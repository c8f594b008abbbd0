"""v2 layer namespace (reference: python/paddle/v2/layer.py).

The reference re-projects every v1 ``*_layer`` under its stem name (fc_layer
→ layer.fc) and specializes ``data``.  Same here, over the port's lazy layer
graph (counterpart of ``paddle_tpu/v2/layer.py``).
"""
from __future__ import annotations

from .. import trainer_config_helpers as _tch
from ..trainer_config_helpers.layers import LayerOutput, parse_network  # noqa: F401
from . import data_type as _dt

__all__ = ["data", "parse_network", "LayerOutput"]


def data(name, type, height=None, width=None):
    """v2 data layer: ``type`` is a data_type spec (carries dim/seq/dtype)."""
    return _tch.data_layer(name=name, size=type.dim, height=height,
                           width=width, type=type)


def _strip(name):
    return name[:-len("_layer")] if name.endswith("_layer") else name


for _name in list(_tch.layers.__all__):
    if _name in ("LayerOutput", "parse_network", "data_layer"):
        continue
    _obj = getattr(_tch.layers, _name)
    _new = _strip(_name)
    globals()[_new] = _obj
    if _new not in __all__:
        __all__.append(_new)

# networks' composites are exposed via paddle.v2.networks, matching the
# reference's split.
