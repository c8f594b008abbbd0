"""v2 pooling namespace (reference: python/paddle/v2/pooling.py)."""
from __future__ import annotations

from ..trainer_config_helpers import poolings as _p

__all__ = []

for _name in _p.__all__:
    if _name == "BasePoolingType":
        continue
    _new = _name[:-len("Pooling")] if _name.endswith("Pooling") else _name
    globals()[_new] = getattr(_p, _name)
    __all__.append(_new)
