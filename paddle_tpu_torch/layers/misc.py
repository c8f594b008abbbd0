"""Miscellaneous layers (counterpart of ``paddle_tpu/layers/misc.py``;
only ``sharding_constraint`` is ported)."""
from __future__ import annotations

from ..layer_helper import LayerHelper


def sharding_constraint(x, logical_axes, name=None):
    """Pin ``x``'s layout by logical axes (the identity on one card; kept
    so programs carry the same ops as the JAX package's)."""
    helper = LayerHelper("sharding_constraint", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sharding_constraint", inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"logical_axes": ["" if a is None else str(a)
                                for a in logical_axes]})
    out.desc.shape = tuple(x.shape)
    return out
