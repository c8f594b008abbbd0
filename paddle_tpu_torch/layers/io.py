"""Input layers (counterpart of ``paddle_tpu/layers/io.py``; only
``data`` is ported)."""
from __future__ import annotations

from ..core.types import VarType
from ..layer_helper import LayerHelper


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=VarType.LOD_TENSOR, stop_gradient=True):
    """Declare an input variable; ``append_batch_size`` prepends a -1
    batch dim."""
    helper = LayerHelper("data", name=name)
    shape = list(shape)
    if lod_level > 0 and shape == [1]:
        shape = [-1]
    if append_batch_size:
        shape = [-1] + shape
    block = helper.main_program.global_block()
    return block.create_var(name=name, shape=shape, dtype=dtype, type=type,
                            stop_gradient=stop_gradient, lod_level=lod_level,
                            is_data=True)
