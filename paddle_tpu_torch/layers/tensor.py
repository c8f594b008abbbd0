"""Tensor layers (counterpart of ``paddle_tpu/layers/tensor.py``; the
layers the training programs call)."""
from __future__ import annotations

from ..layer_helper import LayerHelper


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """tensor.py create_global_var: persistable var initialised in startup."""
    from ..initializer import ConstantInitializer
    helper = LayerHelper("global_var", name=name)
    var = helper.create_or_get_global_variable(
        name or helper.name, shape, dtype, persistable=persistable,
        initializer=ConstantInitializer(value))
    var.desc.persistable = persistable
    return var


def reshape(x, shape, actual_shape=None, act=None, inplace=True, name=None):
    helper = LayerHelper("reshape", input=x, act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="reshape", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"shape": list(shape)})
    shp = [x.shape[i] if s == 0 and x.shape else s for i, s in enumerate(shape)]
    out.desc.shape = tuple(shp)
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="transpose", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": list(perm)})
    if x.shape:
        out.desc.shape = tuple(x.shape[i] for i in perm)
    return out


def slice(input, axes, starts, ends, name=None):
    """Static slice along the given axes (slice_op.cc)."""
    helper = LayerHelper("slice", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    if input.shape:
        shp = list(input.shape)
        for a, s, e in zip(axes, starts, ends):
            if 0 <= a < len(shp) and shp[a] is not None and shp[a] >= 0:
                hi = min(e, shp[a]) if e >= 0 else shp[a] + e
                lo = s if s >= 0 else shp[a] + s
                shp[a] = max(0, hi - lo)
        out.desc.shape = tuple(shp)
    out.desc.lod_level = input.lod_level
    return out


def sums(input, out=None):
    """One ``sum`` op adding the list ``input``."""
    inputs = list(input) if isinstance(input, (list, tuple)) else [input]
    helper = LayerHelper("sum", input=input)
    out = out or helper.create_variable_for_type_inference(inputs[0].dtype)
    helper.append_op(type="sum", inputs={"X": inputs},
                     outputs={"Out": [out]})
    out.desc.shape = inputs[0].shape
    return out
