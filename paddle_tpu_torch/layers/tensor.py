"""Tensor layers (counterpart of ``paddle_tpu/layers/tensor.py``)."""
from __future__ import annotations

import numpy as np

from ..core.program import Variable
from ..layer_helper import LayerHelper


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.block.create_var(name=helper.name, dtype=dtype,
                                   persistable=persistable)


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


def cast(x, dtype):
    helper = LayerHelper("cast", input=x)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    out.desc.shape = x.shape
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", input=input, name=name)
    inputs = helper.multiple_input()
    out = helper.create_variable_for_type_inference(inputs[0].dtype)
    helper.append_op(type="concat", inputs={"X": inputs},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    shapes = [list(v.shape) for v in inputs if v.shape]
    if shapes and all(len(s) == len(shapes[0]) for s in shapes):
        shp = list(shapes[0])
        shp[axis] = (sum(s[axis] for s in shapes)
                     if all(s[axis] >= 0 for s in shapes) else -1)
        out.desc.shape = tuple(shp)
    return out


def assign(input, output=None):
    """A Variable becomes an ``assign`` op, a numpy value an
    ``assign_value`` op."""
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        output = output or helper.create_variable_for_type_inference(
            input.dtype)
        helper.append_op(type="assign", inputs={"X": [input]},
                         outputs={"Out": [output]})
        if input.shape is not None:       # never clobber a declared shape
            output.desc.shape = input.shape
    else:
        arr = np.asarray(input)
        output = output or helper.create_variable_for_type_inference(
            str(arr.dtype))
        helper.append_op(type="assign_value", outputs={"Out": [output]},
                         attrs={"shape": list(arr.shape),
                                "dtype": str(arr.dtype),
                                "values": arr.flatten().tolist()})
        output.desc.shape = arr.shape
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    out = out or helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value)})
    out.desc.shape = tuple(shape)
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like", input=input)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="fill_constant_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    shp = list(shape)
    shp[output_dim_idx] = -1
    out.desc.shape = tuple(shp)
    out.stop_gradient = True
    return out


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 0.0, force_cpu)


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 1.0, force_cpu)


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", input=input, name=name)
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        n, sections = num_or_sections, []
    else:
        sections = list(num_or_sections)
        n = len(sections)
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n)]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs},
                     attrs={"axis": dim, "sections": sections,
                            "num": 0 if sections else n})
    for i, o in enumerate(outs):
        shp = list(input.shape)
        shp[dim] = (sections[i] if sections
                    else (shp[dim] // n if shp[dim] >= 0 else -1))
        o.desc.shape = tuple(shp)
    return outs


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="expand", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"expand_times": list(expand_times)})
    if x.shape:
        out.desc.shape = tuple(s * t if s >= 0 else -1
                               for s, t in zip(x.shape, expand_times))
    return out


def gather(input, index):
    helper = LayerHelper("gather", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    out.desc.shape = tuple(index.shape[:1]) + tuple(input.shape[1:])
    return out


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper("scatter", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="scatter",
                     inputs={"X": [input], "Ids": [index],
                             "Updates": [updates]},
                     outputs={"Out": [out]}, attrs={"overwrite": overwrite})
    out.desc.shape = input.shape
    return out


def _arg(op_type, x, axis):
    helper = LayerHelper(op_type, input=x)
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


def argmax(x, axis=0):
    return _arg("arg_max", x, axis)


def argmin(x, axis=0):
    return _arg("arg_min", x, axis)
