"""Pass-through layers (counterpart of ``paddle_tpu/layers/ops.py``): one
X -> Out layer for each activation of the op table and for ``sign``,
``clip``, ``clip_by_norm``, ``cumsum`` and ``log_softmax`` (attributes as
keywords), the ``reduce_*`` layers with the JAX shape inference, and
``scale``, ``uniform_random``, ``gaussian_random`` and ``amp_cast``."""
from __future__ import annotations

from ..layer_helper import LayerHelper
from ..ops.math_ops import ACTIVATIONS


def _make_unary(op_type):
    """A one-op X -> Out layer, as the JAX package generates them."""
    def layer(x, name=None, **kwargs):
        helper = LayerHelper(op_type, input=x, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        attrs = {k: v for k, v in kwargs.items() if v is not None}
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs=attrs)
        out.desc.shape = x.shape
        return out
    layer.__name__ = op_type
    return layer


UNARY = tuple(ACTIVATIONS) + ("sign", "clip", "clip_by_norm", "cumsum",
                              "log_softmax")
globals().update({_name: _make_unary(_name) for _name in UNARY})


def _make_reduce(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, input=input, name=name)
        out = helper.create_variable_for_type_inference(input.dtype)
        if dim is None:
            attrs = {"reduce_all": True, "keep_dim": keep_dim}
        else:
            dims = dim if isinstance(dim, (list, tuple)) else [dim]
            attrs = {"dim": list(dims), "keep_dim": keep_dim}
        helper.append_op(type=op_type, inputs={"X": [input]},
                         outputs={"Out": [out]}, attrs=attrs)
        if input.shape:
            rank = len(input.shape)
            if dim is None:
                out.desc.shape = (1,) * (rank if keep_dim else 1)
            else:
                dims = [d % rank for d in
                        (dim if isinstance(dim, (list, tuple)) else [dim])]
                if keep_dim:
                    out.desc.shape = tuple(1 if i in dims else s
                                           for i, s in enumerate(input.shape))
                else:
                    out.desc.shape = tuple(
                        s for i, s in enumerate(input.shape)
                        if i not in dims) or (1,)
        return out
    layer.__name__ = op_type
    return layer


reduce_sum = _make_reduce("reduce_sum")
reduce_mean = _make_reduce("reduce_mean")
reduce_max = _make_reduce("reduce_max")
reduce_min = _make_reduce("reduce_min")
reduce_prod = _make_reduce("reduce_prod")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None,
          out=None):
    helper = LayerHelper("scale", input=x, act=act, name=name)
    out = out or helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    out.desc.shape = x.shape
    return helper.append_activation(out)


def _random(op_type, shape, dtype, attrs):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type=op_type, outputs={"Out": [out]},
                     attrs=dict(attrs, shape=list(shape), dtype=dtype))
    out.desc.shape = tuple(shape)
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    return _random("uniform_random", shape, dtype,
                   {"min": min, "max": max, "seed": seed})


def gaussian_random(shape, dtype="float32", mean=0.0, std=1.0, seed=0):
    return _random("gaussian_random", shape, dtype,
                   {"mean": mean, "std": std, "seed": seed})


def amp_cast(x, name=None):
    """Where a model's activation stream drops to bf16 under
    ``program.amp``; the identity at full precision."""
    helper = LayerHelper("amp_cast", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="amp_cast", inputs={"X": [x]},
                     outputs={"Out": [out]})
    out.desc.shape = x.shape
    out.desc.lod_level = x.lod_level
    return out
