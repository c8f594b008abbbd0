"""Neural-net layers (counterpart of ``paddle_tpu/layers/nn.py``; the
layers the training programs call).  Each appends ops to the current
block and returns output Variables with inferred shapes."""
from __future__ import annotations

from ..layer_helper import LayerHelper
from ..initializer import ConstantInitializer, NormalInitializer


def _prod(xs):
    out = 1
    for x in xs:
        out *= x
    return out


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully-connected layer: mul + bias + activation (one input; the
    several-input form, summed by a ``sum`` op, is not ported)."""
    if isinstance(input, (list, tuple)):
        raise NotImplementedError("fc over several inputs is not ported")
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    fan_in = _prod([abs(s) for s in input.shape[num_flatten_dims:]])
    w = helper.create_parameter(param_attr, shape=[fan_in, size],
                                dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="mul", inputs={"X": [input], "Y": [w]},
                     outputs={"Out": [pre_bias]},
                     attrs={"x_num_col_dims": num_flatten_dims,
                            "y_num_col_dims": 1})
    pre_bias.desc.shape = tuple(input.shape[:num_flatten_dims]) + (size,)
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    pre_act.desc.shape = pre_bias.shape
    out = helper.append_activation(pre_act)
    out.desc.shape = pre_bias.shape
    return out


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """nn.py embedding -> lookup_table op.  is_distributed maps to the mesh-
    sharded table in parallel/embedding.py (P7 parity)."""
    helper = LayerHelper("embedding", input=input, param_attr=param_attr)
    w = helper.create_parameter(helper.param_attr, shape=list(size),
                                dtype=dtype,
                                default_initializer=NormalInitializer(0., 1. / (size[1] ** 0.5)))
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="lookup_table",
                     inputs={"W": [w], "Ids": [input]},
                     outputs={"Out": [out]},
                     attrs={"is_sparse": is_sparse,
                            "is_distributed": is_distributed,
                            "padding_idx": -1 if padding_idx is None else padding_idx})
    ish = input.shape or (-1, 1)
    base = ish[:-1] if (len(ish) >= 2 and ish[-1] == 1) else ish
    out.desc.shape = tuple(base) + (size[1],)
    out.desc.lod_level = input.lod_level
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    norm_shape = [_prod([abs(s) for s in input.shape[begin_norm_axis:]])]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(helper.param_attr, shape=norm_shape,
                                    dtype=dtype,
                                    default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(helper.bias_attr, shape=norm_shape,
                                    dtype=dtype, is_bias=True)
        inputs["Bias"] = [b]
    out = helper.create_variable_for_type_inference(dtype)
    mean = helper.create_variable_for_type_inference(dtype)
    var = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="layer_norm", inputs=inputs,
                     outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
                     attrs={"begin_norm_axis": begin_norm_axis,
                            "epsilon": epsilon})
    out.desc.shape = input.shape
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None):
    helper = LayerHelper("dropout", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op(type="dropout", inputs={"X": [x]},
                     outputs={"Out": [out], "Mask": [mask]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "seed": seed if seed is not None else 0})
    out.desc.shape = x.shape
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               return_softmax=False):
    helper = LayerHelper("softmax_with_cross_entropy", input=logits)
    softmax = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Softmax": [softmax], "Loss": [loss]},
                     attrs={"soft_label": soft_label})
    loss.desc.shape = tuple(logits.shape[:-1]) + (1,)
    softmax.desc.shape = logits.shape
    if return_softmax:
        return loss, softmax
    return loss


def mean(x, name=None):
    helper = LayerHelper("mean", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    out.desc.shape = (1,)
    return out


def elementwise_op(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, input=x, act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    if x.shape and y.shape:
        out.desc.shape = (x.shape if len(x.shape) >= len(y.shape)
                          else y.shape)
    else:
        out.desc.shape = x.shape or y.shape   # keep whichever is known
    return helper.append_activation(out)


def _make_elementwise(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        return elementwise_op(op_type, x, y, axis=axis, act=act, name=name)
    layer.__name__ = op_type
    return layer


elementwise_add = _make_elementwise("elementwise_add")
