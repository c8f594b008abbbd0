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


def _pair(v, n=2):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


def _conv_out(size, k, p, s, d=1):
    if size is None or size < 0:
        return -1
    return (size + 2 * p - (d * (k - 1) + 1)) // s + 1


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


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    """data_format NHWC keeps activations channels-last end to end; the
    filter stays OIHW either way, so checkpoints are layout-independent.
    Default init Normal(0, sqrt(2 / (k*k*C)))."""
    helper = LayerHelper("conv2d", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    groups = groups or 1
    k = _pair(filter_size)
    s = _pair(stride)
    p = _pair(padding)
    d = _pair(dilation)
    channels_last = data_format.endswith("C")
    num_channels = input.shape[-1] if channels_last else input.shape[1]
    filter_shape = [num_filters, num_channels // groups, k[0], k[1]]
    std = (2.0 / (k[0] * k[1] * num_channels)) ** 0.5
    w = helper.create_parameter(helper.param_attr, shape=filter_shape,
                                dtype=dtype,
                                default_initializer=NormalInitializer(0.0, std))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="conv2d",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [pre_bias]},
                     attrs={"strides": list(s), "paddings": list(p),
                            "dilations": list(d), "groups": groups,
                            "use_cudnn": use_cudnn,
                            "data_format": data_format})
    if channels_last:
        n, h, wd, _ = input.shape
        pre_bias.desc.shape = (n, _conv_out(h, k[0], p[0], s[0], d[0]),
                               _conv_out(wd, k[1], p[1], s[1], d[1]),
                               num_filters)
        pre_act = helper.append_bias_op(pre_bias, dim_start=3, dim_end=4)
    else:
        n, _, h, wd = input.shape
        pre_bias.desc.shape = (n, num_filters,
                               _conv_out(h, k[0], p[0], s[0], d[0]),
                               _conv_out(wd, k[1], p[1], s[1], d[1]))
        pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    pre_act.desc.shape = pre_bias.shape
    out = helper.append_activation(pre_act)
    out.desc.shape = pre_bias.shape
    return out


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True, data_format="NCHW"):
    helper = LayerHelper("pool2d", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    k, s, p = _pair(pool_size), _pair(pool_stride), _pair(pool_padding)
    helper.append_op(type="pool2d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type, "ksize": list(k),
                            "strides": list(s), "paddings": list(p),
                            "global_pooling": global_pooling,
                            "exclusive": exclusive, "ceil_mode": ceil_mode,
                            "data_format": data_format})
    channels_last = data_format.endswith("C")
    if channels_last:
        n, h, w, c = input.shape
    else:
        n, c, h, w = input.shape
    if global_pooling:
        oh = ow = 1
    else:
        def po(size, kk, pp, ss):
            if size in (None, -1):
                return -1
            if ceil_mode:
                return (size - kk + 2 * pp + ss - 1) // ss + 1
            return (size - kk + 2 * pp) // ss + 1
        oh, ow = po(h, k[0], p[0], s[0]), po(w, k[1], p[1], s[1])
    out.desc.shape = (n, oh, ow, c) if channels_last else (n, c, oh, ow)
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               name=None, moving_mean_name=None, moving_variance_name=None,
               do_model_average_for_mean_and_var=False, in_place=False):
    """The running mean and variance are persistable globals that the
    op updates (MeanOut/VarianceOut alias them); relu fuses into the op's
    ``act`` attribute, any other activation follows as its own op."""
    helper = LayerHelper("batch_norm", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    # the op rule's predicate: channels-last iff the layout string ends in
    # C and the input has spatial dims
    channels = (input.shape[-1]
                if (data_layout.endswith("C") and len(input.shape) > 2)
                else input.shape[1])
    scale = helper.create_parameter(helper.param_attr, shape=[channels],
                                    dtype=dtype,
                                    default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(helper.bias_attr, shape=[channels],
                                   dtype=dtype, is_bias=True)
    mean = helper.create_or_get_global_variable(
        moving_mean_name or helper.name + ".mean", [channels], dtype,
        initializer=ConstantInitializer(0.0))
    variance = helper.create_or_get_global_variable(
        moving_variance_name or helper.name + ".var", [channels], dtype,
        initializer=ConstantInitializer(1.0))
    mean.desc.persistable = True
    variance.desc.persistable = True
    saved_mean = helper.create_variable_for_type_inference(dtype)
    saved_var = helper.create_variable_for_type_inference(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    attrs = {"momentum": momentum, "epsilon": epsilon,
             "is_test": is_test, "data_layout": data_layout}
    if act == "relu":
        attrs["act"] = act
        helper.kwargs["act"] = None
    helper.append_op(type="batch_norm",
                     inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                             "Mean": [mean], "Variance": [variance]},
                     outputs={"Y": [out], "MeanOut": [mean],
                              "VarianceOut": [variance],
                              "SavedMean": [saved_mean],
                              "SavedVariance": [saved_var]},
                     attrs=attrs)
    out.desc.shape = input.shape
    act_out = helper.append_activation(out)
    act_out.desc.shape = input.shape
    return act_out


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


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label})
    out.desc.shape = tuple(input.shape[:-1]) + (1,)
    return out


def softmax(input, use_cudnn=True, name=None):
    helper = LayerHelper("softmax", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    out.desc.shape = input.shape
    return out


def accuracy(input, label, k=1, correct=None, total=None):
    """layers/metric.py accuracy: top-k + accuracy ops."""
    helper = LayerHelper("accuracy", input=input)
    topk_out = helper.create_variable_for_type_inference(input.dtype)
    topk_indices = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [topk_out], "Indices": [topk_indices]},
                     attrs={"k": k})
    acc_out = helper.create_variable_for_type_inference("float32")
    correct = correct or helper.create_variable_for_type_inference("int32")
    total = total or helper.create_variable_for_type_inference("int32")
    helper.append_op(type="accuracy",
                     inputs={"Out": [topk_out], "Indices": [topk_indices],
                             "Label": [label]},
                     outputs={"Accuracy": [acc_out], "Correct": [correct],
                              "Total": [total]})
    acc_out.desc.shape = (1,)
    return acc_out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", input=input, name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    if input.shape:
        shp = tuple(input.shape[:-1]) + (k,)
        values.desc.shape = shp
        indices.desc.shape = shp
    return values, indices


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
