"""Neural-net layers (counterpart of ``paddle_tpu/layers/nn.py``).  Each
appends ops to the current block and returns output Variables with
inferred shapes."""
from __future__ import annotations

from ..initializer import Constant, ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr


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
    """Fully-connected layer: one ``mul`` an input (``param_attr`` may be
    a list, one an input), summed by a ``sum`` op when there are several,
    then bias and activation."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    inputs = helper.multiple_input()
    attrs = (list(param_attr) if isinstance(param_attr, (list, tuple))
             else [param_attr] * len(inputs))
    mul_results = []
    for inp, pattr in zip(inputs, attrs):
        fan_in = _prod([abs(s) for s in inp.shape[num_flatten_dims:]])
        w = helper.create_parameter(pattr, shape=[fan_in, size], dtype=dtype)
        out = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type="mul", inputs={"X": [inp], "Y": [w]},
                         outputs={"Out": [out]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        out.desc.shape = tuple(inp.shape[:num_flatten_dims]) + (size,)
        mul_results.append(out)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
        pre_bias.desc.shape = mul_results[0].shape
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    pre_act.desc.shape = pre_bias.shape
    out = helper.append_activation(pre_act)
    out.desc.shape = pre_bias.shape
    return out


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """nn.py embedding -> lookup_table op.  ``is_sparse`` trains the table
    with a SelectedRows gradient (`core.backward`).  ``is_distributed``
    only marks the op: the JAX package row-shards such a table over a
    mesh; the port has none, so its ``Executor`` refuses the program
    (ROADMAP queue A item 4)."""
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
elementwise_sub = _make_elementwise("elementwise_sub")
elementwise_mul = _make_elementwise("elementwise_mul")
elementwise_div = _make_elementwise("elementwise_div")
elementwise_max = _make_elementwise("elementwise_max")
elementwise_min = _make_elementwise("elementwise_min")
elementwise_pow = _make_elementwise("elementwise_pow")


def square_error_cost(input, label):
    """(input - label)^2, elementwise."""
    from . import ops as _ops
    return _ops.square(elementwise_sub(input, label))


def compare_op(op_type, x, y, cond=None):
    helper = LayerHelper(op_type, input=x)
    cond = cond or helper.create_variable_for_type_inference("bool")
    cond.stop_gradient = True
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    cond.desc.shape = x.shape
    return cond


def less_than(x, y, cond=None):
    return compare_op("less_than", x, y, cond)


def equal(x, y, cond=None):
    return compare_op("equal", x, y, cond)


def greater_than(x, y, cond=None):
    return compare_op("greater_than", x, y, cond)


def not_equal(x, y, cond=None):
    return compare_op("not_equal", x, y, cond)


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y, "alpha": alpha})
    xs, ys = list(x.shape or ()), list(y.shape or ())
    if xs and ys:
        m = xs[-1] if transpose_x else xs[-2] if len(xs) > 1 else 1
        n = ys[-2] if transpose_y else ys[-1]
        out.desc.shape = tuple(xs[:-2]) + (m, n)
    return out


def one_hot(input, depth):
    helper = LayerHelper("one_hot", input=input)
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="one_hot", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"depth": depth})
    ish = input.shape or ()
    base = ish[:-1] if (ish and ish[-1] == 1) else ish
    out.desc.shape = tuple(base) + (depth,)
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="l2_normalize", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"axis": axis, "epsilon": epsilon})
    out.desc.shape = x.shape
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    """Local response normalisation across channels (lrn_op.cc)."""
    helper = LayerHelper("lrn", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="lrn", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    out.desc.shape = input.shape
    return out


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """NCHW; the filter is IOHW.  Without ``filter_size`` it is derived
    from ``output_size``."""
    helper = LayerHelper("conv2d_transpose", input=input,
                         param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    s, p, d = _pair(stride), _pair(padding), _pair(dilation)
    n, num_channels, h, wd = input.shape
    if filter_size is None:
        if output_size is None:
            raise ValueError("conv2d_transpose needs filter_size or "
                             "output_size")
        oh, ow = _pair(output_size)
        filter_size = (oh - (h - 1) * s[0] + 2 * p[0],
                       ow - (wd - 1) * s[1] + 2 * p[1])
    k = _pair(filter_size)
    w = helper.create_parameter(helper.param_attr,
                                shape=[num_channels, num_filters, k[0], k[1]],
                                dtype=input.dtype)
    pre_bias = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="conv2d_transpose",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [pre_bias]},
                     attrs={"strides": list(s), "paddings": list(p),
                            "dilations": list(d)})

    def out_size(size, i):
        if size in (None, -1):
            return -1
        return (size - 1) * s[i] - 2 * p[i] + d[i] * (k[i] - 1) + 1
    pre_bias.desc.shape = (n, num_filters, out_size(h, 0), out_size(wd, 1))
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    pre_act.desc.shape = pre_bias.shape
    out = helper.append_activation(pre_act)
    out.desc.shape = pre_bias.shape
    return out


def _triple(v):
    return list(v) if isinstance(v, (list, tuple)) else [v] * 3


def conv3d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           act=None, name=None):
    helper = LayerHelper("conv3d", input=input, act=act)
    filt = helper.create_parameter(
        param_attr or None,
        [num_filters, input.shape[1] // groups] + _triple(filter_size),
        "float32")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="conv3d",
                     inputs={"Input": [input], "Filter": [filt]},
                     outputs={"Output": [out]},
                     attrs={"strides": _triple(stride),
                            "paddings": _triple(padding),
                            "dilations": _triple(dilation),
                            "groups": groups})
    if bias_attr is not None and bias_attr is not False:
        bias = helper.create_parameter(bias_attr, [num_filters], "float32",
                                       is_bias=True)
        out = elementwise_add(out, bias, axis=1)
    return helper.append_activation(out)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, name=None):
    helper = LayerHelper("pool3d", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="pool3d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type,
                            "ksize": _triple(pool_size),
                            "strides": _triple(pool_stride),
                            "paddings": _triple(pool_padding),
                            "global_pooling": global_pooling})
    return out


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """A bare trainable parameter."""
    helper = LayerHelper("create_parameter")
    return helper.create_parameter(attr or ParamAttr(name=name), shape, dtype,
                                   is_bias=is_bias,
                                   default_initializer=default_initializer)


def _simple_xy(op_type, x, y, attrs=None, out_dtype=None, extra=None):
    """One ``op_type`` op over X (and Y, and ``extra`` slots) -> Out."""
    helper = LayerHelper(op_type, input=x)
    out = helper.create_variable_for_type_inference(out_dtype or x.dtype)
    inputs = {"X": [x]}
    if y is not None:
        inputs["Y"] = [y]
    if extra:
        inputs.update(extra)
    helper.append_op(type=op_type, inputs=inputs, outputs={"Out": [out]},
                     attrs=attrs or {})
    return out


def maxout(x, groups, name=None):
    return _simple_xy("maxout", x, None, {"groups": groups})


def prelu(x, mode="all", param_attr=None, name=None):
    """out = x > 0 ? x : alpha * x; one alpha (``all``), one a channel
    (``channel``) or one an element (``element``)."""
    helper = LayerHelper("prelu", input=x)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [x.shape[1]]
    else:
        alpha_shape = list(x.shape[1:])
    alpha = helper.create_parameter(param_attr or ParamAttr(), alpha_shape,
                                    "float32",
                                    default_initializer=Constant(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="prelu", inputs={"X": [x], "Alpha": [alpha]},
                     outputs={"Out": [out]}, attrs={"mode": mode})
    out.desc.shape = x.shape
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    return _simple_xy("pad", x, None, {"paddings": list(paddings),
                                       "pad_value": float(pad_value)})


def reverse(x, axis, name=None):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return _simple_xy("reverse", x, None, {"axis": list(axes)})


def squeeze(input, axes, name=None):
    return _simple_xy("squeeze", input, None, {"axes": list(axes)})


def unsqueeze(input, axes, name=None):
    return _simple_xy("unsqueeze", input, None, {"axes": list(axes)})


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None,
              name=None):
    helper = LayerHelper("smooth_l1_loss", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    diff = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    helper.append_op(type="smooth_l1_loss", inputs=inputs,
                     outputs={"Out": [out], "Diff": [diff]},
                     attrs={"sigma": sigma or 1.0})
    return out


def sigmoid_cross_entropy_with_logits(x, label, name=None):
    return _simple_xy("sigmoid_cross_entropy_with_logits", x, None,
                      extra={"Label": [label]})


def rank_loss(label, left, right, name=None):
    helper = LayerHelper("rank_loss", input=left)
    out = helper.create_variable_for_type_inference(left.dtype)
    helper.append_op(type="rank_loss",
                     inputs={"Label": [label], "Left": [left],
                             "Right": [right]},
                     outputs={"Out": [out]})
    return out


def huber_loss(input, label, delta, name=None):
    helper = LayerHelper("huber_loss", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    residual = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="huber_loss",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out], "Residual": [residual]},
                     attrs={"delta": float(delta)})
    return out


def cos_sim(x, y, name=None):
    """Row-wise cosine similarity -> [batch, 1]."""
    helper = LayerHelper("cos_sim", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    xn = helper.create_variable_for_type_inference(x.dtype)
    yn = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="cos_sim", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out], "XNorm": [xn], "YNorm": [yn]})
    if x.shape:
        out.desc.shape = (x.shape[0], 1)
    return out


def auc(input, label, curve="ROC", num_thresholds=200, topk=1, name=None):
    """Streaming ROC-AUC with persistent TP/FP/TN/FN counters ->
    (auc, [tp, fp, tn, fn])."""
    from .tensor import create_global_var
    helper = LayerHelper("auc", input=input, name=name)
    stats = [create_global_var(shape=[num_thresholds], value=0,
                               dtype="int64", persistable=True)
             for _ in range(4)]
    tp, fp, tn, fn_ = stats
    auc_out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="auc",
                     inputs={"Predict": [input], "Label": [label],
                             "TP": [tp], "FP": [fp], "TN": [tn],
                             "FN": [fn_]},
                     outputs={"AUC": [auc_out], "TPOut": [tp],
                              "FPOut": [fp], "TNOut": [tn],
                              "FNOut": [fn_]},
                     attrs={"curve": curve,
                            "num_thresholds": num_thresholds})
    auc_out.desc.shape = (1,)
    return auc_out, stats


def row_conv(input, future_context_size, param_attr=None, act=None,
             name=None):
    """row_conv_op.cc: a lookahead convolution over the time axis."""
    helper = LayerHelper("row_conv", input=input)
    d = input.shape[-1]
    filt = helper.create_parameter(param_attr or None,
                                   [future_context_size + 1, d], "float32")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="row_conv",
                     inputs={"X": [input], "Filter": [filt]},
                     outputs={"Out": [out]})
    out.desc.shape = input.shape
    return helper.append_activation(out) if act else out


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    k = _pair(filter_size)
    s = _pair(stride)
    p = padding if isinstance(padding, (list, tuple)) else [padding] * 4
    return _simple_xy("im2sequence", input, None,
                      {"kernels": list(k), "strides": list(s),
                       "paddings": list(p)})


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_slice",
                     inputs={"X": [input], "Offset": [offset],
                             "Length": [length]},
                     outputs={"Out": [out]})
    return out


def sequence_reverse(x, name=None):
    helper = LayerHelper("sequence_reverse", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_reverse", inputs={"X": [x]},
                     outputs={"Y": [out]})
    if x.shape:
        out.desc.shape = x.shape
    return out


def sampling_id(x, min=0.0, max=1.0, seed=0, name=None):
    return _simple_xy("sampling_id", x, None, {"seed": seed},
                      out_dtype="int64")


def lstm_unit(x_t, cell_t_prev, forget_bias=0.0, name=None):
    """lstm_unit_op.cc: one fused cell step; x_t is the 4H gate input."""
    helper = LayerHelper("lstm_unit", input=x_t)
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    helper.append_op(type="lstm_unit",
                     inputs={"X": [x_t], "C_prev": [cell_t_prev]},
                     outputs={"C": [c], "H": [h]},
                     attrs={"forget_bias": float(forget_bias)})
    return h, c


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    """Hierarchical sigmoid loss (hierarchical_sigmoid_op.cc): a row's cost
    over the complete-binary-tree path of its label."""
    helper = LayerHelper("hsigmoid", input=input)
    d = input.shape[-1]
    w = helper.create_parameter(param_attr or None, [num_classes - 1, d],
                                "float32")
    inputs = {"X": [input], "W": [w], "Label": [label]}
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr or None, [num_classes - 1, 1],
                                    "float32", is_bias=True)
        inputs["Bias"] = [b]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="hsigmoid", inputs=inputs, outputs={"Out": [out]},
                     attrs={"num_classes": num_classes})
    return out
