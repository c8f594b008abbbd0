"""Miscellaneous layers (counterpart of ``paddle_tpu/layers/misc.py``):
``sharding_constraint`` and the long-tail layers over the rules of
``ops/misc_ops.py`` (reference: python/paddle/fluid/layers/nn.py
dynamic_lstmp, gru_unit, multiplex, label_smooth, roi_pool, and the v1
layers crop, bilinear_interp, conv_shift, spp and the rest), which build
the same program JSON as the JAX layers."""
from __future__ import annotations

from ..layer_helper import LayerHelper


def _simple(helper, op_type, inputs, attrs, out_shape, dtype,
            extra_outs=()):
    out = helper.create_variable_for_type_inference(dtype)
    outputs = {"Out": [out]}
    extras = []
    for slot in extra_outs:
        v = helper.create_variable_for_type_inference(dtype)
        outputs[slot] = [v]
        extras.append(v)
    helper.append_op(type=op_type, inputs=inputs, outputs=outputs,
                     attrs=attrs)
    if out_shape is not None:
        out.desc.shape = tuple(out_shape)
    return (out, *extras) if extras else out


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


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


def minus(x, y, name=None):
    helper = LayerHelper("minus", input=x, name=name)
    return _simple(helper, "minus", {"X": [x], "Y": [y]}, {}, x.shape, x.dtype)


def l1_norm(x, name=None):
    helper = LayerHelper("l1_norm", input=x, name=name)
    return _simple(helper, "l1_norm", {"X": [x]}, {}, (1,), x.dtype)


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", input=label, name=name)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    return _simple(helper, "label_smooth", inputs,
                   {"epsilon": float(epsilon)}, label.shape, label.dtype)


def modified_huber_loss(x, y, name=None):
    helper = LayerHelper("modified_huber_loss", input=x, name=name)
    inter = helper.create_variable_for_type_inference(x.dtype)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="modified_huber_loss",
                     inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out], "IntermediateVal": [inter]})
    out.desc.shape = (x.shape[0] if x.shape else -1, 1)
    return out


def multiplex(inputs, index):
    helper = LayerHelper("multiplex", input=inputs[0])
    out = helper.create_variable_for_type_inference(inputs[0].dtype)
    helper.append_op(type="multiplex",
                     inputs={"X": list(inputs), "Ids": [index]},
                     outputs={"Out": [out]})
    out.desc.shape = inputs[0].shape
    return out


def crop(x, shape=None, offsets=None, name=None):
    if shape is None:
        raise ValueError("crop requires `shape` (a list/tuple or a Variable "
                         "whose shape is the crop target)")
    helper = LayerHelper("crop", input=x, name=name)
    inputs = {"X": [x]}
    attrs = {}
    if isinstance(shape, (list, tuple)):
        attrs["shape"] = list(shape)
        out_shape = tuple(shape)
    else:                                 # shape given as a Variable (Y)
        inputs["Y"] = [shape]
        out_shape = shape.shape
    if offsets is not None:
        attrs["offsets"] = list(offsets)
    return _simple(helper, "crop", inputs, attrs, out_shape, x.dtype)


def bilinear_interp(input, out_h, out_w, name=None):
    helper = LayerHelper("bilinear_interp", input=input, name=name)
    n, c = input.shape[0], input.shape[1]
    return _simple(helper, "bilinear_interp", {"X": [input]},
                   {"out_h": int(out_h), "out_w": int(out_w)},
                   (n, c, out_h, out_w), input.dtype)


resize_bilinear = bilinear_interp


def conv_shift(x, y, name=None):
    helper = LayerHelper("conv_shift", input=x, name=name)
    return _simple(helper, "conv_shift", {"X": [x], "Y": [y]}, {},
                   x.shape, x.dtype)


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    helper = LayerHelper("bilinear_tensor_product", input=x, name=name,
                         param_attr=param_attr, bias_attr=bias_attr, act=act)
    dtype = helper.input_dtype()
    w = helper.create_parameter(param_attr,
                                shape=[size, x.shape[-1], y.shape[-1]],
                                dtype=dtype)
    inputs = {"X": [x], "Y": [y], "Weight": [w]}
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, shape=[1, size], dtype=dtype,
                                    is_bias=True)
        inputs["Bias"] = [b]
    out = _simple(helper, "bilinear_tensor_product", inputs, {},
                  (x.shape[0], size), dtype)
    return helper.append_activation(out)


def pool2d_with_index(input, pool_size, pool_stride=1, pool_padding=0,
                      global_pooling=False, name=None):
    """max_pool2d_with_index op: returns (Out, Mask of argmax positions)."""
    helper = LayerHelper("max_pool2d_with_index", input=input, name=name)
    ksize = _pair(pool_size)
    strides = _pair(pool_stride)
    pads = _pair(pool_padding)
    n, c, h, w = input.shape
    oh = (h + 2 * pads[0] - ksize[0]) // strides[0] + 1 if h and h > 0 else -1
    ow = (w + 2 * pads[1] - ksize[1]) // strides[1] + 1 if w and w > 0 else -1
    out = helper.create_variable_for_type_inference(input.dtype)
    mask = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="max_pool2d_with_index",
                     inputs={"X": [input]},
                     outputs={"Out": [out], "Mask": [mask]},
                     attrs={"ksize": ksize, "strides": strides,
                            "paddings": pads,
                            "global_pooling": global_pooling})
    out.desc.shape = (n, c, oh, ow)
    mask.desc.shape = (n, c, oh, ow)
    return out, mask


def unpool(input, indices, ksize, strides=1, paddings=0, name=None):
    helper = LayerHelper("unpool", input=input, name=name)
    ksize, strides, pads = _pair(ksize), _pair(strides), _pair(paddings)
    n, c, h, w = input.shape
    oh = (h - 1) * strides[0] - 2 * pads[0] + ksize[0] if h and h > 0 else -1
    ow = (w - 1) * strides[1] - 2 * pads[1] + ksize[1] if w and w > 0 else -1
    return _simple(helper, "unpool",
                   {"X": [input], "Indices": [indices]},
                   {"ksize": ksize, "strides": strides, "paddings": pads},
                   (n, c, oh, ow), input.dtype)


def spp(input, pyramid_height, pool_type="max", name=None):
    helper = LayerHelper("spp", input=input, name=name)
    n, c = input.shape[0], input.shape[1]
    bins = sum(4 ** level for level in range(pyramid_height))
    return _simple(helper, "spp", {"X": [input]},
                   {"pyramid_height": int(pyramid_height),
                    "pooling_type": pool_type},
                   (n, c * bins), input.dtype)


def roi_pool(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0,
             rois_batch_id=None):
    helper = LayerHelper("roi_pool", input=input)
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_batch_id is not None:
        inputs["RoisBatchId"] = [rois_batch_id]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="roi_pool", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"pooled_height": int(pooled_height),
                            "pooled_width": int(pooled_width),
                            "spatial_scale": float(spatial_scale)})
    out.desc.shape = (rois.shape[0], input.shape[1],
                      pooled_height, pooled_width)
    return out


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid"):
    """One GRU step (nn.py gru_unit:698): returns (hidden, reset_hidden,
    gate)."""
    helper = LayerHelper("gru_unit", input=input, param_attr=param_attr,
                         bias_attr=bias_attr)
    dtype = helper.input_dtype()
    H = size // 3
    w = helper.create_parameter(param_attr, shape=[H, 3 * H], dtype=dtype)
    inputs = {"Input": [input], "HiddenPrev": [hidden], "Weight": [w]}
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, shape=[1, 3 * H], dtype=dtype,
                                    is_bias=True)
        inputs["Bias"] = [b]
    gate = helper.create_variable_for_type_inference(dtype)
    reset_h = helper.create_variable_for_type_inference(dtype)
    new_h = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="gru_unit", inputs=inputs,
                     outputs={"Gate": [gate], "ResetHiddenPrev": [reset_h],
                              "Hidden": [new_h]},
                     attrs={"activation": activation,
                            "gate_activation": gate_activation})
    B = input.shape[0]
    gate.desc.shape = (B, 3 * H)
    reset_h.desc.shape = (B, H)
    new_h.desc.shape = (B, H)
    return new_h, reset_h, gate


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None):
    """LSTM with recurrent projection (nn.py dynamic_lstmp:405).

    Returns (projection [B,T,P], cell [B,T,H]).
    """
    helper = LayerHelper("lstmp", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    from .sequence import _check_gate_width
    _check_gate_width("dynamic_lstmp", input, size,
                      "size = 4*hidden; input is the pre-projected "
                      "[batch, time, size] gates")
    H = size // 4
    P = proj_size
    w = helper.create_parameter(param_attr, shape=[P, 4 * H], dtype=dtype)
    w_proj = helper.create_parameter(None, shape=[H, P], dtype=dtype)
    bias_size = [1, 7 * H] if use_peepholes else [1, 4 * H]
    b = helper.create_parameter(bias_attr, shape=bias_size, dtype=dtype,
                                is_bias=True)
    proj = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="lstmp",
        inputs={"Input": [input], "Weight": [w], "ProjWeight": [w_proj],
                "Bias": [b]},
        outputs={"Projection": [proj], "Cell": [cell]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation,
               "proj_activation": proj_activation})
    B, T = input.shape[0], input.shape[1]
    proj.desc.shape = (B, T, P)
    cell.desc.shape = (B, T, H)
    return proj, cell


def positive_negative_pair(score, label, query_id, weight=None, column=0):
    helper = LayerHelper("positive_negative_pair", input=score)
    pos = helper.create_variable_for_type_inference("float32")
    neg = helper.create_variable_for_type_inference("float32")
    neu = helper.create_variable_for_type_inference("float32")
    inputs = {"Score": [score], "Label": [label], "QueryID": [query_id]}
    if weight is not None:
        inputs["Weight"] = [weight]
    helper.append_op(type="positive_negative_pair",
                     inputs=inputs,
                     outputs={"PositivePair": [pos], "NegativePair": [neg],
                              "NeutralPair": [neu]},
                     attrs={"column": int(column)})
    for v in (pos, neg, neu):
        v.desc.shape = (1,)
    return pos, neg, neu
