"""Sequence layers (counterpart of ``paddle_tpu/layers/sequence.py``,
whole: ``dynamic_lstm``, ``dynamic_gru``, ``sequence_pool`` and its
first/last step forms, ``sequence_softmax``, ``sequence_expand``,
``sequence_conv``, ``sequence_reshape``, ``sequence_concat`` and
``sequence_mask_like``)."""
from __future__ import annotations

from ..layer_helper import LayerHelper


def _check_gate_width(layer, input, want, contract):
    """The pre-projected recurrent layers' width check: a mismatch would
    otherwise surface as an obscure reshape error inside the recurrence."""
    if input.shape and input.shape[-1] and input.shape[-1] > 0 \
            and input.shape[-1] != want:
        raise ValueError(
            f"{layer}: input width {input.shape[-1]} must be {want} "
            f"(the reference contract: {contract})")


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """input is the pre-projected gate sequence [batch, time, 4*hidden];
    size = 4*hidden.  Returns (hidden, cell)."""
    helper = LayerHelper("lstm", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    _check_gate_width("dynamic_lstm", input, size,
                      "size = 4*hidden; input is the pre-projected "
                      "[batch, time, size] gates")
    hidden = size // 4
    weight = helper.create_parameter(helper.param_attr,
                                     shape=[hidden, 4 * hidden], dtype=dtype)
    bias_size = [1, 7 * hidden if use_peepholes else 4 * hidden]
    bias = helper.create_parameter(helper.bias_attr, shape=bias_size,
                                   dtype=dtype, is_bias=True)
    hidden_out = helper.create_variable_for_type_inference(dtype)
    cell_out = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(type="lstm", inputs=inputs,
                     outputs={"Hidden": [hidden_out], "Cell": [cell_out]},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation})
    shp = tuple(input.shape[:-1]) + (hidden,) if input.shape else None
    hidden_out.desc.shape = shp
    cell_out.desc.shape = shp
    hidden_out.desc.lod_level = input.lod_level
    cell_out.desc.lod_level = input.lod_level
    return hidden_out, cell_out


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, dtype="float32"):
    """input [batch, time, 3*hidden]; size = hidden."""
    helper = LayerHelper("gru", input=input, param_attr=param_attr,
                         bias_attr=bias_attr)
    _check_gate_width("dynamic_gru", input, 3 * size,
                      "size = hidden; input is the pre-projected "
                      "[batch, time, 3*hidden] gates")
    weight = helper.create_parameter(helper.param_attr,
                                     shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(helper.bias_attr, shape=[1, 3 * size],
                                   dtype=dtype, is_bias=True)
    hidden_out = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    helper.append_op(type="gru", inputs=inputs,
                     outputs={"Hidden": [hidden_out]},
                     attrs={"is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "activation": candidate_activation})
    if input.shape:
        hidden_out.desc.shape = tuple(input.shape[:-1]) + (size,)
    hidden_out.desc.lod_level = input.lod_level
    return hidden_out


def sequence_pool(input, pool_type):
    helper = LayerHelper("sequence_pool", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_pool", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pooltype": pool_type.upper()})
    if input.shape:
        out.desc.shape = (input.shape[0],) + tuple(input.shape[2:])
    return out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def sequence_softmax(input, use_cudnn=False, name=None):
    helper = LayerHelper("sequence_softmax", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    out.desc.shape = input.shape
    out.desc.lod_level = input.lod_level
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_expand", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"ref_level": ref_level})
    if x.shape and y.shape:
        feat = x.shape[1:] if len(x.shape) == 2 else x.shape[2:]
        out.desc.shape = (x.shape[0], y.shape[1]) + tuple(feat)
    out.desc.lod_level = max(x.lod_level, 1)
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None):
    helper = LayerHelper("sequence_conv", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act)
    dtype = input.dtype
    d = input.shape[-1]
    filter_shape = [filter_size * d, num_filters]
    filter_param = helper.create_parameter(helper.param_attr,
                                           shape=filter_shape, dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="sequence_conv",
                     inputs={"X": [input], "Filter": [filter_param]},
                     outputs={"Out": [pre_bias]},
                     attrs={"contextStride": filter_stride,
                            "contextStart": -int(filter_size // 2),
                            "contextLength": filter_size})
    if input.shape:
        pre_bias.desc.shape = tuple(input.shape[:-1]) + (num_filters,)
    pre_bias.desc.lod_level = input.lod_level
    pre_act = helper.append_bias_op(pre_bias, dim_start=2)
    pre_act.desc.shape = pre_bias.shape
    pre_act.desc.lod_level = input.lod_level
    out = helper.append_activation(pre_act)
    return out


def sequence_reshape(input, new_dim):
    helper = LayerHelper("sequence_reshape", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_reshape", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"new_dim": new_dim})
    out.desc.lod_level = input.lod_level
    return out


def sequence_concat(input, name=None):
    """Concat sequences along time, packed by per-row lengths
    (sequence_concat_op.cc)."""
    helper = LayerHelper("sequence_concat", input=input, name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    out = helper.create_variable_for_type_inference(inputs[0].dtype)
    helper.append_op(type="sequence_concat", inputs={"X": list(inputs)},
                     outputs={"Out": [out]})
    first = inputs[0]
    if first.shape and all(i.shape for i in inputs):
        t_sum = sum(i.shape[1] for i in inputs if len(i.shape) > 1)
        out.desc.shape = (first.shape[0], t_sum) + tuple(first.shape[2:])
    out.desc.lod_level = max(i.lod_level or 0 for i in inputs) or 1
    return out


def sequence_mask_like(x):
    """[batch, time] 1/0 validity mask from x's sequence lengths (the
    padded representation's stand-in for LoD offsets)."""
    helper = LayerHelper("sequence_mask", input=x)
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="sequence_mask", inputs={"X": [x]},
                     outputs={"Y": [out]})
    if x.shape:
        out.desc.shape = (x.shape[0], x.shape[1] if len(x.shape) > 1 else -1)
    return out
