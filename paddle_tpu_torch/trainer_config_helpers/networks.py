"""Composite networks (reference: trainer_config_helpers/networks.py).

The reference composes v1 layers into named subnetworks (simple_lstm,
vgg_16_network, simple_attention, …); same vocabulary here over the lazy
layer graph.
"""
from __future__ import annotations

from .activations import (LinearActivation, ReluActivation,
                          SigmoidActivation, SoftmaxActivation,
                          TanhActivation)
from .attrs import ParameterAttribute
from .poolings import MaxPooling
from . import layers as L

__all__ = [
    "simple_img_conv_pool", "img_conv_group", "vgg_16_network",
    "simple_lstm", "bidirectional_lstm", "simple_gru",
    "sequence_conv_pool", "text_conv_pool", "simple_attention",
    "inputs", "outputs", "lstmemory_unit", "lstmemory_group",
    "gru_unit", "gru_group", "simple_gru2", "bidirectional_gru",
    "img_conv_bn_pool", "img_separable_conv", "small_vgg",
    "dot_product_attention", "multi_head_attention",
]


def simple_img_conv_pool(input, filter_size, num_filters, pool_size,
                         name=None, pool_type=None, act=None, groups=1,
                         conv_stride=1, conv_padding=0, bias_attr=None,
                         num_channel=None, param_attr=None,
                         pool_stride=1, pool_padding=0):
    conv = L.img_conv_layer(
        input=input, filter_size=filter_size, num_filters=num_filters,
        num_channels=num_channel, act=act, groups=groups,
        stride=conv_stride, padding=conv_padding, bias_attr=bias_attr,
        param_attr=param_attr, name=name and name + "_conv")
    return L.img_pool_layer(
        input=conv, pool_size=pool_size, pool_type=pool_type,
        stride=pool_stride, padding=pool_padding,
        name=name and name + "_pool")


def img_conv_group(input, conv_num_filter, pool_size, num_channels=None,
                   conv_padding=1, conv_filter_size=3, conv_act=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0,
                   pool_stride=1, pool_type=None):
    """A VGG-style stack: N convs then one pool (reference img_conv_group)."""
    tmp = input
    if not isinstance(conv_padding, (list, tuple)):
        conv_padding = [conv_padding] * len(conv_num_filter)
    if not isinstance(conv_with_batchnorm, (list, tuple)):
        conv_with_batchnorm = [conv_with_batchnorm] * len(conv_num_filter)
    if not isinstance(conv_batchnorm_drop_rate, (list, tuple)):
        conv_batchnorm_drop_rate = (
            [conv_batchnorm_drop_rate] * len(conv_num_filter))
    for i, nf in enumerate(conv_num_filter):
        act = conv_act if not conv_with_batchnorm[i] else LinearActivation()
        tmp = L.img_conv_layer(
            input=tmp, filter_size=conv_filter_size, num_filters=nf,
            num_channels=num_channels if i == 0 else None,
            padding=conv_padding[i], act=act)
        if conv_with_batchnorm[i]:
            tmp = L.batch_norm_layer(input=tmp, act=conv_act)
            if conv_batchnorm_drop_rate[i]:
                tmp = L.dropout_layer(input=tmp,
                                      dropout_rate=conv_batchnorm_drop_rate[i])
    return L.img_pool_layer(input=tmp, pool_size=pool_size,
                            stride=pool_stride, pool_type=pool_type)


def vgg_16_network(input_image, num_channels, num_classes=1000):
    """VGG-16 (reference networks.py vgg_16_network)."""
    relu = ReluActivation()
    tmp = input_image
    for i, (n, nf) in enumerate([(2, 64), (2, 128), (3, 256), (3, 512),
                                 (3, 512)]):
        tmp = img_conv_group(
            input=tmp, conv_num_filter=[nf] * n, pool_size=2,
            num_channels=num_channels if i == 0 else None,
            conv_act=relu, conv_with_batchnorm=True, pool_stride=2,
            pool_type=MaxPooling())
    tmp = L.fc_layer(input=tmp, size=4096, act=relu)
    tmp = L.dropout_layer(input=tmp, dropout_rate=0.5)
    tmp = L.fc_layer(input=tmp, size=4096, act=relu)
    tmp = L.dropout_layer(input=tmp, dropout_rate=0.5)
    return L.fc_layer(input=tmp, size=num_classes, act=SoftmaxActivation())


def simple_lstm(input, size, name=None, reverse=False, mat_param_attr=None,
                bias_param_attr=None, inner_param_attr=None, act=None,
                gate_act=None, state_act=None, mixed_layer_attr=None,
                lstm_cell_attr=None):
    """fc(4h) + lstmemory — the reference's canonical LSTM block."""
    fc = L.fc_layer(input=input, size=size * 4, act=LinearActivation(),
                    param_attr=mat_param_attr, bias_attr=bias_param_attr,
                    name=name and name + "_transform")
    return L.lstmemory(input=fc, size=size, reverse=reverse, act=act,
                       gate_act=gate_act, state_act=state_act,
                       param_attr=inner_param_attr, name=name)


def bidirectional_lstm(input, size, name=None, return_seq=False,
                       fwd_mat_param_attr=None, bwd_mat_param_attr=None,
                       **kwargs):
    fwd = simple_lstm(input=input, size=size, reverse=False,
                      mat_param_attr=fwd_mat_param_attr,
                      name=name and name + "_fwd")
    bwd = simple_lstm(input=input, size=size, reverse=True,
                      mat_param_attr=bwd_mat_param_attr,
                      name=name and name + "_bwd")
    if return_seq:
        return L.concat_layer(input=[fwd, bwd], name=name)
    return L.concat_layer(input=[L.last_seq(fwd), L.first_seq(bwd)],
                          name=name)


def simple_gru(input, size, name=None, reverse=False, mixed_param_attr=None,
               mixed_bias_param_attr=None, gru_param_attr=None,
               gru_bias_attr=None, act=None, gate_act=None, **kwargs):
    fc = L.fc_layer(input=input, size=size * 3, act=LinearActivation(),
                    param_attr=mixed_param_attr,
                    bias_attr=mixed_bias_param_attr,
                    name=name and name + "_transform")
    return L.grumemory(input=fc, size=size, reverse=reverse, act=act,
                       gate_act=gate_act, param_attr=gru_param_attr,
                       bias_attr=gru_bias_attr, name=name)


def sequence_conv_pool(input, context_len, hidden_size, name=None,
                       context_start=None, pool_type=None,
                       context_proj_param_attr=None, fc_param_attr=None,
                       fc_bias_attr=None, fc_act=None, pool_bias_attr=None,
                       fc_attr=None, context_attr=None, pool_attr=None):
    """Context projection + fc + sequence pool (text classification block)."""
    from .. import layers as F
    from ..unique_name import generate as _uniq

    name = name or _uniq("seq_conv_pool")
    fc_act_name = fc_act or TanhActivation()

    def build(parents):
        conv = F.sequence_conv(input=parents[0], num_filters=hidden_size,
                               filter_size=context_len,
                               act=None)
        return F.sequence_pool(input=conv, pool_type="max"
                               if pool_type is None else pool_type.name)

    node = L.LayerOutput(name, "sequence_conv_pool", [input],
                         size=hidden_size, build=build)
    return node


text_conv_pool = sequence_conv_pool


def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     transform_param_attr=None, softmax_param_attr=None,
                     decoder_state_param_attr=None, name=None):
    """Bahdanau additive attention (reference networks.py simple_attention):
    score = v·tanh(enc_proj + W·dec_state); context = Σ softmax(score)·enc."""
    from .. import layers as F
    from ..unique_name import generate as _uniq

    name = name or _uniq("attention")
    size = encoded_proj.size

    def build(parents):
        enc, enc_proj, dec = parents
        dec_expand = F.sequence_expand(
            x=F.fc(input=dec, size=size, bias_attr=False), y=enc_proj)
        att_hidden = F.elementwise_add(enc_proj, dec_expand)
        att_hidden = F.tanh(att_hidden)
        e = F.fc(input=att_hidden, size=1, num_flatten_dims=2,
                 bias_attr=False)
        w = F.sequence_softmax(e)
        scaled = F.elementwise_mul(enc, w)
        return F.sequence_pool(input=scaled, pool_type="sum")

    return L.LayerOutput(name, "attention",
                         [encoded_sequence, encoded_proj, decoder_state],
                         size=encoded_sequence.size, build=build)


# ---------------------------------------------------------------------------
# round-2 network tail (reference networks.py)
# ---------------------------------------------------------------------------

def inputs(layers, *args):
    """reference networks.py inputs(): declare feed order — a no-op marker
    here (DataFeeder takes explicit feed lists)."""
    return layers


def outputs(layers, *args):
    """reference networks.py outputs(): mark network outputs; returns the
    list so callers can hand it to parse_network."""
    out = L._as_list(layers)
    for a in args:
        out.extend(L._as_list(a))
    return out


def lstmemory_unit(input, out_memory=None, name=None, size=None,
                   param_attr=None, act=None, gate_act=None, state_act=None,
                   input_proj_bias_attr=None, input_proj_layer_attr=None,
                   lstm_bias_attr=None, lstm_layer_attr=None):
    """One LSTM step for recurrent_group steps (reference lstmemory_unit):
    mixed(4h) of [input, out_mem] -> lstm_step; memories link by name."""
    size = size or input.size // 4
    name = name or L._uniq("lstmemory_unit")

    if out_memory is None:
        out_memory = L.memory(name=name, size=size)
    state_memory = L.memory(name=name + "_state", size=size)

    with L.mixed_layer(size=size * 4, act=LinearActivation(),
                       bias_attr=input_proj_bias_attr,
                       name=name + "_input_recurrent") as m:
        m += L.full_matrix_projection(input, size=size * 4,
                                      param_attr=param_attr)
        # the recurrent projection has a different shape: a shared
        # ParamAttr object would collide names (LayerHelper binds the
        # attr's name on first use)
        m += L.full_matrix_projection(out_memory, size=size * 4)
    lstm_out = L.lstm_step_layer(
        input=m, state=state_memory, size=size, act=act,
        gate_act=gate_act, state_act=state_act, name=name)
    L.get_output_layer(input=lstm_out, arg_name="state",
                       name=name + "_state")
    return lstm_out


def lstmemory_group(input, size=None, name=None, out_memory=None,
                    reverse=False, param_attr=None, act=None,
                    gate_act=None, state_act=None,
                    input_proj_bias_attr=None, input_proj_layer_attr=None,
                    lstm_bias_attr=None, lstm_layer_attr=None):
    """LSTM as an explicit recurrent_group (reference lstmemory_group) —
    step-level access for attention decoders."""
    name = name or L._uniq("lstm_group")

    def step(x):
        return lstmemory_unit(
            input=x, name=name + "_unit", size=size, param_attr=param_attr,
            act=act, gate_act=gate_act, state_act=state_act,
            input_proj_bias_attr=input_proj_bias_attr,
            lstm_bias_attr=lstm_bias_attr)

    return L.recurrent_group(step, [input], name=name, reverse=reverse)


def gru_unit(input, memory_boot=None, size=None, name=None, gru_bias_attr=None,
             gru_param_attr=None, act=None, gate_act=None,
             gru_layer_attr=None, naive=False):
    """One GRU step for recurrent_group steps (reference gru_unit)."""
    size = size or input.size // 3
    name = name or L._uniq("gru_unit")
    out_mem = L.memory(name=name, size=size, boot_layer=memory_boot)
    return L.gru_step_layer(
        input=input, output_mem=out_mem, size=size, act=act,
        gate_act=gate_act, bias_attr=gru_bias_attr,
        param_attr=gru_param_attr, name=name)


def gru_group(input, memory_boot=None, size=None, name=None,
              reverse=False, gru_bias_attr=None, gru_param_attr=None,
              act=None, gate_act=None, gru_layer_attr=None, naive=False):
    name = name or L._uniq("gru_group")

    def step(x):
        return gru_unit(input=x, memory_boot=memory_boot,
                        size=size, name=name + "_unit",
                        gru_bias_attr=gru_bias_attr,
                        gru_param_attr=gru_param_attr, act=act,
                        gate_act=gate_act)

    return L.recurrent_group(step, [input], name=name, reverse=reverse)


def simple_gru2(input, size, name=None, reverse=False, mixed_param_attr=None,
                mixed_bias_attr=None, gru_param_attr=None,
                gru_bias_attr=None, act=None, gate_act=None,
                mixed_layer_attr=None, gru_cell_attr=None):
    """fc(3h) + gru_group (reference simple_gru2: same math as simple_gru,
    exposed step-by-step)."""
    fc = L.fc_layer(input=input, size=size * 3, act=LinearActivation(),
                    param_attr=mixed_param_attr, bias_attr=mixed_bias_attr,
                    name=name and name + "_transform")
    return gru_group(input=fc, size=size, name=name, reverse=reverse,
                     gru_bias_attr=gru_bias_attr,
                     gru_param_attr=gru_param_attr, act=act,
                     gate_act=gate_act)


def bidirectional_gru(input, size, name=None, return_seq=False,
                      fwd_mixed_param_attr=None, bwd_mixed_param_attr=None,
                      **kwargs):
    fwd = simple_gru(input=input, size=size, reverse=False,
                     mixed_param_attr=fwd_mixed_param_attr,
                     name=name and name + "_fwd")
    bwd = simple_gru(input=input, size=size, reverse=True,
                     mixed_param_attr=bwd_mixed_param_attr,
                     name=name and name + "_bwd")
    if return_seq:
        return L.concat_layer(input=[fwd, bwd], name=name)
    return L.concat_layer(input=[L.last_seq(fwd), L.first_seq(bwd)],
                          name=name)


def img_conv_bn_pool(input, filter_size, num_filters, pool_size, name=None,
                     num_channels=None, conv_padding=0, conv_stride=1,
                     conv_act=None, conv_bias_attr=None, conv_param_attr=None,
                     pool_type=None, pool_stride=1, pool_padding=0,
                     bn_param_attr=None, bn_bias_attr=None,
                     bn_layer_attr=None):
    """conv + batch_norm + pool (reference img_conv_bn_pool)."""
    conv = L.img_conv_layer(
        input=input, filter_size=filter_size, num_filters=num_filters,
        num_channels=num_channels, act=LinearActivation(),
        padding=conv_padding, stride=conv_stride,
        bias_attr=conv_bias_attr, param_attr=conv_param_attr,
        name=name and name + "_conv")
    bn = L.batch_norm_layer(input=conv, act=conv_act,
                            param_attr=bn_param_attr,
                            name=name and name + "_bn")
    return L.img_pool_layer(input=bn, pool_size=pool_size,
                            pool_type=pool_type, stride=pool_stride,
                            padding=pool_padding,
                            name=name and name + "_pool")


def img_separable_conv(input, num_channels, num_out_channels, filter_size,
                       stride=1, padding=0, depth_multiplier=1, act=None,
                       bias_attr=None, param_attr=None, shared_bias=True,
                       name=None):
    """Depthwise + pointwise conv (reference img_separable_conv)."""
    dw = L.img_conv_layer(
        input=input, filter_size=filter_size,
        num_filters=num_channels * depth_multiplier,
        num_channels=num_channels, groups=num_channels,
        stride=stride, padding=padding, act=LinearActivation(),
        bias_attr=bias_attr, param_attr=param_attr,
        name=name and name + "_dw")
    return L.img_conv_layer(
        input=dw, filter_size=1, num_filters=num_out_channels,
        stride=1, padding=0, act=act, bias_attr=bias_attr,
        param_attr=param_attr, name=name and name + "_pw")


def small_vgg(input_image, num_channels, num_classes=102):
    """The 4-group VGG used by the flowers/cifar demos (reference
    small_vgg)."""
    def vgg_block(ipt, num, num_filter, channels=None):
        return img_conv_group(
            input=ipt, conv_num_filter=[num_filter] * num, pool_size=2,
            num_channels=channels, conv_padding=1, conv_filter_size=3,
            conv_act=ReluActivation(), conv_with_batchnorm=True,
            pool_stride=2, pool_type=MaxPooling())

    tmp = vgg_block(input_image, 2, 64, num_channels)
    tmp = vgg_block(tmp, 2, 128)
    tmp = vgg_block(tmp, 3, 256)
    tmp = vgg_block(tmp, 3, 512)
    tmp = L.dropout_layer(input=tmp, dropout_rate=0.5)
    tmp = L.fc_layer(input=tmp, size=512, act=LinearActivation())
    tmp = L.batch_norm_layer(input=tmp, act=ReluActivation())
    tmp = L.dropout_layer(input=tmp, dropout_rate=0.5)
    return L.fc_layer(input=tmp, size=num_classes,
                      act=SoftmaxActivation())


def dot_product_attention(encoded_sequence, attended_sequence,
                          transformed_state, softmax_param_attr=None,
                          name=None):
    """Dot-product attention (reference dot_product_attention): weights
    from <transformed_state, encoded>; context over attended_sequence."""
    from .. import layers as F
    from ..unique_name import generate as _uniq

    name = name or _uniq("dot_attention")

    def build(parents):
        enc, att, dec = parents
        dec_expand = F.sequence_expand(x=dec, y=enc)
        e = F.reduce_sum(F.elementwise_mul(enc, dec_expand), dim=-1,
                         keep_dim=True)
        w = F.sequence_softmax(e)
        scaled = F.elementwise_mul(att, w)
        return F.sequence_pool(input=scaled, pool_type="sum")

    return L.LayerOutput(
        name, "dot_attention",
        [encoded_sequence, attended_sequence, transformed_state],
        size=attended_sequence.size, build=build)


def multi_head_attention(query, key, value, key_proj_size, value_proj_size,
                         head_num, attention_type="dot-product attention",
                         softmax_param_attr=None, name=None):
    """Multi-head attention over padded sequences (reference
    multi_head_attention) — lowered onto the fused flash-attention op."""
    from .. import layers as F
    from ..unique_name import generate as _uniq
    from .. import nets

    name = name or _uniq("multi_head")
    assert key_proj_size % head_num == 0
    assert value_proj_size % head_num == 0

    def build(parents):
        q, k, v = parents
        qp = F.fc(input=q, size=key_proj_size, num_flatten_dims=2,
                  bias_attr=False)
        kp = F.fc(input=k, size=key_proj_size, num_flatten_dims=2,
                  bias_attr=False)
        vp = F.fc(input=v, size=value_proj_size, num_flatten_dims=2,
                  bias_attr=False)
        return nets.scaled_dot_product_attention(
            qp, kp, vp, num_heads=head_num)

    return L.LayerOutput(name, "multi_head", [query, key, value],
                         size=value_proj_size, build=build)
