"""Composite layers (counterpart of ``paddle_tpu/nets.py``): the image
helpers ``simple_img_conv_pool`` and ``img_conv_group``,
``sequence_conv_pool``, ``glu``, and the self-attention branch of
``scaled_dot_product_attention``."""
from __future__ import annotations

from . import layers
from .layer_helper import LayerHelper


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act, param_attr=None,
                         pool_type="max", use_cudnn=True):
    """conv2d (with ``act``) then pool2d."""
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, param_attr=param_attr,
                             act=act, use_cudnn=use_cudnn)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         use_cudnn=use_cudnn)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """A conv2d for each of ``conv_num_filter`` (each optionally followed
    by batch_norm carrying ``conv_act`` and by dropout), then one pool2d.
    Every per-conv argument is one value or a list, one a conv."""
    if not isinstance(conv_num_filter, (list, tuple)):
        raise TypeError("conv_num_filter must be a list or tuple")

    def _expand(obj):
        if isinstance(obj, (list, tuple)):
            return list(obj)
        return [obj] * len(conv_num_filter)

    conv_padding = _expand(conv_padding)
    conv_filter_size = _expand(conv_filter_size)
    param_attr = _expand(param_attr)
    conv_with_batchnorm = _expand(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _expand(conv_batchnorm_drop_rate)

    tmp = input
    for i, num_filter in enumerate(conv_num_filter):
        tmp = layers.conv2d(input=tmp, num_filters=num_filter,
                            filter_size=conv_filter_size[i],
                            padding=conv_padding[i],
                            param_attr=param_attr[i],
                            act=None if conv_with_batchnorm[i] else conv_act,
                            use_cudnn=use_cudnn)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         use_cudnn=use_cudnn)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    """sequence_conv (with ``act``) then sequence_pool."""
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    """Gated linear unit: a * sigmoid(b) over the two halves of ``dim``."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0, causal=False,
                                 use_fused=True, cache=None):
    """Multi-head self-attention over [batch, seq, dim] program variables
    (``queries is keys is values``): one ``[d, 3d]`` fc, q/k/v slices,
    heads split to [B, H, T, d/H], ONE ``fused_attention`` op, heads
    merged back.  The ops, attributes and shapes are the JAX package's.

    Not ported: cross-attention, a single head, attention dropout (the
    matmul/softmax chain), the paged KV cache (the serving model is the
    ``nn.Module`` in ``models.transformer``)."""
    if not (queries is keys and keys is values) or num_heads <= 1:
        raise NotImplementedError("only multi-head self-attention is "
                                  "ported")
    if dropout_rate or cache is not None:
        raise NotImplementedError("attention dropout and the KV cache are "
                                  "not ported in the Program front end")
    hidden = queries.shape[-1]
    qkv = layers.fc(input=queries, size=3 * hidden, num_flatten_dims=2)
    qkv = layers.sharding_constraint(qkv, ("batch", "length", "heads"))
    q = layers.slice(qkv, axes=[2], starts=[0], ends=[hidden])
    k = layers.slice(qkv, axes=[2], starts=[hidden], ends=[2 * hidden])
    v = layers.slice(qkv, axes=[2], starts=[2 * hidden], ends=[3 * hidden])
    for t in (q, k, v):
        t.desc.shape = tuple(qkv.shape[:-1]) + (hidden,)

    def _split_heads(x, n):
        reshaped = layers.reshape(x, shape=[0, 0, n, x.shape[-1] // n])
        t = layers.transpose(reshaped, perm=[0, 2, 1, 3])
        return layers.sharding_constraint(
            t, ("batch", "heads", "length", "kv"))

    def _merge_heads(x):
        t = layers.transpose(x, perm=[0, 2, 1, 3])
        merged = layers.reshape(t, shape=[0, 0, t.shape[2] * t.shape[3]])
        return layers.sharding_constraint(
            merged, ("batch", "length", "embed"))

    q = _split_heads(q, num_heads)
    k = _split_heads(k, num_heads)
    v = _split_heads(v, num_heads)
    helper = LayerHelper("fused_attention", input=q)
    out = helper.create_variable_for_type_inference(q.dtype)
    helper.append_op(type="fused_attention",
                     inputs={"Q": [q], "K": [k], "V": [v]},
                     outputs={"Out": [out]},
                     attrs={"causal": causal})
    out.desc.shape = tuple(q.shape[:-1]) + (v.shape[-1],)
    return _merge_heads(out)
