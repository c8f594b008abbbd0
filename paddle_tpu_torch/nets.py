"""Composite layers (counterpart of ``paddle_tpu/nets.py``): the image
helpers ``simple_img_conv_pool`` and ``img_conv_group``,
``sequence_conv_pool``, ``glu`` and ``scaled_dot_product_attention``."""
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
    """Multi-head attention over [batch, seq, dim] program variables, with
    the JAX package's ops, attributes, names and shapes:

    - self-attention (``queries is keys is values``) with several heads:
      one ``[d, 3d]`` fc and q/k/v slices; cross-attention: three ``[d,
      d]`` fcs; one head: no projection, and ``[B, 1, T, D]`` reshapes
      around the attention op;
    - with ``use_fused`` or ``causal`` and no attention dropout, ONE
      ``fused_attention`` op (the flash kernels); else the ``scale`` /
      ``matmul`` / ``softmax`` / ``dropout`` / ``matmul`` chain;
    - ``cache`` (a ``models.transformer.KVCache`` build handle): the
      projections' K/V go into the paged pools through a
      ``kv_cache_write`` (as ``[B, T, H, D]``), then ``cache.mode ==
      "decode"`` emits ``paged_attention`` over the cached prefix and
      ``"prefill"`` a causal ``fused_attention`` over the prompt.

    Causal attention with attention dropout, and the KV cache with any
    dropout, raise ValueError."""
    if num_heads > 1:
        hidden = queries.shape[-1]
        if queries is keys and keys is values:
            qkv = layers.fc(input=queries, size=3 * hidden,
                            num_flatten_dims=2)
            qkv = layers.sharding_constraint(
                qkv, ("batch", "length", "heads"))
            q = layers.slice(qkv, axes=[2], starts=[0], ends=[hidden])
            k = layers.slice(qkv, axes=[2], starts=[hidden],
                             ends=[2 * hidden])
            v = layers.slice(qkv, axes=[2], starts=[2 * hidden],
                             ends=[3 * hidden])
            for t in (q, k, v):
                t.desc.shape = tuple(qkv.shape[:-1]) + (hidden,)
        else:
            q = layers.fc(input=queries, size=hidden, num_flatten_dims=2)
            k = layers.fc(input=keys, size=hidden, num_flatten_dims=2)
            v = layers.fc(input=values, size=hidden, num_flatten_dims=2)
    else:
        q, k, v = queries, keys, values

    def _split_heads(x, n):
        if n == 1:
            return x
        reshaped = layers.reshape(x, shape=[0, 0, n, x.shape[-1] // n])
        t = layers.transpose(reshaped, perm=[0, 2, 1, 3])
        return layers.sharding_constraint(
            t, ("batch", "heads", "length", "kv"))

    def _merge_heads(x, n):
        if n == 1:
            return x
        t = layers.transpose(x, perm=[0, 2, 1, 3])
        merged = layers.reshape(t, shape=[0, 0, t.shape[2] * t.shape[3]])
        return layers.sharding_constraint(
            merged, ("batch", "length", "embed"))

    def _one_head(*xs):
        """[B, T, D] -> [B, 1, T, D], the attention ops' layout."""
        return [layers.reshape(x, shape=[0, 1] + list(x.shape[1:]))
                for x in xs]

    def _attention_op(op_type, inputs, attrs, q, v):
        helper = LayerHelper(op_type, input=q)
        out = helper.create_variable_for_type_inference(q.dtype)
        helper.append_op(type=op_type, inputs=inputs,
                         outputs={"Out": [out]}, attrs=attrs)
        out.desc.shape = tuple(q.shape[:-1]) + (v.shape[-1],)
        return out

    def _finish(out, single):
        if single:
            return layers.reshape(out, shape=[0] + list(out.shape[2:]))
        return _merge_heads(out, num_heads)

    if causal and dropout_rate:
        raise ValueError("causal attention with attention dropout is not "
                         "supported; drop out the projections instead")
    q = _split_heads(q, num_heads)
    k = _split_heads(k, num_heads)
    v = _split_heads(v, num_heads)
    single = num_heads == 1
    if cache is not None:
        if dropout_rate:
            raise ValueError("KV-cache attention has no dropout "
                             "(generation path)")
        if single:
            q, k, v = _one_head(q, k, v)
        pool_k, pool_v = cache.next_pools()
        # the pools are [block, pos, head, dim]: new rows go in as
        # [B, T, H, D]
        kt = layers.transpose(k, perm=[0, 2, 1, 3])
        vt = layers.transpose(v, perm=[0, 2, 1, 3])
        helper = LayerHelper("kv_cache_write", input=kt)
        pk_out = helper.create_variable_for_type_inference(pool_k.dtype)
        pv_out = helper.create_variable_for_type_inference(pool_v.dtype)
        inputs = {"K": [kt], "V": [vt], "PoolK": [pool_k],
                  "PoolV": [pool_v], "PageTable": [cache.pages],
                  "Index": [cache.index]}
        if cache.length is not None:
            inputs["Length"] = [cache.length]
        helper.append_op(type="kv_cache_write", inputs=inputs,
                         outputs={"PoolKOut": [pk_out],
                                  "PoolVOut": [pv_out]})
        pk_out.desc.shape = pool_k.shape
        pv_out.desc.shape = pool_v.shape
        cache.record_update(pk_out, pv_out)
        if cache.mode == "decode":
            out = _attention_op(
                "paged_attention",
                {"Q": [q], "PoolK": [pk_out], "PoolV": [pv_out],
                 "PageTable": [cache.pages], "Index": [cache.index]},
                {"exact": cache.exact}, q, v)
        else:
            # prefill: the causal attention over the prompt answers; the
            # write above has cached its K/V
            out = _attention_op("fused_attention",
                                {"Q": [q], "K": [k], "V": [v]},
                                {"causal": True}, q, v)
        return _finish(out, single)
    if (use_fused or causal) and not dropout_rate:
        if single:
            q, k, v = _one_head(q, k, v)
        out = _attention_op("fused_attention", {"Q": [q], "K": [k],
                                                "V": [v]},
                            {"causal": causal}, q, v)
        return _finish(out, single)
    d = q.shape[-1]
    scaled_q = layers.scale(q, scale=d ** -0.5)
    product = layers.matmul(scaled_q, k, transpose_y=True)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    ctx = layers.matmul(weights, v)
    return _merge_heads(ctx, num_heads)
