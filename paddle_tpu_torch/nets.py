"""Composite layers (counterpart of ``paddle_tpu/nets.py``; only the
self-attention branch of ``scaled_dot_product_attention`` is ported)."""
from __future__ import annotations

from . import layers
from .layer_helper import LayerHelper


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
