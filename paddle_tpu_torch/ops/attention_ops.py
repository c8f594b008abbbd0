"""Attention: the ``fused_attention`` op rule of the training programs
(counterpart of the rule in ``paddle_tpu/ops/pallas_kernels.py``) and the
tensor-level self-attention of the serving model.

``fused_attention`` goes through `kernels.FlashAttention`: the flash
forward kernel, and the flash backward kernel under autograd.  The JAX
package's dispatch sends short sequences to an XLA matmul chain by a
table measured on the TPU; that table does not carry over to the card,
and a matmul chain in plain PyTorch is no port of the kernel, so every
length takes the flash kernels here.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .kernels import FlashAttention, flash_attention_fwd
from .kv_cache_ops import kv_cache_write, paged_attention


@register_op("fused_attention",
             doc="scaled-dot-product attention over [B, H, T, D] as ONE "
                 "op: the flash forward and backward kernels")
def _fused_attention(ctx):
    q, k, v = (ctx.input(s).contiguous() for s in ("Q", "K", "V"))
    ctx.set_output("Out", FlashAttention.apply(q, k, v,
                                               bool(ctx.attr("causal",
                                                             False))))


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, t, hidden = x.shape
    return x.reshape(b, t, n, hidden // n).transpose(1, 2)      # [B,H,T,Dh]


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def self_attention(x: torch.Tensor, qkv_weight: torch.Tensor,
                   qkv_bias: torch.Tensor, num_heads: int,
                   causal: bool = True, cache=None) -> torch.Tensor:
    """Multi-head self-attention over ``x [B, T, d]`` for the serving
    model: one ``[d, 3d]`` qkv projection, heads split to ``[B, H, T,
    d/H]``, attention, heads merged back to ``[B, T, d]``.  There is no
    output projection (the JAX model has none).

    ``cache`` (a ``models.transformer.KVCache``) makes the call read from
    and append to the paged KV cache: the new K/V rows are written into
    this layer's pools, then ``cache.mode == "decode"`` (one token per
    slot) runs the paged-attention kernel over each slot's cached prefix,
    while ``"prefill"`` runs the causal FlashAttention forward over the
    prompt itself.  Without a cache the call is the full causal attention
    of the training-shaped model."""
    b, t, hidden = x.shape
    qkv = torch.addmm(qkv_bias, x.reshape(b * t, hidden),
                      qkv_weight).reshape(b, t, 3 * hidden)
    q, k, v = qkv.split(hidden, dim=-1)
    q = _split_heads(q, num_heads)
    k = _split_heads(k, num_heads)
    v = _split_heads(v, num_heads)
    if cache is not None:
        pool_k, pool_v = cache.next_pools()
        kv_cache_write(k.transpose(1, 2), v.transpose(1, 2), pool_k, pool_v,
                       cache.pages, cache.index, cache.length,
                       plan=cache.plan)
        if cache.mode == "decode":
            out = paged_attention(q.contiguous(), pool_k, pool_v,
                                  cache.pages, cache.index)
            return _merge_heads(out)
    out, _ = flash_attention_fwd(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=causal)
    return _merge_heads(out)
