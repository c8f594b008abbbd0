"""Attention: the ``fused_attention`` op rule of the training programs
(counterpart of the rule in ``paddle_tpu/ops/pallas_kernels.py``) and the
tensor-level self-attention of the serving model.

``fused_attention`` goes through `kernels.FlashAttention`: the flash
forward kernel, and the flash backward kernel under autograd.  The JAX
package's dispatch sends short sequences to an XLA matmul chain by a
table measured on the TPU; that table does not carry over to the card,
and a matmul chain in plain PyTorch is no port of the kernel, so every
length takes the flash kernels here.

Under ``exact`` (the decode engine's ``numerics="exact"``, and a
Program's ``exact_lowering`` for ``fused_attention``) every product
goes through the row-stable product kernel (`kernels.row_stable_mm`) and
every attention runs in f32 on the flash forward kernel, over the full
span for a decode step (`kv_cache_ops.paged_attention_exact`), so that a
row's bits never depend on the batch it is in.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .kernels import FlashAttention, flash_attention_fwd, row_stable_mm
from .kv_cache_ops import (kv_cache_write, paged_attention,
                           paged_attention_exact)


@register_op("fused_attention",
             doc="scaled-dot-product attention over [B, H, T, D] as ONE "
                 "op: the flash forward and backward kernels")
def _fused_attention(ctx):
    """Under ``program.exact_lowering`` the flash forward in f32."""
    q, k, v = (ctx.input(s).contiguous() for s in ("Q", "K", "V"))
    causal = bool(ctx.attr("causal", False))
    if ctx.program.exact_lowering:
        ctx.set_output("Out", _flash_f32(q, k, v, causal))
        return
    ctx.set_output("Out", FlashAttention.apply(q, k, v, causal))


def linear(x2: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           exact: bool = False) -> torch.Tensor:
    """``x2 [M, K] @ w [K, N] + b`` in x2's dtype: ``torch.addmm``, or
    under ``exact`` the row-stable product kernel in f32."""
    if exact:
        return row_stable_mm(x2.float().contiguous(), w.float().contiguous(),
                             b.float()).to(x2.dtype)
    return torch.addmm(b, x2, w)


def _flash_f32(q, k, v, causal):
    """The flash forward in f32, rounded back to q's dtype."""
    out, _ = flash_attention_fwd(q.float().contiguous(),
                                 k.float().contiguous(),
                                 v.float().contiguous(), causal=causal)
    return out.to(q.dtype)


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, t, hidden = x.shape
    return x.reshape(b, t, n, hidden // n).transpose(1, 2)      # [B,H,T,Dh]


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def self_attention(x: torch.Tensor, qkv_weight: torch.Tensor,
                   qkv_bias: torch.Tensor, num_heads: int,
                   causal: bool = True, cache=None,
                   exact: bool = False) -> torch.Tensor:
    """Multi-head self-attention over ``x [B, T, d]`` for the serving
    model: one ``[d, 3d]`` qkv projection, heads split to ``[B, H, T,
    d/H]``, attention, heads merged back to ``[B, T, d]``.  There is no
    output projection (the JAX model has none).

    ``cache`` (a ``models.transformer.PagedKVView``) makes the call read from
    and append to the paged KV cache: the new K/V rows are written into
    this layer's pools, then ``cache.mode == "decode"`` (one token per
    slot) runs the paged-attention kernel over each slot's cached prefix,
    while ``"prefill"`` runs the causal FlashAttention forward over the
    prompt itself.  Without a cache the call is the full causal attention
    of the training-shaped model.

    A KV pool may be wider than the activations (f32 pools under int8
    serving): the decode query is cast to the pool dtype for the kernel
    and the result back.  ``exact`` takes the row-stable paths (module
    docstring)."""
    b, t, hidden = x.shape
    qkv = linear(x.reshape(b * t, hidden), qkv_weight, qkv_bias,
                 exact).reshape(b, t, 3 * hidden)
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
            if exact:
                out = paged_attention_exact(q, pool_k, pool_v, cache.pages,
                                            cache.index)
            else:
                out = paged_attention(q.to(pool_k.dtype).contiguous(),
                                      pool_k, pool_v, cache.pages,
                                      cache.index).to(q.dtype)
            return _merge_heads(out)
    if exact:
        return _merge_heads(_flash_f32(q, k, v, causal))
    out, _ = flash_attention_fwd(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=causal)
    return _merge_heads(out)
