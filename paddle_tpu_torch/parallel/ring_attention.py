"""Sequence-parallel attention: ring attention and Ulysses (counterpart
of ``paddle_tpu/parallel/ring_attention.py``).

The JAX package runs each body under ``shard_map`` over an ``"sp"``
axis.  The port is SPMD (`parallel.mesh`), as `sharded_embedding_lookup`
is: q, k and v are this rank's ``[B, T/n, H, D]`` sequence shard (shard
i holds positions ``[i T/n, (i + 1) T/n)``), and the result is this
rank's output shard.  Each block of attention runs on the flash kernels
(`ops.kernels`), in their ``[B, H, T, D]`` layout.

- **Ring** (`ring_attention_local`).  K and V rotate around the axis's
  ring (`collectives.ppermute`, shift +1), and each block's
  `kernels.flash_attention_fwd` result merges into the running one by
  its log-sum-exp (`_merge`, in f32).  Causal: the block the rank holds
  at step i came from rank ``src = (my - i) % n``; blocks behind the
  rank (``src < my``) attend in full, the diagonal block causally, and
  blocks wholly in the future (``src > my``) are skipped (in the JAX
  body their -1e30 bias gives them weight exactly 0).  The hop still
  runs on every rank at every step, so the collectives stay matched.
  The port makes ``n - 1`` hops of K and of V: the JAX scan makes ``n``
  and throws the last away.  The backward (`_Ring`) runs
  `kernels.flash_attention_bwd` per block with the merged out and lse;
  dK and dV (f32) travel with their block around the ring, and one more
  hop takes them home: ``n - 1`` hops of K and V and ``n`` of dK and dV.
  In bf16 each block's out comes back from the kernel rounded to bf16
  before the f32 merge (the JAX body keeps an f32 accumulator), so bf16
  is held to the 2e-2 rule.
- **Ulysses** (`ulysses_attention_local`).  One all-to-all
  (`collectives.exchange`) swaps the sequence shard for a head shard,
  full-sequence attention runs through `kernels.FlashAttention` on H/n
  heads, and one all-to-all swaps back: four exchanges forward (q, k, v,
  out) and four backward.  H must divide by the axis size.

`sequence_parallel_attention` picks by strategy; `reference_attention`
is the whole-sequence oracle.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import collectives as coll
from ..ops import kernels as K

NEG_INF = -1e30


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """[B, T, H, D] -> the kernels' contiguous [B, H, T, D]."""
    return t.transpose(1, 2).contiguous()


def _block_attn(q, k, v, causal: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One attention block over [B, H, T, D]: the flash forward kernel ->
    (out [B, H, Tq, D] in q's dtype, normalised; lse [B, H, Tq] f32)."""
    return K.flash_attention_fwd(q, k, v, causal)


def _merge(o1, lse1, o2, lse2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two normalised partials over disjoint keys -> their union's, in
    f32: ``lse = log(e^lse1 + e^lse2)``, ``o = o1 e^(lse1 - lse) +
    o2 e^(lse2 - lse)``."""
    lse = torch.logaddexp(lse1, lse2)
    o = (o1.float() * torch.exp(lse1 - lse)[..., None]
         + o2.float() * torch.exp(lse2 - lse)[..., None])
    return o, lse


def _block_kind(src: int, my: int, causal: bool) -> Optional[bool]:
    """The block from shard ``src`` seen by shard ``my``: None (skipped,
    wholly in the future), else whether it is masked causally."""
    if not causal or src < my:
        return False
    return True if src == my else None


def _ring_forward(q, k, v, group, axis, n, my, causal):
    """Kernel layout in and out -> (out in q's dtype, lse f32)."""
    o = lse = None
    for i in range(n):
        kind = _block_kind((my - i) % n, my, causal)
        if kind is not None:
            o_i, lse_i = _block_attn(q, k, v, kind)
            o, lse = (o_i, lse_i) if o is None else _merge(o, lse, o_i,
                                                           lse_i)
        if i < n - 1:
            k = coll.hop(k, group, axis, 1)
            v = coll.hop(v, group, axis, 1)
    return o.to(q.dtype), lse


class _Ring(torch.autograd.Function):
    """Ring attention over this rank's [B, H, T/n, D] shards whose
    backward runs the flash backward kernel per block (module
    docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, group, axis, n, my, causal):
        out, lse = _ring_forward(q, k, v, group, axis, n, my, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.meta = (group, axis, n, my, causal)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, axis, n, my, causal = ctx.meta
        dout = dout.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        for i in range(n):
            kind = _block_kind((my - i) % n, my, causal)
            if kind is not None:
                dq_i, dk_i, dv_i = K.flash_attention_bwd(q, k, v, out, lse,
                                                         dout, kind)
                dq += dq_i.float()
                dk += dk_i.float()
                dv += dv_i.float()
            if i < n - 1:
                k = coll.hop(k, group, axis, 1)
                v = coll.hop(v, group, axis, 1)
            # dK and dV ride with their block; the last hop takes them home
            dk = coll.hop(dk, group, axis, 1)
            dv = coll.hop(dv, group, axis, 1)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def ring_attention_local(q, k, v, mesh, axis: str = "sp",
                         causal: bool = False) -> torch.Tensor:
    """This rank's ring attention: q, k, v its ``[B, T/n, H, D]``
    shards -> its ``[B, T/n, H, D]`` output shard (module docstring).
    Differentiable in q, k and v."""
    group, n, my = coll.on_axis(mesh, axis)
    qh, kh, vh = (_heads_first(t) for t in (q, k, v))
    if any(t.requires_grad for t in (q, k, v)) and torch.is_grad_enabled():
        out = _Ring.apply(qh, kh, vh, group, axis, n, my, bool(causal))
    else:
        out = _ring_forward(qh, kh, vh, group, axis, n, my,
                            bool(causal))[0]
    return out.transpose(1, 2)


def ulysses_attention_local(q, k, v, mesh, axis: str = "sp",
                            causal: bool = False) -> torch.Tensor:
    """This rank's Ulysses attention: q, k, v its ``[B, T/n, H, D]``
    shards -> its output shard; H must divide by the axis size."""
    group, n, _ = coll.on_axis(mesh, axis)
    b, tl, h, d = q.shape
    if h % n:
        raise ValueError(f"ulysses_attention_local: {h} heads do not split "
                         f"over the {n} ranks of axis {axis!r}")
    hl = h // n

    def seq_to_head(x):
        # [B, Tl, H, D] -> head group j to rank j as dim 0 -> back from
        # each rank its time block -> [B, H/n, T, D]
        x = x.reshape(b, tl, n, hl, d).permute(2, 0, 1, 3, 4).contiguous()
        x = coll.exchange(x, group, axis)
        return x.permute(1, 3, 0, 2, 4).reshape(b, hl, n * tl, d)

    def head_to_seq(x):
        # [B, H/n, T, D] -> time block j to rank j -> back from each rank
        # its head group -> [B, Tl, H, D] in global head order
        x = x.reshape(b, hl, n, tl, d).permute(2, 0, 3, 1, 4).contiguous()
        x = coll.exchange(x, group, axis)
        return x.permute(1, 2, 0, 3, 4).reshape(b, tl, h, d)

    qf, kf, vf = (seq_to_head(t).contiguous() for t in (q, k, v))
    return head_to_seq(K.FlashAttention.apply(qf, kf, vf, bool(causal)))


def sequence_parallel_attention(q, k, v, mesh, axis: str = "sp",
                                strategy: str = "ring",
                                causal: bool = False) -> torch.Tensor:
    """This rank's shards in, its output shard out, by ``strategy``
    (``"ring"``, else Ulysses, as the JAX entry picks)."""
    local = (ring_attention_local if strategy == "ring"
             else ulysses_attention_local)
    return local(q, k, v, mesh, axis=axis, causal=causal)


def reference_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """Whole-sequence oracle over [B, T, H, D]: f32 scores and softmax,
    the result in q's dtype."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    if causal:
        t = q.shape[1]
        mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)
