"""Paged KV-cache ops for incremental decode (counterpart of
``paddle_tpu/ops/kv_cache_ops.py``).

Per-layer K/V live in a block pool ``[num_blocks, block_len, heads,
head_dim]``; each decode slot owns a page-table row of block ids, and an
idle slot's row holds the sentinel ``num_blocks`` (one past the pool).

- `kv_cache_write` scatters new K/V rows into the pools through the page
  table, IN PLACE.  The JAX package returns updated pools functionally
  and the decode engine donates them so XLA aliases the update; PyTorch
  tensors are mutable, so the port writes straight into the pool.
  Masked, over-long and sentinel-page rows are filtered out before the
  scatter: JAX drops them with ``mode="drop"``, while an out-of-range
  index in a CUDA scatter is a device-side assert that kills the context.
- `paged_attention` is the serving ("fast") path: the paged-attention
  kernel (ops/kernels.py).
- `paged_attention_exact` is ``numerics="exact"``: the JAX op's
  ``exact=True`` branch.  Each slot's K/V are gathered over the whole
  span, the query is scattered into row ``Index`` of a zero ``[T, D]``
  matrix, the flash forward kernel runs causal in f32 over all T rows,
  and row ``Index`` is selected.  The flash kernel gives a row the same
  bits wherever the rest of the batch is (one q tile of 64 rows per
  block, each row's softmax its own, no split over keys, no shape-picked
  path), and a key past ``Index`` is masked to a zero weight, so the row
  is bitwise the one the full-prefix recompute at ``T = max_len`` gives
  it.
- `pos_encoding_add` and `batched_select` are the generation programs'
  positional add and per-row gather.

Each function is also the op rule of the same name, with the JAX rule's
slots and attributes, so the generation Programs (built by either
package) run on the port's Executor:

- ``kv_cache_write`` writes the pools in place and sets ``PoolKOut`` /
  ``PoolVOut`` to the very tensors fed as ``PoolK`` / ``PoolV`` (nothing
  is copied; the interpreter never skips the op).  The write plan takes
  one host sync (``torch.nonzero``), so the rules of one run share it,
  keyed on the identity of the ``PageTable``, ``Index`` and ``Length``
  tensors (`core.lowering.Interpreter.memo`): one plan a decode step,
  not one a layer.
- ``paged_attention`` runs the paged-attention kernel, or with
  ``exact=True`` `paged_attention_exact`.  The JAX rule's
  ``FLAGS_paged_attention`` switch and its XLA gather+GEMV branch are
  dispatch choices of the TPU: the port takes its kernel at every shape.
  A query at ``Index`` -1 sees no position and gives 0, as the JAX
  package's Pallas kernel does.
- ``pos_encoding_add`` with and without ``Index``, ``batched_select``
  with its ``offset``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import profiler
from ..core.registry import register_op
from .kernels import flash_attention_fwd, gather_slot_kv, paged_attention  # noqa: F401,E501


def write_plan(table: torch.Tensor, index: torch.Tensor, t: int,
               block_len: int, num_blocks: int,
               length: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where the ``t`` new rows of each slot go: returns ``(src, dst)``
    int64 vectors, ``src`` indexing the flattened ``[S*T]`` new rows and
    ``dst`` the flattened ``[N*L]`` pool rows, with every masked
    (position >= Length[s]), over-long (beyond the slot's pages) or
    unmapped (sentinel or foreign block id) row left out.  The plan
    depends only on the table and positions, so one plan serves every
    layer of a forward pass."""
    s, pages = table.shape
    dev = table.device
    steps = torch.arange(t, device=dev)
    pos = index.reshape(s, 1).long() + steps[None, :]            # [S, T]
    valid = pos < pages * block_len
    if length is not None:
        valid &= steps[None, :] < length.reshape(s, 1).long()
    page_idx = (pos // block_len).clamp(0, pages - 1)
    blk = torch.gather(table.long(), 1, page_idx)
    valid &= (blk >= 0) & (blk < num_blocks)
    dst = blk * block_len + pos % block_len
    src = torch.nonzero(valid.reshape(-1)).reshape(-1)
    return src, dst.reshape(-1)[src]


def kv_cache_write(k: torch.Tensor, v: torch.Tensor, pool_k: torch.Tensor,
                   pool_v: torch.Tensor, table: torch.Tensor,
                   index: torch.Tensor, length: Optional[torch.Tensor] = None,
                   plan: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Write K/V ``[S, T, H, D]`` into the pools ``[N, L, H, D]`` at
    positions ``Index[s] .. Index[s]+T-1`` of each slot, in place (cast to
    the pool dtype).  Rows at ``t >= Length[s]``, past the slot's pages
    or on an unmapped page are dropped.  ``plan`` is a precomputed
    `write_plan`.  Returns the (same) pool tensors."""
    n, block_len = pool_k.shape[0], pool_k.shape[1]
    if plan is None:
        plan = write_plan(table, index, k.shape[1], block_len, n, length)
    src, dst = plan
    # the decode attribution's "write" class is this range's device time
    with profiler.device_range("kv_cache.write"):
        for new, pool in ((k, pool_k), (v, pool_v)):
            rows = new.reshape((-1,) + tuple(pool.shape[2:]))
            flat = pool.view((n * block_len,) + tuple(pool.shape[2:]))
            flat.index_copy_(0, dst,
                             rows.index_select(0, src).to(pool.dtype))
    return pool_k, pool_v


def paged_attention_exact(q: torch.Tensor, pool_k: torch.Tensor,
                          pool_v: torch.Tensor, table: torch.Tensor,
                          index: torch.Tensor) -> torch.Tensor:
    """One decode query per slot, q ``[S, H, 1, D]``, attending positions
    ``0..Index[s]`` of its paged prefix, computed as the full-span causal
    attention of a ``[T, D]`` query matrix that holds q in row ``Index``
    (T = pages * block_len), in f32; -> ``[S, H, 1, D]`` in q's dtype."""
    s = q.shape[0]
    k = gather_slot_kv(pool_k, table).float().contiguous()   # [S, H, T, D]
    v = gather_slot_kv(pool_v, table).float().contiguous()
    t = k.shape[2]
    rows = torch.arange(s, device=q.device)
    idx = index.reshape(s).long().clamp(0, t - 1)
    q_full = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    q_full[rows, :, idx] = q[:, :, 0].float()
    out, _ = flash_attention_fwd(q_full, k, v, causal=True)
    return out[rows, :, idx].unsqueeze(2).to(q.dtype)


def pos_encoding_add(x: torch.Tensor, table: torch.Tensor,
                     index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x [B, T, D] + table[:T]`` (prefill), or with ``index``,
    ``x [S, D] + table[Index]`` (decode: each slot adds its own
    position's row; indices clip to the table like the JAX op)."""
    if index is not None:
        rows = table.index_select(
            0, index.reshape(-1).long().clamp(0, table.shape[0] - 1))
        return x + rows.reshape(x.shape)
    return x + table[None, :x.shape[-2], :]


def batched_select(x: torch.Tensor, index: torch.Tensor,
                   offset: int = 0) -> torch.Tensor:
    """``Out[b] = X[b, Index[b] + offset]`` along axis 1, clipped."""
    b = x.shape[0]
    idx = (index.reshape(b).long() + offset).clamp(0, x.shape[1] - 1)
    return x[torch.arange(b, device=x.device), idx]


# ---------------------------------------------------------------------------
# op rules
# ---------------------------------------------------------------------------

def _shared_plan(ctx, table, index, length, t, block_len, num_blocks):
    """The run's write plan for these page-table, index and length
    tensors (module docstring)."""
    key = ("kv_write_plan", id(table), id(index),
           None if length is None else id(length), t, block_len, num_blocks)
    hit = ctx.interpreter.memo.get(key)
    if hit is None:
        # the tensors ride along so that their ids stay theirs for the run
        hit = (write_plan(table, index, t, block_len, num_blocks, length),
               (table, index, length))
        ctx.interpreter.memo[key] = hit
    return hit[0]


@register_op("kv_cache_write",
             doc="scatter new K/V rows into the paged block pools through "
                 "the slot page table, in place (decode: T=1 append; "
                 "prefill: the bucket-padded prompt, masked by Length)")
def _kv_cache_write(ctx):
    k, v = ctx.input("K"), ctx.input("V")              # [S, T, H, D]
    pool_k, pool_v = ctx.input("PoolK"), ctx.input("PoolV")
    table, index = ctx.input("PageTable"), ctx.input("Index")
    length = ctx.input("Length")
    plan = _shared_plan(ctx, table, index, length, k.shape[1],
                        pool_k.shape[1], pool_k.shape[0])
    kv_cache_write(k, v, pool_k, pool_v, table, index, length, plan=plan)
    ctx.set_output("PoolKOut", pool_k)
    ctx.set_output("PoolVOut", pool_v)


@register_op("paged_attention",
             doc="one decode token per slot attends over its paged KV "
                 "prefix: the paged-attention kernel, or with exact=True "
                 "the f32 flash forward over the full span")
def _paged_attention(ctx):
    q = ctx.input("Q")                                   # [S, H, 1, D]
    pool_k, pool_v = ctx.input("PoolK"), ctx.input("PoolV")
    table = ctx.input("PageTable")
    s = q.shape[0]
    index = ctx.input("Index").reshape(s).to(torch.int32).contiguous()
    if ctx.attr("exact", False):
        out = paged_attention_exact(q, pool_k, pool_v, table, index)
    else:
        out = paged_attention(q.to(pool_k.dtype).contiguous(), pool_k,
                              pool_v, table.to(torch.int32).contiguous(),
                              index).to(q.dtype)
    ctx.set_output("Out", out)


@register_op("pos_encoding_add",
             doc="positional-encoding add of the generation programs: "
                 "X [B, T, D] + Table[:T], or with Index, X [S, D] + "
                 "Table[Index]")
def _pos_encoding_add(ctx):
    ctx.set_output("Out", pos_encoding_add(ctx.input("X"), ctx.input("Table"),
                                           ctx.input("Index")))


@register_op("batched_select",
             doc="per-row gather along axis 1: Out[b] = X[b, Index[b] + "
                 "offset], clipped")
def _batched_select(ctx):
    ctx.set_output("Out", batched_select(ctx.input("X"), ctx.input("Index"),
                                         ctx.attr("offset", 0)))
