"""LoD-machinery op rules (counterpart of ``paddle_tpu/ops/lod_ops.py``).

The reference runs dynamic RNNs op by op with these: rank-sort the
sequences, bucket time steps into a tensor array, shrink the live rows a
step.  Here, as in the JAX package, they compose on the padded
[B, T, ...] + ``@SEQ_LEN`` representation:

- a rank table is the row order by length, longest first (stable), with
  the lengths as its ``@SEQ_LEN`` companion;
- a tensor array is a Python list of [B, ...] time-step slices;
- shrinking a memory masks the rows whose sequence has ended (no shape
  shrink: the JAX package keeps static shapes, and so does the port);
- split/merge give full-size masked halves that merge back to the input
  (row routing itself is ``if_else``'s select).
"""
from __future__ import annotations

import torch

from ..core.lowering import LEN_SUFFIX, ExecContext
from ..core.registry import register_op


def _rank_lengths(ctx: ExecContext):
    lens = ctx.env.get(ctx.input_name("RankTable") + LEN_SUFFIX)
    if lens is None:
        raise ValueError(f"{ctx.op.type}: RankTable input has no sequence "
                         "lengths; pass a lod_rank_table output")
    return lens


@register_op("lod_rank_table",
             doc="rank table = (rows sorted by length, longest first; the "
                 "lengths)")
def _lod_rank_table(ctx: ExecContext):
    x = ctx.input("X")
    lens = ctx.seq_len_of("X")
    if lens is None:
        lens = torch.full((x.shape[0],), x.shape[1] if x.dim() > 1 else 1,
                          dtype=torch.int32, device=x.device)
    order = torch.sort(-lens.long(), stable=True).indices.to(torch.int32)
    ctx.set_output("Out", order)
    ctx.env[ctx.output_name("Out") + LEN_SUFFIX] = lens


@register_op("max_sequence_len", doc="max_sequence_len_op.cc")
def _max_sequence_len(ctx: ExecContext):
    ctx.set_output("Out", _rank_lengths(ctx).max().reshape(1).to(
        torch.int32))


@register_op("reorder_lod_tensor_by_rank",
             doc="gather rows into the rank table's order")
def _reorder_lod_tensor_by_rank(ctx: ExecContext):
    order = ctx.input("RankTable").long()
    ctx.set_output("Out", ctx.input("X")[order])
    lens = ctx.seq_len_of("X")
    if lens is not None:
        ctx.set_seq_len("Out", lens[order])


@register_op("lod_tensor_to_array",
             doc="padded [B, T, ...] -> an array of T time-step slices")
def _lod_tensor_to_array(ctx: ExecContext):
    x = ctx.input("X")
    ctx.env[ctx.output_name("Out")] = [x[:, t] for t in range(x.shape[1])]


@register_op("array_to_lod_tensor",
             doc="stack the time-step slices back to padded [B, T, ...]")
def _array_to_lod_tensor(ctx: ExecContext):
    ctx.set_output("Out", torch.stack(list(ctx.input("X")), dim=1))


@register_op("shrink_rnn_memory",
             doc="rows whose sequence ended are masked (no shape shrink)")
def _shrink_rnn_memory(ctx: ExecContext):
    x = ctx.input("X")                     # [B, ...] the memory
    lens = _rank_lengths(ctx)
    step = ctx.input("I").reshape(()).to(lens.dtype)
    alive = (step < lens).to(x.dtype)
    ctx.set_output("Out", x * alive.reshape((x.shape[0],)
                                            + (1,) * (x.dim() - 1)))


@register_op("rnn_memory_helper", doc="rnn_memory_helper_op.cc: identity "
             "(autograd does its gradient plumbing)")
def _rnn_memory_helper(ctx: ExecContext):
    ctx.set_output("Out", ctx.input("X"))


def _row_mask(mask, like):
    m = mask.reshape(-1).bool()
    return m.reshape((-1,) + (1,) * (like.dim() - 1))


@register_op("split_lod_tensor",
             doc="masked full-size halves; merge_lod_tensor restores the "
                 "input")
def _split_lod_tensor(ctx: ExecContext):
    x = ctx.input("X")
    m = _row_mask(ctx.input("Mask"), x)
    zero = torch.zeros_like(x)
    ctx.set_output("OutTrue", torch.where(m, x, zero))
    ctx.set_output("OutFalse", torch.where(m, zero, x))


@register_op("merge_lod_tensor", doc="merge_lod_tensor_op.cc")
def _merge_lod_tensor(ctx: ExecContext):
    in_true = ctx.input("InTrue")
    ctx.set_output("Out", torch.where(_row_mask(ctx.input("Mask"), in_true),
                                      in_true, ctx.input("InFalse")))


@register_op("lod_array_length", doc="lod_array_length_op.cc: the array's "
             "length, shape [1]")
def _lod_array_length(ctx: ExecContext):
    ctx.set_output("Out", torch.tensor([len(ctx.input("X"))],
                                       dtype=torch.int32, device=ctx.device))


@register_op("delete_var", doc="delete_var_op.cc: frees env slots early")
def _delete_var(ctx: ExecContext):
    for name in ctx.op.desc.input_names():
        ctx.env.pop(name, None)
