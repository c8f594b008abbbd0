"""Structured control-flow op rules (counterpart of
``paddle_tpu/ops/control_ops.py``): ``while``, ``conditional_block``,
``if_else`` and ``parallel_do``.

The JAX rules lower to XLA's structured primitives; the port runs the
sub-blocks eagerly on the executor's device, with the JAX rules'
semantics:

- ``while`` is a host loop.  Each trip runs the body over the entry env
  plus the carried vars (``carry_vars``) and reads the condition back,
  one device-to-host sync a trip.  A bounded loop (``max_trip_count``,
  the JAX rule's masked ``lax.scan``) stops there, warns under
  ``FLAGS.check_nan_inf`` when the condition is still true, and
  differentiates: autograd records each trip.  An unbounded loop (the
  JAX rule's ``lax.while_loop``) gives the same forward result, and
  refuses reverse-mode differentiation as JAX does: a carried value that
  depends on a differentiated input raises ``ValueError`` when a
  gradient reaches it;
- ``conditional_block`` reads its scalar condition on the host and runs
  the block or keeps the assigned vars' prior values (``lax.cond``);
- ``if_else`` runs both branches on the whole batch and selects rows by
  the mask, as the JAX rule does: no dynamic shapes reach the card;
- ``parallel_do`` runs its block once over the whole batch (the JAX rule
  leaves the split to SPMD sharding).

CSP programs (channels, ``go``, ``select``), whose While the JAX rule
runs as a host loop over host objects, wait for queue A item 6.
"""
from __future__ import annotations

import warnings

import torch

from ..core.lowering import ExecContext
from ..core.registry import register_op
from ..flags import FLAGS


def _truth(v) -> bool:
    return bool(v.reshape(()).item()) if isinstance(v, torch.Tensor) \
        else bool(v)


class _UnboundedLoopOutput(torch.autograd.Function):
    """Identity on a carried value of an unbounded While; its backward
    refuses, as reverse-mode differentiation of ``lax.while_loop`` does."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        raise ValueError(
            "Reverse-mode differentiation does not work for an unbounded "
            "While (lax.while_loop in the JAX package); give the While a "
            "max_trip_count")


@register_op("while", doc="while_op.cc: a host loop over the carried vars")
def _while(ctx: ExecContext):
    sub = ctx.program.blocks[ctx.attr("sub_block")]
    carry = list(ctx.attr("carry_vars"))
    cond_name = ctx.input_name("Condition")
    if cond_name not in carry:
        raise ValueError(
            f"While: condition var '{cond_name}' is never updated inside "
            "the block; the loop would not terminate")
    max_trips = ctx.attr("max_trip_count")
    base = dict(ctx.env)
    vals = {n: ctx.env[n] for n in carry}
    trips = 0
    while _truth(vals[cond_name]) and (max_trips is None
                                       or trips < int(max_trips)):
        env = dict(base)
        env.update(vals)
        ctx.run_sub_block(sub, env)
        vals = {n: env[n] for n in carry}
        trips += 1
    if (max_trips is not None and FLAGS.check_nan_inf
            and _truth(vals[cond_name])):
        warnings.warn("While: condition still True after max_trip_count="
                      f"{int(max_trips)} iterations; result is truncated")
    for name, val in vals.items():
        if (max_trips is None and isinstance(val, torch.Tensor)
                and val.requires_grad):
            val = _UnboundedLoopOutput.apply(val)
        ctx.env[name] = val


@register_op("conditional_block",
             doc="conditional_block_op.cc: run the block iff the scalar "
                 "condition holds; the assigned vars keep their prior "
                 "values otherwise")
def _conditional_block(ctx: ExecContext):
    sub = ctx.program.blocks[ctx.attr("sub_block")]
    out_names = ctx.attr("out_vars")
    for n in out_names:
        if n not in ctx.env:
            raise ValueError(
                f"conditional_block: output var '{n}' must be initialised "
                "before the block (the skipped branch keeps prior values)")
    if not _truth(ctx.input("Cond")):
        return
    env = dict(ctx.env)
    ctx.run_sub_block(sub, env)
    for n in out_names:
        ctx.env[n] = env[n]


@register_op("if_else",
             doc="IfElse row routing: both branches run on the whole "
                 "batch, outputs merged row-wise by the condition")
def _if_else(ctx: ExecContext):
    mask = ctx.input("Cond").reshape(-1).bool()

    def branch(block_attr, pairs_attr, outs_attr):
        env = dict(ctx.env)
        for outer, inner in ctx.attr(pairs_attr):
            env[inner] = ctx.env[outer]
        ctx.run_sub_block(ctx.program.blocks[ctx.attr(block_attr)], env)
        return [env[n] for n in ctx.attr(outs_attr)]

    tvals = branch("true_block", "true_inputs", "true_outputs")
    fvals = branch("false_block", "false_inputs", "false_outputs")
    ctx.set_outputs("Out", [
        torch.where(mask.reshape((-1,) + (1,) * (tv.dim() - 1)), tv, fv)
        for tv, fv in zip(tvals, fvals)])


@register_op("parallel_do",
             doc="parallel_do_op.cc: the block runs once over the batch "
                 "this rank holds: the whole batch on one device, the "
                 "rank's data-axis slice under a fast mesh (whose "
                 "backward reduces the gradients over the data axis), "
                 "as the JAX rule runs under GSPMD")
def _parallel_do(ctx: ExecContext):
    env = dict(ctx.env)
    for outer, inner in ctx.attr("input_pairs"):
        env[inner] = ctx.env[outer]
    ctx.run_sub_block(ctx.program.blocks[ctx.attr("sub_block")], env)
    ctx.set_outputs("Out", [env[n] for n in ctx.attr("output_vars")])
