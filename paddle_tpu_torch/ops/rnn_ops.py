"""The ``dynamic_rnn`` op (counterpart of ``paddle_tpu/ops/rnn_ops.py``):
runs a DynamicRNN's or StaticRNN's step sub-block over time.

The JAX rule traces the step block once into a ``lax.scan`` body.  The
port runs it eagerly: a loop over T on the executor's device, each step
interpreting the block's ops (autograd records through the loop, so the
backward op differentiates it like any other op).  Per-step length masks
take the place of the reference's shrinking batches: past its length a
row keeps its memories and outputs 0, and the outputs carry the step
input's ``@SEQ_LEN``.

Two program transforms of the JAX rule are kept:

- **hoisting**: the ops that depend only on step inputs and parameters
  (the per-gate input projections of a hand-built cell) run once over the
  flattened [B*T] batch before the loop, so 4*T per-step input products
  become four full-sequence ones.  The JAX rule hoists only when it runs
  on the CPU (``FLAGS_dynrnn_hoist=auto``, measured slower on its TPU
  backend); the port always hoists, on the CPU and on the card;
- **same-LHS mul merging**: the ``mul`` ops of the loop body that share
  their X (the four h-projections of the cell) run as one product with
  the concatenated weights.

``FLAGS_scan_unroll`` has no meaning for an eager loop and is not ported.
"""
from __future__ import annotations

import torch

from ..core.lowering import LEN_SUFFIX, ExecContext
from ..core.registry import OpRegistry, register_op
from ..core.types import to_torch_dtype
from .math_ops import amp_on

#: op types that may run once over the flattened [B*T] batch
HOISTABLE = {"mul", "elementwise_add", "elementwise_sub", "elementwise_mul",
             "scale", "sigmoid", "tanh", "relu", "cast", "softmax", "sum"}


def _pairs(attr):
    """(outer, inner) name pairs of a step or static input attribute:
    tuples when the program was built, lists after a JSON round trip."""
    return [tuple(p) for p in attr or ()]


def _hoist(ctx, sub, base_env, step_pairs, mem_specs, b, t):
    """Run the hoistable ops of the step block once over [B*T] -> (the
    hoisted ops' ids, inner name -> [B*T, ...] value)."""
    hoisted = {inner: ctx.env[outer].reshape((b * t,)
                                             + ctx.env[outer].shape[2:])
               for outer, inner in step_pairs}
    gblock = ctx.program.global_block()

    def safe(n):
        # flattened [B*T] values may only meet parameters: a per-batch
        # [B, ...] value (a static input, an outer activation) would
        # broadcast wrongly against the flattened batch
        if n in hoisted:
            return True
        var = gblock.vars.get(n)
        return n in base_env and var is not None and var.persistable

    blocked = {m["step"] for m in mem_specs} | {m["new"] for m in mem_specs}
    ops = set()
    for op in sub.ops:
        ins, outs = op.desc.input_names(), op.desc.output_names()
        if (op.type in HOISTABLE and ins
                and not any(n in blocked for n in ins)
                and any(n in hoisted for n in ins)
                and all(safe(n) for n in ins)):
            env = dict(base_env)
            env.update(hoisted)
            OpRegistry.get(op.type).fn(
                ExecContext(op, env, ctx.program, sub, ctx.interpreter))
            hoisted.update((n, env[n]) for n in outs if n in env)
            ops.add(id(op))
        else:
            # anything downstream of an op that stays in the loop stays too
            blocked.update(outs)
    return ops, hoisted


def _merge_muls(body_ops, base_env, amp):
    """Group the body's 2-D ``mul`` ops by their X -> (id(op) -> (X name,
    first column, end column), X name -> concatenated weight)."""
    groups = {}
    for op in body_ops:
        if (op.type == "mul" and op.desc.attrs.get("x_num_col_dims", 1) == 1
                and op.desc.attrs.get("y_num_col_dims", 1) == 1):
            yn = op.desc.inputs["Y"][0]
            if yn in base_env and base_env[yn].dim() == 2:
                groups.setdefault(op.desc.inputs["X"][0], []).append(op)
    merged, wcat = {}, {}
    for xn, ops in groups.items():
        ws = [base_env[op.desc.inputs["Y"][0]] for op in ops]
        if len(ops) < 2 or len({w.shape[0] for w in ws}) != 1:
            continue
        cat = torch.cat(ws, dim=1)
        if amp and cat.dtype == torch.float32:
            # the cast amp_operands applies to each unmerged mul
            cat = cat.to(torch.bfloat16)
        wcat[xn] = cat
        lo = 0
        for op, w in zip(ops, ws):
            merged[id(op)] = (xn, lo, lo + w.shape[1])
            lo += w.shape[1]
    return merged, wcat


@register_op("dynamic_rnn")
def _dynamic_rnn(ctx: ExecContext):
    prog = ctx.program
    sub = prog.blocks[ctx.attr("sub_block")]
    step_pairs = _pairs(ctx.attr("step_inputs"))
    static_pairs = _pairs(ctx.attr("static_inputs"))
    mem_specs = ctx.attr("memories")      # [{step, new, init, value, ...}]
    out_names = ctx.attr("output_vars")   # in-block names
    xs = [ctx.env[outer] for outer, _ in step_pairs]
    b, t = xs[0].shape[0], xs[0].shape[1]
    lens = (ctx.env.get(step_pairs[0][0] + LEN_SUFFIX)
            if ctx.attr("dynamic", True) else None)

    base_env = dict(ctx.env)
    for outer, inner in static_pairs:
        base_env[inner] = ctx.env[outer]
        if outer + LEN_SUFFIX in ctx.env:
            base_env[inner + LEN_SUFFIX] = ctx.env[outer + LEN_SUFFIX]
    mems = [ctx.env[m["init"]] if m.get("init") else torch.full(
                (b,) + tuple(m["shape"]), m.get("value", 0.0),
                dtype=to_torch_dtype(m.get("dtype", "float32")),
                device=ctx.device)
            for m in mem_specs]

    hoisted_ops, hoisted = _hoist(ctx, sub, base_env, step_pairs, mem_specs,
                                  b, t)
    inner_steps = {inner for _, inner in step_pairs}
    body_ops = [op for op in sub.ops if id(op) not in hoisted_ops]
    # hoisted values the loop reads become extra per-step inputs
    read = {n for op in body_ops for n in op.desc.input_names()}
    read.update(out_names)
    read.update(m["new"] for m in mem_specs)
    extra = sorted(n for n in read if n in hoisted and n not in inner_steps)
    steps = [(inner, ctx.env[outer].transpose(0, 1))
             for outer, inner in step_pairs]
    steps += [(n, hoisted[n].reshape((b, t) + hoisted[n].shape[1:])
               .transpose(0, 1)) for n in extra]
    amp = amp_on(ctx)
    merged, wcat = _merge_muls(body_ops, base_env, amp)

    outs = [[] for _ in out_names]
    for i in range(t):
        env = dict(base_env)
        env.update((n, x[i]) for n, x in steps)
        env.update((m["step"], v) for m, v in zip(mem_specs, mems))
        products = {}
        for op in body_ops:
            if id(op) in merged:
                xn, lo, hi = merged[id(op)]
                if xn not in products:
                    x_in = env[xn]
                    products[xn] = torch.matmul(
                        x_in.to(wcat[xn].dtype), wcat[xn]).to(
                            torch.bfloat16 if amp else x_in.dtype)
                out = op.desc.outputs["Out"][0]
                env[out] = products[xn][:, lo:hi]
                # mul carries X's lengths; so must the merged product
                if xn + LEN_SUFFIX in env:
                    env[out + LEN_SUFFIX] = env[xn + LEN_SUFFIX]
                continue
            OpRegistry.get(op.type).fn(
                ExecContext(op, env, prog, sub, ctx.interpreter))
        alive = ((i < lens).to(xs[0].dtype) if lens is not None
                 else torch.ones((b,), device=ctx.device))

        def live(v):
            return alive.reshape((b,) + (1,) * (v.dim() - 1)).to(v.dtype)

        # a memory keeps its dtype (under amp the step may produce bf16)
        mems = [(live(new) * new + (1 - live(new)) * prev).to(prev.dtype)
                for new, prev in ((env.get(m["new"], p), p)
                                  for m, p in zip(mem_specs, mems))]
        for acc, name in zip(outs, out_names):
            acc.append(env[name] * live(env[name]))

    for slot, acc in zip(ctx.output_names("Out"), outs):
        ctx.env[slot] = torch.stack(acc, dim=1)          # [B, T, ...]
        if lens is not None:
            ctx.env[slot + LEN_SUFFIX] = lens
    for slot, m in zip(ctx.output_names("FinalMems"), mems):
        ctx.env[slot] = m
