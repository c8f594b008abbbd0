"""Optimizer op rules (counterpart of ``paddle_tpu/ops/optimizer_ops.py``;
the dense paths of ``sgd``, ``momentum``, ``adam``, ``adamax``,
``adagrad``, ``decayed_adagrad``, ``adadelta``, ``rmsprop``, ``ftrl``,
``proximal_gd``, ``proximal_adagrad`` and ModelAverage's
``average_accumulates``).

Each rule computes its outputs out of place, the JAX rules' math term
for term.  The interpreter commits them into the scope's own tensors
(`core.lowering`), so a step copies no state, and an op wired with
``FoundInf`` keeps its old values on an overflowed step.

SelectedRows.  ``sgd``, ``momentum`` and ``adam`` also take a
SelectedRows gradient (``<Grad>@ROWS``, ``<Grad>@VALUES``; an
``is_sparse`` table, `core.backward`): `merge_selected_rows` sums the
duplicate rows, and the update reads and writes only the merged rows,
so Adam's moments and Momentum's velocity of every other row stay as
they were (``adam_op.h`` SparseAdamFunctor).  The rule hands the commit
a `core.lowering.RowUpdate` of those rows, so a step moves the touched
rows, never the whole table.  Every other optimizer refuses such a
gradient, as the JAX package's rules do.

Meshes.  Under a fast mesh the rules update the local shards of sharded
parameters and their same-shape accumulators as they are; a parameter
and accumulators placed differently (ZeRO-1's sharded accumulators, or
a sharded parameter beside replicated ones) take `_mesh_branch`.  The
mesh-sharded branches of the row-sharded embedding tables are not
ported (ROADMAP queue A item 4).
"""
from __future__ import annotations

import torch

from ..core.lowering import ROWS_SUFFIX, VALUES_SUFFIX, RowUpdate
from ..core.registry import OpRegistry, register_op


def _grad(ctx):
    name = ctx.input_name("Grad")
    if name not in ctx.env and name + VALUES_SUFFIX in ctx.env:
        raise ValueError(
            f"{ctx.op.type} has no SelectedRows branch: {name} is the "
            "gradient of an is_sparse table, which only sgd, momentum and "
            "adam update; build the embedding with is_sparse=False")
    return ctx.input("Grad")


def merge_selected_rows(rows: torch.Tensor, values: torch.Tensor, V: int):
    """Sum the values of duplicate rows (``selected_rows_functor.cc``
    MergeAdd) -> (rows int64 ``[k]``, strictly increasing, in ``[0,
    V)``; their summed values f32 ``[k, D]``).  Ids in ``[-V, 0)`` wrap
    as the lookup wraps them; other ids outside ``[0, V)`` are dropped,
    as the JAX rule's scatters drop them.

    The JAX rule's order: a stable sort of the ids, then each segment
    summed in that order.  ``index_put_(accumulate=True)`` sums the
    duplicates of an index in order of position (on the card a sorted,
    sequential pass, not atomics), so the bits repeat from run to run.
    The size ``k`` is data-dependent: reading it costs one
    device-to-host sync a merge (the JAX rule pads to ``n`` instead)."""
    n = rows.shape[0]
    d = values.shape[-1]
    if n == 0:
        return (torch.zeros(0, dtype=torch.int64, device=rows.device),
                torch.zeros((0, d), dtype=torch.float32,
                            device=values.device))
    rows = rows.long()
    rows = torch.where((rows < 0) & (rows >= -V), rows + V, rows)
    sr, order = torch.sort(rows, stable=True)
    sv = values.float().index_select(0, order)
    head = torch.ones_like(sr, dtype=torch.bool)
    head[1:] = sr[1:] != sr[:-1]
    seg = torch.cumsum(head, 0) - 1
    # the one host sync: segments, and those below 0 and below V
    k, lo, hi = torch.stack([seg[-1] + 1, (head & (sr < 0)).sum(),
                             (head & (sr < V)).sum()]).tolist()
    uniq = torch.full((k,), -1, dtype=torch.int64, device=rows.device)
    uniq.scatter_reduce_(0, seg, sr, "amax")
    merged = torch.zeros((k, d), dtype=torch.float32, device=values.device)
    merged.index_put_((seg,), sv, accumulate=True)
    return uniq[lo:hi], merged[lo:hi]


def _sparse_grad(ctx):
    """(merged rows, merged values) when this op's Grad is a SelectedRows
    gradient, else None."""
    name = ctx.input_name("Grad")
    if name in ctx.env:
        return None
    rows = ctx.env.get(name + ROWS_SUFFIX)
    values = ctx.env.get(name + VALUES_SUFFIX)
    if rows is None or values is None:
        return None
    return merge_selected_rows(rows, values, ctx.input("Param").shape[0])


def _set_rows(ctx, slot: str, base: torch.Tensor, rows: torch.Tensor,
              values: torch.Tensor):
    """Output ``slot``: ``base`` with ``rows`` replaced by ``values``, a
    `RowUpdate` that the commit scatters into ``base`` itself.  Every
    optimize op `Optimizer.minimize` builds writes its state in place;
    a sparse update that is not committed so is refused."""
    if not (ctx.attr("op_role") == "optimize"
            and ctx.env.get(ctx.output_name(slot)) is base):
        raise ValueError(
            f"{ctx.op.type}: a SelectedRows update of {slot} must write "
            "its input in place in an optimize-role op")
    ctx.set_output(slot, RowUpdate(base, rows, values))


def _lr(ctx):
    return ctx.input("LearningRate").reshape(())


def _scalar(ctx, slot):
    return ctx.input(slot).reshape(())


@register_op("sgd")
def _sgd(ctx):
    p = ctx.input("Param")
    sparse = _sparse_grad(ctx)
    if sparse is not None:
        rows, g = sparse
        # the JAX rule's scatter-add of -lr * merged into the rows
        p_rows = p.index_select(0, rows)
        _set_rows(ctx, "ParamOut", p, rows,
                  p_rows + (-_lr(ctx) * g).to(p.dtype))
        return
    g = _grad(ctx)
    ctx.set_output("ParamOut", (p - _lr(ctx) * g).to(p.dtype))


def _momentum_step(p, v, g, mu, lr, nesterov):
    v_new = mu * v + g
    if nesterov:
        return p - (g + mu * v_new) * lr, v_new
    return p - lr * v_new, v_new


@register_op("momentum")
def _momentum(ctx):
    p, v = ctx.input("Param"), ctx.input("Velocity")
    mu, lr = ctx.attr("mu"), _lr(ctx)
    nesterov = ctx.attr("use_nesterov", False)
    sparse = _sparse_grad(ctx)
    if sparse is not None:
        # only the gradient's rows move (momentum_op's sparse path)
        rows, g = sparse
        p_new, v_new = _momentum_step(p.index_select(0, rows),
                                      v.index_select(0, rows), g, mu, lr,
                                      nesterov)
        _set_rows(ctx, "ParamOut", p, rows, p_new)
        _set_rows(ctx, "VelocityOut", v, rows, v_new)
        return
    p_new, v_new = _momentum_step(p, v, _grad(ctx), mu, lr, nesterov)
    ctx.set_output("ParamOut", p_new.to(p.dtype))
    ctx.set_output("VelocityOut", v_new)


def _adam_moments(m, v, g, b1, b2):
    # the JAX rule's b1 * m + (1 - b1) * g and b2 * v + (1 - b2) * g^2,
    # as one add and one addcmul kernel each
    return (m * b1).add(g, alpha=1 - b1), (v * b2).addcmul(g, g,
                                                           value=1 - b2)


@register_op("adam")
def _adam(ctx):
    p = ctx.input("Param")
    m, v = ctx.input("Moment1"), ctx.input("Moment2")
    b1p, b2p = _scalar(ctx, "Beta1Pow"), _scalar(ctx, "Beta2Pow")
    b1, b2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    lr_t = _lr(ctx) * torch.sqrt(1 - b2p) / (1 - b1p)
    sparse = _sparse_grad(ctx)
    if sparse is not None:
        # moments and parameter move only on the gradient's merged rows
        # (adam_op.h SparseAdamFunctor)
        rows, g = sparse
        m_new, v_new = _adam_moments(m.index_select(0, rows),
                                     v.index_select(0, rows), g, b1, b2)
        p_new = (p.index_select(0, rows)
                 - lr_t * m_new / (torch.sqrt(v_new) + eps))
        _set_rows(ctx, "ParamOut", p, rows, p_new)
        _set_rows(ctx, "Moment1Out", m, rows, m_new)
        _set_rows(ctx, "Moment2Out", v, rows, v_new)
    else:
        g = _grad(ctx)
        m_new, v_new = _adam_moments(m, v, g, b1, b2)
        p_new = p - lr_t * m_new / (torch.sqrt(v_new) + eps)
        ctx.set_output("ParamOut", p_new.to(p.dtype))
        ctx.set_output("Moment1Out", m_new)
        ctx.set_output("Moment2Out", v_new)
    ctx.set_output("Beta1PowOut", (b1p * b1).reshape(1))
    ctx.set_output("Beta2PowOut", (b2p * b2).reshape(1))


@register_op("adamax")
def _adamax(ctx):
    p, g = ctx.input("Param"), _grad(ctx)
    m, inf = ctx.input("Moment"), ctx.input("InfNorm")
    b1p = _scalar(ctx, "Beta1Pow")
    b1, b2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    inf_new = torch.maximum(b2 * inf, torch.abs(g))
    p_new = p - (_lr(ctx) / (1 - b1p)) * m_new / (inf_new + eps)
    ctx.set_output("ParamOut", p_new.to(p.dtype))
    ctx.set_output("MomentOut", m_new)
    ctx.set_output("InfNormOut", inf_new)
    ctx.set_output("Beta1PowOut", (b1p * b1).reshape(1))


@register_op("adagrad")
def _adagrad(ctx):
    p, g, mom = ctx.input("Param"), _grad(ctx), ctx.input("Moment")
    eps = ctx.attr("epsilon", 1e-6)
    mom_new = mom + torch.square(g)
    p_new = p - _lr(ctx) * g / (torch.sqrt(mom_new) + eps)
    ctx.set_output("ParamOut", p_new.to(p.dtype))
    ctx.set_output("MomentOut", mom_new)


@register_op("decayed_adagrad")
def _decayed_adagrad(ctx):
    p, g, mom = ctx.input("Param"), _grad(ctx), ctx.input("Moment")
    decay = ctx.attr("decay", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    mom_new = decay * mom + (1 - decay) * torch.square(g)
    p_new = p - _lr(ctx) * g / (torch.sqrt(mom_new) + eps)
    ctx.set_output("ParamOut", p_new.to(p.dtype))
    ctx.set_output("MomentOut", mom_new)


@register_op("adadelta")
def _adadelta(ctx):
    p, g = ctx.input("Param"), _grad(ctx)
    avg_sq_g = ctx.input("AvgSquaredGrad")
    avg_sq_u = ctx.input("AvgSquaredUpdate")
    rho = ctx.attr("rho", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    g2 = rho * avg_sq_g + (1 - rho) * torch.square(g)
    upd = -torch.sqrt((avg_sq_u + eps) / (g2 + eps)) * g
    u2 = rho * avg_sq_u + (1 - rho) * torch.square(upd)
    ctx.set_output("ParamOut", (p + upd).to(p.dtype))
    ctx.set_output("AvgSquaredGradOut", g2)
    ctx.set_output("AvgSquaredUpdateOut", u2)


@register_op("rmsprop")
def _rmsprop(ctx):
    p, g = ctx.input("Param"), _grad(ctx)
    ms, mom = ctx.input("MeanSquare"), ctx.input("Moment")
    rho = ctx.attr("decay", 0.9)
    mu = ctx.attr("momentum", 0.0)
    eps = ctx.attr("epsilon", 1e-10)
    ms_new = rho * ms + (1 - rho) * torch.square(g)
    mom_new = mu * mom + _lr(ctx) * g / torch.sqrt(ms_new + eps)
    ctx.set_output("ParamOut", (p - mom_new).to(p.dtype))
    ctx.set_output("MeanSquareOut", ms_new)
    ctx.set_output("MomentOut", mom_new)


@register_op("ftrl")
def _ftrl(ctx):
    p, g = ctx.input("Param"), _grad(ctx)
    sq = ctx.input("SquaredAccumulator")
    lin = ctx.input("LinearAccumulator")
    l1 = ctx.attr("l1", 0.0) + 1e-10
    l2 = ctx.attr("l2", 0.0) + 1e-10
    lr_power = ctx.attr("lr_power", -0.5)
    lr = _lr(ctx)
    new_sq = sq + torch.square(g)
    if lr_power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
        denom = torch.sqrt(new_sq) / lr + 2 * l2
    else:
        sigma = (torch.pow(new_sq, -lr_power)
                 - torch.pow(sq, -lr_power)) / lr
        denom = torch.pow(new_sq, -lr_power) / lr + 2 * l2
    new_lin = lin + g - sigma * p
    pre = torch.clamp(new_lin, -l1, l1) - new_lin
    ctx.set_output("ParamOut", (pre / denom).to(p.dtype))
    ctx.set_output("SquaredAccumOut", new_sq)
    ctx.set_output("LinearAccumOut", new_lin)


def _proximal(prox, lr_t, l1, l2):
    if l1 > 0:
        return (torch.sign(prox)
                * torch.clamp(torch.abs(prox) - lr_t * l1, min=0.0)
                / (1.0 + lr_t * l2))
    return prox / (1.0 + lr_t * l2)


@register_op("proximal_gd")
def _proximal_gd(ctx):
    p, g = ctx.input("Param"), _grad(ctx)
    lr = _lr(ctx)
    p_new = _proximal(p - lr * g, lr, ctx.attr("l1", 0.0),
                      ctx.attr("l2", 0.0))
    ctx.set_output("ParamOut", p_new.to(p.dtype))


@register_op("proximal_adagrad")
def _proximal_adagrad(ctx):
    p, g, mom = ctx.input("Param"), _grad(ctx), ctx.input("Moment")
    mom_new = mom + torch.square(g)
    lr_t = _lr(ctx) / torch.sqrt(mom_new)
    p_new = _proximal(p - lr_t * g, lr_t, ctx.attr("l1", 0.0),
                      ctx.attr("l2", 0.0))
    ctx.set_output("ParamOut", p_new.to(p.dtype))
    ctx.set_output("MomentOut", mom_new)


@register_op("average_accumulates",
             doc="ModelAverage accumulation: two-buffer windowed "
                 "parameter sums")
def _average_accumulates(ctx):
    p = ctx.input("Param")
    s1, s2 = ctx.input("InSum1"), ctx.input("InSum2")
    num_acc = ctx.input("InNumAccumulates")
    old_num = ctx.input("InOldNumAccumulates")
    num_upd = ctx.input("InNumUpdates")
    avg_window = ctx.attr("average_window", 0.15)
    max_w = ctx.attr("max_average_window", 10000)
    min_w = ctx.attr("min_average_window", 10000)
    s1 = s1 + p
    num_acc = num_acc + 1
    num_upd = num_upd + 1
    # the window restarts when the live window outgrows its budget
    window = (num_upd.float() * avg_window).to(num_upd.dtype)
    limit = torch.clamp(torch.clamp(window, max=max_w), min=min_w)
    shift = num_acc >= limit
    ctx.set_output("OutSum1", torch.where(shift, torch.zeros_like(s1), s1))
    ctx.set_output("OutSum2", torch.where(shift, s1, s2))
    ctx.set_output("OutNumAccumulates",
                   torch.where(shift, torch.zeros_like(num_acc), num_acc))
    ctx.set_output("OutOldNumAccumulates",
                   torch.where(shift, num_acc, old_num))
    ctx.set_output("OutNumUpdates", num_upd)


# ---------------------------------------------------------------------------
# Mixed placements under a mesh: parameter and accumulators cut alike
# ---------------------------------------------------------------------------

#: the slots that are neither the parameter, its gradient nor the rate
_NOT_STATE = ("Param", "Grad", "LearningRate")


def _mesh_branch(fn):
    """An optimizer rule under a fast mesh whose parameter and
    accumulators are placed differently.  Two cases, as GSPMD partitions
    them in the JAX package:

    - accumulators sharded on the data axis beside a replicated
      parameter (ZeRO-1, ``DistributeTranspiler.transpile(zero_stage=1)``):
      the rule updates this rank's rows of the parameter and its
      gradient with the local accumulators, and the parameter's rows are
      all-gathered;
    - a sharded parameter beside replicated accumulators of its shape:
      the accumulators are cut to the parameter's shard, updated, and
      all-gathered back.

    The commit then writes whole tensors where the scope holds whole
    ones and shards where it holds shards."""
    def rule(ctx):
        step = ctx.interpreter.partitioner
        if step is None:
            return fn(ctx)
        env = ctx.env
        p_name, g_name = ctx.input_name("Param"), ctx.input_name("Grad")
        p = env.get(p_name)
        if not isinstance(p, torch.Tensor) or p.dim() == 0:
            return fn(ctx)
        accs = [n for slot, names in ctx.op.desc.inputs.items()
                if slot not in _NOT_STATE for n in names
                if isinstance(env.get(n), torch.Tensor)
                and env[n].dim() == p.dim()]
        part = step.part
        p_spec = step.specs.get(p_name)
        if p_spec is not None:
            spec = p_spec
            full = part.full_shape(tuple(p.shape), spec)
            cut = [n for n in accs if n not in step.specs
                   and tuple(env[n].shape) == full != tuple(p.shape)]
        else:
            zero = [n for n in accs if n in step.specs
                    and env[n].shape[0] < p.shape[0]]
            if not zero:
                return fn(ctx)
            spec = step.specs[zero[0]]
            cut = [p_name, g_name]
        if not cut:
            return fn(ctx)
        saved = {n: env[n] for n in cut}
        for n in cut:
            env[n] = part.shard(saved[n], spec)
        try:
            fn(ctx)
        finally:
            if g_name in saved:
                env[g_name] = saved[g_name]
        outs = {ctx.input_name("Param"): ctx.output_name("ParamOut")}
        for slot, names in ctx.op.desc.inputs.items():
            out = ctx.output_name(slot + "Out")
            if names and out is not None:
                outs[names[0]] = out
        for n in cut:
            out = outs.get(n)
            if out is not None and out in env:
                env[out] = part.gather(env[out], spec)
    rule.__doc__ = fn.__doc__
    return rule


for _name in ("sgd", "momentum", "adam", "adamax", "adagrad",
              "decayed_adagrad", "adadelta", "rmsprop", "ftrl",
              "proximal_gd", "proximal_adagrad"):
    _def = OpRegistry.get(_name)
    _def.fn = _mesh_branch(_def.fn)
