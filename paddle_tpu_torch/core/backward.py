"""Autodiff as a program transform (counterpart of
``paddle_tpu/core/backward.py``).

`append_backward` appends ONE ``backward`` op with the JAX package's
inputs, outputs, attributes and ``@GRAD`` names.  Its rule differs in how
it gets the gradients: it does not replay the forward.  The interpreter
has already run ops ``[0, forward_op_end)`` with autograd recording from
the parameters (see `core.lowering`), so the rule calls
``torch.autograd.grad`` once on the recorded graph.  Each autograd
Function of the port's kernels (flash attention, LayerNorm, softmax
cross-entropy) runs its backward kernel there.

SelectedRows gradients.  A table read only as the ``W`` of ``is_sparse``
``lookup_table`` ops (`_find_sparse_params`) gets a ``@GRAD`` var of type
``SELECTED_ROWS`` with ``@GRAD@ROWS`` and ``@GRAD@VALUES`` companions,
and the dense ``[V, D]`` gradient never exists.  Where the JAX rule
differentiates with respect to a zero delta added at each sparse
lookup's output, the port does not make such a table require grad at
all: the lookup rule gathers from the detached table and makes the
gathered rows the autograd leaf (`ops.nn_ops`), and this rule asks
``torch.autograd.grad`` for those leaves.  ``@ROWS`` is the ids, int32,
concatenated over the table's lookups in op order; ``@VALUES`` the
leaves' gradients as ``[-1, D]`` rows in the table's dtype.

Rematerialisation (``memory_optimize``).  Where the JAX rule replays the
forward in ``jax.checkpoint`` segments, the interpreter runs the
recorded forward in segments under ``torch.utils.checkpoint``
(`core.lowering`), so this rule's one ``torch.autograd.grad`` recomputes
each segment's saved tensors as it reaches it.

Meshes.  Under a fast-numerics mesh the gradients of the one
``torch.autograd.grad`` are reduced over the data axis, as the loss's
placement asks, before the optimizer ops run, and a parameter the step
gathered gets its shard's gradient back
(`parallel.partitioner.StepSharding.reduce_gradients`).  A SelectedRows
table's pairs (a row-sharded table, or one replicated on a
data-parallel mesh) are gathered over the data axis in rank order
(`StepSharding.reduce_sparse`), so that every rank merges the same
pairs.  Under exact numerics the pairs are already the whole batch's on
every rank.

`calc_gradient` appends the same op for any targets and inputs (the
JAX function's program), so a program may hold several; the interpreter
records up to the last, and every one but the last keeps the graph.

``print_grad``.  A var flagged ``desc.print_grad``
(``gradient_printer_evaluator``) prints the cotangent that reaches it.
Where the JAX rule routes the replayed value through an identity whose
VJP prints, the rule hooks the recorded forward value
(`hook_print_grad`, a ``Tensor.register_hook`` that returns the
cotangent unchanged) for the one ``torch.autograd.grad`` and removes the
hook after it.  Every consumer read that tensor, so the hook sees the
sum of their cotangents, as the JAX probe does.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Set, Tuple

import torch

from .lowering import ROWS_SUFFIX, VALUES_SUFFIX, ExecContext
from .program import Parameter, Variable
from .registry import register_op
from .types import VarType


def append_backward(loss: Variable,
                    parameter_list: Optional[Sequence[str]] = None,
                    no_grad_set: Optional[Set[str]] = None
                    ) -> List[Tuple[Parameter, Variable]]:
    block = loss.block
    params = [p for p in block.all_parameters() if p.trainable]
    if parameter_list:
        names = {p if isinstance(p, str) else p.name for p in parameter_list}
        params = [p for p in params if p.name in names]
    if no_grad_set:
        params = [p for p in params if p.name not in no_grad_set]

    forward_op_end = len(block.ops)
    sparse = _find_sparse_params(block, forward_op_end,
                                 {p.name for p in params})
    grad_vars = []
    for p in params:
        g = block.create_var(name=p.name + "@GRAD", shape=p.shape,
                             dtype=p.dtype)
        if p.name in sparse:
            g.desc.type = VarType.SELECTED_ROWS
            block.create_var(name=g.name + ROWS_SUFFIX, shape=(-1,),
                             dtype="int32")
            block.create_var(name=g.name + VALUES_SUFFIX,
                             shape=(-1, p.shape[-1]), dtype=p.dtype)
        grad_vars.append(g)
    loss_grad = block.create_var(name=loss.name + "@GRAD", shape=loss.shape,
                                 dtype=loss.dtype)
    block.append_op(
        "backward",
        inputs={"Loss": [loss]},
        outputs={"Grads": [g.name for g in grad_vars],
                 "LossGrad": [loss_grad]},
        attrs={"params": [p.name for p in params],
               "sparse_params": sorted(sparse),
               "forward_op_end": forward_op_end,
               "op_role": "backward"})
    return list(zip(params, grad_vars))


def _find_sparse_params(block, op_end, param_names):
    """Tables eligible for SelectedRows gradients: every use in ``[0,
    op_end)`` is the ``W`` of an ``is_sparse`` ``lookup_table``.  Any
    other reader, in this block or in a sub-block, vetoes the table (its
    gradient stays dense)."""
    eligible, vetoed = set(), set()
    for op in block.ops[:op_end]:
        for slot, names in op.desc.inputs.items():
            for n in names:
                if n not in param_names:
                    continue
                if (op.type == "lookup_table" and slot == "W"
                        and op.desc.attrs.get("is_sparse")):
                    eligible.add(n)
                else:
                    vetoed.add(n)
    for other in block.program.blocks:
        if other is block:
            continue
        for op in other.ops:
            for names in op.desc.inputs.values():
                vetoed.update(n for n in names if n in param_names)
    return eligible - vetoed


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """The gradients of ``targets[0]`` (summed) with respect to
    ``inputs`` (data vars or parameters), as ``<name>@GRAD`` vars: one
    ``backward`` op, the JAX function's program."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    block = targets[0].block
    forward_op_end = len(block.ops)
    grad_vars = [block.create_var(name=v.name + "@GRAD", shape=v.shape,
                                  dtype=v.dtype) for v in inputs]
    block.append_op(
        "backward",
        inputs={"Loss": [targets[0]]},
        outputs={"Grads": [g.name for g in grad_vars], "LossGrad": []},
        attrs={"params": [v.name for v in inputs],
               "forward_op_end": forward_op_end,
               "op_role": "backward"})
    return grad_vars


def _sparse_sites(block, op_end, sparse_params):
    """``{table: [(lookup Out name, Ids name), ...]}`` in op order: the
    ``is_sparse`` lookups of each SelectedRows table in ``[0, op_end)``."""
    sites = {}
    for op in block.ops[:op_end]:
        if (op.type == "lookup_table" and op.desc.attrs.get("is_sparse")
                and op.desc.inputs["W"][0] in sparse_params):
            sites.setdefault(op.desc.inputs["W"][0], []).append(
                (op.desc.outputs["Out"][0], op.desc.inputs["Ids"][0]))
    return sites


def hook_print_grad(block, op_end, env) -> list:
    """Hook every ``print_grad`` var that ops ``[0, op_end)`` wrote and
    that carries a recorded graph -> the hooks' handles."""
    flagged = {name for name, var in block.vars.items()
               if var.desc.print_grad}
    if not flagged:
        return []
    from ..ops.array_ops import print_cotangent

    def hook(g):
        print_cotangent(g)
        return g

    handles = []
    for op in block.ops[:op_end]:
        for name in op.desc.output_names():
            val = env.get(name)
            if (name not in flagged or not isinstance(val, torch.Tensor)
                    or not val.requires_grad):
                continue
            flagged.discard(name)
            handles.append(val.register_hook(hook))
    return handles


@register_op("backward")
def _backward_rule(ctx: ExecContext):
    loss = ctx.input("Loss")
    names = ctx.attr("params")
    params = [ctx.env[p] for p in names]
    sites = _sparse_sites(ctx.block, ctx.attr("forward_op_end"),
                         set(ctx.attr("sparse_params", []) or ()))
    # each sparse lookup's (table, gathered rows or None, ids); a lookup
    # that did not run (dead) gives zero values for its fed ids
    gathered = []
    for p in names:
        for out, ids in sites.get(p, ()):
            leaf, flat = ctx.interpreter.sparse_leaves.get(
                out, (None, ctx.env[ids]))
            gathered.append((p, leaf, flat))
    # d(sum(loss))/dparams, the JAX rule's jax.grad of jnp.sum(loss)
    loss_grad = torch.ones_like(loss)
    # a loss that depends on no parameter (a constant, or only on stopped
    # inputs) has zero gradients, as jax.grad gives
    wrt = [params[i] for i, p in enumerate(names)
           if p not in sites and params[i].requires_grad]
    wrt += [leaf for _, leaf, _ in gathered
            if leaf is not None and leaf.requires_grad]
    got = {}
    if loss.requires_grad and wrt:
        handles = hook_print_grad(ctx.block, ctx.attr("forward_op_end"),
                                  ctx.env)
        grads = torch.autograd.grad(
            loss, wrt, grad_outputs=loss_grad, allow_unused=True,
            retain_graph=ctx.op is not ctx.interpreter.last_backward)
        for h in handles:
            h.remove()
        got = {id(t): g for t, g in zip(wrt, grads)}
    step = ctx.interpreter.partitioner
    loss_name = ctx.op.desc.inputs["Loss"][0]
    if step is not None:
        # the mesh's gradients: reduced over the data axis, a gathered
        # param's cut back to its shard (parallel.partitioner)
        dense_names = [p for p in names if p not in sites]
        dense = {p: (torch.zeros_like(val) if got.get(id(val)) is None
                     else got[id(val)]) for p, val in zip(names, params)
                 if p not in sites}
        step.reduce_gradients(ctx.block, loss_name, ctx.env, dense_names,
                              dense)
        params = [ctx.env[p] for p in names]
        got.update({id(val): dense[p] for p, val in zip(names, params)
                    if p not in sites})
    for gname, p, val in zip(ctx.output_names("Grads"), names, params):
        if p in sites:
            continue
        g = got.get(id(val))
        ctx.env[gname] = (torch.zeros_like(val) if g is None
                          else g.to(val.dtype)).detach()
    for gname, p, val in zip(ctx.output_names("Grads"), names, params):
        if p not in sites:
            continue
        d = val.shape[-1]
        rows, values = [], []
        for table, leaf, ids in gathered:
            if table != p:
                continue
            g = got.get(id(leaf)) if leaf is not None else None
            rows.append(ids.reshape(-1).to(torch.int32))
            values.append(
                torch.zeros((ids.numel(), d), dtype=val.dtype,
                            device=val.device) if g is None
                else g.detach().reshape(-1, d).to(val.dtype))
        rows, values = torch.cat(rows), torch.cat(values)
        if step is not None:
            rows, values = step.reduce_sparse(ctx.block, loss_name, p,
                                              rows, values)
        ctx.env[gname + ROWS_SUFFIX] = rows
        ctx.env[gname + VALUES_SUFFIX] = values
    ctx.set_output("LossGrad", loss_grad)
