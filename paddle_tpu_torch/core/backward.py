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

`calc_gradient` appends the same op for any targets and inputs (the
JAX function's program), so a program may hold several; the interpreter
records up to the last, and every one but the last keeps the graph.

Not ported yet: SelectedRows (``is_sparse``) gradients and
``memory_optimize`` rematerialisation.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Set, Tuple

import torch

from .lowering import ExecContext
from .program import Parameter, Variable
from .registry import register_op


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
    names = {p.name for p in params}
    for op in block.ops:
        if (op.type == "lookup_table" and op.desc.attrs.get("is_sparse")
                and op.desc.inputs["W"][0] in names):
            raise NotImplementedError(
                "is_sparse embeddings (SelectedRows gradients) are not "
                "ported: build the embedding with is_sparse=False")

    forward_op_end = len(block.ops)
    grad_vars = [block.create_var(name=p.name + "@GRAD", shape=p.shape,
                                  dtype=p.dtype) for p in params]
    loss_grad = block.create_var(name=loss.name + "@GRAD", shape=loss.shape,
                                 dtype=loss.dtype)
    block.append_op(
        "backward",
        inputs={"Loss": [loss]},
        outputs={"Grads": [g.name for g in grad_vars],
                 "LossGrad": [loss_grad]},
        attrs={"params": [p.name for p in params],
               "sparse_params": [],
               "forward_op_end": forward_op_end,
               "op_role": "backward"})
    return list(zip(params, grad_vars))


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


@register_op("backward")
def _backward_rule(ctx: ExecContext):
    if ctx.attr("sparse_params"):
        raise NotImplementedError("SelectedRows gradients are not ported")
    loss = ctx.input("Loss")
    params = [ctx.env[p] for p in ctx.attr("params")]
    # d(sum(loss))/dparams, the JAX rule's jax.grad of jnp.sum(loss)
    loss_grad = torch.ones_like(loss)
    # a loss that depends on no parameter (a constant, or only on stopped
    # inputs) has zero gradients, as jax.grad gives
    want = [i for i, p in enumerate(params) if p.requires_grad]
    grads = [None] * len(params)
    if loss.requires_grad and want:
        got = torch.autograd.grad(
            loss, [params[i] for i in want], grad_outputs=loss_grad,
            allow_unused=True,
            retain_graph=ctx.op is not ctx.interpreter.last_backward)
        for i, g in zip(want, got):
            grads[i] = g
    for gname, p, g in zip(ctx.output_names("Grads"), params, grads):
        ctx.env[gname] = (torch.zeros_like(p) if g is None
                          else g.to(p.dtype)).detach()
    ctx.set_output("LossGrad", loss_grad)
