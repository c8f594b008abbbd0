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

Not ported yet: SelectedRows (``is_sparse``) gradients, ``calc_gradient``
and ``memory_optimize`` rematerialisation.
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
    grads = (torch.autograd.grad(loss, params, grad_outputs=loss_grad,
                                 allow_unused=True)
             if loss.requires_grad else [None] * len(params))
    for gname, p, g in zip(ctx.output_names("Grads"), params, grads):
        ctx.env[gname] = torch.zeros_like(p) if g is None else g.to(p.dtype)
    ctx.set_output("LossGrad", loss_grad)
