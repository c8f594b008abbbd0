"""Optimizer op rules (counterpart of ``paddle_tpu/ops/optimizer_ops.py``;
the dense path of ``adam``).

The update runs in place under ``torch.no_grad()``: the parameter, both
moments and both beta-power accumulators are the scope's own tensors, so
a step copies no state.  The sparse (SelectedRows) and mesh-sharded
branches are not ported.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("adam")
def _adam(ctx):
    if ctx.input_name("Grad") not in ctx.env:
        raise NotImplementedError("adam over a SelectedRows gradient is "
                                  "not ported")
    p, g = ctx.input("Param"), ctx.input("Grad")
    m, v = ctx.input("Moment1"), ctx.input("Moment2")
    b1p, b2p = ctx.input("Beta1Pow"), ctx.input("Beta2Pow")
    lr = ctx.input("LearningRate")
    b1, b2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    with torch.no_grad():
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        lr_t = lr.reshape(()) * torch.sqrt(1 - b2p.reshape(())) \
            / (1 - b1p.reshape(()))
        p.sub_((lr_t * m / (torch.sqrt(v) + eps)).to(p.dtype))
        b1p.mul_(b1)
        b2p.mul_(b2)
    ctx.set_output("ParamOut", p)
    ctx.set_output("Moment1Out", m)
    ctx.set_output("Moment2Out", v)
    ctx.set_output("Beta1PowOut", b1p)
    ctx.set_output("Beta2PowOut", b2p)
