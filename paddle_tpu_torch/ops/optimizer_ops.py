"""Optimizer op rules (counterpart of ``paddle_tpu/ops/optimizer_ops.py``;
the dense paths of ``sgd``, ``momentum`` and ``adam``).

The update runs in place under ``torch.no_grad()``: the parameter and
its accumulators are the scope's own tensors, so a step copies no state.
The sparse (SelectedRows) and mesh-sharded branches are not ported.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op


def _dense_grad(ctx):
    if ctx.input_name("Grad") not in ctx.env:
        raise NotImplementedError(f"{ctx.op.type} over a SelectedRows "
                                  "gradient is not ported")
    return ctx.input("Grad")


def _lr(ctx):
    return ctx.input("LearningRate").reshape(())


@register_op("sgd")
def _sgd(ctx):
    p, g = ctx.input("Param"), _dense_grad(ctx)
    with torch.no_grad():
        p.sub_((_lr(ctx) * g).to(p.dtype))
    ctx.set_output("ParamOut", p)


@register_op("momentum")
def _momentum(ctx):
    p, g = ctx.input("Param"), _dense_grad(ctx)
    v = ctx.input("Velocity")
    mu = ctx.attr("mu")
    lr = _lr(ctx)
    with torch.no_grad():
        v.mul_(mu).add_(g)
        if ctx.attr("use_nesterov", False):
            p.sub_(((g + mu * v) * lr).to(p.dtype))
        else:
            p.sub_((lr * v).to(p.dtype))
    ctx.set_output("ParamOut", p)
    ctx.set_output("VelocityOut", v)


@register_op("adam")
def _adam(ctx):
    p, g = ctx.input("Param"), _dense_grad(ctx)
    m, v = ctx.input("Moment1"), ctx.input("Moment2")
    b1p, b2p = ctx.input("Beta1Pow"), ctx.input("Beta2Pow")
    b1, b2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    with torch.no_grad():
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        lr_t = _lr(ctx) * torch.sqrt(1 - b2p.reshape(())) \
            / (1 - b1p.reshape(()))
        p.sub_((lr_t * m / (torch.sqrt(v) + eps)).to(p.dtype))
        b1p.mul_(b1)
        b2p.mul_(b2)
    ctx.set_output("ParamOut", p)
    ctx.set_output("Moment1Out", m)
    ctx.set_output("Moment2Out", v)
    ctx.set_output("Beta1PowOut", b1p)
    ctx.set_output("Beta2PowOut", b2p)
