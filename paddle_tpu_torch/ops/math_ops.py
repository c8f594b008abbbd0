"""Math op rules (counterpart of ``paddle_tpu/ops/math_ops.py``; the ops
the training programs use).  Mixed precision is not ported: programs run
at their declared dtypes and ``amp_cast`` is the identity."""
from __future__ import annotations

import math

import torch

from ..core.registry import register_op


def _align(x: torch.Tensor, y: torch.Tensor, axis) -> torch.Tensor:
    """Fluid's elementwise broadcast: Y's dims align to X's starting at
    ``axis`` (-1: trailing)."""
    if x.shape == y.shape or y.dim() > x.dim():
        return y
    if axis is None or axis == -1:
        axis = x.dim() - y.dim()
    return y.reshape([1] * axis + list(y.shape)
                     + [1] * (x.dim() - axis - y.dim()))


@register_op("elementwise_add")
def _elementwise_add(ctx):
    x = ctx.input("X")
    y = _align(x, ctx.input("Y"), ctx.attr("axis", -1))
    ctx.set_output("Out", x + y)


#: activation op type -> function (the JAX package's table holds ~30; the
#: port has the ones its programs use)
ACTIVATIONS = {
    "relu": torch.relu,
}


def _act_rule(fn):
    def rule(ctx):
        ctx.set_output("Out", fn(ctx.input("X")))
    return rule


for _name, _fn in ACTIVATIONS.items():
    register_op(_name)(_act_rule(_fn))


@register_op("mul", doc="mul_op.cc: flatten-to-2D matmul")
def _mul(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    xnd = ctx.attr("x_num_col_dims", 1)
    ynd = ctx.attr("y_num_col_dims", 1)
    x2 = x.reshape(math.prod(x.shape[:xnd]), -1)
    y2 = y.reshape(math.prod(y.shape[:ynd]), -1)
    ctx.set_output("Out", torch.matmul(x2, y2).reshape(
        tuple(x.shape[:xnd]) + tuple(y.shape[ynd:])))


@register_op("mean", doc="mean_op.cc: scalar mean")
def _mean(ctx):
    ctx.set_output("Out", torch.mean(ctx.input("X")))


@register_op("scale", doc="scale_op.cc")
def _scale(ctx):
    x = ctx.input("X")
    s, b = ctx.attr("scale", 1.0), ctx.attr("bias", 0.0)
    out = x * s + b if ctx.attr("bias_after_scale", True) else (x + b) * s
    ctx.set_output("Out", out.to(x.dtype))


@register_op("amp_cast", doc="identity at full precision")
def _amp_cast(ctx):
    ctx.set_output("Out", ctx.input("X"))
