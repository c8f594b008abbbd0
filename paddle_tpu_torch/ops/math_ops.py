"""Math op rules (counterpart of ``paddle_tpu/ops/math_ops.py``; the ops
the training programs use) and the mixed-precision helpers of
``program.amp`` that the matmul and convolution rules share."""
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


# ---------------------------------------------------------------------------
# mixed precision (program.amp)
# ---------------------------------------------------------------------------

def amp_on(ctx) -> bool:
    return ctx.program.amp


def amp_operands(ctx, *tensors):
    """Under program.amp, f32 matmul/conv operands are cast to bf16 inside
    the rule; parameters stay f32 master weights, and autograd hands f32
    gradients back through the cast."""
    if amp_on(ctx):
        return tuple(t.to(torch.bfloat16)
                     if t is not None and t.dtype == torch.float32 else t
                     for t in tensors)
    return tensors


def conv_accum_dtype(ctx):
    """The dtype a conv rule computes in: f32 at full precision (a bf16
    operand is widened, which is what the JAX package's f32
    ``preferred_element_type`` does), None under amp (the operands' own
    dtype; the tensor cores still accumulate in f32)."""
    return None if amp_on(ctx) else torch.float32


def amp_out(ctx, out, want):
    """Result dtype of a matmul/conv rule.  Under amp an f32-declared
    output stays bf16, so bf16 flows on through the elementwise, pooling
    and BatchNorm rules, which follow their input's dtype; loss-head ops
    and normalisation statistics upcast to f32 internally."""
    if amp_on(ctx) and want == torch.float32:
        return out.to(torch.bfloat16)
    return out.to(want)


@register_op("mul", doc="mul_op.cc: flatten-to-2D matmul")
def _mul(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    xnd = ctx.attr("x_num_col_dims", 1)
    ynd = ctx.attr("y_num_col_dims", 1)
    x2 = x.reshape(math.prod(x.shape[:xnd]), -1)
    y2 = y.reshape(math.prod(y.shape[:ynd]), -1)
    want = x.dtype
    x2, y2 = amp_operands(ctx, x2, y2)
    out = amp_out(ctx, torch.matmul(x2, y2), want)
    ctx.set_output("Out", out.reshape(
        tuple(x.shape[:xnd]) + tuple(y.shape[ynd:])))


@register_op("top_k", doc="top_k_op.cc")
def _top_k(ctx):
    vals, idx = torch.topk(ctx.input("X"), ctx.attr("k", 1), dim=-1)
    ctx.set_output("Out", vals)
    ctx.set_output("Indices", idx.to(torch.int32))


@register_op("mean", doc="mean_op.cc: scalar mean")
def _mean(ctx):
    ctx.set_output("Out", torch.mean(ctx.input("X")))


@register_op("scale", doc="scale_op.cc")
def _scale(ctx):
    x = ctx.input("X")
    s, b = ctx.attr("scale", 1.0), ctx.attr("bias", 0.0)
    out = x * s + b if ctx.attr("bias_after_scale", True) else (x + b) * s
    ctx.set_output("Out", out.to(x.dtype))


@register_op("amp_cast", doc="joins the bf16 activation stream under "
             "program.amp; the identity at full precision")
def _amp_cast(ctx):
    x = ctx.input("X")
    if amp_on(ctx) and x.dtype == torch.float32:
        x = x.to(torch.bfloat16)
    ctx.set_output("Out", x)
