"""Math op rules (counterpart of ``paddle_tpu/ops/math_ops.py``): the
elementwise family with Fluid's ``axis`` broadcast, the activation table,
``mul``/``matmul``, the reductions, ``clip``/``clip_by_norm``/``cumsum``,
``norm``, ``cos_sim``, ``maxout``, ``arg_max``/``arg_min``, and the
mixed-precision helpers of ``program.amp`` that the matmul and
convolution rules share.  Where the JAX rules carry a ragged input's
``@SEQ_LEN`` companion to the output (``mul``, the elementwise ops, the
activations, ``scale``, ``amp_cast``), so do these."""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from .kernels import row_stable_mm


def _align(x: torch.Tensor, y: torch.Tensor, axis) -> torch.Tensor:
    """Fluid's elementwise broadcast: Y's dims align to X's starting at
    ``axis`` (-1: trailing)."""
    if x.shape == y.shape or y.dim() > x.dim():
        return y
    if axis is None or axis == -1:
        axis = x.dim() - y.dim()
    return y.reshape([1] * axis + list(y.shape)
                     + [1] * (x.dim() - axis - y.dim()))


def _elementwise(fn):
    """An elementwise rule: Out = fn(X, Y aligned at ``axis``), which
    keeps X's sequence lengths.  Under program.amp a mixed bf16/f32
    broadcast pair (an f32 bias or table added into a bf16 stream) is cast
    to bf16, as the JAX rule does, so the stream stays bf16; a same-shape
    mixed pair keeps promotion to f32 (the JAX rule's reason: inside a
    recurrent cell a forced bf16 would flip the carry's dtype)."""
    def rule(ctx):
        x = ctx.input("X")
        y = _align(x, ctx.input("Y"), ctx.attr("axis", -1))
        if (amp_on(ctx) and x.shape != y.shape
                and {x.dtype, y.dtype} == {torch.bfloat16, torch.float32}):
            x, y = x.to(torch.bfloat16), y.to(torch.bfloat16)
        ctx.set_output("Out", fn(x, y))
        ctx.set_seq_len("Out", ctx.seq_len_of("X"))
    return rule


#: elementwise op type -> function (``jnp.mod`` is Python's modulo, the
#: sign of the divisor: ``torch.remainder``)
ELEMENTWISE = {
    "elementwise_add": torch.add,
    "elementwise_sub": torch.sub,
    "elementwise_mul": torch.mul,
    "elementwise_div": torch.true_divide,
    "elementwise_max": torch.maximum,
    "elementwise_min": torch.minimum,
    "elementwise_pow": torch.pow,
    "elementwise_mod": torch.remainder,
}
for _name, _fn in ELEMENTWISE.items():
    register_op(_name)(_elementwise(_fn))


# ---------------------------------------------------------------------------
# activations: one table, as activation_op.cc registers its functors
# ---------------------------------------------------------------------------

def _where0(cond, x):
    return torch.where(cond, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


#: activation op type -> (function, attribute names), the JAX table's
#: entries; ``gelu`` is JAX's default tanh approximation
ACTIVATIONS = {
    "sigmoid": (torch.sigmoid, ()),
    "logsigmoid": (F.logsigmoid, ()),
    "exp": (torch.exp, ()),
    "relu": (torch.relu, ()),
    "tanh": (torch.tanh, ()),
    "tanh_shrink": (lambda x: x - torch.tanh(x), ()),
    "sqrt": (torch.sqrt, ()),
    "rsqrt": (torch.rsqrt, ()),
    "abs": (torch.abs, ()),
    "ceil": (torch.ceil, ()),
    "floor": (torch.floor, ()),
    "cos": (torch.cos, ()),
    "sin": (torch.sin, ()),
    "round": (torch.round, ()),
    "reciprocal": (torch.reciprocal, ()),
    "log": (torch.log, ()),
    "square": (torch.square, ()),
    "softplus": (lambda x: torch.logaddexp(x, torch.zeros_like(x)), ()),
    "softsign": (F.softsign, ()),
    "softshrink": (lambda x, lam: torch.where(
        x > lam, x - lam, _where0(x < -lam, x + lam)), ("lambda",)),
    "hard_shrink": (lambda x, t: _where0(x.abs() > t, x), ("threshold",)),
    "brelu": (lambda x, lo, hi: torch.clamp(x, lo, hi), ("t_min", "t_max")),
    "leaky_relu": (lambda x, a: torch.where(x >= 0, x, a * x), ("alpha",)),
    "soft_relu": (lambda x, t: torch.log1p(torch.exp(torch.clamp(x, -t, t))),
                  ("threshold",)),
    "elu": (lambda x, a: torch.where(x > 0, x, a * torch.expm1(x)),
            ("alpha",)),
    "relu6": (lambda x, t: torch.clamp(x, 0.0, t), ("threshold",)),
    "pow": (lambda x, f: torch.pow(x, f), ("factor",)),
    "stanh": (lambda x, a, b: b * torch.tanh(a * x), ("scale_a", "scale_b")),
    "hard_sigmoid": (lambda x, s, o: torch.clamp(s * x + o, 0.0, 1.0),
                     ("slope", "offset")),
    "swish": (lambda x, b: x * torch.sigmoid(b * x), ("beta",)),
    "thresholded_relu": (lambda x, t: _where0(x > t, x), ("threshold",)),
    "gelu": (lambda x: F.gelu(x, approximate="tanh"), ()),
    "silu": (F.silu, ()),
}
_ACT_DEFAULTS = {
    "lambda": 0.5, "threshold": 6.0, "t_min": 0.0, "t_max": 24.0,
    "alpha": 0.02, "factor": 1.0, "scale_a": 2.0 / 3.0, "scale_b": 1.7159,
    "slope": 0.2, "offset": 0.5, "beta": 1.0,
}


def _act_rule(fn, attr_names):
    def rule(ctx):
        attrs = [ctx.attr(a, _ACT_DEFAULTS.get(a)) for a in attr_names]
        ctx.set_output("Out", fn(ctx.input("X"), *attrs))
        ctx.set_seq_len("Out", ctx.seq_len_of("X"))
    return rule


for _name, (_fn, _attrs) in ACTIVATIONS.items():
    register_op(_name)(_act_rule(_fn, _attrs))


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
    """Under ``program.exact_lowering`` the product is the row-stable
    product kernel in f32 (a row's bits do not depend on M); a shape the
    kernel refuses raises."""
    x, y = ctx.input("X"), ctx.input("Y")
    xnd = ctx.attr("x_num_col_dims", 1)
    ynd = ctx.attr("y_num_col_dims", 1)
    x2 = x.reshape(math.prod(x.shape[:xnd]), -1)
    y2 = y.reshape(math.prod(y.shape[:ynd]), -1)
    want = x.dtype
    if ctx.program.exact_lowering:
        out = amp_out(ctx, row_stable_mm(x2.float().contiguous(),
                                         y2.float().contiguous()), want)
    else:
        x2, y2 = amp_operands(ctx, x2, y2)
        out = amp_out(ctx, torch.matmul(x2, y2), want)
    ctx.set_output("Out", out.reshape(
        tuple(x.shape[:xnd]) + tuple(y.shape[ynd:])))
    ctx.set_seq_len("Out", ctx.seq_len_of("X"))


@register_op("matmul", doc="matmul_op.cc: batched matmul with transpose "
             "flags and alpha")
def _matmul(ctx):
    """A 1-D X is a row and a 1-D Y a column, and they stay 2-D in the
    output, as in the JAX rule; a mixed-dtype pair computes in the
    promoted dtype."""
    x, y = ctx.input("X"), ctx.input("Y")
    if x.dim() == 1:
        x = x[None, :]
    if y.dim() == 1:
        y = y[:, None]
    if ctx.attr("transpose_X", False):
        x = x.transpose(-1, -2)
    if ctx.attr("transpose_Y", False):
        y = y.transpose(-1, -2)
    want = x.dtype
    x, y = amp_operands(ctx, x, y)
    if x.dtype != y.dtype:
        common = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(common), y.to(common)
    out = amp_out(ctx, torch.matmul(x, y), want)
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    ctx.set_output("Out", out)


@register_op("top_k", doc="top_k_op.cc")
def _top_k(ctx):
    vals, idx = torch.topk(ctx.input("X"), ctx.attr("k", 1), dim=-1)
    ctx.set_output("Out", vals)
    ctx.set_output("Indices", idx.to(torch.int32))


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _prod(x, dim=None, keepdim=False):
    if dim is None:
        out = torch.prod(x)
        return out.reshape([1] * x.dim()) if keepdim else out
    for d in sorted((d % x.dim() for d in dim), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _mean(x, dim=None, keepdim=False):
    # jnp.mean of an integer tensor is an f32 mean
    if not x.is_floating_point():
        x = x.float()
    if dim is None:
        out = torch.mean(x)
        return out.reshape([1] * x.dim()) if keepdim else out
    return torch.mean(x, dim=dim, keepdim=keepdim)


def _full_reduce(fn):
    def reduce(x, dim=None, keepdim=False):
        if dim is None:
            out = fn(x)
            return out.reshape([1] * x.dim()) if keepdim else out
        return fn(x, dim=dim, keepdim=keepdim)
    return reduce


#: reduce op type -> fn(x, dim tuple or None for all, keepdim)
REDUCTIONS = {
    "reduce_sum": _full_reduce(torch.sum),
    "reduce_mean": _mean,
    "reduce_max": _full_reduce(torch.amax),
    "reduce_min": _full_reduce(torch.amin),
    "reduce_prod": _prod,
}


def _reduce_rule(fn):
    def rule(ctx):
        x = ctx.input("X")
        keep = ctx.attr("keep_dim", False)
        if ctx.attr("reduce_all", False):
            ctx.set_output("Out", fn(x, None, keep))
            return
        dim = ctx.attr("dim", [0])
        dims = tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)
        ctx.set_output("Out", fn(x, dims, keep))
    return rule


for _name, _fn in REDUCTIONS.items():
    register_op(_name)(_reduce_rule(_fn))


@register_op("mean", doc="mean_op.cc: scalar mean")
def _mean_op(ctx):
    ctx.set_output("Out", torch.mean(ctx.input("X")))


@register_op("sum", doc="sum_op.cc: add N tensors")
def _sum(ctx):
    ctx.set_output("Out", functools.reduce(torch.add, ctx.inputs("X")))


@register_op("scale", doc="scale_op.cc")
def _scale(ctx):
    x = ctx.input("X")
    s, b = ctx.attr("scale", 1.0), ctx.attr("bias", 0.0)
    out = x * s + b if ctx.attr("bias_after_scale", True) else (x + b) * s
    ctx.set_output("Out", out.to(x.dtype))
    ctx.set_seq_len("Out", ctx.seq_len_of("X"))


@register_op("sign")
def _sign(ctx):
    ctx.set_output("Out", torch.sign(ctx.input("X")))


@register_op("clip", doc="clip_op.cc")
def _clip(ctx):
    ctx.set_output("Out", torch.clamp(ctx.input("X"), ctx.attr("min"),
                                      ctx.attr("max")))


@register_op("clip_by_norm", doc="clip_by_norm_op.cc")
def _clip_by_norm(ctx):
    x = ctx.input("X")
    mx = ctx.attr("max_norm")
    norm = torch.sqrt(torch.sum(torch.square(x)))
    ctx.set_output("Out", torch.where(
        norm > mx, x * (mx / torch.clamp(norm, min=1e-12)), x))


@register_op("cumsum", doc="cumsum_op.cc")
def _cumsum(ctx):
    x = ctx.input("X")
    axis = ctx.attr("axis", -1)
    rev = ctx.attr("reverse", False)
    if rev:
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, axis)
    if ctx.attr("exclusive", False):
        out = out - x
    if rev:
        out = torch.flip(out, (axis,))
    ctx.set_output("Out", out)


@register_op("norm", doc="norm_op.cc: l2 normalize along axis")
def _norm(ctx):
    x = ctx.input("X")
    norm = torch.sqrt(torch.sum(torch.square(x), dim=ctx.attr("axis", 1),
                                keepdim=True) + ctx.attr("epsilon", 1e-10))
    ctx.set_output("Out", x / norm)
    ctx.set_output("Norm", norm)


@register_op("maxout", doc="maxout_op.cc")
def _maxout(ctx):
    x = ctx.input("X")              # NCHW
    groups = ctx.attr("groups")
    n, c, h, w = x.shape
    ctx.set_output("Out", torch.amax(x.reshape(n, c // groups, groups, h, w),
                                     dim=2))


@register_op("arg_max")
def _arg_max(ctx):
    ctx.set_output("Out", torch.argmax(ctx.input("X"),
                                       dim=ctx.attr("axis", -1)
                                       ).to(torch.int32))


@register_op("arg_min")
def _arg_min(ctx):
    ctx.set_output("Out", torch.argmin(ctx.input("X"),
                                       dim=ctx.attr("axis", -1)
                                       ).to(torch.int32))


@register_op("cos_sim", doc="cos_sim_op.cc")
def _cos_sim(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    xn = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=-1, keepdim=True))
    num = torch.sum(x * y, dim=-1, keepdim=True)
    ctx.set_output("Out", num / torch.clamp(xn * yn, min=1e-12))
    ctx.set_output("XNorm", xn)
    ctx.set_output("YNorm", yn)


@register_op("amp_cast", doc="joins the bf16 activation stream under "
             "program.amp; the identity at full precision")
def _amp_cast(ctx):
    x = ctx.input("X")
    if amp_on(ctx) and x.dtype == torch.float32:
        x = x.to(torch.bfloat16)
    ctx.set_output("Out", x)
    ctx.set_seq_len("Out", ctx.seq_len_of("X"))
