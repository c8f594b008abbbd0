"""Neural-network ops (counterpart of ``paddle_tpu/ops/nn_ops.py``):
`layer_norm` for the serving model, and the op rules of the training
programs — ``conv2d``, ``pool2d``, ``batch_norm``, ``layer_norm``,
``softmax``, ``cross_entropy`` (on probabilities),
``softmax_with_cross_entropy`` (hard labels), ``lookup_table`` (dense
gradient) and ``dropout``.

The BatchNorm, LayerNorm and loss-head rules go through the autograd
Functions of `ops.kernels`, so their backward runs the BatchNorm,
LayerNorm and softmax-xent backward kernels on the card and the plain
versions on the CPU.  Convolution is a library product in both packages
(``lax.conv_general_dilated`` there, cuDNN through ``F.conv2d`` here).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from . import kernels as K
from .math_ops import amp_operands, amp_out, conv_accum_dtype


def _pair(v, n=2):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


# ---------------------------------------------------------------------------
# convolution and pooling
# ---------------------------------------------------------------------------

@register_op("conv2d")
def _conv2d(ctx):
    x = ctx.input("Input")          # NCHW, or NHWC with data_format
    w = ctx.input("Filter")         # OIHW whatever the layout
    strides = _pair(ctx.attr("strides", [1, 1]))
    pads = _pair(ctx.attr("paddings", [0, 0]))
    dilations = _pair(ctx.attr("dilations", [1, 1]))
    groups = ctx.attr("groups", 1) or 1
    want = x.dtype
    x, w = amp_operands(ctx, x, w)
    acc = conv_accum_dtype(ctx)
    if acc is not None:
        x = x.to(torch.promote_types(x.dtype, acc))
        w = w.to(torch.promote_types(w.dtype, acc))
    if ctx.attr("data_format", "NCHW") == "NHWC":
        # an NHWC tensor's NCHW view lies in channels_last memory; with the
        # filter in the same format cuDNN returns a channels_last output,
        # whose NHWC view is contiguous again: no activation copies
        out = F.conv2d(x.permute(0, 3, 1, 2),
                       w.contiguous(memory_format=torch.channels_last), None,
                       strides, pads, dilations, groups).permute(0, 2, 3, 1)
    else:
        out = F.conv2d(x, w, None, strides, pads, dilations, groups)
    ctx.set_output("Output", amp_out(ctx, out, want))


def _pool(x, ptype, ksize, strides, pads, ceil_mode, exclusive):
    """pool_op.cc over an NCHW view with the JAX package's padding rules:
    max pooling pads with -inf; an exclusive average divides by the count
    of real elements when there is padding; ceil_mode pads the high side
    so that the last partial window is emitted (PyTorch's own ceil_mode
    drops a last window that starts in the padding)."""
    hi = list(pads)
    if ceil_mode:
        for i, size in enumerate(x.shape[2:]):
            rem = (size - ksize[i] + 2 * pads[i]) % strides[i]
            if rem:
                hi[i] += strides[i] - rem
    padded = any(hi) or any(pads)
    # torch's pools pad both sides alike and by at most half a window
    explicit = hi != list(pads) or any(2 * p > k for p, k in zip(pads, ksize))
    if explicit:
        spec = (pads[1], hi[1], pads[0], hi[0])
        if ptype != "max" and exclusive:
            ones = F.pad(torch.ones_like(x), spec)
            x = F.pad(x, spec)
            return (F.avg_pool2d(x, ksize, strides, divisor_override=1)
                    / F.avg_pool2d(ones, ksize, strides, divisor_override=1))
        x = F.pad(x, spec, value=float("-inf") if ptype == "max" else 0.0)
        pads = (0, 0)
    if ptype == "max":
        return F.max_pool2d(x, ksize, strides, pads)
    return F.avg_pool2d(x, ksize, strides, pads,
                        count_include_pad=not (exclusive and padded))


@register_op("pool2d")
def _pool2d(ctx):
    x = ctx.input("X")
    channels_last = ctx.attr("data_format", "NCHW").endswith("C")
    xv = x.permute(0, 3, 1, 2) if channels_last else x      # N, C, H, W
    if ctx.attr("global_pooling", False):
        ksize, strides, pads = tuple(xv.shape[2:]), (1, 1), (0, 0)
    else:
        ksize = _pair(ctx.attr("ksize"))
        strides = _pair(ctx.attr("strides", [1, 1]))
        pads = _pair(ctx.attr("paddings", [0, 0]))
    out = _pool(xv, ctx.attr("pooling_type", "max"), ksize, strides, pads,
                ctx.attr("ceil_mode", False), ctx.attr("exclusive", True))
    if channels_last:
        out = out.permute(0, 2, 3, 1)
    ctx.set_output("Out", out.to(x.dtype))


# ---------------------------------------------------------------------------
# normalisation
# ---------------------------------------------------------------------------

@register_op("batch_norm", doc="batch_norm_op.cc: running stats are state "
             "vars")
def _batch_norm(ctx):
    x = ctx.input("X")              # NCHW, NHWC or NC
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    mean, var = ctx.input("Mean"), ctx.input("Variance")
    eps = ctx.attr("epsilon", 1e-5)
    act = ctx.attr("act")           # relu fused by the layer
    channels_last = (ctx.attr("data_layout", "NCHW").endswith("C")
                     and x.dim() > 2)
    c = x.shape[-1] if channels_last else x.shape[1]
    # the [N', C, S] view of the BatchNorm kernel: (N*H*W, C, 1) for NHWC,
    # (N, C, H*W) for NCHW
    x3 = (x.reshape(-1, c, 1) if channels_last
          else x.reshape(x.shape[0], c, -1)).contiguous()
    if ctx.attr("is_test", False):
        inv = torch.rsqrt(var.float() + eps)
        y = K.batch_norm_apply(x3, scale, bias, mean, inv, act)
        ctx.set_output("Y", y.reshape(x.shape))
        return
    momentum = ctx.attr("momentum", 0.9)
    # statistics outside autograd: the closed-form backward already holds
    # their derivatives, and the running stats must not carry a graph from
    # step to step.  One pass in f32: E[x^2] - E[x]^2, as the JAX package.
    with torch.no_grad():
        xf = x3.float()
        n = x3.shape[0] * x3.shape[2]
        use_mean = xf.sum(dim=(0, 2)) / n
        use_var = torch.clamp(xf.square().sum(dim=(0, 2)) / n
                              - use_mean.square(), min=0.0)
        del xf
        inv = torch.rsqrt(use_var + eps)
        ctx.set_output("MeanOut", momentum * mean
                       + (1 - momentum) * use_mean.to(mean.dtype))
        ctx.set_output("VarianceOut", momentum * var
                       + (1 - momentum) * use_var.to(var.dtype))
    ctx.set_output("SavedMean", use_mean)
    # the inverse standard deviation that produced Y
    ctx.set_output("SavedVariance", inv)
    y = K.BatchNormTrain.apply(x3, scale.float(), bias.float(), use_mean, inv,
                               act)
    ctx.set_output("Y", y.reshape(x.shape))


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               begin_norm_axis: int = 1, epsilon: float = 1e-5):
    """layer_norm_op.cc over the trailing axes from ``begin_norm_axis``:
    returns (Y shaped like x, Mean and Variance shaped like
    ``x.shape[:begin_norm_axis]``).  The rows go to the LayerNorm kernel
    for CUDA tensors and to its plain version for CPU tensors; the
    statistics are f32, Y is in x's dtype.  Forward only (serving)."""
    f = math.prod(x.shape[begin_norm_axis:])
    x2 = x.reshape(-1, f)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    y, mean, var = K.layer_norm_fwd(x2, scale.reshape(f).float(),
                                    bias.reshape(f).float(), epsilon)
    lead = x.shape[:begin_norm_axis]
    return y.reshape(x.shape), mean.reshape(lead), var.reshape(lead)


@register_op("layer_norm", doc="layer_norm_op.cc")
def _layer_norm(ctx):
    x = ctx.input("X")
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    begin = ctx.attr("begin_norm_axis", 1)
    f = math.prod(x.shape[begin:])
    x2 = x.reshape(-1, f).contiguous()
    sc = (scale.reshape(f).float() if scale is not None
          else torch.ones(f, device=x.device))
    b = (bias.reshape(f).float() if bias is not None
         else torch.zeros(f, device=x.device))
    y, mean, var = K.LayerNorm.apply(x2, sc, b, ctx.attr("epsilon", 1e-5))
    ctx.set_output("Y", y.reshape(x.shape))
    ctx.set_output("Mean", mean.reshape(x.shape[:begin]))
    ctx.set_output("Variance", var.reshape(x.shape[:begin]))


# ---------------------------------------------------------------------------
# softmax and losses
# ---------------------------------------------------------------------------

@register_op("softmax")
def _softmax(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", torch.softmax(x.float(), dim=-1).to(x.dtype))


@register_op("cross_entropy", doc="cross_entropy_op.cc: takes probabilities")
def _cross_entropy(ctx):
    """-log of the hard label's probability, clamped at 1e-8, in f32 (soft
    labels and the sequence-length mask of 3-D LoD inputs are not
    ported)."""
    if ctx.attr("soft_label", False):
        raise NotImplementedError("soft_label cross_entropy is not ported")
    probs = torch.clamp(ctx.input("X").float(), min=1e-8)
    label = ctx.input("Label")
    lab = label[..., 0] if label.dim() == probs.dim() else label
    ctx.set_output("Y", -torch.log(probs.gather(-1, lab.long()[..., None])))


@register_op("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ctx):
    logits = ctx.input("Logits")           # [..., V], any rank >= 2
    label = ctx.input("Label")
    if ctx.attr("soft_label", False):
        raise NotImplementedError("soft_label softmax_with_cross_entropy "
                                  "is not ported")
    lab = label[..., 0] if label.dim() == logits.dim() else label
    v = logits.shape[-1]
    loss = K.SoftmaxXent.apply(logits.reshape(-1, v).contiguous(),
                               lab.reshape(-1))
    ctx.set_output("Loss", loss.reshape(tuple(lab.shape) + (1,)))
    # the [.., V] probabilities only when something reads them
    if ctx.output_needed("Softmax"):
        ctx.set_output("Softmax", torch.softmax(logits.float(), dim=-1))


@register_op("lookup_table", doc="lookup_table_op.cc: embedding gather")
def _lookup_table(ctx):
    ids = ctx.input("Ids")
    w = ctx.input("W")
    flat = ids[..., 0] if ids.dim() >= 2 and ids.shape[-1] == 1 else ids
    out = F.embedding(flat.long(), w)
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        # the padding row reads (and so trains) as zeros
        out = out.masked_fill((flat == padding_idx)[..., None], 0.0)
    ctx.set_output("Out", out)


@register_op("dropout")
def _dropout(ctx):
    x = ctx.input("X")
    prob = ctx.attr("dropout_prob", 0.5)
    if ctx.attr("is_test", False):
        ctx.set_output("Out", x * (1.0 - prob))
        return
    if prob == 0.0:
        ctx.set_output("Out", x)
        if ctx.output_needed("Mask"):
            ctx.set_output("Mask", torch.ones_like(x))
        return
    keep = torch.rand(x.shape, generator=ctx.next_rng(), device=x.device)
    mask = (keep < 1.0 - prob).to(x.dtype)
    ctx.set_output("Mask", mask)
    ctx.set_output("Out", x * mask)
