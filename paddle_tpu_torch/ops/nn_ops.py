"""Neural-network ops (counterpart of ``paddle_tpu/ops/nn_ops.py``):
`layer_norm` for the serving model, and the op rules of the dense
families -- convolutions (``conv2d``, ``depthwise_conv2d``,
``conv2d_transpose``, ``conv3d``), pooling (``pool2d``, ``pool3d``),
normalisation (``batch_norm``, ``layer_norm``, ``lrn``,
``l2_normalize``), ``softmax``/``log_softmax``, the losses
(``cross_entropy`` on probabilities, ``softmax_with_cross_entropy``, the
sigmoid, smooth-L1, Huber, hinge, log and rank losses), ``lookup_table``
(dense gradient), ``prelu``, ``dropout``, and the sequence-shaped
``im2sequence`` and ``row_conv``.

The BatchNorm, LayerNorm and hard-label loss-head rules go through the
autograd Functions of `ops.kernels`, so their backward runs the
BatchNorm, LayerNorm and softmax-xent backward kernels on the card and
the plain versions on the CPU.  Convolution is a library product in both
packages (``lax.conv_general_dilated`` there, cuDNN through ``F.conv*d``
here).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.lowering import (CACHED_ROWS_SUFFIX, QSCALE_SUFFIX,
                             dequantize_int8)
from ..core.registry import register_op
from . import kernels as K
from .math_ops import amp_operands, amp_out, conv_accum_dtype
from .tensor_ops import wrap_indices


def _pair(v, n=2):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


# ---------------------------------------------------------------------------
# convolution and pooling
# ---------------------------------------------------------------------------

def _conv_operands(ctx, x, w):
    """(x, w, want): the operands in the dtype the conv computes in (see
    `conv_accum_dtype`) and the declared dtype of the output."""
    want = x.dtype
    x, w = amp_operands(ctx, x, w)
    acc = conv_accum_dtype(ctx)
    if acc is not None:
        x = x.to(torch.promote_types(x.dtype, acc))
        w = w.to(torch.promote_types(w.dtype, acc))
    return x, w, want


@register_op("conv2d")
def _conv2d(ctx):
    x = ctx.input("Input")          # NCHW, or NHWC with data_format
    w = ctx.input("Filter")         # OIHW whatever the layout
    strides = _pair(ctx.attr("strides", [1, 1]))
    pads = _pair(ctx.attr("paddings", [0, 0]))
    dilations = _pair(ctx.attr("dilations", [1, 1]))
    groups = ctx.attr("groups", 1) or 1
    x, w, want = _conv_operands(ctx, x, w)
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


@register_op("depthwise_conv2d")
def _depthwise_conv2d(ctx):
    x = ctx.input("Input")          # NCHW
    groups = ctx.attr("groups", x.shape[1])
    xc, w, want = _conv_operands(ctx, x, ctx.input("Filter"))
    out = F.conv2d(xc, w, None, _pair(ctx.attr("strides", [1, 1])),
                   _pair(ctx.attr("paddings", [0, 0])),
                   _pair(ctx.attr("dilations", [1, 1])), groups)
    ctx.set_output("Output", amp_out(ctx, out, want))


@register_op("conv2d_transpose")
def _conv2d_transpose(ctx):
    """NCHW input, IOHW filter.  Fluid's padding p means "the forward
    conv had padding p": out = (in - 1) * s - 2p + d * (k - 1) + 1
    (conv2d_transpose_op.cc InferShape), which is torch's
    ``conv_transpose2d`` with that padding; groups are ignored, as in the
    JAX rule."""
    x, w, want = _conv_operands(ctx, ctx.input("Input"),
                                ctx.input("Filter"))
    out = F.conv_transpose2d(x, w, None,
                             _pair(ctx.attr("strides", [1, 1])),
                             _pair(ctx.attr("paddings", [0, 0])),
                             dilation=_pair(ctx.attr("dilations", [1, 1])))
    ctx.set_output("Output", amp_out(ctx, out, want))


@register_op("conv3d")
def _conv3d(ctx):
    x, w, want = _conv_operands(ctx, ctx.input("Input"),   # NCDHW, OIDHW
                                ctx.input("Filter"))
    out = F.conv3d(x, w, None, _pair(ctx.attr("strides", [1, 1, 1]), 3),
                   _pair(ctx.attr("paddings", [0, 0, 0]), 3),
                   _pair(ctx.attr("dilations", [1, 1, 1]), 3),
                   ctx.attr("groups", 1) or 1)
    ctx.set_output("Output", amp_out(ctx, out, want))


_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool(x, ptype, ksize, strides, pads, ceil_mode, exclusive):
    """pool_op.cc over an N, C, *spatial view (2 or 3 spatial dims) with
    the JAX package's padding rules: max pooling pads with -inf; an
    exclusive average divides by the count of real elements when there
    is padding; ceil_mode pads the high side so that the last partial
    window is emitted (PyTorch's own ceil_mode drops a last window that
    starts in the padding)."""
    nd = len(ksize)
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
        spec = [v for i in reversed(range(nd)) for v in (pads[i], hi[i])]
        if ptype != "max" and exclusive:
            ones = F.pad(torch.ones_like(x), spec)
            x = F.pad(x, spec)
            avg = _AVG_POOL[nd]
            return (avg(x, ksize, strides, divisor_override=1)
                    / avg(ones, ksize, strides, divisor_override=1))
        x = F.pad(x, spec, value=float("-inf") if ptype == "max" else 0.0)
        pads = (0,) * nd
    if ptype == "max":
        return _MAX_POOL[nd](x, ksize, strides, pads)
    return _AVG_POOL[nd](x, ksize, strides, pads,
                         count_include_pad=not (exclusive and padded))


def _pool_rule(nd):
    def rule(ctx):
        x = ctx.input("X")
        channels_last = ctx.attr("data_format", "NCHW").endswith("C")
        # N, C, *spatial
        xv = x.movedim(-1, 1) if channels_last else x
        if ctx.attr("global_pooling", False):
            ksize, strides, pads = tuple(xv.shape[2:]), (1,) * nd, (0,) * nd
        else:
            ksize = _pair(ctx.attr("ksize"), nd)
            strides = _pair(ctx.attr("strides", [1] * nd), nd)
            pads = _pair(ctx.attr("paddings", [0] * nd), nd)
        out = _pool(xv, ctx.attr("pooling_type", "max"), ksize, strides,
                    pads, ctx.attr("ceil_mode", False),
                    ctx.attr("exclusive", True))
        if channels_last:
            out = out.movedim(1, -1)
        ctx.set_output("Out", out.to(x.dtype))
    return rule


register_op("pool2d")(_pool_rule(2))
register_op("pool3d")(_pool_rule(3))


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
    # step to step.  One pass in f32 (f64 for an f64 input): E[x^2] -
    # E[x]^2, as the JAX package.
    with torch.no_grad():
        xf = x3.to(torch.promote_types(x3.dtype, torch.float32))
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


@register_op("lrn", doc="lrn_op.cc: local response norm across channels")
def _lrn(ctx):
    x = ctx.input("X")              # NCHW
    n = ctx.attr("n", 5)
    half = n // 2
    sq = F.pad(torch.square(x.float()), (0, 0, 0, 0, half, half))
    win = sum(sq[:, i:i + x.shape[1]] for i in range(n))
    mid = ctx.attr("k", 2.0) + ctx.attr("alpha", 1e-4) * win
    ctx.set_output("Out", (x / torch.pow(mid, ctx.attr("beta", 0.75))
                           ).to(x.dtype))
    ctx.set_output("MidOut", mid)


@register_op("l2_normalize")
def _l2_normalize(ctx):
    x = ctx.input("X")
    norm = torch.sqrt(torch.sum(torch.square(x), dim=ctx.attr("axis", -1),
                                keepdim=True) + ctx.attr("epsilon", 1e-12))
    ctx.set_output("Out", x / norm)


# ---------------------------------------------------------------------------
# softmax and losses
# ---------------------------------------------------------------------------

@register_op("softmax")
def _softmax(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", torch.softmax(x.float(), dim=-1).to(x.dtype))


@register_op("log_softmax")
def _log_softmax(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", torch.log_softmax(x.float(), dim=-1).to(x.dtype))


def _mask_padded_tokens(ctx, loss, slot, other):
    """A [B, T, 1] per-token loss of a ragged batch: zero past each row's
    length (from ``slot``'s @SEQ_LEN, else ``other``'s) and carry the
    lengths to the output, as the JAX rules do."""
    lens = ctx.seq_len_of(slot)
    if lens is None:
        lens = ctx.seq_len_of(other)
    if loss.dim() == 3 and lens is not None:
        live = (torch.arange(loss.shape[1], device=loss.device)[None, :]
                < lens[:, None].to(loss.device))
        loss = loss * live.to(loss.dtype)[..., None]
    return loss, lens if loss.dim() == 3 else None


@register_op("cross_entropy", doc="cross_entropy_op.cc: takes probabilities; "
             "3-D sequence inputs get length-masked per-token losses")
def _cross_entropy(ctx):
    """-log of the label's probability (clamped at 1e-8, in f32), or
    -sum(label * log p) with ``soft_label``.  A hard label follows
    ``jnp.take_along_axis``: a label in [-V, 0) wraps, any other label
    outside [0, V) gives NaN, and the gather is clamped, so no label
    reaches an indexing kernel out of range."""
    probs = torch.clamp(ctx.input("X").float(), min=1e-8)
    label = ctx.input("Label")
    if ctx.attr("soft_label", False):
        loss = -torch.sum(label * torch.log(probs), dim=-1, keepdim=True)
    else:
        lab = label[..., 0] if label.dim() == probs.dim() else label
        safe, oob = wrap_indices(lab, probs.shape[-1])
        picked = probs.gather(-1, safe[..., None]).masked_fill(
            oob[..., None], float("nan"))
        loss = -torch.log(picked)
    loss, lens = _mask_padded_tokens(ctx, loss, "Label", "X")
    ctx.set_output("Y", loss)
    ctx.set_seq_len("Y", lens)


@register_op("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ctx):
    """Hard labels run the softmax cross-entropy kernels (a label outside
    [0, V) follows the Pallas kernels: the loss is the row's lse); soft
    labels are plain torch, as the JAX soft-label path is plain XLA."""
    logits = ctx.input("Logits")           # [..., V], any rank >= 2
    label = ctx.input("Label")
    if ctx.attr("soft_label", False):
        logp = torch.log_softmax(logits.float(), dim=-1)
        ctx.set_output("Softmax", torch.exp(logp))
        ctx.set_output("Loss", -torch.sum(label * logp, dim=-1,
                                          keepdim=True))
        return
    lab = label[..., 0] if label.dim() == logits.dim() else label
    v = logits.shape[-1]
    loss = K.SoftmaxXent.apply(logits.reshape(-1, v).contiguous(),
                               lab.reshape(-1))
    loss, lens = _mask_padded_tokens(
        ctx, loss.reshape(tuple(lab.shape) + (1,)), "Label", "Logits")
    ctx.set_output("Loss", loss)
    ctx.set_seq_len("Loss", lens)
    # the [.., V] probabilities only when something reads them
    if ctx.output_needed("Softmax"):
        ctx.set_output("Softmax", torch.softmax(logits.float(), dim=-1))


@register_op("sigmoid_cross_entropy_with_logits")
def _sce_logits(ctx):
    x = ctx.input("X").float()
    label = ctx.input("Label").float()
    ctx.set_output("Out", torch.clamp(x, min=0) - x * label
                   + torch.log1p(torch.exp(-x.abs())))


@register_op("smooth_l1_loss")
def _smooth_l1(ctx):
    sigma = ctx.attr("sigma", 1.0)
    s2 = sigma * sigma
    diff = (ctx.input("X") - ctx.input("Y")).float()
    inw, outw = ctx.input("InsideWeight"), ctx.input("OutsideWeight")
    if inw is not None:
        diff = diff * inw
    ad = diff.abs()
    loss = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2)
    if outw is not None:
        loss = loss * outw
    ctx.set_output("Diff", diff)
    ctx.set_output("Out", loss.reshape(loss.shape[0], -1).sum(
        dim=1, keepdim=True))


@register_op("squared_l2_norm")
def _squared_l2_norm(ctx):
    ctx.set_output("Out", torch.sum(torch.square(ctx.input("X"))).reshape(1))


@register_op("squared_l2_distance")
def _squared_l2_distance(ctx):
    sub = ctx.input("X") - ctx.input("Y")
    ctx.set_output("sub_result", sub)
    ctx.set_output("Out", torch.sum(torch.square(sub), dim=-1, keepdim=True))


@register_op("huber_loss")
def _huber_loss(ctx):
    delta = ctx.attr("delta", 1.0)
    r = (ctx.input("Y") - ctx.input("X")).float()
    ar = r.abs()
    ctx.set_output("Residual", r)
    ctx.set_output("Out", torch.where(ar <= delta, 0.5 * r * r,
                                      delta * (ar - 0.5 * delta)))


@register_op("rank_loss")
def _rank_loss(ctx):
    d = (ctx.input("Left") - ctx.input("Right")).float()
    ctx.set_output("Out", torch.log1p(torch.exp(d)) - ctx.input("Label") * d)


@register_op("margin_rank_loss")
def _margin_rank_loss(ctx):
    x1, x2, label = ctx.input("X1"), ctx.input("X2"), ctx.input("Label")
    act = torch.clamp(-label * (x1 - x2) + ctx.attr("margin", 0.0), min=0.0)
    ctx.set_output("Out", act)
    ctx.set_output("Activated", (act > 0).to(x1.dtype))


@register_op("hinge_loss")
def _hinge_loss(ctx):
    logits, label = ctx.input("Logits"), ctx.input("Labels")
    ctx.set_output("Loss", torch.clamp(1.0 - (2.0 * label - 1.0) * logits,
                                       min=0.0))


@register_op("log_loss")
def _log_loss(ctx):
    p, label = ctx.input("Predicted"), ctx.input("Labels")
    eps = ctx.attr("epsilon", 1e-4)
    ctx.set_output("Loss", -label * torch.log(p + eps)
                   - (1.0 - label) * torch.log(1.0 - p + eps))


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     scale=None) -> torch.Tensor:
    """Rows of ``table [V, D]`` for ``ids`` (any shape) -> ``[*ids, D]``,
    with the JAX rule's out-of-range semantics (``jnp.take``): an id in
    ``[-V, 0)`` wraps, any other id outside ``[0, V)`` gives the fill
    row (NaN for a float table, the dtype's minimum for an int8 one).
    The ids are clamped before the gather, so no id reaches an indexing
    kernel out of range (on the card that would be a device assert,
    which ends the CUDA context).  ``scale`` (an int8 table's column
    scales) dequantizes the gathered rows, fill rows included."""
    safe, oob = wrap_indices(ids, table.shape[0])
    if table.is_floating_point():
        rows = F.embedding(safe, table).masked_fill(oob[..., None],
                                                    float("nan"))
    else:
        rows = table[safe].masked_fill(oob[..., None],
                                       torch.iinfo(table.dtype).min)
    return rows if scale is None else dequantize_int8(rows, scale)


@register_op("lookup_table", doc="lookup_table_op.cc: embedding gather")
def _lookup_table(ctx):
    """Ids [..., 1] or [...] (a ragged [B, T] batch keeps its lengths)."""
    ids = ctx.input("Ids")
    flat = ids[..., 0] if ids.dim() >= 2 and ids.shape[-1] == 1 else ids
    scale = ctx.env.get(ctx.input_name("W") + QSCALE_SUFFIX)
    pre = ctx.env.get(ctx.output_name("Out") + CACHED_ROWS_SUFFIX)
    if pre is not None:
        # the serving hot-row cache resolved the ids to rows (the table is
        # not in the env); an int8 cache's rows dequantize here
        out = (dequantize_int8(pre, scale)
               if pre.dtype == torch.int8 and scale is not None else pre)
    else:
        w = ctx.input("W")
        rows = ctx.interpreter.tables
        if rows is not None and rows.axis_of(ctx.input_name("W")):
            # a row-sharded table (parallel.embedding): W is this rank's
            # shard; the psum lookup (or the id exchange) gives the rows
            # bitwise; an int8 table's rows dequantize before the sum
            out = rows.lookup(ctx.block, ctx.input_name("W"), w, flat,
                              ctx.input_name("Ids"),
                              scale if w.dtype == torch.int8 else None)
        else:
            # an int8 table (serving precision "int8"): dequantize only
            # the gathered rows with the per-column scales, stored bf16
            out = embedding_lookup(w, flat, scale)
    table = ctx.input_name("W")
    if (ctx.attr("is_sparse") and torch.is_grad_enabled()
            and table in ctx.interpreter.sparse_tables):
        # a SelectedRows table (core.backward): the table does not
        # require grad, the gathered rows are the autograd leaf, before
        # the padding mask so that padded ids get zero values.  A
        # rematerialised segment's recompute keeps the first leaf.
        out.requires_grad_(True)
        ctx.interpreter.sparse_leaves.setdefault(ctx.output_name("Out"),
                                                 (out, flat))
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        # the padding row reads (and so trains) as zeros
        out = out.masked_fill((flat == padding_idx)[..., None], 0.0)
    ctx.set_output("Out", out)
    ctx.set_seq_len("Out", ctx.seq_len_of("Ids"))


@register_op("dropout", draws_rng=True)
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


@register_op("prelu")
def _prelu(ctx):
    x, alpha = ctx.input("X"), ctx.input("Alpha")
    mode = ctx.attr("mode", "all")
    if mode == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    elif mode == "element":
        alpha = alpha.reshape(x.shape[1:])
    ctx.set_output("Out", torch.where(x > 0, x, alpha * x))


@register_op("im2sequence", doc="im2sequence_op.cc: convolution patches "
             "as a sequence")
def _im2sequence(ctx):
    """NCHW -> [N, OH*OW, C*kh*kw] (one sequence an image, the patch's
    channel-major layout of ``lax.conv_general_dilated_patches``)."""
    x = ctx.input("X")
    kernels = ctx.attr("kernels")
    strides = ctx.attr("strides", [1, 1])
    pads = ctx.attr("paddings", [0, 0, 0, 0])
    xp = F.pad(x, (pads[1], pads[3], pads[0], pads[2]))
    patches = F.unfold(xp, tuple(kernels), stride=tuple(strides))
    out = patches.transpose(1, 2)
    ctx.set_output("Out", out)
    ctx.set_seq_len("Out", torch.full((x.shape[0],), out.shape[1],
                                      dtype=torch.int32, device=x.device))


@register_op("row_conv", doc="row_conv_op.cc: lookahead convolution over "
             "time")
def _row_conv(ctx):
    x = ctx.input("X")              # [batch, time, dim]
    w = ctx.input("Filter")         # [future_context + 1, dim]
    t = x.shape[1]
    pad = F.pad(x, (0, 0, 0, w.shape[0] - 1))
    out = sum(pad[:, i:i + t, :] * w[i] for i in range(w.shape[0]))
    ctx.set_output("Out", out)
    ctx.set_seq_len("Out", ctx.seq_len_of("X"))
