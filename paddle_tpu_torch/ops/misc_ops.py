"""Miscellaneous op rules (counterpart of ``paddle_tpu/ops/misc_ops.py``):
``sharding_constraint`` and the long tail of the reference's operator
inventory.

Parity targets (paddle/fluid/operators/): minus_op.cc, l1_norm_op.cc,
label_smooth_op.cc, modified_huber_loss_op.cc, multiplex_op.cc,
crop_op.cc, fill_op.cc, conv_shift_op.cc, bilinear_tensor_product_op.cc,
bilinear_interp_op.cc, pool_with_index_op.cc (max_pool2d_with_index /
max_pool3d_with_index), unpool_op.cc, spp_op.cc, roi_pool_op.cc,
gru_unit_op.cc, lstmp_op.cc, positive_negative_pair_op.cc, and the v1
ScaleSubRegionLayer.

None of them reaches a kernel in the JAX package (``lstmp`` is a scan,
``gru_unit`` two products): each is torch functions on tensors, and
autograd gives the gradient.  Where PyTorch has a look-alike whose
contract differs, the rule follows the JAX formula instead:

- ``max_pool*_with_index`` is the JAX reducer itself, a strict ``>`` fold
  over the window in row-major order from (-inf, 0): the first maximum
  wins a tie, and ``Mask`` is the int32 flat index in the unpadded input
  plane (``F.max_pool2d(return_indices=True)`` promises no tie rule on
  CUDA);
- ``roi_pool`` rounds half to even, its bins ``[floor(i*rh/ph),
  ceil((i+1)*rh/ph))`` overlap, an empty bin gives 0, and a missing
  ``RoisBatchId`` means image 0;
- ``bilinear_interp`` uses corner-aligned ratios ``(h-1)/(out_h-1)`` (0 at
  an output size of 1);
- ``unpool``'s output is ``(h-1)*s - 2p + k`` a side, and an index outside
  it is dropped, as a JAX scatter drops it;
- ``positive_negative_pair`` counts a tied score as neutral and negative.
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from ..core.types import to_torch_dtype


@register_op("sharding_constraint",
             doc="pins an activation's logical-axis layout on a mesh; the "
                 "port runs on one card with no mesh, so it is the "
                 "identity")
def _sharding_constraint(ctx):
    ctx.set_output("Out", ctx.input("X"))


# ---------------------------------------------------------------------------
# elementwise and loss tail
# ---------------------------------------------------------------------------

@register_op("minus", doc="minus_op.cc: Out = X - Y")
def _minus(ctx):
    ctx.set_output("Out", ctx.input("X") - ctx.input("Y"))


@register_op("l1_norm", doc="l1_norm_op.cc: Out = sum(|X|)")
def _l1_norm(ctx):
    ctx.set_output("Out", torch.sum(torch.abs(ctx.input("X"))))


@register_op("label_smooth",
             doc="label_smooth_op.cc: (1-eps)*X + eps*prior (uniform "
                 "default)")
def _label_smooth(ctx):
    x = ctx.input("X")
    eps = ctx.attr("epsilon", 0.0)
    prior = ctx.input("PriorDist")
    if prior is not None:
        smooth = eps * prior.reshape((1,) * (x.dim() - 1) + (-1,))
    else:
        smooth = eps / x.shape[-1]
    ctx.set_output("Out", (1.0 - eps) * x + smooth)


@register_op("modified_huber_loss",
             doc="modified_huber_loss_op.h: y in {0,1} -> +-1; -4v | "
                 "(1-v)^2 | 0")
def _modified_huber_loss(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    inter = x * (2.0 * y - 1.0)
    zero = torch.zeros((), dtype=inter.dtype, device=inter.device)
    loss = torch.where(inter < -1.0, -4.0 * inter,
                       torch.where(inter < 1.0, (1.0 - inter) ** 2, zero))
    ctx.set_output("IntermediateVal", inter)
    ctx.set_output("Out", loss.reshape(-1, 1))


# ---------------------------------------------------------------------------
# tensor shuffling
# ---------------------------------------------------------------------------

@register_op("multiplex",
             doc="multiplex_op.cc: Out[i] = X[Ids[i]][i] (row select)")
def _multiplex(ctx):
    ids = ctx.input("Ids").reshape(-1).long()
    xs = torch.stack(ctx.inputs("X"))                # [N, B, ...]
    rows = torch.arange(ids.shape[0], device=ids.device)
    ctx.set_output("Out", xs[ids, rows])


@register_op("crop", doc="crop_op.cc: crop X to Y's shape (or the shape "
                         "attr) at offsets")
def _crop(ctx):
    """Offsets are clamped so that the window fits, as lax.dynamic_slice
    clamps them."""
    x, y = ctx.input("X"), ctx.input("Y")
    shape = tuple(y.shape) if y is not None else tuple(ctx.attr("shape"))
    offsets = ctx.attr("offsets", [0] * x.dim())
    index = tuple(slice(o, o + n) for o, n in
                  ((min(max(int(o), 0), d - n), n)
                   for o, n, d in zip(offsets, shape, x.shape)))
    ctx.set_output("Out", x[index])


@register_op("fill", doc="fill_op.cc: Out = reshape(value attr, shape)")
def _fill(ctx):
    data = torch.tensor(ctx.attr("value"),
                        dtype=to_torch_dtype(ctx.attr("dtype", "float32")),
                        device=ctx.device)
    ctx.set_output("Out", data.reshape(tuple(ctx.attr("shape"))))


@register_op("conv_shift",
             doc="conv_shift_op.cc: circular correlation (NTM addressing)")
def _conv_shift(ctx):
    x, y = ctx.input("X"), ctx.input("Y")            # [B, M], [B, N]
    m, n = x.shape[1], y.shape[1]
    half = (n - 1) // 2
    # Out[i] = sum_j X[(i + j - half) mod M] * Y[j]
    pos = torch.arange(m, device=x.device)[:, None]
    idx = (pos + torch.arange(n, device=x.device)[None, :] - half) % m
    ctx.set_output("Out", torch.einsum("bmn,bn->bm", x[:, idx], y))


@register_op("bilinear_tensor_product",
             doc="bilinear_tensor_product_op.cc: Out_i = x W_i y^T + b_i")
def _bilinear_tensor_product(ctx):
    x, y, w = ctx.input("X"), ctx.input("Y"), ctx.input("Weight")
    out = torch.einsum("bm,kmn,bn->bk", x, w, y).to(x.dtype)
    bias = ctx.input("Bias")
    if bias is not None:
        out = out + bias.reshape(1, -1)
    ctx.set_output("Out", out)


# ---------------------------------------------------------------------------
# interpolation and pooling
# ---------------------------------------------------------------------------

@register_op("bilinear_interp",
             doc="bilinear_interp_op.cc: NCHW resize, corner-aligned "
                 "ratios")
def _bilinear_interp(ctx):
    x = ctx.input("X")                               # [N, C, H, W]
    out_h, out_w = ctx.attr("out_h"), ctx.attr("out_w")
    h, w = x.shape[2], x.shape[3]

    def axis(size, out):
        ratio = (size - 1.0) / (out - 1.0) if out > 1 else 0.0
        pos = torch.arange(out, dtype=torch.float32, device=x.device) * ratio
        lo = torch.clamp(torch.floor(pos).long(), 0, size - 1)
        return lo, torch.clamp(lo + 1, max=size - 1), (pos - lo).to(x.dtype)

    h0, h1, lh = axis(h, out_h)
    w0, w1, lw = axis(w, out_w)
    lh, lw = lh[:, None], lw[None, :]
    top = x[:, :, h0][:, :, :, w0] * (1 - lw) + x[:, :, h0][:, :, :, w1] * lw
    bot = x[:, :, h1][:, :, :, w0] * (1 - lw) + x[:, :, h1][:, :, :, w1] * lw
    ctx.set_output("Out", top * (1 - lh) + bot * lh)


def _pool_with_index(ctx, ndim):
    """Max pool with the flat argmax index: the JAX reducer, a strict
    ``>`` fold over each window in row-major order, from (-inf, 0)."""
    x = ctx.input("X")                               # [N, C, *spatial]
    ksize = list(ctx.attr("ksize"))
    strides = list(ctx.attr("strides", [1] * ndim))
    pads = list(ctx.attr("paddings", [0] * ndim))
    spatial = tuple(x.shape[-ndim:])
    if ctx.attr("global_pooling", False):
        ksize, strides, pads = list(spatial), [1] * ndim, [0] * ndim
    flat = torch.arange(math.prod(spatial), dtype=torch.int32,
                        device=x.device).reshape(spatial).expand(x.shape)
    pad = [p for q in reversed(pads) for p in (q, q)]
    xp = F.pad(x, pad, value=float("-inf"))
    ip = F.pad(flat, pad, value=0)
    outs = [(s + 2 * p - k) // st + 1
            for s, p, k, st in zip(spatial, pads, ksize, strides)]
    lead = (slice(None), slice(None))
    best = torch.full(x.shape[:2] + tuple(outs), float("-inf"),
                      dtype=x.dtype, device=x.device)
    arg = torch.zeros(best.shape, dtype=torch.int32, device=x.device)
    for offs in itertools.product(*(range(k) for k in ksize)):
        window = lead + tuple(slice(o, o + st * (n - 1) + 1, st)
                              for o, st, n in zip(offs, strides, outs))
        cur = xp[window]
        take = cur > best
        best = torch.where(take, cur, best)
        arg = torch.where(take, ip[window], arg)
    ctx.set_output("Out", best)
    ctx.set_output("Mask", arg)


@register_op("max_pool2d_with_index",
             doc="pool_with_index_op.cc: max pool + argmax mask")
def _max_pool2d_with_index(ctx):
    _pool_with_index(ctx, 2)


@register_op("max_pool3d_with_index",
             doc="pool_with_index_op.cc: 3-D max pool + argmax mask")
def _max_pool3d_with_index(ctx):
    _pool_with_index(ctx, 3)


@register_op("unpool",
             doc="unpool_op.cc: max-unpool by an Indices scatter "
                 "(Zeiler'11)")
def _unpool(ctx):
    x = ctx.input("X")                               # [N, C, H, W]
    idx = ctx.input("Indices").long()                # flat h*w positions
    ksize = ctx.attr("ksize")
    strides = ctx.attr("strides", [1, 1])
    pads = ctx.attr("paddings", [0, 0])
    n, c, h, w = x.shape
    out_h = (h - 1) * strides[0] - 2 * pads[0] + ksize[0]
    out_w = (w - 1) * strides[1] - 2 * pads[1] + ksize[1]
    size = out_h * out_w
    flat_i = idx.reshape(n * c, h * w)
    # a negative index counts from the end, as a JAX .at[] index does;
    # one still outside the output lands in a spare column, dropped
    flat_i = torch.where(flat_i < 0, flat_i + size, flat_i)
    flat_i = torch.where((flat_i >= 0) & (flat_i < size), flat_i,
                         torch.full_like(flat_i, size))
    out = torch.zeros((n * c, size + 1), dtype=x.dtype, device=x.device)
    out = out.scatter(1, flat_i, x.reshape(n * c, h * w))
    ctx.set_output("Out", out[:, :size].reshape(n, c, out_h, out_w))


def _adaptive_bins(size, bins, device):
    """Boolean [bins, size] membership: bin b covers [floor(b*size/bins),
    ceil((b+1)*size/bins))."""
    b = torch.arange(bins, device=device)
    starts = torch.floor(b * size / bins).long()
    ends = torch.ceil((b + 1) * size / bins).long()
    pos = torch.arange(size, device=device)
    return (pos[None, :] >= starts[:, None]) & (pos[None, :] < ends[:, None])


@register_op("spp", doc="spp_op.cc: spatial pyramid pooling (He'14)")
def _spp(ctx):
    x = ctx.input("X")                               # [N, C, H, W]
    levels = ctx.attr("pyramid_height")
    ptype = ctx.attr("pooling_type", "max")
    n, c, h, w = x.shape
    neg = torch.tensor(float("-inf"), dtype=x.dtype, device=x.device)
    outs = []
    for lvl in range(levels):
        bins = 2 ** lvl
        mh = _adaptive_bins(h, bins, x.device)       # [bins, H]
        mw = _adaptive_bins(w, bins, x.device)       # [bins, W]
        if ptype == "max":
            # a masked row max [N, C, bins, W], then a column max
            rows = torch.amax(torch.where(mh[None, None, :, :, None],
                                          x[:, :, None, :, :], neg), dim=3)
            pooled = torch.amax(torch.where(mw[None, None, None, :, :],
                                            rows[:, :, :, None, :], neg),
                                dim=4)
        else:
            mhf, mwf = mh.to(x.dtype), mw.to(x.dtype)
            summed = torch.einsum("nchw,bh,dw->ncbd", x, mhf, mwf)
            area = mhf.sum(1)[:, None] * mwf.sum(1)[None, :]
            pooled = summed / area
        outs.append(pooled.reshape(n, c * bins * bins))
    ctx.set_output("Out", torch.cat(outs, dim=1))


@register_op("roi_pool", doc="roi_pool_op.cc: Fast-RCNN ROI max pooling")
def _roi_pool(ctx):
    x = ctx.input("X")                               # [N, C, H, W]
    rois = ctx.input("ROIs")                         # [R, 4] x1,y1,x2,y2
    batch_ids = ctx.input("RoisBatchId")
    scale = ctx.attr("spatial_scale", 1.0)
    ph, pw = ctx.attr("pooled_height", 1), ctx.attr("pooled_width", 1)
    h, w = x.shape[2], x.shape[3]
    dev = x.device
    r = rois.shape[0]
    if batch_ids is None:
        batch_ids = torch.zeros(r, dtype=torch.long, device=dev)
    # torch.round rounds half to even, as jnp.round does
    x1, y1, x2, y2 = (torch.round(rois[:, i] * scale).long()
                      for i in range(4))
    rh = torch.clamp(y2 - y1 + 1, min=1)
    rw = torch.clamp(x2 - x1 + 1, min=1)

    def bins(start, extent, count, lo, hi, size):
        """[R, count, size] membership of each bin; neighbouring bins
        overlap when extent % count != 0."""
        i = torch.arange(count, device=dev)[None, :]
        b0 = start[:, None] + torch.floor(
            (i * extent[:, None]).float() / count).long()
        b1 = start[:, None] + torch.ceil(
            ((i + 1) * extent[:, None]).float() / count).long()
        pos = torch.arange(size, device=dev)[None, None, :]
        inside = ((pos >= lo[:, None, None]) & (pos <= hi[:, None, None]))
        return (pos >= b0[:, :, None]) & (pos < b1[:, :, None]) & inside

    hm = bins(y1, rh, ph, y1, y2, h)                 # [R, ph, H]
    wm = bins(x1, rw, pw, x1, x2, w)                 # [R, pw, W]
    mask = hm[:, :, None, :, None] & wm[:, None, :, None, :]
    img = x[batch_ids.reshape(r).long()]             # [R, C, H, W]
    neg = torch.tensor(float("-inf"), dtype=x.dtype, device=dev)
    masked = torch.where(mask[:, None], img[:, :, None, None], neg)
    pooled = torch.amax(masked, dim=(-2, -1))        # [R, C, ph, pw]
    hit = mask.any(dim=-1).any(dim=-1)[:, None]
    ctx.set_output("Out", torch.where(hit, pooled,
                                      torch.zeros((), dtype=x.dtype,
                                                  device=dev)))


# ---------------------------------------------------------------------------
# recurrent-cell tail
# ---------------------------------------------------------------------------

def _identity(v):
    return v


#: activations by the reference's enum number or by name
_ACTS = {0: _identity, 1: torch.sigmoid, 2: torch.tanh, 3: torch.relu,
         "identity": _identity, "sigmoid": torch.sigmoid,
         "tanh": torch.tanh, "relu": torch.relu}


@register_op("gru_unit", doc="gru_unit_op.cc: one GRU step on pre-projected "
                             "gates; h = (1-u)*h_prev + u*c")
def _gru_unit(ctx):
    x = ctx.input("Input")                           # [B, 3H] = xu|xr|xc
    h_prev = ctx.input("HiddenPrev")                 # [B, H]
    w = ctx.input("Weight")                          # [H, 3H]
    bias = ctx.input("Bias")                         # [1, 3H]
    g_act = _ACTS[ctx.attr("gate_activation", "sigmoid")]
    c_act = _ACTS[ctx.attr("activation", "tanh")]
    hid = h_prev.shape[1]
    if bias is not None:
        x = x + bias.reshape(1, -1)
    ur = g_act(x[:, :2 * hid] + (h_prev.float() @ w[:, :2 * hid].float()
                                 ).to(x.dtype))
    u, r = ur[:, :hid], ur[:, hid:]
    r_h = r * h_prev
    c = c_act(x[:, 2 * hid:] + (r_h.float() @ w[:, 2 * hid:].float()
                                ).to(x.dtype))
    ctx.set_output("Gate", torch.cat([u, r, c], dim=1))
    ctx.set_output("ResetHiddenPrev", r_h)
    ctx.set_output("Hidden", (1.0 - u) * h_prev + u * c)


@register_op("lstmp", doc="lstmp_op.cc: LSTM with a recurrent projection "
                          "(Sak'14); the recurrence runs in projected space")
def _lstmp(ctx):
    """Each step gates from the projected state r; ``Length`` masks the
    step (a padded step keeps the state), ``is_reverse`` runs time
    backwards, peepholes come from ``Bias[4H:7H]`` when the bias is that
    long and ``use_peepholes`` is set."""
    x = ctx.input("Input")                           # [B, T, 4H]
    w = ctx.input("Weight")                          # [P, 4H]
    w_proj = ctx.input("ProjWeight")                 # [H, P]
    bias = ctx.input("Bias")                         # [1, 4H] (+3H peephole)
    lens = ctx.seq_len_of("Input")
    g_act = _ACTS[ctx.attr("gate_activation", "sigmoid")]
    c_act = _ACTS[ctx.attr("cell_activation", "tanh")]
    d_act = _ACTS[ctx.attr("candidate_activation", "tanh")]
    p_act = _ACTS[ctx.attr("proj_activation", "tanh")]
    b_sz, t_len, h4 = x.shape
    hid = h4 // 4
    h0, c0 = ctx.input("H0"), ctx.input("C0")
    r = (torch.zeros((b_sz, w.shape[0]), dtype=x.dtype, device=x.device)
         if h0 is None else h0)
    c = (torch.zeros((b_sz, hid), dtype=x.dtype, device=x.device)
         if c0 is None else c0)
    b = bias.reshape(-1) if bias is not None else None
    peep = (b[4 * hid:7 * hid] if ctx.attr("use_peepholes", False)
            and b is not None and b.shape[0] >= 7 * hid else None)
    xs = x.transpose(0, 1)                           # [T, B, 4H]
    if b is not None:
        xs = xs + b[:4 * hid].reshape(1, 1, -1)
    steps = torch.arange(t_len, device=x.device)[:, None]
    tm = (torch.ones((t_len, b_sz), dtype=x.dtype, device=x.device)
          if lens is None else (steps < lens[None, :].to(x.device)
                                ).to(x.dtype))
    order = range(t_len - 1, -1, -1) if ctx.attr("is_reverse", False) \
        else range(t_len)
    rs, cs = [None] * t_len, [None] * t_len
    for t in order:
        gates = xs[t] + (r.float() @ w.float()).to(x.dtype)
        i, f, g, o = gates.split(hid, dim=-1)
        if peep is not None:
            wi, wf, wo = peep.split(hid)
            i = i + c * wi
            f = f + c * wf
        c_new = g_act(f) * c + g_act(i) * d_act(g)
        if peep is not None:
            o = o + c_new * wo
        h_new = g_act(o) * c_act(c_new)
        r_new = p_act((h_new.float() @ w_proj.float()).to(x.dtype))
        m = tm[t][:, None]
        r = m * r_new + (1 - m) * r
        c = m * c_new + (1 - m) * c
        rs[t], cs[t] = r, c
    ctx.set_output("Projection", torch.stack(rs, dim=1))
    ctx.set_output("Cell", torch.stack(cs, dim=1))
    ctx.set_seq_len("Projection", lens)
    ctx.set_seq_len("Cell", lens)


# ---------------------------------------------------------------------------
# ranking metric and the v1 region scale
# ---------------------------------------------------------------------------

@register_op("positive_negative_pair",
             doc="positive_negative_pair_op.cc: LTR concordant/discordant/"
                 "tied pair counts per query")
def _positive_negative_pair(ctx):
    """A pair with differing labels and equal scores counts as neutral AND
    negative (the reference's ternary sends a product of 0 to neg); a NaN
    score lands in neg.  Pair weight (w_i + w_j) / 2."""
    score = ctx.input("Score")
    s = (score[:, ctx.attr("column", 0)] if score.dim() > 1
         else score.reshape(-1))
    label = ctx.input("Label").reshape(-1)
    qid = ctx.input("QueryID").reshape(-1)
    n = s.shape[0]
    upper = torch.ones((n, n), dtype=torch.bool, device=s.device).triu(1)
    ldiff = label[:, None] - label[None, :]
    sdiff = s[:, None] - s[None, :]
    informative = (qid[:, None] == qid[None, :]) & upper & (ldiff != 0)
    weight = ctx.input("Weight")
    if weight is not None:
        wv = weight.reshape(-1).float()
        pairw = 0.5 * (wv[:, None] + wv[None, :])
    else:
        pairw = torch.ones((n, n), dtype=torch.float32, device=s.device)
    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    concordant = ldiff * sdiff > 0
    pos = torch.where(informative & concordant, pairw, zero).sum()
    neg = torch.where(informative & ~concordant, pairw, zero).sum()
    neu = torch.where(informative & (sdiff == 0), pairw, zero).sum()
    acc_p = ctx.input("AccumulatePositivePair")
    if acc_p is not None:
        pos = pos + acc_p
        neg = neg + ctx.input("AccumulateNegativePair")
        neu = neu + ctx.input("AccumulateNeutralPair")
    ctx.set_output("PositivePair", pos.reshape(1))
    ctx.set_output("NegativePair", neg.reshape(1))
    ctx.set_output("NeutralPair", neu.reshape(1))


@register_op("scale_sub_region",
             doc="v1 ScaleSubRegionLayer: multiply `value` over a "
                 "per-sample CHW box; indices are 1-based [Cs, Ce, Hs, He, "
                 "Ws, We]")
def _scale_sub_region(ctx):
    x = ctx.input("X")                               # [B, C, H, W]
    idx = ctx.input("Indices").long()                # [B, 6]
    value = ctx.attr("value", 1.0)
    lo = idx[:, 0::2] - 1                            # zero-based starts
    hi = idx[:, 1::2]                                # exclusive ends
    mask = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    for axis in range(3):
        pos = torch.arange(x.shape[axis + 1], device=x.device)
        shape = [1, 1, 1, 1]
        shape[axis + 1] = -1
        pos = pos.reshape(shape)
        mask = mask & (pos >= lo[:, axis, None, None, None]) \
            & (pos < hi[:, axis, None, None, None])
    ctx.set_output("Out", torch.where(mask, x * value, x))
