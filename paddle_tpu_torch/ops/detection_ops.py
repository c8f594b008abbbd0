"""Detection op rules (counterpart of ``paddle_tpu/ops/detection_ops.py``):
prior_box, box_coder, iou_similarity, bipartite_match, target_assign,
mine_hard_examples, multiclass_nms, detection_map, gather_encoded_target
and abs_smooth_l1.

The JAX package computes them in XLA, outside any Pallas kernel, so each
is torch functions on tensors here, on the card and on the CPU alike, and
autograd gives abs_smooth_l1's gradient.  They keep the JAX package's
static shapes: NMS and bipartite matching are fixed-count loops over
masks (``torch.where``, never a branch on a tensor, so no loop step syncs
with the host), and every box tensor is padded.

Ties follow the JAX primitives: ``jnp.argmax`` takes the first maximum
(as ``torch.argmax`` does), ``lax.top_k`` and ``jnp.argsort`` put the
lower index first among equals (a stable sort here).  multiclass_nms runs
every image and class at once: one loop of ``nms_top_k`` steps over a
``[B, C-1, K]`` keep mask, where the JAX rule maps images and loops over
classes in Python.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op


def _desc_order(x, dim=-1):
    """Indices that sort ``x`` descending along ``dim``, the lower index
    first among equals (``lax.top_k``'s order)."""
    return torch.sort(x, dim=dim, descending=True, stable=True).indices


# ---------------------------------------------------------------------------
# prior (anchor) boxes
# ---------------------------------------------------------------------------

@register_op("prior_box",
             doc="prior_box_op.cc: Boxes [H, W, P, 4] and Variances in f32")
def _prior_box(ctx):
    feat = ctx.input("Input")          # [N, C, H, W]
    image = ctx.input("Image")         # [N, C, IH, IW]
    min_sizes = list(ctx.attr("min_sizes"))
    max_sizes = list(ctx.attr("max_sizes") or [])
    aspect_ratios = list(ctx.attr("aspect_ratios", [1.0]))
    flip = ctx.attr("flip", False)
    clip = ctx.attr("clip", False)
    variances = list(ctx.attr("variances", [0.1, 0.1, 0.2, 0.2]))
    offset = ctx.attr("offset", 0.5)
    step_w = ctx.attr("step_w", 0.0)
    step_h = ctx.attr("step_h", 0.0)

    H, W = feat.shape[2], feat.shape[3]
    IH, IW = image.shape[2], image.shape[3]
    sw = step_w or IW / W
    sh = step_h or IH / H

    ars = [1.0]
    for ar in aspect_ratios:
        if abs(ar - 1.0) > 1e-6:
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)

    whs = []
    for ms in min_sizes:
        whs.append((ms, ms))
        if max_sizes:
            mx = max_sizes[min_sizes.index(ms)]
            whs.append(((ms * mx) ** 0.5, (ms * mx) ** 0.5))
        for ar in ars[1:]:
            whs.append((ms * ar ** 0.5, ms / ar ** 0.5))

    # f32 aranges, as the JAX rule computes them
    dev = feat.device
    cx = (torch.arange(W, dtype=torch.float32, device=dev) + offset) * sw
    cy = (torch.arange(H, dtype=torch.float32, device=dev) + offset) * sh
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")     # [H, W]
    out = torch.stack([torch.stack([(cxg - w / 2) / IW, (cyg - h / 2) / IH,
                                    (cxg + w / 2) / IW, (cyg + h / 2) / IH],
                                   dim=-1)
                       for (w, h) in whs], dim=2)        # [H, W, P, 4]
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    var = torch.tensor(variances, dtype=torch.float32,
                       device=dev).expand(out.shape)
    ctx.set_output("Boxes", out)
    ctx.set_output("Variances", var.contiguous())


@register_op("box_coder",
             doc="box_coder_op.cc: encode [N, 4] gts against [M, 4] priors "
                 "to [N, M, 4]; decode [M, 4] or [N, M, 4] offsets")
def _box_coder(ctx):
    prior = ctx.input("PriorBox")           # [M, 4] xmin ymin xmax ymax
    prior_var = ctx.input("PriorBoxVar")    # [M, 4]
    target = ctx.input("TargetBox")
    code_type = ctx.attr("code_type", "encode_center_size")
    pw = prior[:, 2] - prior[:, 0]
    ph = prior[:, 3] - prior[:, 1]
    pcx = (prior[:, 0] + prior[:, 2]) / 2
    pcy = (prior[:, 1] + prior[:, 3]) / 2
    if prior_var is None:
        prior_var = torch.ones_like(prior)
    if "encode" in code_type:
        tw = target[:, 2] - target[:, 0]
        th = target[:, 3] - target[:, 1]
        tcx = (target[:, 0] + target[:, 2]) / 2
        tcy = (target[:, 1] + target[:, 3]) / 2
        ox = (tcx[:, None] - pcx[None, :]) / pw[None, :] / prior_var[None, :, 0]
        oy = (tcy[:, None] - pcy[None, :]) / ph[None, :] / prior_var[None, :, 1]
        ow = torch.log(torch.clamp(tw[:, None] / pw[None, :], min=1e-10)
                       ) / prior_var[None, :, 2]
        oh = torch.log(torch.clamp(th[:, None] / ph[None, :], min=1e-10)
                       ) / prior_var[None, :, 3]
        out = torch.stack([ox, oy, ow, oh], dim=-1)
    else:
        if target.dim() == 2:
            target = target[None]
        ox, oy, ow, oh = (target[..., 0], target[..., 1],
                          target[..., 2], target[..., 3])
        cx = ox * prior_var[None, :, 0] * pw[None, :] + pcx[None, :]
        cy = oy * prior_var[None, :, 1] * ph[None, :] + pcy[None, :]
        w = torch.exp(ow * prior_var[None, :, 2]) * pw[None, :]
        h = torch.exp(oh * prior_var[None, :, 3]) * ph[None, :]
        out = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                          dim=-1)
    ctx.set_output("OutputBox", out.float())


def _iou(a, b):
    """a [..., N, 4], b [..., M, 4] -> [..., N, M] IoU (the JAX ``_iou``,
    its 1e-10 floor on the union included)."""
    area_a = (torch.clamp(a[..., 2] - a[..., 0], min=0)
              * torch.clamp(a[..., 3] - a[..., 1], min=0))
    area_b = (torch.clamp(b[..., 2] - b[..., 0], min=0)
              * torch.clamp(b[..., 3] - b[..., 1], min=0))
    ix = torch.clamp(
        torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
        - torch.maximum(a[..., :, None, 0], b[..., None, :, 0]), min=0)
    iy = torch.clamp(
        torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
        - torch.maximum(a[..., :, None, 1], b[..., None, :, 1]), min=0)
    inter = ix * iy
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-10)


@register_op("iou_similarity", doc="iou_similarity_op.cc: [N, M] IoU")
def _iou_similarity(ctx):
    ctx.set_output("Out", _iou(ctx.input("X"), ctx.input("Y")).float())


@register_op("bipartite_match",
             doc="bipartite_match_op.cc: greedy, min(N, M) global maxima; "
                 "then the per_prediction fill")
def _bipartite_match(ctx):
    dist = ctx.input("DistMat").float()        # [N_gt, M_prior]
    N, M = dist.shape
    dev = dist.device
    rows = torch.arange(N, device=dev)
    cols = torch.arange(M, device=dev)
    midx = torch.full((M,), -1, dtype=torch.int32, device=dev)
    mdist = torch.zeros(M, dtype=torch.float32, device=dev)
    d = dist
    for _ in range(min(N, M)):
        flat = torch.argmax(d)                 # the first maximum
        i, j = flat // M, flat % M
        val = d.reshape(-1)[flat]
        hit = (val > 0) & (cols == j)          # [M]: prior j, if matched
        midx = torch.where(hit, i.to(torch.int32), midx)
        mdist = torch.where(hit, val, mdist)
        crossed = (rows == i)[:, None] | (cols == j)[None, :]
        d = torch.where((val > 0) & crossed, torch.full_like(d, -1.0), d)
    if ctx.attr("match_type", "bipartite") == "per_prediction":
        thr = ctx.attr("dist_threshold", 0.5)
        best_val, best_gt = torch.max(dist, dim=0)
        extra = (midx < 0) & (best_val >= thr)
        midx = torch.where(extra, best_gt.to(torch.int32), midx)
        mdist = torch.where(extra, best_val, mdist)
    ctx.set_output("ColToRowMatchIndices", midx[None, :])
    ctx.set_output("ColToRowMatchDist", mdist[None, :])


@register_op("target_assign",
             doc="target_assign_op.cc: each prior's matched row of X (X's "
                 "dtype), mismatch_value where unmatched; Out [1, M, D]")
def _target_assign(ctx):
    x = ctx.input("X")                    # [N_gt, D]
    m = ctx.input("MatchIndices").reshape(-1).long()    # [M]
    safe = torch.clamp(m, 0, x.shape[0] - 1)
    out = x[safe]
    out = torch.where((m >= 0)[:, None], out,
                      torch.full_like(out, ctx.attr("mismatch_value", 0)))
    wt = (m >= 0).float()[:, None]
    ctx.set_output("Out", out[None])
    ctx.set_output("OutWeight", wt[None])


@register_op("mine_hard_examples",
             doc="mine_hard_examples_op.cc: the top neg_pos_ratio x "
                 "positives negatives by loss, as a [B, M] mask")
def _mine_hard_examples(ctx):
    cls_loss = ctx.input("ClsLoss")       # [B, M]
    match = ctx.input("MatchIndices")     # [B, M]
    neg_pos_ratio = ctx.attr("neg_pos_ratio", 3.0)
    loss = cls_loss
    loc = ctx.input("LocLoss")
    if loc is not None and ctx.attr("mining_type",
                                    "max_negative") != "max_negative":
        loss = loss + loc
    is_neg = match < 0
    num_pos = torch.sum(match >= 0, dim=1)
    num_neg = torch.minimum((num_pos * neg_pos_ratio).to(torch.int32),
                            torch.sum(is_neg, dim=1).to(torch.int32))
    neg_loss = torch.where(is_neg, loss, torch.full_like(loss, -torch.inf))
    # the rank of each prior in a stable ascending sort of -loss
    order = torch.argsort(-neg_loss, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    selected = (rank < num_neg[:, None]) & is_neg
    ctx.set_output("NegIndices", selected.to(torch.int32))
    ctx.set_output("UpdatedMatchIndices",
                   torch.where(selected, torch.full_like(match, -1), match))


@register_op("multiclass_nms",
             doc="multiclass_nms_op.cc: Out [B, keep_top_k, 6] rows (label, "
                 "score, x1, y1, x2, y2), label -1 in empty rows")
def _multiclass_nms(ctx):
    boxes = ctx.input("BBoxes")           # [B, M, 4]
    scores = ctx.input("Scores")          # [B, C, M]
    bg = ctx.attr("background_label", 0)
    score_thr = ctx.attr("score_threshold", 0.01)
    nms_thr = ctx.attr("nms_threshold", 0.3)
    keep_top_k = ctx.attr("keep_top_k", 20)
    B, C, M = scores.shape
    k = min(ctx.attr("nms_top_k", 64), M)
    dev = scores.device
    classes = [c for c in range(C) if c != bg]
    nc = len(classes)
    # each class's top k candidates: [B, C', k] scores, [B, C', k, 4] boxes
    cls_scores = scores[:, classes]
    idx = _desc_order(cls_scores)[..., :k]
    s = torch.gather(cls_scores, 2, idx)
    bx = torch.gather(boxes[:, None].expand(B, nc, M, 4), 2,
                      idx[..., None].expand(B, nc, k, 4))
    keep = s > score_thr
    ar = torch.arange(k, device=dev)
    # candidate j may be suppressed by an earlier candidate i that is kept
    cand = (_iou(bx, bx) > nms_thr) & (ar[None, :] > ar[:, None])
    for i in range(k):
        keep = keep & ~(cand[..., i, :] & keep[..., i:i + 1])
    s = torch.where(keep, s, torch.full_like(s, -1.0)).reshape(B, nc * k)
    bx = bx.reshape(B, nc * k, 4)
    labels = torch.tensor(classes, dtype=s.dtype, device=dev
                          ).repeat_interleave(k)
    kk = min(keep_top_k, nc * k)
    top_i = _desc_order(s)[:, :kk]
    top_s = torch.gather(s, 1, top_i)
    rows = torch.cat(
        [torch.where(top_s > 0, labels[top_i],
                     torch.full_like(top_s, -1.0))[..., None],
         top_s[..., None],
         torch.gather(bx, 1, top_i[..., None].expand(B, kk, 4))], dim=2)
    ctx.set_output("Out", rows)


@register_op("detection_map",
             doc="detection_map_op.cc: the 11-point VOC mAP of one batch, "
                 "from GTBoxes + GTLabels or v1 [label, box, difficult] "
                 "rows")
def _detection_map(ctx):
    det = ctx.input("DetectRes")          # [B, K, 6]
    gt_boxes = ctx.input("GTBoxes")
    gt_labels = ctx.input("GTLabels")
    background = ctx.attr("background_label", 0)
    eval_difficult = ctx.attr("evaluate_difficult", True)
    difficult = None
    if gt_labels is None:
        gt_labels = gt_boxes[..., 0]
        if gt_boxes.shape[-1] >= 6:
            difficult = gt_boxes[..., 5]
        gt_boxes = gt_boxes[..., 1:5]
    overlap_thr = ctx.attr("overlap_threshold", 0.5)
    gt_valid = (gt_labels != background) & (gt_labels >= 0)
    if difficult is not None and not eval_difficult:
        gt_valid = gt_valid & (difficult == 0)

    labels, scores, boxes = det[..., 0], det[..., 1], det[..., 2:6]
    iou = _iou(boxes, gt_boxes)                          # [B, K, G]
    same_cls = labels[..., :, None] == gt_labels[..., None, :].to(
        labels.dtype)
    det_ok = (labels >= 0) & (labels != background)
    ok = ((iou > overlap_thr) & same_cls & gt_valid[..., None, :]
          & det_ok[..., :, None])
    valid_det = det_ok.float()
    tp = torch.any(ok, dim=2).float() * valid_det
    npos = torch.sum(gt_valid, dim=1)
    order = torch.argsort(-scores, dim=1, stable=True)
    ctp = torch.cumsum(torch.gather(tp, 1, order), dim=1)
    cdet = torch.cumsum(torch.gather(valid_det, 1, order), dim=1)
    recall = ctp / torch.clamp(npos, min=1)[:, None]
    precision = ctp / torch.clamp(cdet, min=1)
    # the 11 recall points as jnp.linspace(0, 1, 11) gives them in f32
    pts = torch.arange(11, dtype=torch.float32, device=det.device) * 0.1
    best = torch.where(recall[:, None, :] >= pts[None, :, None],
                       precision[:, None, :], torch.zeros_like(
                           precision[:, None, :])).amax(dim=2)   # [B, 11]
    aps = best.mean(dim=1)
    ctx.set_output("MAP", aps.mean())
    ctx.set_output("AccumPosCount", torch.sum(gt_valid).to(torch.int32))


@register_op("gather_encoded_target",
             doc="pick each prior's matched gt's encoded offsets")
def _gather_encoded_target(ctx):
    enc = ctx.input("Encoded")            # [G, M, 4]
    match = ctx.input("MatchIndices").reshape(-1).long()    # [M]
    M = match.shape[0]
    safe = torch.clamp(match, 0, enc.shape[0] - 1)
    picked = enc[safe, torch.arange(M, device=enc.device)]  # [M, 4]
    wt = (match >= 0).float()[:, None]
    ctx.set_output("Out", picked * wt)
    ctx.set_output("OutWeight", wt)


@register_op("abs_smooth_l1", doc="0.5 x^2 where |x| < 1, else |x| - 0.5")
def _abs_smooth_l1(ctx):
    x = ctx.input("X").float()
    ax = torch.abs(x)
    ctx.set_output("Out", torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5))
