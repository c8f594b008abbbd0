"""Comparison and logical op rules and the in-graph metric ops
(counterpart of ``paddle_tpu/ops/logic_ops.py``): the comparisons and
logicals give bool tensors; ``accuracy``, ``auc`` (streaming ROC-AUC over
persistent bucket counters) and ``precision_recall``."""
from __future__ import annotations

import torch

from ..core.registry import register_op

#: comparison and binary logical op type -> function
COMPARISONS = {
    "less_than": torch.lt,
    "less_equal": torch.le,
    "greater_than": torch.gt,
    "greater_equal": torch.ge,
    "equal": torch.eq,
    "not_equal": torch.ne,
    "logical_and": torch.logical_and,
    "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
}


def _binary_rule(fn):
    def rule(ctx):
        ctx.set_output("Out", fn(ctx.input("X"), ctx.input("Y")))
    return rule


for _name, _fn in COMPARISONS.items():
    register_op(_name)(_binary_rule(_fn))


@register_op("logical_not")
def _logical_not(ctx):
    ctx.set_output("Out", torch.logical_not(ctx.input("X")))


@register_op("accuracy", doc="accuracy_op.cc: top-k accuracy from Indices")
def _accuracy(ctx):
    indices = ctx.input("Indices")       # [N, k] from top_k
    label = ctx.input("Label")           # [N, 1]
    n = indices.shape[0]
    correct = (indices == label.to(indices.dtype)).any(dim=1)
    num_correct = correct.sum(dtype=torch.int32)
    ctx.set_output("Accuracy", num_correct.float() / n)
    ctx.set_output("Correct", num_correct)
    ctx.set_output("Total", torch.tensor(n, dtype=torch.int32,
                                         device=ctx.device))


@register_op("auc", doc="auc_op.cc: streaming ROC-AUC over stat buffers")
def _auc(ctx):
    """Counts of the batch's positives and negatives above each of the
    ``num_thresholds`` thresholds (k + 1) / (T + 1) are added to the TP,
    FP, TN and FN counters (persistable state the op updates), and the
    AUC is the trapezoid over the accumulated ROC curve."""
    probs = ctx.input("Predict")         # [N, 2] binary probabilities
    label = ctx.input("Label").reshape(-1)
    tp, fp = ctx.input("TP"), ctx.input("FP")
    tn, fn_ = ctx.input("TN"), ctx.input("FN")
    num_thresh = tp.shape[0]
    thresholds = ((torch.arange(num_thresh, device=ctx.device) + 1)
                  / (num_thresh + 1))
    pos = probs[:, 1][None, :] > thresholds[:, None]        # [T, N]
    is_pos = (label > 0)[None, :]
    tp_new = tp + (pos & is_pos).sum(dim=1).to(tp.dtype)
    fp_new = fp + (pos & ~is_pos).sum(dim=1).to(fp.dtype)
    tn_new = tn + (~pos & ~is_pos).sum(dim=1).to(tn.dtype)
    fn_new = fn_ + (~pos & is_pos).sum(dim=1).to(fn_.dtype)
    tpr = tp_new / torch.clamp(tp_new + fn_new, min=1)
    fpr = fp_new / torch.clamp(fp_new + tn_new, min=1)
    # trapezoid over descending thresholds
    auc = torch.sum((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0)
    ctx.set_output("AUC", torch.abs(auc))
    ctx.set_output("TPOut", tp_new)
    ctx.set_output("FPOut", fp_new)
    ctx.set_output("TNOut", tn_new)
    ctx.set_output("FNOut", fn_new)


def _pr_metrics(s: torch.Tensor) -> torch.Tensor:
    """[C, 4] TP FP TN FN counts -> macro then micro precision, recall
    and F1 (6 values)."""
    tp, fp, fn_ = s[:, 0], s[:, 1], s[:, 3]
    prec = tp / torch.clamp(tp + fp, min=1)
    rec = tp / torch.clamp(tp + fn_, min=1)
    f1 = 2 * prec * rec / torch.clamp(prec + rec, min=1e-6)
    macro = torch.stack([prec.mean(), rec.mean(), f1.mean()])
    tps, fps, fns = tp.sum(), fp.sum(), fn_.sum()
    mprec = tps / torch.clamp(tps + fps, min=1)
    mrec = tps / torch.clamp(tps + fns, min=1)
    micro = torch.stack([mprec, mrec, 2 * mprec * mrec
                         / torch.clamp(mprec + mrec, min=1e-6)])
    return torch.cat([macro, micro])


@register_op("precision_recall", doc="precision_recall_op.cc (macro/micro)")
def _precision_recall(ctx):
    indices = ctx.input("Indices").reshape(-1)
    labels = ctx.input("Labels").reshape(-1)
    states = ctx.input("StatesInfo")      # [C, 4]: TP FP TN FN
    ncls = states.shape[0]
    cls = torch.arange(ncls, device=ctx.device)[:, None]
    pred, lab = indices.long()[None] == cls, labels.long()[None] == cls
    tp = (pred & lab).sum(dim=1)
    fp = (pred & ~lab).sum(dim=1)
    fn_ = (~pred & lab).sum(dim=1)
    tn = labels.shape[0] - tp - fp - fn_
    batch = torch.stack([tp, fp, tn, fn_], dim=1).to(states.dtype)
    acc = states + batch
    ctx.set_output("BatchMetrics", _pr_metrics(batch))
    ctx.set_output("AccumMetrics", _pr_metrics(acc))
    ctx.set_output("AccumStatesInfo", acc)
