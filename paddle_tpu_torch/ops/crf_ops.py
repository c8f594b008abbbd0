"""Structured-prediction op rules (counterpart of
``paddle_tpu/ops/crf_ops.py``): the linear-chain CRF and its Viterbi
decoding, edit distance, chunk evaluation, CTC loss and alignment, NCE
and the hierarchical sigmoid.

All run on padded [B, T, ...] batches with length masks.  The JAX rules'
``lax.scan`` recursions over time become loops over T in torch (the CRF
forward in log space, Viterbi, the edit-distance rows, the CTC alpha
recursion).  The CTC loss is ``optax.ctc_loss``'s recursion written in
torch: ``F.ctc_loss`` after a log-softmax gives other gradients than
optax's.  ``nce`` draws its negative samples from
the executor's generator (threefry's draws never match torch's: hold it
by statistics, or read the samples back through an optional
``SampleLabels`` output).
"""
from __future__ import annotations

import math

import torch

from ..core.registry import register_op
from .sequence_ops import _compact, _time_mask


def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0) (no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _valid_steps(lens, t, b, device):
    """[T-1, B] bool: step 1..T-1 lies inside the row's length."""
    if lens is None:
        return torch.ones((t - 1, b), dtype=torch.bool, device=device)
    return torch.arange(1, t, device=device)[:, None] < lens[None, :]


# ---------------------------------------------------------------------------
# linear-chain CRF (Transition rows: 0 start, 1 end, 2.. the pairs)
# ---------------------------------------------------------------------------

def _crf_log_z(emission, lens, start, end, trans):
    b, t, _ = emission.shape
    alpha = start[None, :] + emission[:, 0]
    valid = _valid_steps(lens, t, b, emission.device)
    for i in range(1, t):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + emission[:, i]
        alpha = torch.where(valid[i - 1][:, None], nxt, alpha)
    return torch.logsumexp(alpha + end[None, :], dim=1)


def _crf_score(emission, label, lens, start, end, trans):
    b, t, _ = emission.shape
    lab = label.long()
    mask = (_time_mask(lens, t) if lens is not None
            else torch.ones((b, t), device=emission.device))
    emit = (emission.gather(2, lab[..., None])[..., 0] * mask).sum(dim=1)
    pair = trans[lab[:, :-1], lab[:, 1:]]
    trans_score = (pair * mask[:, 1:]).sum(dim=1)
    n = (lens if lens is not None
         else torch.full((b,), t, device=emission.device))
    last = lab.gather(1, (n.long() - 1).clamp(0, t - 1)[:, None])[:, 0]
    return emit + trans_score + start[lab[:, 0]] + end[last]


@register_op("linear_chain_crf")
def _linear_chain_crf(ctx):
    emission = ctx.input("Emission").float()     # [B, T, C]
    transition = ctx.input("Transition").float()
    label = ctx.input("Label")
    if label.dim() == 3:
        label = label[..., 0]
    lens = ctx.seq_len_of("Emission")
    if lens is None:
        lens = ctx.seq_len_of("Label")
    start, end, trans = transition[0], transition[1], transition[2:]
    ll = (_crf_score(emission, label, lens, start, end, trans)
          - _crf_log_z(emission, lens, start, end, trans))[:, None]
    # the log-likelihood itself (the layer negates it), as the JAX rule
    ctx.set_output("LogLikelihood", ll)
    ctx.set_output("EmissionExps", torch.exp(emission))
    ctx.set_output("TransitionExps", torch.exp(transition))
    ctx.set_output("Alpha", emission)


@register_op("crf_decoding")
def _crf_decoding(ctx):
    emission = ctx.input("Emission").float()
    transition = ctx.input("Transition").float()
    lens = ctx.seq_len_of("Emission")
    start, end, trans = transition[0], transition[1], transition[2:]
    b, t, c = emission.shape
    dev = emission.device
    valid = _valid_steps(lens, t, b, dev)
    states = torch.arange(c, device=dev)[None, :].expand(b, c)
    delta = start[None, :] + emission[:, 0]
    ptrs = []
    for i in range(1, t):
        scores = delta[:, :, None] + trans[None]          # [B, C, C]
        best, ptr = scores.max(dim=1)
        v = valid[i - 1][:, None]
        delta = torch.where(v, best + emission[:, i], delta)
        ptrs.append(torch.where(v, ptr, states))
    cur = torch.argmax(delta + end[None, :], dim=1)
    path = [cur]
    for ptr in reversed(ptrs):
        cur = ptr.gather(1, cur[:, None])[:, 0]
        path.append(cur)
    path = torch.stack(path[::-1], dim=1).to(torch.int32)   # [B, T]
    if lens is not None:
        path = path * _time_mask(lens, t, torch.int32)
    label = ctx.input("Label")
    if label is not None:
        # 1 marks a correct prediction (crf_decoding_op.h)
        if label.dim() == 3:
            label = label[..., 0]
        path = (path == label.to(path.dtype)).to(torch.int32)
    ctx.set_output("ViterbiPath", path)
    ctx.set_seq_len("ViterbiPath", lens)


# ---------------------------------------------------------------------------
# edit distance (Levenshtein over padded int sequences)
# ---------------------------------------------------------------------------

@register_op("edit_distance")
def _edit_distance(ctx):
    hyp = ctx.input("Hyps").long()
    ref = ctx.input("Refs").long()
    if hyp.dim() == 3:
        hyp = hyp[..., 0]
    if ref.dim() == 3:
        ref = ref[..., 0]
    b, th = hyp.shape
    tr = ref.shape[1]
    dev = hyp.device
    hlens, rlens = ctx.seq_len_of("Hyps"), ctx.seq_len_of("Refs")
    if hlens is None:
        hlens = torch.full((b,), th, dtype=torch.int32, device=dev)
    if rlens is None:
        rlens = torch.full((b,), tr, dtype=torch.int32, device=dev)
    # the distances of each hypothesis prefix to every reference prefix
    row = torch.arange(tr + 1, device=dev, dtype=torch.float32)[None, :] \
        .expand(b, tr + 1)
    cols = torch.arange(tr, device=dev, dtype=torch.float32)[None, :]
    for i in range(th):
        sub = (ref != hyp[:, i:i + 1]).float()
        cand = torch.minimum(row[:, :-1] + sub, row[:, 1:] + 1.0)
        first = row[:, :1] + 1.0
        # the insertion chain cur_j = min(cand_j, cur_{j-1} + 1) in closed
        # form: j + min(first + 1, cummin_k<=j(cand_k - k))
        chain = cols + torch.minimum(
            first + 1.0, torch.cummin(cand - cols, dim=1).values)
        new_row = torch.cat([first, chain], dim=1)
        row = torch.where((i < hlens)[:, None], new_row, row)
    dist = row.gather(1, rlens.long()[:, None])[:, 0]
    if ctx.attr("normalized", False):
        dist = dist / torch.clamp(rlens.float(), min=1.0)
    ctx.set_output("Out", dist[:, None])
    ctx.set_output("SequenceNum", torch.tensor(b, dtype=torch.int32,
                                               device=dev))


# ---------------------------------------------------------------------------
# chunk evaluation (chunk_eval_op.cc)
# ---------------------------------------------------------------------------

_SCHEME_TAGS = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}


def _shift_right(x, fill):
    """x [B, T] moved one step later along T, ``fill`` at step 0."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def _extract_chunks(tags, lens, num_chunk_types, scheme, excluded):
    """tags [B, T] -> (chunk type, chunk starts, the index one past the
    chunk that starts at t), chunk_eval_op.h's ChunkScheme on a batch."""
    scheme_tags = _SCHEME_TAGS[scheme]
    b, t = tags.shape
    pos = torch.arange(t, device=tags.device)[None, :].expand(b, t)
    ctype = tags // scheme_tags
    sub = tags % scheme_tags
    in_chunk = (ctype < num_chunk_types) & (pos < lens[:, None])
    for ex in excluded:
        in_chunk = in_chunk & (ctype != ex)
    type_break = (~_shift_right(in_chunk, False)
                  | (_shift_right(ctype, -1) != ctype))
    prev_sub = _shift_right(sub, -1)
    if scheme == "IOB":          # sub 0 = B, 1 = I
        start = ((sub == 0) | type_break) & in_chunk
    elif scheme == "IOE":        # sub 0 = I, 1 = E
        prev_end = (prev_sub == 1)
        prev_end[:, 0] = True
        start = (type_break | prev_end) & in_chunk
    elif scheme == "IOBES":      # sub 0 = B, 1 = I, 2 = E, 3 = S
        prev_closed = (prev_sub == 2) | (prev_sub == 3)
        prev_closed[:, 0] = True
        start = (((sub == 0) | (sub == 3) | type_break | prev_closed)
                 & in_chunk)
    else:                        # plain: each maximal same-type run
        start = type_break & in_chunk
    # the first boundary after t (a start, or outside a chunk), else T
    bound = torch.where(start | ~in_chunk, pos, torch.full_like(pos, t))
    after = torch.cat([bound[:, 1:], torch.full_like(bound[:, :1], t)],
                      dim=1)
    next_bound = torch.flip(torch.cummin(torch.flip(after, [1]), dim=1)
                            .values, [1])
    return ctype, start, next_bound


@register_op("chunk_eval")
def _chunk_eval(ctx):
    inference = ctx.input("Inference")
    label = ctx.input("Label")
    if inference.dim() == 3:
        inference = inference[..., 0]
    if label.dim() == 3:
        label = label[..., 0]
    lens = ctx.seq_len_of("Inference")
    if lens is None:
        lens = ctx.seq_len_of("Label")
    b, t = inference.shape
    if lens is None:
        lens = torch.full((b,), t, dtype=torch.int32,
                          device=inference.device)
    args = (ctx.attr("num_chunk_types"), ctx.attr("chunk_scheme", "IOB"),
            tuple(ctx.attr("excluded_chunk_types", []) or []))
    it, istart, iend = _extract_chunks(inference.long(), lens, *args)
    lt, lstart, lend = _extract_chunks(label.long(), lens, *args)
    match = istart & lstart & (it == lt) & (iend == lend)
    n_inf, n_lab, n_cor = (v.sum().to(torch.int32)
                           for v in (istart, lstart, match))
    ni, nl, nc = n_inf.float(), n_lab.float(), n_cor.float()
    precision = nc / torch.clamp(ni, min=1)
    recall = nc / torch.clamp(nl, min=1)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-6)
    ctx.set_output("Precision", precision)
    ctx.set_output("Recall", recall)
    ctx.set_output("F1-Score", f1)
    ctx.set_output("NumInferChunks", n_inf)
    ctx.set_output("NumLabelChunks", n_lab)
    ctx.set_output("NumCorrectChunks", n_cor)


# ---------------------------------------------------------------------------
# CTC (warpctc_op.cc, ctc_align_op.cc)
# ---------------------------------------------------------------------------

#: optax.ctc_loss's log(0)
_LOG_EPS = -1e5


def _ctc_nll(logp, label, in_lens, lab_lens, blank):
    """-log p(label | logits) by the log-space alpha recursion over the
    blank-interleaved label (optax.ctc_loss's, log(0) = -1e5): logp
    [B, T, C] log-softmax, label [B, L] -> [B]."""
    b, t, _ = logp.shape
    n = label.shape[1]
    dev = logp.device
    ext = torch.full((b, 2 * n + 1), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = label
    # a label state may be entered from the previous label's state (over
    # the blank between) unless the two labels are equal; a label equal
    # to the blank id is still a label state, as in optax
    skip = torch.zeros_like(ext, dtype=torch.bool)
    skip[:, 3::2] = label[:, 1:] != label[:, :-1]
    eps = torch.full((b, 1), _LOG_EPS, device=dev)
    emit = logp.gather(2, ext[:, None, :].expand(b, t, ext.shape[1]))
    alpha = torch.full_like(emit[:, 0], _LOG_EPS)
    alpha[:, :2] = emit[:, 0, :2]
    for i in range(1, t):
        prev1 = torch.cat([eps, alpha[:, :-1]], dim=1)
        prev2 = torch.cat([eps, eps, alpha[:, :-2]], dim=1)
        prev2 = torch.where(skip, prev2, torch.full_like(prev2, _LOG_EPS))
        nxt = torch.logsumexp(torch.stack([alpha, prev1, prev2]), dim=0) \
            + emit[:, i]
        alpha = torch.where((i < in_lens)[:, None], nxt, alpha)
    last = 2 * lab_lens
    ends = torch.stack([alpha.gather(1, last[:, None])[:, 0],
                        alpha.gather(1, (last - 1).clamp(min=0)[:, None])[:, 0]])
    ends[1] = torch.where(lab_lens > 0, ends[1],
                          torch.full_like(ends[1], _LOG_EPS))
    return -torch.logsumexp(ends, dim=0)


@register_op("warpctc")
def _warpctc(ctx):
    logits = ctx.input("Logits").float()        # [B, T, C + 1]
    label = ctx.input("Label").long()           # [B, L]
    if label.dim() == 3:
        label = label[..., 0]
    b, t, _ = logits.shape
    dev = logits.device
    llens = ctx.seq_len_of("Logits")
    lablens = ctx.seq_len_of("Label")
    in_lens = (llens.long() if llens is not None
               else torch.full((b,), t, dtype=torch.long, device=dev))
    lab_lens = (lablens.long() if lablens is not None
                else torch.full((b,), label.shape[1], dtype=torch.long,
                                device=dev))
    loss = _ctc_nll(torch.log_softmax(logits, dim=-1), label, in_lens,
                    lab_lens, ctx.attr("blank", 0))
    if ctx.attr("norm_by_times", False):
        # warpctc_op.cc scales the GRADIENT by 1/T; the value stays
        scaled = loss / torch.clamp(in_lens.float(), min=1.0)
        loss = scaled + (loss - scaled).detach()
    ctx.set_output("Loss", loss[:, None])
    ctx.set_output("WarpCTCGrad", torch.zeros_like(logits))


@register_op("ctc_align", doc="collapse repeats and strip blanks")
def _ctc_align(ctx):
    x = ctx.input("Input").to(torch.int32)      # [B, T]
    if x.dim() == 3:
        x = x[..., 0]
    lens = ctx.seq_len_of("Input")
    prev = _shift_right(x, -1)
    keep = (x != ctx.attr("blank", 0)) & (x != prev)
    if lens is not None:
        keep = keep & (torch.arange(x.shape[1], device=x.device)[None, :]
                       < lens[:, None])
    out, new_lens = _compact(x, keep)
    ctx.set_output("Output", out)
    ctx.set_seq_len("Output", new_lens)


# ---------------------------------------------------------------------------
# sampled and tree-structured softmax losses
# ---------------------------------------------------------------------------

@register_op("nce", doc="nce_op.cc: noise-contrastive estimation, uniform "
             "negative samples", draws_rng=True)
def _nce(ctx):
    x = ctx.input("Input")                      # [B, D]
    label = ctx.input("Label").long()
    if label.dim() == 2:
        label = label[:, 0]
    w = ctx.input("Weight")                     # [C, D]
    bias = ctx.input("Bias")                    # [C, 1] or None
    num_classes = ctx.attr("num_total_classes")
    num_neg = ctx.attr("num_neg_samples", 10)
    neg = torch.randint(0, num_classes, (x.shape[0], num_neg),
                        generator=ctx.next_rng(), device=x.device)

    def logit(ids):
        out = (w[ids] * (x[:, None, :] if ids.dim() == 2 else x)).sum(-1)
        if bias is not None:
            out = out + bias[:, 0][ids]
        return out

    # a logistic loss against the noise prior q = num_neg / num_classes
    log_q = math.log(num_neg / num_classes)
    cost = (_softplus(-(logit(label) - log_q))
            + _softplus(logit(neg) - log_q).sum(dim=1))
    ctx.set_output("Cost", cost[:, None])
    ctx.set_output("SampleLabels", neg)


@register_op("hsigmoid",
             doc="hierarchical_sigmoid_op.cc: complete-binary-tree "
                 "hierarchical softmax (code = label + num_classes; bit j "
                 "of the path picks the child)")
def _hsigmoid(ctx):
    x = ctx.input("X")                          # [B, D]
    w = ctx.input("W")                          # [num_classes - 1, D]
    bias = ctx.input("Bias")                    # [num_classes - 1, 1]
    label = ctx.input("Label").long().reshape(-1)
    num_classes = ctx.attr("num_classes")
    max_len = max(1, int(math.ceil(math.log2(num_classes))))
    code = label + num_classes
    lengths = torch.floor(torch.log2(code.float())).long()
    j = torch.arange(max_len, device=x.device)[None, :]
    valid = j < lengths[:, None]
    shift = torch.clamp(lengths[:, None] - j, min=0)
    idx = torch.clamp((code[:, None] >> shift) - 1, 0, num_classes - 2)
    bit = (code[:, None] >> torch.clamp(shift - 1, min=0)) & 1
    wx = torch.einsum("bd,bld->bl", x.float(), w[idx].float())
    if bias is not None:
        wx = wx + bias.reshape(-1)[idx]
    per = _softplus(wx) - bit.float() * wx
    cost = torch.where(valid, per, torch.zeros_like(per)).sum(
        dim=1, keepdim=True)
    ctx.set_output("Out", cost.to(x.dtype))
