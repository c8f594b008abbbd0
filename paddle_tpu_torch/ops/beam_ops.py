"""Beam search op rules (counterpart of ``paddle_tpu/ops/beam_ops.py``).

The beam is a flattened [batch*beam] axis with static shapes: one
``beam_search`` op accumulates log-probabilities, keeps the top ``beam``
continuations of each sample and records their parent rows, and
``beam_search_decode`` backtraces the stacked (ids, parents) into
sentences.

Top-k ties.  ``lax.top_k`` breaks ties toward the lower flat index, and
ties are common here: the first step's ``beam_init_scores`` rows (-1e9),
finished beams that force ``end_id``, probabilities clamped at 1e-20.
``torch.topk`` on CUDA promises no order among equal values, so the rule
takes the first ``beam`` of a stable descending sort: equal scores keep
their flat order, the lower index first, on the CPU and on the card.

``cross_entropy_over_beam`` builds its paths on the host, as the
reference does (its layer is pinned to the CPU): the JAX package's numpy
core, copied here, runs inside a ``torch.autograd.Function`` whose
backward is the JAX custom VJP's (the forward's per-row gradients scaled
by each sequence's cotangent).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.lowering import LEN_SUFFIX
from ..core.registry import register_op

NEG_INF = -1e9


def stable_top_k(x: torch.Tensor, k: int):
    """The ``k`` largest entries of each row of ``x`` and their indices,
    ties toward the lower index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register_op("beam_search")
def _beam_search(ctx):
    """One pruning step.  PreScores [Bb, 1] cumulative log-probs, Probs
    [Bb, V], PreFinished [Bb, 1] 0/1 -> SelectedIds [Bb, 1] int64,
    SelectedScores [Bb, 1], ParentIdx [Bb] int32 (absolute rows to
    reorder the decoder state with), Finished [Bb, 1]."""
    pre_scores = ctx.input("PreScores").reshape(-1).float()
    probs = ctx.input("Probs")
    finished = ctx.input("PreFinished")
    beam = ctx.attr("beam_size")
    end_id = ctx.attr("end_id", 1)
    bb, v = probs.shape
    b = bb // beam
    dev = probs.device
    finished = (torch.zeros((bb,), device=dev) if finished is None
                else finished.reshape(-1).float())
    logp = torch.log(torch.clamp(probs.float(), min=1e-20))
    # a finished beam continues with end_id at an unchanged score
    col = torch.arange(v, device=dev)[None, :]
    end_row = torch.where(col == end_id, torch.zeros((), device=dev),
                          torch.full((), NEG_INF, device=dev))
    logp = torch.where(finished[:, None] > 0, end_row, logp)
    total = pre_scores[:, None] + logp
    top_scores, top_idx = stable_top_k(total.reshape(b, beam * v), beam)
    token = top_idx % v
    parent = (top_idx // v + (torch.arange(b, device=dev)
                              * beam)[:, None]).to(torch.int32)
    new_finished = ((finished[parent.reshape(-1).long()] > 0)
                    | (token.reshape(-1) == end_id))
    ctx.set_output("SelectedIds", token.reshape(bb, 1))
    ctx.set_output("SelectedScores", top_scores.reshape(bb, 1))
    ctx.set_output("ParentIdx", parent.reshape(bb))
    ctx.set_output("Finished", new_finished.float().reshape(bb, 1))


@register_op("beam_search_decode")
def _beam_search_decode(ctx):
    """Backtrace the stacked steps: Ids [Bb, T(, 1)], Parents [Bb, T],
    Scores [Bb, 1] -> SentenceIds [Bb, T] (beam-major), SentenceScores;
    ``num_results`` < ``beam_size`` keeps each sample's best rows."""
    ids = ctx.input("Ids")
    if ids.dim() == 3:
        ids = ids[..., 0]
    parents = ctx.input("Parents").long()
    scores = ctx.input("Scores")
    bb, t = ids.shape
    cursor = torch.arange(bb, device=ids.device)
    toks = [None] * t
    for step in range(t - 1, -1, -1):
        toks[step] = ids[:, step][cursor]
        cursor = parents[:, step][cursor]
    sent = torch.stack(toks, dim=1)
    beam, k = ctx.attr("beam_size", 0), ctx.attr("num_results", 0)
    if beam and k and k < beam:
        # each step's top-k lists a sample's beams best first
        rows = torch.arange(bb, device=ids.device).reshape(-1, beam)[
            :, :k].reshape(-1)
        sent, scores = sent[rows], scores[rows]
    ctx.set_output("SentenceIds", sent)
    ctx.set_output("SentenceScores", scores)


@register_op("repeat_batch", doc="repeat each batch row `times` times "
             "(the beam expansion of the encoder's state)")
def _repeat_batch(ctx):
    times = ctx.attr("times")
    ctx.set_output("Out", torch.repeat_interleave(ctx.input("X"), times,
                                                  dim=0))
    lens = ctx.seq_len_of("X")
    if lens is not None:
        ctx.set_seq_len("Out", torch.repeat_interleave(lens, times, dim=0))


@register_op("beam_init_scores", doc="0 for each sample's beam 0, -1e9 for "
             "the rest")
def _beam_init_scores(ctx):
    bb = ctx.input("Ref").shape[0]
    beam = ctx.attr("beam_size")
    row = torch.arange(bb, device=ctx.device)
    ctx.set_output("Out", torch.where(
        row % beam == 0, torch.zeros((), device=ctx.device),
        torch.full((), NEG_INF, device=ctx.device)).reshape(bb, 1))


# ---------------------------------------------------------------------------
# cross_entropy_over_beam (the learning-to-search beam-training cost)
# ---------------------------------------------------------------------------
# E beam expansions, each a triple (candidate scores as a nested
# sequence, kmax-selected candidate ids padded with -1, gold index).  The
# gold is tracked through the expansions; every candidate path of the
# last expansion the gold survived to is expanded (the gold appended as
# an extra path if it fell off the beam), each path scored by the sum of
# its candidates' scores, and the cost is -log softmax over the paths at
# the gold path.  The numpy core is the JAX package's.

def _ceob_one_seq(beam, scores_c, starts_c, ids_l, golds):
    """Cost and score gradients of ONE sequence: scores_c[i] the 1-D
    concatenated valid scores of its rows in expansion i, starts_c[i] the
    rows' offsets into it, ids_l[i] [rows_i, beam] selected ids (-1
    unused), golds[i] the gold's index in the gold row.  Row r of
    expansion i descends from the r-th non-(-1) slot of expansion i-1.
    Returns (cost, gradients, expansions used)."""
    n_exp = len(ids_l)
    gold_row = [0] * n_exp
    gold_col = [-1] * n_exp
    valid = 0
    for i in range(n_exp):
        if i:
            upto = gold_row[i - 1] * beam + gold_col[i - 1]
            gold_row[i] = int((ids_l[i - 1].ravel()[:upto] != -1).sum())
        valid += 1
        hit = np.nonzero(ids_l[i][gold_row[i]] == golds[i])[0]
        if hit.size == 0:
            break
        gold_col[i] = int(hit[0])
    gold_extra = gold_col[valid - 1] == -1

    b = valid - 1
    flat_ids = ids_l[b].ravel()
    keep = flat_ids != -1
    rows_idx = np.repeat(np.arange(ids_l[b].shape[0]), beam)[keep]
    n_real = int(keep.sum())
    n_paths = n_real + (1 if gold_extra else 0)
    path_rows = [np.empty(n_paths, int) for _ in range(valid)]
    path_rows[b][:n_real] = flat_ids[keep].astype(int) + starts_c[b][rows_idx]
    parent = rows_idx
    if gold_extra:
        path_rows[b][-1] = golds[b] + starts_c[b][gold_row[b]]
        gold_path = n_paths - 1
    else:
        gold_off = gold_row[b] * beam + gold_col[b]
        gold_path = int((flat_ids[:gold_off] != -1).sum())
    for i in range(b - 1, -1, -1):
        flat_prev = ids_l[i].ravel()
        slot = np.flatnonzero(flat_prev != -1)[parent]
        cand = flat_prev[slot].astype(int)
        prow = slot // beam
        path_rows[i][:n_real] = cand + starts_c[i][prow]
        if gold_extra:
            path_rows[i][-1] = golds[i] + starts_c[i][gold_row[i]]
        parent = prow

    total = np.zeros(n_paths, np.float64)
    for i in range(valid):
        total += scores_c[i][path_rows[i]]
    z = np.exp(total - total.max())
    sm = z / z.sum()
    cost = -np.log(max(sm[gold_path], 1e-30))
    d = sm.astype(np.float32)
    d[gold_path] -= 1.0
    grads_c = []
    for i in range(valid):
        g = np.zeros_like(scores_c[i], dtype=np.float32)
        np.add.at(g, path_rows[i], d)
        grads_c.append(g)
    return cost, grads_c, valid


def _ceob_batch(scores, lens, ids, golds):
    """Split each expansion's rows by sequence (expansion 0 has a row a
    sequence; expansion i's rows fan out one per non-(-1) candidate of
    expansion i-1, in sequence order) and run `_ceob_one_seq` on each.
    Returns (costs [N], score gradients, rowseq: each expansion's row ->
    its sequence)."""
    n_exp, n = len(scores), golds[0].shape[0]
    beam = ids[0].shape[1]
    row_start = [np.arange(n + 1)]
    for i in range(1, n_exp):
        prev = row_start[i - 1]
        counts = np.array([(ids[i - 1][prev[s]:prev[s + 1]] != -1).sum()
                           for s in range(n)])
        row_start.append(np.concatenate([[0], np.cumsum(counts)]))
    rowseq = []
    for i in range(n_exp):
        rs = np.zeros(scores[i].shape[0], np.int32)
        used = np.repeat(np.arange(n), np.diff(row_start[i]).astype(int))
        rs[:used.size] = used
        rowseq.append(rs)
    costs = np.zeros(n, np.float32)
    grads = [np.zeros(s.shape, np.float32) for s in scores]
    for s in range(n):
        ids_l, scores_c, starts_c, spans = [], [], [], []
        for i in range(n_exp):
            r0, r1 = int(row_start[i][s]), int(row_start[i][s + 1])
            ids_l.append(ids[i][r0:r1])
            ln = lens[i][r0:r1].astype(int)
            starts_c.append(np.concatenate([[0], np.cumsum(ln)]))
            scores_c.append(
                np.concatenate([scores[i][r0 + k, :ln[k]].ravel()
                                for k in range(r1 - r0)])
                if r1 > r0 else np.zeros(0, np.float32))
            spans.append((r0, ln))
        cost, grads_c, valid = _ceob_one_seq(
            beam, scores_c, starts_c, ids_l,
            [int(golds[i][s]) for i in range(n_exp)])
        costs[s] = cost
        for i in range(valid):
            r0, ln = spans[i]
            st = starts_c[i]
            for k in range(len(ln)):
                grads[i][r0 + k, :ln[k]] += grads_c[i][st[k]:st[k + 1]]
    return costs, grads, rowseq


def _host(t):
    return t.detach().cpu().numpy()


class BeamTrainingCost(torch.autograd.Function):
    """Per-sequence costs [N] of E expansions; only the scores are
    differentiated.  ``apply(n_exp, *scores, *lens, *ids, *golds)``."""

    @staticmethod
    def forward(ctx, n_exp, *flat):
        scores = flat[:n_exp]
        lens, ids, golds = (flat[n_exp:2 * n_exp], flat[2 * n_exp:3 * n_exp],
                            flat[3 * n_exp:])
        costs, grads, rowseq = _ceob_batch(
            [_host(s).astype(np.float32) for s in scores],
            [_host(x).astype(np.int64) for x in lens],
            [_host(x).astype(np.int64) for x in ids],
            [_host(x).reshape(-1).astype(np.int64) for x in golds])
        dev = scores[0].device
        ctx.n_exp = n_exp
        ctx.n_flat = len(flat)
        ctx.save_for_backward(
            *[torch.from_numpy(g).to(dev) for g in grads],
            *[torch.from_numpy(r).long().to(dev) for r in rowseq])
        ctx.score_dtypes = [s.dtype for s in scores]
        return torch.from_numpy(costs).to(dev)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        grads, rowseq = saved[:ctx.n_exp], saved[ctx.n_exp:]
        gflat = g.reshape(-1)
        d_scores = [(gr * gflat[rs][:, None]).to(dt)
                    for gr, rs, dt in zip(grads, rowseq, ctx.score_dtypes)]
        return (None, *d_scores) + (None,) * (ctx.n_flat - ctx.n_exp)


@register_op("cross_entropy_over_beam",
             doc="learning-to-search beam-training cost over expansion "
                 "triples (host path construction, the JAX custom VJP's "
                 "gradient)")
def _cross_entropy_over_beam(ctx):
    scores = [s[..., 0] if s.dim() == 3 else s for s in ctx.inputs("Scores")]
    ids = [i[..., 0] if i.dim() == 3 else i for i in ctx.inputs("Ids")]
    golds = [g[..., 0] if g.dim() > 1 else g for g in ctx.inputs("Gold")]
    lens = []
    for name, s in zip(ctx.input_names("Scores"), scores):
        ln = ctx.env.get(name + LEN_SUFFIX)
        lens.append(torch.full((s.shape[0],), s.shape[1], dtype=torch.int32,
                               device=s.device) if ln is None else ln)
    cost = BeamTrainingCost.apply(len(scores), *scores, *lens, *ids, *golds)
    ctx.set_output("Out", cost.reshape(-1, 1))
