"""Sequence op rules (counterpart of ``paddle_tpu/ops/sequence_ops.py``,
all 17 rules: the ``sequence_*`` family, ``lstm_unit`` and the recurrent
``lstm`` and ``gru`` rules).

A ragged batch is a padded dense tensor [B, T, ...] plus its int32
``<name>@SEQ_LEN`` length vector, as in the JAX package; masks take the
place of LoD offsets.

The recurrent rules route as the JAX rules do, by attributes: the default
activations with no peepholes go to the fused kernels' autograd Functions
(`kernels.FusedLSTM`, `kernels.FusedGRU`: the CUDA kernels on the card,
their plain versions on the CPU), anything else to an eager per-step loop
in torch that ports the JAX scan cell.  Unlike the JAX rules, which take
the Pallas kernels only for H % 128 == 0, B % 8 == 0, a VMEM fit and (GRU)
T >= 128, the port takes its kernels at every shape (ROADMAP queue C).
``is_reverse`` flips the whole padded time axis and its mask, as the JAX
rules do (it does not reverse each row within its length).
"""
from __future__ import annotations

import torch

from ..core.lowering import LEN_SUFFIX
from ..core.registry import register_op
from . import kernels as K
from .math_ops import amp_on


def _time_mask(lens, t: int, dtype=torch.float32):
    """[B, T] 1/0 mask from lengths; None if there are none."""
    if lens is None:
        return None
    return (torch.arange(t, device=lens.device)[None, :]
            < lens[:, None]).to(dtype)


def _last_index(lens, b, t, device):
    """Each row's last valid time step ([B] long), T-1 without lengths."""
    idx = (lens - 1 if lens is not None
           else torch.full((b,), t - 1, device=device))
    return idx.clamp(0, t - 1).long()


def _take_time(x, idx):
    """x [B, T, ...] gathered along time at idx [B, T'] -> [B, T', ...]."""
    b, n = idx.shape
    full = idx.reshape((b, n) + (1,) * (x.dim() - 2)).expand(
        (b, n) + tuple(x.shape[2:]))
    return x.gather(1, full)


# ---------------------------------------------------------------------------
# sequence_pool (pool types AVERAGE SUM SQRT MAX LAST FIRST)
# ---------------------------------------------------------------------------

@register_op("sequence_pool")
def _sequence_pool(ctx):
    x = ctx.input("X")                     # [B, T, D...]
    lens = ctx.seq_len_of("X")
    ptype = ctx.attr("pooltype", "AVERAGE").upper()
    b, t = x.shape[0], x.shape[1]
    mshape = (b, t) + (1,) * (x.dim() - 2)
    m = (_time_mask(lens, t, x.dtype).reshape(mshape) if lens is not None
         else torch.ones(mshape, dtype=x.dtype, device=x.device))
    n = (m.sum(dim=1) if lens is not None
         else torch.full((b,) + (1,) * (x.dim() - 2), t, dtype=x.dtype,
                         device=x.device))
    if ptype == "SUM":
        out = (x * m).sum(dim=1)
    elif ptype == "AVERAGE":
        out = (x * m).sum(dim=1) / n.clamp(min=1)
    elif ptype == "SQRT":
        out = (x * m).sum(dim=1) / n.clamp(min=1).sqrt()
    elif ptype == "MAX":
        low = (torch.finfo(x.dtype).min if x.is_floating_point()
               else -2 ** 30)
        out = torch.where(m > 0, x, torch.full((), low, dtype=x.dtype,
                                               device=x.device)).amax(dim=1)
    elif ptype == "LAST":
        out = _take_time(x, _last_index(lens, b, t, x.device)[:, None])[:, 0]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError(f"unknown pooltype {ptype}")
    ctx.set_output("Out", out)


@register_op("sequence_first_step")
def _sequence_first_step(ctx):
    ctx.set_output("Out", ctx.input("X")[:, 0])


@register_op("sequence_last_step")
def _sequence_last_step(ctx):
    x = ctx.input("X")
    idx = _last_index(ctx.seq_len_of("X"), x.shape[0], x.shape[1], x.device)
    ctx.set_output("Out", _take_time(x, idx[:, None])[:, 0])


@register_op("sequence_softmax",
             doc="softmax over the time axis with the length mask")
def _sequence_softmax(ctx):
    x = ctx.input("X")                     # [B, T] or [B, T, 1]
    lens = ctx.seq_len_of("X")
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    logits = (x[..., 0] if squeeze else x).float()
    mask = _time_mask(lens, logits.shape[1])
    if mask is not None:
        logits = torch.where(mask > 0, logits,
                             torch.full_like(logits, -1e30))
    sm = torch.softmax(logits, dim=1)
    if mask is not None:
        sm = sm * mask
    out = sm[..., None] if squeeze else sm
    ctx.set_output("Out", out.to(x.dtype))
    ctx.set_seq_len("Out", lens)


@register_op("sequence_expand",
             doc="broadcast per-row vectors over a reference sequence's "
                 "time axis (the attention use)")
def _sequence_expand(ctx):
    x = ctx.input("X")                     # [B, D] or [B, 1, D]
    y = ctx.input("Y")                     # [B, T, ...] reference
    t = y.shape[1]
    if x.dim() == 2:
        out = x[:, None, :].expand(x.shape[0], t, x.shape[1])
    else:
        out = x.expand((x.shape[0], t) + tuple(x.shape[2:]))
    ctx.set_output("Out", out)
    ctx.set_seq_len("Out", ctx.seq_len_of("Y"))


@register_op("sequence_conv", doc="context-window projection over time")
def _sequence_conv(ctx):
    x = ctx.input("X")                     # [B, T, D]
    w = ctx.input("Filter")                # [ctx_len * D, F]
    ctx_len = ctx.attr("contextLength")
    ctx_start = ctx.attr("contextStart", -(ctx_len // 2))
    lens = ctx.seq_len_of("X")
    t = x.shape[1]
    mask = _time_mask(lens, t, x.dtype)
    xm = x * mask[..., None] if mask is not None else x
    cols = []
    for i in range(ctx_len):
        off = ctx_start + i
        if off < 0:
            cols.append(torch.nn.functional.pad(xm, (0, 0, -off, 0))[:, :t])
        elif off > 0:
            cols.append(torch.nn.functional.pad(xm, (0, 0, 0, off))[:, off:])
        else:
            cols.append(xm)
    stacked = torch.cat(cols, dim=-1)     # [B, T, ctx_len * D]
    dt = torch.promote_types(stacked.dtype, w.dtype)
    out = torch.matmul(stacked.to(dt), w.to(dt)).to(x.dtype)
    if mask is not None:
        out = out * mask[..., None]
    ctx.set_output("Out", out)
    ctx.set_seq_len("Out", lens)


@register_op("sequence_slice")
def _sequence_slice(ctx):
    x = ctx.input("X")
    offset = ctx.input("Offset").reshape(-1).long()      # [B]
    length = ctx.input("Length").reshape(-1).to(torch.int32)
    t = x.shape[1]
    idx = (offset[:, None]
           + torch.arange(t, device=x.device)[None, :]).clamp(0, t - 1)
    ctx.set_output("Out", _take_time(x, idx))
    ctx.set_seq_len("Out", length)


def _compact(x, keep):
    """Kept tokens of each row moved left in order, the rest 0 -> (out,
    new lengths int32)."""
    t = x.shape[1]
    new_lens = keep.sum(dim=1).to(torch.int32)
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    gathered = x.gather(1, order)
    mask = torch.arange(t, device=x.device)[None, :] < new_lens[:, None]
    return torch.where(mask, gathered, torch.zeros_like(gathered)), new_lens


@register_op("sequence_erase", doc="drop tokens; compacts left, repads")
def _sequence_erase(ctx):
    x = ctx.input("X")                     # [B, T] int tokens
    tokens = torch.as_tensor(list(ctx.attr("tokens")), dtype=x.dtype,
                             device=x.device)
    lens = ctx.seq_len_of("X")
    keep = (x[..., None] != tokens[None, None, :]).all(dim=-1)
    if lens is not None:
        keep = keep & (torch.arange(x.shape[1], device=x.device)[None, :]
                       < lens[:, None])
    out, new_lens = _compact(x, keep)
    ctx.set_output("Out", out)
    ctx.set_seq_len("Out", new_lens)


@register_op("sequence_reshape")
def _sequence_reshape(ctx):
    x = ctx.input("X")                     # [B, T, D]
    new_dim = ctx.attr("new_dim")
    b, t, d = x.shape
    ctx.set_output("Out", x.reshape(b, t * d // new_dim, new_dim))
    lens = ctx.seq_len_of("X")
    if lens is not None:
        ctx.set_seq_len("Out", (lens * d) // new_dim)


@register_op("sequence_concat", doc="concat sequences time-wise, packed "
             "by each row's lengths")
def _sequence_concat(ctx):
    xs = ctx.inputs("X")                   # each [B, T_i, ...]
    lens = [ctx.env.get(n + LEN_SUFFIX) for n in ctx.input_names("X")]
    lens = [ln if ln is not None
            else torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                            device=x.device)
            for x, ln in zip(xs, lens)]
    b = xs[0].shape[0]
    t_out = sum(x.shape[1] for x in xs)
    dev = xs[0].device
    idx = torch.arange(t_out, device=dev)[None, :]
    out = torch.zeros((b, t_out) + tuple(xs[0].shape[2:]),
                      dtype=xs[0].dtype, device=dev)
    start = torch.zeros((b, 1), dtype=torch.long, device=dev)
    for x, ln in zip(xs, lens):
        rel = (idx - start).clamp(0, x.shape[1] - 1)
        sel = (idx >= start) & (idx < start + ln.long()[:, None])
        vals = _take_time(x, rel)
        out = torch.where(sel.reshape(sel.shape + (1,) * (vals.dim() - 2)),
                          vals, out)
        start = start + ln.long()[:, None]
    ctx.set_output("Out", out)
    ctx.set_seq_len("Out", sum(lens).to(torch.int32))


@register_op("sequence_pad")
def _sequence_pad(ctx):
    """Already padded in this representation: X again, and its lengths."""
    x = ctx.input("X")
    ctx.set_output("Out", x)
    lens = ctx.seq_len_of("X")
    ctx.set_output("Length", lens if lens is not None else torch.full(
        (x.shape[0],), x.shape[1], dtype=torch.int32, device=x.device))


@register_op("sequence_unpad")
def _sequence_unpad(ctx):
    ctx.set_output("Out", ctx.input("X"))
    ctx.set_seq_len("Out", ctx.input("Length").reshape(-1).to(torch.int32))


@register_op("lstm_unit", doc="lstm_unit_op.cc: one fused cell step")
def _lstm_unit(ctx):
    x = ctx.input("X")                     # [B, 4H] pre-projected gates
    c_prev = ctx.input("C_prev")
    i, f, g, o = x.chunk(4, dim=-1)
    c = (torch.sigmoid(f + ctx.attr("forget_bias", 0.0)) * c_prev
         + torch.sigmoid(i) * torch.tanh(g))
    ctx.set_output("C", c)
    ctx.set_output("H", torch.sigmoid(o) * torch.tanh(c))


@register_op("sequence_mask", doc="1/0 mask [B, T] from a sequence's "
             "lengths")
def _sequence_mask(ctx):
    x = ctx.input("X")
    lens = ctx.seq_len_of("X")
    b, t = x.shape[0], x.shape[1]
    ctx.set_output("Y", torch.ones((b, t), device=x.device) if lens is None
                   else _time_mask(lens, t))


@register_op("sequence_reverse",
             doc="per-row time reversal that leaves the padding in place "
                 "(reversed[t] = x[len-1-t] for t < len)")
def _sequence_reverse(ctx):
    x = ctx.input("X")                     # [B, T, ...]
    lens = ctx.seq_len_of("X")
    b, t = x.shape[0], x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :].expand(b, t)
    if lens is None:
        idx = t - 1 - pos
    else:
        n = lens.reshape(b, 1).long()
        idx = torch.where(pos < n, n - 1 - pos, pos)
    ctx.set_output("Y", _take_time(x, idx))
    ctx.set_seq_len("Y", lens)


# ---------------------------------------------------------------------------
# recurrent cells: dynamic LSTM and GRU over padded sequences
# ---------------------------------------------------------------------------

_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
         "identity": lambda v: v}


def _time_major(x, lens, is_reverse):
    """x [B, T, G] -> (xs [T, B, G], tm [T, B] mask in x's dtype), both
    flipped in time for ``is_reverse``."""
    b, t = x.shape[0], x.shape[1]
    xs = x.transpose(0, 1)
    tmask = _time_mask(lens, t, x.dtype)
    tm = (tmask.transpose(0, 1) if tmask is not None
          else torch.ones((t, b), dtype=x.dtype, device=x.device))
    if is_reverse:
        xs, tm = xs.flip(0), tm.flip(0)
    return xs, tm


def _lstm_scan(x_proj, w_h, bias, h0, c0, lens, gate_act, cell_act,
               cand_act, is_reverse, use_peepholes, w_peep, amp=False):
    """x_proj [B, T, 4H] (the input already projected by an fc), w_h
    [H, 4H] -> (hidden [B, T, H], cell [B, T, H])."""
    h4 = x_proj.shape[2]
    hid = h4 // 4
    xs, tm = _time_major(x_proj, lens, is_reverse)
    if bias is not None:
        # an f32 bias promotes bf16 activations (program.amp)
        xs = xs + bias.reshape(-1)[:h4].reshape(1, 1, h4)
    h0, c0, tm = h0.to(xs.dtype), c0.to(xs.dtype), tm.to(xs.dtype)
    w_mm = w_h.to(torch.bfloat16) if (amp and w_h.dtype == torch.float32) \
        else w_h
    if (gate_act == "sigmoid" and cell_act == "tanh" and cand_act == "tanh"
            and not use_peepholes):
        hs, cs = K.FusedLSTM.apply(xs.contiguous(), w_mm, h0, c0,
                                   tm[:, :, None].contiguous())
    else:
        g_act, c_act, d_act = _ACTS[gate_act], _ACTS[cell_act], \
            _ACTS[cand_act]
        peep = (use_peepholes and w_peep is not None)
        if peep:
            wi, wf, wo = w_peep.chunk(3)
        h, c = h0, c0
        hs, cs = [], []
        for t in range(xs.shape[0]):
            xt = xs[t]
            # the product takes w's dtype and accumulates in f32
            gates = xt + (h.to(w_mm.dtype).float()
                          @ w_mm.float()).to(xt.dtype)
            i, f, g, o = gates.chunk(4, dim=-1)
            if peep:
                i = i + c * wi
                f = f + c * wf
            i, f = g_act(i), g_act(f)
            g = d_act(g)
            c_new = f * c + i * g
            if peep:
                o = o + c_new * wo
            o = g_act(o)
            h_new = o * c_act(c_new)
            m = tm[t][:, None]
            h = m * h_new + (1 - m) * h
            c = m * c_new + (1 - m) * c
            hs.append(h)
            cs.append(c)
        hs, cs = torch.stack(hs), torch.stack(cs)
    if is_reverse:
        hs, cs = hs.flip(0), cs.flip(0)
    return hs.transpose(0, 1), cs.transpose(0, 1)


@register_op("lstm", doc="lstm_op.cc: dynamic LSTM over padded sequences")
def _lstm(ctx):
    x = ctx.input("Input")                 # [B, T, 4H]
    w = ctx.input("Weight")                # [H, 4H]
    bias = ctx.input("Bias")               # [1, 4H], or [1, 7H] w/ peepholes
    lens = ctx.seq_len_of("Input")
    use_peepholes = ctx.attr("use_peepholes", False)
    hid, b = w.shape[0], x.shape[0]
    h0, c0 = ctx.input("H0"), ctx.input("C0")
    if h0 is None:
        h0 = torch.zeros((b, hid), dtype=x.dtype, device=x.device)
    if c0 is None:
        c0 = torch.zeros((b, hid), dtype=x.dtype, device=x.device)
    bv = bias.reshape(-1) if bias is not None else None
    w_peep = (bv[4 * hid:7 * hid] if (use_peepholes and bv is not None
                                      and bv.shape[0] >= 7 * hid) else None)
    hidden, cell = _lstm_scan(
        x, w, bv[:4 * hid] if bv is not None else None, h0, c0, lens,
        ctx.attr("gate_activation", "sigmoid"),
        ctx.attr("cell_activation", "tanh"),
        ctx.attr("candidate_activation", "tanh"),
        ctx.attr("is_reverse", False), use_peepholes, w_peep,
        amp=amp_on(ctx))
    ctx.set_output("Hidden", hidden)
    ctx.set_output("Cell", cell)
    ctx.set_seq_len("Hidden", lens)
    ctx.set_seq_len("Cell", lens)


@register_op("gru", doc="gru_op.cc: dynamic GRU over padded sequences")
def _gru(ctx):
    """Weight [H, 3H] in the JAX package's gate-column layout
    [reset | update | candidate]; the rule applies no amp cast."""
    x = ctx.input("Input")                 # [B, T, 3H]
    w = ctx.input("Weight")
    bias = ctx.input("Bias")               # [1, 3H]
    lens = ctx.seq_len_of("Input")
    is_reverse = ctx.attr("is_reverse", False)
    gate_act = ctx.attr("gate_activation", "sigmoid")
    cand_act = ctx.attr("activation", "tanh")
    b, t, h3 = x.shape
    hid = h3 // 3
    h0 = ctx.input("H0")
    if h0 is None:
        h0 = torch.zeros((b, hid), dtype=x.dtype, device=x.device)
    xs, tm = _time_major(x, lens, is_reverse)
    if bias is not None:
        xs = xs + bias.reshape(1, 1, h3)
    h0, tm = h0.to(xs.dtype), tm.to(xs.dtype)
    if gate_act == "sigmoid" and cand_act == "tanh":
        hs = K.FusedGRU.apply(xs.contiguous(), w, h0,
                              tm[:, :, None].contiguous())
    else:
        g_act, c_act = _ACTS[gate_act], _ACTS[cand_act]
        w_rz, w_c = w[:, :2 * hid], w[:, 2 * hid:]
        h, steps = h0, []
        for i in range(t):
            xt = xs[i]
            rz = g_act(xt[:, :2 * hid] + (h @ w_rz).to(xt.dtype))
            r, z = rz[:, :hid], rz[:, hid:]
            c = c_act(xt[:, 2 * hid:] + ((r * h) @ w_c).to(xt.dtype))
            m = tm[i][:, None]
            h = m * ((1 - z) * h + z * c) + (1 - m) * h
            steps.append(h)
        hs = torch.stack(steps)
    if is_reverse:
        hs = hs.flip(0)
    ctx.set_output("Hidden", hs.transpose(0, 1))
    ctx.set_seq_len("Hidden", lens)
