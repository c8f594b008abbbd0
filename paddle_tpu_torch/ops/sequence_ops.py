"""Sequence op rules (counterpart of ``paddle_tpu/ops/sequence_ops.py``:
``sequence_pool`` and the recurrent ``lstm`` and ``gru`` rules).

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

from ..core.registry import register_op
from . import kernels as K
from .math_ops import amp_on


def _time_mask(lens, t: int, dtype=torch.float32):
    """[B, T] 1/0 mask from lengths; None if there are none."""
    if lens is None:
        return None
    return (torch.arange(t, device=lens.device)[None, :]
            < lens[:, None]).to(dtype)


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
        idx = (lens - 1 if lens is not None
               else torch.full((b,), t - 1, device=x.device))
        idx = idx.clamp(0, t - 1).long().reshape(
            (b, 1) + (1,) * (x.dim() - 2)).expand((b, 1) + x.shape[2:])
        out = x.gather(1, idx)[:, 0]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError(f"unknown pooltype {ptype}")
    ctx.set_output("Out", out)


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
