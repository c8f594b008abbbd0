"""The port's sequence modules against the JAX package, on the CPU: the
LSTM and GRU kernels' plain versions and autograd Functions, the ``lstm``
and ``gru`` rules (fused and per-step paths, ``is_reverse``),
``sequence_pool``, ``lookup_table``'s lengths, the DynamicRNN (hoisting,
mul merging, ``@SEQ_LEN``), the program JSON with a sub-block, and an
output read only inside a step block.

Inputs are made with numpy from fixed seeds and handed to both packages.
The JAX side runs with ``PADDLE_TPU_PALLAS_INTERPRET=1`` where its rules
reach the Pallas kernels (then in interpret mode); the port's wrappers run
their plain versions on CPU tensors.

Tolerances: the kernels' f32 outputs and gradients, atol 2e-5 (the same
f32 math summed in another order); a bf16 recurrent weight, 2e-2 x
max(1, max |want|) (the ROADMAP's bf16 rule: a reordered f32 sum can flip
one bf16 rounding of h_prev, which the recurrence carries on); programs,
1e-5 x the largest |value| in f32.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import layers as jlayers
from paddle_tpu.ops.pallas_kernels import (_gru_pallas_bwd, _gru_pallas_fwd,
                                           _lstm_pallas_bwd,
                                           _lstm_pallas_fwd, fused_gru,
                                           fused_lstm)
import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as players
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops import rnn_ops

JAX = (jfluid, jlayers)
PORT = (fluid, players)
T, B, H = 6, 8, 128
LENS = np.array([6, 6, 4, 2, 6, 1, 3, 5], np.int32)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    for pkg in (jfluid, fluid):
        pkg.core.program.reset_default_programs()
        pkg.core.scope._global_scope = pkg.core.scope.Scope()
    yield


def _close(got, want, tol, what=""):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else np.asarray(got, np.float32), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.max(np.abs(got - want), initial=0.0))
    assert err <= tol, (what, err)


def _mask():
    return (np.arange(T)[:, None] < LENS[None, :]).astype(
        np.float32)[:, :, None]


# ---------------------------------------------------------------------------
# the kernels' plain versions and autograd Functions
# ---------------------------------------------------------------------------

def _recurrent_case(gates, wdtype, seed):
    rng = np.random.RandomState(seed)
    xs = rng.randn(T, B, gates * H).astype(np.float32) * 0.5
    w = rng.randn(H, gates * H).astype(np.float32) * 0.2
    h0 = rng.randn(B, H).astype(np.float32) * 0.5
    c0 = rng.randn(B, H).astype(np.float32) * 0.5
    gh = rng.randn(T, B, H).astype(np.float32)
    gc = rng.randn(T, B, H).astype(np.float32)
    jw = jnp.asarray(w).astype(jnp.dtype(wdtype))
    tw = torch.from_numpy(w).to(getattr(torch, wdtype))
    return xs, w, jw, tw, h0, c0, gh, gc


def _tol(wdtype, want):
    if wdtype == "float32":
        return 2e-5
    return 2e-2 * max(1.0, float(np.max(np.abs(np.asarray(want, np.float32)))))


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_lstm_matches_pallas(wdtype):
    """lstm_fwd_plain and lstm_bwd_plain against the Pallas kernels, and
    FusedLSTM's gradients against jax.grad of fused_lstm, with ragged
    masks."""
    xs, w, jw, tw, h0, c0, gh, gc = _recurrent_case(4, wdtype, 0)
    tm = _mask()
    jargs = (jnp.asarray(xs), jw, jnp.asarray(h0), jnp.asarray(c0))
    jhs, jcs = fused_lstm(*jargs, jnp.asarray(tm), True)
    targs = (torch.from_numpy(xs), tw, torch.from_numpy(h0),
             torch.from_numpy(c0), torch.from_numpy(tm))
    hs, cs = K.lstm_fwd_plain(*targs)
    for got, want in ((hs, jhs), (cs, jcs)):
        _close(got, want, _tol(wdtype, want), "forward")
    # the backward kernel on its own, from given cotangents
    want = _lstm_pallas_bwd(*jargs, jnp.asarray(tm), jhs, jcs,
                            jnp.asarray(gh), jnp.asarray(gc), True)
    got = K.lstm_bwd_plain(*targs, hs, cs, torch.from_numpy(gh),
                           torch.from_numpy(gc))
    for name, g, wv in zip(["dxs", "dw", "dh0", "dc0"], got, want):
        _close(g, wv, _tol(wdtype, wv), name)
    # the autograd Function against jax.grad of the custom VJP

    def loss(*a):
        hs_, cs_ = fused_lstm(*a, jnp.asarray(tm), True)
        return jnp.sum(hs_ * gh) + jnp.sum(cs_ * gc)
    jgrads = jax.grad(loss, argnums=(0, 1, 2, 3))(*jargs)
    leaves = [t.clone().requires_grad_(True) for t in targs[:4]]
    ths, tcs = K.FusedLSTM.apply(*leaves, targs[4])
    ((ths * torch.from_numpy(gh)).sum()
     + (tcs * torch.from_numpy(gc)).sum()).backward()
    for name, leaf, jg in zip(["xs", "w", "h0", "c0"], leaves, jgrads):
        assert leaf.grad.dtype == leaf.dtype
        _close(leaf.grad, jg.astype(jnp.float32), _tol(wdtype, jg), name)


def _kernel_sum(a, b, wdtype):
    """sum over k of a[k] (x) b[k] for a [K, M], b [K, N] in the order of
    summation of the port's tensor-core products: each k-step's product
    formed apart (f64, then rounded to f32: an mma from zero) and added
    to the f32 sum.  bf16 w: operands rounded to bf16, 16-deep steps; f32
    w: 8-deep steps (3xTF32 m16n8k8, about f32's accuracy)."""
    out = torch.zeros(a.shape[1], b.shape[1], dtype=torch.float32)
    if wdtype == "bfloat16":
        a, b = (x.to(torch.bfloat16) for x in (a, b))
    a, b = a.double(), b.double()
    depth = 16 if wdtype == "bfloat16" else 8
    for k0 in range(0, a.shape[0], depth):
        out = out + (a[k0:k0 + depth].T @ b[k0:k0 + depth]).float()
    return out


def _dw_as_the_kernel_sums(hprev, dxs, wdtype):
    """dw = h_prev^T . dgates summed as lstm.cu's dw product sums it: over
    k = (t, b) in order, by `_kernel_sum`."""
    a = hprev.reshape(-1, hprev.shape[-1])
    b = dxs.reshape(-1, dxs.shape[-1])
    return _kernel_sum(a, b, wdtype)


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_lstm_dw_summation_order_matches_pallas(wdtype):
    """The LSTM backward's dw product, emulated in its order of summation
    from the plain version's dgates, against lstm_bwd_plain's dw and the
    Pallas backward's (interpret mode): F32_TOL for an f32 w, the bf16
    rule for a bf16 w."""
    xs, w, jw, tw, h0, c0, gh, gc = _recurrent_case(4, wdtype, 2)
    tm = _mask()
    targs = (torch.from_numpy(xs), tw, torch.from_numpy(h0),
             torch.from_numpy(c0), torch.from_numpy(tm))
    hs, cs = K.lstm_fwd_plain(*targs)
    dxs, dw, _, _ = K.lstm_bwd_plain(*targs, hs, cs, torch.from_numpy(gh),
                                     torch.from_numpy(gc))
    got = _dw_as_the_kernel_sums(K._prev(targs[2], hs), dxs, wdtype)
    jargs = (jnp.asarray(xs), jw, jnp.asarray(h0), jnp.asarray(c0))
    jhs, jcs = fused_lstm(*jargs, jnp.asarray(tm), True)
    want = _lstm_pallas_bwd(*jargs, jnp.asarray(tm), jhs, jcs,
                            jnp.asarray(gh), jnp.asarray(gc), True)[1]
    _close(got, dw, _tol(wdtype, dw), "plain dw")
    _close(got, want, _tol(wdtype, want), "Pallas dw")


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("units", [1, 4, 8])
def test_lstm_dh_exchange_order_matches_plain(wdtype, units):
    """dh_prev as the LSTM backward's recurrence forms it: each block of
    ``units`` hidden units multiplies its own 4 * units dgates columns by
    the matching columns of w for every j (operands rounded to bf16 for a
    bf16 w, the product in f32), and the blocks' shares are added in
    order of block.  Held against the plain version's mm(dgates) . w^T:
    F32_TOL for an f32 w, the bf16 rule for a bf16 w."""
    tw = _recurrent_case(4, wdtype, 3)[3]
    dg = torch.from_numpy(np.random.RandomState(4).randn(B, 4 * H)
                          .astype(np.float32))
    wf = tw.float()
    want = K._mm(dg, tw) @ wf.T
    got = torch.zeros(B, H)
    for j0 in range(0, H, units):
        cols = [q * H + j0 + u for q in range(4) for u in range(units)]
        share = (K._mm(dg[:, cols], tw).double()
                 @ wf[:, cols].T.double()).float()
        got = got + share
    _close(got, want, _tol(wdtype, want), "dh_prev")


@pytest.mark.parametrize("h,sms,units", [(512, 132, 4), (96, 132, 1),
                                         (1024, 132, 8), (2048, 132, 8),
                                         (264, 132, 2)])
def test_recurrent_units_and_dw_splits(h, sms, units, monkeypatch):
    """The wrappers size their exchange buffers by asking their own
    kernel's library (ptt_rnn_exchange_floats, whose units a block and
    layout are recurrent.cuh's; chip_smoke.py phase 3 holds the answers on
    the card to two [blocks] x [blocks] x [B * units rounded up to 4]
    buffers): here a stand-in library answers that layout for ``units``
    (recurrent.cuh's rule on a card of ``sms`` SMs), and the query must
    pass H and B to the named library, keep one answer per card and shape,
    and raise when the library reports an error.  The dw products' split,
    for the LSTM's 4H and the GRU's 3H gate columns, gives about 1024
    blocks, at most 8 runs of at least 128 k each."""
    asked = []

    class Lib:
        def __init__(self, name):
            self.name = name

        @property
        def ptt_rnn_exchange_floats(self):
            def query(hh, bb, out):
                asked.append((self.name, hh, bb))
                blocks = -(-hh // units)
                out._obj.value = 2 * blocks * blocks * (-(-bb * units // 4)
                                                        * 4)
                return 0 if hh > 0 else 1
            return query

    monkeypatch.setattr(K._build, "load", Lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    K.rnn_exchange_floats.cache_clear()
    try:
        blocks = -(-h // units)
        assert (blocks <= sms or units == 8) and (
            units == 1 or -(-h // (units // 2)) > sms)
        for source in (K.LSTM_BWD.source, K.GRU_BWD.source):
            for b in (1, 5, 32):
                seg = -(-b * units // 4) * 4
                for _ in range(2):
                    assert (K.rnn_exchange_floats(source, 0, h, b)
                            == 2 * blocks * blocks * seg)
        assert asked == [(s, h, b) for s in ("lstm", "gru")
                         for b in (1, 5, 32)]
        with pytest.raises(RuntimeError, match="exchange size query"):
            K.rnn_exchange_floats("gru", 0, -h, 4)
    finally:
        K.rnn_exchange_floats.cache_clear()
    for gates in (4, 3):
        tiles = -(-h // 64) * -(-gates * h // 64)
        for tb in (7 * 5, 80 * 32, 4096 * 64):
            s = K.rnn_dw_splits(h, tb, gates)
            assert 1 <= s <= 8 and (s == 1 or tb / s >= 128 / 2)
            assert s * tiles <= max(1024, tiles)
    # the main path's GRU (H512, T80 B32): 8 x 24 tiles in 5 runs
    assert K.rnn_dw_splits(512, 80 * 32, 3) == 5


def _split_dw(a, b, wdtype, splits):
    """a^T . b over k = (t, b) as the backward's dw product sums it: k in
    `splits` runs of whole k-tiles (32 deep for bf16, 16 for f32), each
    run's partial product summed apart, the runs added in order."""
    bk = 32 if wdtype == "bfloat16" else 16
    tiles = -(-a.shape[0] // bk)
    per = -(-tiles // splits)
    out = torch.zeros(a.shape[1], b.shape[1], dtype=torch.float32)
    for z in range(splits):
        k0, k1 = z * per * bk, min(a.shape[0], (z + 1) * per * bk)
        if k0 < k1:
            out = out + _kernel_sum(a[k0:k1], b[k0:k1], wdtype)
    return out


def _shares(d, w_cols, units, gate_cols, wdtype, tw):
    """sum over n of mm(d[b][n]) . w_cols[j][n] as the exchange takes it:
    each block of ``units`` hidden units multiplies its own columns (the
    units' column of each of ``gate_cols`` gates) by w's, in f32 from
    exact products, and the blocks' shares are added in order of block."""
    hid = w_cols.shape[0]
    width = d.shape[1] // gate_cols
    out = torch.zeros(d.shape[0], hid)
    for j0 in range(0, width, units):
        cols = [q * width + j0 + u for q in range(gate_cols)
                for u in range(units) if j0 + u < width]
        share = (K._mm(d[:, cols], tw).double()
                 @ w_cols[:, cols].T.double()).float()
        out = out + share
    return out


def _gru_bwd_hoisted(xs, tw, h0, mask, hs, dhs, units, wdtype):
    """The GRU backward in the order gru.cu takes it: r, z and c from two
    products over all T (x + mm(h_prev) . w_rz, then x + mm(r h_prev) .
    w_c), the recurrence with drh and drz_in . w_rz^T formed from the
    blocks' shares added in order of block, and dw as in-order sums of
    split runs of k."""
    hid = tw.shape[0]
    wf = tw.float()
    w_rz, w_c = wf[:, :2 * hid], wf[:, 2 * hid:]
    t_, b_ = xs.shape[:2]
    hprev = K._prev(h0, hs)
    hp2, x2 = hprev.reshape(-1, hid), xs.reshape(t_ * b_, -1)
    rz = torch.sigmoid(x2[:, :2 * hid] + (K._mm(hp2, tw).double()
                                          @ w_rz.double()).float())
    r, z = rz[:, :hid], rz[:, hid:]
    rh = r * hp2
    c = torch.tanh(x2[:, 2 * hid:] + (K._mm(rh, tw).double()
                                      @ w_c.double()).float())
    r, z, c = (v.reshape(t_, b_, hid) for v in (r, z, c))
    carry = torch.zeros(b_, hid)
    dxs = torch.zeros_like(xs)
    for t in reversed(range(t_)):
        m, h_prev = mask[t], hprev[t]
        dh = dhs[t] + carry
        dh_new = m * dh
        part = (1 - m) * dh + dh_new * (1 - z[t])
        dz = dh_new * (c[t] - h_prev)
        dc_in = dh_new * z[t] * (1 - c[t] * c[t])
        dz_in = dz * z[t] * (1 - z[t])
        drh = _shares(dc_in, w_c, units, 1, wdtype, tw)
        dr_in = drh * h_prev * r[t] * (1 - r[t])
        carry = part + drh * r[t]
        drz_in = torch.cat([dr_in, dz_in], dim=1)
        carry = carry + _shares(drz_in, w_rz, units, 2, wdtype, tw)
        dxs[t] = torch.cat([drz_in, dc_in], dim=1)
    splits = K.rnn_dw_splits(hid, t_ * b_, 3)
    dg = dxs.reshape(t_ * b_, -1)
    dw = torch.cat([_split_dw(hp2, dg[:, :2 * hid], wdtype, splits),
                    _split_dw(rh, dg[:, 2 * hid:], wdtype, splits)], dim=1)
    return dxs, dw, carry


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("units", [1, 4, 8])
def test_gru_bwd_hoisted_order_matches_pallas(wdtype, units):
    """The GRU backward's order of work and summation (gates from the
    batched products, drh and the drz_in . w_rz^T term from the blocks'
    shares added block by block, dw as in-order split sums), rendered in
    plain torch, against gru_bwd_plain and the Pallas backward
    (interpret mode): F32_TOL for an f32 w, the bf16 rule for a bf16 w."""
    xs, w, jw, tw, h0, _, gh, _ = _recurrent_case(3, wdtype, 5)
    tm = _mask()
    targs = (torch.from_numpy(xs), tw, torch.from_numpy(h0),
             torch.from_numpy(tm))
    hs = K.gru_fwd_plain(*targs)
    got = _gru_bwd_hoisted(targs[0], tw, targs[2], targs[3], hs,
                           torch.from_numpy(gh), units, wdtype)
    plain = K.gru_bwd_plain(*targs, hs, torch.from_numpy(gh))
    jargs = (jnp.asarray(xs), jw, jnp.asarray(h0))
    jhs = fused_gru(*jargs, jnp.asarray(tm), True)
    want = _gru_pallas_bwd(*jargs, jnp.asarray(tm), jhs, jnp.asarray(gh),
                           True)
    for name, g, pv, wv in zip(["dxs", "dw", "dh0"], got, plain, want):
        _close(g, pv, _tol(wdtype, pv), f"plain {name}")
        _close(g, wv, _tol(wdtype, wv), f"Pallas {name}")


def _warp_split(a, w_cols, wdtype, warps=8):
    """A forward step product a [B, K] . w_cols [K, N] in the order of
    summation of recurrent.cuh's step_product: K split over ``warps``
    runs of whole 16-deep k-steps, each run summed apart (`_kernel_sum`:
    16-deep bf16 or 8-deep 3xTF32 products added with FADD), the runs
    added in order of warp."""
    hid = w_cols.shape[0]
    steps = -(-hid // 16)
    per = -(-steps // warps)
    total = torch.zeros(a.shape[0], w_cols.shape[1])
    for wp in range(warps):
        k0, k1 = 16 * min(steps, wp * per), 16 * min(steps, wp * per + per)
        k1 = min(k1, hid)
        if k0 < k1:
            total = total + _kernel_sum(a[:, k0:k1].T, w_cols[k0:k1],
                                        wdtype)
    return total


def _lstm_fwd_warp_split(xs, tw, h0, c0, mask, wdtype, warps=8):
    """The LSTM forward in lstm.cu's order of summation: each step's
    product mm(h_prev) . w by `_warp_split`, then x added."""
    hid = tw.shape[0]
    wf = tw.float()
    h, c = h0.float(), c0.float()
    hs, cs = [], []
    for t in range(xs.shape[0]):
        gates = xs[t] + _warp_split(K._mm(h, tw), wf, wdtype, warps)
        i = torch.sigmoid(gates[:, :hid])
        f = torch.sigmoid(gates[:, hid:2 * hid])
        g = torch.tanh(gates[:, 2 * hid:3 * hid])
        o = torch.sigmoid(gates[:, 3 * hid:])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = mask[t]
        h = m * h_new + (1 - m) * h
        c = m * c_new + (1 - m) * c
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def _gru_fwd_warp_split(xs, tw, h0, mask, wdtype, warps=8):
    """The GRU forward in gru.cu's order of summation: the r|z product
    mm(h_prev) . w[:, :2H] and the candidate's mm(r * h_prev) . w[:, 2H:]
    each by `_warp_split`, then x added; r * h_prev rounded as the kernel
    publishes it (bf16 for a bf16 w)."""
    hid = tw.shape[0]
    wf = tw.float()
    h = h0.float()
    hs = []
    for t in range(xs.shape[0]):
        x = xs[t]
        rz = torch.sigmoid(x[:, :2 * hid] + _warp_split(
            K._mm(h, tw), wf[:, :2 * hid], wdtype, warps))
        r, z = rz[:, :hid], rz[:, hid:]
        c = torch.tanh(x[:, 2 * hid:] + _warp_split(
            K._mm(r * h, tw), wf[:, 2 * hid:], wdtype, warps))
        m = mask[t]
        h = m * ((1 - z) * h + z * c) + (1 - m) * h
        hs.append(h)
    return torch.stack(hs)


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_lstm_fwd_step_product_order_matches_pallas(wdtype):
    """The LSTM forward's step product in its kernel's order (K split over
    the 8 warps, 16-deep bf16 or 8-deep 3xTF32 partials added with FADD,
    the warps' sums added in order) against lstm_fwd_plain and the Pallas
    forward (interpret mode): F32_TOL for an f32 w, the bf16 rule for a
    bf16 w."""
    xs, w, jw, tw, h0, c0, _, _ = _recurrent_case(4, wdtype, 6)
    tm = _mask()
    targs = (torch.from_numpy(xs), tw, torch.from_numpy(h0),
             torch.from_numpy(c0), torch.from_numpy(tm))
    got = _lstm_fwd_warp_split(*targs[:2], targs[2], targs[3], targs[4],
                               wdtype)
    plain = K.lstm_fwd_plain(*targs)
    want = _lstm_pallas_fwd(jnp.asarray(xs), jw, jnp.asarray(h0),
                            jnp.asarray(c0), jnp.asarray(tm), True)
    for name, g, pv, wv in zip(["hs", "cs"], got, plain, want):
        _close(g, pv, _tol(wdtype, pv), f"plain {name}")
        _close(g, wv, _tol(wdtype, wv), f"Pallas {name}")


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_gru_fwd_step_product_order_matches_pallas(wdtype):
    """The GRU forward's two step products in its kernel's order (K split
    over the 8 warps, 16-deep bf16 or 8-deep 3xTF32 partials added with
    FADD, the warps' sums added in order, r * h_prev rounded as
    published) against gru_fwd_plain and the Pallas forward (interpret
    mode): F32_TOL for an f32 w, the bf16 rule for a bf16 w."""
    xs, w, jw, tw, h0, _, _, _ = _recurrent_case(3, wdtype, 7)
    tm = _mask()
    targs = (torch.from_numpy(xs), tw, torch.from_numpy(h0),
             torch.from_numpy(tm))
    got = _gru_fwd_warp_split(*targs, wdtype)
    plain = K.gru_fwd_plain(*targs)
    want = _gru_pallas_fwd(jnp.asarray(xs), jw, jnp.asarray(h0),
                           jnp.asarray(tm), True)
    _close(got, plain, _tol(wdtype, plain), "plain hs")
    _close(got, want, _tol(wdtype, want), "Pallas hs")


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_gru_matches_pallas(wdtype):
    """gru_fwd_plain and gru_bwd_plain against the Pallas kernels, and
    FusedGRU's gradients against jax.grad of fused_gru, with ragged
    masks."""
    xs, w, jw, tw, h0, _, gh, _ = _recurrent_case(3, wdtype, 1)
    tm = _mask()
    jargs = (jnp.asarray(xs), jw, jnp.asarray(h0))
    jhs = fused_gru(*jargs, jnp.asarray(tm), True)
    targs = (torch.from_numpy(xs), tw, torch.from_numpy(h0),
             torch.from_numpy(tm))
    hs = K.gru_fwd_plain(*targs)
    _close(hs, jhs, _tol(wdtype, jhs), "forward")
    want = _gru_pallas_bwd(*jargs, jnp.asarray(tm), jhs, jnp.asarray(gh),
                           True)
    got = K.gru_bwd_plain(*targs, hs, torch.from_numpy(gh))
    for name, g, wv in zip(["dxs", "dw", "dh0"], got, want):
        _close(g, wv, _tol(wdtype, wv), name)
    jgrads = jax.grad(lambda *a: jnp.sum(fused_gru(*a, jnp.asarray(tm), True)
                                         * gh), argnums=(0, 1, 2))(*jargs)
    leaves = [t.clone().requires_grad_(True) for t in targs[:3]]
    (K.FusedGRU.apply(*leaves, targs[3]) * torch.from_numpy(gh)).sum() \
        .backward()
    for name, leaf, jg in zip(["xs", "w", "h0"], leaves, jgrads):
        assert leaf.grad.dtype == leaf.dtype
        _close(leaf.grad, jg.astype(jnp.float32), _tol(wdtype, jg), name)


def _f64(*shape, seed, scale=0.5):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(*shape, generator=g,
                                dtype=torch.float64)).requires_grad_(True)


def test_recurrent_functions_gradcheck():
    """Each Function's backward (the plain backward kernel) against finite
    differences of its forward, in f64, ragged mask."""
    t, b, h = 3, 2, 4
    mask = torch.tensor([[1.0, 1.0], [1.0, 0.0], [0.0, 0.0]],
                        dtype=torch.float64)[:, :, None]
    lstm = (_f64(t, b, 4 * h, seed=1), _f64(h, 4 * h, seed=2),
            _f64(b, h, seed=3), _f64(b, h, seed=4))
    assert torch.autograd.gradcheck(
        lambda *a: K.FusedLSTM.apply(*a, mask), lstm)
    gru = (_f64(t, b, 3 * h, seed=5), _f64(h, 3 * h, seed=6),
           _f64(b, h, seed=7))
    assert torch.autograd.gradcheck(lambda *a: K.FusedGRU.apply(*a, mask),
                                    gru)


def test_recurrent_functions_count_no_launch_on_cpu():
    """On CPU tensors the plain versions run and no kernel launch is
    counted; a bf16 xs runs in f32 and comes back in bf16."""
    K.reset_launches()
    xs = torch.randn(3, 2, 16, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(4, 16, requires_grad=True)
    z = torch.zeros(2, 4, dtype=torch.bfloat16)
    mask = torch.ones(3, 2, 1, dtype=torch.bfloat16)
    hs, cs = K.FusedLSTM.apply(xs, w, z, z, mask)
    assert hs.dtype == cs.dtype == torch.bfloat16
    (hs.float().sum() + cs.float().sum()).backward()
    assert xs.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32
    xg = torch.randn(3, 2, 12, requires_grad=True)
    K.FusedGRU.apply(xg, torch.randn(4, 12), torch.zeros(2, 4),
                     torch.ones(3, 2, 1)).sum().backward()
    assert all(k.launches == 0 for k in K.KERNELS)


def test_unplaceable_launch_raises_and_counts_nothing():
    """A recurrent kernel whose blocks cannot all be resident returns
    cudaErrorCooperativeLaunchTooLarge (720): the wrapper raises, saying
    the shape cannot be placed, and counts no launch."""
    k = K.Kernel("probe", "lstm", "ptt_lstm_bwd", "", [])
    k._fn = lambda *args: 720
    with pytest.raises(RuntimeError, match="cannot be placed"):
        k.launch()
    assert k.launches == 0


# ---------------------------------------------------------------------------
# the lstm and gru rules through programs
# ---------------------------------------------------------------------------

def _run_program(pkg, build, feed, fetch_fn):
    """Build with ``build(layers) -> (outputs, loss)``, append the
    backward of ``loss``, run the startup program and one step on the CPU
    -> fetches of the outputs and every parameter's @GRAD."""
    fl, layers = pkg
    outs, loss = build(layers)
    fl.append_backward(loss)
    main = fl.default_main_program()
    fl.default_startup_program().random_seed = 3
    exe = fl.Executor(fl.CPUPlace())
    exe.run(fl.default_startup_program())
    params = sorted(p.name for p in main.all_parameters())
    fetch = fetch_fn(outs) + [p + "@GRAD" for p in params]
    return exe.run(main, feed=feed, fetch_list=fetch)


def _compare_programs(build, feed, fetch_fn=lambda outs: list(outs),
                      tol=1e-5):
    """The program built by ``build`` in both packages, from the same
    parameters (the JAX package's startup values, handed to the port) ->
    (the port's fetches, a function that runs the port's step again)."""
    want = _run_program(JAX, build, feed, fetch_fn)
    fl, layers = PORT
    outs, loss = build(layers)
    fl.append_backward(loss)
    main = fl.default_main_program()
    exe = fl.Executor(fl.CPUPlace())
    exe.run(fl.default_startup_program())
    # the port's startup draws other random numbers: overwrite them
    params = sorted(p.name for p in main.all_parameters())
    for n in params:
        fl.global_scope().set(n, torch.from_numpy(
            np.array(jfluid.global_scope().get(n))))
    fetch = [f if isinstance(f, str) else f.name for f in fetch_fn(outs)]
    fetch += [p + "@GRAD" for p in params]
    got = exe.run(main, feed=feed, fetch_list=fetch)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        _close(g, w, tol * max(1.0, float(np.abs(w).max())))
    return got, lambda: exe.run(main, feed=feed, fetch_list=fetch)


def _ragged_feed(width, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(B, T, width).astype(np.float32) * 0.5,
            "x@SEQ_LEN": LENS}


def _x(layers, width):
    return layers.data(name="x", shape=[T, width], dtype="float32",
                       lod_level=1)


@pytest.mark.parametrize("is_reverse", [False, True])
def test_dynamic_lstm_rule_matches_jax(is_reverse):
    """The fused path (sigmoid/tanh/tanh, no peepholes) on ragged input:
    is_reverse flips the whole padded time axis and its mask, and rows
    past their length hold the last live state."""
    def build(layers):
        hidden, cell = layers.dynamic_lstm(
            input=_x(layers, 4 * H), size=4 * H, use_peepholes=False,
            is_reverse=is_reverse)
        return (hidden, cell), layers.mean(hidden)
    h = _compare_programs(build, _ragged_feed(4 * H))[0][0]
    if not is_reverse:
        for b, n in enumerate(LENS):
            for t in range(n, T):
                np.testing.assert_array_equal(h[b, t], h[b, n - 1])


@pytest.mark.parametrize("is_reverse", [False, True])
def test_dynamic_gru_rule_matches_jax(is_reverse):
    def build(layers):
        hidden = layers.dynamic_gru(input=_x(layers, 3 * H), size=H,
                                    is_reverse=is_reverse)
        return (hidden,), layers.mean(hidden)
    _compare_programs(build, _ragged_feed(3 * H))


@pytest.mark.parametrize("kw", [
    {"use_peepholes": True},
    {"use_peepholes": False, "cell_activation": "relu"},
    {"use_peepholes": True, "gate_activation": "sigmoid",
     "candidate_activation": "identity", "is_reverse": True}],
    ids=["peepholes", "relu-cell", "peepholes-identity-reverse"])
def test_lstm_per_step_path_matches_jax_scan(kw):
    """Peepholes or other activations take the per-step loop, which ports
    the JAX rule's scan cell (the JAX side takes its scan too)."""
    def build(layers):
        hidden, cell = layers.dynamic_lstm(input=_x(layers, 64), size=64,
                                           **kw)
        return (hidden, cell), layers.mean(hidden)
    _compare_programs(build, _ragged_feed(64))


def test_gru_per_step_path_matches_jax_scan():
    def build(layers):
        hidden = layers.dynamic_gru(input=_x(layers, 48), size=16,
                                    candidate_activation="relu")
        return (hidden,), layers.mean(hidden)
    _compare_programs(build, _ragged_feed(48))


@pytest.mark.parametrize("pool", ["average", "sum", "sqrt", "max", "last",
                                  "first"])
def test_sequence_pool_matches_jax(pool):
    def build(layers):
        x = _x(layers, 5)
        y = layers.fc(input=x, size=5, num_flatten_dims=2)
        out = layers.sequence_pool(y, pool)
        return (out,), layers.mean(out)
    _compare_programs(build, _ragged_feed(5))


@pytest.mark.parametrize("ids_shape", [(B, T), (B, T, 1)])
def test_lookup_table_keeps_lengths(ids_shape):
    """[B, T] and [B, T, 1] ids: the embedding carries Ids@SEQ_LEN, so the
    last step and first step pools see the ragged lengths."""
    def build(layers):
        words = layers.data(name="w", shape=list(ids_shape[1:]),
                            dtype="int64", lod_level=1)
        emb = layers.embedding(input=words, size=[20, 6])
        last = layers.sequence_last_step(emb)
        first = layers.sequence_first_step(emb)
        return (last, first), layers.mean(
            layers.elementwise_add(x=last, y=first))
    rng = np.random.RandomState(4)
    feed = {"w": rng.randint(0, 20, ids_shape).astype(np.int64),
            "w@SEQ_LEN": LENS}
    last = _compare_programs(build, feed)[0][0]
    assert not np.allclose(last[1], last[5])


# ---------------------------------------------------------------------------
# DynamicRNN, sub-blocks and the program JSON
# ---------------------------------------------------------------------------

def _cell_program(layers, hid=16):
    """A DynamicRNN with the stacked-LSTM bench's hand-built cell over a
    ragged [B, T, 8] input; returns (the rnn output, its mean)."""
    x = _x(layers, 8)
    rnn = layers.DynamicRNN()
    with rnn.block():
        word = rnn.step_input(x)
        prev_h = rnn.memory(shape=[hid], value=0.0)
        prev_c = rnn.memory(shape=[hid], value=0.0)

        def gate(act):
            g = layers.sums(input=[
                layers.fc(input=word, size=hid, bias_attr=True),
                layers.fc(input=prev_h, size=hid, bias_attr=False)])
            return act(x=g)
        f, i, o = (gate(layers.sigmoid) for _ in range(3))
        g = gate(layers.tanh)
        c = layers.sums(input=[layers.elementwise_mul(x=f, y=prev_c),
                               layers.elementwise_mul(x=i, y=g)])
        h = layers.elementwise_mul(x=o, y=layers.tanh(x=c))
        rnn.update_memory(prev_h, h)
        rnn.update_memory(prev_c, c)
        rnn.output(h)
    out = rnn()
    return out, layers.mean(out)


def test_dynamic_rnn_matches_jax_with_hoisting_and_merging(monkeypatch):
    """The port hoists the cell's four input projections (mul + bias)
    out of the loop and merges its four h-projections into one product;
    the outputs, their @SEQ_LEN and every @GRAD match the JAX package's
    (which hoists on the CPU too), and match the port with both
    transforms off."""
    seen = {}
    hoist, merge = rnn_ops._hoist, rnn_ops._merge_muls

    def spy_hoist(*a):
        seen["hoisted"] = hoist(*a)[0]
        return hoist(*a)

    def spy_merge(*a):
        seen["merged"] = merge(*a)[0]
        return seen["merged"], merge(*a)[1]
    monkeypatch.setattr(rnn_ops, "_hoist", spy_hoist)
    monkeypatch.setattr(rnn_ops, "_merge_muls", spy_merge)

    def build(layers):
        out, loss = _cell_program(layers)
        return (out,), loss

    def fetch(outs):
        return [outs[0], outs[0].name + "@SEQ_LEN"]
    got, rerun = _compare_programs(build, _ragged_feed(8), fetch)
    np.testing.assert_array_equal(got[1], LENS)
    assert len(seen["hoisted"]) == 8          # 4 muls + 4 bias adds
    assert len(seen["merged"]) == 4           # the 4 h-projections
    # past its length a row outputs 0
    for b, n in enumerate(LENS):
        assert not got[0][b, n:].any()
    # both transforms off: the same numbers
    monkeypatch.setattr(rnn_ops, "HOISTABLE", set())
    monkeypatch.setattr(rnn_ops, "_merge_muls", lambda *a: ({}, {}))
    for a, b_ in zip(rerun(), got):
        np.testing.assert_allclose(a, b_, rtol=1e-5, atol=1e-6)


def test_static_rnn_matches_jax():
    """StaticRNN steps over every time step: the lengths fed beside its
    input mask nothing."""
    def build(layers):
        x = _x(layers, 8)
        rnn = layers.StaticRNN()
        with rnn.step():
            word = rnn.step_input(x)
            prev = rnn.memory(shape=[8], value=0.5)
            h = layers.tanh(x=layers.sums(input=[
                layers.fc(input=word, size=8),
                layers.fc(input=prev, size=8, bias_attr=False)]))
            rnn.update_memory(prev, h)
            rnn.output(h)
        out = rnn()
        return (out,), layers.mean(out)
    got, _ = _compare_programs(build, _ragged_feed(8))
    assert got[0][5, 1:].any()                  # past LENS[5] == 1
    main = fluid.default_main_program()
    op = next(o for o in main.global_block().ops if o.type == "dynamic_rnn")
    assert op.desc.attrs["dynamic"] is False


def test_program_json_round_trip_with_a_sub_block():
    """The step block's parent_idx and the dynamic_rnn attrs (lists of
    pairs, lists of dicts) survive the JSON; the parsed program (pairs now
    lists) serializes the same, parses in the JAX package and runs to the
    same output."""
    out, _ = _cell_program(players)
    main = fluid.default_main_program()
    s = main.serialize_to_string()
    parsed = fluid.Program.parse_from_string(s)
    assert [b.parent_idx for b in parsed.blocks] == [-1, 0]
    op = next(o for o in parsed.global_block().ops
              if o.type == "dynamic_rnn")
    assert all(isinstance(p, list) for p in op.desc.attrs["step_inputs"])
    assert parsed.serialize_to_string() == s
    assert jfluid.Program.parse_from_string(s).serialize_to_string() == s
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    feed = _ragged_feed(8)
    (a,) = exe.run(main, feed=feed, fetch_list=[out])
    (b_,) = exe.run(parsed, feed=feed, fetch_list=[out.name])
    np.testing.assert_array_equal(a, b_)


def test_output_read_only_inside_a_step_block_survives():
    """softmax_with_cross_entropy computes its Softmax output only when
    something reads it; here only an op inside the DynamicRNN's step
    block does, and the interpreter must count it as read."""
    def build(layers):
        x = _x(layers, 8)
        feat = layers.data(name="feat", shape=[8], dtype="float32")
        logits = layers.fc(input=feat, size=8)
        label = layers.data(name="label", shape=[1], dtype="int64")
        loss, sm = layers.softmax_with_cross_entropy(logits, label,
                                                     return_softmax=True)
        rnn = layers.DynamicRNN()
        with rnn.block():
            word = rnn.step_input(x)
            rnn.output(layers.elementwise_add(x=word, y=sm))
        out = rnn()
        return (out,), layers.mean(out)
    feed = dict(_ragged_feed(8),
                feat=np.random.RandomState(5).randn(B, 8).astype(
                    np.float32),
                label=np.arange(B, dtype=np.int64)[:, None] % 8)
    got = _compare_programs(build, feed)[0][0]
    assert np.abs(got).max() > 0
