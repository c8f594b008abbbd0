"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its kernel's plain PyTorch version
(the CUDA kernels are held against those same plain versions on the card
by chip_smoke.py); the JAX side runs the Pallas kernels in interpret
mode.  Inputs are made with numpy from a fixed seed and handed to both.

Tolerances (max abs error): f32 2e-5 — the same f32 math summed in
another order; bf16 2e-2 — tests/test_pallas_kernels.py's bf16 tolerance,
outputs rounded to bf16 at slightly different places.  Gradients, whose
magnitude grows with the rows summed, are held to the same tolerances
times max(1, max |want|).

Each autograd Function is also held to finite differences by
``torch.autograd.gradcheck`` in f64 (the plain versions compute in f64
for f64 inputs).  The BatchNorm backward is held against the Pallas
kernel where it applies (channels-last, C a multiple of 128) and against
the JAX package's XLA closed form elsewhere (NCHW, C=64).
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops.nn_ops import _bn_train_core
from paddle_tpu.ops.pallas_kernels import (_flash_backward, _flash_forward,
                                           _ln_pallas_bwd,
                                           _sm_xent_pallas_bwd,
                                           _sm_xent_pallas_fwd,
                                           bn_bwd_onepass,
                                           fused_layer_norm,
                                           paged_attention_pallas)
from paddle_tpu_torch.ops import kernels as K

LN_SHAPES = [(16, 128), (5, 37), (130, 768), (7, 257), (256, 1000)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(a, dtype):
    """numpy f32 array -> (jax array, torch tensor), both in ``dtype``."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(a, b, tol, rel=False):
    a, b = _np(a), _np(b)
    if rel:
        tol = tol * max(1.0, float(np.max(np.abs(b[np.isfinite(b)]),
                                          initial=0.0)))
    assert a.shape == b.shape
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin)
    assert np.array_equal(a[~fin], b[~fin])        # same infinities
    err = float(np.max(np.abs(a[fin] - b[fin]))) if fin.any() else 0.0
    assert err <= tol, err


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_len,pages", [(4, 3), (8, 2), (4, 1)])
def test_paged_attention_matches_pallas(dtype, block_len, pages):
    rng = np.random.RandomState(0)
    s, h, d = 5, 2, 16
    n = s * pages
    q = rng.randn(s, h, 1, d).astype(np.float32)
    pk = rng.randn(n, block_len, h, d).astype(np.float32)
    pv = rng.randn(n, block_len, h, d).astype(np.float32)
    # slot 0 full, slot 1 ragged, slot 2 idle (all-sentinel row, index
    # 0), slot 3 one position, slot 4 ragged with sentinel tail pages
    cap = pages * block_len
    index = np.array([cap - 1, cap // 2, 0, 0, block_len - 2], np.int32)
    table = np.full((s, pages), n, np.int32)
    perm = rng.permutation(n).astype(np.int32)
    for i in (0, 1, 3, 4):
        need = index[i] // block_len + 1
        table[i, :need] = perm[i * pages:i * pages + need]
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(pk, dtype)
    jv, tv = _pair(pv, dtype)
    want = paged_attention_pallas(jq, jk, jv, jnp.asarray(table),
                                  jnp.asarray(index), interpret=True)
    got = K.paged_attention(tq, tk, tv, torch.from_numpy(table),
                            torch.from_numpy(index))
    assert got.dtype == tq.dtype
    _close(got, want, TOL[dtype])


# ---------------------------------------------------------------------------
# FlashAttention forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq,tk,causal", [
    (16, 16, True), (16, 16, False), (8, 24, True), (8, 24, False),
    (24, 16, True)])      # tq > tk causal: the top rows see no key
def test_flash_forward_matches_pallas(dtype, tq, tk, causal):
    rng = np.random.RandomState(1)
    b, h, d = 2, 2, 16
    q = rng.randn(b, h, tq, d).astype(np.float32)
    k = rng.randn(b, h, tk, d).astype(np.float32)
    v = rng.randn(b, h, tk, d).astype(np.float32)
    jq, tq_ = _pair(q, dtype)
    jk, tk_ = _pair(k, dtype)
    jv, tv = _pair(v, dtype)
    want_out, want_lse = _flash_forward(jq, jk, jv, causal, 8, 8,
                                        interpret=True)
    got_out, got_lse = K.flash_attention_fwd(tq_, tk_, tv, causal)
    assert got_out.dtype == tq_.dtype and got_lse.dtype == torch.float32
    _close(got_out, want_out, TOL[dtype])
    _close(got_lse, np.asarray(want_lse).reshape(b, h, tq), 2e-5 if
           dtype == "float32" else 1e-4)


def test_flash_forward_ragged_length_one():
    """Prefill goes down to one token: T=1 is the plain self-attention
    of that token (out == v)."""
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(1, 3, 1, 16).astype(np.float32))
               for _ in range(3))
    out, lse = K.flash_attention_fwd(q, k, v, causal=True)
    np.testing.assert_allclose(out.numpy(), v.numpy(), atol=1e-6)
    np.testing.assert_allclose(
        lse.numpy(), (q * k).sum(-1).numpy() / 4.0, atol=1e-5)


# ---------------------------------------------------------------------------
# LayerNorm forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", LN_SHAPES)
def test_layer_norm_matches_pallas(dtype, shape):
    rng = np.random.RandomState(3)
    r, f = shape
    x = (2.0 * rng.randn(r, f) + 0.5).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(f)).astype(np.float32)
    bias = (0.1 * rng.randn(f)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    wy, wmean, wvar = fused_layer_norm(jx, jnp.asarray(scale),
                                       jnp.asarray(bias), 1e-5, True)
    gy, gmean, gvar = K.layer_norm_fwd(tx, torch.from_numpy(scale),
                                       torch.from_numpy(bias), 1e-5)
    assert gy.dtype == tx.dtype and gmean.dtype == torch.float32
    _close(gy, wy, TOL[dtype])
    # statistics are f32 in both, from identical (bf16-rounded) inputs
    _close(gmean, wmean, 2e-5)
    _close(gvar, wvar, 1e-4)


# ---------------------------------------------------------------------------
# FlashAttention backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq,tk,causal", [
    (16, 16, True), (8, 24, False),
    (24, 16, True)])      # tq > tk causal: fully masked rows get p = 0
def test_flash_backward_matches_pallas(dtype, tq, tk, causal):
    rng = np.random.RandomState(4)
    b, h, d = 2, 2, 16
    q = rng.randn(b, h, tq, d).astype(np.float32)
    k = rng.randn(b, h, tk, d).astype(np.float32)
    v = rng.randn(b, h, tk, d).astype(np.float32)
    g = rng.randn(b, h, tq, d).astype(np.float32)
    jq, tq_ = _pair(q, dtype)
    jk, tk_ = _pair(k, dtype)
    jv, tv = _pair(v, dtype)
    jg, tg = _pair(g, dtype)
    # both backward passes start from the JAX forward's out and lse
    jout, jlse = _flash_forward(jq, jk, jv, causal, 8, 8, interpret=True)
    want = _flash_backward(jq, jk, jv, jout, jlse, jg, causal, 8, 8,
                           interpret=True)
    tout = torch.from_numpy(np.array(_np(jout))).to(tq_.dtype)
    tlse = torch.from_numpy(np.array(jlse).reshape(b, h, tq))
    got = K.flash_attention_bwd(tq_, tk_, tv, tout, tlse, tg, causal)
    for gt, wt in zip(got, want):
        assert gt.dtype == tq_.dtype
        _close(gt, wt, TOL[dtype], rel=True)


# ---------------------------------------------------------------------------
# the flash kernels' numerics on the tensor cores, emulated on the CPU
# ---------------------------------------------------------------------------
#
# The CUDA flash kernels run every product on the tensor cores: bf16
# inputs through bf16 mma with p and ds rounded to bf16 as product
# operands, f32 inputs through 3xTF32.  These helpers repeat that
# arithmetic in torch on the CPU (they are test code, never on the main
# path) to pin the choice before any card runs it.

F32_TOL = 2e-5      # chip_smoke.py's tolerance of an f32 kernel output


def _tf32(x):
    """``cvt.rna.tf32.f32`` on f32 bit patterns: round to nearest, ties
    away from zero, to 10 mantissa bits (the low 13 bits cleared)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_rz(x):
    """The tf32 bits the tensor core reads from an f32 register: the low
    13 bits dropped (round toward zero)."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def _rz_f32(x):
    """f64 -> f32 rounded toward zero."""
    r = x.float()
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _mm_tf32(passes, fadd_every=None):
    """a @ b from tf32 operands as the kernels form it: one pass (hi.hi)
    or 3xTF32 (lo.hi + hi.lo + hi.hi, with hi = tf32(x) rounded to
    nearest and lo = x - hi read by the tensor core as tf32 by
    truncation), one mma per 8 columns of k and term.

    The accumulation follows the kernels too, under a model of the tensor
    cores' adder: each mma adds its 8 exact products to the f32
    accumulator and rounds the sum toward zero, not to nearest (the drift
    that made the kernels sum apart).  Every ``fadd_every`` columns of k
    the accumulator starts again from zero and is added to the running sum
    by an f32 add, rounded to nearest: 8 for the forward (each k-step's
    three products summed apart), 32 for the backward's dq, dk and dv
    (`add_pn`, per 32-row step), None for one accumulator over all of k
    (the backward's S and dP).  The model is the bias's direction, not the
    hardware's exact alignment and truncation of the addends."""
    def mm(a, b):
        a, b = a.float(), b.float()
        ah, bh = _tf32(a), _tf32(b)
        terms = [(ah, bh)]
        if passes == 3:
            terms = [(_tf32_rz(a - ah), bh), (ah, _tf32_rz(b - bh)), (ah, bh)]
        kdim = a.shape[-1]
        step = fadd_every or kdim
        total = torch.zeros(a.shape[:-1] + b.shape[-1:])
        for k0 in range(0, kdim, step):
            acc = torch.zeros_like(total)
            for k1 in range(k0, min(k0 + step, kdim), 8):
                for x, y in terms:
                    acc = _rz_f32(acc.double()
                                  + x[..., k1:k1 + 8].double()
                                  @ y[..., k1:k1 + 8, :].double())
            total = total + acc
        return total
    return mm


def _mm_f32(a, b):
    return a.float() @ b.float()


def _bf16_operand(x):
    return x.to(torch.bfloat16).float()


def _causal_mask(tq, tk):
    return torch.ones(tq, tk, dtype=torch.bool).tril(tk - tq)


def _emulated_fwd(q, k, v, causal, mm, operand=lambda x: x):
    """The forward kernel's arithmetic: f32 scores and softmax, exp(s - m)
    left unnormalised and passed through ``operand`` into P.V, divided by
    the f32 row sum at the end; out in q's dtype, lse f32."""
    d, tq, tk = q.shape[-1], q.shape[2], k.shape[2]
    s = mm(q, k.transpose(-1, -2)) / math.sqrt(d)
    if causal:
        s = s.masked_fill(~_causal_mask(tq, tk), float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    out = mm(operand(e), v) / torch.where(l > 0, l, torch.ones_like(l))
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, -math.inf))
    return out.to(q.dtype), lse[..., 0]


def _emulated_bwd(q, k, v, out, lse, do, causal, mm, operand=lambda x: x,
                  mm_grad=None):
    """The backward kernels' arithmetic: p = exp(s - lse) in f32 (0 on a
    fully masked row), ds = p (dO.V^T - delta) / sqrt(D), then dV = P^T.dO,
    dQ = dS.K, dK = dS^T.Q with p and ds passed through ``operand``; S and
    dP by ``mm``, the three gradients by ``mm_grad`` (default ``mm``)."""
    mm_grad = mm_grad or mm
    d, tq, tk = q.shape[-1], q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    s = mm(q, k.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(tq, tk), float("-inf"))
    live = torch.isfinite(lse)[..., None]
    p = torch.where(live, torch.exp(s - torch.where(live, lse[..., None],
                                                    torch.zeros(()))),
                    torch.zeros(()))
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    ds = p * (mm(do, v.transpose(-1, -2)) - delta) * scale
    dv = mm_grad(operand(p).transpose(-1, -2), do)
    dq = mm_grad(operand(ds), k)
    dk = mm_grad(operand(ds).transpose(-1, -2), q)
    return tuple(x.to(q.dtype) for x in (dq, dk, dv))


@pytest.mark.parametrize("tq,tk,causal", [
    (16, 16, True), (16, 16, False), (8, 24, True), (8, 24, False),
    (24, 16, True)])
def test_flash_forward_bf16_rounding_matches_pallas(tq, tk, causal):
    """The card kernel's bf16 rounding points (p rounded as the operand of
    P.V, the row sum in f32) stay within the bf16 tolerance of the Pallas
    kernel, which keeps p in f32."""
    rng = np.random.RandomState(1)
    b, h, d = 2, 2, 16
    q, k, v = (rng.randn(b, h, t, d).astype(np.float32)
               for t in (tq, tk, tk))
    jq, tq_ = _pair(q, "bfloat16")
    jk, tk_ = _pair(k, "bfloat16")
    jv, tv = _pair(v, "bfloat16")
    want_out, want_lse = _flash_forward(jq, jk, jv, causal, 8, 8,
                                        interpret=True)
    got_out, got_lse = _emulated_fwd(tq_, tk_, tv, causal, _mm_f32,
                                     _bf16_operand)
    assert got_out.dtype == torch.bfloat16
    _close(got_out, want_out, TOL["bfloat16"])
    _close(got_lse, np.asarray(want_lse).reshape(b, h, tq), 1e-4)


@pytest.mark.parametrize("tq,tk,causal", [
    (16, 16, True), (8, 24, False), (24, 16, True)])
def test_flash_backward_bf16_rounding_matches_pallas(tq, tk, causal):
    """The same for the backward: p and ds rounded to bf16 only as the
    operands of dV, dQ and dK."""
    rng = np.random.RandomState(4)
    b, h, d = 2, 2, 16
    q = rng.randn(b, h, tq, d).astype(np.float32)
    k = rng.randn(b, h, tk, d).astype(np.float32)
    v = rng.randn(b, h, tk, d).astype(np.float32)
    g = rng.randn(b, h, tq, d).astype(np.float32)
    jq, tq_ = _pair(q, "bfloat16")
    jk, tk_ = _pair(k, "bfloat16")
    jv, tv = _pair(v, "bfloat16")
    jg, tg = _pair(g, "bfloat16")
    jout, jlse = _flash_forward(jq, jk, jv, causal, 8, 8, interpret=True)
    want = _flash_backward(jq, jk, jv, jout, jlse, jg, causal, 8, 8,
                           interpret=True)
    tout = torch.from_numpy(np.array(_np(jout))).to(torch.bfloat16)
    tlse = torch.from_numpy(np.array(jlse).reshape(b, h, tq))
    got = _emulated_bwd(tq_, tk_, tv, tout, tlse, tg, causal, _mm_f32,
                        _bf16_operand)
    for gt, wt in zip(got, want):
        assert gt.dtype == torch.bfloat16
        _close(gt, wt, TOL["bfloat16"], rel=True)


def _tf32_shares(passes, t=128, partial_sums=True):
    """Largest error of the emulated f32 kernels (forward out and lse,
    backward dq, dk, dv) against the f64 plain versions, each as a share
    of F32_TOL * max(1, max |reference|): T ``t``, D 64, causal.  With
    ``partial_sums`` the products are summed apart as the kernels sum them
    (`_mm_tf32`), else each in one accumulator over all of k."""
    g = torch.Generator().manual_seed(21)
    q, k, v, do = (torch.randn(1, 2, t, 64, generator=g)
                   for _ in range(4))
    fwd_every, grad_every = (8, 32) if partial_sums else (None, None)
    out, lse = _emulated_fwd(q, k, v, True, _mm_tf32(passes, fwd_every))
    grads = _emulated_bwd(q, k, v, out, lse, do, True, _mm_tf32(passes),
                          mm_grad=_mm_tf32(passes, grad_every))
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
    rout, rlse = K.flash_attention_fwd_plain(q64, k64, v64, True)
    rgrads = K.flash_attention_bwd_plain(q64, k64, v64, rout, rlse, do64,
                                         True)
    shares = []
    for got, want in zip((out, lse) + grads, (rout, rlse) + rgrads):
        err = float((got.double() - want).abs().max())
        shares.append(err / (F32_TOL * max(1.0, float(want.abs().max()))))
    return shares


def test_flash_3xtf32_is_f32_accurate():
    """3xTF32, the f32 kernels' route, stays within a tenth of F32_TOL of
    the f64 reference in every output."""
    shares = _tf32_shares(3)
    assert max(shares) <= 0.1, shares


def test_flash_tf32_partial_sums_stop_the_drift():
    """Over a thousand keys, products fed straight into one accumulator
    drift, since the tensor cores round their sums toward zero: most of
    F32_TOL.  Summed apart and added to nearest, as the kernels do, they
    stay near a tenth of it."""
    straight = _tf32_shares(3, t=1024, partial_sums=False)
    kernels = _tf32_shares(3, t=1024)
    assert max(straight) > 0.5, straight
    assert max(kernels) <= 0.2, kernels


def test_flash_single_tf32_pass_misses_f32_tol():
    """One TF32 pass (11 bits per operand) would break F32_TOL: the reason
    the f32 kernels take three."""
    shares = _tf32_shares(1)
    assert max(shares) > 1.0, shares


def test_tf32_rounding_is_round_to_nearest_away():
    """The emulated cvt.rna: 10 mantissa bits kept, a tie rounds away from
    zero, the rest to nearest."""
    one = 1.0
    ulp = 2.0 ** -10                      # a tf32 step at 1.0
    x = torch.tensor([one, one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0], dtype=torch.float32)
    want = torch.tensor([one, one + ulp, -(one + ulp), one, one + ulp, 3.0])
    assert torch.equal(_tf32(x), want)
    y = torch.randn(1000, generator=torch.Generator().manual_seed(3))
    assert float(((_tf32(y) - y).abs() / y.abs()).max()) <= 2.0 ** -11


# ---------------------------------------------------------------------------
# LayerNorm backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 37), (130, 768), (7, 257)])
def test_layer_norm_backward_matches_pallas(dtype, shape):
    rng = np.random.RandomState(5)
    r, f = shape
    x = (2.0 * rng.randn(r, f) + 0.5).astype(np.float32)
    dy = rng.randn(r, f).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(f)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jdy, tdy = _pair(dy, dtype)
    # the saved statistics of the JAX forward feed both
    _, mean, var = fused_layer_norm(jx, jnp.asarray(scale),
                                    jnp.zeros(f, jnp.float32), 1e-5, True)
    inv = 1.0 / np.sqrt(np.asarray(var) + 1e-5)
    want = _ln_pallas_bwd(jx, jnp.asarray(scale), mean, jnp.asarray(inv),
                          jdy, interpret=True)
    got = K.layer_norm_bwd(tx, torch.from_numpy(scale),
                           torch.from_numpy(np.array(mean)),
                           torch.from_numpy(inv), tdy)
    assert got[0].dtype == tx.dtype
    assert got[1].dtype == got[2].dtype == torch.float32
    _close(got[0], want[0], TOL[dtype], rel=True)
    # dscale and dbias are f32 sums over the rows in both
    _close(got[1], want[1], 2e-5, rel=True)
    _close(got[2], want[2], 2e-5, rel=True)


# ---------------------------------------------------------------------------
# softmax cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,v", [(16, 128), (7, 37), (24, 1000)])
def test_softmax_xent_matches_pallas(dtype, r, v):
    rng = np.random.RandomState(6)
    x = (3.0 * rng.randn(r, v)).astype(np.float32)
    lab = rng.randint(0, v, r).astype(np.int32)
    lab[1], lab[4] = -1, v                     # out of range: gold 0
    dloss = rng.rand(r).astype(np.float32)
    jx, tx = _pair(x, dtype)
    wloss, wlse = _sm_xent_pallas_fwd(jx, jnp.asarray(lab), interpret=True)
    gloss, glse = K.softmax_xent_fwd(tx, torch.from_numpy(lab))
    assert gloss.dtype == glse.dtype == torch.float32
    # f32 statistics from identical (bf16-rounded) logits in both
    _close(gloss, wloss, 2e-5, rel=True)
    _close(glse, wlse, 2e-5, rel=True)
    wdx = _sm_xent_pallas_bwd(jx, jnp.asarray(lab), wlse,
                              jnp.asarray(dloss), interpret=True)
    gdx = K.softmax_xent_bwd(tx, torch.from_numpy(lab), glse,
                             torch.from_numpy(dloss))
    assert gdx.dtype == tx.dtype
    _close(gdx, wdx, TOL[dtype])


def test_softmax_xent_extreme_logits():
    """+-1e4 logits saturate exp without overflow (the Pallas kernel's
    online softmax test)."""
    x = np.array([[1e4, 0.0, -1e4, 5.0] * 32, [-1e4] * 128], np.float32)
    lab = np.array([0, 3], np.int32)
    wloss, _ = _sm_xent_pallas_fwd(jnp.asarray(x), jnp.asarray(lab),
                                   interpret=True)
    gloss, _ = K.softmax_xent_fwd(torch.from_numpy(x), torch.from_numpy(lab))
    assert np.isfinite(gloss.numpy()).all()
    np.testing.assert_allclose(gloss.numpy(), np.asarray(wloss), atol=1e-3,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# BatchNorm training backward
# ---------------------------------------------------------------------------

def _bn_case(rng, shape, c, dtype, axes):
    """Seeded x, dy and per-channel vectors; mean and inv are the batch
    statistics of x as rounded to ``dtype``, shared by both sides."""
    x = (2.0 * rng.randn(*shape) + 0.5).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    scale = (1.0 + 0.3 * rng.randn(c)).astype(np.float32)
    bias = (0.5 * rng.randn(c)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jdy, tdy = _pair(dy, dtype)
    xr = _np(tx)
    mean = xr.mean(axis=axes)
    inv = (1.0 / np.sqrt(xr.var(axis=axes) + 1e-5)).astype(np.float32)
    return jx, tx, jdy, tdy, scale, bias, mean.astype(np.float32), inv


def _bn_check(got, want, dtype, tx):
    dx, dscale, dbias = got
    assert dx.dtype == tx.dtype
    assert dscale.dtype == dbias.dtype == torch.float32
    _close(dx, want[0], TOL[dtype], rel=True)
    # dscale and dbias are f32 sums of the same (rounded) inputs in both
    _close(dscale, want[1], 2e-5, rel=True)
    _close(dbias, want[2], 2e-5, rel=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,c", [(64, 128), (256, 128), (64, 256),
                                 (256, 256)])
@pytest.mark.parametrize("act", [None, "relu"])
def test_batch_norm_backward_matches_pallas(dtype, r, c, act):
    """Channels-last [R, C] rows, the shapes the Pallas kernel takes."""
    rng = np.random.RandomState(7)
    jx, tx, jdy, tdy, scale, bias, mean, inv = _bn_case(rng, (r, c), c,
                                                        dtype, 0)
    want = bn_bwd_onepass(jx, jdy, jnp.asarray(scale), jnp.asarray(bias),
                          jnp.asarray(mean), jnp.asarray(inv), act,
                          interpret=True)
    got = K.batch_norm_bwd(tx.reshape(r, c, 1), tdy.reshape(r, c, 1),
                           *(torch.from_numpy(a)
                             for a in (scale, bias, mean, inv)), act)
    _bn_check((got[0].reshape(r, c),) + got[1:], want, dtype, tx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("act", [None, "relu"])
def test_batch_norm_backward_matches_jax_closed_form(dtype, layout, act):
    """C=64, and NCHW: what the Pallas kernel does not take, held against
    the XLA closed form of ``_bn_train_core``'s VJP."""
    rng = np.random.RandomState(8)
    n, c, h, w = 3, 64, 5, 7
    if layout == "NCHW":
        shape, ch, axes, view = (n, c, h, w), 1, (0, 2, 3), (n, c, h * w)
    else:
        shape, ch, axes, view = (n, h, w, c), 3, (0, 1, 2), (n * h * w, c, 1)
    jx, tx, jdy, tdy, scale, bias, mean, inv = _bn_case(rng, shape, c,
                                                        dtype, axes)
    _, vjp = jax.vjp(lambda a, s, b: _bn_train_core(
        a, s, b, jnp.asarray(mean), jnp.asarray(inv), (ch, axes, act)),
        jx, jnp.asarray(scale), jnp.asarray(bias))
    want = vjp(jdy)
    got = K.batch_norm_bwd(tx.reshape(view), tdy.reshape(view),
                           *(torch.from_numpy(a)
                             for a in (scale, bias, mean, inv)), act)
    _bn_check((got[0].reshape(shape),) + got[1:], want, dtype, tx)


@pytest.mark.parametrize("shape", [
    (1605632, 64, 1), (128, 64, 12544), (401408, 256, 1), (6272, 2048, 1),
    (128, 2048, 49), (1000, 96, 1), (8, 96, 125), (1, 1, 1), (3, 5, 2000)])
def test_batch_norm_backward_tiling(shape):
    """The tiling the wrapper hands the kernel meets the launcher's
    checks at ResNet-50's shapes and ragged ones: a tile of at most 1024
    elements, whole tiles of rows per chunk, chunks that cover the rows
    with none empty, grid dimensions within CUDA's limits."""
    rows, c, s = shape
    nb, cb, sb, per, chunks = K.bn_bwd_geometry(rows, c, s, 1056)
    assert nb * cb * sb <= K._BN_TILE and min(nb, cb, sb) >= 1
    assert per % nb == 0
    assert (chunks - 1) * per < rows <= chunks * per
    assert -(-c // cb) <= 65535 and -(-s // sb) <= 65535
    assert chunks * -(-c // cb) * -(-s // sb) <= 2 * 1056 or chunks == 1


# ---------------------------------------------------------------------------
# autograd Functions against finite differences
# ---------------------------------------------------------------------------

def _f64(*shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64,
                       requires_grad=True)


@pytest.mark.parametrize("tq,tk,causal", [(3, 6, True), (6, 3, True),
                                          (4, 5, False)])
def test_flash_attention_function_gradcheck(tq, tk, causal):
    q, k, v = _f64(1, 2, tq, 8, seed=1), _f64(1, 2, tk, 8, seed=2), \
        _f64(1, 2, tk, 8, seed=3)
    assert torch.autograd.gradcheck(
        lambda a, b, c: K.FlashAttention.apply(a, b, c, causal), (q, k, v))


def test_layer_norm_function_gradcheck():
    x, s, b = _f64(4, 9, seed=4), _f64(9, seed=5), _f64(9, seed=6)
    assert torch.autograd.gradcheck(
        lambda a, c, d: K.LayerNorm.apply(a, c, d, 1e-5)[0], (x, s, b))


def test_softmax_xent_function_gradcheck():
    x = _f64(5, 9, seed=7)
    lab = torch.tensor([1, 8, 0, -1, 9])        # two labels out of range
    assert torch.autograd.gradcheck(
        lambda a: K.SoftmaxXent.apply(a, lab), (x,))


@pytest.mark.parametrize("act", [None, "relu"])
def test_batch_norm_function_gradcheck(act):
    """Finite differences recompute the batch statistics from x, as the
    op rule does; the closed-form backward must account for them."""
    def f(x, s, b):
        with torch.no_grad():
            mean = x.mean(dim=(0, 2))
            inv = torch.rsqrt(x.var(dim=(0, 2), unbiased=False) + 1e-5)
        return K.BatchNormTrain.apply(x, s, b, mean, inv, act)
    x, s, b = _f64(4, 3, 5, seed=8), _f64(3, seed=9), _f64(3, seed=10)
    assert torch.autograd.gradcheck(f, (x, s, b))


def test_wrappers_count_only_kernel_launches():
    """On the CPU the plain version runs and no kernel launch is
    counted."""
    K.reset_launches()
    x = torch.randn(4, 32)
    K.layer_norm_fwd(x, torch.ones(32), torch.zeros(32))
    q = torch.randn(1, 2, 3, 32)
    K.flash_attention_fwd(q, q, q, True)
    y, mean, var = K.LayerNorm.apply(x.requires_grad_(), torch.ones(32),
                                     torch.zeros(32), 1e-5)
    y.sum().backward()
    out = K.FlashAttention.apply(q.requires_grad_(), q, q, True)
    out.sum().backward()
    loss = K.SoftmaxXent.apply(x, torch.tensor([0, 1, 2, 3]))
    loss.sum().backward()
    x3 = torch.randn(4, 3, 2, requires_grad=True)
    K.BatchNormTrain.apply(x3, torch.ones(3), torch.zeros(3), torch.zeros(3),
                           torch.ones(3), "relu").sum().backward()
    assert all(k.launches == 0 for k in K.KERNELS)
