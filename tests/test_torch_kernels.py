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


LOG2E = 1.4426950408889634
#: the split kernel's warps and the combine kernel's groups of splits
#: (kWarps, kCombineGroups in csrc/paged_attention.cu)
PAGED_WARPS, PAGED_COMBINE_GROUPS = 4, 16


def _fold(state, sc, v):
    """One position into a running (m, l, acc) per head, log2 units."""
    m, l, acc = state
    m_new = torch.maximum(m, sc)
    alpha = torch.exp2(m - m_new)
    p = torch.exp2(sc - m_new)
    return m_new, l * alpha + p, acc * alpha[:, None] + p[:, None] * v


def _merge(states, groups=1):
    """(m, l, acc) states of one head set merged at their common max;
    with ``groups``, group g first sums states g, g + groups, ... and the
    groups' sums are added in order (the combine kernel's order)."""
    mx = torch.stack([m for m, _, _ in states]).amax(0)
    parts = [states[g::groups] for g in range(min(groups, len(states)))]
    l = sum(sum(l * torch.exp2(m - mx) for m, l, _ in p) for p in parts)
    acc = sum(sum(a * torch.exp2(m - mx)[:, None] for m, _, a in p)
              for p in parts)
    return mx, l, acc


def _paged_split_emulation(q, pk, pv, table, index):
    """The split-K paged-attention kernel's arithmetic in plain f32 torch:
    for each slot, each live split of `K.paged_geometry`'s length, warp w
    folds positions t0 + w, t0 + w + 4, ... one at a time into its
    (m, l, acc); the warps merge, then the combine merges the live
    splits in its groups.  Sentinel pages clamp to the last block; no
    live position gives 0."""
    s, h, _, d = q.shape
    n, block_len = pk.shape[:2]
    pages = table.shape[1]
    split = K.paged_geometry(s, h, d, pages, block_len,
                             q.element_size())[0]
    qf = q.float()[:, :, 0, :] * (LOG2E / math.sqrt(d))
    out = torch.zeros(s, h, d)
    for slot in range(s):
        last = min(int(index[slot]), pages * block_len - 1)
        splits = []
        for t0 in range(0, last + 1, split):
            warps = []
            for w in range(PAGED_WARPS):
                state = (torch.full((h,), -math.inf), torch.zeros(h),
                         torch.zeros(h, d))
                for t in range(t0 + w, min(t0 + split, last + 1),
                               PAGED_WARPS):
                    page = min(max(int(table[slot, t // block_len]), 0),
                               n - 1)
                    k = pk[page, t % block_len].float()
                    v = pv[page, t % block_len].float()
                    state = _fold(state, (qf[slot] * k).sum(-1), v)
                warps.append(state)
            splits.append(_merge(warps))
        if splits:
            _, l, acc = _merge(splits, PAGED_COMBINE_GROUPS)
            out[slot] = acc / l[:, None]
    return out[:, :, None, :].to(q.dtype)


#: (slots, heads, head_dim, block_len, pages, index): cases with several
#: splits a slot (split 16 in the first two, 64 in the third), splits
#: wholly past the index, indexes on page edges (3, 16, 31, 32) and split
#: edges (15, 16, 63, 64), an idle slot (index 0, sentinel row), index -1
#: (no live position) and an index past the table's capacity
PAGED_SPLIT_CASES = [
    (7, 2, 16, 4, 12, [47, 15, 16, 3, 0, -1, 60]),
    (3, 12, 64, 16, 8, [127, 100, 16]),
    (9, 4, 32, 32, 64, [2047, 63, 64, 1000, 0, -1, 31, 32, 3000]),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(PAGED_SPLIT_CASES)))
def test_paged_split_emulation_matches_pallas(dtype, case):
    s, h, d, block_len, pages, index = PAGED_SPLIT_CASES[case]
    rng = np.random.RandomState(10 + case)
    n = s * pages
    index = np.asarray(index, np.int32)
    table = np.full((s, pages), n, np.int32)
    perm = rng.permutation(n).astype(np.int32)
    for i in range(s):
        if index[i] > 0:
            need = min(index[i] // block_len + 1, pages)
            table[i, :need] = perm[i * pages:i * pages + need]
    q = rng.randn(s, h, 1, d).astype(np.float32)
    pk = rng.randn(n, block_len, h, d).astype(np.float32)
    pv = rng.randn(n, block_len, h, d).astype(np.float32)
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(pk, dtype)
    jv, tv = _pair(pv, dtype)
    want = paged_attention_pallas(jq, jk, jv, jnp.asarray(table),
                                  jnp.asarray(index), interpret=True)
    got = _paged_split_emulation(tq, tk, tv, torch.from_numpy(table),
                                 torch.from_numpy(index))
    split, n_splits = K.paged_geometry(s, h, d, pages, block_len,
                                       tq.element_size())[:2]
    live = [min(i, pages * block_len - 1) // split + 1 if i >= 0 else 0
            for i in index]
    assert max(live) > 1 and min(live) < n_splits
    assert got.dtype == tq.dtype
    assert not got[index < 0].any()
    _close(got, want, TOL[dtype])
    # and the port's plain version, which the card's kernel is held to
    _close(got, K.paged_attention(tq, tk, tv, torch.from_numpy(table),
                                  torch.from_numpy(index)), TOL[dtype])


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("slots,heads,head_dim,pages,block_len", [
    (16, 12, 64, 128, 16), (1, 12, 64, 128, 16), (4, 8, 128, 32, 16),
    (5, 2, 16, 3, 4), (1, 32, 128, 128, 16), (64, 12, 64, 128, 16)])
def test_paged_geometry(itemsize, slots, heads, head_dim, pages, block_len):
    split, n_splits, hpb, floats = K.paged_geometry(
        slots, heads, head_dim, pages, block_len, itemsize)
    capacity = pages * block_len
    assert split in (16, 32, 64)
    assert n_splits == -(-capacity // split)
    assert (n_splits - 1) * split < capacity <= n_splits * split
    lanes_per_head = head_dim * itemsize // 16
    assert hpb * lanes_per_head <= 4 * 32        # kChunks chunks a lane
    groups = -(-heads // hpb)
    # two blocks an SM of the H100's 132 when the table is full, unless
    # the split is already at its shortest
    assert split == 16 or slots * groups * n_splits >= 264
    assert floats == slots * n_splits * heads * (head_dim + 2)


def test_paged_geometry_serving_shape():
    # the served model: 16 slots, 12 heads of 64, 128 pages of 16
    assert K.paged_geometry(16, 12, 64, 128, 16, 2) == (
        64, 32, 12, 16 * 32 * 12 * 66)
    # one long slot: 128 splits of 16 positions
    assert K.paged_geometry(1, 12, 64, 128, 16, 2)[:2] == (16, 128)
    # f32 rows of 12 heads take two head groups of 6
    assert K.paged_geometry(16, 12, 64, 128, 16, 4)[2] == 6


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


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("f,path", [(37, "block"), (768, "warp"),
                                    (1000, "warp"), (1024, "warp"),
                                    (1032, "block"), (3072, "block"),
                                    (30000, "block")])
def test_layer_norm_geometry(itemsize, f, path):
    threads, cache = K.layer_norm_geometry(f, itemsize)
    if path == "warp":
        # one warp a row: at most 1024 features in whole 16-byte chunks
        assert (threads, cache) == (0, 0)
        assert f * itemsize % 16 == 0 and f <= 1024
        # a row that is not 16-byte aligned takes the block path
        assert K.layer_norm_geometry(f, itemsize, False)[0] > 0
    else:
        assert threads == (256 if f >= 1024 else 128)
        # the row stays in shared memory when it fits in 48 KB
        assert cache == (f * itemsize if f * itemsize <= 48 * 1024 else 0)


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


def _ln_bwd_walks(rows, warp, blocks):
    """The rows each walker of the LayerNorm backward visits, in order, by
    block: `layer_norm_bwd_geometry`'s runs of ceil(rows / walkers)
    consecutive rows (a warp a walker on the warp path, _LN_ROW_WARPS a
    block; a block a walker else)."""
    per_block = K._LN_ROW_WARPS if warp else 1
    run = -(-rows // (blocks * per_block))
    return [[list(range(min(rows, (k * per_block + w) * run),
                        min(rows, (k * per_block + w + 1) * run)))
             for w in range(per_block)] for k in range(blocks)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("f,path", [(37, "block"), (768, "warp"),
                                    (1000, "warp"), (1024, "warp"),
                                    (1032, "block"), (3072, "block")])
@pytest.mark.parametrize("rows", [1, 7, 2048, 8192])
def test_layer_norm_backward_geometry(itemsize, f, path, rows):
    """The LayerNorm backward's path as the forward's (warp per row for at
    most 1024 features in whole 16-byte chunks with aligned pointers),
    16-byte loads exactly where the row allows them, a grid of one wave
    of the given residency (4 blocks an SM on 132 SMs) or less when there
    is less work, and a walk that visits every row once."""
    warp, vec, blocks = K.layer_norm_bwd_geometry(rows, f, itemsize, True,
                                                  4, 132)
    whole = f * itemsize % 16 == 0
    assert warp == (path == "warp") == (whole and f <= 1024)
    assert vec == (16 // itemsize if whole else 1)
    # a misaligned pointer takes the block path with element loads
    assert K.layer_norm_bwd_geometry(rows, f, itemsize, False, 4,
                                     132)[:2] == (0, 1)
    work = -(-rows // K._LN_ROW_WARPS) if warp else rows
    assert blocks == min(4 * 132, work) >= 1
    walked = sorted(r for blk in _ln_bwd_walks(rows, warp, blocks)
                    for walk in blk for r in walk)
    assert walked == list(range(rows))


def _ln_bwd_sums_in_kernel_order(x, dy, mean, inv, warp, blocks):
    """dscale and dbias of [R, F] f32 rows summed as layer_norm_bwd.cu
    sums them: each walker (lane columns) adds its rows in walk order,
    a block adds its walkers' sums in order, then the reduce kernel's
    warp w adds blocks w, w + 32, ... and the 32 warp sums are added in
    order."""
    xn = (x - mean[:, None]) * inv[:, None]
    prod = dy * xn
    f = x.shape[1]
    parts = []
    for walkers in _ln_bwd_walks(x.shape[0], warp, blocks):
        a, b = torch.zeros(f), torch.zeros(f)
        for walk in walkers:
            sa, sb = torch.zeros(f), torch.zeros(f)
            for r in walk:
                sa, sb = sa + prod[r], sb + dy[r]
            a, b = a + sa, b + sb
        parts.append((a, b))
    out = [torch.zeros(f), torch.zeros(f)]
    for w in range(32):
        sa, sb = torch.zeros(f), torch.zeros(f)
        for blk in range(w, blocks, 32):
            sa, sb = sa + parts[blk][0], sb + parts[blk][1]
        out = [out[0] + sa, out[1] + sb]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1000, 768), (300, 1032), (257, 37)])
def test_layer_norm_backward_sum_order_matches_pallas(dtype, shape):
    """dscale and dbias in the LayerNorm backward kernel's order of
    summation (lane over its walk, warps in order, blocks in the reduce
    kernel's order), on the path and grid the wrapper gives (12 blocks an
    SM on 4 SMs: 48 blocks, more than the reduce kernel's 32 warps),
    against the Pallas backward (interpret
    mode) and the plain version: f32 sums over the rows in all three,
    2e-5 x max(1, max |want|)."""
    rng = np.random.RandomState(9)
    r, f = shape
    x = (2.0 * rng.randn(r, f) + 0.5).astype(np.float32)
    dy = rng.randn(r, f).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(f)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jdy, tdy = _pair(dy, dtype)
    _, mean, var = fused_layer_norm(jx, jnp.asarray(scale),
                                    jnp.zeros(f, jnp.float32), 1e-5, True)
    inv = 1.0 / np.sqrt(np.asarray(var) + 1e-5)
    warp, _, nb = K.layer_norm_bwd_geometry(r, f, tx.element_size(), True,
                                            12, 4)
    assert nb == 48
    got = _ln_bwd_sums_in_kernel_order(
        tx.float(), tdy.float(), torch.from_numpy(np.array(mean)),
        torch.from_numpy(inv), warp, nb)
    want = _ln_pallas_bwd(jx, jnp.asarray(scale), mean, jnp.asarray(inv),
                          jdy, interpret=True)
    plain = K.layer_norm_bwd_plain(tx, torch.from_numpy(scale),
                                   torch.from_numpy(np.array(mean)),
                                   torch.from_numpy(inv), tdy)
    for g, wv, pv in zip(got, want[1:], plain[1:]):
        _close(g, wv, 2e-5, rel=True)
        _close(g, pv, 2e-5, rel=True)


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


# The forward kernel's arithmetic (csrc/softmax_xent.cu), modelled in
# torch: a block of 256 threads a row; the elements before the row's first
# 16-byte boundary and past its last whole vector as one first chunk of two
# values a thread; then chunks of 32 values, thread t taking vectors
# t + 256 u of each run of 256 * 32 / VEC vectors; per chunk one max and at
# most one rescale of the thread's (m2, s) in base 2, each term
# 2^fma(x, log2 e, -m2); a warp butterfly of the pairs, then warp 0's over
# the 8 warps' pairs; lse = (m2 + log2 s) ln 2.
_XENT_THREADS, _XENT_CHUNK = 256, 32
_LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
_LN2 = torch.tensor(0.6931471805599453, dtype=torch.float32)


def _fma32(a, b, c):
    """f32 a * b + c with the product exact (in f64) and one rounding to
    f32 (through f64: a model of FFMA, off by at most an ulp)."""
    return (a.double() * b.double() + c.double()).float()


def _xent_fold(m2, s, chunk):
    """Fold each thread's chunk [threads, n] into its (m2, s)."""
    cm = chunk.max(dim=1).values
    ok = cm > -math.inf
    cm2 = cm * _LOG2E
    up = ok & (cm2 > m2)
    s = torch.where(up, s * torch.exp2(m2 - cm2), s)
    m2 = torch.where(up, cm2, m2)
    terms = torch.exp2(_fma32(chunk, _LOG2E, -m2[:, None]))
    for e in range(chunk.shape[1]):
        s = torch.where(ok, s + terms[:, e], s)
    return m2, s


def _xent_butterfly(m2, s):
    """The warp butterfly over each run of 32 lanes."""
    lane = torch.arange(m2.shape[0])
    for o in (16, 8, 4, 2, 1):
        om2, os = m2[lane ^ o], s[lane ^ o]
        mx = torch.maximum(m2, om2)
        ok = mx > -math.inf
        both = s * torch.exp2(m2 - mx) + os * torch.exp2(om2 - mx)
        s, m2 = torch.where(ok, both, s), torch.where(ok, mx, m2)
    return m2, s


def _xent_fwd_kernel_model(x, lab):
    """(loss, lse) as the forward kernel computes them, for a tensor whose
    storage starts 16-byte aligned."""
    r, v = x.shape
    item = x.element_size()
    vec = 16 // item
    loads = _XENT_CHUNK // vec
    t = torch.arange(_XENT_THREADS)
    ninf = torch.full((_XENT_THREADS,), -math.inf)
    loss, lse = torch.empty(r), torch.empty(r)
    for i in range(r):
        row = x[i].float()
        head = min(v, (16 - i * v * item % 16) % 16 // item)
        nvec = (v - head) // vec
        tail0 = head + nvec * vec
        chunks = [torch.stack([
            torch.where(t < head, row[t.clamp(max=v - 1)], ninf),
            torch.where(tail0 + t < v, row[(tail0 + t).clamp(max=v - 1)],
                        ninf)], dim=1)]
        body = row[head:tail0].reshape(nvec, vec)
        for base in range(0, nvec, _XENT_THREADS * loads):
            j = base + torch.arange(loads)[:, None] * _XENT_THREADS + t
            vals = torch.where((j < nvec)[..., None],
                               body[j.clamp(max=nvec - 1)], -math.inf)
            chunks.append(vals.permute(1, 0, 2).reshape(_XENT_THREADS, -1))
        m2, s = ninf.clone(), torch.zeros(_XENT_THREADS)
        for chunk in chunks:
            m2, s = _xent_fold(m2, s, chunk)
        m2, s = _xent_butterfly(m2, s)
        n_warps = _XENT_THREADS // 32
        m2, s = _xent_butterfly(
            torch.cat([m2[::32], torch.full((32 - n_warps,), -math.inf)]),
            torch.cat([s[::32], torch.zeros(32 - n_warps)]))
        lse[i] = (m2[0] + torch.log2(s[0])) * _LN2 \
            if m2[0] > -math.inf else -math.inf
        g = int(lab[i])
        loss[i] = lse[i] - (row[g] if 0 <= g < v else 0.0)
    return loss, lse


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,v", [(16, 30000), (7, 1001)])
def test_softmax_xent_fwd_kernel_arithmetic_matches_pallas(dtype, r, v):
    """The forward kernel's chunked base-2 online softmax stays within
    F32_TOL of the Pallas kernel, on rows of +-1e4 logits, a row of -inf,
    labels out of range and, at V 1001, rows whose starts are not 16-byte
    aligned."""
    rng = np.random.RandomState(15)
    x = (3.0 * rng.randn(r, v)).astype(np.float32)
    x[0, ::3], x[0, 1::5] = 1e4, -1e4      # saturates the exp
    x[2, :] = -1e4
    x[2, 7] = 1e4
    x[3, :] = -np.inf                      # no term: lse -inf
    x[4, ::2] = -np.inf
    lab = rng.randint(0, v, r).astype(np.int32)
    lab[1], lab[3] = -1, v                 # out of range: gold 0
    jx, tx = _pair(x, dtype)
    wloss, wlse = _sm_xent_pallas_fwd(jx, jnp.asarray(lab), interpret=True)
    gloss, glse = _xent_fwd_kernel_model(tx, torch.from_numpy(lab))
    assert np.isneginf(_np(glse)[3]) and np.isneginf(_np(wlse)[3])
    _close(gloss, wloss, F32_TOL, rel=True)
    _close(glse, wlse, F32_TOL, rel=True)


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


def _bn_walk(n, stride, reverse):
    """The items one BatchNorm backward walker visits, in order, as the
    kernels compute them: base + k * stride below n for each base <
    stride, forward in the sums pass; in the dx pass from the last one
    down, with C++'s truncating division and its early exit."""
    walks = []
    for base in range(stride):
        if not reverse:
            walks.append(list(range(base, n, stride)))
        elif base < n:
            first = base + int((n - 1 - base) / stride) * stride
            walks.append(list(range(first, -1, -stride)))
    return walks


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", [
    (1605632, 64, 1), (128, 64, 12544), (401408, 256, 1), (6272, 2048, 1),
    (128, 2048, 49), (1000, 96, 1), (8, 96, 125), (1, 1, 1), (3, 5, 2000)])
def test_batch_norm_backward_tiling(shape, itemsize):
    """The geometry the wrapper hands the kernels at ResNet-50's shapes and
    ragged ones, in bf16 and f32: 16-byte loads exactly where the
    contiguous dimension allows them (else the scalar path), a grid of
    one wave of the given residency (3 sums and 2 dx blocks an SM on 132
    SMs) or less when there is less work, column groups that cover C
    with none empty, and walks that visit every row (channels-last) or
    vector (channel-major) once in each pass, the dx pass in reverse."""
    rows, c, s = shape
    full = 16 // itemsize
    vec = K.bn_bwd_vec(c, s, itemsize, aligned=True)
    assert vec == (full if (c if s == 1 else s) % full == 0 else 1)
    assert K.bn_bwd_vec(c, s, itemsize, aligned=False) == 1
    bcols, rpp, gx_sums, gx_dx, gy = K.bn_bwd_geometry(rows, c, s, vec, 3,
                                                       2, 132)
    if s == 1:
        assert 1 <= bcols <= 256 and rpp * bcols <= 256
        assert rpp == 256 // bcols
        assert (gy - 1) * bcols * vec < c <= gy * bcols * vec
        n, per_pass = rows, rpp
    else:
        assert gy == c
        n, per_pass = rows * (s // vec), 256
    for gx, per_sm in ((gx_sums, 3), (gx_dx, 2)):
        # one wave, or every row (vector) already in one pass
        assert gx >= 1
        assert gx * gy <= max(per_sm * 132, gy)
        assert gx * gy > per_sm * 132 - gy or gx * per_pass >= n or gx == 1
        stride = gx * per_pass
        if n > 50000:           # the walks are checked at ragged sizes
            continue
        fwd, rev = _bn_walk(n, stride, False), _bn_walk(n, stride, True)
        assert sorted(i for w in fwd for i in w) == list(range(n))
        assert [w[::-1] for w in rev] == [w for w in fwd if w]


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
