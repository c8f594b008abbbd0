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
