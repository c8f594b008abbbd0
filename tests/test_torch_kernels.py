"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its kernel's plain PyTorch version
(the CUDA kernels are held against those same plain versions on the card
by chip_smoke.py); the JAX side runs the Pallas kernels in interpret
mode.  Inputs are made with numpy from a fixed seed and handed to both.

Tolerances (max abs error): f32 2e-5 — the same f32 math summed in
another order; bf16 2e-2 — tests/test_pallas_kernels.py's bf16 tolerance,
outputs rounded to bf16 at slightly different places.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas_kernels import (_flash_forward, fused_layer_norm,
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


def _close(a, b, tol):
    a, b = _np(a), _np(b)
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


def test_wrappers_count_only_kernel_launches():
    """On the CPU the plain version runs and no kernel launch is
    counted."""
    K.reset_launches()
    x = torch.randn(4, 32)
    K.layer_norm_fwd(x, torch.ones(32), torch.zeros(32))
    q = torch.randn(1, 2, 3, 32)
    K.flash_attention_fwd(q, q, q, True)
    assert all(k.launches == 0 for k in K.KERNELS)
