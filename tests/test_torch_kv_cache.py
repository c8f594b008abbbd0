"""The port's paged KV-cache ops against the JAX package's op rules.

The JAX rules (paddle_tpu/ops/kv_cache_ops.py) are called directly with a
minimal op context; inputs come from numpy with a fixed seed.  The write
must land the same rows (exactly: it is a copy), drop what JAX drops, and
update the pool tensors in place.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.ops import kv_cache_ops as J
from paddle_tpu_torch.ops import kv_cache_ops as P


class _Ctx:
    """The slice of the lowering context an op rule reads."""

    def __init__(self, inputs, attrs=None):
        self.inputs = inputs
        self.attrs = attrs or {}
        self.outputs = {}

    def input(self, slot, default=None):
        return self.inputs.get(slot, default)

    def attr(self, key, default=None):
        return self.attrs.get(key, default)

    def set_output(self, slot, value, idx=0):
        self.outputs[slot] = np.asarray(value)


def _jax_write(k, v, pool_k, pool_v, table, index, length=None):
    ins = {"K": jnp.asarray(k), "V": jnp.asarray(v),
           "PoolK": jnp.asarray(pool_k), "PoolV": jnp.asarray(pool_v),
           "PageTable": jnp.asarray(table), "Index": jnp.asarray(index)}
    if length is not None:
        ins["Length"] = jnp.asarray(length)
    ctx = _Ctx(ins)
    J._kv_cache_write(ctx)
    return ctx.outputs["PoolKOut"], ctx.outputs["PoolVOut"]


def _case(seed=0, s=4, t=5, n=6, block_len=4, pages=2, h=2, d=8):
    rng = np.random.RandomState(seed)
    k = rng.randn(s, t, h, d).astype(np.float32)
    v = rng.randn(s, t, h, d).astype(np.float32)
    pool_k = rng.randn(n, block_len, h, d).astype(np.float32)
    pool_v = rng.randn(n, block_len, h, d).astype(np.float32)
    # slot 0: two real pages; slot 1: one real page then the sentinel;
    # slot 2: idle (all sentinel); slot 3: starts near the end of its
    # pages, so most of its rows are over-long
    table = np.array([[0, 1], [2, n], [n, n], [3, 4]], np.int32)
    index = np.array([0, 2, 0, 6], np.int32)
    return k, v, pool_k, pool_v, table, index


@pytest.mark.parametrize("with_length", [False, True])
def test_kv_cache_write_matches_jax_and_is_in_place(with_length):
    k, v, pool_k, pool_v, table, index = _case()
    length = np.array([5, 3, 5, 2], np.int32) if with_length else None
    want_k, want_v = _jax_write(k, v, pool_k, pool_v, table, index, length)
    tk, tv = torch.from_numpy(pool_k.copy()), torch.from_numpy(pool_v.copy())
    ptr_k, ptr_v = tk.data_ptr(), tv.data_ptr()
    out_k, out_v = P.kv_cache_write(
        torch.from_numpy(k), torch.from_numpy(v), tk, tv,
        torch.from_numpy(table), torch.from_numpy(index),
        None if length is None else torch.from_numpy(length))
    assert out_k is tk and out_v is tv
    assert tk.data_ptr() == ptr_k and tv.data_ptr() == ptr_v
    np.testing.assert_array_equal(tk.numpy(), want_k)
    np.testing.assert_array_equal(tv.numpy(), want_v)


def test_kv_cache_write_drops_masked_overlong_and_sentinel_rows():
    k, v, pool_k, pool_v, table, index = _case(seed=1)
    n, block_len = pool_k.shape[:2]
    length = np.array([5, 3, 5, 2], np.int32)
    src, dst = P.write_plan(torch.from_numpy(table), torch.from_numpy(index),
                            k.shape[1], block_len, n,
                            torch.from_numpy(length))
    got = sorted(zip(src.tolist(), dst.tolist()))
    t = k.shape[1]
    # slot 0: rows 0..4 at positions 0..4 -> blocks 0, 1
    want = [(r, r) if r < 4 else (r, 1 * block_len + r - 4)
            for r in range(5)]
    # slot 1: rows 0..2 (Length 3) at positions 2..4; position 4 is on
    # the sentinel page and is dropped
    want += [(t + 0, 2 * block_len + 2), (t + 1, 2 * block_len + 3)]
    # slot 2: idle — nothing; slot 3: rows 0..1 at positions 6, 7
    want += [(3 * t + 0, 4 * block_len + 2), (3 * t + 1, 4 * block_len + 3)]
    assert got == sorted(want)
    assert int(dst.max()) < n * block_len


def test_kv_cache_write_casts_to_bf16_pool():
    k, v, pool_k, pool_v, table, index = _case(seed=2)
    tk = torch.from_numpy(pool_k).to(torch.bfloat16)
    tv = torch.from_numpy(pool_v).to(torch.bfloat16)
    P.kv_cache_write(torch.from_numpy(k), torch.from_numpy(v), tk, tv,
                     torch.from_numpy(table), torch.from_numpy(index))
    want_k, _ = _jax_write(k, v, np.asarray(tk.float()),
                           np.asarray(tv.float()), table, index)
    assert tk.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tk.float().numpy(),
        np.asarray(jnp.asarray(want_k).astype(jnp.bfloat16)
                   .astype(jnp.float32)))


def test_paged_attention_matches_jax_xla_path():
    """The op entry (the kernel wrapper's plain version on the CPU)
    against the JAX rule's gather+GEMV path."""
    rng = np.random.RandomState(3)
    k, v, pool_k, pool_v, table, index = _case(seed=3)
    q = rng.randn(4, 2, 1, 8).astype(np.float32)
    ctx = _Ctx({"Q": jnp.asarray(q), "PoolK": jnp.asarray(pool_k),
                "PoolV": jnp.asarray(pool_v),
                "PageTable": jnp.asarray(table),
                "Index": jnp.asarray(index)}, {"exact": False})
    J._paged_attention(ctx)
    got = P.paged_attention(torch.from_numpy(q), torch.from_numpy(pool_k),
                            torch.from_numpy(pool_v), torch.from_numpy(table),
                            torch.from_numpy(index))
    np.testing.assert_allclose(got.numpy(), ctx.outputs["Out"], atol=2e-5)


def test_gather_slot_kv_matches_jax_with_sentinel_clamp():
    """The plain reference's page gather: sentinel ids clamp to the last
    block as the JAX gather does (``mode="clip"``)."""
    _, _, pool_k, _, table, _ = _case(seed=5)
    got = P.gather_slot_kv(torch.from_numpy(pool_k), torch.from_numpy(table))
    want = J._gather_slot_kv(jnp.asarray(pool_k), jnp.asarray(table))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pos_encoding_add_and_batched_select_match_jax():
    rng = np.random.RandomState(4)
    table = rng.randn(10, 6).astype(np.float32)
    x3 = rng.randn(2, 4, 6).astype(np.float32)
    x2 = rng.randn(3, 6).astype(np.float32)
    index = np.array([0, 9, 12], np.int32)          # 12 clips to 9
    for x, idx in ((x3, None), (x2, index)):
        ins = {"X": jnp.asarray(x), "Table": jnp.asarray(table)}
        if idx is not None:
            ins["Index"] = jnp.asarray(idx)
        ctx = _Ctx(ins)
        J._pos_encoding_add(ctx)
        got = P.pos_encoding_add(
            torch.from_numpy(x), torch.from_numpy(table),
            None if idx is None else torch.from_numpy(idx))
        np.testing.assert_array_equal(got.numpy(), ctx.outputs["Out"])
    sel = np.array([4, 1], np.int32)
    ctx = _Ctx({"X": jnp.asarray(x3), "Index": jnp.asarray(sel)},
               {"offset": -1})
    J._batched_select(ctx)
    got = P.batched_select(torch.from_numpy(x3), torch.from_numpy(sel), -1)
    np.testing.assert_array_equal(got.numpy(), ctx.outputs["Out"])
