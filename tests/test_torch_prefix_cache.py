"""The port's decode-engine prefix cache against the JAX package's
(twins of test_decode_engine.py's prefix-cache tests; the exact-mode
twin is in test_torch_exact_decode.py).

A tiny generation model (2 layers, d16, 2 heads, d_ff 32, vocab 32,
max_len 16) saved by the JAX package, its zero biases and unit LayerNorm
affines replaced by seeded random values, served on the CPU.  Hot
streams must equal cold streams token for token; the port's tokens must
equal the JAX DecodeEngine's with its prefix cache on, where a flipped
greedy choice is allowed only on a near tie of the JAX logits (top-2 gap
under 1e-4, the f32 tolerance of the port's logits).
"""
import numpy as np
import pytest

from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer as JT
from paddle_tpu.serving.decode_engine import DecodeEngine as JaxEngine
from paddle_tpu_torch.serving.decode_engine import (BlockAllocator,
                                                    DecodeEngine,
                                                    PrefixCache)

SPEC = dict(vocab=32, max_len=16, n_layers=2, d_model=16, n_heads=2,
            d_ff=32)
TOL = 1e-4


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("prefix_genmodel"))
    scope = JScope()
    JT.save_generation_model(d, **SPEC, seed=7, scope=scope)
    rng = np.random.RandomState(7)
    for name in list(scope._vars):
        val = np.asarray(scope.get(name))
        if val.ndim == 1 and name.startswith(("fc", "layer_norm")):
            base = 1.0 if name.startswith("layer_norm") and \
                name.endswith("w_0") else 0.0
            scope.set(name, (base + 0.3 * rng.randn(*val.shape))
                      .astype(np.float32))
    JT.save_generation_model(d, **SPEC, scope=scope, init=False)
    return d


def _engine(model_dir, **kw):
    return DecodeEngine.from_model_dir(model_dir, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the allocator and the radix tree in isolation
# ---------------------------------------------------------------------------

def test_block_allocator_refcounts():
    a = BlockAllocator(4)
    got = a.alloc(2)
    assert a.incref(got[0]) == 1 and a.refcount(got[0]) == 1
    with pytest.raises(ValueError):
        a.free([got[0]])
    assert a.available == 2
    assert a.decref(got[0]) == 0
    a.free(got)
    assert a.available == 4
    with pytest.raises(ValueError):
        a.decref(got[0])


def test_prefix_cache_radix_match_insert_evict():
    a = BlockAllocator(8)
    c = PrefixCache(a, block_len=2, capacity_blocks=3)
    b1 = a.alloc(2)
    assert c.insert([1, 2, 3, 4], b1, 2) == []
    assert c.cached_blocks == 2
    assert [n.block for n in c.match([1, 2, 3, 4, 9])] == b1
    assert [n.block for n in c.match([1, 2, 9, 9])] == b1[:1]
    assert c.match([9, 9]) == []
    b2 = a.alloc(2)
    assert c.insert([1, 2, 3, 4], b2, 2) == b2
    a.free(b2)
    path = c.match([1, 2, 3, 4])
    c.adopt(path)
    b3 = a.alloc(1)
    c.insert([7, 8], b3, 1)
    assert c.cached_blocks == 3
    b4 = a.alloc(1)
    rejected = c.insert([5, 6], b4, 1)
    # the only evictable leaf was [7, 8]: [1, 2, 3, 4]'s leaf is
    # referenced and [1, 2] is pinned by its child
    assert rejected == [] and c.evictions == 1
    assert c.match([7, 8]) == []
    assert [n.block for n in c.match([1, 2, 3, 4])] == b1
    c.release(path)
    # nothing referenced: evict_for frees leaves until it has enough
    assert c.evict_for(2) == 2 and c.cached_blocks == 1


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_prefix_cache_hot_stream_identical_and_ttft(model_dir):
    eng = _engine(model_dir, slots=2, block_len=4, num_blocks=16,
                  prefix_cache_blocks=8)
    try:
        p = [3, 4, 5, 6, 7, 8, 9, 10]      # two full blocks at L=4
        cold = eng.generate(p, max_new_tokens=6, timeout=60)
        st = eng.stats()["prefix"]
        assert st["misses"] == 1 and st["hits"] == 0
        assert st["cached_blocks"] == 2
        hot = eng.generate(p, max_new_tokens=6, timeout=60)
        assert hot["tokens"] == cold["tokens"]
        st = eng.stats()
        assert st["prefix"]["hits"] == 1 and st["prefix"]["hit_rate"] == 0.5
        assert st["prefix"]["ttft_hot_ms"] is not None
        assert st["prefills"] == 1             # the hot request ran none
        part = eng.generate([3, 4, 5, 6, 20, 21], max_new_tokens=4,
                            timeout=60)
        assert eng.stats()["prefix"]["hits"] == 2
        with _engine(model_dir, slots=2, block_len=4, num_blocks=16) as e2:
            want = e2.generate([3, 4, 5, 6, 20, 21], max_new_tokens=4,
                               timeout=60)
        assert part["tokens"] == want["tokens"]
        assert eng.stats()["blocks"]["in_use"] == \
            eng.stats()["prefix"]["cached_blocks"]
    finally:
        eng.close()


def test_hot_logits_track_cold_and_jax_tokens_match(model_dir):
    """Hot and cold streams of shared-prefix prompts, several in flight
    at once: the hot logits are the cold ones at f32 accuracy, and the
    port's tokens are the JAX engine's with its prefix cache on."""
    rng = np.random.RandomState(0)
    head = list(rng.randint(2, 32, 8))
    prompts = [head + list(rng.randint(2, 32, n)) for n in (1, 3, 0, 2)]
    prompts.append(list(head))             # a full-prompt hit again
    kw = dict(slots=2, block_len=4, num_blocks=24)
    with _engine(model_dir, **kw) as cold_eng:
        cold = [cold_eng.submit(p, max_new_tokens=5, capture_logits=True)
                .result(timeout=60) for p in prompts]
    with _engine(model_dir, prefix_cache_blocks=8, **kw) as eng:
        first = eng.generate(prompts[0], max_new_tokens=5, timeout=60)
        hs = [eng.submit(p, max_new_tokens=5, capture_logits=True)
              for p in prompts]
        hot = [h.result(timeout=60) for h in hs]
        st = eng.stats()
        assert st["prefix"]["hits"] >= 4
    assert first["tokens"] == cold[0]["tokens"]
    for h, c in zip(hot, cold):
        assert h["tokens"] == c["tokens"]
        for a, b in zip(h["logits"], c["logits"]):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    jeng = JaxEngine.from_model_dir(model_dir, prefix_cache_blocks=8, **kw)
    try:
        jeng.generate(prompts[0], max_new_tokens=5, timeout=120)
        jres = [h.result(timeout=120) for h in
                [jeng.submit(p, max_new_tokens=5, capture_logits=True)
                 for p in prompts]]
        assert jeng.stats()["prefix"]["hits"] >= 4
    finally:
        jeng.close()
    for got, want in zip(hot, jres):
        for step, b in enumerate(want["logits"]):
            b = np.asarray(b)
            np.testing.assert_allclose(got["logits"][step], b, atol=TOL,
                                       rtol=0)
            if got["tokens"][step] != want["tokens"][step]:
                top2 = np.sort(b)[-2:]
                assert top2[1] - top2[0] < TOL
                break
        else:
            assert got["tokens"] == want["tokens"]


def test_full_prompt_hit_copies_the_tail_block_on_write(model_dir):
    """A prompt cached in full adopts all but its last block by
    reference and a private copy of that one; the cached block keeps its
    K/V while the replay writes the copy."""
    with _engine(model_dir, slots=1, block_len=4, num_blocks=8,
                 prefix_cache_blocks=4) as eng:
        p = [5, 6, 7, 8, 9, 10, 11, 12]
        cold = eng.generate(p, max_new_tokens=3, timeout=60)
        node = eng.prefix_cache.match(p)[-1]
        k_before = eng._pools[0][0][node.block].clone()
        hot = eng.generate(p, max_new_tokens=3, timeout=60)
        assert hot["tokens"] == cold["tokens"]
        assert eng.stats()["prefix"]["hits"] == 1
        assert bool((eng._pools[0][0][node.block] == k_before).all())
        assert all(eng.allocator.refcount(b) == 0 for b in range(8))


def test_prefix_cache_evicts_under_pool_pressure(model_dir):
    with _engine(model_dir, slots=1, block_len=4, num_blocks=4,
                 prefix_cache_blocks=3) as eng:
        eng.generate([3, 4, 5, 6], max_new_tokens=4, timeout=60)
        assert eng.stats()["prefix"]["cached_blocks"] >= 1
        # 7 prompt + 9 budget = 4 blocks, with only 3 free: evicts
        eng.generate([20, 21, 22, 23, 24, 25, 26], max_new_tokens=9,
                     timeout=60)
        st = eng.stats()
        assert st["prefix"]["evictions"] >= 1
        assert st["blocks"]["in_use"] == st["prefix"]["cached_blocks"]


def test_prefix_metrics_and_baseline_after_close(model_dir):
    from paddle_tpu_torch.observability import render_prometheus, snapshot
    eng = _engine(model_dir, slots=2, block_len=4, num_blocks=16,
                  prefix_cache_blocks=8, model="lmp")
    try:
        p = [3, 4, 5, 6, 7, 8, 9]
        for _ in range(3):
            eng.generate(p, max_new_tokens=3, timeout=60)
        snap = snapshot()
        assert snap["decode_prefix_hits_total"]["series"]["model=lmp"] == 2
        assert snap["decode_prefix_misses_total"]["series"]["model=lmp"] == 1
        assert snap["decode_tokens_total"]["series"]["model=lmp"] == 9
    finally:
        eng.close()
    # the engine thread records an iteration after the stream it finished
    # has resolved; once closed, its last record is in
    assert eng.flight.last()["tokens_total"] == 9
    assert all(eng.allocator.refcount(b) == 0 for b in range(16))
    assert eng.allocator.in_use == eng.prefix_cache.cached_blocks
    assert 'model="lmp"' not in render_prometheus()


def test_prefix_cache_rejects_bad_capacity_and_unported_modes(model_dir):
    with pytest.raises(ValueError):
        _engine(model_dir, slots=1, block_len=4, num_blocks=4,
                prefix_cache_blocks=4)
    # exact numerics and int8 are ported: exact needs the full max_len
    # span per slot, int8 keeps its KV pools in f32
    with pytest.raises(ValueError, match="max_len"):
        _engine(model_dir, numerics="exact", block_len=4, pages_per_slot=2)
    with _engine(model_dir, numerics="exact", block_len=4,
                 prefix_cache_blocks=2) as eng:
        assert eng.stats()["numerics"] == "exact"
    with _engine(model_dir, precision="int8", block_len=4) as eng:
        assert eng.kv_dtype == "float32"
