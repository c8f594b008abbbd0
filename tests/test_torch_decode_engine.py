"""The port's DecodeEngine against the JAX package's, on a model the JAX
package saved.

A tiny generation model (2 layers, d_model 64, 4 heads, d_ff 128, vocab
128, max_len 64) is saved with ``paddle_tpu.models.transformer.
save_generation_model``, its zero-initialised biases and unit LayerNorm
affines replaced by seeded random values, and served by both packages.
The port runs on the CPU (``device="cpu"``), where its kernel wrappers
run their plain versions.

Tolerances: f32 logits 1e-4 (the same f32 model, summed in another
order); bf16 against the port's own f32 path 2e-2 relative to the logit
scale (bf16 keeps ~3 significant digits through every layer).
"""
import os
import time

import numpy as np
import pytest

from paddle_tpu.core.scope import Scope
from paddle_tpu.models import transformer as JT
from paddle_tpu.serving.decode_engine import greedy_decode_kv as jax_decode_kv
from paddle_tpu_torch.serving.decode_engine import (BlockAllocator,
                                                    DecodeEngine,
                                                    greedy_decode_full,
                                                    greedy_decode_kv)
from paddle_tpu_torch.serving.engine import EngineOverloadedError

SPEC = dict(vocab=128, max_len=64, n_layers=2, d_model=64, n_heads=4,
            d_ff=128)
TOL = 1e-4


def _engine(model_dir, **kw):
    return DecodeEngine.from_model_dir(model_dir, device="cpu", **kw)


def _slow_steps(eng, seconds=0.02):
    """Tiny models decode in about a millisecond on the CPU; slowing each
    decode step makes "while another stream is mid-generation" a wide
    target."""
    orig = eng.model.decode

    def slow(*a, **k):
        time.sleep(seconds)
        return orig(*a, **k)
    eng.model.decode = slow


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_genmodel"))
    scope = Scope()
    JT.save_generation_model(d, **SPEC, seed=5, scope=scope)
    rng = np.random.RandomState(5)
    for f in sorted(os.listdir(d)):
        name = f[:-4]
        if not f.endswith(".npy") or name.startswith(("embedding",
                                                      "pos_encoding")):
            continue
        val = np.asarray(scope.get(name))
        if val.ndim == 1:
            base = 1.0 if name.endswith("w_0") else 0.0
            scope.set(name, (base + 0.1 * rng.randn(*val.shape))
                      .astype(np.float32))
    JT.save_generation_model(d, **SPEC, scope=scope, init=False)
    return d


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(0)
    return [list(rng.randint(2, 128, 7)), list(rng.randint(2, 128, 3)),
            list(rng.randint(2, 128, 12))]


@pytest.fixture(scope="module")
def jax_streams(model_dir, prompts):
    return jax_decode_kv(model_dir, prompts, max_new_tokens=8, block_len=4,
                         capture_logits=True)


def test_port_serves_jax_model_with_identical_streams(model_dir, prompts,
                                                      jax_streams):
    got = greedy_decode_kv(model_dir, prompts, max_new_tokens=8,
                           block_len=4, capture_logits=True, device="cpu")
    for i in range(len(prompts)):
        for step, (a, b) in enumerate(zip(got["logits"][i],
                                          jax_streams["logits"][i])):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
            if got["tokens"][i][step] != jax_streams["tokens"][i][step]:
                # only a near tie may flip the greedy choice
                top2 = np.sort(b)[-2:]
                assert top2[1] - top2[0] < TOL
                break
        else:
            assert got["tokens"][i] == jax_streams["tokens"][i]


def test_kv_decode_matches_full_recompute(model_dir, prompts):
    kv = greedy_decode_kv(model_dir, prompts, max_new_tokens=8, block_len=4,
                          capture_logits=True, device="cpu")
    full = greedy_decode_full(model_dir, prompts, max_new_tokens=8,
                              capture_logits=True, device="cpu")
    assert kv["tokens"] == full["tokens"]
    for i in range(len(prompts)):
        for step, a in enumerate(kv["logits"][i]):
            np.testing.assert_allclose(a, full["logits"][step][i], atol=TOL,
                                       rtol=0)
    assert kv["stats"]["dispatches_per_token"] <= 1.0


def test_block_allocator_alloc_free_exhaust():
    a = BlockAllocator(4)
    got = a.alloc(3)
    assert sorted(got) == [0, 1, 2] and a.available == 1 and a.in_use == 3
    assert a.alloc(2) is None          # no partial grants
    assert a.available == 1
    a.free(got)
    assert a.available == 4
    with pytest.raises(ValueError):
        a.free([99])


def test_admission_mid_generation_does_not_perturb_running_stream(
        model_dir):
    pa, pb = [3, 4, 5, 6], [9, 8]
    with _engine(model_dir, slots=2, block_len=4) as solo:
        a_alone = solo.generate(pa, max_new_tokens=10, timeout=120)
    eng = _engine(model_dir, slots=2, block_len=4)
    _slow_steps(eng)
    try:
        ha = eng.submit(pa, max_new_tokens=10)
        gen = ha.events(timeout=120)
        a_events = []
        for ev in gen:
            a_events.append(ev)
            if ev[0] == "token" and ev[1] >= 1:
                break
        b_first_step = None
        b_done = None
        for ev in eng.submit(pb, max_new_tokens=4).events(timeout=120):
            if ev[0] == "token" and b_first_step is None:
                b_first_step = ev[3]
            if ev[0] == "done":
                b_done = ev
        a_events.extend(gen)
        a_tokens = [ev[2] for ev in a_events if ev[0] == "token"]
        a_last_step = max(ev[3] for ev in a_events if ev[0] == "token")
        assert a_tokens == a_alone["tokens"]
        assert b_done is not None and len(b_done[2]) == 4
        assert b_first_step is not None and b_first_step <= a_last_step
    finally:
        eng.close()


def test_more_prompts_than_slots_all_finish(model_dir, prompts):
    """Slots recycle: five requests through two slots give each prompt
    the stream it gets alone."""
    solo = greedy_decode_kv(model_dir, prompts, max_new_tokens=5,
                            block_len=4, device="cpu")["tokens"]
    with _engine(model_dir, slots=2, block_len=4) as eng:
        hs = [eng.submit(p, max_new_tokens=5) for p in prompts + prompts[:2]]
        got = [h.result(timeout=120)["tokens"] for h in hs]
        assert eng.stats()["prefills"] == 5
    assert got == solo + solo[:2]


def test_blocks_recycle_across_requests(model_dir):
    with _engine(model_dir, slots=2, block_len=4, num_blocks=3) as eng:
        h1 = eng.submit([3, 4, 5], max_new_tokens=6)  # ceil(9/4)=3 blocks
        h2 = eng.submit([3, 4, 5], max_new_tokens=6)  # waits for h1's
        r1, r2 = h1.result(timeout=120), h2.result(timeout=120)
        assert r1["tokens"] == r2["tokens"]
        assert eng.allocator.available == 3
        assert eng.stats()["blocks"]["in_use"] == 0


def test_eos_ends_stream(model_dir):
    with _engine(model_dir, slots=1, block_len=4) as eng:
        eos = eng.generate([3, 4, 5], max_new_tokens=3,
                           timeout=120)["tokens"][0]
        r = eng.generate([3, 4, 5], max_new_tokens=8, eos_id=eos,
                         timeout=120)
        assert r["tokens"] == [eos] and r["finish_reason"] == "eos"
        assert eng.stats()["finished"].get("eos") == 1


def test_queue_bound_sheds_overloaded(model_dir):
    with _engine(model_dir, slots=1, block_len=4, num_blocks=3,
                 max_queue_depth=1) as eng:
        _slow_steps(eng)
        h1 = eng.submit([3, 4], max_new_tokens=8)
        deadline = time.monotonic() + 60
        while eng.stats()["active_slots"] == 0:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        h2 = eng.submit([3, 4], max_new_tokens=8)  # queued: no blocks
        with pytest.raises(EngineOverloadedError):
            eng.submit([3, 4], max_new_tokens=8)
        assert h1.result(timeout=120)["tokens"]
        assert h2.result(timeout=120)["tokens"]
        assert eng.stats()["shed"] == 1


def test_prompt_too_long_and_pool_too_small_rejected(model_dir):
    with _engine(model_dir, slots=1, block_len=4, num_blocks=3) as eng:
        with pytest.raises(ValueError):
            eng.submit(list(range(2, 2 + 64)), max_new_tokens=1)
        with pytest.raises(ValueError):
            eng.submit([3, 4, 5], max_new_tokens=12)  # 4 blocks > 3
        with pytest.raises(ValueError):
            eng.submit([], max_new_tokens=1)


def test_deadline_expires_queued_request(model_dir):
    with _engine(model_dir, slots=1, block_len=4, num_blocks=3) as eng:
        h1 = eng.submit([3, 4, 5], max_new_tokens=8)
        h2 = eng.submit([6, 7], max_new_tokens=8, deadline_ms=0.01)
        with pytest.raises(TimeoutError):
            h2.result(timeout=120)
        assert h1.result(timeout=120)["tokens"]
        assert eng.stats()["expired"] == 1


def test_bf16_path_tracks_f32_path(model_dir, prompts):
    f32 = greedy_decode_kv(model_dir, prompts, max_new_tokens=4,
                           block_len=4, capture_logits=True, device="cpu")
    with _engine(model_dir, slots=3, block_len=4, precision="bf16") as eng:
        assert eng.kv_dtype == "bfloat16"
        assert all(p.dtype.is_floating_point and p.element_size() == 2
                   for pair in eng._pools for p in pair)
        hs = [eng.submit(p, max_new_tokens=4, capture_logits=True)
              for p in prompts]
        bf16 = [h.result(timeout=120) for h in hs]
    for i in range(len(prompts)):
        a, b = bf16[i]["logits"][0], f32["logits"][i][0]
        scale = max(1.0, float(np.abs(b).max()))
        assert float(np.abs(a - b).max()) <= 2e-2 * scale
