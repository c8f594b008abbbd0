"""The port's decode engine under ``numerics="exact"`` and at
``precision="int8"``, against the JAX package's (twins of
test_decode_engine.py:120, :130 and :644, and int8 decode against the JAX
``DecodeEngine(precision="int8")``).

A 2-layer LM (d_model 64, 4 heads, d_ff 128, vocab 128, max_len 32) is
saved by the JAX package with seeded random biases and LayerNorm
affines, and served on the CPU.  Exact mode's contract is held bitwise
as the port's own invariant: every emitted token's logits equal the
port's exact full recompute, across slots of different prompt lengths
and through a prefix-cache hit.  Against the JAX exact engine the logits
agree to 1e-4 (the same f32 model, summed in another order) with equal
tokens.  int8: logits within 5e-2, the tolerance of
test_precision_serving.py:48, and equal tokens up to a greedy choice that
flips on a near tie of the JAX logits (top two within that tolerance:
the bf16 activation stream's sums depend on the CPU's thread count),
after which the streams part.  The row-stable product's plain version
gives a row the same bits at M = 1, 7, 64 and on both sides of the M
where the card switches tile codes, at K 96 and 3072, which is what
exact mode rests on.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer as JT
from paddle_tpu.serving.decode_engine import DecodeEngine as JaxEngine
from paddle_tpu.serving.decode_engine import greedy_decode_kv as jax_kv
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.serving import ModelRegistry
from paddle_tpu_torch.serving.decode_engine import (DecodeEngine,
                                                    greedy_decode_full,
                                                    greedy_decode_kv)

SPEC = dict(vocab=128, max_len=32, n_layers=2, d_model=64, n_heads=4,
            d_ff=128)
TOL = 1e-4
INT8_TOL = 5e-2


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("exact_genmodel"))
    scope = JScope()
    JT.save_generation_model(d, **SPEC, seed=11, scope=scope)
    rng = np.random.RandomState(11)
    for name in list(scope._vars):
        val = np.asarray(scope.get(name))
        if val.ndim == 1 and name.startswith(("fc", "layer_norm")):
            base = 1.0 if name.startswith("layer_norm") and \
                name.endswith("w_0") else 0.0
            scope.set(name, (base + 0.2 * rng.randn(*val.shape))
                      .astype(np.float32))
    JT.save_generation_model(d, **SPEC, scope=scope, init=False)
    return d


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(3)
    return [list(rng.randint(2, 128, n)) for n in (7, 3, 12)]


@pytest.fixture(scope="module")
def exact_streams(model_dir, prompts):
    full = greedy_decode_full(model_dir, prompts, max_new_tokens=6,
                              numerics="exact", capture_logits=True,
                              device="cpu")
    kv = greedy_decode_kv(model_dir, prompts, max_new_tokens=6,
                          numerics="exact", block_len=4,
                          capture_logits=True, device="cpu")
    return full, kv


def _engine(model_dir, **kw):
    return DecodeEngine.from_model_dir(model_dir, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the row-stable product
# ---------------------------------------------------------------------------

def _row_stable_ms():
    """M values around the card's switch between the small-M and the
    large-M tile code (`K.ROW_STABLE_SMALL_M`), and 1, 7 and 64."""
    small = K.ROW_STABLE_SMALL_M
    return sorted({1, 7, small, small + 1, 64})


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("k", [96, 3072])
def test_row_stable_product_gives_a_row_the_same_bits_at_every_m(bias, k):
    """K 96, and 3072, the exact LM's FFN2 depth."""
    ms = _row_stable_ms()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((ms[-1], k)).astype(np.float32))
    # sums of K terms keep the magnitude of K 96's
    w = torch.from_numpy((rng.standard_normal((k, 40))
                          * np.sqrt(96 / k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(40).astype(np.float32)) \
        if bias else None
    rows = {m: K.row_stable_mm(x[ms[-1] - m:], w, b) for m in ms}
    for m, out in rows.items():
        assert out.dtype == torch.float32 and out.shape == (m, 40)
        # the last row of x is the last row of every product
        assert torch.equal(out[-1], rows[ms[-1]][-1]), m
    want = x.double() @ w.double() + (0 if b is None else b.double())
    np.testing.assert_allclose(rows[ms[-1]].numpy(), want.numpy(),
                               atol=1e-4, rtol=0)


def test_row_stable_product_switches_tile_code_above_small_m():
    """The card's small-M code takes M up to ROW_STABLE_SMALL_M, the
    128 x 128 code the rest, and its strip is the widest that gives half
    the SMs a block (the H100's 132 SMs here); on the CPU neither
    launches."""
    small = K.ROW_STABLE_SMALL_M
    assert [K.row_stable_mm_geometry(m, 32000, 132)
            for m in (1, 4, small, small + 1, 8192)] == [32] * 3 + [0] * 2
    # the exact LM's decode products: the head, QKV, FFN1, FFN2
    assert [K.row_stable_mm_geometry(4, n, 132)
            for n in (32000, 2304, 3072, 768)] == [32, 32, 32, 8]
    assert K.ROW_STABLE_MM.path_launches == {"small": 0, "large": 0}
    K.row_stable_mm(torch.ones(4, 8), torch.ones(8, 4))
    assert K.ROW_STABLE_MM.launches == 0
    assert K.ROW_STABLE_MM.path_launches == {"small": 0, "large": 0}


# ---------------------------------------------------------------------------
# exact numerics
# ---------------------------------------------------------------------------

def test_exact_mode_requires_full_cache_span(model_dir):
    with pytest.raises(ValueError, match="max_len"):
        _engine(model_dir, slots=1, block_len=4, pages_per_slot=2,
                numerics="exact")
    with pytest.raises(ValueError, match="fast|exact"):
        _engine(model_dir, numerics="bitwise")


def test_kv_decode_bitwise_equals_full_recompute_exact(prompts,
                                                       exact_streams):
    full, kv = exact_streams
    assert kv["tokens"] == full["tokens"]
    for i in range(len(prompts)):
        assert len(kv["logits"][i]) == 6
        for step, a in enumerate(kv["logits"][i]):
            b = full["logits"][step][i]
            assert np.array_equal(a, b), (
                f"slot {i} token {step}: max |delta| "
                f"{np.max(np.abs(a - b))}")
    assert kv["stats"]["dispatches_per_token"] <= 1.0
    assert kv["stats"]["numerics"] == "exact"


def test_exact_logits_match_the_jax_exact_engine(model_dir, prompts,
                                                 exact_streams):
    """The JAX exact engine dispatches op by op on the CPU (seconds a
    token here): two of the prompts, four tokens each."""
    _, kv = exact_streams
    ref = jax_kv(model_dir, prompts[:2], max_new_tokens=4, numerics="exact",
                 block_len=4, capture_logits=True)
    for i in range(2):
        assert kv["tokens"][i][:4] == ref["tokens"][i]
        for a, b in zip(kv["logits"][i], ref["logits"][i]):
            np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=0)


def test_exact_fast_and_exact_agree_within_f32(model_dir, prompts,
                                               exact_streams):
    _, kv = exact_streams
    fast = greedy_decode_kv(model_dir, prompts, max_new_tokens=6,
                            block_len=4, capture_logits=True, device="cpu")
    assert fast["tokens"] == kv["tokens"]
    for i in range(len(prompts)):
        for a, b in zip(fast["logits"][i], kv["logits"][i]):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0)


def test_prefix_cache_exact_mode_bitwise(model_dir):
    with _engine(model_dir, slots=2, block_len=4, numerics="exact",
                 prefix_cache_blocks=4) as eng:
        p = [3, 4, 5, 6, 7, 8, 9, 10]
        cold = eng.submit(p, max_new_tokens=5,
                          capture_logits=True).result(timeout=240)
        hot = eng.submit(p, max_new_tokens=5,
                         capture_logits=True).result(timeout=240)
        assert eng.stats()["prefix"]["hits"] == 1
        assert hot["tokens"] == cold["tokens"]
        for a, b in zip(hot["logits"], cold["logits"]):
            assert np.array_equal(a, b), np.max(np.abs(a - b))
    full = greedy_decode_full(model_dir, [p], max_new_tokens=5,
                              numerics="exact", capture_logits=True,
                              device="cpu")
    assert full["tokens"][0] == cold["tokens"]
    for step, a in enumerate(cold["logits"]):
        assert np.array_equal(a, full["logits"][step][0])


def test_exact_engine_through_the_registry_decode_options(model_dir):
    reg = ModelRegistry(device="cpu")
    try:
        entry = reg.load("lmx", model_dir, warmup=[],
                         decode={"numerics": "exact", "block_len": 4,
                                 "slots": 2})
        assert entry.describe()["decode"]["numerics"] == "exact"
        got = entry.decode.generate([3, 4, 5], max_new_tokens=4,
                                    timeout=120)
        want = greedy_decode_full(model_dir, [[3, 4, 5]], max_new_tokens=4,
                                  numerics="exact", device="cpu")
        assert got["tokens"] == want["tokens"][0]
        assert entry.decode.stats()["numerics"] == "exact"
    finally:
        reg.close()


def test_prompt_ids_outside_the_vocabulary(model_dir):
    with _engine(model_dir, slots=1, block_len=4) as eng:
        with pytest.raises(ValueError, match="vocabulary"):
            eng.submit([3, 128], max_new_tokens=2)
        wrapped = eng.generate([3, -1], max_new_tokens=3, timeout=120)
        plain = eng.generate([3, 127], max_new_tokens=3, timeout=120)
        assert wrapped["tokens"] == plain["tokens"]


# ---------------------------------------------------------------------------
# int8 decode
# ---------------------------------------------------------------------------

def test_int8_decode_matches_the_jax_int8_engine(model_dir, prompts):
    jeng = JaxEngine.from_model_dir(model_dir, slots=3, block_len=4,
                                    precision="int8")
    try:
        hs = [jeng.submit(p, 6, capture_logits=True) for p in prompts]
        ref = [h.result(timeout=240) for h in hs]
    finally:
        jeng.close()
    with _engine(model_dir, slots=3, block_len=4, precision="int8") as eng:
        assert eng.kv_dtype == "float32"
        assert eng.model.layers[0].qkv_w.dtype == torch.int8
        assert eng.model.embedding.dtype == torch.int8
        hs = [eng.submit(p, 6, capture_logits=True) for p in prompts]
        got = [h.result(timeout=240) for h in hs]
    for g, r in zip(got, ref):
        for step, (a, b) in enumerate(zip(g["logits"], r["logits"])):
            b = np.asarray(b, np.float32)
            np.testing.assert_allclose(a, b, atol=INT8_TOL, rtol=0)
            if g["tokens"][step] != r["tokens"][step]:
                # bf16 activations: only a near tie of the JAX logits may
                # flip the greedy choice, and the streams part there
                top2 = np.sort(b)[-2:]
                assert top2[1] - top2[0] < INT8_TOL, (step, top2)
                break
        else:
            assert g["tokens"] == r["tokens"]


def test_int8_model_quantizes_like_the_predictor(model_dir):
    """The decode model's int8 matrices and scales are the predictor's
    for the same artifact: one quantization helper serves both."""
    from paddle_tpu_torch.serving import Predictor
    pred = Predictor.from_model_dir(model_dir, precision="int8",
                                    device="cpu")
    with _engine(model_dir, slots=1, block_len=4, precision="int8") as eng:
        qkv = eng.model.layers[1].qkv_w
        assert torch.equal(qkv, pred._params["fc_3.w_0"])
        assert torch.equal(eng.model.layers[1].qkv_w_qscale,
                           pred._params["fc_3.w_0" + pred.QSCALE_SUFFIX])
        assert eng.model.layers[0].ln1_w.dtype == torch.float32
