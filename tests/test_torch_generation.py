"""The generation Programs on the port's Executor, against the JAX
package, on the CPU.

A 2-layer LM (vocab 61, max_len 64, d_model 32, 4 heads, d_ff 64) is saved
by the JAX package with seeded random biases and LayerNorm affines, and
loaded into each package's scope through its own ``io``; the paged KV
cache has blocks of 8 positions.

- The port's ``build_generation_programs`` emits the JAX package's
  programs (prefill and decode, fast and exact, f32 and bf16 pools): the
  same JSON, so the same ops, slots, attributes, shapes and parameter
  names.
- The JAX-built programs, serialized to JSON, run on the port's
  Executor against the JAX Executor: one prefill of ragged prompts (1 to
  63 tokens) fetching the logits and every pool, then 6 decode steps
  carrying each package's own pools, with an idle slot on the sentinel
  page row.  The JAX side runs its paged attention as the Pallas kernel
  in interpret mode (``FLAGS_paged_attention=interpret``), as its XLA
  path (``0``) and exact.  Logits agree to 1e-4 x max(1, max |ref|), the
  pools to 2e-5.
- The four kv-cache rules alone against the JAX rules: masked, over-long
  and sentinel-page writes; paged attention fast (against the Pallas
  kernel in interpret mode: a query at Index -1 gives 0) and exact;
  pos_encoding_add with and without Index; batched_select clipping.
- A prefill that fetches only its logits still writes the pools (the
  interpreter never skips a ``kv_cache_write``).
- ``DecodeEngine(scope, spec)``: twins of tests/test_decode_engine.py
  (the full-span check, exact decode bitwise the exact full-recompute
  program, the fast stream, admission mid-generation, EOS, bf16 pools,
  the prefix cache's exact hot stream, stats and metric families), and
  its f32 fast tokens equal to the `TransformerLM` engine's on the same
  weights.
"""
import os
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import io as jio
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.core.scope import scope_guard as jscope_guard
from paddle_tpu.models import transformer as JT
import paddle_tpu_torch as fluid
from paddle_tpu_torch import io as pio
from paddle_tpu_torch.core.program import Program
from paddle_tpu_torch.core.scope import Scope, scope_guard
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.serving.decode_engine import (DecodeEngine,
                                                    _load_full_predictor,
                                                    greedy_decode_full)

SPEC = dict(vocab=61, max_len=64, n_layers=2, d_model=32, n_heads=4,
            d_ff=64)
BLOCK = 8
LOGITS_TOL = 1e-4
POOL_TOL = 2e-5


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("gen_programs"))
    scope = JScope()
    JT.save_generation_model(d, **SPEC, seed=13, scope=scope)
    rng = np.random.RandomState(13)
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
def spec(model_dir):
    return PT.read_generation_spec(model_dir)


@pytest.fixture(scope="module")
def port_scope(model_dir):
    scope = Scope()
    with scope_guard(scope):
        pio.load_inference_model(model_dir, None)
    return scope


@pytest.fixture(scope="module")
def jax_scope(model_dir):
    scope = JScope()
    with jscope_guard(scope):
        jio.load_inference_model(model_dir, jfluid.Executor(
            jfluid.CPUPlace()))
    return scope


def _close(name, got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: {err:.3e} > {tol} x {scale:.3g}"


# ---------------------------------------------------------------------------
# the builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("exact", [False, True], ids=["fast", "exact"])
def test_port_builds_the_jax_generation_programs(spec, exact, kv_dtype):
    want = JT.build_generation_programs(spec, block_len=BLOCK, exact=exact,
                                        kv_dtype=kv_dtype)
    got = PT.build_generation_programs(spec, block_len=BLOCK, exact=exact,
                                       kv_dtype=kv_dtype)
    for mode in ("prefill", "decode"):
        g, w = got[mode], want[mode]
        assert (g["program"].serialize_to_string()
                == w["program"].serialize_to_string()), mode
        assert g["feed_names"] == w["feed_names"]
        assert [v.name for v in g["fetch_vars"]] == \
            [v.name for v in w["fetch_vars"]]
        assert g["program"].exact_lowering is exact
        # clone and prune keep the flag
        assert g["program"].clone().exact_lowering is exact
        assert g["program"].prune(g["fetch_vars"][:1]).exact_lowering \
            is exact
    params = {v.name for v in got["decode"]["program"].list_vars()
              if v.persistable}
    assert params == set(PT.param_shapes(spec))


# ---------------------------------------------------------------------------
# the JAX-built programs on the port's Executor
# ---------------------------------------------------------------------------

#: prompts of the prefill batch; the first four decode on, the last (63
#: tokens, the longest the span holds) is held at its prefill
PROMPT_LENS = (1, 8, 33, 58, 63)
DECODE_STEPS = 6


def _pages(num_blocks, rng):
    """A page-table row a prompt, from a shuffled pool; unmapped pages
    hold the sentinel ``num_blocks``."""
    pages_per_slot = SPEC["max_len"] // BLOCK
    ids = list(rng.permutation(num_blocks))
    table = np.full((len(PROMPT_LENS), pages_per_slot), num_blocks,
                    np.int32)
    for i, n in enumerate(PROMPT_LENS):
        k = min(pages_per_slot, -(-(n + DECODE_STEPS) // BLOCK))
        table[i, :k] = [ids.pop() for _ in range(k)]
    return table


@pytest.mark.parametrize("mode", ["interpret", "xla", "exact"])
def test_jax_programs_run_on_the_port_executor(mode, spec, jax_scope,
                                               port_scope, monkeypatch):
    monkeypatch.setenv("FLAGS_paged_attention",
                       "interpret" if mode == "interpret" else "0")
    exact = mode == "exact"
    jprogs = JT.build_generation_programs(spec, block_len=BLOCK, exact=exact)
    pprogs = {}
    for m in ("prefill", "decode"):
        pprogs[m] = Program.parse_from_string(
            jprogs[m]["program"].serialize_to_string())
        pprogs[m].exact_lowering = exact
    jexe = jfluid.Executor(jfluid.CPUPlace())
    pexe = fluid.Executor(fluid.CPUPlace())
    rng = np.random.RandomState(5)
    num_blocks = 40
    head_dim = SPEC["d_model"] // SPEC["n_heads"]
    pool_shape = (num_blocks, BLOCK, SPEC["n_heads"], head_dim)
    pool_names = [n for n in jprogs["decode"]["feed_names"]
                  if n.startswith(("kv_k_", "kv_v_"))]
    jpools = {n: np.zeros(pool_shape, np.float32) for n in pool_names}
    ppools = {n: torch.zeros(pool_shape) for n in pool_names}
    table = _pages(num_blocks, rng)
    b = len(PROMPT_LENS)
    tokens = np.zeros((b, SPEC["max_len"]), np.int64)
    for i, n in enumerate(PROMPT_LENS):
        tokens[i, :n] = rng.randint(0, SPEC["vocab"], n)
    feed = {"tokens": tokens, "kv_index": np.zeros(b, np.int32),
            "kv_pages": table,
            "kv_len": np.array(PROMPT_LENS, np.int32)}
    fetch = [v.name for v in jprogs["prefill"]["fetch_vars"]]
    want = jexe.run(jprogs["prefill"]["program"], feed={**feed, **jpools},
                    fetch_list=fetch, scope=jax_scope)
    got = pexe.run(pprogs["prefill"], feed={**feed, **ppools},
                   fetch_list=fetch, scope=port_scope)
    _close("prefill logits", got[0], want[0], LOGITS_TOL)
    for name, g, w in zip(pool_names, got[1:], want[1:]):
        _close(f"prefill {name}", g, w, POOL_TOL)
    jpools = dict(zip(pool_names, want[1:]))
    # the port wrote its pools in place: the fetches are its pools
    assert all(np.array_equal(ppools[n].numpy(), g)
               for n, g in zip(pool_names, got[1:]))
    # decode: the first four prompts and an idle slot on the sentinel row
    s = 5
    pages = np.full((s, table.shape[1]), num_blocks, np.int32)
    pages[:4] = table[:4]
    pos = np.array(PROMPT_LENS[:4] + (0,), np.int32)
    tok = np.zeros(s, np.int64)
    tok[:4] = np.asarray(want[0])[:4].argmax(-1)
    fetch = [v.name for v in jprogs["decode"]["fetch_vars"]]
    for step in range(DECODE_STEPS):
        feed = {"tokens": tok, "kv_index": pos, "kv_pages": pages}
        want = jexe.run(jprogs["decode"]["program"],
                        feed={**feed, **jpools}, fetch_list=fetch,
                        scope=jax_scope)
        got = pexe.run(pprogs["decode"], feed={**feed, **ppools},
                       fetch_list=fetch, scope=port_scope)
        _close(f"decode {step} logits", got[0], want[0], LOGITS_TOL)
        for name, g, w in zip(pool_names, got[1:], want[1:]):
            _close(f"decode {step} {name}", g, w, POOL_TOL)
        jpools = dict(zip(pool_names, want[1:]))
        tok = np.asarray(want[0]).argmax(-1).astype(np.int64)
        tok[4] = 0
        pos = pos + np.array([1, 1, 1, 1, 0], np.int32)


def test_prefill_fetching_only_logits_still_writes_the_pools(spec,
                                                             port_scope):
    progs = PT.build_generation_programs(spec, block_len=BLOCK)
    prefill = progs["prefill"]
    pools = [torch.zeros(40, BLOCK, 4, 8) for _ in range(4)]
    feed = {"tokens": np.arange(1, 17, dtype=np.int64).reshape(1, 16),
            "kv_index": np.zeros(1, np.int32),
            "kv_pages": np.arange(8, dtype=np.int32).reshape(1, 8),
            "kv_len": np.array([13], np.int32),
            **dict(zip(prefill["feed_names"][4:], pools))}
    exe = fluid.Executor(fluid.CPUPlace())
    (logits,) = exe.run(prefill["program"], feed=feed,
                        fetch_list=prefill["fetch_vars"][:1],
                        scope=port_scope)
    assert logits.shape == (1, SPEC["vocab"])
    for p in pools:
        flat = p.reshape(-1, 4, 8)
        assert flat[:13].abs().sum(-1).min() > 0       # rows 0..12 written
        assert float(flat[13:].abs().sum()) == 0.0     # masked rows not


# ---------------------------------------------------------------------------
# the four rules alone
# ---------------------------------------------------------------------------

def _rule(op, inputs, attrs, outs, exact=False):
    """A one-op program built by the JAX front end, run by both packages
    (the port from its JSON, copies of the feed) -> (port, JAX)."""
    jfluid.core.program.reset_default_programs()
    main = jfluid.default_main_program()
    block = main.global_block()
    in_map = {}
    for slot, arr in inputs.items():
        name = slot.lower()
        block.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype),
                         is_data=True)
        in_map[slot] = [name]
    out_map = {s: [f"o_{s.lower()}"] for s in outs}
    for s in outs:
        block.create_var(name=out_map[s][0], shape=(1,), dtype="float32")
    block.append_op(op, inputs=in_map, outputs=out_map, attrs=attrs)
    fetch = [out_map[s][0] for s in outs]
    feed = {slot.lower(): arr for slot, arr in inputs.items()}
    want = jfluid.Executor(jfluid.CPUPlace()).run(
        main, feed={k: v.copy() for k, v in feed.items()}, fetch_list=fetch)
    prog = Program.parse_from_string(main.serialize_to_string())
    prog.exact_lowering = exact
    got = fluid.Executor(fluid.CPUPlace()).run(
        prog, feed={k: v.copy() for k, v in feed.items()},
        fetch_list=fetch, scope=fluid.core.scope.Scope())
    return got, want


def _pool_inputs(rng, s=3, t=5, n=6, blk=4, h=2, d=8):
    return {"K": rng.randn(s, t, h, d).astype(np.float32),
            "V": rng.randn(s, t, h, d).astype(np.float32),
            "PoolK": rng.randn(n, blk, h, d).astype(np.float32),
            "PoolV": rng.randn(n, blk, h, d).astype(np.float32)}


@pytest.mark.parametrize("length", [False, True], ids=["dense", "masked"])
def test_kv_cache_write_rule(length):
    """Slot 0 writes across a page edge, slot 1 from position 9 runs past
    its three pages (over-long rows dropped), slot 2 sits on the sentinel
    and a foreign block id (dropped); with Length the tails are masked."""
    rng = np.random.RandomState(1)
    inputs = _pool_inputs(rng)
    inputs["PageTable"] = np.array([[2, 0, 5], [1, 3, 4], [6, 9, 6]],
                                   np.int32)
    inputs["Index"] = np.array([2, 9, 0], np.int32)
    if length:
        inputs["Length"] = np.array([3, 5, 1], np.int32)
    got, want = _rule("kv_cache_write", inputs, {},
                      ("PoolKOut", "PoolVOut"))
    for name, g, w in zip(("PoolKOut", "PoolVOut"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    # something was written, and the sentinel slot wrote nothing
    assert not np.array_equal(got[0], inputs["PoolK"])


@pytest.mark.parametrize("exact", [False, True], ids=["fast", "exact"])
def test_paged_attention_rule(exact, monkeypatch):
    """Fast: against the JAX package's Pallas kernel (interpret mode),
    with a slot on the sentinel page row and a slot at Index -1, which
    sees no position and gives 0 as the kernel does.  Exact: the full-span
    scattered query."""
    monkeypatch.setenv("FLAGS_paged_attention", "interpret")
    rng = np.random.RandomState(2)
    s, h, d, n, blk = 4, 2, 16, 6, 4
    inputs = {"Q": rng.randn(s, h, 1, d).astype(np.float32),
              "PoolK": rng.randn(n, blk, h, d).astype(np.float32),
              "PoolV": rng.randn(n, blk, h, d).astype(np.float32),
              "PageTable": np.array([[2, 0, 5], [1, 3, 4], [6, 6, 6],
                                     [4, 1, 2]], np.int32),
              "Index": np.array([6, 11, 0, 3 if exact else -1], np.int32)}
    got, want = _rule("paged_attention", inputs, {"exact": exact},
                      ("Out",), exact=exact)
    _close("paged_attention", got[0], want[0], POOL_TOL)
    if not exact:
        assert float(np.abs(got[0][3]).max()) == 0.0


@pytest.mark.parametrize("with_index", [False, True],
                         ids=["slice", "index"])
def test_pos_encoding_add_rule(with_index):
    rng = np.random.RandomState(3)
    table = rng.randn(10, 6).astype(np.float32)
    if with_index:
        inputs = {"X": rng.randn(4, 6).astype(np.float32), "Table": table,
                  "Index": np.array([0, 9, 12, -3], np.int32)}   # clipped
    else:
        inputs = {"X": rng.randn(2, 7, 6).astype(np.float32),
                  "Table": table}
    got, want = _rule("pos_encoding_add", inputs, {}, ("Out",))
    np.testing.assert_array_equal(got[0], want[0])


def test_batched_select_rule_clips():
    rng = np.random.RandomState(4)
    inputs = {"X": rng.randn(4, 5, 3).astype(np.float32),
              "Index": np.array([0, 3, 5, 9], np.int32)}
    got, want = _rule("batched_select", inputs, {"offset": -1}, ("Out",))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0][0], inputs["X"][0, 0])
    np.testing.assert_array_equal(got[0][3], inputs["X"][3, 4])


# ---------------------------------------------------------------------------
# DecodeEngine(scope, spec): twins of tests/test_decode_engine.py
# ---------------------------------------------------------------------------

def _engine(scope, spec, **kw):
    return DecodeEngine(scope, spec, device="cpu", block_len=4, **kw)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(0)
    return [list(rng.randint(2, 61, n)) for n in (5, 3, 19)]


def _streams(engine, prompts, max_new):
    try:
        handles = [engine.submit(p, max_new, capture_logits=True)
                   for p in prompts]
        results = [h.result(timeout=240) for h in handles]
        return results, engine.stats()
    finally:
        engine.close()


def test_exact_mode_requires_full_cache_span(port_scope, spec):
    with pytest.raises(ValueError):
        _engine(port_scope, spec, slots=1, pages_per_slot=2,
                numerics="exact")


def test_exact_decode_bitwise_the_full_recompute_program(
        model_dir, port_scope, spec, prompts):
    """Every token's logits bitwise the exact full-prefix program's row
    (`_load_full_predictor`), across slots of different prompt lengths;
    the prefill emits the first token, so dispatches per token <= 1."""
    results, stats = _streams(_engine(port_scope, spec, slots=3,
                                      numerics="exact"), prompts, 8)
    full = greedy_decode_full(
        model_dir, prompts, 8, capture_logits=True,
        predictor=_load_full_predictor(model_dir, spec, True, device="cpu"))
    assert [r["tokens"] for r in results] == full["tokens"]
    for i, r in enumerate(results):
        for step, a in enumerate(r["logits"]):
            b = full["logits"][step][i]
            assert np.array_equal(a, b), (i, step, np.abs(a - b).max())
    assert stats["dispatches_per_token"] <= 1.0
    assert stats["prefill"]["shapes_seen"] == 1      # the max_len bucket


def test_fast_decode_matches_the_token_stream(model_dir, port_scope, spec,
                                              prompts):
    results, stats = _streams(_engine(port_scope, spec, slots=3), prompts,
                              8)
    full = greedy_decode_full(
        model_dir, prompts, 8, capture_logits=True,
        predictor=_load_full_predictor(model_dir, spec, False, device="cpu"))
    assert [r["tokens"] for r in results] == full["tokens"]
    for i, r in enumerate(results):
        for step, a in enumerate(r["logits"]):
            np.testing.assert_allclose(a, full["logits"][step][i],
                                       atol=1e-4, rtol=1e-4)
    # prompts of 3, 5 and 19 tokens take the 8 and 32 buckets
    assert stats["prefill"]["shapes_seen"] == 2


def test_program_engine_tokens_equal_the_module_engine(model_dir,
                                                       port_scope, spec,
                                                       prompts):
    """The same weights through the Programs and through TransformerLM:
    equal f32 tokens, logits within 1e-4."""
    results, _ = _streams(_engine(port_scope, spec, slots=3), prompts, 10)
    module, _ = _streams(DecodeEngine.from_model_dir(
        model_dir, device="cpu", slots=3, block_len=4), prompts, 10)
    assert [r["tokens"] for r in results] == [r["tokens"] for r in module]
    for r, m in zip(results, module):
        for a, b in zip(r["logits"], m["logits"]):
            _close("program vs module", a, b, LOGITS_TOL)


def test_admission_mid_generation_does_not_perturb_running_stream(
        port_scope, spec):
    pa, pb = [3, 4, 5, 6], [9, 8]
    solo = _engine(port_scope, spec, slots=2)
    try:
        a_alone = solo.generate(pa, max_new_tokens=10, timeout=120)
    finally:
        solo.close()
    eng = _engine(port_scope, spec, slots=2)
    decode = eng.model.decode

    def slow(*a, **k):
        time.sleep(0.02)
        return decode(*a, **k)
    eng.model.decode = slow
    try:
        ha = eng.submit(pa, max_new_tokens=10)
        a_events = []
        gen = ha.events(timeout=120)
        for ev in gen:
            a_events.append(ev)
            if ev[0] == "token" and ev[1] >= 1:
                break
        hb = eng.submit(pb, max_new_tokens=4)
        b_first_step, b_done = None, None
        for ev in hb.events(timeout=120):
            if ev[0] == "token" and b_first_step is None:
                b_first_step = ev[3]
            if ev[0] == "done":
                b_done = ev
        a_events.extend(gen)
        a_tokens = [ev[2] for ev in a_events if ev[0] == "token"]
        a_done = [ev for ev in a_events if ev[0] == "done"][0]
        a_last = max(ev[3] for ev in a_events if ev[0] == "token")
        assert a_done[2] == a_tokens == a_alone["tokens"]
        assert b_done is not None and len(b_done[2]) == 4
        assert b_first_step is not None and b_first_step <= a_last
    finally:
        eng.close()


def test_eos_ends_stream(port_scope, spec):
    eng = _engine(port_scope, spec, slots=1)
    try:
        eos = eng.generate([3, 4, 5], max_new_tokens=3,
                           timeout=120)["tokens"][0]
        r = eng.generate([3, 4, 5], max_new_tokens=8, eos_id=eos,
                         timeout=120)
        assert r["tokens"] == [eos] and r["finish_reason"] == "eos"
        assert eng.stats()["finished"].get("eos") == 1
    finally:
        eng.close()


def test_bf16_kv_pools_under_precision_knob(port_scope, spec):
    eng = _engine(port_scope, spec, slots=1, precision="bf16")
    try:
        assert eng.kv_dtype == "bfloat16"
        for k, v in eng._pools:
            assert k.dtype == v.dtype == torch.bfloat16
        r = eng.generate([3, 4, 5], max_new_tokens=4, timeout=120)
        assert len(r["tokens"]) == 4
        assert all(0 <= t < SPEC["vocab"] for t in r["tokens"])
        assert eng.stats()["decode"]["precision"] == "bf16"
    finally:
        eng.close()


def test_engine_stats_and_metric_families(port_scope, spec):
    from paddle_tpu_torch.observability import snapshot
    eng = _engine(port_scope, spec, slots=2, model="lm")
    try:
        eng.generate([3, 4, 5], max_new_tokens=4, timeout=120)
        st = eng.stats()
        assert st["tokens_total"] == 4 and st["prefills"] == 1
        assert st["iterations"] == 3          # the prefill emits token 0
        assert st["ttft_ms"]["p99"] is not None
        assert st["inter_token_ms"]["p99"] is not None
        assert st["occupancy_mean"] == 0.5
        assert st["dispatches_per_token"] == 1.0
        assert eng.model_name == "lm"
        snap = snapshot()
        for fam in ("decode_tokens_total", "decode_requests_total",
                    "decode_ttft_seconds", "decode_inter_token_seconds",
                    "decode_slot_occupancy", "decode_iterations_total"):
            assert fam in snap, fam
    finally:
        eng.close()


def test_prefix_cache_exact_mode_bitwise(model_dir, port_scope, spec):
    eng = _engine(port_scope, spec, slots=2, numerics="exact",
                  prefix_cache_blocks=4)
    try:
        p = [3, 4, 5, 6, 7, 8, 9, 10]
        cold = eng.submit(p, max_new_tokens=5,
                          capture_logits=True).result(timeout=240)
        hot = eng.submit(p, max_new_tokens=5,
                         capture_logits=True).result(timeout=240)
        assert eng.stats()["prefix"]["hits"] == 1
        assert hot["tokens"] == cold["tokens"]
        for a, b in zip(hot["logits"], cold["logits"]):
            assert np.array_equal(a, b), np.max(np.abs(a - b))
        full = greedy_decode_full(
            model_dir, [p], 5, predictor=_load_full_predictor(
                model_dir, spec, True, device="cpu"))
        assert full["tokens"][0] == cold["tokens"]
    finally:
        eng.close()


def test_constructor_refuses_mixed_sources(model_dir, port_scope, spec):
    lm = PT.params_from_numpy(spec, pio._read_params(model_dir),
                              device="cpu")
    with pytest.raises(ValueError):
        DecodeEngine(lm, spec)
    with pytest.raises(ValueError):
        DecodeEngine(port_scope, None, device="cpu")
    with pytest.raises(TypeError):
        DecodeEngine(os.getcwd(), spec, device="cpu")
