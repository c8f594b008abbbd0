"""The port's hot-row embedding cache, its predictor and registry surface
and live row deltas, against the JAX package's (twins of
test_sharded_embedding.py:470, :494, :532, :546, :595 and :633, and of
test_fleet_control.py:638 for both ``cache_rows`` values), plus the
``lookup_table`` rule's out-of-range ids held to the JAX rule.

The recommender is test_sharded_embedding.py:513's (a 64 x 8 table,
``sequence_pool`` sum, fc 4 softmax), saved by the JAX package and served
on the CPU (``device="cpu"``).  Cached replies are held bitwise to the
uncached predictor's (the cache holds the table's bytes), and after
``apply_deltas`` bitwise to a fresh load of the fully republished model;
the delta chain is written by the JAX ``ModelPublisher``.  Out-of-range
ids: the port's rows equal the JAX rule's bit for bit, NaN for NaN.
"""
import re
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import layers as jlayers
from paddle_tpu import serving as jserving
from paddle_tpu.checkpoint import CheckpointManager
from paddle_tpu.fleet_control import ModelPublisher
from paddle_tpu.serving.hot_rows import HotRowCache as JaxHotRowCache

from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.observability import (default_registry,
                                            render_prometheus, snapshot)
from paddle_tpu_torch.serving import ModelRegistry, Predictor
from paddle_tpu_torch.serving.hot_rows import HotRowCache
from paddle_tpu_torch.serving.registry import DELTA_FILENAME, \
    write_row_delta

V, D = 64, 8


def _pred(model_dir, **kw):
    return Predictor.from_model_dir(model_dir, device="cpu", **kw)


def _save_model(dirname, v=V, d=D):
    """words (ragged) -> embedding [v, d] -> sequence_pool sum -> fc 4
    softmax, saved by the JAX package; returns (dir, params)."""
    main, startup, scope = jfluid.Program(), jfluid.Program(), \
        jfluid.core.scope.Scope()
    with jfluid.program_guard(main, startup), \
            jfluid.unique_name.guard(), jfluid.scope_guard(scope):
        words = jlayers.data(name="words", shape=[1], dtype="int64",
                             lod_level=1)
        emb = jlayers.embedding(input=words, size=[v, d], is_sparse=True,
                                is_distributed=True)
        pooled = jlayers.sequence_pool(emb, pool_type="sum")
        pred = jlayers.fc(input=pooled, size=4, act="softmax")
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        jfluid.io.save_inference_model(str(dirname), ["words"], [pred], exe,
                                       main_program=main)
        params = {n: np.asarray(scope.get(n)).copy()
                  for n in scope.local_var_names()
                  if scope.get(n) is not None}
    return str(dirname), params


def _feed(seed=1, v=V):
    rng = np.random.RandomState(seed)
    return {"words": rng.randint(0, v, (6, 5)).astype(np.int64),
            "words@SEQ_LEN": np.full((6,), 5, np.int32)}


@pytest.fixture(scope="module")
def rec_dir(tmp_path_factory):
    return _save_model(tmp_path_factory.mktemp("rec") / "model")[0]


# ---------------------------------------------------------------------------
# out-of-range ids: the lookup_table rule and the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_lookup_table_out_of_range_ids_follow_the_jax_rule(tmp_path,
                                                           precision):
    """ids [0, -1, -V, -V-1, V, V+7]: negatives in [-V, 0) wrap, the rest
    give the fill row (NaN; for int8 the int8 minimum, dequantized)."""
    v, d = 16, 16                  # 256 elements: int8-eligible
    main, startup, scope = jfluid.Program(), jfluid.Program(), \
        jfluid.core.scope.Scope()
    with jfluid.program_guard(main, startup), \
            jfluid.unique_name.guard(), jfluid.scope_guard(scope):
        ids = jlayers.data(name="ids", shape=[6], dtype="int64")
        emb = jlayers.embedding(input=ids, size=[v, d])
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        jfluid.io.save_inference_model(str(tmp_path), ["ids"], [emb], exe,
                                       main_program=main)
    feed = {"ids": np.array([[0, -1, -v, -v - 1, v, v + 7]], np.int64)}
    want = np.asarray(jserving.Predictor.from_model_dir(
        str(tmp_path), precision=precision).run(feed)[0], np.float32)
    got = _pred(str(tmp_path), precision=precision).run(feed)[0]
    np.testing.assert_array_equal(got, want)     # NaN equals NaN here
    assert np.isnan(got[0, 3:]).all() == (precision == "f32")
    np.testing.assert_array_equal(got[0, 2], got[0, 0])   # -V wraps to 0


def test_out_of_range_ids_follow_dense_take_semantics():
    rng = np.random.RandomState(5)
    table = rng.randn(32, 4).astype(np.float32)
    ids = np.array([0, -1, -32, 31], np.int64)
    cache = HotRowCache(table, 8, device="cpu")
    got = cache.lookup(ids).numpy()
    assert got.tobytes() == table[ids].tobytes()    # wraps as numpy does
    over = cache.lookup(np.array([32, -33], np.int64)).numpy()
    assert np.isnan(over).all()                     # fill, not a clamp
    assert cache._counts[0] == 2                    # -32 wrapped to 0
    q = HotRowCache(rng.randint(-127, 128, (32, 4)).astype(np.int8), 8,
                    device="cpu")
    assert (q.lookup(np.array([40])).numpy() == -128).all()


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

def test_hot_row_cache_bitwise_and_promotion_under_zipf():
    rng = np.random.RandomState(7)
    table = rng.randn(256, 8).astype(np.float32)
    cache = HotRowCache(table, budget_rows=64, refresh_every=4,
                        device="cpu")
    jcache = JaxHotRowCache(table, budget_rows=64, refresh_every=4)
    for _ in range(32):
        ids = np.minimum(rng.zipf(1.1, (64,)), 256) - 1
        out = cache.lookup(ids).numpy()
        # bitwise whether a row came from the device cache or the host
        assert out.tobytes() == table[ids].tobytes()
        jcache.lookup(ids)
    assert cache.promotions > 0
    assert cache.hits > 0 and cache.misses > 0
    # the same counters and sweep as the JAX cache, lookup for lookup
    assert (cache.hits, cache.misses, cache.promotions) == \
        (jcache.hits, jcache.misses, jcache.promotions)
    assert np.array_equal(np.sort(cache._row_in_slot),
                          np.sort(jcache._row_in_slot))
    # the hot head is resident now: a head-only batch is all hits
    h0 = cache.hits
    cache.lookup(np.zeros((16,), np.int64))
    assert cache.hits == h0 + 16
    s = cache.stats()
    assert s["budget_rows"] == 64 and s["device_bytes"] == 64 * 8 * 4
    assert s["host_bytes"] == 256 * 8 * 4 and s["table_rows"] == 256


def test_cache_apply_delta_refreshes_resident_rows():
    rng = np.random.RandomState(2)
    table = rng.randn(32, 4).astype(np.float32)
    cache = HotRowCache(table, budget_rows=8, refresh_every=1,
                        device="cpu")
    cache.lookup(np.arange(8))                     # promotes 0..7
    assert (cache._slot_of[:8] >= 0).all()
    new = rng.randn(3, 4).astype(np.float32)
    assert cache.apply_delta([1, 2, 20], new) == 3
    table[[1, 2, 20]] = new
    ids = np.array([1, 2, 20, 5])
    assert cache.lookup(ids).numpy().tobytes() == table[ids].tobytes()
    with pytest.raises(ValueError):
        cache.apply_delta([40], new[:1])
    with pytest.raises(ValueError):
        cache.apply_delta([1, 2], new)


def test_embedding_cache_metric_families_count():
    reg = default_registry()
    was = reg.enabled
    reg.enable()
    try:
        rng = np.random.RandomState(0)
        cache = HotRowCache(rng.randn(32, 4).astype(np.float32), 8,
                            name="m_test", refresh_every=2, device="cpu")
        for _ in range(4):
            cache.lookup(np.arange(8))
        snap = snapshot(reg)
        hits = snap["embedding_cache_hits_total"]["series"]
        assert any("m_test" in k for k in hits)
        assert "embedding_cache_promotions_total" in snap
        assert "embedding_cache_misses_total" in snap
    finally:
        if not was:
            reg.disable()


# ---------------------------------------------------------------------------
# the predictor and the wire
# ---------------------------------------------------------------------------

def test_cached_predictor_bitwise_and_stats(rec_dir):
    feed = _feed()
    ref = _pred(rec_dir).run(dict(feed))
    pred = _pred(rec_dir, embedding_cache_rows=16)
    assert pred._row_caches            # the table left the device params
    assert "embedding_0.w_0" not in pred._params
    for _ in range(3):
        got = pred.run(dict(feed))
        assert got[0].tobytes() == ref[0].tobytes()
    (tstats,) = pred.stats()["embedding_cache"].values()
    assert tstats["budget_rows"] == 16
    assert tstats["hits"] + tstats["misses"] == 3 * 30
    # and the reply is the JAX predictor's
    want = jserving.Predictor.from_model_dir(rec_dir).run(dict(feed))[0]
    np.testing.assert_allclose(got[0], np.asarray(want), atol=1e-6)


def test_int8_cache_rows_bitwise_vs_int8_uncached(rec_dir):
    feed = _feed()
    ref = _pred(rec_dir, precision="int8").run(dict(feed))
    pred = _pred(rec_dir, precision="int8", embedding_cache_rows=16)
    (cache,) = pred._row_caches.values()
    assert cache._host.dtype == torch.int8    # 4x rows per device byte
    got = pred.run(dict(feed))
    assert got[0].tobytes() == ref[0].tobytes()
    with pytest.raises(ValueError, match="int8"):
        pred.apply_row_deltas({"embedding_0.w_0": ([0], np.zeros((1, D)))})


def test_cache_serving_e2e_through_unchanged_wire(rec_dir):
    feed = _feed()
    ref = _pred(rec_dir).run(dict(feed))
    reg = ModelRegistry(device="cpu")
    reg.load("rec", rec_dir, embedding_cache_rows=16, warmup=[])
    server = tserving.InferenceServer(reg, port=0, port_file="").start()
    try:
        with jserving.ServingClient(f"127.0.0.1:{server.port}") as c:
            out = c.infer({"words": feed["words"].tolist(),
                           "words@SEQ_LEN": feed["words@SEQ_LEN"].tolist()},
                          model="rec")
            # no delta published yet: the wire verb is a no-op
            assert c.apply_deltas("rec") == {
                "applied": False, "stale": False, "seq": None,
                "step": None, "rows": 0}
        got = np.asarray(next(iter(out.values())), np.float32)
        assert got.tobytes() == ref[0].astype(np.float32).tobytes()
        assert reg.get("rec").predictor.stats()["embedding_cache"]
    finally:
        server.stop()
        reg.close()


# ---------------------------------------------------------------------------
# live row deltas
# ---------------------------------------------------------------------------

def _delta_rows(text):
    m = re.search(r'embedding_delta_rows_total\{model="rec"\} (\d+)', text)
    return int(m.group(1)) if m else 0


@pytest.mark.parametrize("cache_rows", [0, 16])
def test_publish_deltas_chain_applies_live(tmp_path, cache_rows):
    """A trainer's row delta, published by the JAX ModelPublisher,
    rolls onto a loaded port model without a reload: replies go bitwise
    to a fresh load of the full republish, the delta-rows counter moves,
    re-polling is a no-op, and a broken lineage reads as stale."""
    mdir, params = _save_model(tmp_path / "model")
    table = [n for n in params if n.startswith("embedding_")][0]
    mgr = CheckpointManager(str(tmp_path / "ckpts"), async_save=False)
    mgr.save(1, params, block=True)
    pub = ModelPublisher(str(tmp_path / "ckpts"), mdir)
    pub.publish(1)
    obs = default_registry()
    was = obs.enabled
    obs.enable()
    rows_before = _delta_rows(render_prometheus())
    reg = ModelRegistry(device="cpu")
    reloads = []
    reg.reload = lambda *a, **k: reloads.append(a)
    try:
        kw = {"embedding_cache_rows": cache_rows} if cache_rows else {}
        reg.load("rec", mdir, warmup=[], **kw)
        assert bool(reg.get("rec").predictor._row_caches) == \
            bool(cache_rows)
        rng = np.random.RandomState(0)
        feed = {"words": rng.randint(0, V, (6, 5)).astype(np.int64),
                "words@SEQ_LEN": np.full((6,), 5, np.int32)}
        base_out = np.asarray(reg.infer("rec", dict(feed))[0])
        assert reg.apply_deltas("rec")["applied"] is False

        p2 = {n: a.copy() for n, a in params.items()}
        hot = rng.choice(V, 10, replace=False)
        p2[table][hot] += 1.5
        mgr.save(2, p2, block=True)
        res = pub.publish_deltas()
        assert res["seq"] == 1 and res["rows_total"] == 10
        assert reg.apply_deltas("rec") == {"applied": True, "stale": False,
                                           "seq": 1, "step": 2, "rows": 10}
        assert reg.apply_deltas("rec")["applied"] is False   # idempotent
        assert reg.get("rec").describe()["delta_seq"] == 1

        mdir2 = str(tmp_path / "model2")
        shutil.copytree(mdir, mdir2)
        ModelPublisher(str(tmp_path / "ckpts"), mdir2).publish(2)
        ref = _pred(mdir2).run(dict(feed))[0]
        got = np.asarray(reg.infer("rec", dict(feed))[0])
        assert got.tobytes() == ref.tobytes()
        assert got.tobytes() != base_out.tobytes()

        # the chain goes on: step 3 -> seq 2, linked to seq 1
        p3 = {n: a.copy() for n, a in p2.items()}
        p3[table][:3] -= 0.25
        mgr.save(3, p3, block=True)
        assert pub.publish_deltas()["seq"] == 2
        d3 = reg.apply_deltas("rec")
        assert d3["applied"] is True and d3["seq"] == 2 and d3["rows"] == 3
        assert _delta_rows(render_prometheus()) == rows_before + 13
        assert reloads == []

        # a fresh load (its base is the step-1 artifact) against a head
        # whose prev_seq is 1: stale, not a wrong apply
        reg2 = ModelRegistry(device="cpu")
        reg2.load("rec", mdir, warmup=[], **kw)
        ds = reg2.apply_deltas("rec")
        assert ds["stale"] is True and ds["applied"] is False
        reg2.close()
    finally:
        reg.close()
        if not was:
            obs.disable()


def test_write_row_delta_chain_is_the_publishers_format(tmp_path):
    """The port's link writer gives a chain the registry applies as it
    applies the JAX publisher's, and that the JAX registry reads too."""
    mdir, params = _save_model(tmp_path / "model")
    table = "embedding_0.w_0"
    reg = ModelRegistry(device="cpu")
    jreg = jserving.ModelRegistry()
    try:
        reg.load("rec", mdir, warmup=[], embedding_cache_rows=16)
        jreg.load("rec", mdir, warmup=[])
        rows = np.array([1, 5, 9])
        vals = np.full((3, D), 0.5, np.float32)
        rec = write_row_delta(mdir, {table: (rows, vals)}, step=7)
        assert rec["seq"] == 1 and rec["prev_seq"] is None
        assert (tmp_path / "model" / DELTA_FILENAME).exists()
        assert reg.apply_deltas("rec")["rows"] == 3
        assert jreg.apply_deltas("rec")["rows"] == 3
        p2 = dict(params)
        p2[table] = params[table].copy()
        p2[table][rows] = vals
        feed = _feed(3)
        got = np.asarray(reg.infer("rec", dict(feed))[0])
        want = np.asarray(jreg.infer("rec", dict(feed))[0])
        np.testing.assert_allclose(got, want, atol=1e-6)
        assert write_row_delta(mdir, {table: (rows[:1], vals[:1])},
                               step=8)["prev_seq"] == 1
        assert reg.apply_deltas("rec")["seq"] == 2
    finally:
        reg.close()
        jreg.close()
