"""Twins of tests/test_sharded_embedding.py and tests/test_parallel.py:58
and :70: the port's row-sharded embedding tables (`parallel.embedding`),
the id exchange, tiered tables and the sharded recommender's serving.

The multi-rank cases run on one 4-rank gloo pool (`_torch_mesh_pool`),
every rank on the same global feeds.  The JAX package runs the same
model single-device in this process (its 8 virtual CPU devices for its
own sharded lookups) and saves its initial state, which the ranks load.
The port's mesh runs are held bitwise to the port's single-process run,
and that run within ``TOL`` of the JAX package's (``BF16_TOL``, the
port's bf16 rule, under MixedPrecision, whose bf16 products round in
another order than XLA's).  Where the JAX test uses an ep=2 mesh of its
8 devices, the port's 4-rank world uses ``{"dp": 2, "ep": 2}``.
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu import layers as jlayers, optimizer as joptimizer

import paddle_tpu_torch as fluid
from paddle_tpu_torch.parallel import embedding as emb

from _torch_mesh_pool import RankPool
import torch_sharded_embedding_ranks as R

RANKS = "torch_sharded_embedding_ranks"
TOL = 1e-5
BF16_TOL = 2e-2
V, D = R.V, R.D
TABLE = R.TABLE


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp("gloo"))
    yield p
    p.close()


def _jax_build(opt="adam", mp=False, is_distributed=False, v=V, d=D):
    jfluid.core.program.reset_default_programs()
    jfluid.global_scope().clear()
    words = jlayers.data(name="words", shape=[1], dtype="int64",
                         lod_level=1)
    e = jlayers.embedding(input=words, size=[v, d], is_sparse=True,
                          is_distributed=is_distributed)
    pooled = jlayers.sequence_pool(e, pool_type="sum")
    pred = jlayers.fc(input=pooled, size=2, act="softmax")
    label = jlayers.data(name="label", shape=[1], dtype="int64")
    loss = jlayers.mean(jlayers.cross_entropy(input=pred, label=label))
    o = {"adam": lambda: jfluid.optimizer.Adam(learning_rate=1e-2),
         "sgd": lambda: jfluid.optimizer.SGD(learning_rate=0.1),
         "momentum": lambda: jfluid.optimizer.Momentum(
             learning_rate=0.1, momentum=0.9)}[opt]()
    if mp:
        o = joptimizer.MixedPrecision(o)
    o.minimize(loss)
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(jfluid.default_startup_program())
    return exe, jfluid.default_main_program(), loss


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """(opt, mp, steps, **train_loop kw) -> the JAX single-device run of
    the JAX test's model: (its initial state's dir, losses, params, the
    executor), each configuration run once for the module."""
    base = tmp_path_factory.mktemp("jax")
    cache = {}

    def run(opt="adam", mp=False, steps=8, ids_mod=None, **kw):
        key = (opt, mp, steps, ids_mod, repr(sorted(kw.items())))
        if key not in cache:
            exe, prog, loss = _jax_build(opt, mp)
            d = str(base / f"state{len(cache)}")
            jfluid.io.save_persistables(exe, d, prog)
            losses = [np.asarray(h.get()[0]) for h in exe.train_loop(
                prog, R.make_feeds(ids_mod=ids_mod), fetch_list=[loss],
                steps=steps, **kw)]
            scope = jfluid.global_scope()
            params = {n: np.asarray(scope.get(n))
                      for n in scope.local_var_names()
                      if scope.get(n) is not None and not n.startswith("@")}
            cache[key] = (d, losses, params, exe)
        return cache[key]
    return run


def _close(ref, got, tol=TOL):
    for a, b in zip(ref, got):
        np.testing.assert_allclose(np.asarray(b, np.float64),
                                   np.asarray(a, np.float64), rtol=0,
                                   atol=tol)


def _held(outs, jl, jp=None, tol=TOL):
    """Every rank bitwise its single-process run, and that run within
    ``tol`` of the JAX package's losses (and params)."""
    for r, o in enumerate(outs):
        assert o["bitwise"] is None, (r, o["bitwise"])
    _close(jl, outs[0]["ref_losses"], tol)
    if jp is not None:
        for n, v in jp.items():
            _close([v], [outs[0]["params"][n]], tol)


# ---------------------------------------------------------------------------
# training parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4])
def test_sharded_train_bitwise_vs_single_device(pool, jax_run, k):
    """ep=4 exact: the psum lookup and the shard-local sparse Adam update
    bitwise the single-process run (losses, table, both moments), per
    step and in K=4 windows, a launch a window; the report names the
    4-rank mesh; each rank holds a quarter of the table and moments."""
    d, jl, jp, _ = jax_run()
    outs = pool.run(f"{RANKS}:train", mesh={"ep": 4}, k=k, state_dir=d)
    _held(outs, jl, jp)
    o = outs[0]
    assert o["launches"] <= -(-8 // k)
    assert o["report"]["mesh_shape"] == {"ep": 4}
    assert o["report"]["num_devices"] == 4
    for n in (TABLE, TABLE + ".moment1_0", TABLE + ".moment2_0"):
        assert o["resident"][n] == (V // 4, D)
        assert o["specs"][n] == ("ep", None)


@pytest.mark.parametrize("k", [1, 4])
def test_sharded_bitwise_with_mixed_precision(pool, jax_run, k):
    """MixedPrecision (its SelectedRows-aware unscale and skip) composes
    with the sharded lookup and update: still bitwise."""
    d, jl, _, _ = jax_run(mp=True)
    outs = pool.run(f"{RANKS}:train", mesh={"ep": 4}, k=k, mp=True,
                    state_dir=d)
    _held(outs, jl, tol=BF16_TOL)


@pytest.mark.parametrize("opt", ["sgd", "momentum"])
def test_other_sparse_optimizers_shard_bitwise(pool, jax_run, opt):
    d, jl, jp, _ = jax_run(opt=opt, steps=6)
    outs = pool.run(f"{RANKS}:train", opt=opt, steps=6, mesh={"ep": 4},
                    state_dir=d)
    _held(outs, jl, jp)


def test_ep_and_dp_axes_compose(pool, jax_run):
    """{"dp": 2, "ep": 2}: the feed on dp, the table on ep, exact."""
    d, jl, jp, _ = jax_run()
    outs = pool.run(f"{RANKS}:train", mesh={"dp": 2, "ep": 2}, state_dir=d)
    _held(outs, jl, jp)
    assert outs[0]["resident"][TABLE] == (V // 2, D)


@pytest.mark.parametrize("mesh,exchange", [
    ({"ep": 4}, None), ({"ep": 4}, "a2a"), ({"dp": 2, "ep": 2}, None),
    ({"dp": 2, "ep": 2}, "a2a")])
def test_fast_numerics_within_tolerance(pool, jax_run, mesh, exchange):
    """Fast numerics slices the batch on the data axis ("ep" itself on
    an ep-only mesh): the lookup gathers the ids (psum) or takes the
    rank's block (exchange), the gradient pairs gather in rank order;
    losses within TOL of the single-process run, every rank the same."""
    d, jl, _, _ = jax_run()
    outs = pool.run(f"{RANKS}:train", mesh=mesh, numerics="fast",
                    exchange=exchange, state_dir=d)
    o = outs[0]
    _close(o["ref_losses"], o["losses"])
    _close(jl, o["losses"])
    for x in outs[1:]:
        assert [a.tobytes() for a in x["losses"]] == \
            [a.tobytes() for a in o["losses"]]
    if exchange and "dp" not in mesh:
        # the rank's block rides the exchange: no all-gather of ids
        assert "all-gather" not in o["ledger"]["kinds"]


def test_replicated_sparse_table_on_dp_mesh(pool, jax_run):
    """An is_sparse table replicated on a dp=4 mesh, fast: its pairs
    gather over dp in rank order, every replica merges the same pairs
    and stays in step."""
    d, jl, _, _ = jax_run()
    outs = pool.run(f"{RANKS}:train", mesh={"dp": 4}, numerics="fast",
                    is_distributed=False, state_dir=d)
    _close(jl, outs[0]["losses"])
    _close(outs[0]["ref_losses"], outs[0]["losses"])
    assert outs[0]["resident"][TABLE] == (V, D)
    for o in outs[1:]:
        assert o["local_bytes"] == outs[0]["local_bytes"]


def test_duplicate_id_merge_matches_loop_oracle():
    from paddle_tpu_torch.ops.optimizer_ops import merge_selected_rows
    import torch
    rng = np.random.RandomState(0)
    rows = rng.randint(0, 16, (40,)).astype(np.int32)
    values = rng.randn(40, 4).astype(np.float32)
    uniq, merged = merge_selected_rows(torch.from_numpy(rows),
                                       torch.from_numpy(values), 16)
    oracle = {}
    for r, v in zip(rows, values):
        oracle[int(r)] = oracle.get(int(r), np.zeros(4, np.float32)) + v
    assert uniq.tolist() == sorted(oracle)
    for r, v in zip(uniq.tolist(), merged.numpy()):
        np.testing.assert_allclose(v, oracle[r], rtol=1e-6)


# ---------------------------------------------------------------------------
# placement and validation
# ---------------------------------------------------------------------------

def test_is_distributed_without_mesh_raises():
    exe, loss, feeds = R.build(True)
    for call in (lambda: exe.train_loop(feed=feeds, fetch_list=[loss],
                                        steps=2),
                 lambda: exe.run(feed=feeds[0], fetch_list=[loss])):
        with pytest.raises(ValueError, match="no mesh") as ei:
            call()
        assert "queue A item 4" not in str(ei.value)


def test_is_distributed_on_mesh_without_ep_raises(pool):
    msgs = pool.run(f"{RANKS}:refused_without_row_axis")
    assert all(m and "row-shard" in m for m in msgs), msgs


def test_one_device_mesh_falls_back_to_dense(jax_run):
    """ep=1 runs the dense path: bitwise the single-process run."""
    d, jl, _, _ = jax_run()
    ref_l, ref_p = R.reference(state_dir=d)
    exe, loss, feeds = R.build(True, state_dir=d)
    handles = exe.train_loop(feed=feeds, fetch_list=[loss], steps=8,
                             mesh={"ep": 1})
    assert R.bitwise(ref_l, ref_p, R.losses_of(handles),
                     R.snapshot()) is None
    _close(jl, ref_l)


def test_table_spec_derivation_covers_accumulators(pool):
    """derive_table_specs row-shards the table and its [V, D] Adam
    moments (not the beta pows), as the JAX function does on the same
    program; table_row_axis routes the table and not the fc weight."""
    from paddle_tpu.parallel import create_mesh as jcreate_mesh
    from paddle_tpu.parallel.embedding import (
        derive_table_specs as jderive, table_row_axis as jrow_axis)
    from paddle_tpu.parallel.partitioner import Partitioner as JPartitioner
    _, jprog, _ = _jax_build(is_distributed=True)
    jspecs = jderive(jprog, jcreate_mesh({"ep": 4}))
    jpart = JPartitioner(mesh={"ep": 4}, data_axis="ep", table_specs=jspecs)
    out = pool.run(f"{RANKS}:placement")[0]
    assert out["specs"] == {n: tuple(s) for n, s in jspecs.items()}
    assert len([n for n in out["specs"] if ".moment" in n]) == 2
    assert not any("pow_acc" in n for n in out["specs"])
    assert out["table_axis"] == jrow_axis(jpart, TABLE, (V, D)) == "ep"
    assert out["fc_axis"] is None is jrow_axis(jpart, "fc_0.w_0", (D, 2))


def test_explicit_rule_row_shards_without_is_distributed(pool, jax_run):
    """A param_spec rule that row-shards the plain is_sparse table takes
    the same sharded path: is_distributed is the spelling, not the
    mechanism."""
    d, jl, jp, _ = jax_run()
    outs = pool.run(f"{RANKS}:train", mesh={"ep": 4}, rule=True,
                    is_distributed=False, state_dir=d)
    _held(outs, jl, jp)
    assert outs[0]["specs"][TABLE] == ("ep", None)
    assert outs[0]["resident"][TABLE] == (V // 4, D)


# ---------------------------------------------------------------------------
# capacity
# ---------------------------------------------------------------------------

def test_capacity_is_per_shard_and_no_dense_grad(pool):
    """A 4096 x 64 table (1 MiB) on ep=4: each rank's resident table and
    moments are [V/4, D], the report's per-rank argument bytes stay under
    the whole table's, the gradient is SelectedRows, and no collective of
    the steps moves a [V, D] (or [V/4, D]) tensor."""
    big_v, big_d = 4096, 64
    table_bytes = big_v * big_d * 4
    for o in pool.run(f"{RANKS}:capacity", big_v, big_d):
        assert np.isfinite(o["loss"]).all()
        assert all(s == (big_v // 4, big_d)
                   for s in o["resident"].values() if len(s) == 2)
        assert o["resident_bytes"] == 3 * table_bytes // 4
        assert 0 < o["argument_bytes"] < table_bytes
        assert o["grad_type"].endswith("SELECTED_ROWS")
        biggest = max(e["bytes"] / e["count"] for e in o["kinds"].values())
        assert biggest < table_bytes // 4


def test_lookup_is_bitwise_and_psum_bytes_constant_in_shard_count(pool):
    """The psum lookup is bitwise the dense take, and its all-reduce
    moves the [N, D] output, 5 * 7 * 8 * 4 bytes, at ep 2 and 4."""
    rng = np.random.RandomState(0)
    table = rng.randn(32, 8).astype(np.float32)
    ids = rng.randint(0, 32, (5, 7)).astype(np.int32)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids),
                               axis=0))
    for o in pool.run(f"{RANKS}:lookup_bytes"):
        for ep in (2, 4):
            assert o[ep]["rows"].tobytes() == want.tobytes()
            assert o[ep]["shard"] == (32 // ep, 8)
            assert o[ep]["kinds"] == {"all-reduce": {
                "count": 1, "bytes": 5 * 7 * 8 * 4}}


def test_sharded_embedding_lookup(pool):
    """tests/test_parallel.py:58, at ep=4 (the port's world)."""
    for o in pool.run(f"{RANKS}:parallel_lookup"):
        np.testing.assert_allclose(o["got"], o["want"], rtol=1e-6)


def test_sharded_embedding_grads_flow(pool):
    """tests/test_parallel.py:70: the gradient of a dense row-sharded
    table reaches the looked-up rows only, each in its owner's shard."""
    for o in pool.run(f"{RANKS}:grads_flow"):
        g = o["grad"]
        assert o["shard"] == (8, 8)
        assert g[1].sum() != 0 and g[9].sum() != 0 and g[30].sum() != 0
        assert g[0].sum() == 0
        np.testing.assert_array_equal(g[[1, 9, 30]], 2.0)


@pytest.mark.parametrize("numerics,exchange", [
    ("exact", None), ("exact", "a2a"), ("fast", None), ("fast", "a2a")])
def test_dense_distributed_table_trains_on_its_shards(pool, numerics,
                                                      exchange):
    """An is_distributed table without is_sparse: its gradient is a
    dense [V/4, D] shard, the lookup's backward writing only the rank's
    rows (gathering the gradient over the data axis first under fast
    numerics on ep, where the step reduces it no further): bitwise the
    single-process dense run under exact numerics, within TOL under
    fast, every rank the same losses."""
    outs = pool.run(f"{RANKS}:dense_table", numerics, exchange)
    o = outs[0]
    if numerics == "exact":
        assert R.bitwise(o["ref_losses"], o["ref_params"], o["losses"],
                         o["params"]) is None
    _close(o["ref_losses"], o["losses"])
    for n, v in o["ref_params"].items():
        _close([v], [o["params"][n]])
    assert o["resident"] == (V // 4, D)
    for x in outs[1:]:
        assert [a.tobytes() for a in x["losses"]] == \
            [a.tobytes() for a in o["losses"]]


def test_sharded_row_add_forms_match_the_whole_table(pool):
    """The sgd forms alone: sharded_row_add (merged pairs) and
    sharded_row_add_a2a (raw pairs over the exchange) give the whole
    table's scatter-add of -lr * merged, bitwise."""
    for o in pool.run(f"{RANKS}:row_add"):
        assert o["psum"].tobytes() == o["want"].tobytes()
        assert o["a2a"].tobytes() == o["want"].tobytes()


def test_minus_zero_keeps_its_sign(pool):
    """A -0.0 table entry comes back -0.0 through the psum lookup (its
    all-reduce sums int32 words), the exchange and the int8 path's bf16
    rows, bitwise the dense take.  The JAX package's psum lookup turns
    it into +0.0 (its f32 psum adds the other shards' +0.0): a fault of
    the reference, recorded in ROADMAP queue C."""
    import torch
    from paddle_tpu_torch.ops.nn_ops import embedding_lookup
    from paddle_tpu.parallel import create_mesh as jcreate_mesh
    from paddle_tpu.parallel.embedding import (
        sharded_embedding_lookup as jlookup)
    from jax.sharding import NamedSharding, PartitionSpec as JP
    ids = np.array([5, 20, 1])
    o = pool.run(f"{RANKS}:minus_zero")[0]
    want = o["table"][ids]
    assert np.signbit(want[0, 2]) and np.signbit(want[1, 0])
    assert o["psum"].tobytes() == want.tobytes()
    assert o["a2a"].tobytes() == want.tobytes()
    q = torch.ones((32, 8), dtype=torch.int8)
    q[5, 2] = 0
    dense = embedding_lookup(q, torch.from_numpy(ids),
                             torch.full((8,), -1.0))
    assert o["int8"].tobytes() == dense.view(torch.int16).numpy().tobytes()
    mesh = jcreate_mesh({"ep": 4})
    sh = jax.device_put(jnp.asarray(o["table"]),
                        NamedSharding(mesh, JP("ep", None)))
    jgot = np.asarray(jlookup(sh, jnp.asarray(ids), mesh, "ep"))
    assert not np.signbit(jgot[0, 2]) and not np.signbit(jgot[1, 0])
    np.testing.assert_array_equal(jgot, want)       # equal as numbers


def test_all_to_all_on_gloo_bitwise_and_counted(pool):
    """The tiled all-to-all moves every bit pattern (-0.0, NaN) and
    counts the payload it delivers to the rank under "all-to-all"; the
    card's gloo ranks run the same all_to_all_single on CUDA tensors
    (ROADMAP queue C)."""
    outs = pool.run(f"{RANKS}:all_to_all_bits")
    for r, o in enumerate(outs):
        want = np.stack([outs[j]["sent"][r] for j in range(4)])
        assert o["got"].tobytes() == want.tobytes()
        assert o["ledger"]["kinds"] == {"all-to-all": {"count": 1,
                                                       "bytes": 32}}


# ---------------------------------------------------------------------------
# the id exchange
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt,k", [("adam", 1), ("adam", 4), ("sgd", 1)])
def test_a2a_exchange_bitwise_vs_psum(pool, jax_run, opt, k):
    """lookup_exchange="a2a" exact, at capacity None (full-safe) and at
    the capacity planned from the feeds (the JAX planner's number):
    bitwise the single-process run."""
    from paddle_tpu.parallel.embedding import plan_a2a_capacity as jplan
    d, jl, jp, _ = jax_run(opt=opt)
    planned = jplan([f["words"].reshape(-1) for f in R.make_feeds()], 4,
                    vocab=V)
    assert 0 < planned < V
    for cap, plan in ((None, False), (planned, True)):
        outs = pool.run(f"{RANKS}:train", opt=opt, k=k, mesh={"ep": 4},
                        exchange="a2a", plan=plan, state_dir=d)
        _held(outs, jl, jp)
        assert outs[0]["capacity"] == cap
        assert "all-to-all" in outs[0]["ledger"]["kinds"]
        assert "all-reduce" not in outs[0]["ledger"]["kinds"]


@pytest.mark.parametrize("exchange", ["psum", "a2a"])
def test_negative_ids_wrap_in_the_sharded_update(pool, exchange):
    """Ids in [-V, 0) wrap in the lookup and in the sharded update, as
    the port's single-process merge wraps them: bitwise its run.  The
    JAX package's merge and `_bucket_by_owner` take only [0, V), so its
    sparse update drops those ids' gradients while its lookup wraps them
    (ROADMAP queue C, SelectedRows)."""
    outs = pool.run(f"{RANKS}:train", mesh={"ep": 4}, exchange=exchange,
                    neg=True, steps=4)
    for o in outs:
        assert o["bitwise"] is None, o["bitwise"]
    assert all(np.isfinite(x).all() for x in outs[0]["losses"])


def test_a2a_policy_rides_partitioner(pool):
    """The Partitioner carries the exchange (and its fingerprint and
    description name it); an unknown policy is refused."""
    out = pool.run(f"{RANKS}:placement")[0]
    assert out["a2a"] == ("a2a", 3, "a2a")
    assert out["fp_differs"]
    assert "lookup_exchange" in out["refused"]


def test_exchange_helpers_match_jax():
    """_bucket_by_owner, resolve_a2a_capacity and plan_a2a_capacity give
    the JAX functions' results on the same ids (overflowing buckets,
    out-of-range ids, every capacity)."""
    import torch
    from paddle_tpu.parallel import embedding as jemb
    rng = np.random.RandomState(7)
    ids = rng.randint(-4, 40, 24).astype(np.int32)
    for cap in (1, 3, 6, 12):
        got = emb._bucket_by_owner(torch.from_numpy(ids), 8, 4, cap)
        want = jemb._bucket_by_owner(jnp.asarray(ids), 8, 4, cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for cap in (None, 0, 3, 100):
        for n in (1, 7, 32):
            assert emb.resolve_a2a_capacity(cap, n, 4) == \
                jemb.resolve_a2a_capacity(cap, n, 4)
    zipf = [np.minimum(rng.zipf(1.1, (8, 16)), 99) - 1 for _ in range(3)]
    for batches, nsh, kw in ((zipf, 4, {}), (zipf, 2, {"vocab": 100}),
                             ([ids[ids >= 0]], 4, {"slack": 1.0}),
                             ([], 4, {})):
        assert emb.plan_a2a_capacity(batches, nsh, **kw) == \
            jemb.plan_a2a_capacity(batches, nsh, **kw)


def test_attribution_reads_the_lookup_collectives(pool):
    """psum_share reads the lookup's all-reduce on a psum step, and on an
    exchange step the roofline's lookup_a2a_bytes_per_step is the hand
    count: ids (4 B) and rows (D * 4 B) of nsh * capacity slots, out and
    back, for the lookup and the update."""
    o = pool.run(f"{RANKS}:attribution")[0]
    ps = o["psum"]
    ar = ps["collectives"]["kinds"]["all-reduce"]["bytes"]
    assert ar == ps["ids"] * D * 4
    assert ps["psum_share"] == pytest.approx(ar / ps["bytes_accessed"])
    a2a = o["a2a"]
    nsh, n = 2, a2a["ids"]
    cap = -(-n // nsh)
    per_exchange = nsh * cap * 4 + nsh * cap * D * 4
    assert a2a["roofline"]["lookup_a2a_bytes_per_step"] == 2 * per_exchange


# ---------------------------------------------------------------------------
# tiered tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_tiered_table_bitwise_vs_untiered(jax_run, opt):
    """A [40, D] device pool over the host [64, D] table trains bitwise
    the all-resident run, with the JAX package's hit, miss and eviction
    counts on the same feeds."""
    d, jl, _, _ = jax_run(opt=opt)
    _, _, _, jexe = jax_run(opt=opt, tiered={TABLE: 40})
    ref_l, ref_p = R.reference(opt, state_dir=d)
    exe, loss, feeds = R.build(False, opt=opt, state_dir=d)
    handles = exe.train_loop(feed=feeds, fetch_list=[loss], steps=8,
                             tiered={TABLE: 40})
    assert R.bitwise(ref_l, ref_p, R.losses_of(handles),
                     R.snapshot()) is None
    _close(jl, ref_l)
    st, jst = exe.last_tiered.stats(), jexe.last_tiered.stats()
    for key in ("steps", "hits", "misses", "evictions", "tiered_hit_rate"):
        assert st[key] == jst[key], key
    assert st["evictions"] > 0 and 0.0 < st["tiered_hit_rate"] < 1.0
    assert st["tiered_pool_rows"] == 40


def test_tiered_fused_window_bitwise(jax_run):
    """steps_per_launch=4 stages the window's union of ids once (ids
    kept in [0, 32) so that the union fits C=40): bitwise."""
    d, jl, _, _ = jax_run(ids_mod=32)
    _, _, _, jexe = jax_run(ids_mod=32, steps_per_launch=4,
                            tiered={TABLE: 40})
    ref_l, ref_p = R.reference(state_dir=d, ids_mod=32)
    exe, loss, feeds = R.build(False, state_dir=d, ids_mod=32)
    handles = exe.train_loop(feed=feeds, fetch_list=[loss], steps=8,
                             steps_per_launch=4, tiered={TABLE: 40})
    assert R.bitwise(ref_l, ref_p, R.losses_of(handles),
                     R.snapshot()) is None
    assert exe.last_tiered.stats() == dict(jexe.last_tiered.stats(),
                                           tiered_pool_rows=40)


def test_tiered_checkpoint_midrun_resume_bitwise(tmp_path, jax_run):
    """A checkpoint under tiering holds the whole table, so a resumed
    tiered run is bitwise the uninterrupted untiered one."""
    d, _, _, _ = jax_run()
    ref_l, ref_p = R.reference(state_dir=d)
    ck = str(tmp_path / "ck")
    exe, loss, feeds = R.build(False, state_dir=d)
    head = R.losses_of(exe.train_loop(
        feed=feeds, fetch_list=[loss], steps=4, tiered={TABLE: 40},
        checkpoint_dir=ck, checkpoint_every=2))
    exe, loss, feeds = R.build(False, state_dir=d)
    tail = R.losses_of(exe.train_loop(
        feed=feeds, fetch_list=[loss], steps=8, tiered={TABLE: 40},
        resume_from=ck))
    assert R.bitwise(ref_l, ref_p, head + tail, R.snapshot()) is None
    assert fluid.global_scope().get(TABLE).shape == (V, D)


def test_tiered_refusals():
    """The JAX refusals: a padding_idx lookup, an ids var another op
    reads, a table that is not is_sparse, and a distributed table."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.parallel.tiered import TieredTables

    def program(is_sparse=True, padding_idx=None, ids_reader=False,
                is_distributed=False):
        fluid.core.program.reset_default_programs()
        fluid.global_scope().clear()
        words = layers.data(name="words", shape=[1], dtype="int64",
                            lod_level=1)
        e = layers.embedding(input=words, size=[V, D], is_sparse=is_sparse,
                             padding_idx=padding_idx,
                             is_distributed=is_distributed)
        pooled = layers.sequence_pool(e, pool_type="sum")
        if ids_reader:
            pooled = layers.elementwise_add(
                pooled, layers.cast(layers.reduce_sum(words), "float32"))
        loss = layers.mean(pooled)
        fluid.optimizer.Adam(1e-2).minimize(loss)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        return fluid.default_main_program()

    class _Part:
        table_specs = {TABLE: ("ep", None)}

    for kw, match, part in (({"padding_idx": 0}, "padding_idx", None),
                            ({"ids_reader": True}, "slot remap", None),
                            ({"is_sparse": False}, "is_sparse", None),
                            ({"is_distributed": True}, "distributed",
                             _Part())):
        prog = program(**kw)
        with pytest.raises(ValueError, match=match):
            TieredTables(prog, fluid.global_scope(), {TABLE: 8},
                         partitioner=part)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_ep4_checkpoint_restores_on_ep1_and_ep2(pool, tmp_path, jax_run):
    """The ep=4 checkpoint (one .shard-NNN file per table shard) restores
    on ep=1 and on an ep axis of 2 ({"dp": 2, "ep": 2}) and trains on
    bitwise the uninterrupted single-process run."""
    d, _, _, _ = jax_run()
    outs = pool.run(f"{RANKS}:checkpoint_restore", str(tmp_path), d)
    for o in outs:
        for tag in ("ep1", "ep2"):
            assert o[tag]["bitwise"] is None, (tag, o[tag]["bitwise"])
            shards = [f for f in o[tag]["files"] if ".shard-" in f]
            assert len([f for f in shards if f.startswith(TABLE + ".")
                        ]) >= 4, o[tag]["files"]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _save_model(tmp_path, big=False):
    """The JAX test's saved recommender (is_distributed table) and a
    feed."""
    v, d = (512, 16) if big else (V, D)
    jfluid.core.program.reset_default_programs()
    jfluid.global_scope().clear()
    words = jlayers.data(name="words", shape=[1], dtype="int64",
                         lod_level=1)
    e = jlayers.embedding(input=words, size=[v, d], is_sparse=True,
                          is_distributed=True)
    pooled = jlayers.sequence_pool(e, pool_type="sum")
    pred = jlayers.fc(input=pooled, size=4, act="softmax")
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(jfluid.default_startup_program())
    mdir = str(tmp_path / ("model-big" if big else "model"))
    jfluid.io.save_inference_model(mdir, ["words"], [pred], exe)
    rng = np.random.RandomState(1)
    feed = {"words": rng.randint(0, v, (6, 5)).astype(np.int64),
            "words@SEQ_LEN": np.full((6,), 5, np.int32)}
    return mdir, feed


@pytest.mark.parametrize("numerics", ["fast", "exact"])
def test_sharded_serving_lookup_bitwise_and_reported(pool, tmp_path,
                                                     numerics):
    """ShardedPredictor(mesh={"ep": 4}): the saved is_distributed table
    row-shards by the rule training uses and serves bitwise the
    Predictor's reply; the report names the 4-rank mesh and the per-rank
    argument bytes stay under the whole table's."""
    mdir, feed = _save_model(tmp_path, big=True)
    jwant = jfluid.serving.Predictor.from_model_dir(mdir).run(dict(feed))[0]
    outs = pool.run(f"{RANKS}:predict", mdir, feed, [{"ep": 4}],
                    numerics=numerics)
    for o in outs:
        assert o[0]["got"].tobytes() == o["want"].tobytes()
        assert TABLE in o[0]["info"]["sharded_params"]
        assert o[0]["num_devices"] == 4
        assert 0 < o[0]["argument_bytes"] < 512 * 16 * 4
    np.testing.assert_allclose(outs[0]["want"], np.asarray(jwant),
                               rtol=0, atol=TOL)


def test_sharded_predictor_composes_with_row_cache(pool, tmp_path):
    """ShardedPredictor with embedding_cache_rows on {"dp": 4} and
    {"ep": 4}: the table lives in its hot-row cache, its rows follow the
    batch's slice, replies bitwise the Predictor's."""
    mdir, feed = _save_model(tmp_path)
    outs = pool.run(f"{RANKS}:predict", mdir, feed, [{"dp": 4}, {"ep": 4}],
                    cache_rows=16)
    for o in outs:
        for i in (0, 1):
            assert o[i]["cached"] == [TABLE]
            assert o[i]["got"].tobytes() == o["want"].tobytes(), i
