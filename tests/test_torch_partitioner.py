"""Twins of tests/test_partitioner.py: the port's `parallel.Partitioner`
on a 4-rank gloo world (SPMD: every rank runs the same loop on the same
global feeds).

The JAX package runs the same MLP single-device in this process and
saves its initial state, which the ranks load, so both start from the
same parameters.  ``numerics="exact"`` is held bitwise to the port's own
single-process run (computed on the ranks, one BLAS thread each) and to
the JAX run at the whole-model tolerance; ``"fast"`` to the JAX run at
1e-4, as the JAX test holds it to its single-device run.
"""
import json
import os

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import layers as jlayers, optimizer as joptimizer

from _torch_mesh_pool import RankPool
from torch_mesh_ranks import loss_kind_feeds, loss_kind_program

RANKS = "torch_mesh_ranks"


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp("gloo"))
    yield p
    p.close()


def _jax_mlp(tmp_path, mp=False, batch=8, steps=8, seed=0):
    """The JAX MLP's single-device run -> (its initial state's dir, its
    losses, its final params)."""
    jfluid.core.program.reset_default_programs()
    jfluid.global_scope().clear()
    x = jlayers.data(name="x", shape=[4], dtype="float32")
    y = jlayers.data(name="y", shape=[1], dtype="float32")
    h = jlayers.fc(input=x, size=8, act="relu")
    pred = jlayers.fc(input=h, size=1)
    loss = jlayers.mean(jlayers.square_error_cost(input=pred, label=y))
    opt = jfluid.optimizer.Adam(learning_rate=0.01)
    if mp:
        opt = joptimizer.MixedPrecision(opt)
    opt.minimize(loss)
    rng = np.random.RandomState(seed)
    feeds = [{"x": rng.rand(batch, 4).astype(np.float32),
              "y": rng.rand(batch, 1).astype(np.float32)}
             for _ in range(steps)]
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(jfluid.default_startup_program())
    d = str(tmp_path / f"jax_state_{mp}_{batch}")
    jfluid.io.save_persistables(exe, d, jfluid.default_main_program())
    losses = [np.asarray(h.get()[0]) for h in exe.train_loop(
        feed=feeds, fetch_list=[loss], steps=steps)]
    scope = jfluid.global_scope()
    params = {n: np.asarray(scope.get(n)) for n in
              ("fc_0.w_0", "fc_0.b_0", "fc_1.w_0", "fc_1.b_0")}
    return d, losses, params


def _close(a, b, rtol, atol):
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x, np.float64),
                                   np.asarray(y, np.float64),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("k", [1, 4])
def test_dp4_train_loop_bitwise_equal_to_single_device(pool, tmp_path, k):
    """exact dp=4 (per step and K=4 windows) is bitwise the port's
    single-process run and within 1e-4 of JAX's; a window is one
    launch; the report names the mesh, the sharded feed and the
    replicated params."""
    d, jl, _ = _jax_mlp(tmp_path)
    outs = pool.run(f"{RANKS}:mesh_run", "mlp", 8, k, {"dp": 4}, "exact",
                    None, "dp", False, None, d)
    for r in outs:
        assert r["bitwise"] is None, r["bitwise"]
    r = outs[0]
    assert r["launches"] <= -(-8 // k)
    _close(jl, r["losses"], 1e-4, 1e-6)
    rep = r["report"]
    assert rep["mesh_shape"] == {"dp": 4} and rep["num_devices"] == 4
    assert rep["steps"] == k
    assert any("'dp'" in key for key in rep["sharding_summary"])
    assert "PartitionSpec()" in rep["sharding_summary"]
    assert rep["collectives"]["kinds"]["all-gather"]["count"] >= 2


@pytest.mark.parametrize("k", [1, 4])
def test_dp4_bitwise_with_mixed_precision(pool, tmp_path, k):
    d, jl, _ = _jax_mlp(tmp_path, mp=True)
    outs = pool.run(f"{RANKS}:mesh_run", "mlp", 8, k, {"dp": 4}, "exact",
                    None, "dp", True, None, d)
    for r in outs:
        assert r["bitwise"] is None, r["bitwise"]
    _close(jl, outs[0]["losses"], 2e-2, 1e-3)


def test_fast_numerics_partitions_compute_and_stays_close(pool, tmp_path):
    """fast dp=4: each rank computes its slice (the feed's spec rides
    the data axis), gradients are all-reduced, the losses and params are
    within 1e-4 of JAX's single device, and the replicas hold equal
    bytes."""
    d, jl, jp = _jax_mlp(tmp_path)
    outs = pool.run(f"{RANKS}:mesh_run", "mlp", 8, 1, {"dp": 4}, None, None,
                    "dp", False, None, d)
    r = outs[0]
    _close(jl, r["losses"], 1e-4, 1e-6)
    for n, v in jp.items():
        np.testing.assert_allclose(v, r["params"][n], rtol=1e-4, atol=1e-6)
    assert all(o["replicas_equal"] for o in outs)
    rep = r["report"]
    assert rep["mesh_shape"] == {"dp": 4}
    assert any("'dp'" in key for key in rep["sharding_summary"])
    assert rep["collectives"]["kinds"]["all-reduce"]["count"] >= 4
    # every rank fetched the same global loss
    for o in outs[1:]:
        assert [x.tobytes() for x in o["losses"]] == \
            [x.tobytes() for x in r["losses"]]


def _jax_loss_kind(tmp_path, kind, steps=4):
    """The JAX single-device run of `loss_kind_program` -> (its initial
    state's dir, its losses, its final params)."""
    jfluid.core.program.reset_default_programs()
    jfluid.global_scope().clear()
    loss = loss_kind_program(jfluid, kind)
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(jfluid.default_startup_program())
    d = str(tmp_path / f"jax_state_{kind}")
    jfluid.io.save_persistables(exe, d, jfluid.default_main_program())
    losses = [np.asarray(h.get()[0]) for h in exe.train_loop(
        feed=loss_kind_feeds(steps), fetch_list=[loss], steps=steps)]
    scope = jfluid.global_scope()
    params = {n: np.asarray(scope.get(n)) for n in
              ("fc_0.w_0", "fc_0.b_0", "fc_1.w_0", "fc_1.b_0")}
    return d, losses, params


@pytest.mark.parametrize("kind", ["sum", "rows", "scaled_mean"])
def test_fast_dp_reduces_as_the_loss_asks(pool, tmp_path, kind):
    """fast dp=2 under SGD on a sum over the batch, a per-row loss (the
    gradient of its sum) and an affine function of a mean: the gradients
    and the fetched loss are summed or averaged over the data axis as
    the loss asks, so the losses and params stay within 1e-4 of the JAX
    single-device run (a mean's average in place of a sum's total would
    be off by the axis size)."""
    d, jl, jp = _jax_loss_kind(tmp_path, kind)
    outs = pool.run(f"{RANKS}:loss_kind_run", kind, d, {"dp": 2, "tp": 2})
    for o in outs:
        assert "error" not in o, o.get("error")
        _close(jl, o["losses"], 1e-4, 1e-6)
        for n, v in jp.items():
            np.testing.assert_allclose(v, o["params"][n], rtol=1e-4,
                                       atol=1e-6)


def test_fast_dp_refuses_a_loss_it_cannot_reduce(pool, tmp_path):
    """A max over the batch is neither a mean nor a sum: fast dp=2 raises
    on every rank and names the op and exact numerics, which trains it
    within 1e-4 of the JAX single-device run."""
    d, jl, jp = _jax_loss_kind(tmp_path, "max")
    outs = pool.run(f"{RANKS}:loss_kind_run", "max", d, {"dp": 2, "tp": 2})
    for o in outs:
        assert "reduce_max" in o["error"] and "exact" in o["error"]
    outs = pool.run(f"{RANKS}:loss_kind_run", "max", d, {"dp": 2, "tp": 2},
                    "exact")
    for o in outs:
        assert "error" not in o, o.get("error")
        _close(jl, o["losses"], 1e-4, 1e-6)
        for n, v in jp.items():
            np.testing.assert_allclose(v, o["params"][n], rtol=1e-4,
                                       atol=1e-6)


def test_rule_based_tp_placement_applies_to_named_matrix(pool, tmp_path):
    """A rule shards the hidden fc weight's columns over dp: its resident
    value is the rank's quarter, the rule's misses replicate, and the
    numerics stay within 1e-4 of JAX's."""
    d, jl, _ = _jax_mlp(tmp_path)
    outs = pool.run(f"{RANKS}:mesh_run", "mlp", 8, 1, {"dp": 4}, None,
                    "col8", "dp", False, None, d)
    r = outs[0]
    _close(jl, r["losses"], 1e-4, 1e-6)
    assert r["specs"]["fc_0.w_0"] == (None, "dp")
    assert r["resident"]["fc_0.w_0"] == (4, 2)
    assert "fc_1.w_0" not in r["specs"]
    assert r["resident"]["fc_1.w_0"] == (8, 1)


def test_indivisible_batch_falls_back_to_replicated_feed(pool, tmp_path):
    """dp=4 cannot split 6 rows: the feed stays whole, exact numerics
    stays bitwise, and no feed spec rides the data axis."""
    d, jl, _ = _jax_mlp(tmp_path, batch=6, steps=4)
    outs = pool.run(f"{RANKS}:mesh_run", "mlp", 4, 1, {"dp": 4}, "exact",
                    None, "dp", False, 6, d)
    r = outs[0]
    assert r["bitwise"] is None, r["bitwise"]
    _close(jl, r["losses"], 1e-4, 1e-6)
    assert not any("'dp'" in key for key in r["report"]["sharding_summary"])


def test_sharded_checkpoint_writes_shard_files_and_assembles(pool,
                                                             tmp_path):
    """The rule-sharded dp=4 state checkpoints shard-wise: one file per
    shard, the manifest records each shard's global index and the var's
    spec, the assembled restore equals the live state, and restore-by-
    spec places it on other meshes (an axis a mesh lacks replicates)."""
    outs = pool.run(f"{RANKS}:checkpoint_shards", str(tmp_path))
    r = outs[0]
    shard_files = [n for n in r["files"] if ".shard-" in n]
    assert len(shard_files) >= 4, r["files"]
    sharded = {n: v for n, v in r["manifest"]["vars"].items()
               if v.get("shards")}
    assert sharded["fc_0.w_0"]["spec"] == [None, "dp"]
    assert len(sharded["fc_0.w_0"]["shards"]) == 4
    assert sharded["fc_0.w_0"]["shape"] == [4, 8]
    for n in sharded:
        np.testing.assert_array_equal(r["restored"][n], r["live"][n])
    w = r["live"]["fc_0.w_0"]
    for i, o in enumerate(outs):
        p = o["placed"]
        assert p["dp=4"]["specs"]["fc_0.w_0"] == (None, "dp")
        np.testing.assert_array_equal(p["dp=4"]["w"], w[:, 2 * i:2 * i + 2])
        dp = i // 2
        assert p["dp=2,tp=2"]["specs"]["fc_0.w_0"] == (None, "dp")
        np.testing.assert_array_equal(p["dp=2,tp=2"]["w"],
                                      w[:, 4 * dp:4 * dp + 4])
        for key in ("tp=4", "dp=1"):
            np.testing.assert_array_equal(p[key]["w"], w)


def test_shard_written_checkpoint_resume_matches_uninterrupted(pool,
                                                               tmp_path):
    """Resuming a shard-written fast dp=4 checkpoint on the same mesh is
    bitwise the uninterrupted run; on dp=1 and on a tp mesh it restores
    the same state and trains on within 1e-3."""
    rule = {"mesh": {"dp": 4}, "rule": "col8_all", "steps_per_launch": 4}
    ref = pool.run(f"{RANKS}:mesh_run", "mlp", 12, 4, {"dp": 4}, None,
                   "col8_all", "dp", False, None, None, False)[0]
    same = pool.run(f"{RANKS}:resume_run", str(tmp_path), "same", rule,
                    rule)[0]
    assert any(".shard-" in n for n in same["files"])
    for a, b in zip(ref["losses"][8:], same["losses"]):
        assert a.tobytes() == b.tobytes()
    for n in ref["params"]:
        assert ref["params"][n].tobytes() == same["params"][n].tobytes(), n
    for tag, second in (("dp1", {"mesh": {"dp": 1}}),
                        ("tp4", {"mesh": {"tp": 4}, "data_axis": "tp"})):
        got = pool.run(f"{RANKS}:resume_run", str(tmp_path), tag, rule,
                       second)[0]
        _close(ref["losses"][8:], got["losses"], 1e-3, 1e-5)
        for n in ref["params"]:
            np.testing.assert_allclose(ref["params"][n], got["params"][n],
                                       rtol=1e-3, atol=1e-5)


def test_dp4_checkpoint_resumes_on_dp1_and_tp_mesh(pool, tmp_path):
    """exact dp=4 checkpoints resumed on dp=1 and on tp=4 stay bitwise
    the single-process run."""
    ref = pool.run(f"{RANKS}:mesh_run", "mlp", 12, 1, None, None, None)[0]
    first = {"mesh": {"dp": 4}, "numerics": "exact",
             "steps_per_launch": 4}
    for tag, second in (("dp1", {"mesh": {"dp": 1}, "numerics": "exact"}),
                        ("tp4", {"mesh": {"tp": 4}, "data_axis": "tp",
                                 "numerics": "exact"})):
        got = pool.run(f"{RANKS}:resume_run", str(tmp_path), "x" + tag,
                       first, second, 12, 8, "mlp", 4)[0]
        for a, b in zip(ref["ref_losses"][8:], got["losses"]):
            assert a.tobytes() == b.tobytes(), tag
        for n in ref["ref_params"]:
            assert ref["ref_params"][n].tobytes() == \
                got["params"][n].tobytes(), (tag, n)


def test_cache_key_separation_between_mesh_topologies(pool):
    """dp=4, dp=2 x tp=2 and no partitioner on one executor: each
    topology has its own identity, and switching re-places the state
    (a sharded var is gathered under the old rules first)."""
    r = pool.run(f"{RANKS}:switch_partitioners")[0]
    assert r["fingerprints_distinct"]
    finite, sharded, shapes = zip(*r["steps"])
    assert all(finite)
    assert sharded == (True, True, False, True)
    assert shapes == ((4, 2), (4, 4), (4, 8), (4, 2))


def test_train_loop_reads_process_mesh(pool):
    r = pool.run(f"{RANKS}:process_mesh")[0]
    assert r["shape"] == {"dp": 4}
    assert r["bitwise"] is None, r["bitwise"]


def test_one_device_mesh_falls_back_to_plain_path(pool):
    """A one-rank mesh runs the plain path (no collectives) on any world,
    trivially bitwise."""
    r = pool.run(f"{RANKS}:mesh_run", "mlp", 8, 1, {"dp": 1}, None, None)[0]
    assert r["bitwise"] is None, r["bitwise"]
    assert r["report"] is None or not r["report"]["collectives"]


def test_rule_contract_shared_with_serving(pool):
    """The ParamSpecRule contract lives in the partitioner and serving
    re-exports it; misses and specs a shape cannot honour replicate; a
    mesh that does not cover the world raises with both sizes."""
    r = pool.run(f"{RANKS}:rule_contract")[0]
    assert r["shared"]
    assert r["w8"] == ("dp",) and r["b8"] == () and r["w7"] == ()
    assert r["fits"] and not r["not_fits"]
    assert r["parse"] == {"dp": 2, "tp": 4} and r["none"] is None
    assert r["bad"] and "dp=banana" in r["bad"]
    assert "2 devices" in r["size_error"] and "world size is 4" in \
        r["size_error"]


def test_partial_shard_coverage_refuses_restore(pool, tmp_path):
    errs = pool.run(f"{RANKS}:partial_coverage", str(tmp_path))
    assert all(e is not None and "cover" in e for e in errs), errs


def test_shard_write_failure_on_one_rank_commits_nothing(pool, tmp_path):
    """A shard write that fails on rank 1 alone: no rank hangs, every rank
    raises (rank 1 its own fault, the others naming rank 1), rank 0
    commits no manifest and leaves no tmp dir, and the latest checkpoint
    is still the previous one."""
    outs = pool.run(f"{RANKS}:torn_shard_save", str(tmp_path), timeout=60)
    assert "FaultInjected" in outs[1]["error"], outs[1]
    for r, o in enumerate(outs):
        assert o["error"] is not None, r
        if r != 1:
            assert "not committed" in o["error"] and "[1]" in o["error"], o
        assert [n for n in o["entries"] if n.startswith("ckpt-")] == \
            ["ckpt-000004"], o["entries"]
        assert o["restored"] == 4


def test_port_shard_checkpoint_restores_in_jax_and_back(pool, tmp_path):
    """A port shard-wise checkpoint restores in the JAX package to the
    same arrays, and a JAX shard-wise checkpoint (its dp=4 CPU mesh)
    restores in the port."""
    from paddle_tpu.checkpoint import CheckpointManager as JManager
    r = pool.run(f"{RANKS}:checkpoint_shards", str(tmp_path))[0]
    got = JManager(str(tmp_path / "ckpt")).restore()
    for n, v in r["live"].items():
        np.testing.assert_array_equal(np.asarray(got.arrays[n]), v)
    # the other way: the JAX package writes shard-wise under a rule
    from jax.sharding import PartitionSpec as JP

    def rule(name, shape):
        if len(shape) == 2 and shape[-1] == 8:
            return JP(None, "dp")
        return None

    jfluid.core.program.reset_default_programs()
    jfluid.global_scope().clear()
    x = jlayers.data(name="x", shape=[4], dtype="float32")
    y = jlayers.data(name="y", shape=[1], dtype="float32")
    h = jlayers.fc(input=x, size=8, act="relu")
    loss = jlayers.mean(jlayers.square_error_cost(
        input=jlayers.fc(input=h, size=1), label=y))
    jfluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(jfluid.default_startup_program())
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.rand(8, 4).astype(np.float32),
              "y": rng.rand(8, 1).astype(np.float32)} for _ in range(4)]
    jd = str(tmp_path / "jax_ckpt")
    exe.train_loop(feed=feeds, fetch_list=[loss], steps=4, mesh={"dp": 4},
                   param_spec=rule, checkpoint_dir=jd, checkpoint_every=4)
    with open(os.path.join(jd, "ckpt-000004", "manifest.json")) as f:
        assert json.load(f)["vars"]["fc_0.w_0"]["shards"]
    from paddle_tpu_torch.checkpoint import CheckpointManager
    mine = CheckpointManager(jd).restore()
    scope = jfluid.global_scope()
    for n in ("fc_0.w_0", "fc_0.b_0", "fc_1.w_0"):
        np.testing.assert_array_equal(mine.arrays[n],
                                      np.asarray(scope.get(n)))


def test_fast_mixed_precision_ranks_skip_an_overflow_together(pool):
    """fast dp=4 under MixedPrecision with an inf in one rank's slice:
    the found-inf flag is max-reduced, so every rank skips the step (the
    params keep their bits) and halves its loss scale alike."""
    outs = pool.run(f"{RANKS}:amp_overflow_skip")
    for r in outs:
        assert r["unchanged"]
        assert r["scales"][1] == r["scales"][0] / 2
        assert r["replicas_equal"]
    assert len({tuple(r["scales"]) for r in outs}) == 1
