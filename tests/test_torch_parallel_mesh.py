"""The port's mesh, logical axes, collectives, transpiler and
ParallelExecutor against the JAX package (twins of the data-parallel
cases of tests/test_parallel.py), on a 4-rank gloo world; and the cost
report's peak bytes built from the JAX report's terms.
"""
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

import paddle_tpu as jfluid
from paddle_tpu import layers as jlayers
from paddle_tpu.parallel import (DistributeTranspiler as JTranspiler,
                                 LogicalAxisRules as JRules,
                                 create_mesh as jcreate_mesh)
from paddle_tpu.parallel.partitioner import (parse_mesh_axes as jparse,
                                             spec_fits as jspec_fits)

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers
from paddle_tpu_torch.parallel import (DistributeTranspiler,
                                       LogicalAxisRules, PartitionSpec,
                                       init_distributed, parse_mesh_axes,
                                       spec_fits,
                                       cpu_multiprocess_collectives_supported)
from paddle_tpu_torch.parallel import mesh as mesh_lib

from _torch_mesh_pool import RankPool

RANKS = "torch_mesh_ranks"


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp("gloo"))
    yield p
    p.close()


# ---------------------------------------------------------------------------
# in this process: specs, parsing, the one-rank mesh, the refusals
# ---------------------------------------------------------------------------

def test_partition_spec_prints_and_compares_as_jax():
    for parts in ((), ("dp",), (None, "tp"), (("dp", "tp"), None)):
        mine, theirs = PartitionSpec(*parts), JP(*parts)
        assert tuple(mine) == tuple(theirs)
        assert repr(mine) == repr(theirs)


@pytest.mark.parametrize("text", ["dp=4", "dp=2,tp=4", "none", "", "off",
                                  " tp=2 , dp=2 "])
def test_parse_mesh_axes_matches_jax(text):
    assert parse_mesh_axes(text) == jparse(text)


def test_spec_fits_matches_jax():
    jmesh = jcreate_mesh({"dp": 2, "tp": 4})
    cases = [(("dp",), (8, 3)), ((None, "dp"), (8, 3)), (("tp",), (6,)),
             ((("dp", "tp"),), (16,)), ((("dp", "tp"),), (12,)),
             (("ep",), (8,)), ((None, None, "tp"), (2, 2))]
    for parts, shape in cases:
        assert spec_fits(PartitionSpec(*parts), shape, jmesh) == \
            jspec_fits(JP(*parts), shape, jmesh), (parts, shape)


def test_logical_axis_rules_resolve_as_jax():
    rules = dict(axis_rules=(("batch", "dp"), ("mlp", "tp"),
                             ("embed", None)),
                 param_rules=((r"w:\d+x\d+", ("embed", "mlp")),
                              (r"b:\d+", ("mlp",))), name="t")
    mine, theirs = LogicalAxisRules(**rules), JRules(**rules)
    assert mine.fingerprint() == theirs.fingerprint()
    for name, shape in (("w", (4, 8)), ("b", (8,)), ("w", (8,)),
                        ("c", (2, 2))):
        a, b = mine(name, shape), theirs(name, shape)
        assert (a is None) == (b is None)
        if a is not None:
            assert tuple(a) == tuple(b)
    assert tuple(mine.logical_to_mesh(("batch", "embed", "mlp"))) == \
        tuple(theirs.logical_to_mesh(("batch", "embed", "mlp")))


def test_one_rank_mesh_needs_no_process_group():
    mesh = mesh_lib.create_mesh({"dp": 1})
    assert mesh.size == 1 and mesh.coords == {"dp": 0}
    assert mesh.group("dp") is None
    from paddle_tpu_torch.parallel import Partitioner
    assert not Partitioner(mesh=mesh).use_sharding


def test_multi_rank_mesh_without_a_world_raises():
    with pytest.raises(ValueError, match="no process group"):
        mesh_lib.create_mesh({"dp": 2})


def test_init_distributed_refuses_nccl_without_a_card():
    """No silent switch: NCCL on the CPU, or with no card, raises."""
    assert cpu_multiprocess_collectives_supported()
    with pytest.raises(ValueError, match="nccl"):
        init_distributed("127.0.0.1:1", 1, 0, backend="nccl", device="cpu")
    with pytest.raises((RuntimeError, ValueError)):
        init_distributed("127.0.0.1:1", 2, 0)


@pytest.mark.parametrize("case", ["torchrun_two_hosts", "torchrun_crowded",
                                  "explicit_crowded"])
def test_init_distributed_counts_the_ranks_of_one_host(monkeypatch, case):
    """NCCL's one-rank-a-device limit holds per host: torchrun's 2 hosts
    x 8 cards (a world of 16, 8 a host) join on card LOCAL_RANK, while 2
    ranks a host on one card, or an explicit world of 2 on one card,
    raise and name gloo (a card faked by patching torch.cuda; no group
    forms)."""
    import torch
    import torch.distributed as dist
    cards = {"torchrun_two_hosts": 8}.get(case, 1)
    joined = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: joined.setdefault("card", i))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: joined.update(kw))
    monkeypatch.setattr(dist, "get_rank", lambda: joined["rank"])
    monkeypatch.setattr(dist, "get_world_size",
                        lambda: joined["world_size"])
    if case == "explicit_crowded":
        with pytest.raises(RuntimeError, match="2 ranks on this host's 1 "
                                               "card.*gloo"):
            init_distributed("127.0.0.1:1", 2, 0)
        assert not joined
        return
    per_host = 8 if case == "torchrun_two_hosts" else 2
    for k, v in {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1",
                 "WORLD_SIZE": "16", "RANK": "9", "LOCAL_RANK": "1",
                 "LOCAL_WORLD_SIZE": str(per_host)}.items():
        monkeypatch.setenv(k, v)
    if case == "torchrun_crowded":
        with pytest.raises(RuntimeError, match="2 ranks on this host's 1 "
                                               "card.*gloo"):
            init_distributed()
        assert not joined
        return
    assert init_distributed() == (9, 16)
    assert joined == {"card": 1, "backend": "nccl", "init_method": "env://",
                      "world_size": 16, "rank": 9}


def test_transpiler_specs_and_zero_match_jax():
    """The sharding pass gives the JAX specs (table row-sharded over tp,
    feeds over dp, ZeRO-1 moments over dp); the pserver role returns the
    same program; async mode raises."""
    def build(fl, ly):
        x = ly.data(name="words", shape=[1], dtype="int64", lod_level=1)
        emb = ly.embedding(input=x, size=[64, 16], is_distributed=True)
        pooled = ly.sequence_pool(emb, "sum")
        logit = ly.fc(input=pooled, size=8, act="softmax")
        label = ly.data(name="label", shape=[1], dtype="int64")
        loss = ly.mean(ly.cross_entropy(input=logit, label=label))
        fl.optimizer.Adam(learning_rate=0.01).minimize(loss)
        return fl.default_main_program()

    jprog = build(jfluid, jlayers)
    fluid.core.program.reset_default_programs()
    prog = build(fluid, layers)
    jspecs = JTranspiler().transpile(jprog, jcreate_mesh({"dp": 4, "tp": 2}),
                                     zero_stage=1)

    class _Shape:       # the transpiler reads only the mesh's sizes
        shape = {"dp": 4, "tp": 2}

    t = DistributeTranspiler()
    specs = t.transpile(prog, _Shape(), zero_stage=1)
    assert {n: tuple(s) for n, s in specs.items()} == \
        {n: tuple(s) for n, s in jspecs.items()}
    emb = [n for n in specs if n.startswith("embedding")][0]
    assert tuple(specs[emb]) == ("tp", None)
    assert t.get_pserver_program("127.0.0.1:6174") is prog
    with pytest.raises(NotImplementedError):
        DistributeTranspiler(sync_mode=False).get_pserver_program(
            "127.0.0.1:6174")


def test_second_program_report_peak_covers_jax_terms():
    """A program run after a larger one registers a nonzero peak: the
    port's argument + output + temp - alias bytes cover the JAX report's
    argument + output bytes for the same program."""
    from paddle_tpu.observability import introspect as jintro
    from paddle_tpu_torch.observability import introspect as tintro

    def build(fl, ly, width):
        x = ly.data(name="x", shape=[width], dtype="float32")
        h = ly.fc(input=x, size=width, act="relu",
                  param_attr=fl.ParamAttr(name=f"w{width}"),
                  bias_attr=fl.ParamAttr(name=f"b{width}"))
        return ly.fc(input=h, size=4, param_attr=fl.ParamAttr(
            name=f"v{width}"), bias_attr=fl.ParamAttr(name=f"c{width}"))

    feed = {"x": np.random.RandomState(0).rand(8, 16).astype(np.float32)}
    jfluid.core.program.reset_default_programs()
    jout = build(jfluid, jlayers, 16)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    before = jintro.count()
    jexe.run(feed=feed, fetch_list=[jout])
    jrep = max(jintro.reports(since_seq=before), key=lambda r: r["flops"])

    exe = fluid.Executor(fluid.CPUPlace())
    for width in (256, 16):          # a bigger program first
        fluid.core.program.reset_default_programs()
        out = build(fluid, layers, width)
        exe.run(fluid.default_startup_program())
        before = tintro.count()
        exe.run(feed={"x": np.random.RandomState(0).rand(
            8, width).astype(np.float32)}, fetch_list=[out])
    rep = tintro.reports(layer="executor", since_seq=before)[0]
    assert rep["peak_bytes"] > 0
    assert rep["peak_bytes"] >= jrep["argument_bytes"] + jrep["output_bytes"]
    assert rep["peak_bytes"] == (rep["argument_bytes"] + rep["output_bytes"]
                                 + rep["temp_bytes"] - rep["alias_bytes"])


# ---------------------------------------------------------------------------
# on the 4-rank world
# ---------------------------------------------------------------------------

def test_collectives_are_bit_exact_and_counted(pool):
    """All-gather passes -0.0 and NaN payloads bit for bit (f32 and
    bf16), sums and maxima reduce over the named group, Megatron's f
    all-reduces the backward and g the forward, and every call is
    counted by kind and axis."""
    import struct
    outs = pool.run(f"{RANKS}:collectives_check")
    for r in outs:
        dp, tp = r["coords"]["dp"], r["coords"]["tp"]
        g = r["gather"]
        assert len(g) == 8
        neg0 = struct.unpack("<i", struct.pack("<f", -0.0))[0]
        assert g[0] == neg0 and g[4] == neg0
        for i, t in enumerate((0, 1)):
            rk = dp * 2 + t
            assert g[4 * i + 2] == struct.unpack(
                "<i", struct.pack("<f", 1.5 + rk))[0]
        assert r["gather_bf16"][0] == -32768
        assert r["sum"] == [float(tp + (2 + tp))]
        assert r["max"] == [3]
        # f's backward sums the tp pair's ones: 2 * (rank + 1)
        assert r["f_grad"] == [2.0 * (dp * 2 + tp + 1)] * 2
        assert r["g_out"] == [2.0 * ((1 + dp * 2) + (1 + dp * 2 + 1))]
        assert r["g_grad"] == [2.0]
        kinds = r["ledger"]["kinds"]
        assert kinds["all-gather"]["count"] == 2
        assert kinds["all-reduce"]["count"] == 4
        assert set(r["ledger"]["axes"]) == {"tp", "dp", "world"}


def test_dp_step_all_reduces_each_gradient(pool):
    """The transpiled data-parallel SGD step (the HLO test's program):
    its report's collectives hold one gradient all-reduce per parameter
    over the data axis (the JAX test finds the all-reduce in the
    HLO)."""
    led = pool.run(f"{RANKS}:dp_step_collectives")[0]
    assert led["kinds"]["all-reduce"]["count"] >= 6
    assert led["axes"]["dp"]["count"] >= 6
    grad_bytes = 4 * (64 * 256 + 256 + 256 * 256 + 256 + 256 + 1)
    assert led["axes"]["dp"]["bytes"] >= grad_bytes


def test_parallel_executor_matches_single_device(pool, tmp_path):
    """One SGD step through ParallelExecutor (data parallel over the
    world) equals the JAX single-device step (the reference's grad-
    equality oracle)."""
    jfluid.core.program.reset_default_programs()
    x = jlayers.data(name="x", shape=[16], dtype="float32")
    y = jlayers.data(name="y", shape=[1], dtype="float32")
    h = jlayers.fc(input=x, size=32, act="relu",
                   param_attr=jfluid.ParamAttr(name="w1"),
                   bias_attr=jfluid.ParamAttr(name="b1"))
    p = jlayers.fc(input=h, size=1, param_attr=jfluid.ParamAttr(name="w2"),
                   bias_attr=jfluid.ParamAttr(name="b2"))
    d = jlayers.elementwise_sub(p, y)
    cost = jlayers.mean(jlayers.elementwise_mul(d, d))
    jfluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    exe = jfluid.Executor(jfluid.CPUPlace())
    jfluid.default_startup_program().random_seed = 7
    exe.run(jfluid.default_startup_program())
    state = str(tmp_path / "state")
    jfluid.io.save_persistables(exe, state, jfluid.default_main_program())
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(16, 16).astype(np.float32),
            "y": rng.randn(16, 1).astype(np.float32)}
    exe.run(jfluid.default_main_program(), feed=feed, fetch_list=[cost])
    want = np.asarray(jfluid.global_scope().get("w1"))
    for r in pool.run(f"{RANKS}:parallel_executor_sgd", state):
        assert r["count"] == 4
        np.testing.assert_allclose(r["w1"], want, rtol=1e-5, atol=1e-6)


def test_zero_stage_1_shards_the_moments(pool, tmp_path):
    """transpile(zero_stage=1) through ParallelExecutor on dp=4: each
    rank holds a quarter of every moment's rows, the parameters stay
    whole and byte-equal on every rank, and the losses track the JAX
    single-device run within 1e-4."""
    from test_torch_partitioner import _jax_mlp
    d, jl, jp = _jax_mlp(tmp_path, steps=4)
    outs = pool.run(f"{RANKS}:transpiler_zero", d)
    r = outs[0]
    assert r["device_count"] == 4
    assert r["specs"]["fc_0.w_0.moment1_0"] == ("dp",)
    assert r["resident"]["fc_0.w_0.moment1_0"] == (1, 8)
    assert r["resident"]["fc_0.w_0"] == (4, 8)
    assert all(o["replicas_equal"] for o in outs)
    for a, b in zip(jl[:4], r["losses"]):
        np.testing.assert_allclose(np.asarray(b, np.float64),
                                   np.asarray(a, np.float64), rtol=1e-4,
                                   atol=1e-6)


def test_parallel_do_is_data_parallel_on_a_mesh(pool):
    """A ParallelDo block trained fast on dp=4 runs each rank's slice and
    averages the gradients: the losses track the single-process run."""
    r = pool.run(f"{RANKS}:parallel_do_dp")[0]
    for a, b in zip(r["ref"], r["got"]):
        np.testing.assert_allclose(np.asarray(b, np.float64),
                                   np.asarray(a, np.float64), rtol=1e-5,
                                   atol=1e-7)
    assert r["ledger"]["axes"]["dp"]["count"] > 0
