"""SelectedRows sparse training in the port against the JAX package (twins
of the single-device tests of tests/test_selected_rows.py, plus the
optimizer branches, amp, clip, weight decay, the refusals and the
recommender of bench.py at a small size).

Each program is built by both front ends from the same code; the two
must serialize to the same dict.  The JAX package runs the startup
program, the port takes its state, and the table starts from one seeded
init in both.  Tolerances: parameters and row values 1e-5 (f32 rules in
another summation order), under ``MixedPrecision`` the bf16 rule of 2e-2
(its fc product takes bf16 operands, rounded at other places in the two
frameworks), the fetched rows bitwise, a row never looked up and an
overflowed step's state bitwise.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu_torch.ops.optimizer_ops import merge_selected_rows

V, D, B, T = 40, 8, 4, 5
TOL = 1e-5
BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def _fresh():
    for fl in (jfluid, fluid):
        fl.core.program.reset_default_programs()
        fl.core.scope._global_scope = fl.core.scope.Scope()
    yield


def _table_init():
    return np.random.RandomState(7).randn(V, D).astype(np.float32) * 0.3


def _feeds(n=5, seed=0, half=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, V, (B, T)).astype(np.int64)
        out.append({"ids": ids % (V // 2) if half else ids,
                    "y": rng.randn(B, D).astype(np.float32)})
    return out


def _model(fl, is_sparse=True, fc=False, is_distributed=False):
    layers = fl.layers
    ids = layers.data("ids", shape=[T], dtype="int64")
    y = layers.data("y", shape=[D], dtype="float32")
    emb = layers.embedding(input=ids, size=[V, D], is_sparse=is_sparse,
                           is_distributed=is_distributed,
                           param_attr=fl.ParamAttr(name="table"))
    pooled = layers.reduce_mean(emb, dim=1)
    if fc:
        pooled = layers.fc(input=pooled, size=D,
                           param_attr=fl.ParamAttr(name="w"))
    return layers.mean(layers.square_error_cost(pooled, y))


def _twin(build):
    """Build with both front ends (equal JSON); -> (jexe, exe, jcost,
    cost) with the port's scope holding the JAX startup state and both
    tables at `_table_init`."""
    jcost = build(jfluid)
    cost = build(fluid)
    jmain, main = jfluid.default_main_program(), fluid.default_main_program()
    assert (json.dumps(jmain.to_dict(), sort_keys=True)
            == json.dumps(main.to_dict(), sort_keys=True))
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    jfluid.global_scope().set("table", _table_init())
    exe = fluid.Executor(fluid.CPUPlace())
    for v in main.list_vars():
        val = jfluid.global_scope().get(v.name)
        if v.persistable and val is not None:
            fluid.global_scope().set(v.name, np.array(val))
    return jexe, exe, jcost, cost


def _get(fl, name):
    val = fl.global_scope().get(name)
    return val.numpy() if isinstance(val, torch.Tensor) else np.asarray(val)


def _persistables():
    return [v.name for v in fluid.default_main_program().list_vars()
            if v.persistable and not v.desc.is_data
            and fluid.global_scope().get(v.name) is not None]


def _run_both(build, feeds, fetch=(), tol=TOL):
    jexe, exe, jcost, cost = _twin(build)
    for step, f in enumerate(feeds):
        want = jexe.run(feed=f, fetch_list=[jcost.name, *fetch])
        got = exe.run(feed=f, fetch_list=[cost.name, *fetch])
        for name, g, w in zip([cost.name, *fetch], got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=tol,
                                       err_msg=f"step {step} {name}")
    for name in _persistables():
        np.testing.assert_allclose(_get(fluid, name), _get(jfluid, name),
                                   rtol=0, atol=tol, err_msg=name)
    return exe, cost


OPTIMIZERS = {
    "sgd": lambda fl: fl.optimizer.SGD(0.1),
    "momentum": lambda fl: fl.optimizer.Momentum(0.1, momentum=0.9),
    "momentum_nesterov": lambda fl: fl.optimizer.Momentum(
        0.1, momentum=0.9, use_nesterov=True),
    "adam": lambda fl: fl.optimizer.Adam(0.05),
}


def test_sparse_grad_var_is_selected_rows():
    def build(fl):
        cost = _model(fl)
        fl.optimizer.SGD(0.1).minimize(cost)
        return cost
    _twin(build)
    block = fluid.default_main_program().global_block()
    assert block.vars["table@GRAD"].desc.type \
        == fluid.core.types.VarType.SELECTED_ROWS
    assert block.vars["table@GRAD@ROWS"].dtype == "int32"
    assert tuple(block.vars["table@GRAD@VALUES"].shape) == (-1, D)
    (bwd,) = [op for op in block.ops if op.type == "backward"]
    assert bwd.desc.attrs["sparse_params"] == ["table"]


@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_sparse_rule_matches_jax(kind):
    def build(fl):
        cost = _model(fl, fc=True)
        OPTIMIZERS[kind](fl).minimize(cost)
        return cost
    _run_both(build, _feeds())


def test_sgd_sparse_matches_dense():
    def run(is_sparse):
        fluid.core.program.reset_default_programs()
        fluid.core.scope._global_scope = fluid.core.scope.Scope()
        cost = _model(fluid, is_sparse)
        fluid.optimizer.SGD(0.1).minimize(cost)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        fluid.global_scope().set("table", _table_init())
        for f in _feeds():
            exe.run(feed=f, fetch_list=[cost])
        return _get(fluid, "table")
    np.testing.assert_allclose(run(True), run(False), rtol=0, atol=TOL)


def test_sparse_rows_values_fetchable():
    """Rows bitwise the JAX package's, values to 1e-6; scatter-added they
    are the dense gradient."""
    def build(fl):
        cost = _model(fl)
        fl.optimizer.SGD(0.0).minimize(cost)
        return cost
    jexe, exe, _, _ = _twin(build)
    (f,) = _feeds(1)
    names = ["table@GRAD@ROWS", "table@GRAD@VALUES"]
    rows, values = exe.run(feed=f, fetch_list=names)
    jrows, jvalues = (np.asarray(a) for a in jexe.run(feed=f,
                                                      fetch_list=names))
    assert rows.dtype == np.int32 and rows.shape == (B * T,)
    assert values.shape == (B * T, D)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_allclose(values, jvalues, rtol=0, atol=1e-6)

    fluid.core.program.reset_default_programs()
    cost = _model(fluid, is_sparse=False)
    fluid.optimizer.SGD(0.0).minimize(cost)
    exe2 = fluid.Executor(fluid.CPUPlace())
    (dense,) = exe2.run(feed=f, fetch_list=["table@GRAD"])
    want = np.zeros((V, D), np.float32)
    np.add.at(want, rows, values)
    np.testing.assert_allclose(want, dense, rtol=0, atol=1e-6)


def test_adam_sparse_touches_only_rows():
    """Rows never looked up keep their table, moment and velocity bits
    (dense Adam would decay their moments)."""
    def build(fl):
        cost = _model(fl)
        fl.optimizer.Adam(0.05).minimize(cost)
        return cost
    _run_both(build, _feeds(6, half=True))
    moments = [n for n in _persistables() if "table" in n and "moment" in n]
    assert len(moments) == 2, _persistables()
    table = _get(fluid, "table")
    np.testing.assert_array_equal(table[V // 2:], _table_init()[V // 2:])
    for name in moments:
        np.testing.assert_array_equal(_get(fluid, name)[V // 2:], 0.0)
    assert not np.array_equal(table[:V // 2], _table_init()[:V // 2])


def test_sparse_disabled_when_table_has_other_consumers():
    """A table also read by another op trains dense in both packages."""
    def build(fl):
        layers = fl.layers
        ids = layers.data("ids", shape=[T], dtype="int64")
        emb = layers.embedding(input=ids, size=[V, D], is_sparse=True,
                               param_attr=fl.ParamAttr(name="table"))
        tbl = fl.default_main_program().global_block().vars["table"]
        cost = layers.elementwise_add(
            layers.mean(layers.reduce_mean(emb, dim=1)),
            layers.reduce_mean(tbl))
        fl.optimizer.SGD(0.1).minimize(cost)
        return cost
    jexe, exe, jcost, cost = _twin(build)
    g = fluid.default_main_program().global_block().vars["table@GRAD"]
    assert g.desc.type != fluid.core.types.VarType.SELECTED_ROWS
    f = {"ids": _feeds(1)[0]["ids"]}
    (want,) = jexe.run(feed=f, fetch_list=["table@GRAD"])
    (got,) = exe.run(feed=f, fetch_list=["table@GRAD"])
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)


def test_sparse_amp_matches_jax_and_overflow_is_a_bitwise_skip():
    def build(fl):
        cost = _model(fl, fc=True)
        fl.optimizer.MixedPrecision(fl.optimizer.Adam(0.05)).minimize(cost)
        return cost
    exe, cost = _run_both(build, _feeds(3), tol=BF16_TOL)
    before = {n: _get(fluid, n).copy() for n in _persistables()}
    bad = dict(_feeds(1, seed=9)[0])
    bad["y"] = np.full((B, D), np.inf, np.float32)
    exe.run(feed=bad, fetch_list=[cost])
    scale = fluid.default_main_program()._loss_scaling["scale"]
    for name, old in before.items():
        if name == scale:
            assert _get(fluid, name)[0] == old[0] / 2
        elif name != fluid.default_main_program()._loss_scaling[
                "good_steps"]:
            np.testing.assert_array_equal(_get(fluid, name), old, name)


def test_sparse_grad_skips_global_norm_clip():
    """The table's rows stay out of the global-norm group: the dense
    weight alone is clipped, as in the JAX package."""
    def build(fl):
        cost = _model(fl, fc=True)
        fl.clip.set_gradient_clip(
            fl.clip.GradientClipByGlobalNorm(clip_norm=1e-3))
        fl.optimizer.SGD(0.5).minimize(cost)
        return cost
    _run_both(build, _feeds(3))


def test_sparse_grad_gets_no_weight_decay():
    def build(fl):
        cost = _model(fl, fc=True)
        fl.optimizer.Momentum(0.1, momentum=0.9, regularization=(
            fl.regularizer.L2Decay(0.5))).minimize(cost)
        return cost
    _run_both(build, _feeds(3, half=True))
    # L2 would have moved every row; the rows never looked up are bitwise
    np.testing.assert_array_equal(_get(fluid, "table")[V // 2:],
                                  _table_init()[V // 2:])


@pytest.mark.parametrize("kind", ["adagrad", "rmsprop", "adamax"])
def test_other_optimizers_refuse_selected_rows(kind):
    make = {"adagrad": lambda fl: fl.optimizer.Adagrad(0.1),
            "rmsprop": lambda fl: fl.optimizer.RMSProp(0.01),
            "adamax": lambda fl: fl.optimizer.Adamax(0.05)}[kind]

    def build(fl):
        cost = _model(fl)
        make(fl).minimize(cost)
        return cost
    jexe, exe, jcost, cost = _twin(build)
    (f,) = _feeds(1)
    with pytest.raises(Exception):
        jexe.run(feed=f, fetch_list=[jcost])
    with pytest.raises(ValueError, match="no SelectedRows branch"):
        exe.run(feed=f, fetch_list=[cost])


def test_sparse_update_not_written_in_place_is_refused():
    """A sparse update scatters its rows into the table's own tensor: an
    sgd op whose ParamOut is another var is refused."""
    cost = _model(fluid)
    fluid.optimizer.SGD(0.1).minimize(cost)
    block = fluid.default_main_program().global_block()
    sgd = next(op for op in block.ops if op.type == "sgd"
               and op.desc.inputs["Param"] == ["table"])
    block.create_var(name="table_out", shape=[V, D], dtype="float32")
    sgd.desc.outputs["ParamOut"] = ["table_out"]
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    with pytest.raises(ValueError, match="in place"):
        exe.run(feed=_feeds(1)[0], fetch_list=[cost])


@pytest.mark.parametrize("entry", ["run", "train_loop"])
def test_distributed_table_is_refused_in_both(entry):
    def build(fl):
        cost = _model(fl, is_distributed=True)
        fl.optimizer.SGD(0.1).minimize(cost)
        return cost
    jexe, exe, jcost, cost = _twin(build)
    (f,) = _feeds(1)
    for e, c in ((jexe, jcost), (exe, cost)):
        with pytest.raises(ValueError, match="no mesh is bound"):
            if entry == "run":
                e.run(feed=f, fetch_list=[c])
            else:
                e.train_loop(feed=[f], fetch_list=[c], steps=1)
    # the port names the JAX remedy (row-sharded tables are ported:
    # tests/test_torch_sharded_embedding.py trains them on a mesh)
    with pytest.raises(ValueError, match=r"mesh=\{'ep': N\}") as ei:
        exe.run(feed=f, fetch_list=[cost])
    assert "queue A item 4" not in str(ei.value)
    # the table never moved
    np.testing.assert_array_equal(_get(fluid, "table"), _table_init())


def test_merge_selected_rows_against_numpy():
    rng = np.random.RandomState(3)
    rows = rng.randint(-V - 3, V + 3, 64).astype(np.int32)
    values = rng.randn(64, D).astype(np.float32)
    uniq, merged = merge_selected_rows(torch.from_numpy(rows),
                                       torch.from_numpy(values), V)
    wrapped = np.where((rows < 0) & (rows >= -V), rows + V, rows)
    keep = (wrapped >= 0) & (wrapped < V)
    want_rows = np.unique(wrapped[keep])
    want = np.zeros((len(want_rows), D), np.float32)
    for r, v in zip(wrapped[keep], values[keep]):
        want[np.searchsorted(want_rows, r)] += v
    np.testing.assert_array_equal(uniq.numpy(), want_rows)
    np.testing.assert_allclose(merged.numpy(), want, rtol=0, atol=1e-6)
    empty = merge_selected_rows(torch.zeros(0, dtype=torch.int32),
                                torch.zeros((0, D)), V)
    assert empty[0].shape == (0,) and empty[1].shape == (0, D)


def test_train_loop_windows_bitwise_per_step_run():
    """K-step windows of a sparse Adam program: the steps of per-step
    ``run``, bit for bit."""
    def run(k):
        fluid.core.program.reset_default_programs()
        fluid.core.scope._global_scope = fluid.core.scope.Scope()
        cost = _model(fluid, fc=True)
        fluid.optimizer.Adam(0.05).minimize(cost)
        exe = fluid.Executor(fluid.CPUPlace())
        fluid.default_startup_program().random_seed = 3
        exe.run(fluid.default_startup_program())
        fluid.global_scope().set("table", _table_init())
        if k:
            hs = exe.train_loop(feed=_feeds(6), fetch_list=[cost], steps=6,
                                steps_per_launch=k)
            losses = [float(h.get()[0]) for h in hs]
        else:
            losses = [float(exe.run(feed=f, fetch_list=[cost])[0])
                      for f in _feeds(6)]
        return losses, {n: _get(fluid, n) for n in _persistables()}
    base, state = run(0)
    for k in (1, 3):
        losses, got = run(k)
        assert losses == base
        for name, val in state.items():
            np.testing.assert_array_equal(got[name], val, name)


REC_V, REC_D, REC_T, REC_B = 1000, 16, 8, 16


def _recommender(fl, is_sparse=True):
    """bench.py bench_recommender's model at a small size."""
    layers = fl.layers
    words = layers.data(name="words", shape=[1], dtype="int64", lod_level=1)
    emb = layers.embedding(input=words, size=[REC_V, REC_D],
                           is_sparse=is_sparse)
    pooled = layers.sequence_pool(emb, pool_type="sum")
    h = layers.fc(input=pooled, size=32, act="relu")
    pred = layers.fc(input=h, size=2, act="softmax")
    label = layers.data(name="label", shape=[1], dtype="int64")
    loss = layers.mean(layers.cross_entropy(input=pred, label=label))
    fl.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return loss


def _rec_feeds(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"words": (np.minimum(rng.zipf(1.1, (REC_B, REC_T)), REC_V)
                       - 1).astype(np.int64),
             "words@SEQ_LEN": rng.randint(1, REC_T + 1, REC_B).astype(
                 np.int32),
             "label": rng.randint(0, 2, (REC_B, 1)).astype(np.int64)}
            for _ in range(n)]


def test_recommender_trains_as_jax():
    """The recommender, sparse Adam, 3 steps: the port's train_loop
    against the JAX package's per-step runs, at 1e-4."""
    jexe, exe, jcost, cost = _twin(_recommender)
    feeds = _rec_feeds(3)
    want = [float(np.asarray(jexe.run(feed=f, fetch_list=[jcost])[0]))
            for f in feeds]
    hs = exe.train_loop(feed=feeds, fetch_list=[cost], steps=3)
    got = [float(h.get()[0]) for h in hs]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    for name in _persistables():
        np.testing.assert_allclose(_get(fluid, name), _get(jfluid, name),
                                   rtol=0, atol=1e-4, err_msg=name)
