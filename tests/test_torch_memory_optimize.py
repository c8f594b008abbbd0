"""``memory_optimize`` and ``release_memory`` in the port against the JAX
package (twins of tests/test_aux_subsystems.py's four memory tests), and
the interpreter's rematerialisation on its own terms.

The transpiler is the JAX package's pass, copied: the liveness sets, the
remat bounds and the ``delete_var`` programs must be equal.  The
interpreter recomputes each segment in the backward from the same ops
and inputs, so training under ``memory_optimize`` is bitwise the port's
run without it (one CPU thread, so that no reduction changes its split
between runs), and within 1e-4 of the JAX package's.  Under remat the
autograd graph keeps fewer saved bytes (counted with
``torch.autograd.graph.saved_tensors_hooks``), dropout's masks repeat
in the recompute (the generator's state replayed), and ops whose effect
must not happen twice (a print, the executor's reader pull) happen once
a step.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.memory_optimization_transpiler import \
    ControlFlowGraph as JControlFlowGraph
from paddle_tpu.memory_optimization_transpiler import \
    release_memory as jrelease_memory
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch.memory_optimization_transpiler import (
    ControlFlowGraph, release_memory)
from paddle_tpu_torch.models import transformer


@pytest.fixture(autouse=True)
def _fresh():
    for fl in (jfluid, fluid):
        fl.core.program.reset_default_programs()
        fl.core.scope._global_scope = fl.core.scope.Scope()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same_json(jprog, prog):
    assert (json.dumps(jprog.to_dict(), sort_keys=True)
            == json.dumps(prog.to_dict(), sort_keys=True))


def _mlp(fl, widths=(16,), lr=0.1):
    layers = fl.layers
    x = layers.data(name="x", shape=[8], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    h = x
    for i, w in enumerate(widths):
        h = layers.fc(input=h, size=w, act="relu",
                      param_attr=fl.ParamAttr(name=f"w{i + 1}"))
    p = layers.fc(input=h, size=1, param_attr=fl.ParamAttr(name="w9"))
    d = layers.elementwise_sub(p, y)
    cost = layers.mean(layers.elementwise_mul(d, d))
    fl.optimizer.SGD(learning_rate=lr).minimize(cost)
    return cost


def _state(fl, main):
    scope = fl.global_scope()
    return {v.name: np.array(scope.get(v.name).numpy()
                             if isinstance(scope.get(v.name), torch.Tensor)
                             else np.asarray(scope.get(v.name)))
            for v in main.list_vars()
            if v.persistable and scope.get(v.name) is not None}


def _train(fl, build, feeds, transform=None, seed=3, fetch=(), start=None):
    """Build, transform, start from ``seed`` (or from the state
    ``start``) and train one step a feed in fresh default programs ->
    (losses, fetches, scope values, the starting values)."""
    fl.core.program.reset_default_programs()
    fl.core.scope._global_scope = fl.core.scope.Scope()
    cost = build(fl)
    main = fl.default_main_program()
    if transform is not None:
        transform(fl, main, cost)
    fl.default_startup_program().random_seed = seed
    main.random_seed = seed
    exe = fl.Executor(fl.CPUPlace())
    exe.run(fl.default_startup_program())
    for name, val in (start or {}).items():
        fl.global_scope().set(name, val.copy())
    init = _state(fl, main)
    losses, fetched = [], []
    for f in feeds:
        out = exe.run(main, feed=f, fetch_list=[cost, *fetch])
        losses.append(np.asarray(out[0]))
        fetched.append([np.asarray(o) for o in out[1:]])
    return losses, fetched, _state(fl, main), init


def _mlp_feeds(n, seed):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(4, 8).astype(np.float32),
             "y": rng.randn(4, 1).astype(np.float32)} for _ in range(n)]


def _remat(fl, main, cost):
    fl.memory_optimize(main)


def _bitwise(a, b):
    for name, val in a.items():
        np.testing.assert_array_equal(b[name], val, name)


# ---------------------------------------------------------------------------
# twins of tests/test_aux_subsystems.py
# ---------------------------------------------------------------------------

def test_memory_optimize_same_result():
    feeds = _mlp_feeds(1, 0)
    jremat = _train(jfluid, _mlp, feeds, _remat)
    plain = _train(fluid, _mlp, feeds, start=jremat[3])
    remat = _train(fluid, _mlp, feeds, _remat, start=jremat[3])
    _bitwise(plain[2], remat[2])
    assert fluid.default_main_program()._remat_bounds \
        == jfluid.default_main_program()._remat_bounds
    for name in ("w1", "w9"):
        np.testing.assert_allclose(remat[2][name], jremat[2][name],
                                   rtol=0, atol=1e-4)


def test_liveness_cfg_and_remat_bounds():
    def build(fl):
        layers = fl.layers
        x = layers.data(name="x", shape=[64], dtype="float32")
        wide = layers.fc(input=x, size=256, act="relu")
        narrow = layers.fc(input=wide, size=4, act="relu")
        out = layers.fc(input=narrow, size=64)
        layers.mean(out)
        return wide
    build(jfluid)
    wide = build(fluid)
    _same_json(jfluid.default_main_program(), fluid.default_main_program())
    jcfg = JControlFlowGraph(jfluid.default_main_program())
    cfg = ControlFlowGraph(fluid.default_main_program())
    assert cfg.live_in == jcfg.live_in and cfg.live_out == jcfg.live_out
    assert ({i: sorted(v) for i, v in cfg.last_uses().items()}
            == {i: sorted(v) for i, v in jcfg.last_uses().items()})
    n = len(cfg.ops)
    assert [cfg.live_out_bytes(i) for i in range(n)] \
        == [jcfg.live_out_bytes(i) for i in range(n)]
    for k in (None, 2, 3):
        assert cfg.remat_bounds(k) == jcfg.remat_bounds(k)
    last = {v: i for i, vs in cfg.last_uses().items() for v in vs}
    assert wide.name in last
    assert all(wide.name not in cfg.live_out[i]
               for i in range(last[wide.name], n))
    bounds = cfg.remat_bounds(n_segments=2)
    assert bounds[0] == 0 and bounds[-1] == n and bounds[1:-1]
    widest = max(range(n - 1), key=cfg.live_out_bytes)
    assert all(c - 1 != widest for c in bounds[1:-1])


def test_release_memory_inserts_delete_var_and_preserves_results():
    def build(fl):
        layers = fl.layers
        x = layers.data(name="x", shape=[8], dtype="float32")
        h = layers.fc(input=x, size=16, act="relu",
                      param_attr=fl.ParamAttr(name="w1"))
        p = layers.fc(input=h, size=1, param_attr=fl.ParamAttr(name="w2"))
        return layers.mean(p)
    jcost, cost = build(jfluid), build(fluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    exe = fluid.Executor(fluid.CPUPlace())
    for v in fluid.default_main_program().list_vars():
        val = jfluid.global_scope().get(v.name)
        if v.persistable and val is not None:
            fluid.global_scope().set(v.name, np.array(val))
    feed = {"x": np.random.RandomState(0).randn(4, 8).astype(np.float32)}
    before = exe.run(feed=feed, fetch_list=[cost])[0]
    jprog = jrelease_memory(jfluid.default_main_program(),
                            skip_opt_set={jcost.name})
    prog = release_memory(fluid.default_main_program(),
                          skip_opt_set={cost.name})
    _same_json(jprog, prog)
    assert "delete_var" in [op.type for op in prog.global_block().ops]
    after = exe.run(prog, feed=feed, fetch_list=[cost])[0]
    np.testing.assert_array_equal(after, before)
    (want,) = jexe.run(jprog, feed=feed, fetch_list=[jcost])
    np.testing.assert_allclose(after, np.asarray(want), rtol=0, atol=1e-6)


def test_liveness_remat_trains_same_as_plain():
    def build(fl):
        return _mlp(fl, widths=(32, 4))
    feeds = _mlp_feeds(3, 3)
    jremat = _train(jfluid, build, feeds, _remat, seed=11)
    plain = _train(fluid, build, feeds, seed=11, start=jremat[3])
    remat = _train(fluid, build, feeds, _remat, seed=11, start=jremat[3])
    assert fluid.default_main_program()._remat_bounds
    assert [float(v) for v in remat[0]] == [float(v) for v in plain[0]]
    _bitwise(plain[2], remat[2])
    for name in ("w1", "w2", "w9"):
        np.testing.assert_allclose(remat[2][name], jremat[2][name],
                                   rtol=0, atol=1e-4)


def test_release_memory_after_minimize_keeps_training_correct():
    def release(fl, main, cost):
        mod = (jfluid.memory_optimization_transpiler if fl is jfluid
               else fluid.memory_optimization_transpiler)
        mod.release_memory(main, skip_opt_set={cost.name})
    feeds = _mlp_feeds(3, 5)
    jrel = _train(jfluid, _mlp, feeds, release, seed=13)
    plain = _train(fluid, _mlp, feeds, seed=13, start=jrel[3])
    rel = _train(fluid, _mlp, feeds, release, seed=13, start=jrel[3])
    prog = fluid.default_main_program()
    assert "delete_var" in [op.type for op in prog.global_block().ops]
    _same_json(jfluid.default_main_program(), prog)
    _bitwise(plain[2], rel[2])
    for name in ("w1", "w9"):
        np.testing.assert_allclose(rel[2][name], jrel[2][name], rtol=0,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# the interpreter's remat
# ---------------------------------------------------------------------------

LM = dict(vocab=64, max_len=16, n_layers=2, d_model=32, n_heads=4, d_ff=64)


def _lm(dropout):
    def build(fl):
        mod = transformer if fl is fluid else jtransformer
        return mod.transformer_lm_train_program(dropout=dropout, **LM)[2]
    return build


def _lm_feeds(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"tokens": rng.randint(0, 64, (4, 16)).astype(np.int64),
             "labels": rng.randint(0, 64, (4, 16)).astype(np.int64)}
            for _ in range(n)]


def _grad_names():
    (bwd,) = [op for op in fluid.default_main_program().global_block().ops
              if op.type == "backward"]
    return [p + "@GRAD" for p in bwd.desc.attrs["params"]]


def test_lm_with_dropout_remat_grads_bitwise():
    """Dropout 0.1 in a 2-layer LM: the @GRADs under remat are the
    un-remat'd run's bit for bit, so each recompute drew the first run's
    masks from the replayed generator."""
    _train(fluid, _lm(0.1), [])
    names = _grad_names()
    feeds = _lm_feeds(3)
    plain = _train(fluid, _lm(0.1), feeds, fetch=names)
    remat = _train(fluid, _lm(0.1), feeds, _remat, fetch=names)
    main = fluid.default_main_program()
    assert len(main._remat_bounds) > 3
    assert any(op.type == "dropout" for op in main.global_block().ops)
    for step, (a, b) in enumerate(zip(plain[1], remat[1])):
        for name, x, y in zip(names, a, b):
            np.testing.assert_array_equal(y, x, f"step {step} {name}")
    assert [float(v) for v in remat[0]] == [float(v) for v in plain[0]]
    _bitwise(plain[2], remat[2])


def test_lm_remat_bounds_equal_jax_and_losses_agree():
    """The LM under memory_optimize in both packages: equal programs and
    remat bounds; from the JAX startup state the port's losses within
    1e-4 of the JAX package's (dropout 0: the two draw other masks)."""
    jcost, cost = _lm(0.0)(jfluid), _lm(0.0)(fluid)
    jmain, main = jfluid.default_main_program(), fluid.default_main_program()
    jfluid.memory_optimize(jmain)
    fluid.memory_optimize(main)
    _same_json(jmain, main)
    assert main._remat_bounds == jmain._remat_bounds
    assert len(main._remat_bounds) > 3
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    exe = fluid.Executor(fluid.CPUPlace())
    for v in main.list_vars():
        val = jfluid.global_scope().get(v.name)
        if v.persistable and val is not None:
            fluid.global_scope().set(v.name, np.array(val))
    for f in _lm_feeds(2, 1):
        (want,) = jexe.run(jmain, feed=f, fetch_list=[jcost])
        (got,) = exe.run(main, feed=f, fetch_list=[cost])
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


def test_remat_saves_fewer_bytes_for_backward():
    def saved(transform):
        _train(fluid, _lm(0.0), [], transform)
        main = fluid.default_main_program()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t
        cost = main.global_block().var(
            next(op for op in main.global_block().ops
                 if op.type == "backward").desc.inputs["Loss"][0])
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            exe.run(main, feed=_lm_feeds(1)[0], fetch_list=[cost])
        return total[0]
    plain, remat = saved(None), saved(_remat)
    assert plain > 0
    assert remat < plain / 4, (remat, plain)


def test_print_runs_once_a_step_under_remat(capsys):
    """A Print in the forward is cut out of its segment: it prints once a
    step, and the trained state is the un-remat'd run's."""
    def build(fl):
        layers = fl.layers
        x = layers.data(name="x", shape=[8], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        h = layers.fc(input=x, size=16, act="relu",
                      param_attr=fl.ParamAttr(name="w1"))
        h = layers.Print(h, message="remat-probe")
        p = layers.fc(input=h, size=1, param_attr=fl.ParamAttr(name="w2"))
        cost = layers.mean(layers.square_error_cost(p, y))
        fl.optimizer.SGD(0.1).minimize(cost)
        return cost
    feeds = _mlp_feeds(2, 7)
    plain = _train(fluid, build, feeds)
    capsys.readouterr()
    remat = _train(fluid, build, feeds, _remat)
    assert capsys.readouterr().out.count("remat-probe") == 2
    _bitwise(plain[2], remat[2])


def test_batch_norm_stats_and_nan_guard_under_remat():
    """BatchNorm's running statistics keep the first run's write (the
    recompute's is dropped), and ``check_nan_inf`` sees the same ops."""
    def build(fl):
        layers = fl.layers
        img = layers.data(name="img", shape=[3, 8, 8], dtype="float32")
        label = layers.data(name="label", shape=[1], dtype="int64")
        c = layers.conv2d(input=img, num_filters=4, filter_size=3)
        c = layers.batch_norm(input=c, act="relu")
        c = layers.conv2d(input=c, num_filters=4, filter_size=3)
        c = layers.batch_norm(input=c, act="relu")
        pred = layers.fc(input=c, size=3, act="softmax")
        cost = layers.mean(layers.cross_entropy(input=pred, label=label))
        fl.optimizer.Momentum(0.1, momentum=0.9).minimize(cost)
        return cost
    rng = np.random.RandomState(2)
    feeds = [{"img": rng.randn(4, 3, 8, 8).astype(np.float32),
              "label": rng.randint(0, 3, (4, 1)).astype(np.int64)}
             for _ in range(3)]
    fluid.FLAGS.check_nan_inf = True
    try:
        plain = _train(fluid, build, feeds)
        remat = _train(fluid, build, feeds, _remat)
    finally:
        fluid.FLAGS.check_nan_inf = False
    stats = [n for n in plain[2] if "batch_norm" in n]
    assert len(stats) >= 4
    _bitwise(plain[2], remat[2])


def test_reader_pulls_once_a_step_under_remat(tmp_path):
    """A reader-op program under remat: the executor's pull (the port's
    ``read``) runs once a step, and losses and state are bitwise the
    un-remat'd run's."""
    from paddle_tpu_torch import layers, recordio_writer
    path = str(tmp_path / "t.recordio")
    rng = np.random.RandomState(0)

    def samples():
        for _ in range(32):
            x = rng.rand(8).astype(np.float32)
            yield (x, np.float32([x.sum()]))
    recordio_writer.convert_reader_to_recordio_file(path, samples)

    def run(remat):
        fluid.core.program.reset_default_programs()
        fluid.core.scope._global_scope = fluid.core.scope.Scope()
        reader = layers.batch(layers.open_recordio_file(
            path, shapes=[[-1, 8], [-1, 1]], dtypes=["float32", "float32"]),
            batch_size=8)
        x, y = layers.read_file(reader)
        h = layers.fc(input=x, size=16, act="relu")
        loss = layers.mean(layers.square_error_cost(
            layers.fc(input=h, size=1), y))
        fluid.optimizer.SGD(0.1).minimize(loss)
        main = fluid.default_main_program()
        if remat:
            fluid.memory_optimize(main)
        fluid.default_startup_program().random_seed = 1
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        pulls = [0]
        bound = main._bound_reader
        pull = bound.next_feed

        def counted():
            pulls[0] += 1
            return pull()
        bound.next_feed = counted
        hs = exe.train_loop(fetch_list=[loss], steps_per_launch=2)
        return ([float(h.get()[0]) for h in hs], pulls[0],
                {n: fluid.global_scope().get(n).numpy().copy()
                 for n in fluid.global_scope().local_var_names()})
    plain, remat = run(False), run(True)
    assert len(plain[0]) == 4 and plain[1] == remat[1] == 5  # 4 + the EOF
    assert remat[0] == plain[0]
    _bitwise(plain[2], remat[2])


def test_sparse_table_under_remat_bitwise():
    """An is_sparse table's leaves inside a rematerialised segment: the
    SelectedRows gradient and the trained table bitwise the un-remat'd
    run's."""
    def build(fl):
        layers = fl.layers
        ids = layers.data("ids", shape=[5], dtype="int64")
        y = layers.data("y", shape=[8], dtype="float32")
        emb = layers.embedding(input=ids, size=[40, 8], is_sparse=True,
                               param_attr=fl.ParamAttr(name="table"))
        h = layers.fc(input=layers.reduce_mean(emb, dim=1), size=8,
                      act="tanh")
        cost = layers.mean(layers.square_error_cost(h, y))
        fl.optimizer.Adam(0.05).minimize(cost)
        return cost
    rng = np.random.RandomState(4)
    feeds = [{"ids": rng.randint(0, 40, (4, 5)).astype(np.int64),
              "y": rng.randn(4, 8).astype(np.float32)} for _ in range(3)]
    fetch = ("table@GRAD@ROWS", "table@GRAD@VALUES")
    plain = _train(fluid, build, feeds, fetch=fetch)
    remat = _train(fluid, build, feeds, _remat, fetch=fetch)
    for a, b in zip(plain[1], remat[1]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    _bitwise(plain[2], remat[2])
