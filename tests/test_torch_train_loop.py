"""``Executor.train_loop`` of the port (twins of
tests/test_train_fastpath.py and tests/test_fused_dispatch.py).

In the port a window of K steps is K eager steps of the same function as
per-step ``run``: losses and final parameters are bitwise those of
per-step ``run`` at every K, with a ragged last window and with
``fetch_every``.  Against the JAX package's ``train_loop`` (K 1 and 3,
ragged) the losses and parameters agree to 1e-4 (whole models, ROADMAP).
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu_torch import fault
from paddle_tpu_torch.core.executor import NonFiniteError
from paddle_tpu_torch.reader import StackedBatch, device_prefetch

CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True)
def _fresh_port():
    fluid.core.program.reset_default_programs()
    fluid.core.scope._global_scope = fluid.core.scope.Scope()
    fault.reset()
    yield
    fault.reset()


def _mlp(fl):
    layers = fl.layers
    x = layers.data(name="x", shape=[4], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    h = layers.fc(input=x, size=8, act="relu")
    pred = layers.fc(input=h, size=1)
    loss = layers.mean(layers.square_error_cost(input=pred, label=y))
    fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _feeds(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.rand(8, 4).astype(np.float32),
             "y": rng.rand(8, 1).astype(np.float32)} for _ in range(n)]


def _build_model(seed=0, n_feeds=8):
    """Tiny MLP regression + SGD in fresh programs; -> (loss, feeds)."""
    fluid.core.program.reset_default_programs()
    fluid.global_scope().clear()
    return _mlp(fluid), _feeds(n_feeds, seed)


def _fresh_exe():
    exe = fluid.Executor(CPU)
    exe.run(fluid.default_startup_program())
    return exe


def _snapshot(scope):
    return {n: scope.get(n).clone() for n in scope.local_var_names()
            if isinstance(scope.get(n), torch.Tensor)}


def _restore(scope, snap):
    for n, v in snap.items():
        scope.set(n, v.clone())


def _assert_same(a, b):
    assert set(a) == set(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n


# -- twins of tests/test_train_fastpath.py ----------------------------------

def test_train_loop_bitwise_equal_to_per_step_run():
    loss, feeds = _build_model(n_feeds=7)
    exe = _fresh_exe()
    scope = fluid.global_scope()
    snap = _snapshot(scope)
    losses_run = [exe.run(feed=f, fetch_list=[loss])[0] for f in feeds]
    params_run = _snapshot(scope)
    _restore(scope, snap)
    handles = exe.train_loop(feed=feeds, fetch_list=[loss], fetch_every=3)
    assert len(handles) == len(feeds)
    for a, h in zip(losses_run, handles):
        assert np.array_equal(a, h.get()[0])
    _assert_same(params_run, _snapshot(scope))


def test_scope_is_current_without_sync_scope():
    """The port keeps no bound copy of the state: after train_loop the
    scope already holds the trained tensors, and sync_scope is a no-op."""
    loss, feeds = _build_model()
    exe = _fresh_exe()
    scope = fluid.global_scope()
    w0 = scope.get("fc_0.w_0").clone()
    exe.train_loop(feed=feeds, fetch_list=[loss])
    w1 = scope.get("fc_0.w_0").clone()
    assert not torch.equal(w0, w1)
    exe.sync_scope()
    assert torch.equal(scope.get("fc_0.w_0"), w1)


def test_external_scope_set_wins():
    """A value the caller puts in the scope between loops is what the
    next step trains from."""
    loss, feeds = _build_model()
    exe = _fresh_exe()
    scope = fluid.global_scope()
    exe.train_loop(feed=feeds[:2], fetch_list=[loss])
    scope.set("fc_1.b_0", np.full((1,), 5.0, np.float32))
    (h,) = exe.train_loop(feed=feeds[2:3], fetch_list=[loss])
    assert float(h.get()[0]) > 10.0       # the step saw the bias of 5
    assert float(scope.get("fc_1.b_0")) < 5.0   # and trained it in place


def test_fetch_every_windowed_nan_detection():
    loss, feeds = _build_model()
    exe = _fresh_exe()
    exe.check_nan_inf = True
    bad = dict(feeds[4])
    bad["x"] = np.full_like(bad["x"], np.nan)
    with pytest.raises(NonFiniteError, match="NaN/Inf at step 4"):
        exe.train_loop(feed=feeds[:4] + [bad] + feeds[5:],
                       fetch_list=[loss], fetch_every=3)
    loss, feeds = _build_model()
    exe = _fresh_exe()
    exe.check_nan_inf = True
    handles = exe.train_loop(feed=feeds, fetch_list=[loss], fetch_every=3)
    assert np.isfinite(handles[-1].get()[0]).all()


def test_run_nonfinite_check_still_raises():
    loss, feeds = _build_model()
    exe = _fresh_exe()
    exe.check_nan_inf = True
    exe.run(feed=feeds[0], fetch_list=[loss])
    bad = dict(feeds[1])
    bad["x"] = np.full_like(bad["x"], np.inf)
    with pytest.raises(RuntimeError, match="NaN/Inf"):
        exe.run(feed=bad, fetch_list=[loss])


def test_train_loop_single_feed_and_reader():
    loss, feeds = _build_model()
    exe = _fresh_exe()
    handles = exe.train_loop(feed=feeds[0], fetch_list=[loss], steps=4,
                             fetch_every=2)
    assert len(handles) == 4
    h = handles[0]
    assert "step=0" in repr(h)
    dev = h.get(return_numpy=False)
    assert len(dev) == 1 and np.array_equal(h.get()[0], dev[0].numpy())

    def reader():
        yield from feeds[:3]
    handles = exe.train_loop(feed=reader, fetch_list=[loss])
    assert [h.step for h in handles] == [0, 1, 2]
    handles = exe.train_loop(feed=feeds[:2], fetch_list=[loss], steps=5)
    assert len(handles) == 5
    with pytest.raises(ValueError):
        exe.train_loop(feed=feeds[0], fetch_list=[loss])


def test_train_loop_persistable_fetch_survives_in_place_updates():
    """A fetched parameter is the scope's own tensor, which later steps
    update in place: each handle keeps its step's value."""
    loss, feeds = _build_model()
    exe = _fresh_exe()
    scope = fluid.global_scope()
    snap = _snapshot(scope)
    per_step = [exe.run(feed=f, fetch_list=[loss, "fc_0.w_0"])
                for f in feeds[:4]]
    _restore(scope, snap)
    handles = exe.train_loop(feed=feeds[:4], fetch_list=[loss, "fc_0.w_0"],
                             fetch_every=4)
    for ref, h in zip(per_step, handles):
        got = h.get()
        assert np.array_equal(ref[0], got[0])
        assert np.array_equal(ref[1], got[1])
    assert (handles[0].get(return_numpy=False)[1].data_ptr()
            != scope.get("fc_0.w_0").data_ptr())


def test_gauge_reset_max():
    from paddle_tpu_torch.observability import MetricsRegistry
    g = MetricsRegistry(enabled=True).gauge("t_inflight")
    g.set(7)
    g.set(2)
    assert g.max_seen == 7
    g.reset_max()
    assert g.max_seen == 2
    g.set(5)
    assert g.max_seen == 5


def test_device_prefetch_decorator():
    rng = np.random.RandomState(0)
    batches = [{"x": rng.rand(4, 3).astype(np.float32),
                "y": rng.randint(0, 5, (4, 1)).astype(np.int32),
                "meta": "tag%d" % i} for i in range(5)]
    staged = list(device_prefetch(lambda: iter(batches), size=2,
                                  place=CPU)())
    assert len(staged) == 5
    for raw, dev in zip(batches, staged):
        assert isinstance(dev["x"], torch.Tensor)
        assert isinstance(dev["y"], torch.Tensor)
        assert dev["meta"] == raw["meta"]
        assert np.array_equal(raw["x"], dev["x"].numpy())
        assert np.array_equal(raw["y"], dev["y"].numpy())

    def broken():
        yield batches[0]
        raise IOError("disk gone")
    it = device_prefetch(broken, size=1, place=CPU)()
    next(it)
    with pytest.raises(IOError):
        list(it)


def test_device_prefetch_feeds_train_loop():
    loss, feeds = _build_model()
    exe = _fresh_exe()
    scope = fluid.global_scope()
    snap = _snapshot(scope)
    losses_host = [h.get()[0]
                   for h in exe.train_loop(feed=feeds, fetch_list=[loss])]
    params_host = _snapshot(scope)
    _restore(scope, snap)
    pre = device_prefetch(lambda: iter(feeds), size=2, place=CPU)
    losses_dev = [h.get()[0]
                  for h in exe.train_loop(feed=pre, fetch_list=[loss])]
    for a, b in zip(losses_host, losses_dev):
        assert np.array_equal(a, b)
    _assert_same(params_host, _snapshot(scope))


def test_prepare_feed_casts_to_declared_dtype():
    """Feeds come in as declared: a device tensor of the declared dtype
    passes through, float64 and lists are cast."""
    _build_model()
    exe = fluid.Executor(CPU)
    block = fluid.default_main_program().global_block()
    t = torch.zeros((2, 4))
    assert exe._prepare_feed(block, {"x": t})["x"] is t
    for v in (np.zeros((2, 4)), [[0.0] * 4] * 2):
        assert exe._prepare_feed(block, {"x": v})["x"].dtype == torch.float32


def test_profiler_record_block_disabled_is_noop():
    from paddle_tpu_torch import profiler
    c1 = profiler.record_block("x")
    assert c1 is profiler.record_block("y")
    with c1:
        pass


# -- twins of tests/test_fused_dispatch.py ----------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_fused_bitwise_equal_to_per_step_run(k):
    loss, feeds = _build_model()
    exe = _fresh_exe()
    scope = fluid.global_scope()
    snap = _snapshot(scope)
    losses_run = [exe.run(feed=f, fetch_list=[loss])[0] for f in feeds]
    params_run = _snapshot(scope)
    _restore(scope, snap)
    handles = exe.train_loop(feed=feeds, fetch_list=[loss],
                             steps_per_launch=k)
    assert [h.step for h in handles] == list(range(len(feeds)))
    for a, h in zip(losses_run, handles):
        assert np.array_equal(a, h.get()[0])
    _assert_same(params_run, _snapshot(scope))


def test_fused_ragged_final_window():
    loss, feeds = _build_model(n_feeds=7)
    exe = _fresh_exe()
    scope = fluid.global_scope()
    snap = _snapshot(scope)
    losses_run = [exe.run(feed=f, fetch_list=[loss])[0] for f in feeds]
    params_run = _snapshot(scope)
    _restore(scope, snap)
    base = exe.launches
    handles = exe.train_loop(feed=feeds, fetch_list=[loss],
                             steps_per_launch=4, fetch_every=3)
    assert exe.launches - base == 2            # 4 + 3
    assert [h.step for h in handles] == list(range(7))
    for a, h in zip(losses_run, handles):
        assert np.array_equal(a, h.get()[0])
    _assert_same(params_run, _snapshot(scope))


def test_fused_dispatch_count_bound():
    loss, feeds = _build_model()
    exe = _fresh_exe()
    for steps, k, expect in ((8, 4, 2), (10, 4, 3), (16, 8, 2)):
        base = exe.launches
        exe.train_loop(feed=feeds, fetch_list=[loss], steps=steps,
                       steps_per_launch=k)
        assert exe.launches - base == expect, (steps, k)


def test_fused_nan_raised_at_precise_step():
    loss, feeds = _build_model()
    exe = _fresh_exe()
    exe.check_nan_inf = True
    bad = dict(feeds[5])
    bad["x"] = np.full_like(bad["x"], np.nan)
    with pytest.raises(RuntimeError, match="step 5"):
        exe.train_loop(feed=feeds[:5] + [bad] + feeds[6:],
                       fetch_list=[loss], steps_per_launch=4)
    recs = [r for r in exe._flight.records() if r["nonfinite"]]
    assert recs and recs[-1]["step"] == 5


def test_fused_checkpoint_resume_across_launch_boundary(tmp_path):
    ckpt = str(tmp_path / "ckpts")
    loss, feeds = _build_model(n_feeds=12)
    exe = _fresh_exe()
    exe.train_loop(feed=feeds, fetch_list=[loss], steps=12,
                   steps_per_launch=4)
    ref = _snapshot(fluid.global_scope())
    loss, feeds = _build_model(n_feeds=12)
    exe = _fresh_exe()
    saved = []
    save = exe._checkpoint

    def spy(manager, program, scope, step):
        saved.append(step)
        save(manager, program, scope, step)
    exe._checkpoint = spy
    exe.train_loop(feed=feeds, fetch_list=[loss], steps=8,
                   steps_per_launch=4, checkpoint_dir=ckpt,
                   checkpoint_every=3)
    # checkpoint_every=3 rounds to the window boundaries; the step-4
    # snapshot may be superseded by step 8's before the writer starts it
    # (the newest state wins), step 8's always commits
    assert saved == [4, 8]
    committed = sorted(d for d in os.listdir(ckpt)
                       if d.startswith("ckpt-") and ".tmp" not in d)
    assert committed[-1] == "ckpt-000008"
    assert set(committed) <= {"ckpt-000004", "ckpt-000008"}
    loss, feeds = _build_model(n_feeds=12)
    exe = _fresh_exe()
    handles = exe.train_loop(feed=feeds, fetch_list=[loss], steps=12,
                             steps_per_launch=4, resume_from=ckpt)
    assert [h.step for h in handles] == [8, 9, 10, 11]
    got = _snapshot(fluid.global_scope())
    for n in ref:
        assert torch.equal(ref[n], got[n]), n


def test_fused_window_metrics_count_logical_steps():
    from paddle_tpu_torch.observability import default_registry
    reg = default_registry()
    gap_h = reg.histogram("executor_host_gap_seconds")
    flight_g = reg.gauge("executor_steps_in_flight")
    loss, feeds = _build_model()
    exe = _fresh_exe()
    exe.train_loop(feed=feeds, fetch_list=[loss], steps=4,
                   steps_per_launch=4)
    was = reg.enabled
    reg.enable()
    try:
        gap_n0 = gap_h.count
        flight_g.reset_max()
        exe.train_loop(feed=feeds, fetch_list=[loss], steps=8,
                       fetch_every=8, steps_per_launch=4)
        assert gap_h.count - gap_n0 == 4
        assert flight_g.max_seen == 8
    finally:
        if not was:
            reg.disable()
    steps_seen = [r["step"] for r in exe._flight.records()
                  if r["note"] != "window_sync"][-8:]
    assert steps_seen == list(range(8))
    assert len([r for r in exe._flight.records()
                if r["note"] == "fused[4]"]) >= 2
    per_step = [r for r in exe._flight.records()
                if r["note"] != "window_sync"][-8:]
    assert per_step[0]["dispatch_s"] == per_step[1]["dispatch_s"]


def test_reader_op_feed_is_refused():
    """feed=None reads the program's bound reader op (layers.read_file;
    tests/test_torch_reader_ops.py trains through one): a program with
    none is refused."""
    loss, _ = _build_model()
    exe = _fresh_exe()
    with pytest.raises(ValueError, match="read_file"):
        exe.train_loop(fetch_list=[loss], steps_per_launch=2)


@pytest.mark.parametrize("kw,label", [
    ({"mesh": {"dp": 2}}, "queue A item 4"),
    ({"param_spec": object()}, "queue A item 4"),
    ({"data_axis": "tp"}, "queue A item 4"),
    ({"numerics": "exact"}, "queue A item 4"),
    ({"lookup_exchange": "a2a"}, "queue A item 4"),
    ({"a2a_capacity": 4}, "queue A item 4"),
    ({"tiered": {"w": 4}}, "queue A item 4"),
])
def test_unported_arguments_raise_with_their_label(kw, label):
    """The sharded embeddings' arguments (``lookup_exchange``,
    ``a2a_capacity``, ``tiered``) raise with their label.  The mesh's
    (``mesh``, ``param_spec``, ``data_axis``, ``numerics``) are ported
    (queue A item 4a): in a one-process world a two-rank mesh, or a rule
    with no mesh, is refused by the mesh itself, and ``data_axis`` or
    ``numerics`` with no mesh run the single-device loop, as in the JAX
    package."""
    loss, feeds = _build_model()
    exe = _fresh_exe()
    if "mesh" in kw or "param_spec" in kw:
        with pytest.raises(ValueError, match="process group|no mesh") as ei:
            exe.train_loop(feed=feeds, fetch_list=[loss], **kw)
        assert label not in str(ei.value)
        return
    if "data_axis" in kw or "numerics" in kw:
        snap = _snapshot(fluid.global_scope())
        ref = exe.train_loop(feed=feeds, fetch_list=[loss])
        ref_params = _snapshot(fluid.global_scope())
        _restore(fluid.global_scope(), snap)
        got = _fresh_exe_like(exe).train_loop(feed=feeds,
                                              fetch_list=[loss], **kw)
        assert [h.get()[0].tobytes() for h in got] == \
            [h.get()[0].tobytes() for h in ref]
        _assert_same(ref_params, _snapshot(fluid.global_scope()))
        return
    with pytest.raises(NotImplementedError, match=label):
        exe.train_loop(feed=feeds, fetch_list=[loss], **kw)


def _fresh_exe_like(exe):
    """A second executor on the same place (no partitioner, a fresh
    generator seeded alike)."""
    return fluid.Executor(exe.place)


def test_device_prefetch_stacked_feeds_fused_loop():
    loss, feeds = _build_model(n_feeds=10)
    exe = _fresh_exe()
    scope = fluid.global_scope()
    snap = _snapshot(scope)
    ref = [exe.run(feed=f, fetch_list=[loss])[0] for f in feeds]
    ref_params = _snapshot(scope)
    staged = list(device_prefetch(lambda: iter(feeds), size=2, place=CPU,
                                  stack=4)())
    assert [b.k for b in staged] == [4, 4, 2]
    assert all(isinstance(b, StackedBatch) for b in staged)
    assert staged[0]["x"].shape == (4, 8, 4)
    assert isinstance(staged[0]["x"], torch.Tensor)
    _restore(scope, snap)
    pre = device_prefetch(lambda: iter(feeds), size=2, place=CPU, stack=4)
    base = exe.launches
    handles = exe.train_loop(feed=pre, fetch_list=[loss])
    assert exe.launches - base == 3
    for a, h in zip(ref, handles):
        assert np.array_equal(a, h.get()[0])
    _assert_same(ref_params, _snapshot(scope))


def test_fetch_handles_share_one_window_pull():
    loss, feeds = _build_model()
    exe = _fresh_exe()
    handles = exe.train_loop(feed=feeds[:4], fetch_list=[loss],
                             steps_per_launch=4)
    launch = handles[0]._launch
    assert all(h._launch is launch for h in handles)
    assert launch._host is None
    first = handles[0].get()[0]
    host_id = id(launch._host)
    for h in handles[1:]:
        h.get()
    assert id(launch._host) == host_id
    dev = handles[2].get(return_numpy=False)[0]
    assert np.array_equal(dev.numpy(), handles[2].get()[0])
    assert np.array_equal(first, handles[0].get()[0])


def test_stacked_batch_rejected_by_plain_per_step_window():
    loss, feeds = _build_model()
    exe = _fresh_exe()
    stacked = StackedBatch(
        {k: np.stack([feeds[0][k], feeds[1][k]]) for k in feeds[0]}, 2)
    mixed = [feeds[0], stacked, feeds[2]]
    with pytest.raises(ValueError, match="mixed stacked"):
        exe.train_loop(feed=mixed, fetch_list=[loss], steps_per_launch=4)
    with pytest.raises(ValueError, match="stacked batch"):
        exe.train_loop(feed=mixed, fetch_list=[loss])


def test_fused_fault_point_counts_logical_steps():
    loss, feeds = _build_model()
    exe = _fresh_exe()
    fault.arm("train.step@6:raise")
    base = exe.launches
    with pytest.raises(fault.FaultInjected):
        exe.train_loop(feed=feeds, fetch_list=[loss], steps=8,
                       steps_per_launch=4)
    assert exe.launches - base == 1
    assert fault.hits("train.step") == 6


def test_stacked_k1_feed_fuses_instead_of_misfeeding():
    loss, feeds = _build_model(n_feeds=4)
    exe = _fresh_exe()
    scope = fluid.global_scope()
    snap = _snapshot(scope)
    ref = [exe.run(feed=f, fetch_list=[loss])[0] for f in feeds]
    _restore(scope, snap)
    pre = device_prefetch(lambda: iter(feeds), size=2, place=CPU, stack=1)
    handles = exe.train_loop(feed=pre, fetch_list=[loss])
    assert len(handles) == 4
    for a, h in zip(ref, handles):
        assert np.array_equal(a, h.get()[0])


def test_fused_resume_with_stacked_feed_counts_logical_steps(tmp_path):
    ckpt = str(tmp_path / "ckpts")
    loss, feeds = _build_model(n_feeds=12)
    exe = _fresh_exe()
    exe.train_loop(feed=feeds, fetch_list=[loss], steps=12,
                   steps_per_launch=4)
    ref = _snapshot(fluid.global_scope())

    def pre():
        return device_prefetch(lambda: iter(feeds), size=2, place=CPU,
                               stack=4)
    loss, feeds = _build_model(n_feeds=12)
    exe = _fresh_exe()
    exe.train_loop(feed=pre(), fetch_list=[loss], steps=8,
                   checkpoint_dir=ckpt, checkpoint_every=4)
    loss, feeds = _build_model(n_feeds=12)
    exe = _fresh_exe()
    handles = exe.train_loop(feed=pre(), fetch_list=[loss], steps=12,
                             resume_from=ckpt)
    assert [h.step for h in handles] == [8, 9, 10, 11]
    _assert_same(ref, _snapshot(fluid.global_scope()))
    # a resume inside a stack re-yields the stack's tail
    loss, feeds = _build_model(n_feeds=12)
    exe = _fresh_exe()
    exe.train_loop(feed=feeds, fetch_list=[loss], steps=6,
                   steps_per_launch=3, checkpoint_dir=ckpt + "2",
                   checkpoint_every=6)
    loss, feeds = _build_model(n_feeds=12)
    exe = _fresh_exe()
    handles = exe.train_loop(feed=pre(), fetch_list=[loss], steps=12,
                             resume_from=ckpt + "2")
    assert [h.step for h in handles] == [6, 7, 8, 9, 10, 11]
    _assert_same(ref, _snapshot(fluid.global_scope()))


# -- against the JAX package ------------------------------------------------

@pytest.mark.parametrize("k", [1, 3])
def test_train_loop_matches_jax(k):
    """Seven steps (a ragged last window at K 3) with fetch_every 2 in
    both packages from the same state: losses and parameters to 1e-4."""
    jfluid.core.program.reset_default_programs()
    jfluid.core.scope._global_scope = jfluid.core.scope.Scope()
    jloss, loss = _mlp(jfluid), _mlp(fluid)
    jmain, main = jfluid.default_main_program(), fluid.default_main_program()
    assert (json.dumps(jmain.to_dict(), sort_keys=True)
            == json.dumps(main.to_dict(), sort_keys=True))
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    exe = fluid.Executor(CPU)
    for v in main.list_vars():
        val = jfluid.global_scope().get(v.name)
        if v.persistable and val is not None:
            fluid.global_scope().set(v.name, np.array(val))
    feeds = _feeds(7, seed=4)
    kw = dict(steps=7, fetch_every=2, steps_per_launch=k)
    jl = [h.get()[0] for h in jexe.train_loop(jmain, feeds,
                                              [jloss.name], **kw)]
    pl = [h.get()[0] for h in exe.train_loop(main, feeds, [loss.name],
                                             **kw)]
    np.testing.assert_allclose(pl, jl, rtol=1e-4, atol=1e-6)
    jexe.sync_scope()
    for p in main.all_parameters():
        np.testing.assert_allclose(
            fluid.global_scope().get(p.name).numpy(),
            np.asarray(jfluid.global_scope().get(p.name)),
            rtol=1e-4, atol=1e-6, err_msg=p.name)
