"""Mixed-precision training in the port against the JAX package (twins of
tests/test_mixed_precision.py): the dynamic loss scaler, the bitwise
skip of an overflowed step, ``check_nan_inf`` counting a skip, the
for_test clone, exact resume of the scaler, and the slice as a whole:
``transformer_lm_train_program(amp=True)`` through ``train_loop`` with a
checkpoint, in both packages.

Overflows are made by feeding one batch of inf: the scaled loss's
gradients go non-finite, ``check_finite_and_unscale`` sets found_inf,
and every optimize op keeps its old values.  Tolerances: the scaler's
state exactly, the fc models' losses to 2e-5 of max(1, |JAX value|),
their state after bf16 products and the LM's losses at the bf16 rule of
2e-2 (ROADMAP).
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid

TOL = 2e-5
BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def _fresh_port():
    fluid.core.program.reset_default_programs()
    fluid.core.scope._global_scope = fluid.core.scope.Scope()
    yield


def _reset():
    for fl in (jfluid, fluid):
        fl.core.program.reset_default_programs()
        fl.core.scope._global_scope = fl.core.scope.Scope()


def _build_fc(fl, lr=0.1, opt=None, **mp_kwargs):
    layers = fl.layers
    x = layers.data(name="x", shape=[4], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    pred = layers.fc(input=x, size=3, act="relu")
    pred = layers.fc(input=pred, size=1)
    cost = layers.mean(layers.square_error_cost(input=pred, label=y))
    inner = opt(fl) if opt else fl.optimizer.SGD(lr)
    fl.optimizer.MixedPrecision(inner, **mp_kwargs).minimize(cost)
    return cost


def _feeds(n=8, bs=8, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.rand(bs, 4).astype(np.float32),
             "y": rng.rand(bs, 1).astype(np.float32)} for _ in range(n)]


def _bad_feed(bs=8):
    return {"x": np.full((bs, 4), np.inf, np.float32),
            "y": np.zeros((bs, 1), np.float32)}


def _scaler_state(prog, scope):
    ls = prog._loss_scaling
    return (float(np.asarray(scope.get(ls["scale"])).reshape(-1)[0]),
            int(np.asarray(scope.get(ls["good_steps"])).reshape(-1)[0]))


def _port(**kw):
    cost = _build_fc(fluid, **kw)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    return cost, fluid.default_main_program(), exe


def _state(prog, scope):
    return {v.name: scope.get(v.name).clone()
            for v in prog.global_block().vars.values()
            if v.persistable and isinstance(scope.get(v.name), torch.Tensor)}


def _twin(**kw):
    """The same MixedPrecision fc program in both packages (the same
    dict), the port holding the JAX startup state."""
    jcost = _build_fc(jfluid, **kw)
    cost = _build_fc(fluid, **kw)
    jmain, main = jfluid.default_main_program(), fluid.default_main_program()
    assert (json.dumps(jmain.to_dict(), sort_keys=True)
            == json.dumps(main.to_dict(), sort_keys=True))
    assert main._loss_scaling == jmain._loss_scaling
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    exe = fluid.Executor(fluid.CPUPlace())
    for v in main.list_vars():
        val = jfluid.global_scope().get(v.name)
        if v.persistable and val is not None:
            fluid.global_scope().set(v.name, np.array(val))
    return jcost, cost, jmain, main, jexe, exe


def test_overflow_skips_update_and_halves_scale():
    cost, prog, exe = _port(init_loss_scaling=16.0, incr_every_n_steps=100)
    assert prog.amp is True and prog._loss_scaling
    scope = fluid.global_scope()
    exe.run(prog, feed=_feeds()[0], fetch_list=[cost])
    before = _state(prog, scope)
    ptrs = {n: scope.get(n).data_ptr() for n in before}
    exe.run(prog, feed=_bad_feed(), fetch_list=[cost])
    after = _state(prog, scope)
    ls = prog._loss_scaling
    for name, val in before.items():
        # the scope keeps its tensors: the skip is a select in place
        assert scope.get(name).data_ptr() == ptrs[name], name
        if name in (ls["scale"], ls["good_steps"]):
            continue
        assert torch.equal(val, after[name]), f"{name} changed in a skip"
    assert _scaler_state(prog, scope) == (8.0, 0)


def test_clean_steps_double_scale_and_reset_counter():
    cost, prog, exe = _port(init_loss_scaling=4.0, incr_every_n_steps=3)
    scope = fluid.global_scope()
    feeds = _feeds()
    for i in range(2):
        exe.run(prog, feed=feeds[i], fetch_list=[cost])
    assert _scaler_state(prog, scope) == (4.0, 2)
    exe.run(prog, feed=feeds[2], fetch_list=[cost])
    assert _scaler_state(prog, scope) == (8.0, 0)
    exe.run(prog, feed=feeds[3], fetch_list=[cost])
    assert _scaler_state(prog, scope) == (8.0, 1)


def test_scale_floored_at_min_loss_scaling():
    cost, prog, exe = _port(init_loss_scaling=4.0, min_loss_scaling=2.0)
    for _ in range(4):
        exe.run(prog, feed=_bad_feed(), fetch_list=[cost])
    assert _scaler_state(prog, fluid.global_scope())[0] == 2.0


def test_scaler_trajectory_matches_jax():
    """Eight steps with two overflows (Adam inside): the scaler's
    trajectory is the JAX one exactly and the losses agree to 2e-5;
    parameters and moments, after eight Adam steps on bf16 products,
    at the bf16 rule (BF16_TOL of max(1, |JAX value|))."""
    jcost, cost, jmain, main, jexe, exe = _twin(
        opt=lambda fl: fl.optimizer.Adam(0.05), init_loss_scaling=32.0,
        incr_every_n_steps=2, min_loss_scaling=8.0)
    seq = _feeds(8, seed=2)
    seq[2] = seq[5] = _bad_feed()
    traj, jtraj = [], []
    for step, feed in enumerate(seq):
        want = jexe.run(jmain, feed=feed, fetch_list=[jcost.name])[0]
        got = exe.run(main, feed=feed, fetch_list=[cost.name])[0]
        if step not in (2, 5):
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=TOL * max(1, abs(float(want))))
        jtraj.append(_scaler_state(jmain, jfluid.global_scope()))
        traj.append(_scaler_state(main, fluid.global_scope()))
    assert traj == jtraj
    # 32 -> 64 after two clean steps, halved by each overflow
    assert traj[1] == (64.0, 0) and traj[2] == (32.0, 0)
    assert traj[5] == (traj[4][0] / 2, 0)
    for v in main.list_vars():
        want = jfluid.global_scope().get(v.name)
        if v.persistable and want is not None:
            want = np.asarray(want, np.float64)
            got = fluid.global_scope().get(v.name).numpy()
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=BF16_TOL * max(1.0, float(np.abs(want).max())),
                err_msg=v.name)


def test_amp_knob_on_optimizer_routes_through_scaler():
    layers = fluid.layers
    x = layers.data(name="x", shape=[4], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    pred = layers.fc(input=x, size=1)
    cost = layers.mean(layers.square_error_cost(input=pred, label=y))
    fluid.optimizer.Adam(learning_rate=1e-3,
                         amp={"init_loss_scaling": 64.0}).minimize(cost)
    prog = fluid.default_main_program()
    assert prog.amp is True and prog._loss_scaling
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    out = exe.run(prog, feed=_feeds(1)[0], fetch_list=[cost])
    assert np.isfinite(out[0]).all()
    assert _scaler_state(prog, fluid.global_scope()) == (64.0, 1)


def test_check_nan_inf_overflow_is_skip_not_error():
    cost, prog, exe = _port(init_loss_scaling=16.0)
    exe.check_nan_inf = True
    feeds = _feeds(4)
    exe.run(prog, feed=_bad_feed(), fetch_list=[cost])
    seq = [feeds[0], _bad_feed(), feeds[1], feeds[2]]
    hs = exe.train_loop(prog, seq, fetch_list=[cost], steps=4,
                        fetch_every=4)
    assert len(hs) == 4
    hs = exe.train_loop(prog, seq, fetch_list=[cost], steps=4,
                        fetch_every=4, steps_per_launch=2)
    assert len(hs) == 4
    assert _scaler_state(prog, fluid.global_scope())[0] < 16.0


def test_train_loop_skip_master_weights_bitwise():
    """A window holding an overflow gives the same final parameters as
    running only the clean steps, at K 1, 2 and 4."""
    feeds = _feeds(4, seed=3)

    def run(seq, k):
        fluid.core.program.reset_default_programs()
        fluid.core.scope._global_scope = fluid.core.scope.Scope()
        cost, prog, exe = _port(init_loss_scaling=8.0)
        exe.train_loop(prog, seq, fetch_list=[cost], steps=len(seq),
                       fetch_every=len(seq), steps_per_launch=k)
        scope = fluid.global_scope()
        return {p.name: scope.get(p.name).clone()
                for p in prog.global_block().all_parameters()}

    want = run([feeds[0], feeds[1], feeds[2]], 1)
    for k in (1, 2, 4):
        got = run([feeds[0], feeds[1], _bad_feed(), feeds[2]], k)
        for name, val in want.items():
            assert torch.equal(val, got[name]), (name, k)


def test_for_test_clone_drops_stale_scaler_marker():
    layers = fluid.layers
    x = layers.data(name="x", shape=[4], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    pred = layers.fc(input=x, size=1)
    cost = layers.mean(layers.square_error_cost(input=pred, label=y))
    fluid.optimizer.Adam(1e-3, amp=True).minimize(cost)
    prog = fluid.default_main_program()
    test_prog = prog.clone(for_test=True)
    assert prog._loss_scaling
    assert not test_prog._loss_scaling
    assert not any(op.type in ("check_finite_and_unscale",
                               "update_loss_scaling", "backward")
                   for op in test_prog.global_block().ops)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.check_nan_inf = True
    exe.run(fluid.default_startup_program())
    feed = _feeds(1)[0]
    exe.run(prog, feed=feed, fetch_list=[cost])
    out = exe.run(test_prog, feed=feed, fetch_list=[pred])
    assert np.isfinite(out[0]).all()
    assert not prog.prune([pred])._loss_scaling


def test_bf16_vs_f32_convergence_small_transformer():
    from paddle_tpu_torch.models import transformer

    def run(amp):
        fluid.core.program.reset_default_programs()
        fluid.core.scope._global_scope = fluid.core.scope.Scope()
        _, _, avg_cost = transformer.transformer_lm_train_program(
            vocab=64, max_len=16, n_layers=1, d_model=32, n_heads=2,
            d_ff=64, lr=1e-2, amp=amp)
        prog = fluid.default_main_program()
        assert prog.amp is amp
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        rng = np.random.RandomState(0)
        feed = {"tokens": rng.randint(0, 64, (4, 16)).astype(np.int64),
                "labels": rng.randint(0, 64, (4, 16)).astype(np.int64)}
        return [float(exe.run(prog, feed=feed, fetch_list=[avg_cost])[0])
                for _ in range(20)]

    l32, l16 = run(False), run(True)
    assert l32[-1] < l32[0] and l16[-1] < l16[0]
    assert abs(l16[-1] - l32[-1]) / abs(l32[-1]) < 0.15


def test_checkpoint_resume_scaler_state_across_fused_boundary(tmp_path):
    """Exact resume through a skipped step on a window boundary: the
    parameters and the scaler match the uninterrupted run bitwise."""
    seq = _feeds(8, seed=5)
    seq[3] = _bad_feed()

    def build():
        fluid.core.program.reset_default_programs()
        fluid.core.scope._global_scope = fluid.core.scope.Scope()
        return _port(init_loss_scaling=32.0, incr_every_n_steps=3)

    def final_state(prog):
        scope = fluid.global_scope()
        return ({p.name: scope.get(p.name).clone()
                 for p in prog.global_block().all_parameters()},
                _scaler_state(prog, scope))

    cost, prog, exe = build()
    exe.train_loop(prog, seq, fetch_list=[cost], steps=8, fetch_every=8,
                   steps_per_launch=2)
    want_params, want_scaler = final_state(prog)
    assert want_scaler == (64.0, 1)
    ck = str(tmp_path / "ck")
    cost, prog, exe = build()
    exe.train_loop(prog, seq, fetch_list=[cost], steps=4, fetch_every=4,
                   steps_per_launch=2, checkpoint_dir=ck,
                   checkpoint_every=2)
    cost, prog, exe = build()
    exe.train_loop(prog, seq, fetch_list=[cost], steps=8, fetch_every=8,
                   steps_per_launch=2, resume_from=ck)
    got_params, got_scaler = final_state(prog)
    assert got_scaler == want_scaler
    for name, val in want_params.items():
        assert torch.equal(val, got_params[name]), name


LM = dict(vocab=64, max_len=32, n_layers=2, d_model=64, n_heads=4,
          d_ff=128, lr=1e-3, amp=True)
LM_RTOL = BF16_TOL


def test_amp_lm_train_loop_with_checkpoint_matches_jax(tmp_path,
                                                       monkeypatch):
    """The slice as a whole: transformer_lm_train_program(amp=True), 6
    steps through train_loop at K 2 with a checkpoint at step 4, in both
    packages from the same state; then both resume from their own step-4
    checkpoint for 2 more steps.  Each package's resumed steps are
    bitwise its uninterrupted ones where it promises that (the port) and
    the losses agree at the bf16 rule."""
    monkeypatch.setenv("FLAGS_fused_layernorm", "interpret")
    monkeypatch.setenv("FLAGS_fused_softmax_xent", "interpret")
    from paddle_tpu.models import transformer as JT
    from paddle_tpu_torch.models import transformer as PT

    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(6):
        t = rng.randint(0, LM["vocab"], (4, LM["max_len"]))
        feeds.append({"tokens": t.astype(np.int64),
                      "labels": np.roll(t, -1, axis=1).astype(np.int64)})

    def build():
        _reset()
        JT.transformer_lm_train_program(**LM)
        _, _, cost = PT.transformer_lm_train_program(**LM)
        jmain = jfluid.default_main_program()
        main = fluid.default_main_program()
        assert (fluid.checkpoint.program_fingerprint(main)
                == jfluid.checkpoint.program_fingerprint(jmain))
        jfluid.default_startup_program().random_seed = 3
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jfluid.default_startup_program())
        exe = fluid.Executor(fluid.CPUPlace())
        for v in main.list_vars():
            val = jfluid.global_scope().get(v.name)
            if v.persistable and val is not None:
                fluid.global_scope().set(v.name, np.array(val))
        return jexe, exe, jmain, main, cost.name

    jexe, exe, jmain, main, cost = build()
    kw = dict(fetch_list=[cost], steps=6, steps_per_launch=2,
              checkpoint_every=4)
    jl = [float(h.get()[0]) for h in jexe.train_loop(
        jmain, feeds, checkpoint_dir=str(tmp_path / "j"), **kw)]
    pl = [float(h.get()[0]) for h in exe.train_loop(
        main, feeds, checkpoint_dir=str(tmp_path / "p"), **kw)]
    np.testing.assert_allclose(pl, jl, rtol=LM_RTOL)
    assert pl[-1] < pl[0]
    for fl, d in ((jfluid, "j"), (fluid, "p")):
        assert fl.checkpoint.CheckpointManager(
            str(tmp_path / d)).steps() == [4]

    jexe, exe, jmain, main, cost = build()
    kw = dict(fetch_list=[cost], steps=6, steps_per_launch=2)
    jr = [float(h.get()[0]) for h in jexe.train_loop(
        jmain, feeds, resume_from=str(tmp_path / "j"), **kw)]
    hs = exe.train_loop(main, feeds, resume_from=str(tmp_path / "p"), **kw)
    assert [h.step for h in hs] == [4, 5]
    pr = [float(h.get()[0]) for h in hs]
    assert pr == pl[4:]                     # bitwise in the port
    np.testing.assert_allclose(pr, jr, rtol=LM_RTOL)
