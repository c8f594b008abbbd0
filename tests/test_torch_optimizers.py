"""Every optimizer rule, weight decay, gradient clip, LR schedule and
ModelAverage of the port against the JAX package.

One small fc program is built by each package's front end from the same
code; the two programs must serialize to the same dict (so their
checkpoint fingerprints agree).  The JAX package runs the startup
program and the port takes its state; both then take 5 steps on the same
seeded numpy feeds on the CPU.  Losses, every parameter and every
accumulator agree to 2e-5 x max(1, max |JAX value|) (f32 op rules,
ROADMAP's ground rules).  Twins of tests/test_clip_regularizer.py and
tests/test_model_average.py sit at the end.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid

TOL = 2e-5
STEPS = 5


@pytest.fixture(autouse=True)
def _fresh_port():
    fluid.core.program.reset_default_programs()
    fluid.core.scope._global_scope = fluid.core.scope.Scope()
    yield


def _feeds(n=STEPS, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.rand(8, 4).astype(np.float32),
             "y": rng.rand(8, 1).astype(np.float32)} for _ in range(n)]


def _fc_loss(fl, param_attr=None, regularizer=None):
    layers = fl.layers
    x = layers.data(name="x", shape=[4], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    h = layers.fc(input=x, size=6, act="tanh", param_attr=param_attr)
    pred = layers.fc(input=h, size=1)
    return layers.mean(layers.square_error_cost(input=pred, label=y))


def _twin(build):
    """Build with both front ends; -> (jexe, exe, jfetch, fetch) with the
    port's scope holding the JAX startup state."""
    jfetch = build(jfluid)
    fetch = build(fluid)
    jmain, main = jfluid.default_main_program(), fluid.default_main_program()
    assert (json.dumps(jmain.to_dict(), sort_keys=True)
            == json.dumps(main.to_dict(), sort_keys=True))
    assert (jfluid.checkpoint.program_fingerprint(jmain)
            == fluid.checkpoint.program_fingerprint(main))
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    exe = fluid.Executor(fluid.CPUPlace())
    for v in main.list_vars():
        val = jfluid.global_scope().get(v.name)
        if v.persistable and val is not None:
            fluid.global_scope().set(v.name, np.array(val))
    return jexe, exe, jfetch, fetch


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    top = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    assert got.shape == want.shape or got.size == want.size, what
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=0,
                               atol=TOL * top, err_msg=what)


def _run_both(build, feeds=None, extra_fetch=()):
    jexe, exe, jfetch, fetch = _twin(build)
    jmain, main = jfluid.default_main_program(), fluid.default_main_program()
    fetches = [fetch.name] + list(extra_fetch)
    for step, feed in enumerate(feeds or _feeds()):
        want = jexe.run(jmain, feed=feed, fetch_list=fetches)
        got = exe.run(main, feed=feed, fetch_list=fetches)
        for name, g, w in zip(fetches, got, want):
            _close(g, w, f"step {step} {name}")
    compared = 0
    for v in main.list_vars():
        want = jfluid.global_scope().get(v.name)
        if not v.persistable or want is None or v.desc.is_data:
            continue
        got = fluid.global_scope().get(v.name)
        _close(got.numpy() if isinstance(got, torch.Tensor) else got,
               np.asarray(want), v.name)
        compared += 1
    return compared


OPTIMIZERS = {
    "sgd": lambda fl: fl.optimizer.SGD(0.1),
    "momentum": lambda fl: fl.optimizer.Momentum(0.1, momentum=0.9),
    "momentum_nesterov": lambda fl: fl.optimizer.Momentum(
        0.1, momentum=0.9, use_nesterov=True),
    "adam": lambda fl: fl.optimizer.Adam(0.05),
    "adamax": lambda fl: fl.optimizer.Adamax(0.05),
    "adagrad": lambda fl: fl.optimizer.Adagrad(0.1),
    "decayed_adagrad": lambda fl: fl.optimizer.DecayedAdagrad(0.1),
    "adadelta": lambda fl: fl.optimizer.Adadelta(1.0),
    "rmsprop": lambda fl: fl.optimizer.RMSProp(0.01, momentum=0.5),
    "ftrl": lambda fl: fl.optimizer.Ftrl(0.1, l1=0.01, l2=0.01),
    "ftrl_power": lambda fl: fl.optimizer.Ftrl(0.1, l1=0.01, l2=0.01,
                                               lr_power=-0.7),
    "proximal_gd": lambda fl: fl.optimizer.ProximalGD(0.1, l1=0.01,
                                                      l2=0.01),
    "proximal_gd_l2": lambda fl: fl.optimizer.ProximalGD(0.1, l2=0.01),
    "proximal_adagrad": lambda fl: fl.optimizer.ProximalAdagrad(
        0.1, l1=0.01, l2=0.01),
}


@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_optimizer_rule_matches_jax(kind):
    def build(fl):
        loss = _fc_loss(fl)
        OPTIMIZERS[kind](fl).minimize(loss)
        return loss
    assert _run_both(build) >= 4


def test_average_accumulates_matches_jax():
    def build(fl):
        loss = _fc_loss(fl)
        fl.optimizer.SGD(0.1).minimize(loss)
        fl.optimizer.ModelAverage(average_window_rate=0.5,
                                  min_average_window=2,
                                  max_average_window=3)
        return loss
    # 5 steps cross the window restart (min 2, max 3) twice
    assert _run_both(build) >= 4 * 5


def test_all_rules_registered():
    rules = {"sgd", "momentum", "adam", "adamax", "adagrad",
             "decayed_adagrad", "adadelta", "rmsprop", "ftrl",
             "proximal_gd", "proximal_adagrad", "average_accumulates",
             "check_finite_and_unscale", "update_loss_scaling"}
    ported = set(fluid.core.registry.OpRegistry.registered_ops())
    assert rules <= ported
    assert rules <= set(jfluid.core.registry.OpRegistry.registered_ops())


REGULARIZERS = {
    "l1": lambda fl: fl.regularizer.L1Decay(0.05),
    "l2": lambda fl: fl.regularizer.L2Decay(0.05),
    "l1_class": lambda fl: fl.regularizer.L1DecayRegularizer(0.02),
    "l2_class": lambda fl: fl.regularizer.L2DecayRegularizer(0.02),
}


@pytest.mark.parametrize("kind", sorted(REGULARIZERS))
@pytest.mark.parametrize("where", ["optimizer", "param"])
def test_regularizer_matches_jax(kind, where):
    def build(fl):
        reg = REGULARIZERS[kind](fl)
        attr = fl.ParamAttr(regularizer=reg) if where == "param" else None
        loss = _fc_loss(fl, param_attr=attr)
        fl.optimizer.Momentum(
            0.1, momentum=0.9,
            regularization=reg if where == "optimizer" else None
        ).minimize(loss)
        return loss
    _run_both(build)


CLIPS = {
    "value": lambda fl: fl.clip.GradientClipByValue(max=0.05),
    "value_asym": lambda fl: fl.clip.GradientClipByValue(max=0.05,
                                                         min=-0.01),
    "norm": lambda fl: fl.clip.GradientClipByNorm(clip_norm=0.1),
    "global_norm": lambda fl: fl.clip.GradientClipByGlobalNorm(
        clip_norm=0.1),
}


@pytest.mark.parametrize("kind", sorted(CLIPS))
def test_gradient_clip_matches_jax(kind):
    def build(fl):
        loss = _fc_loss(fl)
        fl.clip.set_gradient_clip(CLIPS[kind](fl))
        fl.optimizer.SGD(1.0).minimize(loss)
        return loss
    _run_both(build)


def test_gradient_clip_by_param_attr_and_error_clip():
    """A clip given through ParamAttr to one parameter; ErrorClipByValue
    appends the JAX package's clip op."""
    def build(fl):
        loss = _fc_loss(fl, param_attr=fl.ParamAttr(
            gradient_clip=fl.clip.GradientClipByValue(max=0.01)))
        fl.optimizer.Adam(0.05).minimize(loss)
        return loss
    _run_both(build)
    ops = []
    for fl in (jfluid, fluid):
        block = fl.Program().global_block()
        fl.clip.ErrorClipByValue(max=2.0).append_clip_op(block, "g")
        ops.append(block.ops[0].desc.to_dict())
    assert ops[0] == ops[1] and ops[0]["attrs"]["min"] == -2.0


SCHEDULES = {
    "noam": lambda L: L.noam_decay(d_model=64, warmup_steps=3),
    "exponential": lambda L: L.exponential_decay(0.5, 2, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(
        0.5, 2, 0.5, staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.5, 2, 0.5),
    "inverse_time": lambda L: L.inverse_time_decay(0.5, 2, 0.5,
                                                   staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.5, 3, 0.01, power=2.0),
    "polynomial_cycle": lambda L: L.polynomial_decay(0.5, 2, 0.01,
                                                     cycle=True),
    "piecewise": lambda L: L.piecewise_decay([2, 4], [0.5, 0.2, 0.05]),
}


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_lr_schedule_matches_jax(kind):
    lrs = {}

    def build(fl):
        loss = _fc_loss(fl)
        lr = SCHEDULES[kind](fl.layers)
        lrs[fl] = lr
        fl.optimizer.SGD(learning_rate=lr).minimize(loss)
        return loss
    jexe, exe, jloss, loss = _twin(build)
    jmain, main = jfluid.default_main_program(), fluid.default_main_program()
    assert main.global_block().ops[0].type == "increment"
    seen = []
    for feed in _feeds():
        want = jexe.run(jmain, feed=feed,
                        fetch_list=[jloss.name, lrs[jfluid].name])
        got = exe.run(main, feed=feed, fetch_list=[loss.name, lrs[fluid].name])
        _close(got[0], want[0], "loss")
        _close(got[1], want[1], "learning rate")
        seen.append(float(np.asarray(got[1]).reshape(-1)[0]))
    assert len(set(seen)) > 1          # the schedule moves
    for p in main.all_parameters():
        _close(fluid.global_scope().get(p.name).numpy(),
               np.asarray(jfluid.global_scope().get(p.name)), p.name)


def test_per_parameter_learning_rate_matches_jax():
    def build(fl):
        loss = _fc_loss(fl, param_attr=fl.ParamAttr(learning_rate=0.25))
        fl.optimizer.Adam(0.05).minimize(loss)
        return loss
    _run_both(build)


# -- twins of tests/test_clip_regularizer.py --------------------------------

def _one_sgd_step(clip=None, lr=1.0, regularization=None, scale=1000.0):
    """One SGD step on w [4] with huge gradients; -> (w0, w1)."""
    layers = fluid.layers
    x = layers.data(name="x", shape=[4], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    pred = layers.fc(input=x, size=1, bias_attr=False,
                     param_attr=fluid.ParamAttr(name="w"))
    loss = layers.mean(layers.scale(
        layers.square_error_cost(input=pred, label=y), scale=scale))
    if clip is not None:
        fluid.clip.set_gradient_clip(clip)
    fluid.optimizer.SGD(learning_rate=lr,
                        regularization=regularization).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    scope = fluid.global_scope()
    w0 = scope.get("w").numpy().copy()
    xs = np.random.RandomState(0).rand(8, 4).astype(np.float32)
    ys = 100.0 * np.ones((8, 1), np.float32)
    exe.run(feed={"x": xs, "y": ys}, fetch_list=[loss])
    return w0, scope.get("w").numpy().copy()


def test_global_norm_clip_caps_update():
    w0, w1 = _one_sgd_step(
        clip=fluid.clip.GradientClipByGlobalNorm(clip_norm=0.5))
    upd = np.linalg.norm((w0 - w1).ravel())
    assert 0.4 * 0.5 < upd <= 0.5 * 1.001, upd


def test_value_clip_bounds_each_component():
    w0, w1 = _one_sgd_step(clip=fluid.clip.GradientClipByValue(max=0.1))
    assert np.all(np.abs(w0 - w1) <= 0.1 + 1e-6)
    assert np.abs(w0 - w1).max() > 0.09


def test_unclipped_update_is_much_larger():
    w0, w1 = _one_sgd_step()
    assert np.linalg.norm((w0 - w1).ravel()) > 10.0


def test_l2_regularizer_decays_weights():
    w0, w1 = _one_sgd_step(lr=0.1, scale=0.0,
                           regularization=fluid.regularizer.L2Decay(0.5))
    np.testing.assert_allclose(w1, w0 * (1 - 0.1 * 0.5), rtol=1e-5,
                               atol=1e-6)


# -- twins of tests/test_model_average.py -----------------------------------

def test_model_average_apply_restore():
    """apply() swaps the average in (the JAX package's average of the
    same run), restore() puts the live tensors back bitwise."""
    mas = []

    def build(fl):
        x = fl.layers.data(name="x", shape=[4], dtype="float32")
        y = fl.layers.data(name="y", shape=[1], dtype="float32")
        pred = fl.layers.fc(input=x, size=1)
        loss = fl.layers.mean(fl.layers.square_error_cost(input=pred,
                                                          label=y))
        fl.optimizer.SGD(learning_rate=0.05).minimize(loss)
        mas.append(fl.optimizer.ModelAverage(average_window_rate=0.5,
                                             min_average_window=2,
                                             max_average_window=10))
        return loss
    jexe, exe, jloss, loss = _twin(build)
    rng = np.random.RandomState(0)
    xs = rng.rand(16, 4).astype("float32")
    feed = {"x": xs, "y": xs @ np.array([[1.0], [2.0], [3.0], [4.0]],
                                        "float32")}
    for _ in range(20):
        jexe.run(jfluid.default_main_program(), feed=feed,
                 fetch_list=[jloss])
        exe.run(fluid.default_main_program(), feed=feed, fetch_list=[loss])
    pname = mas[1].params[0].name
    scope = fluid.global_scope()
    live = scope.get(pname).clone()
    with mas[0].apply():
        javg = np.asarray(jfluid.global_scope().get(pname)).copy()
    with mas[1].apply():
        avg = scope.get(pname).numpy().copy()
    assert torch.equal(scope.get(pname), live)      # restored bitwise
    assert not np.allclose(avg, live.numpy())
    _close(avg, javg, "averaged parameter")
    mas[1].apply(exe, need_restore=False)
    assert not torch.equal(scope.get(pname), live)
    mas[1].restore(exe)
    assert torch.equal(scope.get(pname), live)


def test_weighted_average():
    wa = fluid.average.WeightedAverage()
    wa.add(2.0, 1)
    wa.add(4.0, 3)
    assert wa.eval() == 3.5
    wa.reset()
    wa.add(1.0, 1)
    assert wa.eval() == 1.0
