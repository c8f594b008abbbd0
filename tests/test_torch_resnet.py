"""ResNet training through the port's Fluid front end against the JAX
package, on the CPU.

The JAX package runs the startup program and ``save_persistables``; the
port loads that state with ``io.load_persistables`` (parameters, Momentum
velocities and the BatchNorm running statistics).  Both then take the
same Momentum steps on the same seeded numpy feeds.  The JAX side runs
with ``PADDLE_TPU_PALLAS_INTERPRET=1``, so its channels-last BatchNorm
layers with C a multiple of 128 go through the Pallas backward kernel in
interpret mode; its others take the XLA closed form.  The port runs its
BatchNorm kernel's plain version through the autograd Function the card
uses.

The net is ResNet cut to size: the ``conv_bn_layer`` stem (16 channels)
and its 3x3/2 max pool, one ``bottleneck`` with ch_out 32 (so the
expansion and shortcut BatchNorms have C=128), the global average pool
and the softmax head; 16x16 images, batch 2, 10 classes.

Tolerances: f32, 1e-4 relative for the whole model (ROADMAP) -- the loss
of every step, every ``@GRAD`` of step 1 and every persistable after the
last step, each held to 1e-4 x its largest |value|.  ``program.amp``:
2e-2 on the losses, bf16 rounded at other places in the two packages;
its gradients and state are held to the f32 run (see the test).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu as jfluid
from paddle_tpu import io as jio
from paddle_tpu import layers as jlayers
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import resnet as JR
import paddle_tpu_torch as fluid
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import layers as players
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.models import resnet as PR

IMG, CLASSES, BATCH, LR = 16, 10, 2, 0.05
JAX = (jfluid, jlayers, jopt, JR)
PORT = (fluid, players, popt, PR)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The tier-1 run shares the machine's cores among several pytest
    workers: these convolutions take two of them, not all."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_port():
    fluid.core.program.reset_default_programs()
    fluid.core.scope._global_scope = fluid.core.scope.Scope()
    yield


def _image_shape(layout):
    return [IMG, IMG, 3] if layout == "NHWC" else [3, IMG, IMG]


def _small_net(pkg, layout, is_test=False, optimizer=None):
    """(avg_cost, acc, predict) of the cut-down ResNet in ``pkg``'s
    default programs."""
    _, layers, opt, resnet = pkg
    img = layers.data(name="data", shape=_image_shape(layout),
                      dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    x = resnet.conv_bn_layer(img, 16, 3, 1, 1, is_test=is_test,
                             data_format=layout)
    x = layers.pool2d(input=x, pool_type="max", pool_size=3, pool_stride=2,
                      pool_padding=1, data_format=layout)
    x = resnet.bottleneck(x, 32, 1, is_test, layout)
    x = layers.pool2d(input=x, pool_size=8, pool_type="avg",
                      global_pooling=True, data_format=layout)
    predict = layers.fc(input=x, size=CLASSES, act="softmax")
    avg_cost = layers.mean(layers.cross_entropy(input=predict, label=label))
    acc = layers.accuracy(input=predict, label=label)
    if not is_test:
        (optimizer or (lambda o: o.Momentum(learning_rate=LR,
                                            momentum=0.9)))(opt).minimize(
            avg_cost)
    return avg_cost, acc, predict


def _feeds(layout, n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"data": rng.rand(BATCH, *_image_shape(layout)).astype(
                 np.float32),
             "label": rng.randint(0, CLASSES, (BATCH, 1)).astype(np.int64)}
            for _ in range(n)]


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.max(np.abs(got - want), initial=0.0))
    assert err <= tol * max(float(np.max(np.abs(want), initial=0.0)),
                            1e-6), (what, err)


def _jax_start(tmp_path, layout, amp, **kw):
    """Build the net in the JAX package, run its startup and save the
    persistables; returns (executor, main, avg_cost)."""
    javg, _, _ = _small_net(JAX, layout, **kw)
    jmain = jfluid.default_main_program()
    jmain.amp = amp
    jfluid.default_startup_program().random_seed = 5
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    jio.save_persistables(jexe, str(tmp_path), jmain)
    return jexe, jmain, javg


def _run_both(tmp_path, layout, amp, steps, **kw):
    """``steps`` steps of the net in both packages from the JAX package's
    saved startup state -> (parameter names, [(JAX fetches, port
    fetches)] per step: the loss, then each parameter's @GRAD)."""
    jexe, jmain, javg = _jax_start(tmp_path, layout, amp, **kw)
    avg, _, _ = _small_net(PORT, layout, **kw)
    main = fluid.default_main_program()
    main.amp = amp
    exe = fluid.Executor(fluid.CPUPlace())
    pio.load_persistables(exe, str(tmp_path), main)
    params = [p.name for p in main.all_parameters() if p.trainable]
    fetch = [avg.name] + [p + "@GRAD" for p in params]
    out = []
    for feed in _feeds(layout, steps):
        want = jexe.run(jmain, feed=feed, fetch_list=fetch)
        got = exe.run(main, feed=feed, fetch_list=fetch)
        assert np.isfinite(got[0]).all()
        out.append(([np.asarray(w) for w in want], got))
    return params, out


def _states():
    """(port, JAX) value of every persistable of the port's program."""
    main = fluid.default_main_program()
    names = [v.name for v in main.list_vars()
             if v.persistable and not v.desc.is_data]
    return {n: (fluid.global_scope().get(n).float().numpy(),
                np.asarray(jfluid.global_scope().get(n))) for n in names}


def _state_matches(tol):
    """Every persistable of the port's program (parameters, velocities,
    BatchNorm running statistics) against the JAX scope's."""
    state = _states()
    assert any(n.endswith(".mean") for n in state)
    for n, (port, jax) in state.items():
        _close(port, jax, tol, n)


def _steps_match(tmp_path, layout, amp, tol, steps=3, **kw):
    params, out = _run_both(tmp_path, layout, amp, steps, **kw)
    for step, (want, got) in enumerate(out):
        _close(got[0], want[0], tol, f"loss of step {step + 1}")
    for p, g, w in zip(params, out[0][1][1:], out[0][0][1:]):
        _close(g, w, tol, p + "@GRAD")
    _state_matches(tol)


def test_resnet50_program_is_the_jax_program():
    """Built only: ResNet-50 at ImageNet width, NHWC, serializes to the
    same JSON in both packages (main and startup)."""
    JR.resnet_train_program(depth=50, class_dim=1000,
                            image_shape=(224, 224, 3), data_format="NHWC")
    PR.resnet_train_program(depth=50, class_dim=1000,
                            image_shape=(224, 224, 3), data_format="NHWC")
    jmain, pmain = jfluid.default_main_program(), fluid.default_main_program()
    ops = [op.type for op in pmain.global_block().ops]
    assert ops.count("batch_norm") == 53 and ops.count("conv2d") == 53
    assert ops.count("momentum") == 161
    assert pmain.to_dict() == jmain.to_dict()
    assert (fluid.default_startup_program().to_dict()
            == jfluid.default_startup_program().to_dict())


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_momentum_steps_match_jax(tmp_path, monkeypatch, layout):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    _steps_match(tmp_path, layout, amp=False, tol=1e-4)


def test_amp_steps_match_jax(tmp_path, monkeypatch):
    """The loss of every bf16 step at 2e-2.  The gradients and the state
    after 3 steps are not held to each other at 2e-2: BatchNorm's backward
    subtracts two projections from dy, and dy in bf16 leaves a residual
    percents of each gradient's max off its f32 value in BOTH packages,
    and a bias that starts at 0 is made of those gradients.  So each @GRAD of step 1 and each persistable after step 3
    of the port's amp run is held to the f32 run: no farther off than
    twice the JAX package's amp run is, plus 2e-2 of its max."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    params, amp = _run_both(tmp_path / "amp", "NHWC", True, 3)
    for step, (want, got) in enumerate(amp):
        _close(got[0], want[0], 2e-2, f"loss of step {step + 1}")
    amp_state = _states()
    jfluid.core.program.reset_default_programs()
    fluid.core.program.reset_default_programs()
    _, full = _run_both(tmp_path / "f32", "NHWC", False, 3)
    full_state = _states()
    pairs = [(p + "@GRAD", amp[0][1][i], amp[0][0][i], full[0][1][i])
             for i, p in enumerate(params, start=1)]
    pairs += [(n, port, jax, full_state[n][0])
              for n, (port, jax) in amp_state.items()]
    for name, port, jax, truth in pairs:
        top = float(np.abs(truth).max())
        jerr = float(np.abs(jax - truth).max())
        perr = float(np.abs(port - truth).max())
        assert perr <= 2 * jerr + 2e-2 * top, (name, perr, jerr, top)


@pytest.mark.parametrize("make", [
    lambda o: o.SGD(learning_rate=LR),
    lambda o: o.Momentum(learning_rate=LR, momentum=0.9, use_nesterov=True)],
    ids=["sgd", "nesterov"])
def test_sgd_and_nesterov_steps_match_jax(tmp_path, make):
    _steps_match(tmp_path, "NHWC", amp=False, tol=1e-4, steps=2,
                 optimizer=make)


def _amp_fetch_dtypes(pkg, fetch_of):
    """Build the cut-down ResNet in ``pkg`` under program.amp, run its
    startup and one step, and return the dtype name of every var that
    ``fetch_of(main, avg, predict)`` lists."""
    fl = pkg[0]
    avg, _, predict = _small_net(pkg, "NHWC")
    main = fl.default_main_program()
    main.amp = True
    exe = fl.Executor(fl.CPUPlace())
    exe.run(fl.default_startup_program())
    names = fetch_of(main, avg, predict)
    out = exe.run(main, feed=_feeds("NHWC", 1)[0], fetch_list=names,
                  return_numpy=False)
    return [str(o.dtype).replace("torch.", "") for o in out]


def test_amp_dtypes_follow_the_jax_rules():
    """Under program.amp: conv outputs, BatchNorm/pool activations and
    the two elementwise_adds (residual and the fc's broadcast bias, cast
    to bf16 as the JAX rule casts a mixed broadcast pair) bf16, so predict
    (softmax keeps its input's dtype) is bf16, the loss f32, the master
    weights, velocities and running stats f32 -- each dtype as the JAX
    package fetches it."""
    def fetch_of(main, avg, predict):
        block = main.global_block()
        keyed = (("conv2d", "Output"), ("batch_norm", "Y"),
                 ("pool2d", "Out"), ("elementwise_add", "Out"))
        return [avg.name, predict.name] + [
            op.desc.outputs[key][0] for typ, key in keyed
            for op in block.ops if op.type == typ]

    want = _amp_fetch_dtypes(JAX, fetch_of)
    jfluid.core.program.reset_default_programs()
    got = _amp_fetch_dtypes(PORT, fetch_of)
    assert want[:2] == ["float32", "bfloat16"]
    assert got == want
    assert all(t.dtype == torch.float32
               for t in fluid.global_scope()._vars.values()
               if t.is_floating_point())


def test_amp_every_var_dtype_matches_jax():
    """Every var of one amp program with a broadcast bias add (fc) and a
    same-shape mixed bf16/f32 pair (the fc's bf16 output plus an f32 feed
    of its shape) fetches with the JAX package's dtype: the broadcast pair
    casts to bf16, the same-shape pair promotes to f32."""
    def build(pkg):
        fl, layers, _, _ = pkg
        x = layers.data(name="x", shape=[6], dtype="float32")
        y = layers.data(name="y", shape=[8], dtype="float32")
        label = layers.data(name="label", shape=[1], dtype="int64")
        h = layers.fc(input=x, size=8, act="relu")
        mixed = layers.elementwise_add(h, y)
        both = layers.elementwise_add(mixed, h)
        predict = layers.fc(input=both, size=4, act="softmax")
        avg = layers.mean(layers.cross_entropy(input=predict, label=label))
        main = fl.default_main_program()
        main.amp = True
        exe = fl.Executor(fl.CPUPlace())
        exe.run(fl.default_startup_program())
        names = sorted({v for op in main.global_block().ops
                        for vs in op.desc.outputs.values() for v in vs})
        rng = np.random.RandomState(3)
        feed = {"x": rng.rand(5, 6).astype(np.float32),
                "y": rng.rand(5, 8).astype(np.float32),
                "label": rng.randint(0, 4, (5, 1)).astype(np.int64)}
        out = exe.run(main, feed=feed, fetch_list=names, return_numpy=False)
        return dict(zip(names, (str(o.dtype).replace("torch.", "")
                                for o in out))), avg.name, mixed.name

    want, avg, mixed = build(JAX)
    fluid.core.program.reset_default_programs()
    got, _, _ = build(PORT)
    assert want[avg] == "float32" and want[mixed] == "float32"
    assert "bfloat16" in want.values()
    assert got == want


def test_is_test_forward_matches_jax(tmp_path):
    """Inference mode from trained running statistics: one JAX step
    moves them, then both packages build the is_test net under the same
    names and compare the probabilities."""
    jexe, jmain, javg = _jax_start(tmp_path / "train", "NHWC", False)
    feed = _feeds("NHWC", 2)
    jexe.run(jmain, feed=feed[0], fetch_list=[javg])
    jfluid.core.program.reset_default_programs()
    _, _, jpred = _small_net(JAX, "NHWC", is_test=True)
    jtest = jfluid.default_main_program()
    jio.save_persistables(jexe, str(tmp_path / "test"), jtest)
    _, _, pred = _small_net(PORT, "NHWC", is_test=True)
    main = fluid.default_main_program()
    assert main.to_dict() == jtest.to_dict()
    exe = fluid.Executor(fluid.CPUPlace())
    pio.load_persistables(exe, str(tmp_path / "test"), main)
    assert not np.allclose(fluid.global_scope().get(
        "batch_norm_0.mean").numpy(), 0.0)
    (want,) = jexe.run(jtest, feed=feed[1], fetch_list=[jpred])
    (got,) = exe.run(main, feed=feed[1], fetch_list=[pred])
    _close(got, want, 1e-5, "probabilities")


POOL_CASES = [
    # (type, k, stride, pad, ceil_mode, exclusive)
    ("max", 3, 2, 1, False, True),     # the ResNet stem's pool
    ("avg", 3, 2, 1, False, True),
    ("avg", 3, 2, 1, False, False),
    ("max", 2, 2, 1, True, True),      # ceil: a last window of padding only
    ("avg", 2, 2, 1, True, True),
    ("avg", 2, 2, 1, True, False),
    ("max", 3, 2, 0, True, True),      # ceil: a partial last window
    ("avg", 3, 2, 0, True, True),
    ("max", 3, 1, 2, False, True),     # padding over half a window
    ("avg", 3, 1, 2, False, True),
]


def _pool_program(pkg, layout, case, global_pooling=False):
    _, layers, _, _ = pkg
    ptype, k, s, p, ceil_mode, exclusive = case
    shape = [5, 6, 3] if layout == "NHWC" else [3, 5, 6]
    x = layers.data(name="x", shape=shape, dtype="float32")
    return layers.pool2d(input=x, pool_size=k, pool_type=ptype,
                         pool_stride=s, pool_padding=p,
                         global_pooling=global_pooling, ceil_mode=ceil_mode,
                         exclusive=exclusive, data_format=layout)


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("case", POOL_CASES + ["global"])
def test_pool2d_matches_jax(layout, case):
    glob = case == "global"
    case = ("avg", 2, 1, 0, False, True) if glob else case
    jout = _pool_program(JAX, layout, case, glob)
    out = _pool_program(PORT, layout, case, glob)
    shape = (2, 5, 6, 3) if layout == "NHWC" else (2, 3, 5, 6)
    feed = {"x": np.random.RandomState(9).randn(*shape).astype(np.float32)}
    (want,) = jfluid.Executor(jfluid.CPUPlace()).run(
        jfluid.default_main_program(), feed=feed, fetch_list=[jout])
    (got,) = fluid.Executor(fluid.CPUPlace()).run(
        fluid.default_main_program(), feed=feed, fetch_list=[out])
    assert got.shape[1:] == tuple(out.shape[1:])
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)


def test_ceil_mode_is_not_torchs():
    """The JAX package's ceil_mode keeps a last window that lies in the
    padding (out = ceil((5 + 2 - 2) / 2) + 1 = 4 here), where PyTorch's
    own ceil_mode drops it (3): the port pads by the JAX rule itself."""
    x = torch.randn(1, 1, 5, 5)
    assert F.max_pool2d(x, 2, 2, 1, ceil_mode=True).shape[-1] == 3
    _pool_program(PORT, "NCHW", ("max", 2, 2, 1, True, True))
    (got,) = fluid.Executor(fluid.CPUPlace()).run(
        fluid.default_main_program(),
        feed={"x": np.zeros((1, 3, 5, 6), np.float32)},
        fetch_list=[fluid.default_main_program().global_block().ops[-1]
                    .desc.outputs["Out"][0]])
    assert got.shape[-2:] == (4, 4)
    assert np.isneginf(got[..., -1, :]).all()
