"""The port's DataFeeder, host metrics, in-graph Evaluator and
WeightedAverage against the JAX package's, on the same numpy.

`DataFeeder.feed` must give the JAX feeder's arrays bit for bit (names,
dtypes, shapes, values) for dense columns and for ragged ones (padding
to a power-of-two length with the ``@SEQ_LEN`` companion).  The numpy
metrics must agree exactly, the evaluator's streaming accuracy and the
weighted average too.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import average as javerage
from paddle_tpu import evaluator as jevaluator
from paddle_tpu import metrics as jmetrics
import paddle_tpu_torch as fluid
from paddle_tpu_torch import average as paverage
from paddle_tpu_torch import evaluator as pevaluator
from paddle_tpu_torch import metrics as pmetrics


@pytest.fixture(autouse=True)
def _fresh():
    jfluid.core.program.reset_default_programs()
    fluid.core.program.reset_default_programs()
    fluid.core.scope._global_scope = fluid.core.scope.Scope()
    yield


def _feeds(rows, declare):
    """Each package's DataFeeder.feed over ``rows`` for the data vars
    ``declare(layers)`` makes."""
    out = []
    for pkg in (jfluid, fluid):
        feeder = pkg.DataFeeder(place=pkg.CPUPlace(),
                                feed_list=declare(pkg.layers))
        out.append(feeder.feed(rows))
    return out


def _bitwise(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def test_data_feeder_dense_columns_bitwise():
    """Flat 784-pixel samples reshaped to the declared [1, 28, 28], scalar
    labels given their declared [1], float64 input cast to float32."""
    rng = np.random.RandomState(0)
    rows = [(rng.rand(784), int(rng.randint(10)), rng.rand(3).tolist())
            for _ in range(5)]

    def declare(layers):
        return [layers.data(name="img", shape=[1, 28, 28], dtype="float32"),
                layers.data(name="label", shape=[1], dtype="int64"),
                layers.data(name="vec", shape=[3], dtype="float32")]
    want, got = _feeds(rows, declare)
    _bitwise(got, want)
    assert got["img"].shape == (5, 1, 28, 28)
    assert got["label"].shape == (5, 1) and got["label"].dtype == np.int64


@pytest.mark.parametrize("lengths", [[3, 1, 5], [9, 2, 17, 1]])
def test_data_feeder_ragged_columns_bitwise(lengths):
    """Ragged id and feature columns: padded to the next power of two (at
    least 8) with an int32 @SEQ_LEN vector."""
    rng = np.random.RandomState(1)
    rows = [([int(i) for i in rng.randint(0, 50, n)],
             rng.rand(n, 4).astype(np.float32), [int(n % 2)])
            for n in lengths]

    def declare(layers):
        return [layers.data(name="words", shape=[1], dtype="int64",
                            lod_level=1),
                layers.data(name="feats", shape=[4], dtype="float32",
                            lod_level=1),
                layers.data(name="label", shape=[1], dtype="int64")]
    want, got = _feeds(rows, declare)
    _bitwise(got, want)
    pad = 8 if max(lengths) <= 8 else 32
    assert got["words"].shape == (len(lengths), pad)
    assert got["words@SEQ_LEN"].tolist() == lengths


def test_data_feeder_pinned_memory_stages_on_place(monkeypatch):
    """FLAGS_use_pinned_memory: the feed comes back as tensors on the
    feeder's place (CPU tensors on a CPU place), bitwise the arrays of
    the unstaged feed, and the Executor takes it as it is: an fc program
    fetches the same bits from both feeds."""
    import torch
    rng = np.random.RandomState(3)
    rows = [(rng.rand(6).astype(np.float32),
             [int(i) for i in rng.randint(0, 9, n)]) for n in (3, 5, 2)]
    x = fluid.layers.data(name="x", shape=[6], dtype="float32")
    words = fluid.layers.data(name="words", shape=[1], dtype="int64",
                              lod_level=1)
    y = fluid.layers.fc(input=x, size=4)
    feeder = fluid.DataFeeder(place=fluid.CPUPlace(), feed_list=[x, words])
    plain = feeder.feed(rows)
    monkeypatch.setattr(fluid.flags.FLAGS, "use_pinned_memory", True)
    staged = feeder.feed(rows)
    assert sorted(staged) == sorted(plain)
    for k, v in staged.items():
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu", k
        assert v.numpy().dtype == plain[k].dtype, k
        assert v.numpy().tobytes() == plain[k].tobytes(), k
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    (want,) = exe.run(feed=plain, fetch_list=[y])
    (got,) = exe.run(feed=staged, fetch_list=[y])
    assert got.tobytes() == want.tobytes()


def _drive(metric_pair, updates):
    """The same update calls on the JAX and the port metric -> both
    evals."""
    for args, kwargs in updates:
        for m in metric_pair:
            m.update(*args, **kwargs)
    return [m.eval() for m in metric_pair]


def test_host_metrics_match_jax():
    rng = np.random.RandomState(2)
    preds = rng.rand(64, 2)
    labels = rng.randint(0, 2, (64, 1))
    cases = [
        ("Accuracy", [((0.5, 10), {}), ((0.75, 30), {})]),
        ("ChunkEvaluator", [((5, 7, 4), {}), ((np.array([2, 1]), 3, 2), {})]),
        ("EditDistance", [((np.array([0, 2, 1.5]), 3), {}),
                          ((np.array([0, 0]), 2), {})]),
        ("Auc", [((preds[:32], labels[:32]), {}),
                 ((preds[32:], labels[32:]), {})]),
        ("Precision", [((preds[:, 1], labels), {})]),
        ("Recall", [((preds[:, 1], labels), {})]),
    ]
    for name, updates in cases:
        j, p = _drive((getattr(jmetrics, name)(),
                       getattr(pmetrics, name)()), updates)
        assert np.array_equal(np.asarray(p), np.asarray(j)), (name, p, j)
    j, p = _drive((jmetrics.LatencyStats(max_samples=4),
                   pmetrics.LatencyStats(max_samples=4)),
                  [((s,), {}) for s in (0.1, 0.4, 0.2, 0.9, 0.3, 0.05)])
    assert p == j
    composite = []
    for mod in (jmetrics, pmetrics):
        c = mod.CompositeMetric()
        c.add_metric(mod.Precision())
        c.add_metric(mod.Recall())
        for m in c._metrics:
            m.update(preds[:, 1], labels)
        composite.append(c.eval())
    assert composite[0] == composite[1]


def test_weighted_average_matches_jax():
    avgs = (javerage.WeightedAverage(), paverage.WeightedAverage())
    for v, w in ((2.0, 1), (np.array([1.0, 3.0]), 2), (0.5, 4)):
        for a in avgs:
            a.add(v, w)
    assert np.array_equal(avgs[1].eval(), avgs[0].eval())
    for a in avgs:
        with pytest.raises(ValueError):
            a.add([1.0, 2.0], 1)
        a.reset()
        with pytest.raises(ValueError):
            a.eval()


def test_accuracy_evaluator_matches_jax():
    """The in-graph streaming accuracy over three batches (state vars
    updated by ops each step), then reset to zero."""
    rng = np.random.RandomState(3)
    batches = [(rng.rand(6, 4).astype(np.float32),
                rng.randint(0, 4, (6, 1)).astype(np.int64))
               for _ in range(3)]
    results = []
    for pkg, ev in ((jfluid, jevaluator), (fluid, pevaluator)):
        x = pkg.layers.data(name="x", shape=[4], dtype="float32")
        label = pkg.layers.data(name="label", shape=[1], dtype="int64")
        acc = ev.Accuracy(input=x, label=label)
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(pkg.default_startup_program())
        per_batch = [float(np.asarray(exe.run(
            pkg.default_main_program(), feed={"x": xs, "label": ys},
            fetch_list=acc.metrics)[0])) for xs, ys in batches]
        total = acc.eval(exe)
        acc.reset(exe)
        results.append((per_batch, total, acc.eval(exe)))
    assert results[1] == results[0]
    assert results[1][2] == 0.0
