"""The port's legacy v2 API and PyDataProvider2 (twins of
tests/test_v2_api.py and tests/test_pydataprovider2.py).

Each twin builds the same config through both packages.  The v2 trainer
twins start the port from a ``v2.parameters`` tar the JAX package wrote
(`Parameters.from_tar`, the function that carries weights across), train
both on the same seeded batches and hold every iteration's cost and
every final parameter to the JAX package's at 1e-4 (whole models,
ROADMAP).  The port's own ``parameters.create`` gives the JAX names and
shapes.  The slice's model, the GRU classifier of tools/gru_bench.py, is
twinned at vocab 50, H 16.
"""
import importlib.util
import io
import sys
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu.recordio as jrecordio
import paddle_tpu.trainer.PyDataProvider2 as jdp2
from paddle_tpu.distributed import MasterServer as JMasterServer
from paddle_tpu.distributed import MasterService as JMasterService

import paddle_tpu_torch.recordio as precordio
import paddle_tpu_torch.trainer.PyDataProvider2 as pdp2
from paddle_tpu_torch.distributed import MasterServer, MasterService

from _torch_legacy_twins import (JAX, PORT, assert_close, assert_v2_twins,
                                 fresh, jax_state, load_into_port,
                                 same_program, v2_twins)

CPU = PORT.place


@pytest.fixture(autouse=True)
def _fresh():
    fresh()
    yield


# ---------------------------------------------------------------------------
# tests/test_v2_api.py
# ---------------------------------------------------------------------------

def _v1_mlp(pk):
    L, A = pk.L, pk.A
    img = L.data_layer(name="pixel", size=64)
    h = L.fc_layer(input=img, size=32, act=A.ReluActivation())
    pred = L.fc_layer(input=h, size=10, act=A.SoftmaxActivation())
    lbl = L.data_layer(name="label", size=1,
                       type=pk.v2.data_type.integer_value(10))
    return L.classification_cost(input=pred, label=lbl)


def test_v1_dsl_mlp_trains():
    rng = np.random.RandomState(0)
    x = rng.rand(16, 64).astype("float32")
    y = rng.randint(0, 10, (16, 1)).astype("int64")
    losses, params = {}, {}
    for pk in (JAX, PORT):
        [cost_var] = pk.L.parse_network(_v1_mlp(pk))
        pk.fluid.optimizer.SGD(learning_rate=0.05).minimize(cost_var)
        exe = pk.fluid.Executor(pk.place)
        exe.run(pk.fluid.default_startup_program())
        if pk is JAX:
            state = jax_state()
        else:
            load_into_port(state)
        losses[pk.name] = [float(exe.run(pk.fluid.default_main_program(),
                                         feed={"pixel": x, "label": y},
                                         fetch_list=[cost_var])[0])
                           for _ in range(10)]
        scope = pk.fluid.global_scope()
        params[pk.name] = {n: np.asarray(scope.get(n)) for n in state}
    same_program()
    assert losses["port"][-1] < losses["port"][0]
    assert_close(losses["port"], losses["jax"], what="losses")
    for n in state:
        assert_close(params["port"][n], params["jax"][n], what=n)


def test_v1_parse_network_stable_param_names():
    names = {}
    for pk in (JAX, PORT):
        img = pk.L.data_layer(name="pixel", size=8)
        pred = pk.L.fc_layer(input=img, size=4,
                             act=pk.A.SoftmaxActivation())
        got = []
        for _ in range(2):
            prog, startup = pk.fluid.Program(), pk.fluid.Program()
            with pk.fluid.program_guard(prog, startup):
                pk.L.parse_network(pred)
            got.append(sorted(v.name for v in prog.global_block().vars.values()
                              if getattr(v, "persistable", False)))
        assert got[0] == got[1] and got[0]
        names[pk.name] = got[0]
    assert names["port"] == names["jax"]


def _mlp(pk, dim=64, nclass=10):
    paddle = pk.v2
    images = paddle.layer.data(name="pixel",
                               type=paddle.data_type.dense_vector(dim))
    label = paddle.layer.data(name="label",
                              type=paddle.data_type.integer_value(nclass))
    h = paddle.layer.fc(input=images, size=32, act=paddle.activation.Relu())
    predict = paddle.layer.fc(input=h, size=nclass,
                              act=paddle.activation.Softmax())
    cost = paddle.layer.classification_cost(input=predict, label=label)
    return cost, predict


def test_v2_trainer_events_and_infer():
    rng = np.random.RandomState(0)
    X = rng.rand(64, 64).astype("float32")
    Y = rng.randint(0, 10, 64)

    def make_reader():
        def reader():
            for i in range(64):
                yield X[i], int(Y[i])
        return reader

    res = v2_twins(_mlp, make_reader, lambda pk: pk.v2.optimizer.Momentum(
        learning_rate=0.05, momentum=0.9), 32, 25)
    assert res.port.events == res.jax.events
    assert res.port.events.count("BeginPass") == 25
    assert res.port.events.count("EndIteration") == 50
    assert res.port.costs[-1] < res.port.costs[0] * 0.7
    assert_v2_twins(res)

    batches = lambda: iter([[(X[i], int(Y[i])) for i in range(64)]])  # noqa
    tests = [t.trainer.test(batches).cost for t in (res.jax, res.port)]
    assert np.isfinite(tests[1])
    assert_close(tests[1], tests[0], what="test cost")

    outs = {}
    for pk, built, params in ((JAX, res.jbuilt, res.jparams),
                              (PORT, res.pbuilt, res.pparams)):
        kw = {"place": CPU} if pk is PORT else {}
        outs[pk.name] = pk.v2.infer(output_layer=built[1], parameters=params,
                                    input=[(X[i],) for i in range(64)], **kw)
    assert outs["port"].shape == (64, 10)
    assert_close(outs["port"], outs["jax"], what="infer")
    assert (outs["port"].argmax(1) == Y).mean() > 0.5


def test_v2_parameters_tar_roundtrip():
    cost, _ = _mlp(JAX, dim=16, nclass=4)
    jparams = JAX.v2.parameters.create(cost)
    jbuf = io.BytesIO()
    jparams.to_tar(jbuf)
    # JAX tar -> port -> tar -> JAX, bitwise; the port's tar holds the same
    # members, byte for byte
    pparams = PORT.v2.parameters.Parameters.from_tar(
        io.BytesIO(jbuf.getvalue()))
    pbuf = io.BytesIO()
    pparams.to_tar(pbuf)
    back = JAX.v2.parameters.Parameters.from_tar(io.BytesIO(pbuf.getvalue()))

    def members(raw):
        with tarfile.open(fileobj=io.BytesIO(raw)) as tar:
            return {m.name: tar.extractfile(m).read()
                    for m in tar.getmembers()}
    assert members(pbuf.getvalue()) == members(jbuf.getvalue())
    for name in jparams.names():
        assert np.array_equal(pparams.get(name), jparams.get(name))
        assert np.array_equal(back.get(name), jparams.get(name))
    # set/get numpy access
    name = pparams.names()[0]
    v = np.zeros_like(pparams.get(name))
    pparams.set(name, v)
    np.testing.assert_array_equal(pparams.get(name), v)
    # the port's own create: the same names, shapes and dtypes
    PORT.fluid.core.program.reset_default_programs()
    own = PORT.v2.parameters.create(_mlp(PORT, dim=16, nclass=4)[0])
    assert sorted(own.names()) == sorted(jparams.names())
    for n in own.names():
        assert own.get(n).shape == jparams.get(n).shape
        assert own.get(n).dtype == jparams.get(n).dtype


def _seq_reader(lo, hi, batch):
    """A maker of 64-sample readers of ragged id sequences; the first of
    each batch is of length hi - 1, so every batch pads to one shape (the
    JAX package compiles a step for each)."""
    def make():
        rng = np.random.RandomState(0)

        def reader():
            for i in range(64):
                T = rng.randint(lo, hi)
                T = hi - 1 if i % batch == 0 else T
                y = i % 2
                toks = rng.randint(0, 25, T) + (25 if y else 0)
                yield toks.astype("int64"), y
        return reader
    return make


def test_v2_sequence_lstm_trains():
    def build(pk):
        paddle = pk.v2
        data = paddle.layer.data(
            name="word", type=paddle.data_type.integer_value_sequence(50))
        label = paddle.layer.data(name="label",
                                  type=paddle.data_type.integer_value(2))
        emb = paddle.layer.embedding(input=data, size=16)
        lstm = paddle.networks.simple_lstm(input=emb, size=16)
        last = paddle.layer.last_seq(input=lstm)
        pred = paddle.layer.fc(input=last, size=2,
                               act=paddle.activation.Softmax())
        return (paddle.layer.classification_cost(input=pred, label=label),)

    res = v2_twins(build, _seq_reader(3, 10, 16), lambda pk: pk.v2.optimizer.Adam(
        learning_rate=0.02), 16, 8)
    assert res.port.costs[-1] < res.port.costs[0] * 0.7
    assert_v2_twins(res)


def test_v2_conv_network():
    def build(pk):
        paddle = pk.v2
        images = paddle.layer.data(
            name="pixel", type=paddle.data_type.dense_vector(1 * 16 * 16),
            height=16, width=16)
        label = paddle.layer.data(name="label",
                                  type=paddle.data_type.integer_value(4))
        conv = paddle.networks.simple_img_conv_pool(
            input=images, filter_size=3, num_filters=4, pool_size=2,
            pool_stride=2, act=paddle.activation.Relu(), conv_padding=1)
        pred = paddle.layer.fc(input=conv, size=4,
                               act=paddle.activation.Softmax())
        return (paddle.layer.classification_cost(input=pred, label=label),)

    rng = np.random.RandomState(0)
    X = rng.rand(32, 256).astype("float32")
    Y = rng.randint(0, 4, 32)

    def make_reader():
        return lambda: ((X[i], int(Y[i])) for i in range(32))

    res = v2_twins(build, make_reader, lambda pk: pk.v2.optimizer.Adam(
        learning_rate=0.02), 16, 8)
    assert res.port.costs[-1] < res.port.costs[0]
    assert_v2_twins(res)


def test_v2_image_utils():
    im = np.arange(3 * 20 * 24, dtype=np.float32).reshape(20, 24, 3)
    for fn, args in (("resize_short", (im, 16)), ("to_chw", (im,)),
                     ("center_crop", (im, 12)),
                     ("left_right_flip", (im,)),
                     ("simple_transform", (im, 16, 12, False)),
                     ("simple_transform", (im, 16, 12, False, True,
                                           [1.0, 2.0, 3.0]))):
        got = getattr(PORT.v2.image, fn)(*args)
        want = getattr(JAX.v2.image, fn)(*args)
        assert got.dtype == want.dtype and np.array_equal(got, want), fn
    got = PORT.v2.image.random_crop(im, 12, rng=np.random.RandomState(3))
    want = JAX.v2.image.random_crop(im, 12, rng=np.random.RandomState(3))
    assert np.array_equal(got, want)
    small = PORT.v2.image.resize_short(im, 16)
    assert min(small.shape[:2]) == 16
    assert PORT.v2.image.center_crop(small, 12).shape[:2] == (12, 12)
    out = PORT.v2.image.simple_transform(im, 16, 12, is_train=False)
    assert out.shape == (3, 12, 12)


def test_v2_master_client_streams_records(tmp_path):
    """The port's v2 master.client over the port's master and over the
    JAX package's (one wire), on record files either package wrote."""
    paths = []
    for i, recordio in enumerate((precordio, jrecordio)):
        p = str(tmp_path / f"part-{i}.recordio")
        with recordio.Writer(p, max_chunk_records=4) as w:
            for j in range(8):
                w.write(f"r{i}-{j}".encode())
        paths.append(p)
    got = []
    for service, server in ((MasterService, MasterServer),
                            (JMasterService, JMasterServer)):
        with server(service(chunks_per_task=1)) as srv:
            c = PORT.v2.master.client(addr=f"{srv.host}:{srv.port}")
            c.set_dataset(paths)
            recs = []
            while True:
                r, err = c.next_record()
                if err:
                    assert (r, err) == (None, -2)
                    break
                recs.append(r)
            c.release()
        got.append(sorted(recs))
    assert len(got[0]) == 16 and len(set(got[0])) == 16
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# the slice's model, the v2 place default, init, the topology
# ---------------------------------------------------------------------------

def _gru_classifier(pk, vocab=50, hid=16):
    """tools/gru_bench.py:47-54 in the v2 DSL (phase 36's model)."""
    paddle = pk.v2
    word = paddle.layer.data(
        name="word", type=paddle.data_type.integer_value_sequence(vocab))
    label = paddle.layer.data(name="label",
                              type=paddle.data_type.integer_value(2))
    emb = paddle.layer.embedding(input=word, size=hid)
    gru = paddle.networks.simple_gru(input=emb, size=hid)
    pooled = paddle.layer.pooling(input=gru,
                                  pooling_type=paddle.pooling.Max())
    pred = paddle.layer.fc(input=pooled, size=2,
                           act=paddle.activation.Softmax())
    return paddle.layer.classification_cost(input=pred, label=label), pred


def test_v2_gru_classifier_twin():
    """The GRU classifier at vocab 50, H 16, Adam, ragged lengths: every
    cost and parameter, then paddle.infer, within 1e-4 of the JAX
    package's from the JAX tar."""
    res = v2_twins(_gru_classifier, _seq_reader(1, 12, 8),
                   lambda pk: pk.v2.optimizer.Adam(learning_rate=1e-2), 8, 3)
    assert res.port.costs[-1] < res.port.costs[0]
    assert_v2_twins(res)
    rng = np.random.RandomState(5)
    samples = [(rng.randint(0, 50, rng.randint(1, 12)),) for _ in range(16)]
    outs = [pk.v2.infer(output_layer=built[1], parameters=params,
                        input=samples, **kw)
            for pk, built, params, kw in (
                (JAX, res.jbuilt, res.jparams, {}),
                (PORT, res.pbuilt, res.pparams, {"place": CPU}))]
    assert outs[1].shape == (16, 2)
    assert_close(outs[1], outs[0], what="infer")


def test_v2_entry_points_default_to_the_card(monkeypatch):
    cost, pred = _gru_classifier(PORT)
    params = PORT.v2.parameters.create(cost)   # runs on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PORT.v2.trainer.SGD(cost=cost, parameters=params,
                            update_equation=PORT.v2.optimizer.Adam())
    with pytest.raises(RuntimeError, match="CUDA"):
        PORT.v2.infer(output_layer=pred, parameters=params,
                      input=[(np.arange(3),)])
    out = PORT.v2.infer(output_layer=pred, parameters=params,
                        input=[(np.arange(3),)], place=CPU)
    assert out.shape == (1, 2)


def test_v2_init_seeds_only():
    for pk in (JAX, PORT):
        pk.v2.init(use_gpu=True, trainer_count=1, seed=7)
        assert pk.fluid.default_main_program().random_seed == 7
        assert pk.fluid.default_startup_program().random_seed == 7


def test_v2_topology_data_types_and_proto():
    got = {}
    for pk in (JAX, PORT):
        fresh()
        topo = pk.v2.topology.Topology(_gru_classifier(pk)[0])
        got[pk.name] = ([(n, t.dim, t.seq_type, t.type, t.dtype)
                         for n, t in topo.data_type()], topo.proto())
    assert got["port"] == got["jax"]


# ---------------------------------------------------------------------------
# tests/test_pydataprovider2.py: each provider declared in both packages
# ---------------------------------------------------------------------------

def _both(make):
    return make(jdp2), make(pdp2)


def test_provider_decorator_yields_and_types():
    def make(dp2):
        @dp2.provider(input_types=[dp2.dense_vector(4),
                                   dp2.integer_value(3)],
                      should_shuffle=False)
        def process(settings, filename):
            assert settings.input_types[0].dim == 4
            for i in range(5):
                yield np.full((4,), i, np.float32), i % 3
        return process

    jproc, pproc = _both(make)
    samples = list(pproc())
    assert len(samples) == 5 and samples[0][0].shape == (4,)
    for (a, b), (c, d) in zip(samples, jproc()):
        assert np.array_equal(a, c) and b == d
    t = pproc.input_types[1]
    assert (t.type == pdp2.DataType.Index
            and t.seq_type == pdp2.SequenceType.NO_SEQUENCE)
    assert pproc.__name__ == "process"


def test_provider_dict_protocol_and_eval_determinism():
    def make(dp2):
        @dp2.provider(input_types={"img": dp2.dense_vector(2),
                                   "lbl": dp2.integer_value(5)}, check=True)
        def process(settings, filename):
            for i in range(4):
                yield {"lbl": i % 5, "img": np.full((2,), i, np.float32)}
        return process

    jproc, pproc = _both(make)
    reader = pdp2.provider_to_reader(pproc, is_train=False)
    a, b = list(reader()), list(reader())
    want = list(jdp2.provider_to_reader(jproc, is_train=False)())
    assert len(a) == 4
    assert a[0][0].shape == (2,) and a[0][1] == 0
    for sa, sb, sw in zip(a, b, want):
        for x, y, z in zip(sa, sb, sw):
            assert np.array_equal(x, y) and np.array_equal(x, z)
    # a declared-range violation raises in both
    bad = {}
    for dp2 in (jdp2, pdp2):
        @dp2.provider(input_types=[dp2.integer_value(3)], check=True)
        def oob(settings, filename):
            yield [7]
        with pytest.raises(ValueError, match="out of range"):
            list(oob())
        bad[dp2] = True
    assert len(bad) == 2


def test_provider_init_hook_and_file_list():
    def make(dp2):
        @dp2.provider(input_types=[dp2.integer_value_sequence(10)],
                      should_shuffle=False, init_hook=lambda s, file_list,
                      **kw: setattr(s, "offset", len(file_list)))
        def process(settings, filename):
            yield [settings.offset, int(filename)]
        return process

    jproc, pproc = _both(make)
    got = list(pproc(file_list=["7", "8"]))
    assert got == [[2, 7], [2, 8]] == list(jproc(file_list=["7", "8"]))


def test_provider_cache_pass_in_mem():
    calls = {jdp2: [], pdp2: []}

    def make(dp2):
        @dp2.provider(input_types=[dp2.dense_vector(1)],
                      should_shuffle=False,
                      cache=dp2.CacheType.CACHE_PASS_IN_MEM)
        def process(settings, filename):
            calls[dp2].append(filename)
            for i in range(3):
                yield [float(i)]
        return process

    for dp2, proc in zip((jdp2, pdp2), _both(make)):
        assert len(list(proc())) == 3
        assert len(list(proc())) == 3
        assert len(calls[dp2]) == 1       # second pass served from cache


def test_provider_trains_through_reader_pipeline():
    """A @provider feeding fluid training in both packages: every loss of
    15 epochs within 1e-4, from the JAX startup's state."""
    rng = np.random.RandomState(0)
    w_true = rng.rand(4, 1).astype(np.float32)

    def make(dp2):
        @dp2.provider(input_types=[dp2.dense_vector(4),
                                   dp2.dense_vector(1)],
                      should_shuffle=False)
        def process(settings, filename):
            r = np.random.RandomState(int(filename))
            for _ in range(64):
                x = r.rand(4).astype(np.float32)
                yield x, (x @ w_true).astype(np.float32)
        return process

    losses = {}
    for pk, dp2, proc in zip((JAX, PORT), (jdp2, pdp2), _both(make)):
        creator = dp2.provider_to_reader(proc, file_list=["0"])
        layers = pk.layers
        x = layers.data(name="x", shape=[4], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        pred = layers.fc(input=x, size=1)
        loss = layers.mean(layers.square_error_cost(input=pred, label=y))
        pk.fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        exe = pk.fluid.Executor(pk.place)
        exe.run(pk.fluid.default_startup_program())
        if pk is JAX:
            state = jax_state()
        else:
            load_into_port(state)
        got = []
        for _ in range(15):
            batch = []
            for sample in creator():
                batch.append(sample)
                if len(batch) == 16:
                    (l,) = exe.run(pk.fluid.default_main_program(),
                                   feed={"x": np.stack([b[0] for b in batch]),
                                         "y": np.stack([b[1] for b in batch])},
                                   fetch_list=[loss])
                    got.append(float(l))
                    batch = []
        losses[pk.name] = got
    same_program()
    assert losses["port"][-1] < losses["port"][0] * 0.1
    assert_close(losses["port"], losses["jax"], what="losses")


def _plot_without_and_with_matplotlib(tmp_path, monkeypatch, capsys):
    texts = []
    # the original sys.modules entry (submodules included) is back
    # before the second half
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "matplotlib", None)
        for pk in (JAX, PORT):
            plot = pk.v2.plot.Ploter("train", "test")
            for step in range(3):
                plot.append("train", step, 1.0 / (step + 1))
            plot.append("test", 2, 0.25)
            capsys.readouterr()
            plot.plot()
            texts.append(capsys.readouterr().out)
            plot.reset()
    assert texts[1] == texts[0]
    assert "[plot] train: step=2 value=0.3333333333333333" in texts[1]
    if importlib.util.find_spec("matplotlib") is not None:
        plot = PORT.v2.plot.Ploter("train")
        plot.append("train", 0, 1.0)
        plot.plot(str(tmp_path / "cost.png"))
        assert (tmp_path / "cost.png").stat().st_size > 0


def test_v2_plot_without_and_with_matplotlib(tmp_path, monkeypatch, capsys):
    """Ploter's lazy matplotlib import: without it (the card machine has
    none) plot() prints each series' last point, as the JAX Ploter does;
    with it, plot(path) writes the figure."""
    _plot_without_and_with_matplotlib(tmp_path, monkeypatch, capsys)


def test_v2_plot_after_pyplot_was_imported(tmp_path, monkeypatch, capsys):
    """The same with ``matplotlib.pyplot`` imported by an earlier test in
    the process: hiding matplotlib must not leave its submodules behind
    a second copy of the package."""
    if importlib.util.find_spec("matplotlib") is not None:
        importlib.import_module("matplotlib.pyplot")
    _plot_without_and_with_matplotlib(tmp_path, monkeypatch, capsys)
