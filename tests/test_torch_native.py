"""The port's native C++ runtime against the JAX package's, on the CPU.

The port builds its own copy of the C++ (``paddle_tpu_torch/native/``)
with g++ into ``build/native``; the JAX package builds ``native/`` with
make.  Files written by either C++ writer are byte-identical and read by
either package's scanners; the loaders give the same records; the queue
and the pool behave alike; the C++ CPU runner and the C API run the
models of tests/test_infer_native.py from a model the port saved,
bitwise the JAX runner on the JAX-saved model with the same weights
(the same C++ on the same artifacts), and within 1e-4 of the port's CPU
`serving.Predictor` (at full lengths: the Predictor serves dense
batches).  A failed build raises; nothing falls back to
Python.
"""
import os
import pickle
import shutil

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import io as jio
from paddle_tpu import layers as jlayers
from paddle_tpu import native as jnative
from paddle_tpu import recordio as jrecordio
import paddle_tpu_torch as fluid
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import layers
from paddle_tpu_torch import native, recordio
from paddle_tpu_torch.reader import creator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the port's CPU Predictor against the C++ runner
PREDICTOR_TOL = 1e-4


@pytest.fixture(autouse=True)
def _fresh():
    jfluid.core.program.reset_default_programs()
    fluid.core.program.reset_default_programs()
    jfluid.global_scope().clear()
    fluid.core.scope._global_scope = fluid.core.scope.Scope()
    yield


def _records(n):
    return [f"record-{i}".encode() * (i % 7 + 1) for i in range(n)]


def test_sources_are_the_jax_packages_byte_for_byte():
    for name in sorted(os.listdir(native.SRC_DIR)):
        ours = (native.SRC_DIR / name).read_bytes()
        with open(os.path.join(REPO, "native", name), "rb") as f:
            assert ours == f.read(), name


def test_library_builds_under_build_native():
    lib = native.load_library()
    assert lib is native.load_library()
    path = native._lib_path()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert native.available()


# ---------------------------------------------------------------------------
# recordio
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compressor,chunk", [(2, 16), (2, 1000), (0, 7)])
def test_writer_bytes_equal_the_jax_writers(tmp_path, compressor, chunk):
    recs = _records(101)
    paths = []
    for pk, tag in ((native, "port"), (jnative, "jax")):
        p = str(tmp_path / f"{tag}.recordio")
        with pk.NativeWriter(p, compressor=compressor,
                             max_chunk_records=chunk) as w:
            for r in recs:
                w.write(r)
        paths.append(p)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    for scan in (recordio.Scanner, jrecordio.Scanner, native.NativeScanner,
                 jnative.NativeScanner):
        assert list(scan(paths[0])) == recs
    assert native.native_num_chunks(paths[0]) == -(-101 // chunk) \
        == recordio.num_chunks(paths[1])


def test_python_writers_files_read_by_the_cpp_scanner(tmp_path):
    recs = _records(50)
    for i, writer in enumerate((recordio.Writer, jrecordio.Writer)):
        p = str(tmp_path / f"py{i}.recordio")
        with writer(p, max_chunk_records=16) as w:
            for r in recs:
                w.write(r)
        assert list(native.NativeScanner(p)) == recs
        assert native.native_num_chunks(p) == 4


def test_range_reads(tmp_path):
    path = str(tmp_path / "r.recordio")
    with recordio.writer(path, max_chunk_records=10) as w:
        for i in range(100):
            w.write(str(i).encode())
    assert [int(r) for r in native.NativeScanner(path, 2, 5)] == \
        list(range(20, 50))
    assert [int(r) for r in recordio.scanner(path, 8)] == \
        list(range(80, 100))
    assert [int(r) for r in recordio.scanner(path, 3, 4)] == \
        [int(r) for r in jnative.NativeScanner(path, 3, 4)]


def test_corruption_raises(tmp_path):
    path = str(tmp_path / "c.recordio")
    with recordio.writer(path) as w:
        for r in _records(20):
            w.write(r)
    blob = bytearray(open(path, "rb").read())
    blob[30] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with pytest.raises(IOError):
        list(recordio.scanner(path))
    with pytest.raises(IOError, match="cannot open"):
        native.native_num_chunks(str(tmp_path / "missing"))


def test_front_end_returns_the_cpp_classes(tmp_path):
    p = str(tmp_path / "fe.recordio")
    w = recordio.writer(p)
    assert isinstance(w, native.NativeWriter)
    for i in range(5):
        w.write(str(i).encode())
    w.close()
    s = recordio.scanner(p)
    assert isinstance(s, native.NativeScanner)
    assert [int(r) for r in s] == list(range(5))


# ---------------------------------------------------------------------------
# the loader, the queue, the pool
# ---------------------------------------------------------------------------

def _shards(tmp_path, files=5, n=40):
    paths = []
    for f in range(files):
        p = str(tmp_path / f"part-{f}.recordio")
        with recordio.writer(p, max_chunk_records=8) as w:
            for i in range(n):
                w.write(f"f{f}-r{i}".encode())
        paths.append(p)
    return paths


@pytest.mark.parametrize("threads", [1, 4])
def test_file_loader_matches_the_jax_loader(tmp_path, threads):
    paths = _shards(tmp_path)
    loader = native.FileLoader(paths, num_threads=threads,
                               queue_capacity=16)
    got = list(loader)
    loader.close()
    jl = jnative.FileLoader(paths, num_threads=threads, queue_capacity=16)
    want = list(jl)
    jl.close()
    assert sorted(got) == sorted(want)
    for f in range(len(paths)):
        mine = [r for r in got if r.startswith(f"f{f}-".encode())]
        assert mine == [f"f{f}-r{i}".encode() for i in range(40)]
    if threads == 1:
        assert got == want == list(creator.recordio(paths)())


def test_convert_then_recordio_threaded_gives_every_sample(tmp_path):
    from paddle_tpu_torch.dataset import common
    samples = [(np.arange(i, i + 3, dtype=np.float32), i) for i in range(57)]
    n = common.convert(str(tmp_path), lambda: iter(samples), 10, "tr")
    assert n == 6
    paths = sorted(str(p) for p in tmp_path.iterdir())
    got = [pickle.loads(r)
           for r in creator.recordio_threaded(paths, num_threads=4)()]
    assert sorted(s[1] for s in got) == list(range(57))
    for arr, i in got:
        np.testing.assert_array_equal(arr, samples[i][0])


def test_loader_error_raises(tmp_path):
    with pytest.raises(IOError, match="cannot open"):
        list(native.FileLoader([str(tmp_path / "missing")]))


def test_blocking_queue():
    for pk in (native, jnative):
        q = pk.BlockingQueue(capacity=4)
        assert q.push(b"one") and q.push(b"two")
        assert len(q) == 2
        assert q.pop() == b"one"
        assert len(q) == 1
        assert q.pop() == b"two"
        q.close()
        assert q.pop() is None
        assert not q.push(b"late")


def _pool_script(pk):
    pool = pk.MemoryPool(capacity=1 << 16, min_block=256)
    trace = []
    live = []
    for n in (1000, 100, 5000, 256, 257, 30000, 1, 4096):
        p = pool.alloc(n)
        trace.append(("alloc", n, p is not None, pool.used, pool.peak))
        if p:
            live.append(p)
    for p in live[::2]:
        pool.free(p)
        trace.append(("free", pool.used, pool.peak))
    trace.append(("big", pool.alloc(1 << 17) is None, pool.capacity))
    with pytest.raises(ValueError):
        pool.free(live[1] + 8)
    return trace


def test_memory_pool_matches_the_jax_pool():
    assert _pool_script(native) == _pool_script(jnative)


# ---------------------------------------------------------------------------
# the C++ CPU runner and the C API
# ---------------------------------------------------------------------------

def _lenet(fl, L):
    img = L.data(name="img", shape=[1, 28, 28], dtype="float32")
    c1 = L.conv2d(img, num_filters=6, filter_size=5, act="relu")
    p1 = L.pool2d(c1, pool_size=2, pool_stride=2)
    c2 = L.conv2d(p1, num_filters=16, filter_size=5, act="relu")
    p2 = L.pool2d(c2, pool_size=2, pool_stride=2)
    predict = L.fc(input=p2, size=10, act="softmax")
    feed = {"img": np.random.RandomState(0).rand(4, 1, 28, 28)
            .astype(np.float32)}
    return feed, [predict], ["img"]


def _bn_elementwise(fl, L):
    img = L.data(name="img", shape=[3, 16, 16], dtype="float32")
    c1 = L.conv2d(img, num_filters=8, filter_size=3, padding=1)
    b1 = L.batch_norm(c1, act="relu")
    c2 = L.conv2d(b1, num_filters=8, filter_size=3, padding=1)
    b2 = L.batch_norm(c2)
    proj = L.conv2d(img, num_filters=8, filter_size=1)
    out = L.elementwise_add(b2, proj, act="relu")
    pooled = L.pool2d(out, global_pooling=True, pool_type="avg")
    predict = L.fc(input=pooled, size=5, act="softmax")
    feed = {"img": np.random.RandomState(1).rand(2, 3, 16, 16)
            .astype(np.float32)}
    return feed, [predict], ["img"]


def _embedding_mlp(fl, L):
    words = L.data(name="words", shape=[4], dtype="int64")
    emb = L.embedding(input=words, size=[50, 16])
    h = L.fc(input=L.reshape(emb, shape=[-1, 64]), size=32, act="tanh")
    predict = L.fc(input=h, size=50, act="softmax")
    feed = {"words": np.random.RandomState(2).randint(0, 50, (3, 4))
            .astype(np.int64)}
    return feed, [predict], ["words"]


def _stacked_lstm(fl, L):
    data = L.data(name="words", shape=[1], dtype="int64", lod_level=1)
    emb = L.embedding(input=data, size=[50, 12])
    proj = L.fc(input=emb, size=32, num_flatten_dims=2, bias_attr=False)
    h, _ = L.dynamic_lstm(input=proj, size=32, use_peepholes=False)
    last = L.sequence_pool(h, "last")
    pred = L.fc(input=last, size=2, act="softmax")
    rng = np.random.RandomState(1)
    feed = {"words": rng.randint(0, 50, (4, 9)).astype(np.int64),
            "words@SEQ_LEN": np.array([9, 7, 4, 2], np.int32)}
    return feed, [pred], ["words"]


MODELS = {"lenet": _lenet, "bn_elementwise": _bn_elementwise,
          "embedding_mlp": _embedding_mlp, "stacked_lstm": _stacked_lstm}


def _saved_pair(tmp_path, build):
    """The model saved by the JAX package from its startup and by the
    port from the same weights -> (jax dir, port dir, feed)."""
    feed, jtargets, names = build(jfluid, jlayers)
    jmain = jfluid.default_main_program()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jio.save_inference_model(jdir, names, jtargets, jexe)
    jio.save_persistables(jexe, str(tmp_path / "state"), jmain)
    _, targets, _ = build(fluid, layers)
    main = fluid.default_main_program()
    assert main.to_dict() == jmain.to_dict()
    exe = fluid.Executor(fluid.CPUPlace())
    pio.load_persistables(exe, str(tmp_path / "state"), main)
    pio.save_inference_model(pdir, names, targets, exe)
    return jdir, pdir, feed


@pytest.mark.parametrize("runner", ["cpu_predictor", "capi"])
@pytest.mark.parametrize("model", list(MODELS))
def test_cpp_runner_on_a_port_saved_model(tmp_path, model, runner):
    from paddle_tpu_torch.serving import Predictor
    jdir, pdir, feed = _saved_pair(tmp_path, MODELS[model])
    want = jnative.CpuPredictor(jdir).run(feed)
    if runner == "capi":
        got = native.capi_run(pdir, feed)
    else:
        pred = native.CpuPredictor(pdir)
        assert pred.feed_names == jnative.CpuPredictor(jdir).feed_names
        got = pred.run(feed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    # the Predictor serves dense batches (it reads no @SEQ_LEN, as the
    # JAX Predictor does not): it is held at full lengths
    dense = {k: (np.full_like(v, feed[k[:-len("@SEQ_LEN")]].shape[1])
                 if k.endswith("@SEQ_LEN") else v) for k, v in feed.items()}
    if any(k.endswith("@SEQ_LEN") for k in feed):
        got = native.CpuPredictor(pdir).run(dense)
    ours = Predictor.from_model_dir(pdir, device="cpu").run(dense)
    for g, o in zip(got, ours):
        np.testing.assert_allclose(g, o, atol=PREDICTOR_TOL, rtol=0)


def test_cpp_runner_error_path(tmp_path):
    with pytest.raises(IOError, match="__model__"):
        native.CpuPredictor(str(tmp_path / "nonexistent"))
    with pytest.raises(IOError, match="__model__"):
        native.capi_run(str(tmp_path / "nonexistent"), {})


def test_capi_missing_feed_errors(tmp_path):
    _, pdir, _ = _saved_pair(tmp_path, _embedding_mlp)
    with pytest.raises(RuntimeError):
        native.capi_run(pdir, {})


# ---------------------------------------------------------------------------
# PJRT and the build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda: native.load_pjrt_library(),
    lambda: native.pjrt_plugin_candidates(),
    lambda: native.default_pjrt_plugin(),
    lambda: native.PjrtPredictor("any")],
    ids=["load_pjrt_library", "pjrt_plugin_candidates",
         "default_pjrt_plugin", "PjrtPredictor"])
def test_pjrt_names_raise(call):
    with pytest.raises(RuntimeError,
                       match="ROADMAP queue C: XLA-only options"):
        call()


def test_missing_compiler_raises_and_nothing_falls_back(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.load_library()
    assert not native.available()
    with pytest.raises(RuntimeError, match="native build failed"):
        recordio.writer(str(tmp_path / "x.recordio"))
    with pytest.raises(RuntimeError, match="native build failed"):
        list(recordio.scanner(str(tmp_path / "x.recordio")))
    with pytest.raises(RuntimeError, match="native build failed"):
        list(creator.recordio_threaded([str(tmp_path / "x.recordio")])())
    assert not any(p.suffix == ".so" for p in (tmp_path / "b").iterdir())


def test_compile_error_raises_with_the_compilers_output(tmp_path,
                                                        monkeypatch):
    src = tmp_path / "src"
    shutil.copytree(native.SRC_DIR, src)
    (src / "memory_pool.cc").write_text("int broken(  {\n")
    monkeypatch.setattr(native, "SRC_DIR", src)
    monkeypatch.setattr(native, "SOURCES", ("memory_pool.cc",))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="memory_pool.cc.*error"):
        native.load_library()
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == []
