"""The reader ops (``layers/io.py``), recordio (``recordio.py``,
``recordio_writer.py``, the creators of ``reader/creator.py``) and the
executor's binding of them in the port, on the CPU.

- Twins of tests/test_reader_pipeline.py's three tests.
- A twin of tests/test_fused_dispatch.py::test_fused_reader_op_program:
  ``train_loop(feed=None)`` in windows of 2 against the per-step
  ``exe.run`` reader loop, losses and parameters bitwise, and a resume
  from a checkpoint in the middle of the pass with bitwise losses; the
  per-step losses also against the JAX package's reader loop from the
  same startup state (1e-6).
- Recordio files and serialized samples written by one package and read
  by the other, both ways, byte for byte; the recordio creators of both
  over the same shards.
- ``shuffle`` after ``random.seed`` gives the JAX package's batches.
- ``double_buffer(place=CPUPlace())`` stages tensors, surfaces a source
  error, and its producer thread ends when the consumer abandons the
  pass; ``ListenAndServ``/``Send`` build the JAX package's op pair.
"""
import os
import random
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import io as jio
from paddle_tpu import layers as jlayers
from paddle_tpu import recordio as jrecordio
from paddle_tpu import recordio_writer as jwriter
from paddle_tpu.reader import creator as jcreator
import paddle_tpu_torch as fluid
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import layers
from paddle_tpu_torch import recordio, recordio_writer
from paddle_tpu_torch.reader import creator


@pytest.fixture(autouse=True)
def _fresh_programs():
    fluid.core.program.reset_default_programs()
    fluid.core.scope._global_scope = fluid.core.scope.Scope()
    jfluid.core.program.reset_default_programs()
    jfluid.global_scope().clear()
    yield


def _write_dataset(path, n=64, writer=recordio_writer):
    rng = np.random.RandomState(0)
    w = rng.rand(4, 1).astype(np.float32)

    def samples():
        for _ in range(n):
            x = rng.rand(4).astype(np.float32)
            yield (x, (x @ w).astype(np.float32))

    assert writer.convert_reader_to_recordio_file(path, samples) == n
    return w


# ---------------------------------------------------------------------------
# twins of tests/test_reader_pipeline.py
# ---------------------------------------------------------------------------

def test_serialize_roundtrip():
    s = (np.arange(6, dtype=np.float32).reshape(2, 3),
         np.array([7], np.int64), np.float32(3.5))
    back = recordio_writer.deserialize_sample(
        recordio_writer.serialize_sample(s))
    assert len(back) == 3
    np.testing.assert_array_equal(back[0], s[0])
    np.testing.assert_array_equal(back[1], s[1])
    assert back[2] == np.float32(3.5)


def test_reader_pipeline_trains_and_eofs(tmp_path):
    path = str(tmp_path / "train.recordio")
    _write_dataset(path, n=64)
    reader = layers.open_recordio_file(
        path, shapes=[[-1, 4], [-1, 1]], dtypes=["float32", "float32"])
    reader = layers.shuffle(reader, buffer_size=32)
    reader = layers.batch(reader, batch_size=16)
    reader = layers.double_buffer(reader, place=fluid.CPUPlace())
    x, y = layers.read_file(reader)
    pred = layers.fc(input=x, size=1)
    loss = layers.mean(layers.square_error_cost(input=pred, label=y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    losses = []
    for _ in range(20):
        reader.reset()
        while True:
            try:
                (l,) = exe.run(fluid.default_main_program(),
                               fetch_list=[loss])
            except layers.EOFException:
                break
            losses.append(float(l))
    assert len(losses) == 20 * 4
    assert losses[-1] < losses[0] * 0.1
    assert fluid.core.EOFException is layers.EOFException


def test_sharded_files_and_open_files(tmp_path):
    def samples():
        for i in range(30):
            yield (np.full((2,), i, np.float32),)

    paths = recordio_writer.convert_reader_to_recordio_files(
        str(tmp_path / "shard"), 10, samples)
    assert len(paths) == 3
    reader = layers.batch(
        layers.open_files(paths, shapes=[[-1, 2]], dtypes=["float32"]), 5)
    reader.var_names = ["x"]
    vals = []
    while True:
        try:
            vals.append(reader.next_feed()["x"])
        except layers.EOFException:
            break
    assert len(vals) == 6
    np.testing.assert_allclose(np.concatenate(vals)[:, 0], np.arange(30))


# ---------------------------------------------------------------------------
# train_loop(feed=None)
# ---------------------------------------------------------------------------

def _reader_program(path, L=layers, f=fluid):
    """The regression of test_fused_reader_op_program in ``f``'s fresh
    default programs, fed by a bound reader of batch 8 -> (reader,
    loss)."""
    f.core.program.reset_default_programs()
    reader = L.open_recordio_file(path, shapes=[[-1, 4], [-1, 1]],
                                  dtypes=["float32", "float32"])
    reader = L.batch(reader, batch_size=8)
    x, y = L.read_file(reader)
    pred = L.fc(input=x, size=1)
    loss = L.mean(L.square_error_cost(input=pred, label=y))
    f.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return reader, loss


def _start(tmp_path):
    """A fresh scope and executor on the state in ``tmp_path/start``."""
    fluid.core.scope._global_scope = fluid.core.scope.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    pio.load_persistables(exe, str(tmp_path / "start"),
                          fluid.default_main_program())
    return exe


def _params():
    scope = fluid.global_scope()
    return {n: scope.get(n).numpy().copy() for n in scope.local_var_names()}


def test_train_loop_reader_op_program(tmp_path):
    """train_loop(feed=None, steps_per_launch=2) takes the bound reader:
    2 windows for the pass of 4 batches, losses and parameters bitwise
    the per-step loop's, which also meets EOFException at the pass end;
    the per-step losses agree with the JAX package's reader loop."""
    path = str(tmp_path / "t.recordio")
    _write_dataset(path, n=32)
    _, jloss = _reader_program(path, jlayers, jfluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    jio.save_persistables(jexe, str(tmp_path / "start"),
                          jfluid.default_main_program())
    jref = []
    while True:
        try:
            jref.append(float(jexe.run(fetch_list=[jloss])[0]))
        except jlayers.EOFException:
            break

    _reader_program(path)
    loss = fluid.default_main_program().global_block().var(jloss.name)
    exe = _start(tmp_path)
    ref = []
    while True:
        try:
            ref.append(exe.run(fetch_list=[loss])[0])
        except layers.EOFException:
            break
    ref_params = _params()
    assert len(ref) == 4
    np.testing.assert_allclose(np.float64(ref), jref, rtol=1e-6)

    _reader_program(path)
    exe = _start(tmp_path)
    base = exe.launches
    handles = exe.train_loop(fetch_list=[loss], steps_per_launch=2)
    assert exe.launches - base == 2
    assert len(handles) == 4
    for a, h in zip(ref, handles):
        assert np.array_equal(np.asarray(a), h.get()[0])
    for n, v in _params().items():
        assert np.array_equal(ref_params[n], v), n


def test_train_loop_reader_op_resumes_mid_pass(tmp_path):
    """A checkpoint after 2 of the pass's 4 steps, then a fresh build
    resumed from it: steps 3 and 4 read batches 3 and 4, with losses
    bitwise the uninterrupted pass's."""
    path = str(tmp_path / "t.recordio")
    _write_dataset(path, n=32)
    _, loss = _reader_program(path)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    pio.save_persistables(exe, str(tmp_path / "start"),
                          fluid.default_main_program())
    full = [h.get()[0] for h in exe.train_loop(fetch_list=[loss])]
    assert len(full) == 4

    _reader_program(path)
    exe = _start(tmp_path)
    ckpt = str(tmp_path / "ckpt")
    first = exe.train_loop(fetch_list=[loss], steps=3, checkpoint_dir=ckpt,
                           checkpoint_every=2)
    assert [h.step for h in first] == [0, 1, 2]

    _reader_program(path)
    exe = fluid.Executor(fluid.CPUPlace())
    fluid.core.scope._global_scope = fluid.core.scope.Scope()
    rest = exe.train_loop(fetch_list=[loss], resume_from=ckpt)
    assert [h.step for h in rest] == [2, 3]
    for h, want in zip(rest, full[2:]):
        assert np.array_equal(h.get()[0], want)


# ---------------------------------------------------------------------------
# recordio across the packages
# ---------------------------------------------------------------------------

def _samples(n=40):
    rng = np.random.RandomState(3)
    dts = [np.float32, np.float64, np.int32, np.int64, np.uint8, np.bool_,
           np.float16, np.int8, np.int16, np.uint16, np.uint32, np.uint64]
    for i in range(n):
        dt = dts[i % len(dts)]
        shape = [(3,), (2, 2), (), (1, 4, 2)][i % 4]
        yield (rng.randint(0, 5, shape).astype(dt),
               np.float32(rng.rand()), np.arange(i % 5, dtype=np.int64))


def _records(scanner_cls, path, *chunks):
    return list(scanner_cls(path, *chunks))


@pytest.mark.parametrize("direction", ["port writes", "jax writes"])
def test_recordio_files_cross_packages(tmp_path, direction):
    """Files of 40 samples in chunks of 7 records: the same bytes from
    either writer; each package's scanner reads the other's file, whole
    and by chunk range; the samples deserialize to the originals."""
    mine, theirs = ((recordio_writer, jwriter) if direction == "port writes"
                    else (jwriter, recordio_writer))
    path, twin = str(tmp_path / "a.recordio"), str(tmp_path / "b.recordio")
    assert mine.convert_reader_to_recordio_file(
        path, lambda: _samples(), max_num_records=7) == 40
    theirs.convert_reader_to_recordio_file(twin, lambda: _samples(),
                                           max_num_records=7)
    with open(path, "rb") as f, open(twin, "rb") as g:
        assert f.read() == g.read()
    assert recordio.num_chunks(path) == jrecordio.num_chunks(path) == 6
    for chunks in ((), (1, 3)):
        got = _records(recordio.Scanner, path, *chunks)
        want = _records(jrecordio.Scanner, path, *chunks)
        assert got == want and len(got) == (40 if not chunks else 14)
    for rec, sample in zip(_records(recordio.scanner, path), _samples()):
        for a, b in zip(theirs.deserialize_sample(rec), sample):
            assert a.dtype == np.asarray(b).dtype
            assert a.tobytes() == np.asarray(b).tobytes()
    for s in _samples(12):
        assert (recordio_writer.serialize_sample(s)
                == jwriter.serialize_sample(s))


def test_recordio_uncompressed_and_bad_files(tmp_path):
    """A NO_COMPRESS file reads in both packages; a flipped payload byte
    is a CRC error and a bad magic an IOError in the port."""
    path = str(tmp_path / "raw.recordio")
    with recordio.writer(path, max_chunk_records=3,
                         compressor=recordio.NO_COMPRESS) as w:
        for i in range(8):
            w.write(f"record {i}")
    want = [f"record {i}".encode() for i in range(8)]
    assert list(recordio.Scanner(path)) == list(
        jrecordio.Scanner(path)) == want
    data = bytearray(open(path, "rb").read())
    data[25] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(IOError, match="CRC"):
        list(recordio.Scanner(path))
    data[0] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(IOError, match="magic"):
        list(recordio.Scanner(path))


def test_recordio_creators_cross_packages(tmp_path):
    """reader.creator.recordio and recordio_threaded over shards of the
    other package: the JAX records, in order (both packages' C++
    threaded loaders as a multiset: their threads interleave files; in
    order with one thread)."""
    paths = jwriter.convert_reader_to_recordio_files(
        str(tmp_path / "s"), 15, lambda: _samples())
    want = list(jcreator.recordio(paths)())
    assert list(creator.recordio(paths)()) == want
    assert list(creator.recordio(",".join(paths))()) == want
    threaded = list(creator.recordio_threaded(paths)())
    assert sorted(threaded) == sorted(want)
    assert list(creator.recordio_threaded(paths, num_threads=1)()) == want
    assert sorted(threaded) == sorted(jcreator.recordio_threaded(paths)())


def test_shuffle_batches_match_jax(tmp_path):
    """open_recordio_file -> shuffle -> batch -> double_buffer(CPU) ->
    read_file in both packages, Python's ``random`` seeded alike before
    each pass: the same batches, bitwise, over two passes."""
    path = str(tmp_path / "t.recordio")
    _write_dataset(path, n=40)
    got = []
    for L, f, exe_pkg in ((jlayers, jfluid, jfluid), (layers, fluid, fluid)):
        f.core.program.reset_default_programs()
        r = L.open_recordio_file(path, shapes=[[-1, 4], [-1, 1]],
                                 dtypes=["float32", "float32"])
        r = L.double_buffer(L.batch(L.shuffle(r, buffer_size=16), 8),
                            place=exe_pkg.CPUPlace())
        L.read_file(r)
        batches = []
        for seed in (7, 8):
            random.seed(seed)
            r.reset()
            while True:
                try:
                    feed = r.next_feed()
                except L.EOFException:
                    break
                batches.append([np.asarray(v) for v in feed.values()])
        got.append(batches)
    assert len(got[1]) == len(got[0]) == 10
    for p, j in zip(*got[::-1]):
        for a, b in zip(p, j):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# double_buffer
# ---------------------------------------------------------------------------

def _producers():
    return [t for t in threading.enumerate()
            if t.name == layers.io.DOUBLE_BUFFER_THREAD and t.is_alive()]


def _batches(n, fields=2):
    return layers.Reader(lambda: iter(
        [tuple(np.full((2, 3), i + k, np.float32) for k in range(fields))
         for i in range(n)]))


def test_double_buffer_stages_on_the_place():
    """Each batch comes back as tensors on the place's device, in order,
    and the pass ends without a thread left behind."""
    r = layers.double_buffer(_batches(5), place=fluid.CPUPlace(),
                             capacity=2)
    out = list(r._make_iter())
    assert len(out) == 5
    for i, (a, b) in enumerate(out):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert float(a[0, 0]) == i and float(b[0, 0]) == i + 1
    _wait_for_no_producer()


def _wait_for_no_producer(timeout=5.0):
    deadline = time.monotonic() + timeout
    while _producers() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not _producers()


def test_double_buffer_abandoned_pass_stops_its_producer():
    """A consumer that takes one batch of a long pass and drops the
    generator: the producer, blocked on the full queue, sees the stop
    event and ends."""
    _wait_for_no_producer()
    gen = iter(layers.double_buffer(_batches(1000), place=fluid.CPUPlace(),
                                    capacity=2)._make_iter())
    next(gen)
    time.sleep(0.2)                 # the producer fills the queue and waits
    assert len(_producers()) == 1
    gen.close()
    _wait_for_no_producer()


def test_double_buffer_surfaces_a_source_error():
    def broken():
        yield (np.zeros((2, 3), np.float32),)
        raise ValueError("bad record")

    gen = iter(layers.double_buffer(layers.Reader(broken),
                                    place=fluid.CPUPlace())._make_iter())
    next(gen)
    with pytest.raises(ValueError, match="bad record"):
        next(gen)
    _wait_for_no_producer()


def _pserver_pair(fl, ly):
    """A ListenAndServ program and a Send program built by one front end
    -> their JSON."""
    import json
    server = fl.Program()
    with fl.program_guard(server):
        acc = server.global_block().create_var(name="Acc", shape=(1,),
                                               dtype="float32")
        ly.fill_constant(shape=[1], dtype="float32", value=0.0, out=acc)
        serv = ly.ListenAndServ("127.0.0.1:0", ["X"], fan_in=2)
        with serv.do():
            x = ly.data(name="X", shape=[1], dtype="float32",
                        append_batch_size=False)
            ly.assign(ly.elementwise_add(acc, x), output=acc)
    trainer = fl.Program()
    with fl.program_guard(trainer):
        x = ly.data(name="X", shape=[32, 32], dtype="float32",
                    append_batch_size=False)
        out = trainer.global_block().create_var(name="Out", shape=(32, 32),
                                                dtype="float32")
        ly.Send("127.0.0.1:6174", [x], [out])
    return (json.loads(server.serialize_to_string()),
            json.loads(trainer.serialize_to_string()))


def test_parameter_server_layers_build_the_jax_op_pair():
    """ListenAndServ (its sub-block, Fanin, out_vars) and Send build the
    JAX package's programs, op for op."""
    got = _pserver_pair(fluid, layers)
    want = _pserver_pair(jfluid, jlayers)
    assert got == want
    types = [op["type"] for op in got[0]["blocks"][0]["ops"]]
    assert types[-1] == "listen_and_serv"
