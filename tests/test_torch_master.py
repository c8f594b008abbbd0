"""Twins of tests/test_master_service.py, of the master tests of
tests/test_fault_tolerance.py, of tests/test_cli.py::
test_pserver_starts_and_serves and of tests/test_dist_train.py: the
port's elastic dataset master (`distributed.master`) and its ``pserver``
verb.

Where a JAX test drives the service directly, the JAX service runs the
same calls beside it and the tasks each hands out are held equal (the
replies bitwise).  The record files are written by the port's
`recordio.Writer` and read by either package.
"""
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from paddle_tpu.distributed import master as jmaster

import paddle_tpu_torch.recordio as recordio
from paddle_tpu_torch import fault
from paddle_tpu_torch.distributed import (AllTasksFailed, Backoff,
                                          MasterClient, MasterServer,
                                          MasterService, NoMoreTasks, Task)
from paddle_tpu_torch.observability import default_registry

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: a drain thread's deadline: generous under a loaded parallel run
DRAIN_DEADLINE = 120.0


@pytest.fixture
def port_fault():
    """The port's fault points, clean on both sides of the test."""
    fault.reset()
    yield fault
    fault.reset()


def _write_dataset(tmp_path, files=2, chunks=3, records_per_chunk=4):
    paths = []
    rec_id = 0
    for fi in range(files):
        p = str(tmp_path / f"shard-{fi:02d}.recordio")
        with recordio.Writer(p, max_chunk_records=records_per_chunk) as w:
            for _ in range(chunks * records_per_chunk):
                w.write(f"rec-{rec_id}".encode())
                rec_id += 1
        paths.append(p)
    return paths, rec_id


def _both(**kw):
    """The port's service and the JAX one, alike configured."""
    return MasterService(**kw), jmaster.MasterService(**kw)


def _lease(svcs, *args, **kw):
    """``get_task`` on both services -> the port's task, held equal to
    the JAX one's (or both raise the same exception type)."""
    got = []
    for svc in svcs:
        try:
            got.append(svc.get_task(*args, **kw))
        except (NoMoreTasks, jmaster.NoMoreTasks) as e:
            got.append(("NoMoreTasks", e.retryable))
        except (AllTasksFailed, jmaster.AllTasksFailed):
            got.append(("AllTasksFailed",))
    port, jax_ = got
    if isinstance(port, tuple):
        assert port == jax_
        raise (NoMoreTasks(retryable=port[1]) if port[0] == "NoMoreTasks"
               else AllTasksFailed())
    assert port.to_json() == jax_.to_json()
    return port


# ---------------------------------------------------------------------------
# tests/test_master_service.py
# ---------------------------------------------------------------------------

def test_partition_and_full_pass(tmp_path):
    paths, total = _write_dataset(tmp_path)
    svcs = _both(chunks_per_task=1)
    for s in svcs:
        s.set_dataset(paths)
    seen = []
    while True:
        try:
            task = _lease(svcs, "w0", epoch=0)
        except NoMoreTasks:
            break
        for rec in recordio.Scanner(task.path, task.chunk_begin,
                                    task.chunk_end):
            seen.append(rec)
        for s in svcs:
            s.task_finished(task.id)
    assert len(seen) == total
    assert len(set(seen)) == total


def test_lease_timeout_requeues(tmp_path):
    paths, _ = _write_dataset(tmp_path, files=1, chunks=1)
    svcs = _both(chunks_per_task=1, timeout_s=0.1)
    for s in svcs:
        s.set_dataset(paths)
    t1 = _lease(svcs, "dead-worker")
    with pytest.raises(NoMoreTasks):
        _lease(svcs, "w1")
    time.sleep(0.15)
    t2 = _lease(svcs, "w1")
    assert t2.id == t1.id
    assert t2.num_failures == 1


def test_failure_budget_discards_poison_task(tmp_path):
    paths, _ = _write_dataset(tmp_path, files=1, chunks=1)
    svcs = _both(chunks_per_task=1, failure_max=3)
    for s in svcs:
        s.set_dataset(paths)
    for _ in range(3):
        t = _lease(svcs, "w")
        for s in svcs:
            s.task_failed(t.id)
    with pytest.raises(AllTasksFailed):
        _lease(svcs, "w")


def test_new_pass_after_done(tmp_path):
    paths, _ = _write_dataset(tmp_path, files=1, chunks=2)
    svcs = _both(chunks_per_task=1)
    for s in svcs:
        s.set_dataset(paths)
    for _ in range(2):
        t = _lease(svcs, "w")
        for s in svcs:
            s.task_finished(t.id)
    assert _lease(svcs, "w").epoch == 1


def test_snapshot_recover(tmp_path):
    """The port's snapshot recovers in the port and in the JAX package
    alike (the file is the JAX format)."""
    paths, _ = _write_dataset(tmp_path, files=1, chunks=3)
    snap = str(tmp_path / "master.state")
    svc = MasterService(chunks_per_task=1, snapshot_path=snap)
    svc.set_dataset(paths)
    t = svc.get_task("w")
    svc.task_finished(t.id)
    svc.get_task("w")               # one pending, lost on restart
    svcs = (MasterService(chunks_per_task=1, snapshot_path=snap),
            jmaster.MasterService(chunks_per_task=1, snapshot_path=snap))
    for s in svcs:
        s.snapshot_path = None      # read it, do not rewrite it
    ids = set()
    while True:
        try:
            task = _lease(svcs, "w2", epoch=0)
        except NoMoreTasks:
            break
        ids.add(task.id)
        for s in svcs:
            s.task_finished(task.id)
    assert len(ids) == 2


def test_tcp_server_client_roundtrip(tmp_path):
    paths, total = _write_dataset(tmp_path, files=2, chunks=2)
    svc = MasterService(chunks_per_task=1)
    port_file = str(tmp_path / "selected_port")
    with MasterServer(svc, port_file=port_file) as server:
        assert int(open(port_file).read()) == server.port
        client = MasterClient(server.host, server.port)
        client.set_dataset(paths)
        seen = list(client.records())
        assert len(seen) == total
        assert len(list(client.records())) == total    # the next pass
        client.close()
        # the JAX client reads the port's master over the same wire
        jc = jmaster.MasterClient(server.host, server.port, worker="j")
        assert sorted(jc.records()) == sorted(seen)
        jc.close()


def test_two_clients_disjoint_tasks(tmp_path):
    """One client a worker thread; the drain threads have DRAIN_DEADLINE,
    which holds on a loaded machine.  Both clients register before
    either leases: a client that registers after the pass drained joins
    the next pass (`MasterService.register`), so a thread started late
    on a loaded machine would read the dataset a second time."""
    paths, total = _write_dataset(tmp_path, files=2, chunks=3)
    svc = MasterService(chunks_per_task=2)
    svc.set_dataset(paths)
    with MasterServer(svc) as server:
        per_worker = {"w1": [], "w2": []}
        registered = threading.Barrier(len(per_worker),
                                       timeout=DRAIN_DEADLINE)

        def drain(worker):
            c = MasterClient(server.host, server.port, worker=worker)
            try:
                assert c.register() == 0
                registered.wait()
                per_worker[worker].extend(c.records())
            finally:
                c.close()

        threads = [threading.Thread(target=drain, args=(w,), daemon=True)
                   for w in per_worker]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=DRAIN_DEADLINE)
            assert not t.is_alive(), "drain thread hung"
        recs = per_worker["w1"] + per_worker["w2"]
        assert len(recs) == total
        assert len(set(recs)) == total


# ---------------------------------------------------------------------------
# tests/test_fault_tolerance.py's master tests
# ---------------------------------------------------------------------------

def _small_dataset(tmp_path, chunks=3):
    return _write_dataset(tmp_path, files=1, chunks=chunks,
                          records_per_chunk=2)


def test_replacement_worker_finishes_round_after_peer_death(tmp_path):
    """Worker A dies holding a pass-1 lease; replacement B registers,
    adopts pass 1, inherits the expired lease and finishes the pass."""
    reg = default_registry()
    was = reg.enabled
    reg.enable()
    readmitted = reg.counter(
        "master_workers_readmitted_total",
        "replacement workers admitted after leasing began "
        "(elastic refill)")._series[()]
    base = readmitted.value
    try:
        paths, total = _small_dataset(tmp_path)
        svc = MasterService(chunks_per_task=1, timeout_s=0.2)
        with MasterServer(svc) as server:
            a = MasterClient(server.host, server.port, worker="doomed")
            a.set_dataset(paths)
            pass0 = list(a.records())
            assert len(pass0) == total
            victim = a.get_task()
            assert victim.epoch == 1
            a.close()
            b = MasterClient(server.host, server.port, worker="replacement",
                             retry_interval=0.05)
            pass1 = list(b.records())
            b.close()
        assert sorted(pass1) == sorted(pass0)
        assert readmitted.value - base >= 1
    finally:
        if not was:
            reg.disable()


def test_late_registrant_adopts_current_epoch(tmp_path):
    paths, _ = _small_dataset(tmp_path, chunks=2)
    svc = MasterService(chunks_per_task=1)
    with MasterServer(svc) as server:
        a = MasterClient(server.host, server.port, worker="w0")
        a.set_dataset(paths)
        list(a.records())
        b = MasterClient(server.host, server.port, worker="late")
        assert b.register() == 1
        a.close()
        b.close()


def test_expired_lease_requeues_to_front(tmp_path):
    paths, _ = _small_dataset(tmp_path)
    svcs = _both(chunks_per_task=1, timeout_s=0.1)
    for s in svcs:
        s.set_dataset(paths)
    t0 = _lease(svcs, "dead")
    time.sleep(0.15)
    t = _lease(svcs, "replacement")
    assert t.id == t0.id and t.num_failures == 1


def test_get_task_retransmit_returns_same_lease(tmp_path):
    paths, _ = _small_dataset(tmp_path)
    svcs = _both(chunks_per_task=1, timeout_s=60.0)
    for s in svcs:
        s.set_dataset(paths)
    t1 = _lease(svcs, "w", req=1)
    again = _lease(svcs, "w", req=1)
    assert again.id == t1.id
    assert len(svcs[0]._pending) == 1
    t2 = _lease(svcs, "w", req=2)
    assert t2.id != t1.id
    t3 = _lease(svcs, "w")
    assert t3.id not in (t1.id, t2.id)


def test_retryable_no_more_tasks_backs_off(tmp_path, monkeypatch):
    """While every task is leased elsewhere, next_record sleeps growing
    jittered delays."""
    paths, _ = _small_dataset(tmp_path, chunks=2)
    svc = MasterService(chunks_per_task=2, timeout_s=0.6)
    with MasterServer(svc) as server:
        a = MasterClient(server.host, server.port, worker="holder")
        a.set_dataset(paths)
        a.get_task()
        b = MasterClient(server.host, server.port, worker="waiter",
                         retry_interval=0.01)
        delays = []
        orig = Backoff.sleep

        def spy(self):
            d = self.next_delay()
            delays.append(d)
            time.sleep(min(d, 0.05))
            return d
        monkeypatch.setattr(Backoff, "sleep", spy)
        rec = b.next_record()
        assert rec is not None
        assert len(delays) >= 2
        assert delays[-1] > delays[0]
        monkeypatch.setattr(Backoff, "sleep", orig)
        a.close()
        b.close()


@pytest.mark.chaos
def test_master_rpc_survives_one_dropped_connection(tmp_path, port_fault):
    paths, total = _small_dataset(tmp_path, chunks=2)
    svc = MasterService(chunks_per_task=1)
    with MasterServer(svc) as server:
        c = MasterClient(server.host, server.port, worker="flaky",
                         retry_interval=0.01)
        c.set_dataset(paths)
        port_fault.arm("master.rpc@2:drop")
        recs = list(c.records())
        assert len(recs) == total
        assert port_fault.hits("master.rpc") >= 2
        c.close()


@pytest.mark.chaos
def test_master_rpc_drop_exhausts_bounded_retries(tmp_path, port_fault):
    svc = MasterService(chunks_per_task=1)
    with MasterServer(svc) as server:
        c = MasterClient(server.host, server.port, worker="w",
                         retry_interval=0.01, rpc_retries=1)
        port_fault.arm("master.rpc@1+:drop")
        with pytest.raises(ConnectionError):
            c.register()


def test_wire_replies_match_the_jax_master(tmp_path):
    """The same call sequence on a port master and a JAX master gives the
    same reply lines, byte for byte, from each package's client."""
    import json
    import socket
    paths, _ = _small_dataset(tmp_path)
    calls = [{"method": "set_dataset", "paths": paths},
             {"method": "register", "worker": "w"},
             {"method": "get_task", "worker": "w", "epoch": 0, "req": 1},
             {"method": "get_task", "worker": "w", "epoch": 0, "req": 1},
             {"method": "task_failed", "task_id": 0},
             {"method": "get_task", "worker": "w", "epoch": 0, "req": 2},
             {"method": "task_finished", "task_id": 1},
             {"method": "nope"}]
    lines = []
    for mod in (jmaster, sys.modules[MasterService.__module__]):
        svc = mod.MasterService(chunks_per_task=1)
        with mod.MasterServer(svc) as server:
            with socket.create_connection((server.host, server.port)) as s:
                f = s.makefile("rwb")
                got = []
                for c in calls:
                    f.write((json.dumps(c) + "\n").encode())
                    f.flush()
                    got.append(f.readline())
        lines.append(got)
    assert lines[0] == lines[1]
    assert Task.from_json(json.loads(lines[1][2])["task"]).id == 0


# ---------------------------------------------------------------------------
# tests/test_cli.py::test_pserver_starts_and_serves and the
# tests/test_dist_train.py worker
# ---------------------------------------------------------------------------

def test_pserver_starts_and_serves(tmp_path):
    """``python -m paddle_tpu_torch pserver`` binds, publishes its port,
    answers a client (the JAX one too) and stops on SIGTERM."""
    paths, total = _small_dataset(tmp_path, chunks=2)
    port_file = tmp_path / "port"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=_REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "pserver",
         "--host", "127.0.0.1", "--port", "0",
         "--port-file", str(port_file), "--chunks-per-task", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        deadline = time.monotonic() + 60
        while not port_file.exists() and time.monotonic() < deadline:
            time.sleep(0.1)
        assert port_file.exists(), "pserver never wrote its port"
        port = int(port_file.read_text())
        client = MasterClient("127.0.0.1", port)
        client.set_dataset(paths)
        assert client.register() == 0
        task = client.get_task()
        assert task.chunk_end - task.chunk_begin == 2
        client.task_finished(task.id)
        client.close()
        jc = jmaster.MasterClient("127.0.0.1", port, worker="j")
        assert len(list(jc.records())) == total
        jc.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=30)[0]
    assert proc.returncode == 0, out
    assert f"on 127.0.0.1:{port}" in out


_WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.distributed import MasterClient
    from paddle_tpu_torch.recordio_writer import deserialize_sample

    port_file, n_epochs = sys.argv[1], int(sys.argv[2])
    c = MasterClient("127.0.0.1", int(open(port_file).read()),
                     worker="trainer")
    x = layers.data(name="x", shape=[4], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    pred = layers.fc(input=x, size=1)
    loss = layers.mean(layers.square_error_cost(input=pred, label=y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    losses, n_records = [], 0
    for _ in range(n_epochs):
        batch = []
        for rec in c.records():
            n_records += 1
            batch.append(deserialize_sample(rec))
            if len(batch) == 16:
                xs = np.stack([b[0] for b in batch])
                ys = np.stack([b[1] for b in batch])
                (l,) = exe.run(fluid.default_main_program(),
                               feed={{"x": xs, "y": ys}}, fetch_list=[loss])
                losses.append(float(l))
                batch = []
    c.close()
    print("RESULT", n_records, losses[0], losses[-1])
""").format(repo=_REPO)


def test_worker_process_trains_from_master(tmp_path):
    """A worker process of the port leases every record of four passes
    through `MasterClient` and its fit-a-line loss falls."""
    from paddle_tpu_torch.recordio_writer import \
        convert_reader_to_recordio_file

    rng = np.random.RandomState(0)
    w_true = rng.rand(4, 1).astype(np.float32)

    def samples():
        for _ in range(64):
            x = rng.rand(4).astype(np.float32)
            yield x, (x @ w_true).astype(np.float32)

    path = str(tmp_path / "train.recordio")
    convert_reader_to_recordio_file(path, samples)
    worker_py = str(tmp_path / "worker.py")
    with open(worker_py, "w") as f:
        f.write(_WORKER)
    port_file = str(tmp_path / "selected_port")
    svc = MasterService(chunks_per_task=1)
    svc.set_dataset([path])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    with MasterServer(svc, port_file=port_file):
        proc = subprocess.run([sys.executable, worker_py, port_file, "4"],
                              capture_output=True, text=True, timeout=300,
                              env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT")][0]
    _, n_records, first, last = line.split()
    assert int(n_records) == 4 * 64
    assert float(last) < float(first) * 0.2
