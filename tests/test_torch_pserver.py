"""Twins of tests/test_listen_and_serv.py, of the parameter-server tests
of tests/test_fault_tolerance.py and of
tests/test_observability.py::test_trace_rides_the_distributed_rpc_wire:
the port's ``listen_and_serv`` / ``send`` op pair and
`distributed.param_server`.

The pservers run as ``python -c`` subprocesses of the port (one BLAS
thread each), bind port 0 and publish the real port through the
selected-port file, as in the JAX tests.  The wire is the JAX package's:
a JAX trainer and a port trainer meet in one round of a port pserver,
and a port trainer talks to a JAX pserver; every reply is held bitwise.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import layers as jlayers
from paddle_tpu.distributed import param_server as jps

import paddle_tpu_torch as fluid
from paddle_tpu_torch import fault, layers, profiler
from paddle_tpu_torch.distributed import param_server as ps
from paddle_tpu_torch.observability import trace

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_port():
    """Fresh default programs and scope for the port, and no armed fault
    (another file's tests may have run first in this process)."""
    fluid.core.program.reset_default_programs()
    fluid.core.scope._global_scope = fluid.core.scope.Scope()
    fault.reset()
    yield
    fault.reset()

_PSERVER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers

    port_file = sys.argv[1]
    main = fluid.Program()
    with fluid.program_guard(main):
        serv = layers.ListenAndServ("127.0.0.1:0", ["X"],
                                    optimizer_mode=False)
        with serv.do():
            x = layers.data(name="X", shape=[32, 32], dtype="float32",
                            append_batch_size=False)
            out = main.global_block().create_var(
                name="Out", shape=(32, 32), dtype="float32")
            layers.scale(x=x, scale=10.0, out=out)
    import paddle_tpu_torch.distributed.param_server as ps
    ps.SELECTED_PORT_FILE = port_file
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(main)     # serves until the shutdown message
""").format(repo=_REPO)

_PSERVER_STATEFUL = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers

    port_file, fan_in = sys.argv[1], int(sys.argv[2])
    main = fluid.Program()
    with fluid.program_guard(main):
        acc = main.global_block().create_var(name="Acc", shape=(1,),
                                             dtype="float32")
        layers.fill_constant(shape=[1], dtype="float32", value=0.0, out=acc)
        serv = layers.ListenAndServ("127.0.0.1:0", ["X"], fan_in=fan_in,
                                    optimizer_mode=True)
        with serv.do():
            x = layers.data(name="X", shape=[1], dtype="float32",
                            append_batch_size=False)
            layers.assign(layers.elementwise_add(acc, x), output=acc)
    import paddle_tpu_torch.distributed.param_server as ps
    ps.SELECTED_PORT_FILE = port_file
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(main)
""").format(repo=_REPO)

# the JAX test's pserver, unchanged but for the package path
_JAX_PSERVER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    os.environ["JAX_PLATFORMS"] = "cpu"
    import paddle_tpu as fluid
    from paddle_tpu import layers

    port_file = sys.argv[1]
    main = fluid.Program()
    with fluid.program_guard(main):
        serv = layers.ListenAndServ("127.0.0.1:0", ["X"],
                                    optimizer_mode=False)
        with serv.do():
            x = layers.data(name="X", shape=[32, 32], dtype="float32",
                            append_batch_size=False)
            out = main.global_block().create_var(
                name="Out", shape=(32, 32), dtype="float32")
            layers.scale(x=x, scale=10.0, out=out)
    import paddle_tpu.distributed.param_server as ps
    ps.SELECTED_PORT_FILE = port_file
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(main)
""").format(repo=_REPO)


class _Pserver:
    """A pserver subprocess: ``with _Pserver(script, tmp, *args) as ep``
    -> its endpoint; the exit sends the shutdown message and reaps it."""

    def __init__(self, script, tmp_path, *args):
        self.port_file = str(tmp_path / "selected_port")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", script, self.port_file, *args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)

    def __enter__(self):
        deadline = time.time() + 60
        while not os.path.exists(self.port_file):
            assert self.proc.poll() is None, self.proc.stdout.read().decode()
            assert time.time() < deadline, "pserver never published port"
            time.sleep(0.05)
        return f"127.0.0.1:{open(self.port_file).read().strip()}"

    def __exit__(self, *exc):
        try:
            port = open(self.port_file).read().strip()
            ps.shutdown_server(f"127.0.0.1:{port}")
        except OSError:
            pass
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def _port_trainer(endpoint, value):
    """The JAX test's trainer program on the port: Send X, receive Out."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data(name="X", shape=[32, 32], dtype="float32",
                        append_batch_size=False)
        get_var = main.global_block().create_var(
            name="Out", shape=(32, 32), dtype="float32")
        layers.Send(endpoint, [x], [get_var])
    exe = fluid.Executor(fluid.CPUPlace())
    return exe.run(main, feed={"X": np.full((32, 32), value, np.float32)},
                   fetch_list=[get_var])[0]


def _jax_send(endpoint, name, out_shape, value, shape):
    """A JAX trainer program: Send ``name`` (fed ``value``), receive Out
    (or Acc) of ``out_shape``."""
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        x = jlayers.data(name="X", shape=list(shape), dtype="float32",
                         append_batch_size=False)
        get_var = main.global_block().create_var(
            name=name, shape=out_shape, dtype="float32")
        jlayers.Send(endpoint, [x], [get_var])
    exe = jfluid.Executor(jfluid.CPUPlace())
    return np.asarray(exe.run(main, feed={"X": np.full(shape, value,
                                                       np.float32)},
                              fetch_list=[get_var])[0])


def test_send_op_round_trip(tmp_path):
    """The port trainer sends X, the port server scales by 10, the
    trainer receives Out (2.3 -> 23.0, the float32 product of both
    packages' scale rule)."""
    with _Pserver(_PSERVER, tmp_path) as ep:
        out = _port_trainer(ep, 2.3)
    assert out.dtype == np.float32 and out.shape == (32, 32)
    np.testing.assert_array_equal(
        out, np.full((32, 32), np.float32(2.3) * np.float32(10.0)))


def test_transpiler_pserver_routing_no_longer_raises():
    """get_pserver_program / get_startup_program return the transpiled
    program (the pserver role is one more SPMD participant), which runs."""
    from paddle_tpu_torch.parallel.transpiler import DistributeTranspiler

    x = layers.data(name="x", shape=[4], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    pred = layers.fc(input=x, size=1)
    loss = layers.mean(layers.square_error_cost(input=pred, label=y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)

    class _Mesh:        # the transpiler reads only the mesh's sizes
        shape = {"dp": 1}

    t = DistributeTranspiler(trainer_id=0, trainers=2,
                             pservers="127.0.0.1:0")
    t.transpile(fluid.default_main_program(), _Mesh())
    trainer_prog = t.get_trainer_program()
    pserver_prog = t.get_pserver_program("127.0.0.1:0")
    startup = t.get_startup_program("127.0.0.1:0", pserver_prog)
    assert pserver_prog is trainer_prog
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    out = exe.run(pserver_prog,
                  feed={"x": np.ones((4, 4), np.float32),
                        "y": np.zeros((4, 1), np.float32)},
                  fetch_list=[loss])
    assert np.isfinite(float(out[0]))


def test_async_pserver_mode_stays_loud():
    from paddle_tpu_torch.parallel.transpiler import DistributeTranspiler
    t = DistributeTranspiler(sync_mode=False)
    with pytest.raises(NotImplementedError):
        t.get_pserver_program("127.0.0.1:0")


def test_server_state_accumulates_across_rounds(tmp_path):
    """The served env persists between rounds: sends of 2.0 and 3.0
    leave Acc = 5.0 on the server."""
    with _Pserver(_PSERVER_STATEFUL, tmp_path, "1") as ep:
        r1 = ps.send_round_trip(ep, {"X": np.array([2.0], np.float32)})
        r2 = ps.send_round_trip(ep, {"X": np.array([3.0], np.float32)})
    assert r1["Acc"].dtype == np.float32
    assert float(r1["Acc"][0]) == 2.0
    assert float(r2["Acc"][0]) == 5.0


def test_jax_and_port_trainers_share_a_port_pserver_round(tmp_path):
    """One round of a port pserver with fan_in=2 completes from a JAX
    trainer's send op and a port trainer's: the server sums 2.0 and 3.0
    and both get Acc = 5.0; a second JAX round from the JAX
    ``send_round_trip`` and the port's gives 5.0 + 4.0 + 1.0."""
    with _Pserver(_PSERVER_STATEFUL, tmp_path, "2") as ep:
        got = {}
        t = threading.Thread(target=lambda: got.update(
            jax=_jax_send(ep, "Acc", (1,), 2.0, (1,))), daemon=True)
        t.start()
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            x = layers.data(name="X", shape=[1], dtype="float32",
                            append_batch_size=False)
            acc = main.global_block().create_var(name="Acc", shape=(1,),
                                                 dtype="float32")
            layers.Send(ep, [x], [acc])
        got["port"] = fluid.Executor(fluid.CPUPlace()).run(
            main, feed={"X": np.array([3.0], np.float32)},
            fetch_list=[acc])[0]
        t.join(timeout=60)
        assert not t.is_alive()
        np.testing.assert_array_equal(got["port"], np.float32([5.0]))
        np.testing.assert_array_equal(got["jax"], got["port"])
        second = {}
        t = threading.Thread(target=lambda: second.update(
            jax=jps.send_round_trip(ep, {"X": np.float32([4.0])})),
            daemon=True)
        t.start()
        second["port"] = ps.send_round_trip(ep, {"X": np.float32([1.0])})
        t.join(timeout=60)
    assert second["jax"]["Acc"].tobytes() == second["port"]["Acc"].tobytes()
    assert float(second["port"]["Acc"][0]) == 10.0


def test_port_trainer_against_jax_pserver(tmp_path):
    """The port's send op against the JAX package's pserver: the reply
    is bitwise the JAX trainer's."""
    with _Pserver(_JAX_PSERVER, tmp_path) as ep:
        got = _port_trainer(ep, 2.3)
        want = _jax_send(ep, "Out", (32, 32), 2.3, (32, 32))
    assert got.tobytes() == want.astype(np.float32).tobytes()


def test_send_refuses_a_shapeless_var_and_a_missing_reply(tmp_path):
    """The JAX errors: a receiving var without a concrete shape, and a
    reply that lacks a var the program receives."""
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = layers.data(name="X", shape=[1], dtype="float32",
                        append_batch_size=False)
        free = main.global_block().create_var(name="Free", shape=(-1,),
                                              dtype="float32")
        layers.Send("127.0.0.1:1", [x], [free])
    with pytest.raises(ValueError, match="concrete shape"):
        fluid.Executor(fluid.CPUPlace()).run(
            main, feed={"X": np.float32([1.0])}, fetch_list=[free])
    with _Pserver(_PSERVER_STATEFUL, tmp_path, "1") as ep:
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()):
            x = layers.data(name="X", shape=[1], dtype="float32",
                            append_batch_size=False)
            other = main.global_block().create_var(name="Other",
                                                   shape=(1,),
                                                   dtype="float32")
            layers.Send(ep, [x], [other])
        with pytest.raises(KeyError, match="did not produce var 'Other'"):
            fluid.Executor(fluid.CPUPlace()).run(
                main, feed={"X": np.float32([1.0])}, fetch_list=[other])


def test_pserver_send_drop_is_a_connection_error():
    fault.arm("pserver.send:drop")
    with pytest.raises(ConnectionError, match="send dropped"):
        ps.send_round_trip("127.0.0.1:1", {"g": np.zeros(2, np.float32)})
    assert fault.hits("pserver.send") == 1


def test_pserver_round_completed_by_replacement_trainer():
    """fan_in counts contributions, not identities: a replacement's send
    completes the round a dead trainer left, and every waiter gets the
    summed round's result, bitwise the JAX service's."""
    results = {}
    for pkg, mod in (("port", ps), ("jax", jps)):
        svc = mod.ParamServerService(
            serve_fn=lambda feed: {"w": feed["g"] * 2.0},
            fan_in=2, round_deadline=30.0)
        got = {}

        def survivor(svc=svc, got=got):
            got["survivor"] = svc.handle_send({"g": np.ones(2, np.float32)})

        t = threading.Thread(target=survivor, daemon=True)
        t.start()
        time.sleep(0.1)
        got["replacement"] = svc.handle_send(
            {"g": np.full(2, 3.0, np.float32)})
        t.join(timeout=10)
        assert not t.is_alive()
        results[pkg] = got
    for who in ("survivor", "replacement"):
        np.testing.assert_array_equal(results["port"][who]["w"],
                                      np.full(2, 8.0))
        assert (results["port"][who]["w"].tobytes()
                == results["jax"][who]["w"].tobytes())


def test_round_deadline_withdraws_and_a_failed_round_fails_every_waiter():
    """A waiter whose round never completes withdraws its send and gets
    the diagnostic; a round whose computation raises fails each waiter."""
    svc = ps.ParamServerService(lambda feed: {"w": feed["g"]}, fan_in=2,
                                round_deadline=0.2)
    with pytest.raises(RuntimeError, match="incomplete after"):
        svc.handle_send({"g": np.ones(1, np.float32)})
    assert svc._round_feeds == []

    def boom(feed):
        raise ValueError("bad block")

    svc = ps.ParamServerService(boom, fan_in=1)
    with pytest.raises(RuntimeError, match="ValueError: bad block"):
        svc.handle_send({"g": np.ones(1, np.float32)})


def test_trace_rides_the_distributed_rpc_wire():
    """The trainer's trace id reaches the server, which answers under it;
    the round trip returns the served value."""
    service = ps.ParamServerService(lambda feed: {"w": feed["g"] * 2.0},
                                    fan_in=1)
    server = ps.ParamServer(service, port=0, port_file="")
    t = threading.Thread(target=server.serve_forever,
                         kwargs={"poll_interval": 0.05}, daemon=True)
    t.start()
    try:
        profiler.start_profiler()
        with trace.scope() as tid:
            out = ps.send_round_trip(f"127.0.0.1:{server.port}",
                                     {"g": np.ones(2, np.float32)},
                                     timeout=10, read_timeout=30)
        profiler.stop_profiler()
        np.testing.assert_allclose(out["w"], 2.0)
        with socket.create_connection(("127.0.0.1", server.port)) as s:
            f = s.makefile("rwb")
            with trace.scope(tid):
                msg = trace.inject({"method": "send", "vars": {
                    "g": ps._encode(np.ones(2, np.float32))}})
            f.write((json.dumps(msg) + "\n").encode())
            f.flush()
            resp = json.loads(f.readline())
        assert resp["trace"] == tid
    finally:
        profiler.reset_profiler()
        server.shutdown()
        server.server_close()
