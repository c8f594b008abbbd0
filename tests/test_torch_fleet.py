"""The port's serving fleet in one process: `FleetFrontend` over port
`InferenceServer` replicas living in this process (milliseconds to
boot), held to the JAX frontend's contract and, where the two can take
the same decisions, to the JAX frontend itself.

- Twins of ``tests/test_fleet.py``'s in-process tests: routing and
  tracing, power-of-two-choices, the circuit breaker, retry on another
  replica, the ``fleet.route`` and ``fleet.health`` fault points,
  admission and deadline sheds, the merged metrics with SLO gauges and
  the time-series store, retry spans on one trace, the relayed
  ``inspect``/``models`` verbs, the client's retry policy and the port
  file.
- Parity: `_Admission` and `_pick` take the JAX frontend's decisions for
  the same script and seed; the JAX `ServingClient` and the JAX ``top``
  renderer read a port frontend (infer, a streamed generate, stats,
  fleet, metrics); the JAX `stitch_processes` reads its trace.
- The refused ``compile_cache`` (XLA executables) and the decode
  engine's profiler warm-up window, which keeps no attribution.

Replicas run on the CPU (``device="cpu"``); the tiny models are a scale
op and a 2-layer d32 LM saved by the port.
"""
import json
import os
import random
import threading
import time

import numpy as np
import pytest

from paddle_tpu import serving as jserving
from paddle_tpu.__main__ import _render_top as j_render_top
from paddle_tpu.observability import timeline as jtl
from paddle_tpu.serving.fleet import (FleetFrontend as JFleetFrontend,
                                      _Admission as JAdmission)

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import fault, io as tio, layers as tlayers
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.__main__ import _render_top
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.serving import (FleetFrontend, InferenceServer,
                                      ServingClient, ServingEngine,
                                      ServingError)
from paddle_tpu_torch.serving.engine import EngineOverloadedError
from paddle_tpu_torch.serving.fleet import (EJECTED, HEALTHY, SUSPECT,
                                            _Admission)
from paddle_tpu_torch.serving.predictor import Predictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 10.0
LM = dict(vocab=64, max_len=16, n_layers=2, d_model=32, n_heads=4, d_ff=64)
DECODE = {"slots": 2, "block_len": 4, "warmup": True}


def _subproc_env():
    """Spawned replicas: the repo importable, one BLAS thread each."""
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def _scale_program(scale=SCALE):
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        x = tlayers.data(name="x", shape=[2], dtype="float32")
        out = tlayers.scale(x=x, scale=scale)
    return main, out


def _scale_predictor(scale=SCALE):
    main, out = _scale_program(scale)
    return Predictor(main, ["x"], [out], device="cpu")


def _scale_server(scale=SCALE, port=0, **engine_kw):
    engine_kw.setdefault("max_queue_delay_ms", 1.0)
    eng = ServingEngine(_scale_predictor(scale), **engine_kw)
    return InferenceServer(eng, port=port, port_file=None).start()


def _save_scale_model(dirname, scale=SCALE):
    """A one-scale-op inference model saved by the port, for replica
    processes."""
    main, out = _scale_program(scale)
    tio.save_inference_model(str(dirname), ["x"], [out], None,
                             main_program=main)
    return str(dirname)


def _save_lm(dirname, seed=5):
    """A random 2-layer d32 generation model saved by the port."""
    spec = TT.generation_spec(**LM)
    scope = Scope()
    for name, arr in TT.random_params(spec, seed).items():
        scope.set(name, arr)
    TT.save_generation_model(str(dirname), **LM, scope=scope, init=False)
    return str(dirname)


def _x(v):
    return {"x": np.full((1, 2), float(v), np.float32)}


def _fetch(out):
    return next(iter(out.values()))


@pytest.fixture
def adopted_fleet():
    """Two in-process replicas adopted by a frontend."""
    servers = [_scale_server(), _scale_server()]
    fleet = FleetFrontend(
        replica_endpoints=[f"127.0.0.1:{s.port}" for s in servers],
        health_interval=0.1, route_timeout=5.0, probe_timeout=2.0)
    fleet.start().wait_ready(timeout=20)
    yield fleet, servers
    fleet.stop(grace=5.0)
    for s in servers:
        try:
            s.stop()
        except Exception:  # noqa: BLE001 — already stopped by the test
            pass


@pytest.fixture
def fault_points():
    fault.reset()
    yield fault
    fault.reset()


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    return _save_lm(tmp_path_factory.mktemp("fleet_lm"))


@pytest.fixture
def lm_fleet(lm_dir):
    """A frontend over one in-process replica serving the LM with its
    decode engine."""
    reg = tserving.ModelRegistry(device="cpu")
    reg.load("default", lm_dir, decode=dict(DECODE), warmup=[])
    server = InferenceServer(reg, port=0, port_file="").start()
    fleet = FleetFrontend(replica_endpoints=[f"127.0.0.1:{server.port}"],
                          health_interval=0.1, route_timeout=20.0,
                          probe_timeout=5.0, sample_interval=0.1,
                          slo="p99_ms=60000")
    fleet.start().wait_ready(timeout=30)
    try:
        yield fleet, reg
    finally:
        fleet.stop(grace=5.0)
        server.stop()
        reg.close()


# ---------------------------------------------------------------------------
# routing + the health state machine
# ---------------------------------------------------------------------------

def test_fleet_routes_and_traces_through_replicas(adopted_fleet):
    fleet, _ = adopted_fleet
    with ServingClient(f"127.0.0.1:{fleet.port}") as c:
        for i in range(6):
            np.testing.assert_allclose(_fetch(c.infer(_x(i))), SCALE * i)
        # one trace id spans client -> frontend -> replica
        assert c.last_trace and len(c.last_trace) == 16
    st = fleet.stats()
    assert st["requests"] == 6
    assert sum(st["forwarded"].values()) == 6
    assert all(v > 0 for v in st["forwarded"].values())


def test_p2c_routing_prefers_lighter_replica():
    servers = [_scale_server(), _scale_server()]
    fleet = FleetFrontend(
        replica_endpoints=[f"127.0.0.1:{s.port}" for s in servers],
        health_interval=60.0, route_timeout=5.0)
    fleet.start().wait_ready(timeout=20)
    try:
        fleet.replica(0).last_depth = 1000.0   # r0 reports a deep queue
        with ServingClient(f"127.0.0.1:{fleet.port}") as c:
            for _ in range(10):
                c.infer(_x(1))
        assert fleet.replica(1).forwarded == 10
        assert fleet.replica(0).forwarded == 0
    finally:
        fleet.stop(grace=5.0)
        for s in servers:
            s.stop()


def test_circuit_breaker_eject_probe_readmit():
    """healthy -> (death) ejected -> (port answers again) healthy,
    counted as a re-admission."""
    srv = _scale_server()
    port = srv.port
    fleet = FleetFrontend(replica_endpoints=[f"127.0.0.1:{port}"],
                          health_interval=0.1, probe_timeout=1.0,
                          route_timeout=2.0)
    fleet.start().wait_ready(timeout=20)
    try:
        rep = fleet.replica(0)
        srv.engine.close()
        srv.stop()
        rep.invalidate_pool()
        deadline = time.monotonic() + 15
        while rep.state != EJECTED and time.monotonic() < deadline:
            time.sleep(0.05)
        assert rep.state == EJECTED, rep.describe()
        with pytest.raises(ServingError) as ei:
            ServingClient(f"127.0.0.1:{fleet.port}", retries=0).infer(_x(1))
        assert ei.value.code == "overloaded"
        srv2 = _scale_server(port=port)
        try:
            deadline = time.monotonic() + 20
            while rep.state != HEALTHY and time.monotonic() < deadline:
                time.sleep(0.05)
            assert rep.state == HEALTHY, rep.describe()
            assert fleet.stats()["readmitted"] >= 1
            out = tserving.infer_round_trip(f"127.0.0.1:{fleet.port}",
                                            _x(3))
            np.testing.assert_allclose(_fetch(out), SCALE * 3.0)
        finally:
            srv2.stop()
    finally:
        fleet.stop(grace=5.0)


def test_route_time_failure_retries_on_another_replica(adopted_fleet):
    fleet, servers = adopted_fleet
    servers[0].engine.close()
    servers[0].stop()
    with ServingClient(f"127.0.0.1:{fleet.port}", retries=0) as c:
        for i in range(8):
            np.testing.assert_allclose(_fetch(c.infer(_x(i))), SCALE * i)
    assert fleet.stats()["forwarded"]["r1"] >= 8


def test_fault_point_fleet_route_is_retried(adopted_fleet, fault_points):
    fleet, _ = adopted_fleet
    fault_points.arm("fleet.route@1:raise")
    with ServingClient(f"127.0.0.1:{fleet.port}", retries=0) as c:
        out = c.infer(_x(2))
    np.testing.assert_allclose(_fetch(out), SCALE * 2.0)
    assert fleet.stats()["retries"] >= 1
    assert fault_points.hits("fleet.route") >= 1


def test_stop_without_start_does_not_hang():
    srv = _scale_server()
    try:
        fleet = FleetFrontend(replica_endpoints=[f"127.0.0.1:{srv.port}"])
        t0 = time.monotonic()
        fleet.stop(grace=2.0)
        assert time.monotonic() - t0 < 10.0
    finally:
        srv.stop()


def test_fault_point_fleet_health_skips_one_sweep(adopted_fleet,
                                                  fault_points):
    fleet, _ = adopted_fleet
    fault_points.arm("fleet.health:raise")
    time.sleep(0.4)
    assert fleet.healthy_count() == 2
    out = tserving.infer_round_trip(f"127.0.0.1:{fleet.port}", _x(1))
    np.testing.assert_allclose(_fetch(out), SCALE)


def test_compile_cache_is_refused_and_described_as_none(tmp_path):
    with pytest.raises(ValueError, match="XLA-only options"):
        FleetFrontend([("default", str(tmp_path))], replicas=1,
                      compile_cache=str(tmp_path / "cc"))
    srv = _scale_server()
    fleet = FleetFrontend(replica_endpoints=[f"127.0.0.1:{srv.port}"])
    try:
        d = fleet.describe()
        assert d["compile_cache"] is None
        assert sorted(d) == sorted(
            ["endpoint", "models", "compile_cache", "health_interval",
             "replicas", "admission"])
        assert os.path.basename(fleet.run_dir).startswith(
            "paddle_tpu_torch_fleet.")
        cmd = FleetFrontend._spawn_cmd(
            type("F", (), {"python": "py", "models": [("default", "d")],
                           "replica_args": ["--device", "cpu"]})(), "pf")
        assert cmd == ["py", "-m", "paddle_tpu_torch", "serve", "d",
                       "--host", "127.0.0.1", "--port", "0",
                       "--port-file", "pf", "--device", "cpu"]
    finally:
        fleet.stop(grace=2.0)
        srv.stop()


class _FakeProc:
    """A spawned process that never runs: alive until terminated."""
    pid = 0

    def __init__(self):
        self.code = None

    def poll(self):
        return self.code

    def terminate(self):
        self.code = -15

    kill = terminate

    def wait(self, timeout=None):
        return self.code


def test_scale_up_spawns_its_replica_once(tmp_path):
    """`scale_up` spawns the new replica itself; the health loop (whose
    branch 0 spawns an owned replica that has no process) must not spawn
    it a second time while the first spawn is still starting the process:
    a second, untracked process would outlive the fleet.  The JAX
    frontend has this race (ROADMAP queue C)."""
    srv = _scale_server()
    fleet = FleetFrontend([("default", str(tmp_path))],
                          replica_endpoints=[f"127.0.0.1:{srv.port}"],
                          health_interval=0.01, run_dir=str(tmp_path))
    spawned = []

    def slow_spawn(rep):
        spawned.append(rep.rid)
        time.sleep(0.3)               # a Popen that takes a while
        rep.proc, rep.started_at = _FakeProc(), time.monotonic()

    fleet._spawn = slow_spawn
    fleet.start().wait_ready(timeout=20)
    try:
        rep = fleet.scale_up()
        time.sleep(0.5)
        assert spawned == [rep.rid], spawned
    finally:
        fleet.stop(grace=2.0)
        srv.stop()


# ---------------------------------------------------------------------------
# fleet-wide observability
# ---------------------------------------------------------------------------

def test_fleet_metrics_aggregation_slo_gauges_and_timeseries():
    servers = [_scale_server(), _scale_server()]
    fleet = FleetFrontend(
        replica_endpoints=[f"127.0.0.1:{s.port}" for s in servers],
        health_interval=0.1, route_timeout=5.0, probe_timeout=2.0,
        slo="p99_ms=10000:avail=0.5", sample_interval=0.1)
    fleet.start().wait_ready(timeout=20)
    try:
        with ServingClient(f"127.0.0.1:{fleet.port}") as c:
            for i in range(4):
                c.infer(_x(i))
            deadline = time.monotonic() + 15
            while (any(r.metrics_snap is None for r in fleet.replicas)
                   or fleet.timeseries.ticks < 2) \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            snap = c.metrics(format="json")
            text = c.metrics()
        keys = snap["engine_requests_total"]["series"]
        for rep in ("r0", "r1", "fleet"):
            assert any(f"replica={rep}" in k for k in keys), (rep, keys)
        assert 'replica="r0"' in text and 'replica="fleet"' in text
        assert "fleet_requests_total" in snap
        assert "slo_breach" in snap and "slo_objective_target" in snap
        assert fleet.timeseries.ticks >= 2
        assert "fleet_requests_total" in fleet.timeseries.names()
        roll = fleet.timeseries.rollup("fleet_requests_total")
        assert roll and roll["last"] >= 4
        assert "slo" in fleet.stats()
    finally:
        fleet.stop(grace=5.0)
        for s in servers:
            s.stop()


def test_retry_attempt_spans_tagged_on_one_trace(adopted_fleet,
                                                 fault_points):
    fleet, _ = adopted_fleet
    fault_points.arm("fleet.route@1:raise")
    tprof.start_profiler()
    try:
        with ServingClient(f"127.0.0.1:{fleet.port}", retries=0) as c:
            out = c.infer(_x(2))
            tid = c.last_trace
        np.testing.assert_allclose(_fetch(out), SCALE * 2.0)
        spans = tprof.get_spans(tid)
    finally:
        tprof.stop_profiler(quiet=True)
        tprof.reset_profiler()
    attempts = sorted(
        (s["attrs"]["attempt"], s["attrs"]["outcome"])
        for s in spans if s["name"] == "fleet.attempt")
    assert attempts == [(1, "fault"), (2, "ok")], spans
    assert any(s["name"] == "frontend.request" for s in spans)


def test_fleet_relays_inspect_and_models_verbs(adopted_fleet):
    fleet, _ = adopted_fleet
    with ServingClient(f"127.0.0.1:{fleet.port}") as c:
        assert "models" in c.models()
        assert "layers" in c.inspect()


# ---------------------------------------------------------------------------
# admission control + deadlines
# ---------------------------------------------------------------------------

def test_admission_priority_queue_strict_order():
    adm = _Admission(bound=1, queue_limit=8)
    ok, _ = adm.acquire()
    assert ok
    order = []

    def waiter(prio):
        ok, code = adm.acquire(priority=prio, timeout=10.0)
        assert ok, code
        order.append(prio)
        adm.release()

    threads = []
    for prio in (1, 3, 2):
        t = threading.Thread(target=waiter, args=(prio,))
        t.start()
        threads.append(t)
        deadline = time.monotonic() + 5
        while adm.queued < len(threads) and time.monotonic() < deadline:
            time.sleep(0.01)
    adm.release()
    for t in threads:
        t.join(10)
    assert order == [3, 2, 1]


def test_admission_sheds_priority_zero_and_bounded_queue():
    adm = _Admission(bound=1, queue_limit=1)
    assert adm.acquire() == (True, None)
    assert adm.acquire(priority=0) == (False, "overloaded")
    ok, code = adm.acquire(priority=1, deadline=time.monotonic() + 0.05,
                           timeout=10.0)
    assert (ok, code) == (False, "deadline_exceeded")
    blocker = threading.Thread(
        target=lambda: adm.acquire(priority=1, timeout=2.0))
    blocker.start()
    deadline = time.monotonic() + 5
    while adm.queued < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert adm.acquire(priority=5) == (False, "overloaded")
    adm.release()
    blocker.join(10)


def test_admission_takes_the_jax_decisions():
    """One script of acquires and releases, single-threaded (sheds,
    bounded waits, deadlines, the unbounded admission), through both
    packages' `_Admission`: the same decisions and counts."""
    def run(cls):
        out = []
        for bound, limit in ((2, 1), (None, 4), (0, 2)):
            adm = cls(bound, limit)
            for op, prio, kind in (("a", 0, None), ("a", 0, None),
                                   ("a", 0, None), ("a", 1, "deadline"),
                                   ("a", 1, "timeout"), ("r", 0, None),
                                   ("a", 2, "timeout"), ("r", 0, None),
                                   ("r", 0, None), ("a", 0, None)):
                if op == "r":
                    adm.release()
                    out.append(("r", adm.outstanding, adm.queued))
                    continue
                kw = {"priority": prio, "timeout": 0.02}
                if kind == "deadline":
                    kw["deadline"] = time.monotonic() + 0.01
                out.append(("a",) + adm.acquire(**kw)
                           + (adm.outstanding, adm.queued))
        return out

    assert run(_Admission) == run(JAdmission)


def test_pick_takes_the_jax_decisions():
    """Power-of-two-choices over the same replicas, states, depths and
    seed draws the same replicas in both packages."""
    eps = [f"127.0.0.1:{1 + i}" for i in range(5)]
    fleets = [cls(replica_endpoints=eps, seed="parity")
              for cls in (FleetFrontend, JFleetFrontend)]
    try:
        rng = random.Random(7)
        script = []
        for step in range(60):
            states = [rng.choice((HEALTHY, HEALTHY, SUSPECT, EJECTED))
                      for _ in eps]
            depths = [float(rng.randrange(4)) for _ in eps]
            inflight = [rng.randrange(3) for _ in eps]
            tried = {i for i in range(len(eps)) if rng.random() < 0.2}
            script.append((states, depths, inflight, tried))
        picks = []
        for fleet in fleets:
            got = []
            for states, depths, inflight, tried in script:
                for r, st, d, n in zip(fleet.replicas, states, depths,
                                       inflight):
                    r.state, r.last_depth, r.inflight = st, d, n
                rep = fleet._pick(set(tried))
                got.append(None if rep is None else rep.rid)
            picks.append(got)
        assert picks[0] == picks[1]
        assert len({p for p in picks[0] if p is not None}) >= 3
    finally:
        for fleet in fleets:
            fleet.stop(grace=1.0)


def test_admission_shed_at_depth_bound_over_wire():
    srv = _scale_server()
    fleet = FleetFrontend(replica_endpoints=[f"127.0.0.1:{srv.port}"],
                          health_interval=0.1, admission_bound=0,
                          route_timeout=2.0)
    fleet.start().wait_ready(timeout=20)
    try:
        with pytest.raises(ServingError) as ei:
            ServingClient(f"127.0.0.1:{fleet.port}", retries=0).infer(_x(1))
        assert ei.value.code == "overloaded"
        assert ei.value.retriable
        assert fleet.stats()["shed"].get("overloaded", 0) >= 1
    finally:
        fleet.stop(grace=5.0)
        srv.stop()


def test_priority_rides_the_wire_to_the_admission_queue():
    """The port client's ``priority`` queues a request at a full bound
    instead of shedding it, as the JAX client's does."""
    srv = _scale_server()
    fleet = FleetFrontend(replica_endpoints=[f"127.0.0.1:{srv.port}"],
                          health_interval=0.1, admission_bound=1,
                          route_timeout=10.0)
    fleet.start().wait_ready(timeout=20)
    try:
        adm = fleet._admission(None)
        assert adm.acquire() == (True, None)      # hold the only slot
        box = {}

        def queued():
            with ServingClient(f"127.0.0.1:{fleet.port}", retries=0) as c:
                box["out"] = c.infer(_x(4), priority=2)

        t = threading.Thread(target=queued)
        t.start()
        deadline = time.monotonic() + 10
        while adm.queued < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert adm.queued == 1
        with pytest.raises(ServingError):
            ServingClient(f"127.0.0.1:{fleet.port}", retries=0).infer(_x(1))
        adm.release()
        t.join(10)
        np.testing.assert_allclose(_fetch(box["out"]), SCALE * 4)
    finally:
        fleet.stop(grace=5.0)
        srv.stop()


def test_deadline_shed_at_frontend_not_client_timeout(adopted_fleet):
    fleet, _ = adopted_fleet
    t0 = time.monotonic()
    with pytest.raises(ServingError) as ei:
        ServingClient(f"127.0.0.1:{fleet.port}").infer(_x(1),
                                                       deadline_ms=0.0)
    assert ei.value.code == "deadline_exceeded"
    assert time.monotonic() - t0 < 2.0
    assert fleet.stats()["shed"].get("deadline", 0) >= 1


def test_deadline_propagates_to_single_server():
    srv = _scale_server()
    try:
        with pytest.raises(ServingError) as ei:
            ServingClient(f"127.0.0.1:{srv.port}").infer(_x(1),
                                                         deadline_ms=-1.0)
        assert ei.value.code == "deadline_exceeded"
        out = ServingClient(f"127.0.0.1:{srv.port}").infer(
            _x(1), deadline_ms=30000.0)
        np.testing.assert_allclose(_fetch(out), SCALE)
    finally:
        srv.stop()


def test_engine_max_queue_depth_sheds():
    with ServingEngine(_scale_predictor(), max_queue_depth=0,
                       max_queue_delay_ms=1.0) as eng:
        with pytest.raises(EngineOverloadedError):
            eng.submit(_x(1))


def test_engine_purges_expired_queued_requests():
    with ServingEngine(_scale_predictor(), max_queue_delay_ms=1.0) as eng:
        fut = eng.submit(_x(1), deadline=time.monotonic() - 0.001)
        with pytest.raises(TimeoutError):
            fut.result(timeout=10)
        s = eng.stats()
        assert s["expired"] == 1
        assert s["dispatches"] == 0
        out, = eng.infer(_x(2), timeout=30)
        np.testing.assert_allclose(out, SCALE * 2.0)


# ---------------------------------------------------------------------------
# the client's retry policy (a scripted TCP stub)
# ---------------------------------------------------------------------------

class _ScriptedServer:
    """A TCP stub that replies from a script."""

    def __init__(self, replies):
        import socketserver

        outer = self

        class H(socketserver.StreamRequestHandler):
            def handle(self):
                for line in self.rfile:
                    outer.requests.append(json.loads(line))
                    if not outer.replies:
                        return
                    reply = outer.replies.pop(0)
                    if reply == "CLOSE":
                        return
                    if reply == "GARBLE":
                        self.wfile.write(b'{"fetch": {"x"')
                        self.wfile.flush()
                        return
                    self.wfile.write((json.dumps(reply) + "\n").encode())
                    self.wfile.flush()

        class S(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.replies = list(replies)
        self.requests = []
        self._srv = S(("127.0.0.1", 0), H)
        self.port = self._srv.server_address[1]
        threading.Thread(target=self._srv.serve_forever,
                         kwargs={"poll_interval": 0.05},
                         daemon=True).start()

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()


def test_client_retries_retriable_codes_with_bounded_backoff():
    stub = _ScriptedServer([
        {"error": "queue full", "code": "overloaded"},
        {"error": "draining", "code": "shutting_down"},
        {"stats": {"queue_depth": 0}},
    ])
    try:
        c = ServingClient(f"127.0.0.1:{stub.port}", retries=3)
        assert c.stats() == {"queue_depth": 0}
        assert len(stub.requests) == 3
        c.close()
    finally:
        stub.stop()


def test_client_retry_budget_is_bounded():
    stub = _ScriptedServer(
        [{"error": "queue full", "code": "overloaded"}] * 10)
    try:
        c = ServingClient(f"127.0.0.1:{stub.port}", retries=2)
        with pytest.raises(ServingError) as ei:
            c.stats()
        assert ei.value.code == "overloaded"
        assert len(stub.requests) == 3
        c.close()
    finally:
        stub.stop()


def test_client_retries_garbled_reply_as_connection_error():
    stub = _ScriptedServer(["GARBLE", {"stats": {"queue_depth": 0}}])
    try:
        c = ServingClient(f"127.0.0.1:{stub.port}", retries=2)
        assert c.stats() == {"queue_depth": 0}
        assert len(stub.requests) == 2
        c.close()
    finally:
        stub.stop()


def test_client_restates_remaining_deadline_on_retry():
    stub = _ScriptedServer([
        {"error": "queue full", "code": "overloaded"},
        {"fetch": {}, "trace": "00" * 8},
    ])
    try:
        c = ServingClient(f"127.0.0.1:{stub.port}", retries=3)
        c.infer({}, deadline_ms=5000.0)
        d1 = stub.requests[0]["deadline_ms"]
        d2 = stub.requests[1]["deadline_ms"]
        assert d1 <= 5000.0
        assert d2 < d1, (d1, d2)
        c.close()
    finally:
        stub.stop()
    stub = _ScriptedServer(
        [{"error": "queue full", "code": "overloaded"}] * 5)
    try:
        c = ServingClient(f"127.0.0.1:{stub.port}", retries=4)
        with pytest.raises(ServingError) as ei:
            c.infer({}, deadline_ms=5.0)
        assert ei.value.code == "deadline_exceeded"
        c.close()
    finally:
        stub.stop()


def test_client_never_retries_nonretriable_or_admin():
    stub = _ScriptedServer([{"error": "no such model",
                             "code": "unknown_model"}])
    try:
        c = ServingClient(f"127.0.0.1:{stub.port}", retries=3)
        with pytest.raises(ServingError) as ei:
            c.stats(model="ghost")
        assert ei.value.code == "unknown_model"
        assert len(stub.requests) == 1
        c.close()
    finally:
        stub.stop()
    stub = _ScriptedServer([{"error": "draining",
                             "code": "shutting_down"}])
    try:
        c = ServingClient(f"127.0.0.1:{stub.port}", retries=3)
        with pytest.raises(ServingError):
            c.unload_model("m")
        assert len(stub.requests) == 1
        c.close()
    finally:
        stub.stop()


# ---------------------------------------------------------------------------
# the port file
# ---------------------------------------------------------------------------

def test_port_file_written_atomically_and_waiter_polls(tmp_path):
    path = str(tmp_path / "port")
    open(path, "w").close()

    def complete_later():
        time.sleep(0.3)
        tserving.write_port_file(path, 4242)

    t = threading.Thread(target=complete_later)
    t.start()
    assert tserving.wait_for_port_file(path, timeout=10.0) == 4242
    t.join(5)
    assert os.listdir(str(tmp_path)) == ["port"]


def test_server_port_file_is_one_complete_line(tmp_path):
    port_file = str(tmp_path / "selected")
    srv = _scale_server()
    try:
        tserving.write_port_file(port_file, srv.port)
        assert open(port_file).read() == f"{srv.port}\n"
        assert tserving.wait_for_port_file(port_file, timeout=1.0) \
            == srv.port
    finally:
        srv.stop()


def test_wait_port_file_times_out_cleanly(tmp_path):
    with pytest.raises(TimeoutError):
        tserving.wait_for_port_file(str(tmp_path / "never"), timeout=0.3)


# ---------------------------------------------------------------------------
# the JAX package reads a port fleet
# ---------------------------------------------------------------------------

def test_jax_client_and_top_read_a_port_fleet(lm_fleet):
    """The JAX `ServingClient` drives a port frontend over an LM replica
    (infer, a streamed generate relayed token by token, stats, fleet,
    metrics), and the JAX ``top`` renderer gives the port's text."""
    fleet, reg = lm_fleet
    ep = f"127.0.0.1:{fleet.port}"
    tokens = {"tokens": np.arange(2 * LM["max_len"]).reshape(2, -1)
              % LM["vocab"]}
    want = reg.get("default").decode.generate([3, 4, 5], 6, timeout=60)
    with jserving.ServingClient(ep, timeout=60) as c:
        logits = _fetch(c.infer(tokens))
        assert logits.shape == (2, LM["max_len"], LM["vocab"])
        lines = list(c.generate_stream([3, 4, 5], max_new_tokens=6))
        assert lines[-1]["done"]
        assert [o["token"] for o in lines[:-1]] == lines[-1]["tokens"] \
            == want["tokens"]
        assert [o["index"] for o in lines[:-1]] == list(range(6))
        st = c.stats()
        assert st["fleet"] is True and st["requests"] == 2
        assert st["forwarded"] == {"r0": 2}
        deadline = time.monotonic() + 10
        while fleet.replica(0).last_decode is None or \
                fleet.replica(0).metrics_snap is None or \
                not fleet.slo_monitor.last:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        desc = c.raw_call({"method": "fleet"})["fleet"]
        stats = c.raw_call({"method": "stats"})["stats"]
        metrics = c.metrics(format="json")
    assert desc["replicas"][0]["decode"]["slots"] == DECODE["slots"]
    jtext, jprev = j_render_top(ep, desc, stats, metrics, {}, 1.0)
    ttext, tprev = _render_top(ep, desc, stats, metrics, {}, 1.0)
    assert jtext == ttext and jprev == tprev
    assert f"fleet {ep} — 1 replica(s), 1 healthy" in ttext
    assert "decode: slots" in ttext and "slo latency_p99" in ttext


def test_jax_stitch_reads_the_port_fleet_trace(lm_fleet):
    """One infer and one generate through the port frontend under the
    port's span log: the ``trace`` verb (asked by the JAX client) gives
    the frontend's and the replica's slices, which the JAX stitcher
    merges into flows over one trace id."""
    fleet, _ = lm_fleet
    ep = f"127.0.0.1:{fleet.port}"
    tokens = {"tokens": np.zeros((1, LM["max_len"]), np.int64)}
    tprof.start_profiler()
    try:
        with jserving.ServingClient(ep, timeout=60) as c:
            c.infer(tokens)
            tid = c.last_trace
            doc = c.trace(tid)
    finally:
        tprof.stop_profiler(quiet=True)
        tprof.reset_profiler()
    roles = [p["role"] for p in doc["processes"]]
    assert roles == ["frontend", "replica r0"], roles
    names = {s["name"] for p in doc["processes"] for s in p["spans"]}
    assert {"frontend.request", "fleet.attempt", "serving.request"} \
        <= names, names
    stitched = jtl.stitch_processes(doc["processes"])
    flows = [e for e in stitched["traceEvents"]
             if e.get("id") == tid and e["ph"] in ("s", "t", "f")]
    assert {e["ph"] for e in flows} == {"s", "t", "f"}


def test_generate_relay_in_process(lm_fleet):
    """The frontend relays a stream verbatim and counts it."""
    fleet, _ = lm_fleet
    with ServingClient(f"127.0.0.1:{fleet.port}", timeout=60) as c:
        lines = list(c.generate_stream([3, 4, 5], max_new_tokens=5))
        res = c.generate([3, 4, 5], max_new_tokens=5)
    assert lines[-1]["done"] and res["tokens"] == lines[-1]["tokens"]
    assert [o["token"] for o in lines[:-1]] == lines[-1]["tokens"]
    assert fleet.stats()["forwarded"]["r0"] == 2
    # the frontend's own series (a heartbeat may also have merged the
    # in-process replica's copy of it, labelled by replica)
    tokens = fleet.metrics_snapshot()["fleet_generate_tokens_total"]
    assert tokens["series"]["model=default"] == 5   # none non-streamed


# ---------------------------------------------------------------------------
# the decode engine's profiler warm-up window
# ---------------------------------------------------------------------------

def test_warmup_profiler_window_keeps_no_attribution(lm_dir):
    """The card's warm-up runs one decode step under ``torch.profiler``
    to pay CUPTI's first start before the port file is written; that
    window keeps no attribution and leaves a pending request alone, so
    the first ``stats()`` still profiles a live step.  On the CPU the
    same path runs through the plain versions."""
    import torch
    eng = tserving.DecodeEngine.from_model_dir(lm_dir, device="cpu",
                                               slots=2, block_len=4)
    try:
        idle = torch.from_numpy(eng._pages)
        step = (torch.zeros(2, dtype=torch.int64), idle,
                torch.zeros(2, dtype=torch.int32))
        eng._attr_wanted = True
        with torch.inference_mode():
            logits = eng._profiled_decode(*step, keep=False)
            plain = eng._decode_call(*step)
        assert eng._attr_wanted is True
        assert eng._inter_token_attr is None and eng._attr_error is None
        assert torch.equal(logits, plain)
        with torch.inference_mode():
            eng._profiled_decode(*step)
        assert eng._attr_wanted is False      # a kept window clears it
    finally:
        eng.close()
