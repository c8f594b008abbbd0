"""The port's serving fleet over real replica processes: ``python -m
paddle_tpu_torch serve --device cpu`` replicas spawned by a
`FleetFrontend` (or by the ``fleet`` verb) and SIGKILLed under load.

Twins of the chaos tests of ``tests/test_fleet.py`` (zero failed
requests across a SIGKILL, a faulted first spawn, a killed replica's
metric series dropping out and returning, the three-process stitched
trace, the bounded CLI smoke with ``top`` and ``metrics --watch``) and
of ``tests/test_decode_engine.py``'s fleet relay tests (a generate
stream relayed, and replayed token for token across a SIGKILL, with and
without the prefix cache), plus ``top``'s embedding-cache line.  Five
of the JAX originals fail in the reference (ROADMAP queue C); these
twins hold the intended contract.  Every subprocess runs under the
``proc_guard`` watchdog or `FleetFrontend.stop`, every port discovery
through ``wait_port_file``; replicas get one BLAS thread each.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch import fault, profiler as tprof
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.__main__ import _render_embcache, _render_top
from paddle_tpu_torch.__main__ import main as cli_main
from paddle_tpu_torch.observability import timeline as ttl
from paddle_tpu_torch.serving import FleetFrontend, ServingClient
from paddle_tpu_torch.serving.fleet import EJECTED, HEALTHY, SUSPECT

from tests.test_torch_fleet import (REPO, SCALE, _fetch, _save_lm,
                                    _save_scale_model, _subproc_env, _x)

CPU = ("--device", "cpu")


def _spawned_fleet(model_dir, tmp_path, n=3, replica_args=(), **kw):
    kw.setdefault("health_interval", 0.25)
    kw.setdefault("route_timeout", 60.0)
    kw.setdefault("request_timeout", 120.0)
    kw.setdefault("spawn_timeout", 120.0)
    return FleetFrontend(
        [("default", str(model_dir))], replicas=n,
        run_dir=str(tmp_path / "fleet_run"),
        spawn_env=kw.pop("spawn_env", None) or _subproc_env(),
        replica_args=CPU + tuple(replica_args), **kw)


@pytest.fixture
def fault_points():
    fault.reset()
    yield fault
    fault.reset()


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    return _save_lm(tmp_path_factory.mktemp("chaos_lm"))


# ---------------------------------------------------------------------------
# infer: SIGKILL, spawn faults, metric series
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_fleet_sigkill_replica_zero_failed_requests(tmp_path):
    """Three replicas under concurrent load, one SIGKILLed mid-run: zero
    failed or misrouted replies, the dead replica restarted, re-admitted
    and serving again."""
    model_dir = _save_scale_model(tmp_path / "model")
    fleet = _spawned_fleet(model_dir, tmp_path, n=3)
    fleet.start()
    try:
        fleet.wait_ready(timeout=180)
        endpoint = f"127.0.0.1:{fleet.port}"
        errors, misroutes = [], []
        done = threading.Event()
        per_client, n_clients = 120, 6

        def client(ci):
            try:
                with ServingClient(endpoint, timeout=120.0) as c:
                    for i in range(per_client):
                        v = float(ci * per_client + i)
                        got = _fetch(c.infer(_x(v)))
                        if not np.allclose(got, SCALE * v):
                            misroutes.append((v, got))
            except Exception as e:  # noqa: BLE001 — the assertion
                errors.append(e)

        threads = [threading.Thread(target=client, args=(ci,))
                   for ci in range(n_clients)]
        for t in threads:
            t.start()

        def killer():
            deadline = time.monotonic() + 60
            while (fleet.stats()["requests"] < 50
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            os.kill(fleet.replica(0).proc.pid, signal.SIGKILL)
            done.set()

        kt = threading.Thread(target=killer)
        kt.start()
        for t in threads:
            t.join(300)
        kt.join(30)
        assert done.is_set()
        assert not errors, errors
        assert not misroutes, misroutes
        victim = fleet.replica(0)
        deadline = time.monotonic() + 10
        while (victim.state not in (EJECTED, SUSPECT, HEALTHY)
               or victim.restarts == 0) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert victim.restarts >= 1, victim.describe()
        fleet.wait_ready(timeout=180)
        before = victim.forwarded
        with ServingClient(endpoint, timeout=120.0) as c:
            for _ in range(40):
                c.infer(_x(1))
        assert fleet.stats()["readmitted"] >= 1
        assert victim.forwarded > before, [r.describe()
                                           for r in fleet.replicas]
        assert fleet.stats()["retries"] >= 1
    finally:
        fleet.stop(grace=15.0)
    assert all(r.proc.poll() is not None for r in fleet.replicas)


@pytest.mark.chaos
def test_fault_point_replica_spawn_is_retried(tmp_path, fault_points):
    """A faulted first spawn strands nothing: the health loop retries it
    on the replica's backoff and the fleet comes up."""
    model_dir = _save_scale_model(tmp_path / "model")
    fault_points.arm("replica.spawn@1:raise")
    fleet = _spawned_fleet(model_dir, tmp_path, n=1)
    fleet.start()
    try:
        fleet.wait_ready(timeout=180)
        assert fault_points.hits("replica.spawn") >= 2
        out = tserving.infer_round_trip(f"127.0.0.1:{fleet.port}", _x(2),
                                        timeout=120.0)
        np.testing.assert_allclose(_fetch(out), SCALE * 2.0)
    finally:
        fleet.stop(grace=10.0)


@pytest.mark.chaos
def test_fleet_metrics_replica_series_drop_and_return(tmp_path):
    """Every replica's engine_* series labeled by replica plus the
    sum-merged fleet view; a SIGKILLed replica's series drop out on
    ejection and return once its successor is re-admitted."""
    model_dir = _save_scale_model(tmp_path / "model")
    fleet = _spawned_fleet(model_dir, tmp_path, n=3)
    fleet.start()
    try:
        fleet.wait_ready(timeout=180)
        with ServingClient(f"127.0.0.1:{fleet.port}", timeout=120.0) as c:
            for i in range(6):
                c.infer(_x(i))

            def replica_labels():
                snap = c.metrics(format="json")
                labels = set()
                for key in snap.get("engine_requests_total",
                                    {}).get("series", {}):
                    for part in key.split(","):
                        if part.startswith("replica="):
                            labels.add(part.split("=", 1)[1])
                return snap, labels

            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                snap, labels = replica_labels()
                series = snap.get("engine_requests_total",
                                  {}).get("series", {})
                seen = sum(v for k, v in series.items()
                           if "replica=fleet" in k)
                if {"r0", "r1", "r2", "fleet"} <= labels and seen >= 6:
                    break
                time.sleep(0.2)
            assert {"r0", "r1", "r2", "fleet"} <= labels, labels
            series = snap["engine_requests_total"]["series"]
            per = {r: sum(v for k, v in series.items()
                          if f"replica={r}" in k)
                   for r in ("r0", "r1", "r2")}
            merged = sum(v for k, v in series.items()
                         if "replica=fleet" in k)
            assert merged == sum(per.values()) and merged >= 6, series
            assert any("replica=" in k for k in
                       snap["engine_request_latency_seconds"]["series"])

            os.kill(fleet.replica(0).proc.pid, signal.SIGKILL)
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                _, labels = replica_labels()
                if "r0" not in labels:
                    break
                time.sleep(0.2)
            assert "r0" not in labels, labels

            fleet.wait_ready(timeout=180)
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                _, labels = replica_labels()
                if "r0" in labels:
                    break
                time.sleep(0.2)
            assert "r0" in labels, labels
        assert fleet.stats()["readmitted"] >= 1
    finally:
        fleet.stop(grace=15.0)


# ---------------------------------------------------------------------------
# the fleet verb: stitched trace, top, metrics --watch
# ---------------------------------------------------------------------------

def _fleet_cli(model_dir, port_file, *extra):
    return [sys.executable, "-m", "paddle_tpu_torch", "fleet", model_dir,
            "--replicas", "1", "--port-file", port_file,
            "--health-interval", "0.25", "--replica-arg=--device",
            "--replica-arg=cpu", *extra]


@pytest.mark.chaos
def test_stitched_trace_spans_three_processes(tmp_path, proc_guard,
                                              wait_port_file):
    """One infer through a ``fleet --profile`` gives one stitched Chrome
    trace with spans from three processes (client, frontend, replica)
    linked by flows on one trace id, clocks aligned."""
    model_dir = _save_scale_model(tmp_path / "model")
    port_file = str(tmp_path / "frontend.port")
    proc = proc_guard(
        _fleet_cli(model_dir, port_file, "--profile",
                   "--slo", "p99_ms=60000"),
        hard_timeout=300.0, env=_subproc_env(), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    endpoint = f"127.0.0.1:{wait_port_file(port_file, timeout=120.0)}"
    tprof.start_profiler()      # the client process's span log
    try:
        with ServingClient(endpoint, timeout=240.0) as c:
            out = c.infer(_x(4))
            tid = c.last_trace
            np.testing.assert_allclose(_fetch(out), SCALE * 4.0)
            doc = c.trace(tid)
        assert doc["id"] == tid
        remote = doc["processes"]
        roles = {p["role"] for p in remote}
        assert "frontend" in roles and any(r.startswith("replica")
                                           for r in roles), roles
        local = ttl.process_trace_doc(tid, role="client")
        assert local["spans"], "client recorded no spans"
        stitched = ttl.stitch_processes(remote + [local])
    finally:
        tprof.stop_profiler(quiet=True)
        tprof.reset_profiler()
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=120)
    events = stitched["traceEvents"]
    assert len({e["pid"] for e in events if e["ph"] == "X"}) >= 3
    flows = [e for e in events if e.get("id") == tid
             and e["ph"] in ("s", "t", "f")]
    assert {e["ph"] for e in flows} == {"s", "t", "f"}
    assert len({e["pid"] for e in flows}) >= 3, flows
    flow_spans = {e["args"]["span"] for e in flows}
    assert "client.request" in flow_spans
    assert "frontend.request" in flow_spans or "fleet.attempt" \
        in flow_spans
    assert {"engine.batch", "executor.run"} & flow_spans, flow_spans
    xs = [e for e in events if e["ph"] == "X"]
    client_span = next(e for e in xs if e["name"] == "client.request")
    exec_span = next(e for e in xs if e["name"] == "executor.run")
    assert client_span["ts"] <= exec_span["ts"]
    assert client_span["ts"] + client_span["dur"] >= \
        exec_span["ts"] + exec_span["dur"]


@pytest.mark.chaos
def test_fleet_cli_smoke_bounded(tmp_path, proc_guard, wait_port_file):
    """``python -m paddle_tpu_torch fleet`` boots one replica, answers an
    infer, renders under ``top --iterations`` and ``metrics --watch
    --count 2``, and prints its stats line on SIGTERM; the refused
    ``--compile-cache`` exits non-zero before binding anything."""
    model_dir = _save_scale_model(tmp_path / "model")
    with pytest.raises(SystemExit, match="XLA-only options"):
        cli_main(_fleet_cli(model_dir, str(tmp_path / "refused.port"),
                            "--compile-cache", str(tmp_path / "cc"))[3:])
    assert not (tmp_path / "refused.port").exists()
    port_file = str(tmp_path / "frontend.port")
    proc = proc_guard(
        _fleet_cli(model_dir, port_file), hard_timeout=240.0,
        env=_subproc_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    endpoint = f"127.0.0.1:{wait_port_file(port_file, timeout=60.0)}"
    out = tserving.infer_round_trip(endpoint, _x(4), timeout=240.0)
    np.testing.assert_allclose(_fetch(out), SCALE * 4.0)
    top, watch = (proc_guard(
        [sys.executable, "-m", "paddle_tpu_torch", *verb],
        hard_timeout=120.0, env=_subproc_env(), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for verb in (("top", endpoint, "--iterations", "2",
                      "--interval", "0.2"),
                     ("metrics", endpoint, "--watch", "0.2",
                      "--count", "2")))
    text = top.communicate(timeout=120)[0]
    assert top.returncode == 0, text
    assert f"fleet {endpoint}" in text, text
    assert "r0" in text and "healthy" in text
    assert "rps" in text and "p99_ms" in text
    text = watch.communicate(timeout=120)[0]
    assert watch.returncode == 0, text
    assert text.count(f"=== {endpoint} snapshot ") == 2, text
    assert "fleet_requests_total" in text
    proc.send_signal(signal.SIGTERM)
    stdout, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, stdout
    st = json.loads(stdout.strip().splitlines()[-1])
    assert st["fleet"] is True and sum(st["forwarded"].values()) >= 1


def test_top_renders_embedding_cache_line():
    stats = {"requests": 3, "queue_depth": 0, "dispatches": 1,
             "avg_batch": 3, "latency": {},
             "predictor": {"embedding_cache": {
                 "emb.w_0": {"hit_rate": 0.93, "budget_rows": 128,
                             "table_rows": 4096, "promotions": 7}}}}
    line = _render_embcache(stats["predictor"]["embedding_cache"])
    assert "hit_rate 0.93" in line and "128/4096" in line
    text, _ = _render_top("127.0.0.1:1", None, stats, {}, {}, 0.0)
    assert "embcache" in text


# ---------------------------------------------------------------------------
# generate: relay and replay across a SIGKILL
# ---------------------------------------------------------------------------

@pytest.mark.decode
def test_fleet_generate_relay(lm_dir, tmp_path):
    fleet = _spawned_fleet(lm_dir, tmp_path, n=2, health_interval=0.3)
    fleet.start()
    try:
        fleet.wait_ready(2, timeout=180)
        with ServingClient(f"127.0.0.1:{fleet.port}", timeout=120) as c:
            lines = list(c.generate_stream([3, 4, 5], max_new_tokens=6))
        assert lines[-1]["done"]
        assert [o["token"] for o in lines[:-1]] == lines[-1]["tokens"]
        assert len(lines[-1]["tokens"]) == 6
    finally:
        fleet.stop()


def _sigkill_chaos(lm_dir, tmp_path, replica_args=(), prompt_fn=None):
    """SIGKILL the replica carrying stream 0 once it has relayed two
    tokens: every stream completes unbroken, equal to an in-process
    engine's, and at least one retry happened.

    The victim is the replica the frontend relays stream 0 from (its
    ``relaying`` set).  A replica of this tiny model writes its ten
    tokens in a few ms, faster than a loaded client reads two, and a
    stream already in the socket buffers completes without a retry.  So
    every replica stops itself (SIGSTOP, the ``serve.stream_token@1+:stop``
    fault point) after each token line it writes: the victim is sent
    SIGCONT until the client holds two of stream 0's tokens, so it has
    written at most one line more than the client has read when it is
    killed, whatever the machine's load, while the other replicas are
    resumed as they stop."""
    prompt_fn = prompt_fn or (lambda i: [3, 4, 5 + i])
    n_streams, gen = 4, 10
    ref = tserving.DecodeEngine.from_model_dir(lm_dir, device="cpu",
                                               slots=n_streams, block_len=4)
    try:
        want = [ref.generate(prompt_fn(i), gen, timeout=60)["tokens"]
                for i in range(n_streams)]
    finally:
        ref.close()
    # the paced victim is stopped most of the time: a probe must wait
    # for it rather than eject it (and retry stream 0 elsewhere) first
    env = dict(_subproc_env(),
               FLAGS_fault_points="serve.stream_token@1+:stop")
    fleet = _spawned_fleet(lm_dir, tmp_path, n=2, health_interval=0.3,
                           replica_args=replica_args, probe_timeout=120.0,
                           spawn_env=env)
    fleet.start()
    done = threading.Event()

    def cont(pid):
        try:
            os.kill(pid, signal.SIGCONT)
        except OSError:
            pass

    def resume_others(victim_pid):
        while not done.wait(0.001):
            for r in list(fleet.replicas):
                if r.proc is not None and r.proc.pid != victim_pid:
                    cont(r.proc.pid)

    resumer = None
    try:
        fleet.wait_ready(2, timeout=180)
        results = [None] * n_streams
        streamed = [[] for _ in range(n_streams)]
        seen = [threading.Event() for _ in range(gen + 1)]

        def client(i):
            with ServingClient(f"127.0.0.1:{fleet.port}",
                               timeout=120) as c:
                for obj in c.generate_stream(prompt_fn(i),
                                             max_new_tokens=gen):
                    if obj.get("done"):
                        results[i] = obj
                        continue
                    streamed[i].append(obj["token"])
                    if i == 0:
                        seen[len(streamed[0])].set()

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_streams)]
        threads[0].start()
        deadline = time.monotonic() + 60
        victim = None
        while victim is None and time.monotonic() < deadline:
            victim = next((r for r in fleet.replicas if r.relaying), None)
            time.sleep(0.001)
        assert victim is not None, "stream 0 was never relayed"
        victim_pid = victim.proc.pid
        resumer = threading.Thread(target=resume_others, args=(victim_pid,),
                                   daemon=True)
        resumer.start()
        for t in threads[1:]:
            t.start()
        while not seen[2].is_set() and time.monotonic() < deadline:
            have = len(streamed[0])
            cont(victim_pid)
            seen[have + 1].wait(0.05)
        assert seen[2].is_set(), "stream 0 never relayed two tokens"
        os.kill(victim_pid, signal.SIGKILL)
        for t in threads:
            t.join(timeout=300)
        for i in range(n_streams):
            assert results[i] is not None, f"stream {i} never finished"
            assert streamed[i] == results[i]["tokens"] == want[i], i
        assert int(fleet._m_retries.value) >= 1
    finally:
        done.set()
        if resumer is not None:
            resumer.join(timeout=10)
        for r in list(fleet.replicas):
            if r.proc is not None:
                cont(r.proc.pid)
        fleet.stop()


@pytest.mark.decode
@pytest.mark.chaos
def test_fleet_generate_sigkill_zero_dropped_streams(lm_dir, tmp_path):
    _sigkill_chaos(lm_dir, tmp_path)


@pytest.mark.decode
@pytest.mark.chaos
def test_fleet_sigkill_replay_with_prefix_cache(lm_dir, tmp_path):
    """The replay survives a prefix cache over a shared prompt head: a
    retry that lands on a replica whose radix tree already holds the
    head from other streams reproduces its tokens exactly."""
    _sigkill_chaos(
        lm_dir, tmp_path,
        replica_args=("--decode-block-len", "4",
                      "--decode-prefix-cache-blocks", "8"),
        prompt_fn=lambda i: [3, 4, 5, 6, 10 + i])
