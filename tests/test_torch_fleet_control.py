"""The port's fleet control plane against the JAX package's: the
autoscaling policy, the checkpoint -> serving publisher and its delta
chain, the health-gated rolling watcher and the trace-driven load
generator.

- Parity: `parse_autoscale_spec` gives the JAX dicts and errors;
  `Autoscaler.evaluate_once` takes the JAX policy's decisions over the
  same store samples on the same clock; `build_schedule` gives the JAX
  schedule for the same phases and seed.
- Twins of every test of ``tests/test_fleet_control.py``: the store's
  cold-read sentinels, the policy's full cycle on a fake fleet, the
  load generator against a live server, the publisher's round trip and
  error paths, the delta chain at cache rows 0 and 16, and the
  watcher's roll, no-op, mid-roll restart, rollback and delta roll
  under load over in-process port replicas; one ``chaos`` test scales a
  fleet of spawned port replicas up and down.
"""
import re
import shutil
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from paddle_tpu.fleet_control import (Autoscaler as JAutoscaler,
                                      build_schedule as j_build_schedule,
                                      parse_autoscale_spec as j_parse)
from paddle_tpu.observability import (MetricsRegistry as JRegistry,
                                      TimeSeriesStore as JStore)

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import fault, io as tio, layers as tlayers
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.checkpoint import CheckpointManager
from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard
from paddle_tpu_torch.fleet_control import (Autoscaler, CheckpointWatcher,
                                            LoadGenerator, ModelPublisher,
                                            build_schedule,
                                            parse_autoscale_spec)
from paddle_tpu_torch.observability import MetricsRegistry, TimeSeriesStore
from paddle_tpu_torch.serving import (FleetFrontend, InferenceServer,
                                      ServingClient)
from paddle_tpu_torch.serving.registry import read_manifest

from tests.test_torch_fleet import (SCALE, _fetch, _save_scale_model,
                                    _scale_server, _subproc_env, _x)


# ---------------------------------------------------------------------------
# the store's cold-read sentinels
# ---------------------------------------------------------------------------

def test_store_cold_read_sentinels():
    reg = MetricsRegistry()
    store = TimeSeriesStore(registry=reg, interval_s=1.0)
    assert store.rollup("fleet_route_latency_seconds") == {}
    assert store.rollup("anything", match={"quantile": "0.99"}) == {}
    assert store.window_delta("fleet_shed_total") == 0.0
    g = reg.gauge("g", "g")
    g.set(1.0)
    store.sample_once(now=1000.0)
    assert store.rollup("g", match={"quantile": "0.99"}, now=1000.0) == {}
    assert store.rollup("g", window_s=5.0, now=2000.0) == {}
    assert store.window_delta("nope", now=1000.0) == 0.0


# ---------------------------------------------------------------------------
# --autoscale spec parsing
# ---------------------------------------------------------------------------

def test_parse_autoscale_spec():
    spec = parse_autoscale_spec(
        "min=1,max=4,slo=p99_ms=100:avail=0.999,cooldown_up_s=5")
    assert spec["min"] == 1 and spec["max"] == 4
    assert spec["slo"]["p99_ms"] == 100.0
    assert spec["slo"]["avail"] == 0.999
    assert spec["cooldown_up_s"] == 5.0


BAD_SPECS = ["min=1", "max=4", "min=0,max=2", "min=3,max=2",
             "min=1,max=2,typo=5", "min=1,max=2,queue_high"]


@pytest.mark.parametrize("bad", BAD_SPECS)
def test_parse_autoscale_spec_rejects(bad):
    with pytest.raises(ValueError):
        parse_autoscale_spec(bad)


@pytest.mark.parametrize("spec", [
    "min=1,max=4,slo=p99_ms=100:avail=0.999,cooldown_up_s=5",
    "min=2,max=2", ",min=1,,max=3,queue_high=2.5,window_s=7,idle_s=9,"
    "cooldown_down_s=11", "min=1,max=2,slo=avail=0.5"] + BAD_SPECS)
def test_parse_autoscale_spec_matches_jax(spec):
    def parse(fn):
        try:
            return ("ok", fn(spec))
        except ValueError as e:
            return ("error", str(e))
    assert parse(parse_autoscale_spec) == parse(j_parse)


# ---------------------------------------------------------------------------
# autoscaler policy (a fake fleet, a real store, explicit clocks)
# ---------------------------------------------------------------------------

class _FakeFleet:
    """Duck-typed fleet: a real TimeSeriesStore over a private registry,
    list-backed replicas, instant scale actuators."""

    def __init__(self, registry_cls=MetricsRegistry,
                 store_cls=TimeSeriesStore):
        self.registry = registry_cls()
        self.timeseries = store_cls(registry=self.registry, interval_s=1.0)
        self.metrics = self.registry
        self.autoscaler = None
        self._reps = [SimpleNamespace(state="healthy", name="r0")]
        self._n = 1

    @property
    def replicas(self):
        return list(self._reps)

    def healthy_count(self):
        return sum(1 for r in self._reps if r.state == "healthy")

    def scale_up(self):
        rep = SimpleNamespace(state="starting", name=f"r{self._n}")
        self._n += 1
        self._reps.append(rep)
        return rep

    def scale_down(self, rid=None, drain_grace=10.0):
        return self._reps.pop() if self._reps else None


def _wired_fake(scaler_cls=Autoscaler, registry_cls=MetricsRegistry,
                store_cls=TimeSeriesStore, **kw):
    fleet = _FakeFleet(registry_cls, store_cls)
    lat = fleet.registry.gauge("fleet_route_latency_seconds", "t",
                               labelnames=("quantile",))
    reqs = fleet.registry.counter("fleet_requests_total", "t",
                                  labelnames=("model",))
    for key, val in (("p99_ms", 100.0), ("queue_high", 4.0),
                     ("window_s", 5.0), ("idle_s", 20.0),
                     ("breach_after", 2), ("clear_after", 2),
                     ("cooldown_up_s", 10.0), ("cooldown_down_s", 30.0)):
        kw.setdefault(key, val)
    scaler = scaler_cls(fleet, registry=fleet.registry, **kw)
    assert fleet.autoscaler is scaler
    return fleet, scaler, lat.labels(quantile="0.99"), reqs.labels(
        model="default")


def _full_cycle(scaler_cls=Autoscaler, registry_cls=MetricsRegistry,
                store_cls=TimeSeriesStore):
    """The policy's whole life on a deterministic clock; -> (scaler,
    fleet, every decision record)."""
    fleet, scaler, lat, reqs = _wired_fake(
        scaler_cls, registry_cls, store_cls, min_replicas=1,
        max_replicas=3)
    records = []

    def tick(t):
        if t < 1020.0:
            reqs.inc()      # traffic flows while the latency is read
        fleet.timeseries.sample_once(now=t)
        records.append(dict(scaler.last))

    lat.set(0.020)
    tick(1000.0)
    tick(1001.0)
    lat.set(0.500)
    tick(1002.0)
    tick(1003.0)
    tick(1004.0)
    tick(1005.0)
    fleet._reps[1].state = "healthy"
    tick(1006.0)
    tick(1007.0)
    tick(1014.0)
    fleet._reps[2].state = "healthy"
    tick(1015.0)
    tick(1016.0)
    lat.set(0.010)
    for t in (1040.0, 1041.0, 1046.0, 1047.0, 1048.0, 1077.0, 1078.0,
              1079.0):
        tick(t)
    return scaler, fleet, records


def test_autoscaler_full_cycle_with_hysteresis():
    """calm -> breach (debounced) -> scale-up -> boot gate -> cooldown
    -> second scale-up -> hold_max -> idle (debounced + down cooldown)
    -> two scale-downs -> hold_min; every tick in the flight ring."""
    scaler, fleet, records = _full_cycle()
    decisions = [r["decision"] for r in records]
    # each action resets its streak: the tick after it holds
    assert decisions == [
        "hold", "hold", "hold", "scale_up", "hold", "await_boot",
        "cooldown", "cooldown", "scale_up", "hold", "hold_max",
        "hold", "cooldown", "scale_down", "hold", "cooldown",
        "scale_down", "hold", "hold_min"]
    assert records[0]["reason"] == "-" and records[2]["reason"] == "p99"
    assert len(fleet.replicas) == 1
    d = scaler.describe()
    assert d["scale_ups"] == 2 and d["scale_downs"] == 2
    assert d["state"] == "hold_min"
    assert d["min"] == 1 and d["max"] == 3
    records = scaler.flight.records()
    assert len(records) == 19
    assert [r["decision"] for r in records].count("scale_up") == 2


def test_autoscaler_takes_the_jax_decisions():
    """The same samples on the same clock through both packages' store
    and policy: every decision record (decision, reason, replicas,
    healthy, cooldown, signals) and the describe() section equal."""
    port, _, port_records = _full_cycle()
    jax, _, jax_records = _full_cycle(JAutoscaler, JRegistry, JStore)
    assert port_records == jax_records
    assert port.describe() == jax.describe()
    for cls, reg_cls, store_cls in ((Autoscaler, MetricsRegistry,
                                     TimeSeriesStore),
                                    (JAutoscaler, JRegistry, JStore)):
        fleet, scaler, _, _ = _wired_fake(cls, reg_cls, store_cls)
        shed = fleet.registry.counter("fleet_shed_total", "t",
                                      labelnames=("reason",))
        fleet.registry.gauge("fleet_inflight", "t").set(50.0)
        shed.labels(reason="unavailable").inc(3)
        fleet.timeseries.sample_once(now=2000.0)
        if cls is Autoscaler:
            port_last = scaler.last
        else:
            assert scaler.last == port_last


def test_autoscaler_ignores_a_stale_p99():
    """A p99 gauge left over the SLO by a burst is pressure only while
    requests arrive: once the window saw none, an idle fleet at max
    scales down.  The JAX policy counts the stale tail and holds at max
    (``hold_max``) for as long as the fleet stays idle."""
    out = {}
    for cls, reg_cls, store_cls in ((Autoscaler, MetricsRegistry,
                                     TimeSeriesStore),
                                    (JAutoscaler, JRegistry, JStore)):
        fleet, scaler, lat, reqs = _wired_fake(
            cls, reg_cls, store_cls, min_replicas=1, max_replicas=2)
        fleet._reps.append(SimpleNamespace(state="healthy", name="r1"))
        lat.set(0.500)
        decisions = []
        for t in (1000.0, 1001.0, 1002.0, 1003.0, 1010.0, 1030.0, 1031.0):
            if t < 1005.0:
                reqs.inc()
            fleet.timeseries.sample_once(now=t)
            decisions.append(scaler.last["decision"])
            assert scaler.last["signals"]["p99_ms"] == 500.0
        out[cls] = (decisions, len(fleet.replicas))
    assert out[Autoscaler] == (
        ["hold", "hold_max", "hold_max", "hold_max", "hold", "hold",
         "scale_down"], 1)
    assert out[JAutoscaler] == (["hold"] + ["hold_max"] * 6, 2)


def test_autoscaler_pressure_reasons_shed_and_queue():
    fleet, scaler, lat, reqs = _wired_fake()
    shed = fleet.registry.counter("fleet_shed_total", "t",
                                  labelnames=("reason",))
    infl = fleet.registry.gauge("fleet_inflight", "t")
    shed.labels(reason="unavailable").inc(3)
    infl.set(50.0)
    fleet.timeseries.sample_once(now=2000.0)
    assert scaler.last["reason"] == "shed,queue"
    assert scaler.last["signals"]["shed_delta"] == 3.0
    assert scaler.last["signals"]["inflight_mean"] == 50.0


def test_autoscaler_restores_floor_without_debounce():
    fleet, scaler, _, _ = _wired_fake(min_replicas=2, max_replicas=3)
    fleet._reps = []
    fleet.timeseries.sample_once(now=3000.0)
    assert scaler.last["decision"] == "scale_up"
    assert scaler.last["reason"] == "below_min"
    assert len(fleet.replicas) == 1
    fleet.timeseries.sample_once(now=3001.0)
    assert scaler.last["decision"] == "await_boot"
    fleet._reps[0].state = "healthy"
    fleet.timeseries.sample_once(now=3002.0)
    assert len(fleet.replicas) == 2


def test_autoscaler_close_detaches_hook():
    fleet, scaler, _, _ = _wired_fake()
    assert scaler.evaluate_once in fleet.timeseries.on_sample
    scaler.close()
    assert scaler.evaluate_once not in fleet.timeseries.on_sample
    n = scaler.last
    fleet.timeseries.sample_once(now=4000.0)
    assert scaler.last == n


def test_autoscaler_rejects_bad_ranges():
    fleet = _FakeFleet()
    with pytest.raises(ValueError):
        Autoscaler(fleet, min_replicas=0)
    with pytest.raises(ValueError):
        Autoscaler(fleet, min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError):
        Autoscaler(fleet, p99_ms=-5.0)


# ---------------------------------------------------------------------------
# load generator
# ---------------------------------------------------------------------------

PHASES = [{"duration_s": 10.0, "rps": 5.0},
          {"duration_s": 10.0, "rps": 5.0, "burst_x": 3.0,
           "generate_fraction": 0.5},
          {"duration_s": 10.0, "rps": 1.0, "end_rps": 9.0}]


def test_build_schedule_deterministic_and_shaped():
    a = build_schedule(PHASES, seed=16)
    assert a == build_schedule(PHASES, seed=16)
    assert a != build_schedule(PHASES, seed=17)
    assert all(a[i][0] <= a[i + 1][0] for i in range(len(a) - 1))
    assert 0.0 < a[0][0] and a[-1][0] < 30.0
    flat = [p for p in a if p[0] < 10.0]
    burst = [p for p in a if 10.0 <= p[0] < 20.0]
    assert 2.0 * len(flat) < len(burst) < 4.0 * len(flat)
    assert all(k == "infer" for _, k in flat)
    assert {k for _, k in burst} == {"infer", "generate"}


@pytest.mark.parametrize("seed", [0, 16, 31])
def test_build_schedule_byte_identical_to_jax(seed):
    phases = PHASES + [{"duration_s": 3.0, "rps": 20.0, "burst_x": 8.0},
                       {"duration_s": 2.0, "rps": 0.0}]
    a, b = build_schedule(phases, seed), j_build_schedule(phases, seed)
    assert repr(a) == repr(b) and len(a) > 100


def test_loadgen_replays_against_live_server():
    srv = _scale_server()
    try:
        sched = build_schedule(
            [{"duration_s": 1.2, "rps": 40.0, "generate_fraction": 0.25}],
            seed=3)
        lg = LoadGenerator(f"127.0.0.1:{srv.port}", sched,
                           feed={"x": np.ones((1, 2), np.float32)},
                           retries=0, timeout=20.0)
        report = lg.run()
    finally:
        srv.stop()
    assert report["offered"] == len(sched) > 20
    assert report["ok"] == report["offered"]
    assert report["shed"] == 0 and report["errors"] == 0
    assert report["shed_rate"] == 0.0
    assert report["achieved_rps"] > 0
    assert 0 < report["latency_p50_ms"] <= report["latency_p99_ms"]
    assert set(report["by_kind"]) == {"infer", "generate"}
    assert sum(report["by_kind"].values()) == report["offered"]


# ---------------------------------------------------------------------------
# publisher: checkpoint -> serving artifact
# ---------------------------------------------------------------------------

def _arrays(scope):
    return {n: np.asarray(scope.get(n)).copy()
            for n in scope.local_var_names() if scope.get(n) is not None}


def _save_fc_model(dirname):
    """4 -> 3 softmax fc saved by the port (persistable params, so the
    manifest fingerprint tracks the weight bytes); -> (dir, params)."""
    main, startup, scope = tfluid.Program(), tfluid.Program(), Scope()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard(), \
            scope_guard(scope):
        x = tlayers.data(name="x", shape=[4], dtype="float32")
        y = tlayers.fc(input=x, size=3, act="softmax")
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        tio.save_inference_model(str(dirname), ["x"], [y], exe,
                                 main_program=main)
        return str(dirname), _arrays(scope)


def test_publisher_roundtrip_fingerprint_and_scope_isolation(tmp_path):
    model_dir, params = _save_fc_model(tmp_path / "model")
    w0, b0 = params["fc_0.w_0"], params["fc_0.b_0"]
    fp0 = read_manifest(model_dir)["fingerprint"]
    ckpt = str(tmp_path / "ckpts")
    mgr = CheckpointManager(ckpt, async_save=False)
    mgr.save(1, {"fc_0.w_0": w0 * 1.5, "fc_0.b_0": b0 + 1.0,
                 "adam_moment_not_in_graph": np.ones(4, np.float32)},
             block=True)
    sentinel = np.full_like(w0, 7.0)
    global_scope().set("fc_0.w_0", sentinel)

    pub = ModelPublisher(ckpt, model_dir)
    assert pub.latest_step() == 1
    assert pub.published() == {}
    res = pub.publish()
    assert res["step"] == 1 and res["changed"] is True
    fp1 = res["fingerprint"]
    assert fp1 and fp1 != fp0
    assert pub.published_fingerprint() == fp1
    rec = pub.published()
    assert rec["step"] == 1
    assert rec["previous"]["fingerprint"] == fp0
    assert sorted(rec["vars"]) == ["fc_0.b_0", "fc_0.w_0"]
    # a private scope: the process's global scope is untouched
    assert global_scope().get("fc_0.w_0") is sentinel
    np.testing.assert_array_equal(np.load(f"{model_dir}/fc_0.w_0.npy"),
                                  w0 * 1.5)
    res2 = pub.publish(1)
    assert res2["changed"] is False and res2["fingerprint"] == fp1


def test_publisher_error_paths(tmp_path):
    model_dir, _ = _save_fc_model(tmp_path / "model")
    empty = ModelPublisher(str(tmp_path / "no_ckpts"), model_dir)
    assert empty.latest_step() is None
    with pytest.raises(FileNotFoundError):
        empty.publish()
    mgr = CheckpointManager(str(tmp_path / "ck2"), async_save=False)
    mgr.save(7, {"some_other_var": np.ones(2, np.float32)}, block=True)
    with pytest.raises(ValueError):
        ModelPublisher(str(tmp_path / "ck2"), model_dir).publish()


# ---------------------------------------------------------------------------
# watcher: health-gated rolling reload over an in-process fleet
# ---------------------------------------------------------------------------

def _count_reloads(reg, counts, key):
    orig = reg.reload

    def wrapped(name):
        counts[key] = counts.get(key, 0) + 1
        return orig(name)

    reg.reload = wrapped


@pytest.fixture
def rolling_fleet(tmp_path):
    """Two registry-backed in-process replicas serving one fc model dir,
    adopted by a frontend, with the checkpoint/publisher plumbing."""
    model_dir, params = _save_fc_model(tmp_path / "model")
    servers, regs = [], []
    for _ in range(2):
        reg = tserving.ModelRegistry(device="cpu")
        reg.load("default", model_dir,
                 engine_opts={"max_queue_delay_ms": 1})
        servers.append(InferenceServer(reg, port=0, port_file=None).start())
        regs.append(reg)
    fleet = FleetFrontend(
        replica_endpoints=[f"127.0.0.1:{s.port}" for s in servers],
        health_interval=0.1, route_timeout=5.0, probe_timeout=2.0)
    fleet.start().wait_ready(timeout=20)
    ckpt = str(tmp_path / "ckpts")
    yield SimpleNamespace(fleet=fleet, servers=servers, regs=regs,
                          model_dir=model_dir,
                          mgr=CheckpointManager(ckpt, async_save=False),
                          pub=ModelPublisher(ckpt, model_dir),
                          w0=params["fc_0.w_0"], b0=params["fc_0.b_0"])
    fault.reset()
    fleet.stop(grace=5.0)
    for s in servers:
        try:
            s.stop()
        except Exception:  # noqa: BLE001 — already stopped
            pass
    for reg in regs:
        reg.close()


def _served_fps(ctx):
    out = []
    for s in ctx.servers:
        with ServingClient(f"127.0.0.1:{s.port}") as c:
            out.append(c.models()["models"]["default"]
                       ["manifest_fingerprint"])
    return out


@pytest.mark.chaos
def test_watcher_rolls_noops_and_survives_midroll_restart(rolling_fleet):
    ctx = rolling_fleet
    counts = {}
    for i, reg in enumerate(ctx.regs):
        _count_reloads(reg, counts, f"r{i}")
    watcher = CheckpointWatcher(ctx.fleet, ctx.pub, poll_interval=0.1,
                                health_timeout=20.0,
                                registry=MetricsRegistry())
    fp0 = read_manifest(ctx.model_dir)["fingerprint"]
    assert watcher.poll_once() is None

    ctx.mgr.save(1, {"fc_0.w_0": ctx.w0 * 2.0, "fc_0.b_0": ctx.b0},
                 block=True)
    result = watcher.poll_once()
    assert result["outcome"] == "ok" and result["step"] == 1
    assert len(result["rolled"]) == 2 and result["failed"] is None
    fp1 = ctx.pub.published_fingerprint()
    assert fp1 != fp0
    assert _served_fps(ctx) == [fp1, fp1]
    assert counts == {"r0": 1, "r1": 1}
    with ServingClient(f"127.0.0.1:{ctx.fleet.port}") as c:
        out = c.infer({"x": np.ones((1, 4), np.float32)})
        assert _fetch(out).shape == (1, 3)

    # identical bytes: a fleet-wide no-op, no replica drained
    ctx.mgr.save(2, {"fc_0.w_0": ctx.w0 * 2.0, "fc_0.b_0": ctx.b0},
                 block=True)
    result = watcher.poll_once()
    assert result["outcome"] == "noop"
    assert result["rolled"] == [] and len(result["skipped"]) == 2
    assert counts == {"r0": 1, "r1": 1}
    assert ctx.pub.published().get("step") == 2

    # the watcher dies between replicas; a fresh one resumes
    ctx.mgr.save(3, {"fc_0.w_0": ctx.w0 * 3.0, "fc_0.b_0": ctx.b0},
                 block=True)
    fault.arm("watcher.roll@2:raise")
    with pytest.raises(fault.FaultInjected):
        watcher.poll_once()
    fault.reset()
    fp3 = ctx.pub.published_fingerprint()
    assert _served_fps(ctx).count(fp3) == 1
    restarted = CheckpointWatcher(ctx.fleet, ctx.pub, poll_interval=0.1,
                                  health_timeout=20.0,
                                  registry=MetricsRegistry())
    result = restarted.poll_once()
    assert result["outcome"] == "ok"
    assert len(result["rolled"]) == 1 and len(result["skipped"]) == 1
    assert _served_fps(ctx) == [fp3, fp3]
    assert counts == {"r0": 2, "r1": 2}


@pytest.mark.chaos
def test_watcher_failed_health_gate_rolls_back(rolling_fleet):
    ctx = rolling_fleet
    watcher = CheckpointWatcher(ctx.fleet, ctx.pub, poll_interval=0.1,
                                health_timeout=20.0,
                                registry=MetricsRegistry())
    ctx.mgr.save(1, {"fc_0.w_0": ctx.w0 * 2.0, "fc_0.b_0": ctx.b0},
                 block=True)
    assert watcher.poll_once()["outcome"] == "ok"
    fp1 = ctx.pub.published_fingerprint()
    ctx.mgr.save(2, {"fc_0.w_0": ctx.w0 * 0.5, "fc_0.b_0": ctx.b0},
                 block=True)
    fault.arm("watcher.health_gate@1:raise")
    result = watcher.poll_once()
    fault.reset()
    assert result["outcome"] == "rollback"
    assert result["failed"] is not None
    assert ctx.pub.published_fingerprint() == fp1
    assert _served_fps(ctx) == [fp1, fp1]
    rec = ctx.pub.published()
    assert rec["step"] == 1 and rec["rolled_back_from"] == 2
    assert watcher.poll_once() is None
    ctx.mgr.save(3, {"fc_0.w_0": ctx.w0 * 4.0, "fc_0.b_0": ctx.b0},
                 block=True)
    result = watcher.poll_once()
    assert result["outcome"] == "ok" and result["step"] == 3
    assert ctx.pub.published_fingerprint() != fp1


# ---------------------------------------------------------------------------
# the real actuator path + the stats/top surface
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_autoscaler_scales_real_fleet_and_rides_stats(tmp_path):
    """Shed pressure on a one-replica fleet of spawned port replicas buys
    a second replica; sustained idle retires it; the policy state rides
    ``stats()["autoscaler"]`` and ``top``."""
    from paddle_tpu_torch.__main__ import _render_top

    model_dir = _save_scale_model(tmp_path / "model")
    fleet = FleetFrontend(
        [("default", model_dir)], replicas=1,
        run_dir=str(tmp_path / "fleet_run"), spawn_env=_subproc_env(),
        replica_args=("--device", "cpu"), health_interval=0.25,
        route_timeout=10.0, spawn_timeout=120.0, sample_interval=0.25)
    try:
        fleet.start().wait_ready(timeout=180)
        scaler = Autoscaler(fleet, min_replicas=1, max_replicas=2,
                            p99_ms=None, queue_high=1e9,
                            window_s=0.75, idle_s=1.0,
                            breach_after=1, clear_after=2,
                            cooldown_up_s=0.2, cooldown_down_s=2.0)
        deadline = time.monotonic() + 120.0
        while fleet.healthy_count() < 2 and time.monotonic() < deadline:
            fleet._m_shed.labels(reason="unavailable").inc()
            time.sleep(0.2)
        assert fleet.healthy_count() == 2, scaler.last
        assert len(fleet.replicas) == 2
        st = fleet.stats()
        asc = st["autoscaler"]
        assert asc["scale_ups"] == 1 and asc["replicas"] == 2
        assert asc["min"] == 1 and asc["max"] == 2
        assert asc["last_decision"]["decision"] in (
            "scale_up", "await_boot", "hold", "cooldown", "hold_max")
        text, _ = _render_top(f"127.0.0.1:{fleet.port}", fleet.describe(),
                              st, {}, {}, time.time())
        assert "autoscaler [1..2]" in text
        with ServingClient(f"127.0.0.1:{fleet.port}") as c:
            np.testing.assert_allclose(_fetch(c.infer(_x(3))), SCALE * 3)
        deadline = time.monotonic() + 90.0
        while len(fleet.replicas) != 1 and time.monotonic() < deadline:
            time.sleep(0.1)
        assert len(fleet.replicas) == 1, scaler.last
        assert fleet.stats()["autoscaler"]["scale_downs"] == 1
        with ServingClient(f"127.0.0.1:{fleet.port}") as c:
            c.infer(_x(1))
    finally:
        fleet.stop(grace=10.0)


# ---------------------------------------------------------------------------
# streaming embedding deltas
# ---------------------------------------------------------------------------

def _save_emb_model(dirname, v=64, d=8):
    """embedding -> sum pool -> fc scorer; -> (dir, params)."""
    main, startup, scope = tfluid.Program(), tfluid.Program(), Scope()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard(), \
            scope_guard(scope):
        words = tlayers.data(name="words", shape=[1], dtype="int64",
                             lod_level=1)
        emb = tlayers.embedding(input=words, size=[v, d], is_sparse=True,
                                is_distributed=True)
        pooled = tlayers.sequence_pool(emb, pool_type="sum")
        pred = tlayers.fc(input=pooled, size=4, act="softmax")
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        tio.save_inference_model(str(dirname), ["words"], [pred], exe,
                                 main_program=main)
        return str(dirname), _arrays(scope)


@pytest.mark.parametrize("cache_rows", [0, 16])
def test_publish_deltas_chain_applies_live(tmp_path, cache_rows):
    """A trainer row-delta rolls onto a loaded model without a reload:
    the publisher chains ``__delta__.json`` and npz payloads, the
    registry applies them to the live predictor (device table and
    hot-row cache alike), replies equal the full republish bitwise, the
    delta-rows counter moves with zero reloads, and a lineage break
    reads as stale."""
    from paddle_tpu_torch.observability import (default_registry,
                                                render_prometheus)

    mdir, params = _save_emb_model(tmp_path / "model")
    table = [n for n in params if n.startswith("embedding_")][0]
    mgr = CheckpointManager(str(tmp_path / "ckpts"), async_save=False)
    mgr.save(1, params, block=True)
    pub = ModelPublisher(str(tmp_path / "ckpts"), mdir)
    pub.publish(1)

    def _delta_rows(text):
        m = re.search(r'embedding_delta_rows_total\{model="rec"\} '
                      r'(\d+)', text)
        return int(m.group(1)) if m else 0

    obs = default_registry()
    was_enabled = obs.enabled
    obs.enable()
    rows_before = _delta_rows(render_prometheus())
    reg = tserving.ModelRegistry(device="cpu")
    counts = {}
    _count_reloads(reg, counts, "r0")
    try:
        kw = {"embedding_cache_rows": cache_rows} if cache_rows else {}
        reg.load("rec", mdir, warmup=[], **kw)
        if cache_rows:
            assert reg.get("rec").predictor._row_caches
        rng = np.random.RandomState(0)
        feed = {"words": rng.randint(0, 64, (6, 5)).astype(np.int64),
                "words@SEQ_LEN": np.full((6,), 5, np.int32)}
        base_out = np.asarray(reg.infer("rec", dict(feed))[0])
        assert reg.apply_deltas("rec")["applied"] is False

        p2 = {n: a.copy() for n, a in params.items()}
        hot = rng.choice(64, 10, replace=False)
        p2[table][hot] += 1.5
        mgr.save(2, p2, block=True)
        res = pub.publish_deltas()
        assert res["seq"] == 1 and res["rows_total"] == 10
        assert list(res["tables"]) == [table]
        d = reg.apply_deltas("rec")
        assert d == {"applied": True, "stale": False, "seq": 1,
                     "step": 2, "rows": 10}
        assert reg.apply_deltas("rec")["applied"] is False
        assert reg.get("rec").describe()["delta_seq"] == 1

        mdir2 = str(tmp_path / "model2")
        shutil.copytree(mdir, mdir2)
        ModelPublisher(str(tmp_path / "ckpts"), mdir2).publish(2)
        ref = tserving.Predictor.from_model_dir(mdir2, device="cpu").run(
            dict(feed))[0]
        got = np.asarray(reg.infer("rec", dict(feed))[0])
        assert got.tobytes() == np.asarray(ref).tobytes()
        assert got.tobytes() != base_out.tobytes()

        p3 = {n: a.copy() for n, a in p2.items()}
        p3[table][:3] -= 0.25
        mgr.save(3, p3, block=True)
        assert pub.publish_deltas()["seq"] == 2
        d3 = reg.apply_deltas("rec")
        assert d3["applied"] is True and d3["seq"] == 2 and d3["rows"] == 3
        assert _delta_rows(render_prometheus()) == rows_before + 13
        assert counts == {}

        reg2 = tserving.ModelRegistry(device="cpu")
        reg2.load("rec", mdir, warmup=[], **kw)
        ds = reg2.apply_deltas("rec")
        assert ds["stale"] is True and ds["applied"] is False
        reg2.close()
    finally:
        reg.close()
        if not was_enabled:
            obs.disable()


@pytest.mark.chaos
def test_watcher_delta_roll_under_load(rolling_fleet):
    """The watcher's delta poll patches both live replicas while a
    LoadGenerator replays traffic through the frontend: zero requests
    shed or errored, zero reloads, the second poll a no-op, and the
    fleet serving the step-2 bytes afterwards."""
    ctx = rolling_fleet
    counts = {}
    for i, reg in enumerate(ctx.regs):
        _count_reloads(reg, counts, f"r{i}")
    watcher = CheckpointWatcher(ctx.fleet, ctx.pub, poll_interval=0.1,
                                health_timeout=20.0,
                                registry=MetricsRegistry())
    ctx.mgr.save(1, {"fc_0.w_0": ctx.w0, "fc_0.b_0": ctx.b0}, block=True)
    ctx.pub.publish(1)
    assert watcher.poll_deltas_once() is None

    sched = build_schedule([{"duration_s": 1.5, "rps": 40.0}], seed=3)
    lg = LoadGenerator(f"127.0.0.1:{ctx.fleet.port}", sched,
                       feed={"x": np.ones((1, 4), np.float32)},
                       retries=0, timeout=20.0)
    box = {}
    t = threading.Thread(target=lambda: box.update(report=lg.run()))
    t.start()
    try:
        w2 = ctx.w0.copy()
        w2[[0, 2]] += 0.5
        ctx.mgr.save(2, {"fc_0.w_0": w2, "fc_0.b_0": ctx.b0}, block=True)
        assert ctx.pub.publish_deltas()["rows_total"] == 2
        result = watcher.poll_deltas_once()
        assert result["outcome"] == "ok", result
        assert len(result["applied"]) == 2
        assert result["reloaded"] == [] and result["failed"] is None
        assert watcher.last_delta_roll["seq"] == 1
    finally:
        t.join(timeout=60)
    assert not t.is_alive()
    report = box["report"]
    assert report["ok"] == report["offered"] == len(sched)
    assert report["shed"] == 0 and report["errors"] == 0
    assert counts == {}
    again = watcher.poll_deltas_once()
    assert again["outcome"] == "noop"
    assert len(again["skipped"]) == 2 and again["applied"] == []

    mdir2 = str(ctx.model_dir) + "-full"
    shutil.copytree(ctx.model_dir, mdir2)
    ModelPublisher(ctx.pub.checkpoint_dir, mdir2).publish(2)
    ref = tserving.Predictor.from_model_dir(mdir2, device="cpu").run(
        {"x": np.ones((1, 4), np.float32)})[0]
    for s in ctx.servers:
        with ServingClient(f"127.0.0.1:{s.port}") as c:
            out = c.infer({"x": np.ones((1, 4), np.float32)})
            got = np.asarray(_fetch(out), np.float32)
            assert got.tobytes() == np.asarray(ref, np.float32).tobytes()
