"""The port's time-series store, SLO monitor and snapshot tools against
the JAX package's: the same registry updates, sampled at the same
injected ``now``, give equal `query` / `rollup` / `window_delta`
results and equal ``slo_*`` gauges; `parse_slo_spec` accepts and refuses
the same specs; `parse_series_key`, `render_snapshot_prometheus` and
`merge_labeled_snapshots` give equal results on the same snapshots.
Exact equality: the same arithmetic on the same floats."""
import pytest

from paddle_tpu import observability as jobs
from paddle_tpu.observability import exporters as jexp

from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.observability import exporters as texp

PACKAGES = (jobs, tobs)


class _Twin:
    """One registry, store and monitor of a package, fed a script."""

    def __init__(self, obs, capacity=8, max_series=64, **slo):
        self.obs = obs
        self.reg = obs.MetricsRegistry()
        self.lat = self.reg.histogram("fleet_route_latency_seconds",
                                      labelnames=("model",),
                                      max_samples=32)
        self.replies = self.reg.counter("fleet_replies_total",
                                        labelnames=("model", "outcome"))
        self.shed = self.reg.counter("fleet_shed_total",
                                     labelnames=("reason",))
        self.depth = self.reg.gauge("engine_queue_depth",
                                    labelnames=("model",))
        self.store = obs.TimeSeriesStore(self.reg, interval_s=3600,
                                         capacity=capacity,
                                         max_series=max_series)
        self.mon = (obs.SLOMonitor(self.store, registry=self.reg, **slo)
                    if slo else None)

    def tick(self, now, latency_s, good=8, bad=0, shed=0, models=("m",)):
        for model in models:
            for _ in range(good):
                self.lat.labels(model=model).observe(latency_s)
                self.replies.labels(model=model, outcome="ok").inc()
            for _ in range(bad):
                self.replies.labels(model=model, outcome="error").inc()
            self.depth.labels(model=model).set(good + bad)
        if shed:
            self.shed.labels(reason="queue_full").inc(shed)
        self.store.sample_once(now=now)

    def gauges(self):
        snap = self.obs.snapshot(self.reg)
        return {name: body["series"] for name, body in snap.items()
                if name.startswith("slo_")}


def _script(twin):
    """Healthy traffic, a latency and error incident, then silence."""
    for n in range(4):
        twin.tick(1000.0 + n, 0.010, models=("a", "b"))
    for n in range(4, 9):
        twin.tick(1000.0 + n, 0.200, good=6, bad=2, shed=1,
                  models=("a", "b"))
    for n in range(9, 13):
        twin.tick(1000.0 + n, 0.012, models=("b",))
    for n in range(3):
        twin.tick(2000.0 + n, 0.0, good=0)


def _queries(twin, now=1012.0):
    st = twin.store
    out = {}
    for name in st.names():
        for part in (None, "count", "sum"):
            for window in (None, 3.5):
                for match in (None, {"model": "a"}, {"outcome": "ok"}):
                    key = (name, part, window, str(match))
                    out[key] = (
                        st.query(name, match=match, part=part,
                                 window_s=window, now=now),
                        st.rollup(name, match=match, part=part,
                                  window_s=window, now=now),
                        st.window_delta(name, match=match, part=part,
                                        window_s=window, now=now),
                        st.latest(name, match=match, part=part))
    return out


@pytest.mark.parametrize("capacity", [4, 64])
def test_store_queries_equal_jax(capacity):
    twins = [_Twin(obs, capacity=capacity) for obs in PACKAGES]
    for t in twins:
        _script(t)
    got = [_queries(t) for t in twins]
    assert got[0] == got[1]
    st = twins[1].store
    assert st.ticks == 16 and st.kind("fleet_replies_total") == "counter"
    assert st.names() == twins[0].store.names()
    assert st.series("fleet_route_latency_seconds") == \
        twins[0].store.series("fleet_route_latency_seconds")
    # the documented empty sentinels
    assert st.rollup("no_such_family") == {}
    assert st.window_delta("no_such_family") == 0.0


def test_store_bounds_series_like_jax():
    twins = [_Twin(obs, max_series=5) for obs in PACKAGES]
    for t in twins:
        _script(t)
    assert twins[0].store.dropped_series == twins[1].store.dropped_series > 0
    assert _queries(twins[0]) == _queries(twins[1])


@pytest.mark.parametrize("slo", [
    dict(p99_ms=50.0, availability=0.9, breach_after=2, clear_after=2),
    dict(p99_ms=50.0, breach_after=1, clear_after=2, window_s=3.0),
    dict(availability=0.99, breach_after=1, clear_after=1, window_s=60.0),
])
def test_slo_gauges_equal_jax_along_the_script(slo):
    twins = [_Twin(obs, **slo) for obs in PACKAGES]
    seen = [[], []]
    for i, t in enumerate(twins):
        orig = t.store.sample_once

        def sample(now=None, _t=t, _i=i, _orig=orig):
            n = _orig(now=now)
            seen[_i].append((_t.gauges(), dict(_t.mon.last)))
            return n
        t.store.sample_once = sample
        _script(t)
    assert seen[0] == seen[1]
    gauges = seen[1][-1][0]
    assert set(gauges) == {"slo_objective_target", "slo_observed",
                           "slo_error_budget_burn_rate", "slo_breach"}
    # the incident breached at some tick
    assert any(v == 1.0 for g, _ in seen[1]
               for v in g["slo_breach"].values())


def test_slo_monitor_close_detaches_its_hook():
    t = _Twin(tobs, p99_ms=10.0)
    assert t.mon.evaluate_once in t.store.on_sample
    t.mon.close()
    assert t.mon.evaluate_once not in t.store.on_sample
    with pytest.raises(ValueError, match="at least one objective"):
        tobs.SLOMonitor(t.store)


@pytest.mark.parametrize("spec", [
    "p99_ms=100:avail=0.999", "p99_ms=250", "avail=1", ":p99_ms=5:",
    "p42=1", "avail=1.5", "avail=0", "p99_ms=0", "p99_ms=-3", "", "p99_ms",
    "p99_ms=abc"])
def test_parse_slo_spec_like_jax(spec):
    def outcome(obs):
        try:
            return obs.parse_slo_spec(spec)
        except ValueError as e:
            return ("ValueError", str(e))
    assert outcome(jobs) == outcome(tobs)


def test_store_rejects_nonpositive_interval():
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="interval_s"):
            tobs.TimeSeriesStore(tobs.MetricsRegistry(), interval_s=bad)


def test_background_sampler_runs_hooks_and_counts_errors():
    import time
    reg = tobs.MetricsRegistry()
    reg.counter("bg_total").inc()
    st = tobs.TimeSeriesStore(reg, interval_s=0.02)
    ticks = []
    st.on_sample.append(ticks.append)

    def bad(now):
        raise RuntimeError("monitor died")
    st.on_sample.append(bad)
    with st.start():
        deadline = time.monotonic() + 10
        while st.ticks < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
    assert st.ticks >= 3 and len(ticks) >= 3
    assert st.errors["hook_errors"] >= 3
    assert "monitor died" in st.errors["last_error"]
    assert st.latest("bg_total")[""] == 1.0


# ---------------------------------------------------------------------------
# the three exporter functions
# ---------------------------------------------------------------------------

KEYS = ["", "count", "sum", "model=a", "model=a:count", "model=a:sum",
        "device=cuda\\:0,model=a", "device=TPU_0(process\\=0\\,(0\\,0)),m=x",
        "quantile=0.99,model=b", "a=b=c", "weird\\\\=x"]


@pytest.mark.parametrize("key", KEYS)
def test_parse_series_key_equals_jax(key):
    assert texp.parse_series_key(key) == jexp.parse_series_key(key)


def _snap(obs, scale):
    reg = obs.MetricsRegistry()
    c = reg.counter("req_total", labelnames=("model",))
    g = reg.gauge("device_memory_bytes", labelnames=("device",))
    h = reg.histogram("lat_seconds", labelnames=("model",))
    c.labels(model="a").inc(3 * scale)
    g.labels(device="cuda:0").set(100 * scale)
    for i in range(5):
        h.labels(model="a").observe(0.01 * (i + scale))
    reg.gauge("plain").set(scale)
    return obs.snapshot(reg)


def test_render_snapshot_prometheus_equals_jax():
    for scale in (1, 2):
        snap = _snap(tobs, scale)
        assert snap == _snap(jobs, scale)
        assert texp.render_snapshot_prometheus(snap) == \
            jexp.render_snapshot_prometheus(snap)


def test_merge_labeled_snapshots_equals_jax():
    per = {"r0": _snap(tobs, 1), "r1": _snap(tobs, 2)}
    got = texp.merge_labeled_snapshots(per)
    assert got == jexp.merge_labeled_snapshots(per)
    series = got["device_memory_bytes"]["series"]
    # device series take the max across replicas, counters sum
    assert series["device=cuda\\:0,replica=fleet"] == 200
    assert got["req_total"]["series"]["model=a,replica=fleet"] == 9
    # a fleet of fleets keeps its sub-replicas namespaced
    outer = {"f0": got, "r9": _snap(tobs, 3)}
    assert texp.merge_labeled_snapshots(outer, into={}) == \
        jexp.merge_labeled_snapshots(outer, into={})
