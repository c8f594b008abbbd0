"""Autoscaling control loop (counterpart of
``paddle_tpu/fleet_control/policy.py``).

A read-evaluate-act loop over the fleet frontend's own
`TimeSeriesStore`: every sampler tick it reads the last window of the
frontend's latency/shed/inflight families, debounces the verdict with
the same signed-streak hysteresis `SLOMonitor` uses for breaches, and
drives the `FleetFrontend.scale_up`/`scale_down` actuators, which
reuse the existing `_spawn` machinery, so a scale-down drains through
the same graceful-shutdown ladder as teardown.

Signals (all from ``fleet.timeseries``; every read degrades to the
documented empty sentinels — ``rollup() == {}``, ``window_delta() ==
0.0`` — on a cold store, so the loop is well-defined from tick one):

- **scale up** when the observed p99 (``rollup("fleet_route_latency_seconds",
  match={"quantile": "0.99"}, window_s=...)["max"]``) crosses the SLO
  target, when the frontend shed anything in the window, or when mean
  in-flight per healthy replica climbs past ``queue_high`` — sustained
  for ``breach_after`` consecutive ticks;
- **scale down** when the fleet is idle (zero accepted requests over
  ``idle_s`` and nothing in flight) for ``clear_after`` consecutive
  ticks.

Hysteresis on top of the streaks: per-direction cooldowns (a scale-up
also arms the scale-DOWN cooldown, so freshly added capacity is not
immediately retired), min/max replica clamps, and a boot gate (no
second scale-up while a replica is still STARTING — a slow boot must
not read as "pressure persists, add more").

Every evaluation lands in a ``fleet.autoscaler`` flight-recorder ring
and the ``autoscaler_*`` metric families; the live state (last
decision, cooldown remaining) rides ``FleetFrontend.stats()`` under
``"autoscaler"`` so ``top`` renders it.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from ..observability import MetricsRegistry, default_registry
from ..observability import flight as _flight
from ..observability.slo import parse_slo_spec

__all__ = ["Autoscaler", "parse_autoscale_spec"]

#: tuning keys accepted by `parse_autoscale_spec` beyond min/max/slo
_FLOAT_KEYS = ("queue_high", "window_s", "idle_s", "cooldown_up_s",
               "cooldown_down_s")


def parse_autoscale_spec(spec: str) -> Dict[str, Any]:
    """``'min=1,max=4,slo=p99_ms=100'`` -> ``{'min': 1, 'max': 4,
    'slo': {'p99_ms': 100.0}}``.  Parts are ','-separated KEY=VALUE;
    known keys: ``min``/``max`` (ints, required), ``slo`` (a
    `parse_slo_spec` string — ':'-separated inside, so it nests without
    quoting), and the float tunables ``queue_high``, ``window_s``,
    ``idle_s``, ``cooldown_up_s``, ``cooldown_down_s``.  Unknown keys
    raise ValueError (same contract as ``--slo``: a typo'd knob must
    not silently autoscale with defaults)."""
    out: Dict[str, Any] = {}
    for part in str(spec).split(","):
        if not part:
            continue
        key, sep, val = part.partition("=")
        if not sep:
            raise ValueError(
                f"bad --autoscale part {part!r}: expected KEY=VALUE, "
                "','-separated")
        if key in ("min", "max"):
            out[key] = int(val)
        elif key == "slo":
            out["slo"] = parse_slo_spec(val)
        elif key in _FLOAT_KEYS:
            out[key] = float(val)
        else:
            raise ValueError(
                f"unknown --autoscale key {key!r}: known keys are "
                f"min, max, slo, {', '.join(_FLOAT_KEYS)}")
    if "min" not in out or "max" not in out:
        raise ValueError(
            f"--autoscale needs min=N and max=M, got {spec!r}")
    if out["min"] < 1:
        # scaling to zero replicas would leave nothing to route to —
        # the frontend itself holds no model
        raise ValueError(f"min must be >= 1, got {out['min']}")
    if out["max"] < out["min"]:
        raise ValueError(
            f"max ({out['max']}) must be >= min ({out['min']})")
    return out


class Autoscaler:
    """Attaches to a `FleetFrontend`: registers on the fleet store's
    ``on_sample`` hook (every sampler tick evaluates once, same
    transport as `SLOMonitor`) and sets ``fleet.autoscaler = self`` so
    the stats page and teardown find it.  ``evaluate_once(now=...)`` is
    the deterministic unit tests drive directly."""

    def __init__(self, fleet, min_replicas: int = 1,
                 max_replicas: int = 4,
                 p99_ms: Optional[float] = None,
                 queue_high: float = 4.0,
                 window_s: float = 15.0,
                 idle_s: float = 30.0,
                 breach_after: int = 2,
                 clear_after: int = 2,
                 cooldown_up_s: float = 15.0,
                 cooldown_down_s: float = 60.0,
                 latency_family: str = "fleet_route_latency_seconds",
                 latency_quantile: str = "0.99",
                 registry: Optional[MetricsRegistry] = None):
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas ({max_replicas}) must be >= min_replicas "
                f"({min_replicas})")
        if min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {min_replicas}")
        if p99_ms is not None and float(p99_ms) <= 0:
            raise ValueError(f"p99_ms must be positive, got {p99_ms}")
        self.fleet = fleet
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.p99_ms = None if p99_ms is None else float(p99_ms)
        self.queue_high = float(queue_high)
        self.window_s = float(window_s)
        self.idle_s = float(idle_s)
        self.breach_after = max(1, int(breach_after))
        self.clear_after = max(1, int(clear_after))
        self.cooldown_up_s = float(cooldown_up_s)
        self.cooldown_down_s = float(cooldown_down_s)
        self.latency_family = latency_family
        self.latency_quantile = str(latency_quantile)

        self._lock = threading.Lock()
        self._up_streak = 0
        self._down_streak = 0
        #: cooldown deadlines in the evaluation timebase (the ``now``
        #: the sampler passes — wall clock, same as the store's rings)
        self._cooldown_until = {"up": 0.0, "down": 0.0}
        self._n = 0
        #: most recent decision record (the stats page's last_decision)
        self.last: Dict[str, Any] = {}

        reg = registry or getattr(fleet, "metrics", None) \
            or default_registry()
        self._m_events = reg.counter(
            "autoscaler_scale_events_total",
            "replicas added/removed by the policy",
            labelnames=("direction",))
        self._m_decisions = reg.counter(
            "autoscaler_decisions_total",
            "policy evaluations by decision",
            labelnames=("decision",))
        self._m_target = reg.gauge(
            "autoscaler_replicas_target",
            "replicas the policy is currently holding the fleet at")
        self._m_cooldown = reg.gauge(
            "autoscaler_cooldown_seconds",
            "seconds until the next scale action is allowed")

        # flight-ring record of EVERY decision: the
        # ring is bounded, so holds are cheap and a post-mortem shows
        # the ticks between two scale events, not just the events
        self.flight = _flight.FlightRecorder(
            "fleet.autoscaler",
            ("ts", "n", "decision", "reason", "replicas", "healthy",
             "p99_ms", "inflight_mean", "shed_delta"),
            meta={"min": self.min_replicas, "max": self.max_replicas,
                  "p99_ms": self.p99_ms})

        fleet.timeseries.on_sample.append(self.evaluate_once)
        fleet.autoscaler = self

    def close(self):
        try:
            self.fleet.timeseries.on_sample.remove(self.evaluate_once)
        except ValueError:
            pass

    # ------------------------------------------------------------------
    def _signals(self, now: float) -> Dict[str, Any]:
        store = self.fleet.timeseries
        lat = store.rollup(self.latency_family,
                           match={"quantile": self.latency_quantile},
                           window_s=self.window_s, now=now)
        infl = store.rollup("fleet_inflight", window_s=self.window_s,
                            now=now)
        shed = store.window_delta("fleet_shed_total",
                                  window_s=self.window_s, now=now)
        reqs = store.window_delta("fleet_requests_total",
                                  window_s=self.idle_s, now=now)
        p99 = lat.get("max")
        return {"p99_ms": None if p99 is None else p99 * 1e3,
                "inflight_mean": infl.get("mean", 0.0),
                "shed_delta": shed,
                "requests_idle_window": reqs}

    def evaluate_once(self, now: Optional[float] = None
                      ) -> Dict[str, Any]:
        """One read-evaluate-act tick.  Returns the decision record
        (also pushed to the flight ring, counted on the registry, and
        kept as ``self.last``)."""
        now = time.time() if now is None else float(now)
        sig = self._signals(now)
        replicas = self.fleet.replicas
        total = len(replicas)
        healthy = sum(1 for r in replicas if r.state == "healthy")
        booting = sum(1 for r in replicas if r.state == "starting")

        reasons = []
        if (self.p99_ms is not None and sig["p99_ms"] is not None
                and sig["p99_ms"] > self.p99_ms):
            reasons.append("p99")
        if sig["shed_delta"] > 0:
            reasons.append("shed")
        if (healthy > 0
                and sig["inflight_mean"] / healthy > self.queue_high):
            reasons.append("queue")
        pressure = bool(reasons)
        idle = (not pressure and sig["requests_idle_window"] <= 0
                and sig["inflight_mean"] <= 0)

        with self._lock:
            self._up_streak = self._up_streak + 1 if pressure else 0
            self._down_streak = self._down_streak + 1 if idle else 0
            decision, reason = "hold", ",".join(reasons) or "-"
            if total < self.min_replicas:
                # below the floor (a fleet started small, or a prior
                # scale-down raced a config change): restore it without
                # waiting out streaks or cooldowns
                if booting == 0 and self.fleet.scale_up() is not None:
                    decision, reason = "scale_up", "below_min"
                    self._m_events.labels(direction="up").inc()
                    self._cooldown_until["up"] = now + self.cooldown_up_s
                else:
                    decision = "await_boot"
            elif pressure and self._up_streak >= self.breach_after:
                if total >= self.max_replicas:
                    decision = "hold_max"
                elif booting > 0:
                    # a replica is still coming up: its capacity is not
                    # in the signals yet — adding another would double
                    # down on a verdict the boot may already fix
                    decision = "await_boot"
                elif now < self._cooldown_until["up"]:
                    decision = "cooldown"
                elif self.fleet.scale_up() is not None:
                    decision = "scale_up"
                    self._m_events.labels(direction="up").inc()
                    self._cooldown_until["up"] = now + self.cooldown_up_s
                    # fresh capacity must not be idle-reaped before it
                    # has served a single window
                    self._cooldown_until["down"] = max(
                        self._cooldown_until["down"],
                        now + self.cooldown_down_s)
                    self._up_streak = 0
                else:
                    decision = "hold_max"   # adopt-only fleet: can't grow
            elif idle and self._down_streak >= self.clear_after:
                reason = "idle"
                if total <= self.min_replicas:
                    decision = "hold_min"
                elif now < self._cooldown_until["down"]:
                    decision = "cooldown"
                elif self.fleet.scale_down() is not None:
                    decision = "scale_down"
                    self._m_events.labels(direction="down").inc()
                    self._cooldown_until["down"] = (
                        now + self.cooldown_down_s)
                    self._down_streak = 0
                else:
                    decision = "hold_min"   # nothing owned to retire
            cooldown_remaining = max(
                0.0, max(self._cooldown_until.values()) - now)
            self._n += 1
            n = self._n
            record = {"ts": now, "n": n, "decision": decision,
                      "reason": reason, "replicas": total,
                      "healthy": healthy,
                      "cooldown_remaining_s": cooldown_remaining,
                      "signals": sig}
            self.last = record
        self._m_decisions.labels(decision=decision).inc()
        self._m_target.set(float(len(self.fleet.replicas)))
        self._m_cooldown.set(cooldown_remaining)
        self.flight.push((now, n, decision, reason, total, healthy,
                          sig["p99_ms"], sig["inflight_mean"],
                          sig["shed_delta"]))
        return record

    # ------------------------------------------------------------------
    def describe(self) -> Dict[str, Any]:
        """The stats-page section: current state,
        last decision, and cooldown remaining."""
        with self._lock:
            last = dict(self.last) if self.last else None
        ups = downs = 0
        for labels, series in self._m_events.items():
            if labels.get("direction") == "up":
                ups = int(series.value)
            elif labels.get("direction") == "down":
                downs = int(series.value)
        return {"state": (last or {}).get("decision", "idle"),
                "min": self.min_replicas,
                "max": self.max_replicas,
                "replicas": len(self.fleet.replicas),
                "healthy": self.fleet.healthy_count(),
                "scale_ups": ups,
                "scale_downs": downs,
                "cooldown_remaining_s":
                    (last or {}).get("cooldown_remaining_s", 0.0),
                "last_decision": last}
