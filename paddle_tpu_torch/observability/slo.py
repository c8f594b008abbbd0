"""SLO monitor: objectives evaluated against the time-series store
(counterpart of ``paddle_tpu/observability/slo.py``).

Two objective kinds:

- **latency** — "p99 stays under L ms".  Observed: the worst current p99
  across the matching series of the latency family.  Burn rate:
  ``observed / target``.
- **availability** — "at least A of requests succeed".  Observed: the
  good/total ratio over the trailing window, from counter deltas in the
  store's rings.  Burn rate: ``error_rate / (1 - A)``.

Each objective sets four gauge series labelled ``objective=...``:
``slo_objective_target``, ``slo_observed``, ``slo_error_budget_burn_rate``
and ``slo_breach`` (0/1, set after ``breach_after`` consecutive
over-budget evaluations and cleared after ``clear_after`` clean ones).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from .registry import MetricsRegistry, default_registry
from .timeseries import TimeSeriesStore


def parse_slo_spec(spec: str) -> Dict[str, float]:
    """'p99_ms=100:avail=0.999' -> {'p99_ms': 100.0, 'avail': 0.999}.
    Parts are ':'-separated KEY=VALUE; known keys: p99_ms, avail."""
    out: Dict[str, float] = {}
    for part in str(spec).split(":"):
        if not part:
            continue
        key, sep, val = part.partition("=")
        if not sep or key not in ("p99_ms", "avail"):
            raise ValueError(
                f"bad --slo part {part!r}: expected p99_ms=MS and/or "
                "avail=RATIO, ':'-separated")
        out[key] = float(val)
    if not out:
        raise ValueError(f"empty --slo spec {spec!r}")
    if "avail" in out and not (0.0 < out["avail"] <= 1.0):
        raise ValueError(f"avail must be in (0, 1], got {out['avail']}")
    if "p99_ms" in out and out["p99_ms"] <= 0:
        # a zero/negative target would make the burn math degenerate
        # into "never breaches" — the opposite of what the typo meant
        raise ValueError(f"p99_ms must be positive, got {out['p99_ms']}")
    return out


class SLOMonitor:
    """Evaluates objectives against a `TimeSeriesStore` on every store
    sample tick (it registers itself on ``store.on_sample``) or on
    explicit ``evaluate_once`` calls (tests / CLI one-shots)."""

    def __init__(self, store: TimeSeriesStore,
                 p99_ms: Optional[float] = None,
                 availability: Optional[float] = None,
                 latency_family: str = "fleet_route_latency_seconds",
                 latency_quantile: str = "0.99",
                 good_series: Tuple[str, Dict[str, str]] =
                 ("fleet_replies_total", {"outcome": "ok"}),
                 total_families: Tuple[str, ...] =
                 ("fleet_replies_total", "fleet_shed_total"),
                 window_s: float = 60.0,
                 breach_after: int = 2,
                 clear_after: int = 2,
                 registry: Optional[MetricsRegistry] = None):
        if p99_ms is None and availability is None:
            raise ValueError("SLOMonitor needs at least one objective")
        if p99_ms is not None and float(p99_ms) <= 0:
            raise ValueError(f"p99_ms must be positive, got {p99_ms}")
        self.store = store
        self.p99_ms = None if p99_ms is None else float(p99_ms)
        self.availability = (None if availability is None
                             else float(availability))
        self.latency_family = latency_family
        self.latency_quantile = str(latency_quantile)
        self.good_series = good_series
        self.total_families = tuple(total_families)
        self.window_s = float(window_s)
        self.breach_after = max(1, int(breach_after))
        self.clear_after = max(1, int(clear_after))
        self._lock = threading.Lock()
        self._streak: Dict[str, int] = {}   # +n over-budget, -n clean
        self._breached: Dict[str, bool] = {}
        #: most recent evaluation, objective -> result dict (stats page)
        self.last: Dict[str, Dict[str, Any]] = {}

        reg = registry or default_registry()
        self._g_target = reg.gauge(
            "slo_objective_target", "configured objective target",
            labelnames=("objective",))
        self._g_observed = reg.gauge(
            "slo_observed", "latest observed value per objective",
            labelnames=("objective",))
        self._g_burn = reg.gauge(
            "slo_error_budget_burn_rate",
            "error-budget burn rate (1.0 = burning exactly at the "
            "objective's allowance)", labelnames=("objective",))
        self._g_breach = reg.gauge(
            "slo_breach", "1 while the objective is in sustained breach",
            labelnames=("objective",))
        if self.p99_ms is not None:
            self._g_target.labels(objective="latency_p99").set(self.p99_ms)
        if self.availability is not None:
            self._g_target.labels(objective="availability").set(
                self.availability)
        store.on_sample.append(self.evaluate_once)

    def close(self):
        try:
            self.store.on_sample.remove(self.evaluate_once)
        except ValueError:
            pass

    # ------------------------------------------------------------------
    def _update(self, objective: str, observed: Optional[float],
                burn: Optional[float], now: float) -> Dict[str, Any]:
        """Debounced breach bookkeeping + gauge export for one
        objective; ``burn is None`` means "no data this window" and
        leaves the breach state untouched."""
        with self._lock:
            breached = self._breached.get(objective, False)
            streak = self._streak.get(objective, 0)
            if burn is not None:
                over = burn > 1.0
                streak = (streak + 1 if over and streak >= 0 else
                          streak - 1 if not over and streak <= 0 else
                          (1 if over else -1))
                if streak >= self.breach_after:
                    breached = True
                elif -streak >= self.clear_after:
                    breached = False
                self._streak[objective] = streak
                self._breached[objective] = breached
        if observed is not None:
            self._g_observed.labels(objective=objective).set(observed)
        if burn is not None:
            self._g_burn.labels(objective=objective).set(burn)
        self._g_breach.labels(objective=objective).set(1.0 if breached
                                                       else 0.0)
        result = {"observed": observed, "burn_rate": burn,
                  "breached": breached, "ts": now}
        self.last[objective] = result
        return result

    def evaluate_once(self, now: Optional[float] = None
                      ) -> Dict[str, Dict[str, Any]]:
        import time as _time
        now = _time.time() if now is None else float(now)
        out: Dict[str, Dict[str, Any]] = {}
        if self.p99_ms is not None:
            from .exporters import parse_series_key
            latest = self.store.latest(
                self.latency_family,
                match={"quantile": self.latency_quantile})
            # PER-SERIES idle guard: the histogram's percentile window
            # is a ring of PAST samples, so a series with zero new
            # observations re-reads a stale p99 forever — one model's
            # latency incident followed by silence must not latch a
            # breach while (or after) other series keep serving.  A
            # series whose :count shows no increase across the trailing
            # window (with enough points to tell) is stale and excluded;
            # a fully idle family meets the objective vacuously,
            # burning zero budget.
            counts = self.store.query(self.latency_family, part="count",
                                      window_s=self.window_s, now=now)
            stale = set()
            for key, pts in counts.items():
                labels, _part = parse_series_key(key)
                if len(pts) >= 2 and pts[-1][1] <= pts[0][1]:
                    stale.add(frozenset(labels.items()))
            vals = []
            for key, v in latest.items():
                labels, _part = parse_series_key(key)
                labels.pop("quantile", None)
                if frozenset(labels.items()) not in stale:
                    vals.append(v)
            observed_ms = max(vals) * 1e3 if vals else None
            if observed_ms is not None and self.p99_ms > 0:
                burn = observed_ms / self.p99_ms
            elif latest:
                burn = 0.0      # every series idle: burning nothing
            else:
                burn = None     # no data at all: leave state untouched
            out["latency_p99"] = self._update("latency_p99", observed_ms,
                                              burn, now)
        if self.availability is not None:
            fam, match = self.good_series
            good = self.store.window_delta(fam, match=match,
                                           window_s=self.window_s, now=now)
            total = sum(self.store.window_delta(f, window_s=self.window_s,
                                                now=now)
                        for f in self.total_families)
            if total <= 0:
                # zero traffic meets the objective vacuously — same
                # idle principle as the latency guard: an incident
                # followed by silence must not page indefinitely, so an
                # empty window burns nothing and lets the breach clear
                out["availability"] = self._update("availability", None,
                                                   0.0, now)
            else:
                ratio = good / total
                allowed = 1.0 - self.availability
                err = 1.0 - ratio
                burn = err / allowed if allowed > 0 else (
                    0.0 if err <= 0 else 1e9)
                out["availability"] = self._update("availability", ratio,
                                                   burn, now)
        return out
