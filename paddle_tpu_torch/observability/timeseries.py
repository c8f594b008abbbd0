"""A ring-buffered time-series store over the metrics registry
(counterpart of ``paddle_tpu/observability/timeseries.py``).

The registry answers "what is the value now"; the SLO monitor and a
fleet view need "what were the values over the last window".  This
module samples a `MetricsRegistry` into bounded rings:

- one ring per (family, series key); the key is the
  ``exporters.snapshot`` key (``"model=default,quantile=0.99"``,
  ``"model=default:count"``), so a store sample and a ``metrics`` RPC
  snapshot name the same series;
- each ring is a ``deque(maxlen=capacity)`` of ``(ts, value)`` pairs, so
  memory stays under ``capacity * max_series``;
- queries filter by family, label match and trailing window, and
  ``rollup`` reduces a window to min/max/mean/pXX (and a per-second rate
  for counters).

Sampling is pulled: the instrumented hot paths are untouched, and a
process that starts no sampler pays nothing.  One tick walks
``registry.collect()`` once.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from .exporters import parse_series_key, series_key
from .registry import MetricsRegistry, default_registry

DEFAULT_CAPACITY = 512      # samples kept per series ring
DEFAULT_MAX_SERIES = 4096   # distinct rings before new ones are dropped


def _matches(labels: Dict[str, str], match: Optional[Dict[str, str]]) -> bool:
    if not match:
        return True
    return all(labels.get(k) == str(v) for k, v in match.items())


class TimeSeriesStore:
    """Samples a registry's families into bounded per-series rings.

    ``sample_once`` is the unit of work (tests drive it directly for
    determinism); ``start``/``stop`` run it on a background thread at
    ``interval_s``.  ``on_sample`` hooks (the SLO monitor) run after
    each tick, on the sampler thread.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 interval_s: float = 1.0,
                 capacity: int = DEFAULT_CAPACITY,
                 max_series: int = DEFAULT_MAX_SERIES):
        self.registry = registry or default_registry()
        self.interval_s = float(interval_s)
        if self.interval_s <= 0:
            # wait(0) never blocks: the sampler thread would busy-loop
            # holding the registry lock — reject at construction, where
            # the CLI surfaces it as a clean usage error
            raise ValueError(
                f"interval_s must be positive, got {interval_s}")
        self.capacity = int(capacity)
        self.max_series = int(max_series)
        self._lock = threading.Lock()
        #: family -> {series_key: deque[(ts, value)]}
        self._rings: Dict[str, Dict[str, deque]] = {}
        self._kinds: Dict[str, str] = {}
        self._dropped_series = 0
        self._ticks = 0
        self._sample_errors = 0
        self._hook_errors = 0
        self._last_error: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.on_sample: List[Any] = []

    # -- sampling ----------------------------------------------------------
    def sample_once(self, now: Optional[float] = None) -> int:
        """One tick: append every family's current samples to its rings.
        Returns the number of values recorded."""
        now = time.time() if now is None else float(now)
        recorded = 0
        collected = self.registry.collect()
        with self._lock:
            n_series = sum(len(f) for f in self._rings.values())
            for name, kind, _help, samples in collected:
                self._kinds[name] = kind
                fam = self._rings.setdefault(name, {})
                for labels, suffix, value in samples:
                    key = series_key(labels, suffix)
                    ring = fam.get(key)
                    if ring is None:
                        if n_series >= self.max_series:
                            self._dropped_series += 1
                            continue
                        ring = fam[key] = deque(maxlen=self.capacity)
                        n_series += 1
                    ring.append((now, float(value)))
                    recorded += 1
            self._ticks += 1
        for hook in list(self.on_sample):
            try:
                hook(now)
            except Exception as e:  # noqa: BLE001 — a hook must not kill
                # sampling, but a dying hook (the SLO monitor) silently
                # freezing its gauges at stale values needs a signal:
                # count it and keep the last error for the stats page
                self._hook_errors += 1
                self._last_error = f"{type(e).__name__}: {e}"
        return recorded

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception as e:  # noqa: BLE001 — keep sampling
                self._sample_errors += 1
                self._last_error = f"{type(e).__name__}: {e}"

    def start(self) -> "TimeSeriesStore":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="timeseries-sampler")
            self._thread.start()
        return self

    def stop(self, final_sample: bool = False):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self.interval_s + 5.0)
            self._thread = None
        if final_sample:
            self.sample_once()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- introspection -----------------------------------------------------
    @property
    def ticks(self) -> int:
        return self._ticks

    @property
    def errors(self) -> Dict[str, Any]:
        """{sample_errors, hook_errors, last_error} — nonzero means the
        sampler (or an on_sample hook like the SLO monitor) is failing
        and its derived gauges may be stale."""
        return {"sample_errors": self._sample_errors,
                "hook_errors": self._hook_errors,
                "last_error": self._last_error}

    @property
    def dropped_series(self) -> int:
        """SAMPLES skipped because ``max_series`` was hit — increments
        on every tick that an un-ringed series stays over the bound, so
        it keeps growing while the overflow persists (nonzero = you are
        losing data NOW, magnitude ~ overflow x ticks, not the count of
        distinct dropped series)."""
        return self._dropped_series

    def kind(self, name: str) -> Optional[str]:
        return self._kinds.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._rings)

    def series(self, name: str) -> List[str]:
        """Series keys recorded for one family."""
        with self._lock:
            return sorted(self._rings.get(name, ()))

    # -- queries -----------------------------------------------------------
    def query(self, name: str, match: Optional[Dict[str, str]] = None,
              part: Optional[str] = None,
              window_s: Optional[float] = None,
              now: Optional[float] = None
              ) -> Dict[str, List[Tuple[float, float]]]:
        """-> {series_key: [(ts, value), ...]} for one family, filtered
        by exact label ``match`` (subset), histogram ``part`` ("count"/
        "sum"/None for plain samples), and a trailing ``window_s``."""
        now = time.time() if now is None else float(now)
        out: Dict[str, List[Tuple[float, float]]] = {}
        with self._lock:
            fam = self._rings.get(name, {})
            items = [(k, list(ring)) for k, ring in fam.items()]
        for key, points in items:
            labels, key_part = parse_series_key(key)
            if part is not None and key_part != part:
                continue
            if part is None and key_part in ("count", "sum"):
                continue
            if not _matches(labels, match):
                continue
            if window_s is not None:
                points = [p for p in points if p[0] >= now - window_s]
            if points:
                out[key] = points
        return out

    def latest(self, name: str, match: Optional[Dict[str, str]] = None,
               part: Optional[str] = None) -> Dict[str, float]:
        """Most recent value per matching series."""
        return {k: pts[-1][1]
                for k, pts in self.query(name, match=match,
                                         part=part).items()}

    def rollup(self, name: str, match: Optional[Dict[str, str]] = None,
               part: Optional[str] = None,
               window_s: Optional[float] = None,
               now: Optional[float] = None) -> Dict[str, float]:
        """Reduce every matching series' window to one summary:
        count/min/max/mean/p50/p90/p99/first/last, plus ``rate`` (per
        second, from the first-to-last delta) for counter families —
        the "requests per second over the last N seconds" primitive the
        ``top`` view and the autoscaling policy read.

        A family with no matching samples (a cold store, an unknown
        name, an empty window) returns ``{}`` — the documented empty
        sentinel.  It is falsy, so ``if roll:``
        guards keep working, and it is a dict, so a policy loop can
        ``roll.get("max")`` unconditionally without None-checks.
        `window_delta` has the matching contract: no samples sum to
        ``0.0``."""
        series = self.query(name, match=match, part=part,
                            window_s=window_s, now=now)
        points = sorted(p for pts in series.values() for p in pts)
        if not points:
            return {}
        values = sorted(v for _, v in points)
        n = len(values)

        def pct(q: float) -> float:
            return values[min(int(n * q), n - 1)]

        out = {"count": float(n), "min": values[0], "max": values[-1],
               "mean": sum(values) / n, "p50": pct(0.50),
               "p90": pct(0.90), "p99": pct(0.99),
               "first": points[0][1], "last": points[-1][1]}
        if self._kinds.get(name) == "counter" and n >= 2:
            # counters are cumulative: rate is the window's value delta
            # over its time span, summed across matching series
            rate = 0.0
            for pts in series.values():
                if len(pts) >= 2 and pts[-1][0] > pts[0][0]:
                    rate += max(pts[-1][1] - pts[0][1], 0.0) \
                        / (pts[-1][0] - pts[0][0])
            out["rate"] = rate
        return out

    def window_delta(self, name: str,
                     match: Optional[Dict[str, str]] = None,
                     part: Optional[str] = None,
                     window_s: Optional[float] = None,
                     now: Optional[float] = None) -> float:
        """Summed increase across matching series over the window
        (counter families: "how many events happened in this window").
        A family with no samples yet (cold store) is a well-defined
        ``0.0`` — nothing happened — matching `rollup`'s ``{}`` empty
        sentinel.

        The baseline per series is the last sample before the window;
        a series with no pre-window history whose ring has NOT evicted
        anything is treated as born at 0 inside the window (counters
        start at 0 — the first error of a process must count as a
        delta, not vanish because the series is new).  A full ring has
        lost history, so it falls back to the conservative
        first-in-window baseline."""
        now = time.time() if now is None else float(now)
        cutoff = None if window_s is None else now - window_s
        with self._lock:
            fam = self._rings.get(name, {})
            items = [(k, list(ring), len(ring) == ring.maxlen)
                     for k, ring in fam.items()]
        total = 0.0
        for key, points, ring_full in items:
            labels, key_part = parse_series_key(key)
            if part is not None and key_part != part:
                continue
            if part is None and key_part in ("count", "sum"):
                continue
            if not _matches(labels, match):
                continue
            inw = (points if cutoff is None
                   else [p for p in points if p[0] >= cutoff])
            if not inw:
                continue
            before = ([] if cutoff is None
                      else [p for p in points if p[0] < cutoff])
            if before:
                base = before[-1][1]
            elif ring_full:
                base = inw[0][1]
            else:
                base = 0.0
            total += max(inw[-1][1] - base, 0.0)
        return total
