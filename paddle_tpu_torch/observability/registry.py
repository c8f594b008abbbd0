"""Process-wide metrics registry: Counter / Gauge / Histogram families
with labelled series (counterpart of
``paddle_tpu/observability/registry.py``).

The family names, label names and exposition are the JAX package's, so
one scrape reads the same from either package's server.  Contract:

- thread-safe: every series mutator holds a per-series lock, and the
  registry locks family and series creation;
- free while nobody looks: the process default registry starts
  disabled, and every mutator first checks ``enabled`` (starting a
  serving engine or attaching an exporter enables it).  Private
  registries, one per serving engine, are born enabled;
- per-instance series: a component builds its own `MetricsRegistry` and
  mounts it on the default one; exporters walk mounted children, and
  the component unmounts on close.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# A family keeps at most this many labelled series: an unbounded label
# (request id, user id) would otherwise grow host memory without limit.
DEFAULT_MAX_SERIES = 1000


class CardinalityError(ValueError):
    """A metric family exceeded its labelled-series budget."""


class _LatencyWindow:
    """A ring of the most recent ``max_samples`` observations (the
    percentiles) plus lifetime count and sum; one lock covers both, so a
    reader never sees them torn (``paddle_tpu/metrics.py`` LatencyStats)."""

    def __init__(self, max_samples: int = 8192):
        self.max_samples = int(max_samples)
        self._lock = threading.Lock()
        self._samples: List[float] = []
        self._next = 0
        self.count = 0
        self.total = 0.0

    def update(self, value: float):
        s = float(value)
        with self._lock:
            if len(self._samples) < self.max_samples:
                self._samples.append(s)
            else:
                self._samples[self._next] = s
            self._next = (self._next + 1) % self.max_samples
            self.count += 1
            self.total += s

    def percentile(self, q: float) -> float:
        with self._lock:
            if not self._samples:
                raise ValueError("no samples accumulated")
            arr = np.asarray(self._samples)
        return float(np.percentile(arr, q))

    def eval(self) -> Dict[str, float]:
        with self._lock:
            if self.count == 0:
                raise ValueError("no samples accumulated")
            arr = np.asarray(self._samples)
            count, total = self.count, self.total
        return {"count": count, "mean": total / count,
                "p50": float(np.percentile(arr, 50)),
                "p99": float(np.percentile(arr, 99))}


class _Instrument:
    """One metric family: a name, declared label names, and its series."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: Sequence[str], max_series: int):
        self._reg = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_series = max_series
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], Any] = {}
        if not self.labelnames:
            # an unlabelled family's one series exists from birth, so it
            # exports a zero sample
            self._series[()] = self._make_series()

    def _make_series(self):
        raise NotImplementedError

    def labels(self, **labelvalues):
        """Get or create the series for these label values (hot paths
        call this once at set-up and keep the series)."""
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labelvalues)}, "
                f"declared {sorted(self.labelnames)}")
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        series = self._series.get(key)
        if series is None:
            with self._lock:
                series = self._series.get(key)
                if series is None:
                    if len(self._series) >= self.max_series:
                        raise CardinalityError(
                            f"{self.name}: {len(self._series)} series "
                            f"already exist (max_series={self.max_series}); "
                            "an unbounded label value leaked in")
                    series = self._make_series()
                    self._series[key] = series
        return series

    def items(self) -> List[Tuple[Dict[str, str], Any]]:
        """[(labels_dict, series)] for stats pages."""
        with self._lock:
            return [(dict(zip(self.labelnames, key)), series)
                    for key, series in self._series.items()]

    def samples(self) -> List[Tuple[Dict[str, str], str, float]]:
        """[(labels_dict, name_suffix, value)] for exposition."""
        out = []
        with self._lock:
            items = list(self._series.items())
        for key, series in items:
            ld = dict(zip(self.labelnames, key))
            out.extend((dict(ld, **extra), suffix, value)
                       for extra, suffix, value in series._samples())
        return out


class _CounterSeries:
    __slots__ = ("_reg", "_lock", "_value")

    def __init__(self, reg):
        self._reg = reg
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0):
        if not self._reg.enabled:
            return
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def _samples(self):
        return [({}, "", self._value)]


class Counter(_Instrument):
    kind = "counter"

    def _make_series(self):
        return _CounterSeries(self._reg)

    def inc(self, amount: float = 1.0):
        self._series[()].inc(amount)

    @property
    def value(self) -> float:
        return self._series[()].value


class _GaugeSeries:
    __slots__ = ("_reg", "_lock", "_value", "_max_seen")

    def __init__(self, reg):
        self._reg = reg
        self._lock = threading.Lock()
        self._value = 0.0
        self._max_seen = 0.0

    def set(self, value: float):
        if not self._reg.enabled:
            return
        with self._lock:
            self._value = value
            if value > self._max_seen:
                self._max_seen = value

    def inc(self, amount: float = 1.0):
        if not self._reg.enabled:
            return
        with self._lock:
            self._value += amount
            if self._value > self._max_seen:
                self._max_seen = self._value

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    @property
    def max_seen(self) -> float:
        """High-water mark since creation (queue-depth gauges)."""
        return self._max_seen

    def reset_max(self):
        """Restart the high-water mark from the current value."""
        with self._lock:
            self._max_seen = self._value

    def _samples(self):
        return [({}, "", self._value)]


class Gauge(_Instrument):
    kind = "gauge"

    def _make_series(self):
        return _GaugeSeries(self._reg)

    def set(self, value: float):
        self._series[()].set(value)

    def inc(self, amount: float = 1.0):
        self._series[()].inc(amount)

    def dec(self, amount: float = 1.0):
        self._series[()].dec(amount)

    @property
    def value(self) -> float:
        return self._series[()].value

    @property
    def max_seen(self) -> float:
        return self._series[()].max_seen

    def reset_max(self):
        self._series[()].reset_max()


class _HistogramSeries:
    """A percentile window plus lifetime count and sum."""

    __slots__ = ("_reg", "_stats", "_quantiles")

    def __init__(self, reg, max_samples, quantiles):
        self._reg = reg
        self._stats = _LatencyWindow(max_samples)
        self._quantiles = quantiles

    def observe(self, value: float):
        if not self._reg.enabled:
            return
        self._stats.update(value)

    @property
    def count(self) -> int:
        return self._stats.count

    @property
    def sum(self) -> float:
        return self._stats.total

    def percentile(self, q: float) -> float:
        return self._stats.percentile(q)

    def summary(self) -> Optional[Dict[str, float]]:
        """{count, mean, p50, p99} of the current window, None if empty."""
        if self._stats.count == 0:
            return None
        return self._stats.eval()

    def _samples(self):
        out = []
        if self._stats.count:
            for q in self._quantiles:
                out.append(({"quantile": str(q)}, "",
                            self._stats.percentile(q * 100.0)))
        out.append(({}, "_sum", self._stats.total))
        out.append(({}, "_count", float(self._stats.count)))
        return out


class Histogram(_Instrument):
    """Exported in Prometheus *summary* form (windowed quantiles plus
    lifetime _sum and _count)."""

    kind = "summary"

    def __init__(self, registry, name, help, labelnames, max_series,
                 max_samples: int = 8192,
                 quantiles: Sequence[float] = (0.5, 0.9, 0.99)):
        self.max_samples = max_samples
        self.quantiles = tuple(quantiles)
        super().__init__(registry, name, help, labelnames, max_series)

    def _make_series(self):
        return _HistogramSeries(self._reg, self.max_samples, self.quantiles)

    def observe(self, value: float):
        self._series[()].observe(value)

    @property
    def count(self) -> int:
        return self._series[()].count

    @property
    def sum(self) -> float:
        return self._series[()].sum

    def percentile(self, q: float) -> float:
        return self._series[()].percentile(q)

    def summary(self):
        return self._series[()].summary()


class MetricsRegistry:
    """A set of metric families plus mounted child registries."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}
        self._children: List[MetricsRegistry] = []

    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    def mount(self, child: "MetricsRegistry"):
        """Expose a component-owned registry through this one's exporters."""
        with self._lock:
            if child not in self._children:
                self._children.append(child)

    def unmount(self, child: "MetricsRegistry"):
        with self._lock:
            try:
                self._children.remove(child)
            except ValueError:
                pass

    def reset(self):
        """Drop every family and child mount (test isolation only)."""
        with self._lock:
            self._instruments.clear()
            self._children = []

    def _get_or_create(self, cls, name, help, labelnames, max_series,
                       **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if type(inst) is not cls or (tuple(labelnames)
                                             != inst.labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered as {cls.__name__}"
                        f"({labelnames}) but exists as "
                        f"{type(inst).__name__}({inst.labelnames})")
                return inst
            inst = cls(self, name, help, labelnames, max_series, **kwargs)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = (),
                max_series: int = DEFAULT_MAX_SERIES) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames,
                                   max_series)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = (),
              max_series: int = DEFAULT_MAX_SERIES) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames, max_series)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  max_series: int = DEFAULT_MAX_SERIES,
                  max_samples: int = 8192,
                  quantiles: Sequence[float] = (0.5, 0.9, 0.99)) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   max_series, max_samples=max_samples,
                                   quantiles=quantiles)

    def collect(self) -> List[Tuple[str, str, str,
                                    List[Tuple[Dict[str, str], str, float]]]]:
        """[(name, kind, help, samples)] over self and mounted children;
        same-named families of two children merge under one header."""
        with self._lock:
            instruments = list(self._instruments.values())
            children = list(self._children)
        merged: Dict[str, Tuple[str, str, List]] = {}
        order: List[str] = []
        for inst in instruments:
            merged[inst.name] = (inst.kind, inst.help, inst.samples())
            order.append(inst.name)
        for child in children:
            for name, kind, help, samples in child.collect():
                if name in merged:
                    merged[name][2].extend(samples)
                else:
                    merged[name] = (kind, help, samples)
                    order.append(name)
        return [(n,) + merged[n] for n in order]


_DEFAULT = MetricsRegistry(enabled=False)


def default_registry() -> MetricsRegistry:
    return _DEFAULT
