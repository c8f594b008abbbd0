"""Metric exporters: Prometheus text exposition and periodic JSONL
snapshots (counterpart of ``paddle_tpu/observability/exporters.py``;
the fleet's snapshot merging waits for the fleet).

Attaching an exporter enables its registry.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, Optional

from .registry import MetricsRegistry, default_registry


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _fmt(value: float) -> str:
    f = float(value)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def render_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """Prometheus text exposition format 0.0.4 of the whole registry,
    mounted children included.  A family with no samples yet still
    emits its HELP and TYPE headers."""
    registry = registry or default_registry()
    lines = []
    for name, kind, help, samples in registry.collect():
        if help:
            lines.append(f"# HELP {name} {help}")
        lines.append(f"# TYPE {name} {kind}")
        for labels, suffix, value in samples:
            if labels:
                lab = ",".join(f'{k}="{_escape_label(str(v))}"'
                               for k, v in sorted(labels.items()))
                lines.append(f"{name}{suffix}{{{lab}}} {_fmt(value)}")
            else:
                lines.append(f"{name}{suffix} {_fmt(value)}")
    return "\n".join(lines) + "\n"


def _escape_label_value(value: str) -> str:
    """Backslash-escape the key grammar's separators inside a label
    value (``device="cuda:0"``)."""
    out = []
    for ch in value:
        if ch in "\\,=:":
            out.append("\\")
        out.append(ch)
    return "".join(out)


def series_key(labels: Dict[str, str], suffix: str = "") -> str:
    """A snapshot's key for one sample: ``label=value,...`` sorted by
    label name ('' for the unlabelled series), with a histogram's
    ``:sum`` / ``:count`` part after the labels."""
    key = ",".join(f"{k}={_escape_label_value(str(v))}"
                   for k, v in sorted(labels.items()))
    part = suffix.lstrip("_")
    if part:
        key = f"{key}:{part}" if key else part
    return key


def snapshot(registry: Optional[MetricsRegistry] = None) -> Dict[str, Any]:
    """{family: {"kind", "series": {series_key: value}}}."""
    registry = registry or default_registry()
    out: Dict[str, Any] = {}
    for name, kind, _help, samples in registry.collect():
        out[name] = {"kind": kind,
                     "series": {series_key(labels, suffix): value
                                for labels, suffix, value in samples}}
    return out


class JsonlExporter:
    """A background thread appending one JSON snapshot line per interval
    to ``path``.  Construction enables the registry."""

    def __init__(self, path: str, interval_s: float = 10.0,
                 registry: Optional[MetricsRegistry] = None):
        self.path = path
        self.interval_s = float(interval_s)
        self.registry = registry or default_registry()
        self.registry.enable()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="metrics-jsonl-exporter")
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self.write_once()

    def write_once(self):
        line = json.dumps({"ts": time.time(),
                           "metrics": snapshot(self.registry)})
        with open(self.path, "a") as f:
            f.write(line + "\n")

    def close(self, final_snapshot: bool = True):
        self._stop.set()
        self._thread.join(self.interval_s + 5.0)
        if final_snapshot:
            self.write_once()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
