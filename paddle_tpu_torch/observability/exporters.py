"""Metric exporters: Prometheus text exposition and periodic JSONL
snapshots (counterpart of ``paddle_tpu/observability/exporters.py``),
the snapshot key grammar both ways (`series_key`, `parse_series_key`),
and the merge of several processes' snapshots
(`merge_labeled_snapshots`, rendered by `render_snapshot_prometheus`).

Attaching an exporter enables its registry.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, Optional, Tuple

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


def _split_unescaped(s: str, sep: str) -> list:
    """Split on unescaped ``sep``, keeping escape sequences intact."""
    parts, cur, i = [], [], 0
    while i < len(s):
        ch = s[i]
        if ch == "\\" and i + 1 < len(s):
            cur.append(ch)
            cur.append(s[i + 1])
            i += 2
            continue
        if ch == sep:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
        i += 1
    parts.append("".join(cur))
    return parts


def _unescape(s: str) -> str:
    out, i = [], 0
    while i < len(s):
        if s[i] == "\\" and i + 1 < len(s):
            out.append(s[i + 1])
            i += 2
        else:
            out.append(s[i])
            i += 1
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


def parse_series_key(key: str) -> Tuple[Dict[str, str], str]:
    """Invert `series_key`: -> (labels, part), part '' for a plain
    sample, label values unescaped."""
    part = ""
    chunks = _split_unescaped(key, ":")
    if len(chunks) == 2 and chunks[1] in ("count", "sum"):
        # values escape ':', so an unescaped one is the part separator
        key, part = chunks
    elif key and "=" not in key.replace("\\=", ""):
        # an unlabelled histogram's aggregate key is the bare part
        return {}, key
    labels: Dict[str, str] = {}
    for pair in _split_unescaped(key, ","):
        if not pair:
            continue
        kv = _split_unescaped(pair, "=")
        labels[_unescape(kv[0])] = _unescape("=".join(kv[1:]))
    return labels, part


def snapshot(registry: Optional[MetricsRegistry] = None) -> Dict[str, Any]:
    """{family: {"kind", "series": {series_key: value}}}."""
    registry = registry or default_registry()
    out: Dict[str, Any] = {}
    for name, kind, _help, samples in registry.collect():
        out[name] = {"kind": kind,
                     "series": {series_key(labels, suffix): value
                                for labels, suffix, value in samples}}
    return out


def render_snapshot_prometheus(snap: Dict[str, Any]) -> str:
    """Prometheus text exposition of a `snapshot`-shaped dict (a merge of
    several processes' snapshots has no live registry to render)."""
    lines = []
    for name in snap:
        body = snap[name]
        lines.append(f"# TYPE {name} {body.get('kind', 'untyped')}")
        for key, value in body.get("series", {}).items():
            labels, part = parse_series_key(key)
            suffix = f"_{part}" if part in ("sum", "count") else ""
            if labels:
                lab = ",".join(f'{k}="{_escape_label(str(v))}"'
                               for k, v in sorted(labels.items()))
                lines.append(f"{name}{suffix}{{{lab}}} {_fmt(value)}")
            else:
                lines.append(f"{name}{suffix} {_fmt(value)}")
    return "\n".join(lines) + "\n"


def merge_labeled_snapshots(per_source: Dict[str, Dict[str, Any]],
                            label: str = "replica",
                            merged_value: str = "fleet",
                            into: Optional[Dict[str, Any]] = None
                            ) -> Dict[str, Any]:
    """Merge N processes' snapshots into one: every source series again,
    labelled ``{label}=<source>``, plus one merged series per key
    labelled ``{label}=<merged_value>``: counters and gauges sum, except
    device-labelled series and quantiles, which take the max (replicas on
    one card see the same memory; a fleet's p99 is at least its worst
    member's).  A source whose snapshot already carries ``label`` (a
    fleet of fleets) keeps its series namespaced (``f0/r1``), and only
    its own merged total feeds the rollup.  ``into`` merges on top of an
    existing snapshot, which is returned."""
    out: Dict[str, Any] = into if into is not None else {}
    for source, snap in sorted(per_source.items()):
        for name, body in (snap or {}).items():
            fam = out.setdefault(name, {"kind": body.get("kind", "untyped"),
                                        "series": {}})
            series = fam["series"]
            for key, value in body.get("series", {}).items():
                labels, part = parse_series_key(key)
                inner = labels.get(label)
                labels[label] = (source if inner is None
                                 else f"{source}/{inner}")
                series[series_key(labels, "_" + part if part else "")] = value
                if inner is not None and inner != merged_value:
                    continue    # sub-replica detail: counted in its total
                labels[label] = merged_value
                mkey = series_key(labels, "_" + part if part else "")
                prev = series.get(mkey)
                if prev is None:
                    series[mkey] = value
                elif "quantile" in labels or "device" in labels:
                    series[mkey] = max(prev, value)
                else:
                    series[mkey] = prev + value
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
