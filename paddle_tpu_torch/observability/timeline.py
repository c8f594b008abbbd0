"""Chrome Trace Event Format export (counterpart of
``paddle_tpu/observability/timeline.py``; the same document for the same
spans, flight records and counters).

One Chrome Trace / Perfetto JSON document from the profiler's host span
log, the trace ids that link a request across components, metrics-JSONL
snapshots and flight-recorder rings:

- spans -> ``"X"`` duration events on per-thread tracks, with ``"M"``
  thread_name rows;
- trace ids -> flow events (``"s"``/``"t"``/``"f"``) chaining the spans of
  one request across threads and processes;
- metrics snapshots and flight records -> ``"C"`` counter tracks.

Open it at chrome://tracing or https://ui.perfetto.dev.  Spans carry
``time.perf_counter()`` stamps and metrics and flight records wall
``time.time()``; ``profiler.start_profiler`` records one (wall, perf)
origin pair that places both on one wall-clock axis.  A span log without
an origin keeps span-relative time, and its counters are dropped.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple


def _span_wall(t: float, origin: Optional[Tuple[float, float]]) -> float:
    """perf_counter stamp -> wall seconds (identity without an origin)."""
    if origin is None:
        return t
    wall0, perf0 = origin
    return wall0 + (t - perf0)


# -- shared event emitters: chrome_trace (single process) and
# stitch_processes (fleet) build the SAME X/flow events, differing only
# in how spans are placed (pid, tid namespace, wall alignment) — one
# emitter each, so the two exports cannot drift apart -----------------------

def _x_event(s: Dict[str, Any], pid: int, tid: int,
             wall_start: float, wall_end: float, us) -> Dict[str, Any]:
    ev = {"name": s["name"], "ph": "X", "cat": "host",
          "ts": us(wall_start), "dur": (wall_end - wall_start) * 1e6,
          "pid": pid, "tid": tid}
    args = dict(s.get("attrs") or {})
    if s.get("trace"):
        args["trace"] = list(s["trace"])
    if args:
        ev["args"] = args
    return ev


def _flow_events(placed, us) -> List[Dict[str, Any]]:
    """``placed``: [(span, pid, tid, wall_start, wall_end)] — chain each
    trace id's spans (wall order) into s/t/f flow arrows bound inside
    their X slices (chrome attaches a flow to the enclosing slice on the
    same pid/tid; ``bp: "e"`` binds the finish)."""
    by_trace: Dict[str, List] = {}
    for p in placed:
        for t in p[0].get("trace") or ():
            by_trace.setdefault(str(t), []).append(p)
    out: List[Dict[str, Any]] = []
    for trace_id, linked in by_trace.items():
        if len(linked) < 2:
            continue        # a flow with one endpoint draws nothing
        linked.sort(key=lambda p: p[3])
        last = len(linked) - 1
        for i, (s, pid, tid, w0, w1) in enumerate(linked):
            ev = {"name": "trace", "cat": "trace", "id": trace_id,
                  "ts": us(w0 + (w1 - w0) / 2),
                  "pid": pid, "tid": tid,
                  "ph": "s" if i == 0 else ("f" if i == last else "t"),
                  "args": {"span": s["name"]}}
            if ev["ph"] == "f":
                ev["bp"] = "e"
            out.append(ev)
    return out


def chrome_trace(spans: Iterable[Dict[str, Any]],
                 origin: Optional[Tuple[float, float]] = None,
                 counters: Optional[Iterable[Dict[str, Any]]] = None,
                 flight_records: Optional[Dict[str, List[Dict[str, Any]]]]
                 = None,
                 pid: Optional[int] = None,
                 dropped_spans: int = 0) -> Dict[str, Any]:
    """Build one Chrome Trace Event Format document.

    ``spans``          — profiler.get_spans() dicts ({name, start, end,
                         tid, trace}).
    ``origin``         — profiler.get_origin() (wall, perf) pair.
    ``counters``       — metrics-JSONL lines ({"ts", "metrics"}); gauge
                         families become counter tracks.
    ``flight_records`` — {recorder_name: records()}; numeric fields of
                         each record become one counter track per
                         recorder (the ``ts`` field is the timestamp).
    """
    pid = os.getpid() if pid is None else pid
    spans = [dict(s) for s in spans]
    events: List[Dict[str, Any]] = []

    if spans and origin is None:
        # span stamps are perf_counter seconds while counters/flight
        # carry wall time — without an origin pair they cannot share an
        # axis, so the counters are skipped
        counters = None
        flight_records = None

    # one shared zero point so spans, counters, and flight records align
    t0_candidates = [_span_wall(s["start"], origin) for s in spans]
    if counters:
        t0_candidates += [c["ts"] for c in counters if "ts" in c]
    if flight_records:
        t0_candidates += [r["ts"] for recs in flight_records.values()
                          for r in recs if "ts" in r]
    t0 = min(t0_candidates, default=0.0)

    def us(wall_t: float) -> float:
        return (wall_t - t0) * 1e6

    # ---- spans: X events on per-thread tracks, then trace-id flows --------
    tids: Dict[str, int] = {}
    placed = []
    for s in spans:
        tid = tids.setdefault(str(s.get("tid", "host")), len(tids))
        placed.append((s, pid, tid, _span_wall(s["start"], origin),
                       _span_wall(s["end"], origin)))
    events.extend(_x_event(s, p, t, w0, w1, us)
                  for s, p, t, w0, w1 in placed)
    for name, tid in tids.items():
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    events.extend(_flow_events(placed, us))

    # ---- metrics snapshots: gauge families as counter tracks --------------
    for line in counters or ():
        ts = line.get("ts")
        metrics = line.get("metrics") or {}
        if ts is None:
            continue
        for family, fam in metrics.items():
            if fam.get("kind") not in ("gauge", "counter"):
                continue
            args = {k or "value": v for k, v in fam.get("series", {}).items()
                    if isinstance(v, (int, float))}
            if args:
                events.append({"name": family, "ph": "C", "ts": us(ts),
                               "pid": pid, "args": args})

    # ---- flight rings: numeric fields as one counter track each -----------
    for rec_name, recs in (flight_records or {}).items():
        for r in recs:
            ts = r.get("ts")
            if ts is None:
                continue
            args = {k: v for k, v in r.items()
                    if k != "ts" and isinstance(v, (int, float))
                    and not isinstance(v, bool)}
            if args:
                events.append({"name": f"flight:{rec_name}", "ph": "C",
                               "ts": us(ts), "pid": pid, "args": args})

    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if dropped_spans:
        doc["otherData"] = {"dropped_spans": dropped_spans}
    return doc


def read_metrics_jsonl(path: str) -> List[Dict[str, Any]]:
    """Parse a JsonlExporter file into chrome_trace ``counters`` input
    (tolerant of a torn final line from a killed process)."""
    out = []
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


def write_timeline(path: str, trace_doc: Dict[str, Any]) -> str:
    """Atomically write one chrome-trace document (a crash mid-export
    never leaves a truncated timeline)."""
    from ..io import _atomic_write
    with _atomic_write(path) as f:
        json.dump(trace_doc, f)
    return path


def process_trace_doc(trace_id: Optional[str] = None,
                      role: str = "process") -> Dict[str, Any]:
    """THIS process's slice of one distributed trace: the spans recorded
    for ``trace_id`` (all spans when None),
    the profiler's (wall, perf) clock origin so a stitcher can align
    this process's clock with everyone else's, and any flight-recorder
    records that fall inside the trace's time window.  This is what the
    ``trace <id>`` wire RPC returns — `stitch_processes` merges a list
    of these into one Chrome trace."""
    import socket
    import time as _time

    from .. import profiler
    from . import flight as _flight

    spans = profiler.get_spans(trace_id)
    origin = profiler.get_origin()
    doc: Dict[str, Any] = {"role": role, "pid": os.getpid(),
                           "host": socket.gethostname(),
                           "wall": _time.time(),
                           "origin": list(origin) if origin else None,
                           "spans": spans, "flight": {}}
    if spans and origin:
        w0 = min(_span_wall(s["start"], origin) for s in spans) - 0.05
        w1 = max(_span_wall(s["end"], origin) for s in spans) + 0.05
        for rec in _flight.recorders():
            if "ts" not in rec.fields:
                continue
            hits = [r for r in rec.records() if w0 <= r.get("ts", 0) <= w1]
            if hits:
                doc["flight"][rec.name] = hits
    return doc


def stitch_processes(processes: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge N `process_trace_doc` dicts into ONE Chrome trace document:
    each process gets its own pid track
    (named by its role), its spans keep their per-thread rows, every
    span's clock is aligned to the shared wall axis via that process's
    (wall, perf) origin pair, and each trace id's spans — now spanning
    processes — chain into s/t/f flow arrows drawn ACROSS the process
    tracks: client -> frontend -> replica engine -> executor as one
    arrow path."""
    processes = [dict(p) for p in processes]
    # chrome pids keyed by (host, pid) IDENTITY: adopted replicas on two
    # machines can share an OS pid, and merging their tracks would
    # attribute one host's spans to the other — colliding identities get
    # a deterministic synthetic pid instead
    assigned: Dict[Any, int] = {}
    taken: set = set()
    pids: List[int] = []
    for i, proc in enumerate(processes):
        ident = (proc.get("host"),
                 proc["pid"] if proc.get("pid") is not None else f"anon-{i}")
        if ident not in assigned:
            want = (int(proc["pid"]) if proc.get("pid") is not None
                    else 100000 + i)
            while want in taken:
                want += 100000
            assigned[ident] = want
            taken.add(want)
        pids.append(assigned[ident])

    # align every stamp onto the shared wall axis before choosing t0
    spans_by_proc: List[List[Tuple[Dict[str, Any], float, float]]] = []
    t0_candidates: List[float] = []
    for proc in processes:
        origin = tuple(proc["origin"]) if proc.get("origin") else None
        ss = [(s, _span_wall(s["start"], origin),
               _span_wall(s["end"], origin))
              for s in proc.get("spans") or ()]
        spans_by_proc.append(ss)
        t0_candidates += [w0 for _s, w0, _w1 in ss]
        for recs in (proc.get("flight") or {}).values():
            t0_candidates += [r["ts"] for r in recs if "ts" in r]
    t0 = min(t0_candidates, default=0.0)

    def us(wall_t: float) -> float:
        return (wall_t - t0) * 1e6

    events: List[Dict[str, Any]] = []
    # per-process thread rows: tid namespace is per chrome pid
    tids: Dict[Tuple[int, str], int] = {}
    next_tid: Dict[int, int] = {}

    def tid_for(pid: int, tname: str) -> int:
        key = (pid, str(tname))
        if key not in tids:
            n = next_tid.get(pid, 0)
            tids[key] = n
            next_tid[pid] = n + 1
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": n, "args": {"name": str(tname)}})
        return tids[key]

    placed = []
    for proc, pid, ss in zip(processes, pids, spans_by_proc):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": f"{proc.get('role', 'process')}"
                                        f" (pid {proc.get('pid')})"}})
        for rec_name, recs in (proc.get("flight") or {}).items():
            for r in recs:
                ts = r.get("ts")
                if ts is None:
                    continue
                args = {k: v for k, v in r.items()
                        if k != "ts" and isinstance(v, (int, float))
                        and not isinstance(v, bool)}
                if args:
                    events.append({"name": f"flight:{rec_name}", "ph": "C",
                                   "ts": us(ts), "pid": pid, "args": args})
        for s, w0, w1 in ss:
            placed.append((s, pid, tid_for(pid, s.get("tid", "host")),
                           w0, w1))
    events.extend(_x_event(s, p, t, w0, w1, us)
                  for s, p, t, w0, w1 in placed)
    events.extend(_flow_events(placed, us))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_profile(timeline_path: str,
                   counters: Optional[Iterable[Dict[str, Any]]] = None,
                   include_flight: bool = True) -> str:
    """One-call export of the CURRENT profiler session: spans + flows +
    (by default) every live flight-recorder ring as counter tracks."""
    from .. import profiler
    from . import flight as _flight
    flight_records = None
    if include_flight:
        flight_records = {rec.name: rec.records()
                          for rec in _flight.recorders() if len(rec)}
    doc = chrome_trace(profiler.get_spans(), origin=profiler.get_origin(),
                       counters=counters, flight_records=flight_records,
                       dropped_spans=profiler.dropped_spans())
    return write_timeline(timeline_path, doc)
