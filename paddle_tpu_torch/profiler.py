"""Profiler (counterpart of ``paddle_tpu/profiler.py``).

Two sources, one surface:

- the host span log: ``start_profiler`` opens a session; every
  ``record_block`` / ``record_span`` then records a named, timestamped
  span stamped with the active request trace ids
  (`observability.trace`) on the recording thread's track, and a
  per-name event table (``stop_profiler`` prints it).  The log is a ring
  of ``MAX_SPANS`` that evicts its oldest half when full, so a long
  profiled serving session keeps answering ``trace <id>`` for recent
  requests;
- the card: while a ``torch.profiler`` runs, ``record_block`` is also a
  ``torch.profiler.record_function`` range, so the serving and executor
  spans (``serving.request``, ``engine.batch``, ``executor.run``,
  ``decode.prefill``, ``decode.step``) appear by name beside the kernels
  they launched.  ``profiler(profile_path=...)`` writes the span log
  there and a CUDA+CPU ``torch.profiler`` trace to
  ``<profile_path>.trace.json`` (where the JAX package writes an
  ``.xplane`` directory); ``start_trace`` / ``stop_trace`` and
  ``cuda_profiler`` drive one module-level ``torch.profiler`` session.

With both off, ``record_block`` returns one shared do-nothing context:
the disabled path allocates nothing (``record_function`` costs about
15 us a span even with no profiler).
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Optional

import torch

from .observability import trace as _trace
from .observability.attribution import torch_profiling as _torch_profiling

#: name -> [calls, total, min, max]
_events = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])
_spans = []      # (name, start_s, end_s, tid, trace_ids, attrs)
_spans_lock = threading.Lock()
_enabled = False
# (wall, perf) pair taken at start_profiler: spans stamp perf_counter,
# metrics and flight records time.time (observability/timeline.py)
_origin = None

# At the cap the oldest half of the log goes (counted as dropped): the
# log behaves as a ring that keeps answering for recent requests, in
# amortised O(1) a record; the event table keeps accumulating.
MAX_SPANS = 200_000
_dropped_spans = 0


def reset_profiler():
    global _dropped_spans
    with _spans_lock:
        _events.clear()
        _spans.clear()
        _dropped_spans = 0


def dropped_spans() -> int:
    """Spans discarded since the last reset because MAX_SPANS was hit."""
    return _dropped_spans


def get_spans(trace_id: Optional[str] = None):
    """Recorded spans as dicts, optionally those of one trace id."""
    with _spans_lock:
        spans = list(_spans)
    out = [{"name": n, "start": s, "end": e, "tid": t, "trace": list(tr),
            "attrs": dict(attrs) if attrs else {}}
           for n, s, e, t, tr, attrs in spans]
    if trace_id is not None:
        out = [s for s in out if trace_id in s["trace"]]
    return out


def is_enabled() -> bool:
    return _enabled


def get_origin():
    """(wall, perf) clock pair of the current session, or None."""
    return _origin


def start_profiler(state: str = "All"):
    """Begin a fresh session (the previous session's data is cleared)."""
    global _enabled, _origin
    reset_profiler()
    _origin = (time.time(), time.perf_counter())
    _enabled = True


def stop_profiler(sorted_key: Optional[str] = None,
                  profile_path: Optional[str] = None,
                  timeline_path: Optional[str] = None,
                  quiet: bool = False) -> str:
    """Stop the session; print (unless ``quiet``) and return the event
    table.  ``profile_path`` receives the raw span log as JSON
    (``{"spans", "origin", "dropped_spans"}``), ``timeline_path`` the
    Chrome trace of `observability.timeline.export_profile`; both are
    written atomically."""
    global _enabled
    _enabled = False
    if profile_path:
        from .io import _atomic_write
        with _atomic_write(profile_path) as f:
            json.dump({"spans": get_spans(),
                       "origin": list(_origin) if _origin else None,
                       "dropped_spans": _dropped_spans}, f)
    if timeline_path:
        from .observability import timeline as _timeline
        _timeline.export_profile(timeline_path)
    table = _format_table(sorted_key) if _events else ""
    if table and not quiet:
        print(table)
    return table


def record_event(name: str, seconds: float):
    if _enabled:
        with _spans_lock:
            _add_event(name, seconds)


def _add_event(name: str, seconds: float):
    ev = _events[name]
    ev[0] += 1
    ev[1] += seconds
    ev[2] = min(ev[2], seconds)
    ev[3] = max(ev[3], seconds)


def record_span(name: str, start: float, end: float,
                tid: Optional[str] = None,
                attrs: Optional[dict] = None):
    """A named span of ``perf_counter`` stamps, stamped with the active
    trace ids; ``tid`` defaults to the recording thread's name and
    ``attrs`` (JSON-safe) become the timeline event's ``args``."""
    global _dropped_spans
    if _enabled:
        if tid is None:
            tid = threading.current_thread().name
        with _spans_lock:
            if len(_spans) >= MAX_SPANS:
                drop = max(1, MAX_SPANS // 2)
                del _spans[:drop]
                _dropped_spans += drop
            _spans.append((name, start, end, tid, _trace.current_ids(),
                           attrs))
            # the log and the table under one lock: spans come from
            # handler threads, the engines' threads and autograd's
            _add_event(name, end - start)


# one shared, reentrant do-nothing context for the disabled path
_NULL_BLOCK = contextlib.nullcontext()


def record_block(name: str, tid: Optional[str] = None):
    """A span around the block: in the host span log while a session is
    on, and a ``record_function`` range while a ``torch.profiler`` runs;
    the shared no-op context when neither is."""
    if _enabled:
        return _record_block_live(name, tid)
    if _torch_profiling():
        return torch.profiler.record_function(name)
    return _NULL_BLOCK


def device_range(name: str):
    """A ``record_function`` range while a ``torch.profiler`` runs (the
    kernels launched inside it show under ``name`` on the device's
    timeline), else the shared no-op: no host span."""
    if _torch_profiling():
        return torch.profiler.record_function(name)
    return _NULL_BLOCK


@contextlib.contextmanager
def _record_block_live(name: str, tid: Optional[str]):
    rf = (torch.profiler.record_function(name) if _torch_profiling()
          else _NULL_BLOCK)
    t0 = time.perf_counter()
    try:
        with rf:
            yield
    finally:
        record_span(name, t0, time.perf_counter(), tid)


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: Optional[str] = "total",
             profile_path: Optional[str] = None,
             timeline_path: Optional[str] = None):
    """A profiled block.  With ``profile_path`` the host span log goes to
    that file and a ``torch.profiler`` trace of the block (CPU, and CUDA
    where there is a card) to ``<profile_path>.trace.json``;
    ``timeline_path`` receives the Chrome trace of the span log."""
    start_profiler(state)
    prof = (torch.profiler.profile(activities=_activities())
            if profile_path else None)
    t0 = time.perf_counter()
    try:
        if prof is None:
            yield
        else:
            with prof:
                yield
    finally:
        record_event("total", time.perf_counter() - t0)
        stop_profiler(sorted_key, profile_path, timeline_path=timeline_path)
        if prof is not None:
            prof.export_chrome_trace(profile_path + ".trace.json")


# the module-level device trace of start_trace / stop_trace
_trace_session = None


def start_trace(log_dir: str, activities=None):
    """Start a ``torch.profiler`` session (``activities``, default the
    CPU and the card) whose trace `stop_trace` writes to
    ``<log_dir>/trace.json``.  Raises while another profiler runs."""
    global _trace_session
    if _trace_session is not None or _torch_profiling():
        raise RuntimeError("a profiler session is already active")
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities or _activities())
    prof.start()
    _trace_session = (prof, log_dir)


def stop_trace() -> str:
    """Stop the `start_trace` session and write its trace; -> the path."""
    global _trace_session
    if _trace_session is None:
        raise RuntimeError("no profiler session is active")
    prof, log_dir = _trace_session
    _trace_session = None
    prof.stop()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def cuda_profiler(output_file=None, output_mode=None, config=None):
    """The reference's ``cuda_profiler``: a device trace of the block,
    written under ``output_file`` (a directory)."""
    start_trace(output_file or os.path.join(tempfile.gettempdir(),
                                            "paddle_tpu_torch_trace"))
    try:
        yield
    finally:
        stop_trace()


def _format_table(sorted_key):
    rows = [("Event", "Calls", "Total(s)", "Min(s)", "Max(s)", "Ave(s)")]
    items = list(_events.items())
    if sorted_key in ("total", None):
        items.sort(key=lambda kv: -kv[1][1])
    elif sorted_key == "calls":
        items.sort(key=lambda kv: -kv[1][0])
    elif sorted_key == "max":
        items.sort(key=lambda kv: -kv[1][3])
    elif sorted_key == "min":
        items.sort(key=lambda kv: kv[1][2])
    for name, (calls, total, mn, mx) in items:
        rows.append((name, str(calls), f"{total:.6f}", f"{mn:.6f}",
                     f"{mx:.6f}", f"{total / max(calls, 1):.6f}"))
    widths = [max(len(r[i]) for r in rows) for i in range(6)]
    return "\n".join("  ".join(c.ljust(w) for c, w in zip(r, widths))
                     for r in rows)
