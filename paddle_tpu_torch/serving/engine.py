"""Dynamic batcher: coalesce concurrent requests into one forward
(counterpart of ``paddle_tpu/serving/engine.py``).

Requests queue; a worker takes the oldest, adds compatible queued ones
(same feed shapes past the batch dimension and dtypes) up to
``max_batch_size`` rows or until ``max_queue_delay_ms`` has passed since
it began, pads the batch with zero rows to the nearest bucket, runs one
`Predictor` call, and hands each request its own rows.  ``workers``
threads pipeline (one's scatter overlaps another's forward); one of them
at a time assembles, so two never split a coalescing window.

The buckets are the JAX engine's (powers of two up to the batch cap) so
that batch shapes, padding and ``stats()`` match.  Eager PyTorch needs no
fixed shapes: the padding is kept for parity, and its cost is an open
question in PERF.md.  A request larger than the cap runs alone at its
own size ("oversize").  ``max_queue_depth`` refuses a submit beyond it
(`EngineOverloadedError`), a request still queued past its ``deadline``
fails with TimeoutError without reaching the device, and ``close``
drains the queue before the workers stop.

Every family carries the ``model`` label; the engine mounts its
registry on the process default one and enables it, as the JAX engine
does.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import profiler
from ..observability import MetricsRegistry, default_registry, trace
from ..observability import flight as _flight
from ..observability import introspect as _introspect


class EngineOverloadedError(RuntimeError):
    """The bounded request queue is full.  Retriable (wire code
    ``overloaded``): the request never ran."""

    def __init__(self, model: str, depth: int, bound: int):
        super().__init__(
            f"engine is overloaded: model {model!r} queue depth {depth} at "
            f"bound {bound}")
        self.model = model
        self.depth = depth
        self.bound = bound


class SlimFuture:
    """A single-producer future: one pre-acquired lock, one slot."""

    __slots__ = ("_lock", "_val", "_exc", "_done")

    def __init__(self):
        self._lock = threading.Lock()
        self._lock.acquire()          # released exactly once, on resolve
        self._val = None
        self._exc = None
        self._done = False

    def set_result(self, value):
        self._val = value
        self._done = True
        self._lock.release()

    def set_exception(self, exc):
        self._exc = exc
        self._done = True
        self._lock.release()

    def done(self) -> bool:
        return self._done

    def result(self, timeout: Optional[float] = None):
        if not self._done:
            if not self._lock.acquire(
                    timeout=-1 if timeout is None else timeout):
                raise TimeoutError("serving request timed out")
            self._lock.release()      # later result() calls stay cheap
        if self._exc is not None:
            raise self._exc
        return self._val


class _Request:
    __slots__ = ("feed", "rows", "sig", "future", "t_submit", "trace",
                 "deadline")

    def __init__(self, feed, rows, sig, deadline=None):
        self.feed = feed
        self.rows = rows
        self.sig = sig            # interned int token of the feed shapes
        self.future = SlimFuture()
        self.t_submit = time.monotonic()
        self.deadline = deadline  # monotonic; purged at assembly past it
        self.trace = trace.current_ids()


class ServingEngine:
    #: sample ``executor_device_memory_bytes{device}`` every Nth dispatch
    #: (the JAX engine's cadence), off the per-request path
    DEVICE_MEM_SAMPLE_EVERY = 64

    def __init__(self, predictor, max_batch_size: int = 16,
                 max_queue_delay_ms: float = 2.0,
                 buckets: Optional[Sequence[int]] = None,
                 workers: int = 2, model: str = "default",
                 max_queue_depth: Optional[int] = None):
        self.predictor = predictor
        self.max_queue_depth = (None if max_queue_depth is None
                                else int(max_queue_depth))
        self.model = str(model)
        self.max_batch_size = int(max_batch_size)
        self.max_queue_delay_s = float(max_queue_delay_ms) / 1e3
        if buckets:
            self.buckets = sorted({int(b) for b in buckets})
        else:
            # powers of two up to the cap: at most 2x padding
            self.buckets, b = [], 1
            while b < self.max_batch_size:
                self.buckets.append(b)
                b *= 2
            self.buckets.append(self.max_batch_size)
        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._closed = False
        self._assembling = False
        self._sig_tokens: Dict[tuple, int] = {}
        self.metrics = MetricsRegistry(enabled=True)
        m = self.metrics
        lab = dict(model=self.model)

        def series(kind, name, help):
            return getattr(m, kind)(name, help,
                                    labelnames=("model",)).labels(**lab)

        self._m_requests = series("counter", "engine_requests_total",
                                  "requests submitted to the batcher")
        self._m_dispatches = series("counter", "engine_dispatches_total",
                                    "fused device dispatches")
        self._m_batched_rows = series("counter", "engine_batched_rows_total",
                                      "real rows dispatched")
        self._m_padded_rows = series("counter", "engine_padded_rows_total",
                                     "pad rows dispatched (bucket waste)")
        self._m_queue_depth = series("gauge", "engine_queue_depth",
                                     "requests waiting to be batched")
        self._m_batch_rows = series("gauge", "engine_batch_rows",
                                    "real rows in the latest dispatch")
        self._m_batch_fill = series("histogram", "engine_batch_fill_ratio",
                                    "real rows / bucket rows per dispatch")
        self._m_padding_waste = series(
            "histogram", "engine_padding_waste_ratio",
            "pad rows / bucket rows per dispatch")
        self._m_bucket_dispatches = m.counter(
            "engine_bucket_dispatches_total", "dispatches per shape bucket",
            labelnames=("model", "bucket"))
        self._m_bucket_cache = m.counter(
            "engine_bucket_cache_events_total",
            "executable-cache results per shape bucket",
            labelnames=("model", "bucket", "result"))
        self.latency = series("histogram", "engine_request_latency_seconds",
                              "submit-to-result latency per request")
        self._m_shed = series(
            "counter", "engine_shed_total",
            "submits rejected at the max_queue_depth admission bound")
        self._m_expired = series(
            "counter", "engine_deadline_expired_total",
            "queued requests purged at assembly because their deadline "
            "lapsed (never dispatched)")
        default_registry().mount(m)
        default_registry().enable()
        self.flight = _flight.FlightRecorder(
            f"engine.{self.model}",
            ("ts", "dispatch", "queue_depth", "batch_requests", "rows",
             "bucket", "latency_s"),
            meta={"model": self.model})
        self._dispatch_n = 0
        _flight.install_signal_handler()
        self._workers = [threading.Thread(target=self._loop, daemon=True,
                                          name=f"serving-engine-{i}")
                         for i in range(max(1, int(workers)))]
        for t in self._workers:
            t.start()

    # ------------------------------------------------------------------
    def submit(self, feed: Dict[str, Any],
               deadline: Optional[float] = None) -> SlimFuture:
        """Enqueue one request (one or more rows along axis 0); the
        future resolves to the fetch arrays of exactly its rows.  Past
        ``deadline`` (monotonic) a still-queued request fails with
        TimeoutError without reaching the device."""
        feed = {n: np.asarray(v) for n, v in feed.items()}
        rows = None
        for n in self.predictor.feed_names:
            if n not in feed:
                raise KeyError(f"missing feed {n!r}")
            if feed[n].ndim == 0:
                feed[n] = feed[n].reshape(1)
            r = feed[n].shape[0]
            if rows is None:
                rows = r
            elif r != rows:
                raise ValueError(
                    f"feed {n!r} has {r} rows, expected {rows}: all feeds "
                    "of one request must agree on the batch dimension")
        sig = tuple((n, feed[n].shape[1:], feed[n].dtype)
                    for n in self.predictor.feed_names)
        with self._cv:
            if self._closed:
                raise RuntimeError("ServingEngine is closed")
            if (self.max_queue_depth is not None
                    and len(self._queue) >= self.max_queue_depth):
                self._m_shed.inc()
                raise EngineOverloadedError(self.model, len(self._queue),
                                            self.max_queue_depth)
            token = self._sig_tokens.setdefault(sig, len(self._sig_tokens))
            req = _Request(feed, rows, token, deadline=deadline)
            self._queue.append(req)
            self._m_requests.inc()
            self._m_queue_depth.set(len(self._queue))
            self._cv.notify_all()
        return req.future

    def infer(self, feed: Dict[str, Any], timeout: Optional[float] = None):
        """Submit and wait; a timeout is also the queue deadline."""
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        return self.submit(feed, deadline=deadline).result(timeout=timeout)

    def bucket_for(self, rows: int) -> int:
        for b in self.buckets:
            if rows <= b:
                return b
        return rows   # oversize: dispatched alone at its own size

    def stats(self) -> Dict[str, Any]:
        lat = None
        e = self.latency.summary()
        if e:
            lat = {"count": e["count"],
                   "mean_ms": round(e["mean"] * 1e3, 3),
                   "p50_ms": round(e["p50"] * 1e3, 3),
                   "p99_ms": round(e["p99"] * 1e3, 3)}
        buckets: Dict[str, Dict[str, int]] = {}

        def entry(b):
            return buckets.setdefault(b, {"dispatches": 0, "hits": 0,
                                          "misses": 0})

        for labels, s in self._m_bucket_dispatches.items():
            entry(labels["bucket"])["dispatches"] = int(s.value)
        for labels, s in self._m_bucket_cache.items():
            key = "hits" if labels["result"] == "hit" else "misses"
            entry(labels["bucket"])[key] = int(s.value)
        dispatches = int(self._m_dispatches.value)
        batched = int(self._m_batched_rows.value)
        padded = int(self._m_padded_rows.value)
        with self._cv:
            depth = len(self._queue)
        return {
            "requests": int(self._m_requests.value),
            "dispatches": dispatches,
            "batched_rows": batched,
            "padded_rows": padded,
            "avg_batch": round(batched / max(dispatches, 1), 3),
            "batch_fill_ratio": round(batched / max(batched + padded, 1), 4),
            "max_batch_observed": int(self._m_batch_rows.max_seen),
            "queue_depth": depth,
            "shed": int(self._m_shed.value),
            "expired": int(self._m_expired.value),
            "max_queue_depth": int(self._m_queue_depth.max_seen),
            "buckets": {b: c for b, c in sorted(
                buckets.items(),   # numeric buckets first, oversize last
                key=lambda kv: (not kv[0].isdigit(),
                                int(kv[0]) if kv[0].isdigit() else 0))},
            "latency": lat,
            "predictor": self.predictor.stats(),
        }

    def close(self, timeout: float = 30.0, unmount: bool = True):
        """Stop accepting, drain the queue, join the workers.
        ``unmount=False`` keeps the series visible for a final snapshot."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        for t in self._workers:
            t.join(timeout)
        if unmount:
            default_registry().unmount(self.metrics)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def _loop(self):
        if self.predictor.device.type == "cuda":
            torch.cuda.set_device(self.predictor.device)
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            try:
                self._dispatch(batch)
            except Exception as e:  # noqa: BLE001 — a worker must not die
                try:
                    self.flight.dump(
                        reason=f"dispatch exception: {type(e).__name__}")
                except OSError:
                    pass
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _next_batch(self) -> Optional[List[_Request]]:
        with self._cv:
            while self._assembling:
                if self._closed and not self._queue:
                    return None
                self._cv.wait(0.05)
            self._assembling = True
            try:
                head = None
                while head is None:
                    while not self._queue:
                        if self._closed:
                            return None
                        self._cv.wait(0.05)
                    head = self._queue.popleft()
                    if self._expired(head):
                        head = None
                batch, rows = [head], head.rows
                deadline = time.monotonic() + self.max_queue_delay_s
                while rows < self.max_batch_size:
                    took = False
                    now = time.monotonic()
                    for i, req in enumerate(self._queue):
                        if req.deadline is not None and now > req.deadline:
                            del self._queue[i]
                            self._expire(req)
                            took = True      # the queue changed: rescan
                            break
                        if (req.sig == head.sig
                                and rows + req.rows <= self.max_batch_size):
                            del self._queue[i]
                            batch.append(req)
                            rows += req.rows
                            took = True
                            break
                    if took:
                        continue
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._closed:
                        break
                    self._cv.wait(min(remaining, 0.05))
                self._m_queue_depth.set(len(self._queue))
                return batch
            finally:
                self._assembling = False
                self._cv.notify_all()

    def _expired(self, req: _Request) -> bool:
        if req.deadline is None or time.monotonic() <= req.deadline:
            return False
        self._expire(req)
        return True

    def _expire(self, req: _Request):
        self._m_expired.inc()
        req.future.set_exception(TimeoutError(
            "deadline expired before dispatch"))

    def _dispatch(self, batch: List[_Request]):
        rows = sum(r.rows for r in batch)
        bucket = self.bucket_for(rows)
        batch_traces = tuple(tid for r in batch for tid in r.trace)
        try:
            with (trace.scope(*batch_traces) if batch_traces
                  else contextlib.nullcontext()), \
                    profiler.record_block("engine.batch"):
                feed = {}
                for n in self.predictor.feed_names:
                    parts = [r.feed[n] for r in batch]
                    if len(parts) == 1 and parts[0].shape[0] == bucket:
                        feed[n] = parts[0]
                        continue
                    fused = np.empty((bucket,) + parts[0].shape[1:],
                                     parts[0].dtype)
                    off = 0
                    for p in parts:
                        fused[off:off + p.shape[0]] = p
                        off += p.shape[0]
                    fused[off:] = 0            # only the pad tail
                    feed[n] = fused
                outs, hit = self.predictor.run_with_info(feed)
        except Exception as e:  # noqa: BLE001 — routed to the waiters
            for r in batch:
                r.future.set_exception(e)
            return
        # resolve the futures first: clients resume during the bookkeeping
        sliceable = [np.ndim(o) > 0 and np.shape(o)[0] == bucket
                     for o in outs]
        off = 0
        for r in batch:
            end = off + r.rows
            r.future.set_result([o[off:end] if s else o
                                 for o, s in zip(outs, sliceable)])
            off = end
        now = time.monotonic()
        self._m_dispatches.inc()
        self._m_batched_rows.inc(rows)
        self._m_padded_rows.inc(bucket - rows)
        self._m_batch_rows.set(rows)
        self._m_batch_fill.observe(rows / bucket)
        self._m_padding_waste.observe((bucket - rows) / bucket)
        # oversize dispatches share one label value (raw row counts
        # would be an unbounded label)
        b = str(bucket) if bucket in self.buckets else "oversize"
        self._m_bucket_dispatches.labels(model=self.model, bucket=b).inc()
        self._m_bucket_cache.labels(model=self.model, bucket=b,
                                    result="hit" if hit else "miss").inc()
        self._dispatch_n += 1
        every = self.DEVICE_MEM_SAMPLE_EVERY
        if every and self._dispatch_n % every == 1 % every:
            _introspect.sample_device_memory()
        self.flight.push((time.time(), self._dispatch_n, len(self._queue),
                          len(batch), rows, bucket, now - batch[0].t_submit))
        for r in batch:
            self.latency.observe(now - r.t_submit)
