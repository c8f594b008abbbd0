"""Seeded trace-driven open-loop load generator (counterpart of
``paddle_tpu/fleet_control/loadgen.py``).

The missing scenario harness: autoscaling and rolling-reload claims are
only measurable against *shaped* traffic — diurnal ramps, N-times
bursts, a mix of one-shot classify and streaming generate — offered at
a rate the server does NOT control.  Two pieces:

- `build_schedule(phases, seed)` — a pure function from a phase list to
  a deterministic arrival trace ``[(t_offset_s, kind), ...]``.  Arrival
  gaps are exponential (Poisson process) at a per-phase rate that can
  ramp linearly (``end_rps``) or step (``burst_x``); each arrival rolls
  ``generate_fraction`` to pick classify vs generate.  Same seed, same
  phases -> byte-identical schedule (the JAX generator's too), so
  an A/B comparison (fixed fleet vs autoscaled fleet) replays the SAME
  trace and the delta is attributable to the policy alone.

- `LoadGenerator` — replays a schedule against one endpoint
  **open-loop**: requests launch at their scheduled time whether or not
  earlier ones returned (a bounded worker pool protects the host; an
  arrival that finds no free worker is counted as shed — that is what
  overload means).  With ``retries=0`` a frontend shed surfaces
  immediately and is *counted*, not retried away — the shed-rate
  column.  With retries on, the generator measures what a well-behaved
  client sees — the zero-dropped-requests assert for rolling reloads.

The report is plain numbers: offered/sent/ok/shed/errors, shed_rate,
``achieved_rps`` (ok per wall second), latency p50/p99, per-kind
counts.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..serving.server import ServingClient, ServingError

__all__ = ["build_schedule", "LoadGenerator"]

_SHED_CODES = ("overloaded", "deadline_exceeded", "shutting_down")


def build_schedule(phases: Sequence[Dict[str, Any]], seed: int = 0
                   ) -> List[Tuple[float, str]]:
    """Phase list -> deterministic arrival trace.

    Each phase: ``{"duration_s": float, "rps": float}`` plus optional
    ``end_rps`` (linear ramp from ``rps``), ``burst_x`` (rate
    multiplier — ``{"rps": 20, "burst_x": 3}`` is a 3x burst), and
    ``generate_fraction`` (probability an arrival is ``"generate"``
    instead of ``"infer"``).  Returns ``[(t_offset_s, kind), ...]``
    sorted by time, identical for identical (phases, seed)."""
    rng = random.Random(seed)
    out: List[Tuple[float, str]] = []
    t0 = 0.0
    for phase in phases:
        dur = float(phase["duration_s"])
        mult = float(phase.get("burst_x", 1.0))
        base = float(phase["rps"]) * mult
        end = float(phase["end_rps"]) * mult if "end_rps" in phase \
            else base
        gen_frac = float(phase.get("generate_fraction", 0.0))
        t = 0.0
        while True:
            # local rate: linear interpolation across the phase (ramp);
            # flat and burst phases have end == base
            frac = t / dur if dur > 0 else 1.0
            rate = base + (end - base) * min(frac, 1.0)
            if rate <= 0:
                break
            t += rng.expovariate(rate)
            if t >= dur:
                break
            kind = "generate" if rng.random() < gen_frac else "infer"
            out.append((t0 + t, kind))
        t0 += dur
    out.sort(key=lambda p: p[0])
    return out


class LoadGenerator:
    """Replays a `build_schedule` trace against ``endpoint``.

    ``feed`` is the classify request body (name -> array); generate
    arrivals call the streaming ``generate`` verb with
    ``generate_prompt`` (requires the target to serve a generation
    model — pass ``generate_model``).  ``deadline_ms`` rides on every
    infer so the frontend sheds queue-waiters instead of letting an
    overload smear into seconds of latency."""

    def __init__(self, endpoint: str, schedule: Sequence[Tuple[float, str]],
                 feed: Dict[str, Any], model: Optional[str] = None,
                 generate_model: Optional[str] = None,
                 generate_prompt: str = "the",
                 max_new_tokens: int = 8,
                 deadline_ms: Optional[float] = None,
                 retries: int = 0,
                 timeout: float = 30.0,
                 max_outstanding: int = 256):
        self.endpoint = endpoint
        self.schedule = list(schedule)
        self.feed = feed
        self.model = model
        self.generate_model = generate_model
        self.generate_prompt = generate_prompt
        self.max_new_tokens = int(max_new_tokens)
        self.deadline_ms = deadline_ms
        self.retries = int(retries)
        self.timeout = float(timeout)
        self.max_outstanding = int(max_outstanding)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._lat: List[float] = []
        self._counts = {"ok": 0, "shed": 0, "errors": 0}
        self._by_kind: Dict[str, int] = {}

    def _client(self) -> ServingClient:
        cli = getattr(self._local, "client", None)
        if cli is None:
            cli = self._local.client = ServingClient(
                self.endpoint, timeout=self.timeout, retries=self.retries)
        return cli

    def _one(self, kind: str, sem: threading.Semaphore):
        t0 = time.monotonic()
        try:
            cli = self._client()
            if kind == "generate" and self.generate_model is not None:
                cli.generate(self.generate_prompt,
                             model=self.generate_model,
                             max_new_tokens=self.max_new_tokens)
            else:
                cli.infer(self.feed, model=self.model,
                          deadline_ms=self.deadline_ms)
            outcome = "ok"
        except ServingError as e:
            outcome = "shed" if e.code in _SHED_CODES else "errors"
        except OSError:
            outcome = "errors"
        dt = time.monotonic() - t0
        with self._lock:
            self._counts[outcome] += 1
            self._by_kind[kind] = self._by_kind.get(kind, 0) + 1
            if outcome == "ok":
                self._lat.append(dt)
        sem.release()

    def run(self, time_scale: float = 1.0) -> Dict[str, Any]:
        """Replay the schedule (``time_scale`` stretches/compresses the
        trace: 0.5 plays it twice as fast).  Returns the report dict."""
        sem = threading.Semaphore(self.max_outstanding)
        threads: List[threading.Thread] = []
        start = time.monotonic()
        overflow = 0
        for t_off, kind in self.schedule:
            delay = start + t_off * time_scale - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            if not sem.acquire(blocking=False):
                # open-loop: a full worker pool means the backend is
                # this many requests behind — that IS shed load, counted
                # without ever reaching the wire
                overflow += 1
                continue
            th = threading.Thread(target=self._one, args=(kind, sem),
                                  daemon=True, name="loadgen")
            th.start()
            threads.append(th)
        for th in threads:
            th.join(self.timeout + 10.0)
        wall = max(time.monotonic() - start, 1e-9)
        with self._lock:
            lat = sorted(self._lat)
            counts = dict(self._counts)
            by_kind = dict(self._by_kind)
        offered = len(self.schedule)
        shed = counts["shed"] + overflow
        trace_span = self.schedule[-1][0] if self.schedule else 0.0

        def pct(q: float) -> float:
            return lat[min(int(len(lat) * q), len(lat) - 1)] if lat else 0.0

        return {
            "offered": offered,
            "offered_rps": offered / max(trace_span * time_scale, 1e-9),
            "sent": offered - overflow,
            "ok": counts["ok"],
            "shed": shed,
            "errors": counts["errors"],
            "shed_rate": shed / offered if offered else 0.0,
            "achieved_rps": counts["ok"] / wall,
            "latency_p50_ms": pct(0.50) * 1e3,
            "latency_p99_ms": pct(0.99) * 1e3,
            "by_kind": by_kind,
            "wall_s": wall,
        }
