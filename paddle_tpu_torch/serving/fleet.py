"""Resilient serving fleet (counterpart of ``paddle_tpu/serving/fleet.py``).

One `FleetFrontend` process owns N replica ``serve`` processes (spawned
as ``python -m paddle_tpu_torch serve``, or adopted from given
endpoints) and routes the newline-JSON wire over them, so to a client
the fleet looks exactly like one ``serve`` endpoint, except that a
SIGKILLed replica costs zero failed requests and a dead one is
restarted.

The moving parts:

- **Health state machine**: per replica, driven by a heartbeat thread
  calling the replica's ``stats`` RPC: ``healthy`` (routable) ->
  ``suspect`` (one missed heartbeat: not routed, next success restores)
  -> ``ejected`` (circuit open: probed for re-admission on a seeded
  `distributed.backoff.Backoff` schedule, never hammered).  A refused
  connection or a dead owned process ejects immediately: nothing is
  listening, there is no ambiguity to wait out.
- **Routing**: power-of-two-choices on load score (last reported
  ``queue_depth`` + live in-flight forwards), drawn from a
  ``random.Random(str(seed))``, the JAX frontend's stream.
- **Admission control**: per-model outstanding-request bound.  Beyond
  it, priority-0 requests shed instantly with the *retriable*
  ``overloaded`` code (never executed, safe to re-send) and positive-
  priority requests wait in a bounded strict-priority queue.
- **Deadline propagation**: ``deadline_ms`` rides the wire as the
  *remaining* budget (relative, because the client's clock is not
  ours).  A request that cannot meet its deadline is shed *here* with
  ``deadline_exceeded``.
- **Retry on another replica**: ``infer`` is idempotent (a shed or a
  dead socket means not executed), so a forward that dies retries on a
  different replica, bounded by ``max_retries``; a ``generate`` stream
  that dies mid-way replays on another replica (greedy decode is
  deterministic) and the tokens already relayed are skipped.
- **Replica restart**: a dead owned process respawns with seeded
  backoff.  ``compile_cache`` is refused: it persists XLA executables,
  and eager PyTorch has none (ROADMAP queue C: XLA-only options).

The frontend is also the fleet's observability plane: heartbeats pull
each replica's full metrics snapshot, so the ``metrics`` verb exposes
every replica's families labeled ``replica=<id>`` plus a sum/max-merged
``replica=fleet`` view; a `TimeSeriesStore` samples the frontend's own
latency/queue/replica series (the autoscaler's input); an optional
`SLOMonitor` (``slo="p99_ms=...:avail=..."``) exports ``slo_*`` gauges;
and the ``trace <id>`` verb fans out across the fleet so one stitched
Chrome trace shows client -> frontend -> replica engine -> executor with
per-attempt ``fleet.attempt`` spans tagged ``attempt=N``.

Fault points (`paddle_tpu_torch.fault`): ``fleet.route`` (per forward
attempt), ``fleet.health`` (per heartbeat sweep) and ``replica.spawn``
(per spawn attempt).  Every routed request lands in the
``fleet.frontend`` flight-recorder ring; every decision is a ``fleet_*``
metric family.  Wire, family and label names, ``describe()``/``stats()``
keys and fault-point names are the JAX frontend's letter for letter.
"""
from __future__ import annotations

import heapq
import json
import os
import random
import socketserver
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import fault, profiler
from ..distributed.backoff import Backoff
from ..observability import (MetricsRegistry, default_registry,
                             snapshot, trace)
from ..observability import flight as _flight
from .predictor import _refuse_xla_options
from .server import RETRIABLE_CODES, ServingClient, write_port_file

__all__ = ["FleetFrontend", "HEALTHY", "SUSPECT", "EJECTED", "STARTING"]

HEALTHY = "healthy"
SUSPECT = "suspect"
EJECTED = "ejected"
STARTING = "starting"
_STATES = (HEALTHY, SUSPECT, EJECTED, STARTING)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

class _Admission:
    """Per-model outstanding-request bound with a strict-priority wait
    queue.  ``bound=None`` admits everything (counting only).

    Priority 0 (the default) sheds immediately at the bound — the
    retriable ``overloaded`` code tells the client the request never
    executed.  Positive priorities queue, highest first (FIFO within a
    priority), up to ``queue_limit`` waiters; a waiter that outlives its
    deadline sheds with ``deadline_exceeded``."""

    def __init__(self, bound: Optional[int], queue_limit: int = 16):
        self.bound = bound
        self.queue_limit = int(queue_limit)
        self._cv = threading.Condition()
        self._outstanding = 0
        self._waiters: List[Tuple[int, int]] = []   # heap of (-prio, seq)
        self._seq = 0

    @property
    def outstanding(self) -> int:
        return self._outstanding

    @property
    def queued(self) -> int:
        return len(self._waiters)

    def acquire(self, priority: int = 0, deadline: Optional[float] = None,
                timeout: float = 30.0) -> Tuple[bool, Optional[str]]:
        """-> (True, None) admitted, or (False, shed_code)."""
        with self._cv:
            if self.bound is None:
                self._outstanding += 1
                return True, None
            if self._outstanding < self.bound and not self._waiters:
                self._outstanding += 1
                return True, None
            if priority <= 0 or len(self._waiters) >= self.queue_limit:
                return False, "overloaded"
            me = (-int(priority), self._seq)
            self._seq += 1
            heapq.heappush(self._waiters, me)
            end = time.monotonic() + timeout
            if deadline is not None:
                end = min(end, deadline)
            try:
                while not (self._outstanding < self.bound
                           and self._waiters[0] == me):
                    remaining = end - time.monotonic()
                    if remaining <= 0:
                        timed_out_on_deadline = (deadline is not None
                                                 and end == deadline)
                        return False, ("deadline_exceeded"
                                       if timed_out_on_deadline
                                       else "overloaded")
                    self._cv.wait(remaining)
                self._outstanding += 1
                return True, None
            finally:
                self._waiters.remove(me)
                heapq.heapify(self._waiters)
                self._cv.notify_all()

    def release(self):
        with self._cv:
            self._outstanding -= 1
            self._cv.notify_all()


# ---------------------------------------------------------------------------
# one replica
# ---------------------------------------------------------------------------

class _Replica:
    """One backend ``serve`` process: endpoint, health state, connection
    pool, and (when spawned by us) the process handle + respawn recipe."""

    def __init__(self, rid: int, endpoint: Optional[str] = None,
                 spawn_cmd: Optional[List[str]] = None,
                 port_file: Optional[str] = None,
                 log_path: Optional[str] = None,
                 backoff: Optional[Backoff] = None):
        self.rid = rid
        self.name = f"r{rid}"
        self.endpoint = endpoint
        self.spawn_cmd = spawn_cmd
        self.port_file = port_file
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        self.owned = spawn_cmd is not None
        self.state = STARTING if self.owned else SUSPECT
        self.fails = 0
        self.last_depth = 0.0
        #: latest decode-engine stats section from the heartbeat's
        #: `stats` pull, None when the replica serves no DecodeEngine —
        #: `top` renders the decode columns from it
        self.last_decode: Optional[Dict[str, Any]] = None
        self.inflight = 0
        #: trace ids of the generate streams this replica relays now
        self.relaying: set = set()
        self.forwarded = 0
        self.restarts = 0
        #: latest full metrics snapshot pulled by the heartbeat: the
        #: fleet `metrics` verb merges these labeled
        #: replica=<name>.  Cleared on ejection/respawn so a dead
        #: replica's series DROP OUT of the fleet view until its
        #: successor is re-admitted and scraped again.
        self.metrics_snap: Optional[Dict[str, Any]] = None
        self.metrics_ts = 0.0
        self.started_at = 0.0
        self.next_action_at = 0.0       # monotonic: next probe/restart
        #: a health check for this replica is in flight (set by the
        #: health loop, cleared by the check thread — single writer per
        #: phase, benign under the GIL)
        self.checking = False
        self.spawned_once = False
        #: scaled down: out of the rotation for good.  The
        #: flag (set under the frontend lock BEFORE the list removal)
        #: stops an already-running check thread from respawning the
        #: process the retirement is busy draining.
        self.retired = False
        # seeded per replica: a whole fleet restarting desynchronizes
        # reproducibly
        self.backoff = backoff or Backoff(base=0.2, cap=5.0,
                                          seed=f"replica-{rid}")
        self._pool: List[ServingClient] = []
        self._pool_lock = threading.Lock()
        self._pool_gen = 0
        self._probe_client: Optional[ServingClient] = None

    # -- connection pool (data plane ONLY — probes have their own
    # dedicated connection so a 5s heartbeat socket never carries a
    # request whose kernel build outlives it, and a 60s request socket
    # never lets one wedged replica stall the health thread) ------------
    def checkout(self, timeout: float) -> ServingClient:
        with self._pool_lock:
            if self._pool:
                return self._pool.pop()
            gen = self._pool_gen
        if self.endpoint is None:
            raise ConnectionError(f"replica {self.name} has no endpoint")
        client = ServingClient(self.endpoint, timeout=timeout, retries=0)
        client._fleet_pool_gen = gen
        return client

    def checkin(self, client: ServingClient):
        with self._pool_lock:
            # a connection checked out before invalidate_pool() belongs
            # to a dead incarnation — close it instead of re-pooling
            if getattr(client, "_fleet_pool_gen", -1) == self._pool_gen:
                self._pool.append(client)
                return
        client.close()

    def probe_client(self, timeout: float) -> ServingClient:
        """The replica's dedicated heartbeat connection (created with
        the probe timeout, reused across sweeps, dropped with the pool)."""
        with self._pool_lock:
            if self._probe_client is not None:
                return self._probe_client
        client = ServingClient(self.endpoint, timeout=timeout, retries=0)
        with self._pool_lock:
            self._probe_client = client
        return client

    def drop_probe_client(self):
        with self._pool_lock:
            client, self._probe_client = self._probe_client, None
        if client is not None:
            client.close()

    def invalidate_pool(self, drop_probe: bool = True):
        """Close every pooled data-plane connection (the endpoint died
        or moved); connections currently checked out die at check-in.
        ``drop_probe=False`` spares the health thread's dedicated
        socket — a SOFT route failure (one request timeout) must not
        yank a possibly-in-flight heartbeat out from under the prober
        and convert itself into a spurious ejection."""
        with self._pool_lock:
            pool, self._pool = self._pool, []
            self._pool_gen += 1
        for c in pool:
            c.close()
        if drop_probe:
            self.drop_probe_client()

    # -- description ------------------------------------------------------
    def describe(self) -> Dict[str, Any]:
        return {"replica": self.name, "state": self.state,
                "endpoint": self.endpoint, "owned": self.owned,
                "queue_depth": self.last_depth, "inflight": self.inflight,
                "forwarded": self.forwarded, "restarts": self.restarts,
                "consecutive_failures": self.fails,
                "decode": self.last_decode,
                "pid": self.proc.pid if self.proc else None}


# ---------------------------------------------------------------------------
# the frontend
# ---------------------------------------------------------------------------

class _RetryStream(Exception):
    """Internal: the replica shed the generate stream BEFORE emitting
    anything client-visible — safe to retry on another replica."""


class _FrontendHandler(socketserver.StreamRequestHandler):
    def handle(self):
        fleet: "FleetFrontend" = self.server.fleet
        for line in self.rfile:
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                break
            method = msg.get("method")
            if method == "infer":
                try:
                    resp = fleet.route_infer(msg)
                except Exception as e:  # noqa: BLE001 — reply, not die
                    resp = {"error": f"{type(e).__name__}: {e}",
                            "code": "internal"}
            elif method == "generate":
                # token-streaming decode: the frontend holds
                # the client connection and relays the chosen replica's
                # stream line by line; a replica death mid-stream
                # replays the (deterministic, greedy) request on
                # another replica and SKIPS the tokens already relayed,
                # so the client sees one unbroken stream
                try:
                    for resp in fleet.route_generate(msg):
                        self.wfile.write(
                            (json.dumps(resp) + "\n").encode())
                        self.wfile.flush()
                except Exception as e:  # noqa: BLE001 — reply, not die
                    resp = {"error": f"{type(e).__name__}: {e}",
                            "code": "internal"}
                    self.wfile.write((json.dumps(resp) + "\n").encode())
                    self.wfile.flush()
                continue
            elif method == "stats":
                resp = {"stats": fleet.stats()}
            elif method == "fleet":
                resp = {"fleet": fleet.describe()}
            elif method == "metrics":
                # fleet-merged exposition: the frontend's own
                # registry plus every live replica's heartbeat-pulled
                # snapshot labeled replica=<id>, with a sum/max-merged
                # replica="fleet" view per family
                resp = {"metrics": fleet.metrics_snapshot()
                        if msg.get("format") == "json"
                        else fleet.metrics_text()}
            elif method == "trace":
                resp = fleet.trace_document(msg.get("id"),
                                            fmt=msg.get("format"))
            elif method in ("models", "inspect"):
                # read-only admin verbs relay to any healthy replica —
                # the fleet looks like one serve endpoint to every
                # existing client and CLI verb
                resp = fleet.forward_admin(msg)
            elif method == "shutdown":
                self.wfile.write((json.dumps({"ok": True}) + "\n").encode())
                self.wfile.flush()
                fleet.shutting_down.set()
                threading.Thread(target=self.server.shutdown,
                                 daemon=True).start()
                return
            else:
                resp = {"error": f"unknown method {method!r}",
                        "code": "bad_request"}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


class _FrontendServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class FleetFrontend:
    """N health-checked replica ``serve`` processes behind one endpoint.

    ``models``            — [(name, model_dir), ...]; name ``"default"``
                            mounts as the replicas' default model.
    ``replicas``          — how many replica processes to spawn.
    ``replica_endpoints`` — already-running ``serve`` endpoints to adopt
                            (health-checked and routed, never restarted).
    ``compile_cache``     — refused (XLA executables; ROADMAP queue C:
                            XLA-only options); kept as None in
                            ``describe()``.
    ``admission_bound``   — per-model outstanding-request bound: an int
                            (every model) or {model: int}; None = off.
    ``replica_args``      — extra raw CLI args for spawned replicas
                            (e.g. ``("--max-batch-size", "64")``).
    """

    def __init__(self, models: Sequence[Tuple[str, str]] = (),
                 replicas: int = 0,
                 replica_endpoints: Sequence[str] = (),
                 host: str = "127.0.0.1", port: int = 0,
                 port_file: Optional[str] = None,
                 compile_cache: Optional[str] = None,
                 run_dir: Optional[str] = None,
                 health_interval: float = 0.5,
                 eject_after: int = 2,
                 probe_timeout: float = 5.0,
                 spawn_timeout: float = 120.0,
                 request_timeout: float = 60.0,
                 max_retries: int = 3,
                 route_timeout: float = 30.0,
                 admission_bound=None,
                 admission_queue: int = 16,
                 replica_args: Sequence[str] = (),
                 seed: str = "fleet",
                 python: Optional[str] = None,
                 spawn_env: Optional[Dict[str, str]] = None,
                 pull_metrics: bool = True,
                 sample_interval: float = 1.0,
                 slo=None):
        _refuse_xla_options(compile_cache)
        self.models = [(str(n), str(d)) for n, d in models]
        self.host = host
        self.compile_cache = None
        self.run_dir = run_dir or tempfile.mkdtemp(
            prefix="paddle_tpu_torch_fleet.")
        os.makedirs(self.run_dir, exist_ok=True)
        self.health_interval = float(health_interval)
        self.eject_after = int(eject_after)
        self.probe_timeout = float(probe_timeout)
        self.spawn_timeout = float(spawn_timeout)
        self.request_timeout = float(request_timeout)
        self.max_retries = int(max_retries)
        self.route_timeout = float(route_timeout)
        self.admission_bound = admission_bound
        self.admission_queue = int(admission_queue)
        self.replica_args = list(replica_args)
        self.python = python or sys.executable
        #: env for spawned replicas (None = inherit); tests point
        #: PYTHONPATH at the repo so `-m paddle_tpu_torch` resolves
        self.spawn_env = spawn_env
        self.shutting_down = threading.Event()
        self._lock = threading.Lock()
        self._healthy_cv = threading.Condition(self._lock)
        self._rng = random.Random(str(seed))
        self._admissions: Dict[str, _Admission] = {}
        self._ewma: Dict[str, float] = {}
        self._stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        self._serve_thread: Optional[threading.Thread] = None
        self._route_n = 0
        self._route_n_lock = threading.Lock()

        # replicas: spawned first (rid order), then adopted
        self._replicas: List[_Replica] = []
        for i in range(int(replicas)):
            if not self.models:
                raise ValueError("spawning replicas needs model specs")
            pf = os.path.join(self.run_dir, f"replica-{i}.port")
            log = os.path.join(self.run_dir, f"replica-{i}.log")
            self._replicas.append(_Replica(
                i, spawn_cmd=self._spawn_cmd(pf), port_file=pf,
                log_path=log))
        base = int(replicas)
        for j, ep in enumerate(replica_endpoints):
            self._replicas.append(_Replica(base + j, endpoint=str(ep)))
        if not self._replicas:
            raise ValueError(
                "FleetFrontend needs replicas to spawn or endpoints to "
                "adopt")
        #: next rid for a scale-up replica — rids are never
        #: reused, so port/log files and flight records stay unambiguous
        self._next_rid = len(self._replicas)
        #: replicas scaled out of the rotation, kept so stop() can make
        #: sure their processes are dead even if the drain thread is
        self._retired_replicas: List[_Replica] = []
        #: the attached fleet_control.Autoscaler (its constructor sets
        #: this); stats() reports its describe() and stop() closes it
        self.autoscaler = None

        # metrics (mounted like an engine's: the fleet IS the process)
        self.metrics = MetricsRegistry(enabled=True)
        m = self.metrics
        self._m_requests = m.counter(
            "fleet_requests_total", "requests accepted by the frontend",
            labelnames=("model",))
        self._m_replies = m.counter(
            "fleet_replies_total", "replies relayed to clients",
            labelnames=("model", "outcome"))
        self._m_retries = m.counter(
            "fleet_retries_total",
            "forward attempts retried on another replica")
        self._m_streams = m.counter(
            "fleet_generate_streams_total",
            "generate streams relayed end-to-end",
            labelnames=("model", "outcome"))
        self._m_stream_tokens = m.counter(
            "fleet_generate_tokens_total",
            "token lines relayed to generate clients",
            labelnames=("model",))
        self._m_shed = m.counter(
            "fleet_shed_total", "requests shed at the frontend",
            labelnames=("reason",))
        self._m_transitions = m.counter(
            "fleet_health_transitions_total",
            "replica health-state transitions", labelnames=("to",))
        self._m_restarts = m.counter(
            "fleet_replica_restarts_total", "replica process respawns")
        self._m_readmitted = m.counter(
            "fleet_replicas_readmitted_total",
            "ejected replicas re-admitted by a successful probe")
        self._m_states = m.gauge(
            "fleet_replicas", "replicas by health state",
            labelnames=("state",))
        self._m_inflight = m.gauge(
            "fleet_inflight", "requests currently being routed")
        self._m_latency = m.histogram(
            "fleet_route_latency_seconds",
            "accept-to-reply latency at the frontend",
            labelnames=("model",))
        default_registry().mount(m)
        default_registry().enable()

        #: whether heartbeats also pull each replica's full metrics
        #: snapshot for the merged fleet `metrics` view
        self.pull_metrics = bool(pull_metrics)
        # fleet-wide time-series store: the frontend's own
        # latency/queue/replica series — what the autoscaling policy
        # loop reads — sampled
        # into bounded rings; started with the frontend, queryable as
        # `fleet.timeseries`.
        from ..observability.timeseries import TimeSeriesStore
        self.timeseries = TimeSeriesStore(default_registry(),
                                          interval_s=float(sample_interval))
        #: SLO monitor (tentpole part d): `slo` is a spec string
        #: ("p99_ms=100:avail=0.999"), a parsed dict, or None.  Gauges
        #: land on the fleet registry so `metrics` exports them.
        self.slo_monitor = None
        if slo:
            from ..observability.slo import SLOMonitor, parse_slo_spec
            spec = parse_slo_spec(slo) if isinstance(slo, str) else dict(slo)
            self.slo_monitor = SLOMonitor(
                self.timeseries,
                p99_ms=spec.get("p99_ms"),
                availability=spec.get("avail"),
                registry=self.metrics)

        # flight recorder: one record per routed request — the frontend
        # dispatch loop's post-mortem ring
        self.flight = _flight.FlightRecorder(
            "fleet.frontend",
            ("ts", "n", "model", "replica", "attempts", "outcome",
             "latency_s", "inflight"),
            meta={"replicas": len(self._replicas)})
        _flight.install_signal_handler()

        # frontend endpoint (same wire as InferenceServer)
        self._server = _FrontendServer((host, int(port)), _FrontendHandler)
        self._server.fleet = self
        self.port = self._server.server_address[1]
        if port_file:
            write_port_file(port_file, self.port)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def _spawn_cmd(self, port_file: str) -> List[str]:
        cmd = [self.python, "-m", "paddle_tpu_torch", "serve"]
        for name, d in self.models:
            if name == "default":
                cmd.append(d)
            else:
                cmd += ["--model", f"{name}={d}"]
        cmd += ["--host", "127.0.0.1", "--port", "0",
                "--port-file", port_file]
        cmd += self.replica_args
        return cmd

    def start(self) -> "FleetFrontend":
        for rep in self._replicas:
            if rep.owned:
                self._spawn(rep)
        self._serve_thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.1}, daemon=True,
            name="fleet-frontend")
        self._serve_thread.start()
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True, name="fleet-health")
        self._health_thread.start()
        self.timeseries.start()
        return self

    def _spawn(self, rep: _Replica):
        """(Re)launch one owned replica process.  A `replica.spawn`
        fault reschedules the attempt on the replica's backoff — chaos
        can starve a restart, never crash the frontend."""
        if self._stop.is_set() or rep.retired:
            # a straggler check thread must not respawn a replica the
            # teardown (or a scale-down) is busy killing — that would
            # orphan a process
            return
        try:
            fault.maybe_fault("replica.spawn")
        except fault.FaultInjected:
            rep.next_action_at = rep.backoff.next_deadline()
            return
        # the old port file names the DEAD incarnation's port — remove
        # it so STARTING never adopts a stale endpoint
        try:
            os.unlink(rep.port_file)
        except OSError:
            pass
        log = open(rep.log_path, "ab") if rep.log_path else subprocess.DEVNULL
        try:
            rep.proc = subprocess.Popen(rep.spawn_cmd, stdout=log,
                                        stderr=log, env=self.spawn_env,
                                        start_new_session=True)
        except OSError:
            # fd exhaustion / missing interpreter: same contract as a
            # spawn fault — reschedule on the backoff, don't crash the
            # caller (start() or the health sweep)
            rep.next_action_at = rep.backoff.next_deadline()
            if log is not subprocess.DEVNULL:
                log.close()
            return
        if log is not subprocess.DEVNULL:
            log.close()          # the child holds its own descriptor
        rep.endpoint = None
        rep.started_at = time.monotonic()
        # the new incarnation starts with a clean slate: inheriting the
        # dead one's accumulated failure count would eject (and kill) it
        # on its first transient probe hiccup instead of granting the
        # usual eject_after grace
        rep.fails = 0
        # restarts count PROCESSES actually launched after the first —
        # a faulted/OSError'd spawn attempt (above) must not inflate the
        # number operators and the readmission logic consume
        if rep.spawned_once:
            rep.restarts += 1
            self._m_restarts.inc()
        rep.spawned_once = True
        self._transition(rep, STARTING)

    def stop(self, grace: float = 10.0):
        """Stop routing, then the replicas we own: graceful ``shutdown``
        RPC first, SIGTERM after, SIGKILL at the grace deadline."""
        self.shutting_down.set()
        self._stop.set()
        if self.autoscaler is not None:
            self.autoscaler.close()
        self.timeseries.stop()
        if self.slo_monitor is not None:
            self.slo_monitor.close()
        if self._serve_thread is not None:
            # BaseServer.shutdown() waits on an event only
            # serve_forever() sets — calling it when start() never ran
            # (or died before launching the thread) would hang forever
            self._server.shutdown()
        self._server.server_close()
        if self._health_thread is not None:
            self._health_thread.join(grace)
        for rep in self._replicas:
            rep.invalidate_pool()
            if not rep.owned or rep.proc is None:
                continue
            if rep.proc.poll() is None and rep.endpoint:
                try:
                    c = ServingClient(rep.endpoint, timeout=2.0, retries=0)
                    try:
                        c.raw_call({"method": "shutdown"})
                    finally:
                        c.close()
                except Exception:  # noqa: BLE001 — SIGTERM is next
                    pass
        deadline = time.monotonic() + grace
        for rep in self._replicas:
            if not rep.owned or rep.proc is None:
                continue
            try:
                if rep.proc.poll() is None:
                    rep.proc.terminate()
                rep.proc.wait(max(deadline - time.monotonic(), 0.1))
            except (subprocess.TimeoutExpired, OSError):
                try:
                    rep.proc.kill()
                    rep.proc.wait(5.0)
                except OSError:
                    pass
        # scaled-down replicas drain on their own threads; teardown
        # must not leave one orphaned if its drain is still in flight
        for rep in list(self._retired_replicas):
            if rep.proc is not None and rep.proc.poll() is None:
                try:
                    rep.proc.kill()
                    rep.proc.wait(5.0)
                except OSError:
                    pass
        default_registry().unmount(self.metrics)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def wait_ready(self, n: Optional[int] = None,
                   timeout: float = 120.0) -> "FleetFrontend":
        """Block until ``n`` replicas (default: all) are healthy."""
        want = len(self._replicas) if n is None else int(n)
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                healthy = sum(1 for r in self._replicas
                              if r.state == HEALTHY)
                if healthy >= want:
                    return self
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"{healthy}/{want} replicas healthy after "
                        f"{timeout}s: "
                        f"{[(r.name, r.state) for r in self._replicas]}")
                self._healthy_cv.wait(min(remaining, 0.2))

    # ------------------------------------------------------------------
    # health state machine
    # ------------------------------------------------------------------
    def _transition(self, rep: _Replica, to: str):
        with self._lock:
            if rep.state == to:
                return
            rep.state = to
            if to in (EJECTED, STARTING):
                # a dead (or not-yet-born) replica's series must drop
                # out of the fleet metrics view; they return when the
                # re-admitted successor's heartbeat scrapes it again
                rep.metrics_snap = None
            self._m_transitions.labels(to=to).inc()
            self._refresh_state_gauges()
            if to == HEALTHY:
                self._healthy_cv.notify_all()

    def _refresh_state_gauges(self):
        """Recompute the per-state replica gauges.  Caller holds
        ``self._lock`` (transitions and scale events both
        change the census)."""
        for s in _STATES:
            self._m_states.labels(state=s).set(
                sum(1 for r in self._replicas if r.state == s))

    def _health_loop(self):
        # sweep FIRST (adopted replicas should be routable immediately),
        # then settle into the interval cadence.  Each replica is
        # checked on its OWN short-lived thread: probing serially would
        # let one wedged (alive-but-unresponsive)
        # replica stall every other replica's heartbeat by up to
        # probe_timeout per sweep — a SIGKILLed peer's detection must
        # not wait in line behind a wedge.  A replica whose check is
        # still in flight is skipped, never double-probed.
        while True:
            try:
                fault.maybe_fault("fleet.health")
            except fault.FaultInjected:
                # chaos at the health point skips ONE sweep; the next
                # interval recovers — a monitoring hiccup must never
                # take the routing plane with it
                if self._stop.wait(self.health_interval):
                    return
                continue
            for rep in list(self._replicas):
                if rep.checking:
                    continue
                rep.checking = True
                threading.Thread(target=self._check_one, args=(rep,),
                                 daemon=True,
                                 name=f"fleet-check-{rep.name}").start()
            if self._stop.wait(self.health_interval):
                return

    def _check_one(self, rep: _Replica):
        try:
            self._check(rep)
        except Exception:  # noqa: BLE001 — isolate per replica
            pass
        finally:
            rep.checking = False

    def _check(self, rep: _Replica):
        if rep.retired:
            return
        now = time.monotonic()
        # 0. an owned replica with NO process: its (first) spawn attempt
        # was faulted or failed — retry once the backoff deadline
        # passes, or the replica would be stranded in STARTING forever
        if rep.owned and rep.proc is None:
            if now >= rep.next_action_at:
                self._spawn(rep)
            return
        # 1. an owned process that exited is dead, full stop: eject and
        # schedule its respawn on the seeded backoff
        if rep.owned and rep.proc is not None and rep.proc.poll() is not None:
            if rep.state != EJECTED:
                rep.invalidate_pool()
                self._transition(rep, EJECTED)
                rep.next_action_at = rep.backoff.next_deadline(now)
            elif now >= rep.next_action_at:
                self._spawn(rep)     # counts the restart itself, and
                return               # only when a process actually ran
            return
        # 2. a starting replica publishes its port file when its engine
        # is up; adopt the endpoint and fall through to the probe
        if rep.state == STARTING and rep.endpoint is None:
            port = self._try_read_port(rep)
            if port is None:
                if now - rep.started_at > self.spawn_timeout:
                    # wedged boot: kill it; branch 1 respawns it
                    if rep.proc is not None:
                        try:
                            rep.proc.kill()
                        except OSError:
                            pass
                return
            rep.endpoint = f"127.0.0.1:{port}"
        # 3. ejected replicas probe only when the circuit's backoff
        # allows — re-admission is earned, not assumed
        if rep.state == EJECTED and now < rep.next_action_at:
            return
        try:
            st = self._probe(rep)
        except Exception as e:  # noqa: BLE001 — any probe failure counts
            rep.fails += 1
            hard = isinstance(e, ConnectionRefusedError)
            if rep.state == EJECTED or hard or rep.fails >= self.eject_after:
                rep.invalidate_pool()
                self._transition(rep, EJECTED)
                rep.next_action_at = rep.backoff.next_deadline(now)
            elif rep.state == HEALTHY:
                self._transition(rep, SUSPECT)
            # a hung-but-ALIVE owned process never trips branch 1 (its
            # poll() stays None), so an ejected wedge would be probed
            # forever and its capacity lost — after enough consecutive
            # failed probes, kill it so the respawn path takes over
            # (a blocked C call answers nothing, including probes,
            # indefinitely)
            if (rep.owned and rep.proc is not None
                    and rep.proc.poll() is None
                    and rep.state == EJECTED
                    and rep.fails >= max(6, self.eject_after * 3)):
                try:
                    rep.proc.kill()
                except OSError:
                    pass
            return
        rep.last_depth = float(st.get("queue_depth", 0) or 0)
        rep.last_decode = st.get("decode")
        rep.fails = 0
        if rep.state != HEALTHY:
            # re-admission = earning HEALTHY back after being out of the
            # rotation: a probed-back ejected endpoint, or a restarted
            # process coming up through STARTING (first boot excluded)
            if rep.state == EJECTED or (rep.state == STARTING
                                        and rep.restarts > 0):
                self._m_readmitted.inc()
            rep.backoff.reset()
            self._transition(rep, HEALTHY)

    def _try_read_port(self, rep: _Replica) -> Optional[int]:
        try:
            with open(rep.port_file) as f:
                line = f.readline().strip()
            return int(line) if line else None
        except (OSError, ValueError):
            return None

    def _probe(self, rep: _Replica) -> Dict[str, Any]:
        """One heartbeat: the replica's default-model ``stats`` RPC,
        over the replica's DEDICATED probe connection — never a pooled
        data-plane socket (their timeouts differ by design)."""
        if rep.endpoint is None:
            raise ConnectionError(f"replica {rep.name} has no endpoint")
        client = rep.probe_client(self.probe_timeout)
        try:
            resp = client.raw_call({"method": "stats"})
            if "error" not in resp and self.pull_metrics:
                # ride the same heartbeat: pull the replica's FULL
                # metrics snapshot so the fleet `metrics` verb can show
                # every replica's families without a per-scrape fan-out.
                # Isolated from the health verdict: the stats probe already succeeded, and a
                # slow/garbled METRICS reply is a metrics-plane problem
                # — ejecting a traffic-serving replica over it would
                # trade capacity for telemetry.  The probe socket is
                # desynchronized though (a late reply would answer the
                # NEXT probe), so it is dropped and rebuilt.
                try:
                    mresp = client.raw_call({"method": "metrics",
                                             "format": "json"})
                except OSError:
                    rep.drop_probe_client()
                else:
                    snap = mresp.get("metrics")
                    if isinstance(snap, dict):
                        rep.metrics_snap = snap
                        rep.metrics_ts = time.monotonic()
        except BaseException:
            rep.drop_probe_client()
            raise
        if "error" in resp:
            raise ConnectionError(
                f"stats probe failed: {resp.get('error')}")
        return resp.get("stats", {})

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------
    def _admission(self, model: Optional[str]) -> _Admission:
        key = model or "default"
        with self._lock:
            adm = self._admissions.get(key)
            if adm is None:
                bound = (self.admission_bound.get(key)
                         if isinstance(self.admission_bound, dict)
                         else self.admission_bound)
                adm = _Admission(bound, self.admission_queue)
                self._admissions[key] = adm
            return adm

    def _pick(self, tried: set) -> Optional[_Replica]:
        """Power-of-two-choices over the healthy replicas not yet tried
        for this request: sample two, take the lighter (reported queue
        depth + live in-flight forwards)."""
        with self._lock:
            cands = [r for r in self._replicas
                     if r.state == HEALTHY and r.rid not in tried]
            if not cands:
                return None
            if len(cands) == 1:
                return cands[0]
            a, b = self._rng.sample(cands, 2)

        def score(r):
            return r.last_depth + r.inflight

        return a if score(a) <= score(b) else b

    def _replica_failed(self, rep: _Replica, hard: bool):
        """Route-time failure feedback into the health machine — the
        data plane sees a death before the next heartbeat does.  Soft
        failures keep the probe socket alive: the heartbeat gets to
        form its own opinion."""
        rep.fails += 1
        rep.invalidate_pool(drop_probe=hard)
        if hard or rep.fails >= self.eject_after:
            self._transition(rep, EJECTED)
            rep.next_action_at = rep.backoff.next_deadline()
        elif rep.state == HEALTHY:
            self._transition(rep, SUSPECT)

    def route_infer(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """The frontend dispatch loop: admission → deadline check →
        pick → forward → (bounded) retry elsewhere.  Always returns a
        reply dict; never raises to the handler."""
        t0 = time.monotonic()
        model = msg.get("model")
        mlabel = model or "default"
        deadline = None
        if msg.get("deadline_ms") is not None:
            deadline = t0 + float(msg["deadline_ms"]) / 1e3
        with trace.from_message(msg) as tid:
            self._m_requests.labels(model=mlabel).inc()
            if self.shutting_down.is_set():
                return {"error": "fleet frontend is shutting down",
                        "code": "shutting_down", "trace": tid}
            # predictive deadline shed: if the remaining budget is far
            # under this model's typical round trip, the answer cannot
            # arrive in time — fail fast instead of burning a replica
            # slot on a reply nobody will read
            ewma = self._ewma.get(mlabel, 0.0)
            if deadline is not None and (
                    t0 >= deadline
                    or (ewma > 0 and (deadline - t0) < 0.25 * ewma)):
                # decay the estimate on every predictive shed: one slow
                # outlier (a kernel build) must not latch the frontend
                # into shedding all-deadline traffic forever — after a
                # handful of sheds the estimate relaxes and a real
                # request re-measures it
                if ewma > 0:
                    self._ewma[mlabel] = ewma * 0.9
                self._m_shed.labels(reason="deadline").inc()
                self._record(t0, mlabel, "-", 0, "shed_deadline")
                return {"error": "deadline cannot be met "
                                 f"(budget {msg.get('deadline_ms')}ms)",
                        "code": "deadline_exceeded", "trace": tid}
            adm = self._admission(model)
            ok, shed_code = adm.acquire(
                priority=int(msg.get("priority") or 0),
                deadline=deadline, timeout=self.route_timeout)
            if not ok:
                reason = ("deadline" if shed_code == "deadline_exceeded"
                          else "overloaded")
                self._m_shed.labels(reason=reason).inc()
                self._record(t0, mlabel, "-", 0, f"shed_{reason}")
                return {"error": "admission control shed this request "
                                 f"({reason})",
                        "code": shed_code, "trace": tid}
            self._m_inflight.inc()
            try:
                # the frontend's own span for the stitched trace: the
                # request handler track that encloses every attempt
                with profiler.record_block("frontend.request"):
                    return self._route_admitted(msg, mlabel, deadline,
                                                t0, tid)
            finally:
                self._m_inflight.dec()
                adm.release()

    def _route_admitted(self, msg, mlabel, deadline, t0, tid):
        attempts = 0
        tried: set = set()
        last_err = "no healthy replica"
        end = t0 + self.route_timeout
        if deadline is not None:
            end = min(end, deadline)
        while True:
            now = time.monotonic()
            if deadline is not None and now >= deadline:
                self._m_shed.labels(reason="deadline").inc()
                self._record(t0, mlabel, "-", attempts, "shed_deadline")
                return {"error": f"deadline expired after {attempts} "
                                 f"attempt(s): {last_err}",
                        "code": "deadline_exceeded", "trace": tid}
            if attempts > self.max_retries or now >= end:
                # exhausted: the request was never executed, so the shed
                # is retriable — `overloaded` tells the client to back
                # off and try again (the fleet may be mid-recovery)
                self._m_shed.labels(reason="unavailable").inc()
                self._record(t0, mlabel, "-", attempts, "unavailable")
                return {"error": f"no replica could serve this request "
                                 f"after {attempts} attempt(s): {last_err}",
                        "code": "overloaded", "trace": tid}
            rep = self._pick(tried)
            if rep is None:
                if tried:
                    # every healthy replica was tried; widen the net —
                    # one may have recovered or been re-admitted by now
                    tried.clear()
                time.sleep(min(0.05, max(end - now, 0.0)))
                continue
            attempts += 1
            # each forward attempt records its own span tagged
            # attempt=N/replica: the ONE trace id
            # — preserved across the retry-on-another-replica path by
            # trace.inject below — shows a failed and a successful
            # forward as SIBLING spans in the stitched timeline
            t_att = time.perf_counter()

            def _span(outcome):
                profiler.record_span(
                    "fleet.attempt", t_att, time.perf_counter(),
                    attrs={"attempt": attempts, "replica": rep.name,
                           "outcome": outcome})

            try:
                fault.maybe_fault("fleet.route")
                fwd = dict(msg)
                if deadline is not None:
                    fwd["deadline_ms"] = max(
                        (deadline - time.monotonic()) * 1e3, 1.0)
                trace.inject(fwd)
                resp = self._forward(rep, fwd)
            except fault.FaultInjected as e:
                _span("fault")
                last_err = str(e)
                self._m_retries.inc()
                continue
            except (OSError, ConnectionError) as e:
                # the forward died mid-flight: infer is idempotent (the
                # engine resolves futures before replying, and a dead
                # socket means no reply was committed to this client),
                # so another replica may safely run it
                _span("connection_error")
                last_err = f"{type(e).__name__}: {e}"
                hard = (isinstance(e, ConnectionRefusedError)
                        or (rep.owned and rep.proc is not None
                            and rep.proc.poll() is not None))
                self._replica_failed(rep, hard=hard)
                tried.add(rep.rid)
                self._m_retries.inc()
                continue
            code = resp.get("code")
            if "error" in resp and code in RETRIABLE_CODES:
                # the replica itself shed (draining / full queue):
                # retriable by contract — try a different one
                _span(f"shed:{code}")
                last_err = resp.get("error", code)
                if code == "shutting_down":
                    self._replica_failed(rep, hard=False)
                tried.add(rep.rid)
                self._m_retries.inc()
                continue
            # success OR a non-retriable error — both relay verbatim
            # (the replica's error is the client's error; re-executing a
            # bad_feed on another replica would just fail again)
            rep.forwarded += 1
            lat = time.monotonic() - t0
            outcome = "error" if "error" in resp else "ok"
            _span(outcome)
            self._m_replies.labels(model=mlabel, outcome=outcome).inc()
            self._m_latency.labels(model=mlabel).observe(lat)
            # every relayed reply is a measured round trip — error
            # replies included (a bad_feed reply still took the real
            # queue+dispatch path), so the estimate tracks reality even
            # when successes are rare
            prev = self._ewma.get(mlabel, 0.0)
            self._ewma[mlabel] = (lat if prev == 0.0
                                  else 0.8 * prev + 0.2 * lat)
            self._record(t0, mlabel, rep.name, attempts, outcome)
            return resp

    def route_generate(self, msg: Dict[str, Any]):
        """Admission + streamed relay for the ``generate`` verb.  Yields
        every reply line for the handler to write.  Mid-stream replica
        failures retry on another replica: generation is GREEDY, hence
        deterministic, so the replay re-produces the identical token
        stream and the frontend suppresses the first ``sent`` token
        lines — the client never sees a seam (chaos-tested)."""
        t0 = time.monotonic()
        model = msg.get("model")
        mlabel = model or "default"
        deadline = None
        if msg.get("deadline_ms") is not None:
            deadline = t0 + float(msg["deadline_ms"]) / 1e3
        with trace.from_message(msg) as tid:
            self._m_requests.labels(model=mlabel).inc()
            if self.shutting_down.is_set():
                yield {"error": "fleet frontend is shutting down",
                       "code": "shutting_down", "trace": tid}
                return
            adm = self._admission(model)
            ok, shed_code = adm.acquire(
                priority=int(msg.get("priority") or 0),
                deadline=deadline, timeout=self.route_timeout)
            if not ok:
                reason = ("deadline" if shed_code == "deadline_exceeded"
                          else "overloaded")
                self._m_shed.labels(reason=reason).inc()
                yield {"error": f"admission control shed this generate "
                                f"request ({reason})",
                       "code": shed_code, "trace": tid}
                return
            self._m_inflight.inc()
            try:
                with profiler.record_block("frontend.generate"):
                    yield from self._relay_generate(msg, mlabel, deadline,
                                                    t0, tid)
            finally:
                self._m_inflight.dec()
                adm.release()

    def _relay_generate(self, msg, mlabel, deadline, t0, tid):
        attempts = 0
        sent = 0                      # token lines already relayed
        tried: set = set()
        last_err = "no healthy replica"
        end = t0 + self.route_timeout
        if deadline is not None:
            end = min(end, deadline)
        while True:
            now = time.monotonic()
            if deadline is not None and now >= deadline:
                self._m_shed.labels(reason="deadline").inc()
                self._m_streams.labels(model=mlabel,
                                       outcome="deadline").inc()
                yield {"error": f"deadline expired after {attempts} "
                                f"attempt(s): {last_err}",
                       "code": "deadline_exceeded", "trace": tid}
                return
            if attempts > self.max_retries or now >= end:
                self._m_shed.labels(reason="unavailable").inc()
                self._m_streams.labels(model=mlabel,
                                       outcome="unavailable").inc()
                yield {"error": "no replica could finish this generate "
                                f"stream after {attempts} attempt(s): "
                                f"{last_err}",
                       "code": "overloaded", "trace": tid}
                return
            rep = self._pick(tried)
            if rep is None:
                if tried:
                    tried.clear()
                time.sleep(min(0.05, max(end - now, 0.0)))
                continue
            attempts += 1
            fwd = dict(msg)
            if deadline is not None:
                fwd["deadline_ms"] = max(
                    (deadline - time.monotonic()) * 1e3, 1.0)
            trace.inject(fwd)
            with self._lock:
                rep.inflight += 1
                rep.relaying.add(tid)
            client = None
            try:
                fault.maybe_fault("fleet.route")
                client = rep.checkout(self.request_timeout)
                for obj in client.stream_call(fwd):
                    code = obj.get("code")
                    if "error" in obj:
                        if code in RETRIABLE_CODES:
                            # shed before execution: try elsewhere
                            last_err = obj.get("error", code)
                            if code == "shutting_down":
                                self._replica_failed(rep, hard=False)
                            tried.add(rep.rid)
                            self._m_retries.inc()
                            raise _RetryStream()
                        # a non-retriable error relays verbatim
                        self._m_streams.labels(model=mlabel,
                                               outcome="error").inc()
                        yield dict(obj, trace=tid)
                        rep.checkin(client)
                        return
                    if "token" in obj:
                        idx = int(obj.get("index", sent))
                        if idx >= sent:
                            sent = idx + 1
                            self._m_stream_tokens.labels(
                                model=mlabel).inc()
                            yield dict(obj, trace=tid)
                        continue
                    # done line: the stream completed on this replica
                    rep.forwarded += 1
                    lat = time.monotonic() - t0
                    self._m_streams.labels(model=mlabel,
                                           outcome="ok").inc()
                    self._m_replies.labels(model=mlabel,
                                           outcome="ok").inc()
                    self._m_latency.labels(model=mlabel).observe(lat)
                    yield dict(obj, trace=tid)
                    rep.checkin(client)
                    return
                # stream ended without a terminal line: treat as a
                # connection failure and replay elsewhere
                raise ConnectionError("generate stream ended early")
            except _RetryStream:
                if client is not None:
                    client.close()
                continue
            except fault.FaultInjected as e:
                if client is not None:
                    client.close()
                last_err = str(e)
                self._m_retries.inc()
                continue
            except (OSError, ConnectionError) as e:
                # replica died mid-stream: greedy decode is
                # deterministic, so a replay elsewhere emits the same
                # tokens — `sent` suppresses the prefix we already
                # relayed
                if client is not None:
                    client.close()
                last_err = f"{type(e).__name__}: {e}"
                hard = (isinstance(e, ConnectionRefusedError)
                        or (rep.owned and rep.proc is not None
                            and rep.proc.poll() is not None))
                self._replica_failed(rep, hard=hard)
                tried.add(rep.rid)
                self._m_retries.inc()
                continue
            except BaseException:
                # generator abandoned mid-relay (GeneratorExit when the
                # CLIENT disconnected) or an unexpected fault: the
                # replica socket is mid-protocol with unread token
                # lines — close it, never pool it (the same
                # close-on-failure invariant _forward keeps)
                if client is not None:
                    client.close()
                raise
            finally:
                with self._lock:
                    rep.inflight -= 1
                    rep.relaying.discard(tid)

    def _forward(self, rep: _Replica, fwd: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            rep.inflight += 1
        try:
            client = rep.checkout(self.request_timeout)
            try:
                resp = client.raw_call(fwd)
            except BaseException:
                client.close()      # never pool a poisoned connection
                raise
            rep.checkin(client)
            return resp
        finally:
            with self._lock:
                rep.inflight -= 1

    def _record(self, t0: float, model: str, replica: str, attempts: int,
                outcome: str):
        with self._route_n_lock:
            self._route_n += 1
            n = self._route_n
        self.flight.push((time.time(), n, model, replica, attempts,
                          outcome, time.monotonic() - t0,
                          int(self._m_inflight.value)))

    # ------------------------------------------------------------------
    # fleet-wide observability
    # ------------------------------------------------------------------
    def metrics_snapshot(self) -> Dict[str, Any]:
        """One merged metrics snapshot: the frontend process's own
        registry (fleet_* families, slo_* gauges) overlaid with every
        live replica's last heartbeat-pulled snapshot — each replica's
        series labeled ``replica=<id>`` plus a sum/max-merged
        ``replica=fleet`` view per family (`merge_labeled_snapshots`
        rules).  A replica whose snapshot was cleared on ejection
        contributes nothing until its successor is scraped again, and a
        snapshot the heartbeat has failed to refresh for several
        intervals ages out rather than reporting hours-old numbers as
        current."""
        from ..observability import merge_labeled_snapshots
        now = time.monotonic()
        # generous: a couple of missed metrics pulls on an otherwise
        # healthy replica (stats ok, metrics reply garbled) is noise; a
        # snapshot older than this is a lie
        max_age = max(6 * self.health_interval, 3 * self.probe_timeout)
        per = {}
        with self._lock:
            for rep in self._replicas:
                # state-filtered, not just snap-filtered: a probe thread
                # racing an ejection could re-install a dead replica's
                # snapshot after the EJECTED transition cleared it — the
                # drop-out contract is on the STATE, so enforce it here
                if (rep.metrics_snap is not None
                        and rep.state in (HEALTHY, SUSPECT)
                        and now - rep.metrics_ts <= max_age):
                    per[rep.name] = rep.metrics_snap
        return merge_labeled_snapshots(per, into=snapshot())

    def metrics_text(self) -> str:
        """Prometheus text exposition of `metrics_snapshot`."""
        from ..observability import render_snapshot_prometheus
        return render_snapshot_prometheus(self.metrics_snapshot())

    def trace_document(self, trace_id: Optional[str],
                       fmt: Optional[str] = None) -> Dict[str, Any]:
        """Fan the ``trace <id>`` RPC out across the fleet (tentpole
        part c): the frontend's own span/flight slice plus every
        routable replica's, each carrying its (wall, perf) clock
        origin.  ``fmt="chrome"`` returns the stitched Chrome trace
        document directly; otherwise the raw per-process slices, so a
        client can append its OWN slice before stitching — the drawn
        arrow chain then spans client → frontend → replica engine →
        executor."""
        from ..observability import timeline as _tl
        processes = [_tl.process_trace_doc(trace_id, role="frontend")]
        with self._lock:
            targets = [(r.name, r.endpoint) for r in self._replicas
                       if r.endpoint is not None
                       and r.state in (HEALTHY, SUSPECT)]
        # parallel fan-out on dedicated short-lived connections: trace
        # pulls are rare and must not steal pooled data-plane sockets,
        # and ONE hung suspect replica must cost the caller one probe
        # timeout total, not one per replica in line
        results: Dict[str, Dict[str, Any]] = {}

        def pull(name: str, endpoint: str):
            try:
                c = ServingClient(endpoint, timeout=self.probe_timeout,
                                  retries=0)
                try:
                    results[name] = c.raw_call({"method": "trace",
                                                "id": trace_id})
                finally:
                    c.close()
            except (OSError, ConnectionError):
                pass

        threads = [threading.Thread(target=pull, args=t, daemon=True,
                                    name=f"fleet-trace-{t[0]}")
                   for t in targets]
        for t in threads:
            t.start()
        deadline = time.monotonic() + self.probe_timeout + 1.0
        for t in threads:
            t.join(max(deadline - time.monotonic(), 0.0))
        for name, _endpoint in targets:
            resp = results.get(name)
            if resp is None:
                continue
            for proc in (resp.get("trace") or {}).get("processes", ()):
                if proc.get("spans"):
                    proc = dict(proc, role=f"replica {name}")
                    processes.append(proc)
        if fmt == "chrome":
            return {"trace": {"id": trace_id,
                              "chrome": _tl.stitch_processes(processes)}}
        return {"trace": {"id": trace_id, "processes": processes}}

    # ------------------------------------------------------------------
    # admin / introspection
    # ------------------------------------------------------------------
    def forward_admin(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """Relay a read-only admin verb (``models``) to any healthy
        replica — they are homogeneous by construction."""
        rep = self._pick(set())
        if rep is None:
            return {"error": "no healthy replica", "code": "overloaded"}
        try:
            return self._forward(rep, msg)
        except (OSError, ConnectionError) as e:
            return {"error": f"{type(e).__name__}: {e}", "code": "internal"}

    # ------------------------------------------------------------------
    # dynamic scaling: the autoscaling policy's actuators
    # ------------------------------------------------------------------
    def scale_up(self) -> Optional[_Replica]:
        """Add ONE owned replica to the rotation and spawn it.  The new
        process loads the kernels its siblings' build left in
        build/kernels (same sources, same hash).  Returns the new
        replica, or None when the fleet has no model specs to spawn
        from (an adopt-only fleet cannot grow) or is stopping."""
        if not self.models or self._stop.is_set():
            return None
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            pf = os.path.join(self.run_dir, f"replica-{rid}.port")
            log = os.path.join(self.run_dir, f"replica-{rid}.log")
            rep = _Replica(rid, spawn_cmd=self._spawn_cmd(pf),
                           port_file=pf, log_path=log)
            # the health loop skips a replica whose check is in flight:
            # until this spawn has set rep.proc its branch 0 would spawn
            # a second, untracked process (a race the JAX frontend has)
            rep.checking = True
            self._replicas.append(rep)
            self._refresh_state_gauges()
        try:
            self._spawn(rep)
        finally:
            rep.checking = False
        return rep

    def scale_down(self, rid: Optional[int] = None,
                   drain_grace: float = 10.0) -> Optional[_Replica]:
        """Retire one OWNED replica (default: the highest rid, i.e. the
        most recent scale-up) out of the rotation.  The removal happens
        under the routing lock, so no new request picks it; in-flight
        forwards finish because the process gets the same graceful
        ``shutdown``-RPC drain the teardown uses — on a background
        thread, SIGTERM/SIGKILL ladder after ``drain_grace``.  Returns
        the retired replica, or None when nothing is eligible (adopted
        replicas are never retired)."""
        with self._lock:
            cands = [r for r in self._replicas if r.owned
                     and (rid is None or r.rid == rid)]
            if not cands:
                return None
            rep = max(cands, key=lambda r: r.rid)
            rep.retired = True
            self._replicas.remove(rep)
            self._retired_replicas.append(rep)
            self._refresh_state_gauges()
        threading.Thread(target=self._retire, args=(rep, drain_grace),
                         daemon=True,
                         name=f"fleet-retire-{rep.name}").start()
        return rep

    def _retire(self, rep: _Replica, grace: float):
        """Drain-and-stop a retired replica: graceful ``shutdown`` RPC
        (the replica's registry drains in-flight work before exiting),
        SIGTERM after ``grace``, SIGKILL as the last resort."""
        if (rep.proc is not None and rep.proc.poll() is None
                and rep.endpoint):
            try:
                c = ServingClient(rep.endpoint, timeout=2.0, retries=0)
                try:
                    c.raw_call({"method": "shutdown"})
                finally:
                    c.close()
            except Exception:  # noqa: BLE001 — SIGTERM is next
                pass
        if rep.proc is not None:
            try:
                rep.proc.wait(grace)
            except (subprocess.TimeoutExpired, OSError):
                pass
            try:
                if rep.proc.poll() is None:
                    rep.proc.terminate()
                rep.proc.wait(5.0)
            except (subprocess.TimeoutExpired, OSError):
                try:
                    rep.proc.kill()
                    rep.proc.wait(5.0)
                except OSError:
                    pass
        rep.invalidate_pool()

    def replica(self, rid: int) -> _Replica:
        # by rid, not list position: after a scale-down the list can
        # have holes in its rid sequence
        for r in self._replicas:
            if r.rid == rid:
                return r
        raise IndexError(f"no replica with rid {rid} in the rotation")

    @property
    def replicas(self) -> List[_Replica]:
        return list(self._replicas)

    def healthy_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas if r.state == HEALTHY)

    def describe(self) -> Dict[str, Any]:
        with self._lock:
            reps = [r.describe() for r in self._replicas]
            admissions = {k: {"bound": a.bound,
                              "outstanding": a.outstanding,
                              "queued": a.queued}
                          for k, a in self._admissions.items()}
        return {"endpoint": f"{self.host}:{self.port}",
                "models": dict(self.models),
                "compile_cache": self.compile_cache,
                "health_interval": self.health_interval,
                "replicas": reps,
                "admission": admissions}

    def stats(self) -> Dict[str, Any]:
        """Fleet-level summary in a ``stats``-verb-compatible shape —
        ``queue_depth`` aggregates the replicas', so a FleetFrontend can
        itself be heartbeat-probed (fleets of fleets compose)."""
        with self._lock:
            depth = sum(r.last_depth for r in self._replicas)
            by_state = {s: sum(1 for r in self._replicas if r.state == s)
                        for s in _STATES}
            forwarded = {r.name: r.forwarded for r in self._replicas}
            restarts = sum(r.restarts for r in self._replicas)
        sheds = {labels["reason"]: int(series.value)
                 for labels, series in self._m_shed.items()}
        out = {"fleet": True,
               "queue_depth": depth,
               "replicas": by_state,
               "forwarded": forwarded,
               "restarts": restarts,
               "requests": int(sum(s.value for _, s
                                   in self._m_requests.items())),
               "retries": int(self._m_retries.value),
               "shed": sheds,
               "readmitted": int(self._m_readmitted.value)}
        if self.slo_monitor is not None:
            out["slo"] = dict(self.slo_monitor.last)
        if self.autoscaler is not None:
            # the live policy state (last decision,
            # cooldown remaining) rides the stats page so `top` can
            # render a scale event without anyone grepping logs
            out["autoscaler"] = self.autoscaler.describe()
        return out
