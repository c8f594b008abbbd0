"""The elastic dataset master (counterpart of
``paddle_tpu/distributed/master.py``, byte for byte its wire, so either
package's client talks to either package's master).

`MasterService` partitions record files into tasks of
``chunks_per_task`` chunks (`set_dataset`), leases them to trainers
(`get_task`) with a deadline, and keeps the todo, pending and done
queues: a finished task moves to done (a drained pass starts the next,
with a new epoch), a failed one goes back to todo until its failure
budget is spent (then it is discarded), and an expired lease goes back
to the front of todo.  A worker first seen after leasing began counts as
re-admitted and starts at the current pass (`register`); a ``get_task``
retransmitted with the same request id gets the lease it already holds.
With ``snapshot_path`` every change is written to a file, from which a
restarted master recovers (pending leases go back to todo).

The wire (`MasterServer`, `_Handler`) is newline-delimited JSON over
TCP; it carries task descriptors only, and clients read the record files
themselves (`MasterClient.next_record` and `records`, over
`recordio.Scanner`).  Every master method is idempotent, so the client
retries a dropped connection with bounded backoff.

Metrics: ``master_tasks_leased_total``, ``master_tasks_finished_total``,
``master_task_retries_total``, ``master_tasks_discarded_total``,
``master_lease_expirations_total``, ``master_get_task_seconds`` and
``master_workers_readmitted_total``; the fault point ``master.rpc`` drops
a client call.
"""
from __future__ import annotations

import contextlib
import json
import os
import socket
import socketserver
import threading
import time
from dataclasses import dataclass, field, asdict
from typing import Dict, List, Optional

from .. import recordio
from .. import fault as _fault
from ..io import _atomic_write
from ..observability import default_registry as _obs_registry
from ..observability import trace as _trace
from .backoff import Backoff

__all__ = ["Task", "MasterService", "MasterServer", "MasterClient",
           "NoMoreTasks", "AllTasksFailed"]

# no-ops until the process registry is enabled
_M_LEASED = _obs_registry().counter(
    "master_tasks_leased_total", "tasks handed to trainers")
_M_FINISHED = _obs_registry().counter(
    "master_tasks_finished_total", "tasks completed by trainers")
_M_RETRIES = _obs_registry().counter(
    "master_task_retries_total", "tasks re-queued after a reported failure")
_M_DISCARDED = _obs_registry().counter(
    "master_tasks_discarded_total", "tasks dropped over the failure budget")
_M_EXPIRED = _obs_registry().counter(
    "master_lease_expirations_total",
    "leases reclaimed after timeout (straggler/crashed trainer)")
_M_GET_TASK_S = _obs_registry().histogram(
    "master_get_task_seconds", "get_task service time")
_M_READMITTED = _obs_registry().counter(
    "master_workers_readmitted_total",
    "replacement workers admitted after leasing began (elastic refill)")


class NoMoreTasks(Exception):
    """The current pass is exhausted.

    ``retryable`` is True when the pass is not actually over — every
    remaining task is merely leased to another worker, so the caller
    should retry (a lease may expire back into the todo queue).
    """

    def __init__(self, msg: str = "", retryable: bool = False):
        super().__init__(msg)
        self.retryable = retryable


class AllTasksFailed(Exception):
    """Every task exceeded its failure budget."""


@dataclass
class Task:
    id: int
    path: str
    chunk_begin: int
    chunk_end: int            # exclusive
    epoch: int = 0
    num_failures: int = 0

    def to_json(self):
        return asdict(self)

    @staticmethod
    def from_json(d):
        return Task(**d)


@dataclass
class _Lease:
    task: Task
    deadline: float
    worker: str = ""
    req: Optional[int] = None     # client request id (at-most-once retry)


class MasterService:
    """In-process core: queues + timeouts + failure budget + snapshot."""

    def __init__(self, chunks_per_task: int = 1, timeout_s: float = 60.0,
                 failure_max: int = 3, snapshot_path: Optional[str] = None):
        self.chunks_per_task = chunks_per_task
        self.timeout_s = timeout_s
        self.failure_max = failure_max
        self.snapshot_path = snapshot_path
        self._lock = threading.Lock()
        self._todo: List[Task] = []
        self._pending: Dict[int, _Lease] = {}
        self._done: List[Task] = []
        self._discarded: List[Task] = []
        self._epoch = 0
        self._next_id = 0
        # re-admission bookkeeping: worker id -> last
        # contact; a worker id FIRST seen after leasing began is a
        # replacement joining mid-round
        self._workers: Dict[str, float] = {}
        self._ever_leased = False
        if snapshot_path and os.path.exists(snapshot_path):
            self._recover()

    # -- dataset registration -------------------------------------------------
    def set_dataset(self, paths: List[str]):
        """Split every recordio file into chunk-range tasks."""
        with self._lock:
            if self._todo or self._pending or self._done:
                return            # set once
            for path in sorted(paths):
                n = recordio.num_chunks(path)
                for begin in range(0, n, self.chunks_per_task):
                    end = min(begin + self.chunks_per_task, n)
                    self._todo.append(Task(self._next_id, path, begin, end,
                                           epoch=self._epoch))
                    self._next_id += 1
            self._snapshot_locked()

    # -- trainer RPCs --------------------------------------------------------
    def register(self, worker: str = "") -> int:
        """Admit (or re-admit) a worker -> the current pass id: a
        replacement that joins on pass k starts at pass k.  A worker id
        first seen after leasing began counts as a re-admission
        (``master_workers_readmitted_total``)."""
        with self._lock:
            if worker and worker not in self._workers and self._ever_leased:
                _M_READMITTED.inc()
            if worker:
                self._workers[worker] = time.monotonic()
            return self._epoch

    def get_task(self, worker: str = "", epoch: Optional[int] = None,
                 req: Optional[int] = None) -> Task:
        """Lease a task; expired leases are reclaimed first.

        ``epoch`` is the caller's pass id: a caller still on an older
        pass gets "pass complete" once, so each client sees its pass end
        although ``task_finished`` refills the queue when a pass drains.
        """
        t0 = time.perf_counter()
        with self._lock:
            self._reclaim_expired_locked()
            if epoch is not None and epoch < self._epoch:
                raise NoMoreTasks("pass complete")
            # at most once: a worker whose reply was lost retransmits
            # the same ``req`` id and gets the same task with a fresh
            # deadline (a caller without ``req`` leases a new task each
            # call)
            if worker and req is not None:
                for lease in self._pending.values():
                    if lease.worker == worker and lease.req == req:
                        lease.deadline = time.monotonic() + self.timeout_s
                        self._workers[worker] = time.monotonic()
                        _M_GET_TASK_S.observe(time.perf_counter() - t0)
                        return lease.task
            if not self._todo:
                if self._pending:
                    raise NoMoreTasks("all tasks leased; retry later",
                                      retryable=True)
                if not self._done and self._discarded:
                    raise AllTasksFailed(
                        f"{len(self._discarded)} tasks over failure budget")
                raise NoMoreTasks("pass complete")
            task = self._todo.pop(0)
            self._pending[task.id] = _Lease(
                task, time.monotonic() + self.timeout_s, worker, req)
            if worker:
                self._workers[worker] = time.monotonic()
            self._ever_leased = True
            self._snapshot_locked()
            _M_LEASED.inc()
            _M_GET_TASK_S.observe(time.perf_counter() - t0)
            return task

    def task_finished(self, task_id: int):
        """Move the task from pending to done; a drained pass starts the
        next."""
        with self._lock:
            lease = self._pending.pop(task_id, None)
            if lease is None:
                return
            self._done.append(lease.task)
            _M_FINISHED.inc()
            if not self._todo and not self._pending:
                self._start_new_pass_locked()
            self._snapshot_locked()

    def task_failed(self, task_id: int):
        """Re-queue the task unless its failure budget is spent."""
        with self._lock:
            lease = self._pending.pop(task_id, None)
            if lease is None:
                return
            self._requeue_locked(lease.task)
            self._snapshot_locked()

    # -- internals -----------------------------------------------------------
    def _requeue_locked(self, task: Task, front: bool = False):
        task.num_failures += 1
        if task.num_failures >= self.failure_max:
            self._discarded.append(task)    # a poisoned chunk: dropped
            _M_DISCARDED.inc()
        elif front:
            self._todo.insert(0, task)
            _M_RETRIES.inc()
        else:
            self._todo.append(task)
            _M_RETRIES.inc()

    def _reclaim_expired_locked(self):
        """Reclaimed leases go to the front of the todo queue, so the
        next caller inherits a dead worker's task before fresh work.  The
        failure budget is per task (``num_failures`` travels with it),
        never per worker."""
        now = time.monotonic()
        for tid in [t for t, l in self._pending.items() if l.deadline <= now]:
            lease = self._pending.pop(tid)
            _M_EXPIRED.inc()
            self._requeue_locked(lease.task, front=True)

    def _start_new_pass_locked(self):
        self._epoch += 1
        for t in self._done:
            t.epoch, t.num_failures = self._epoch, 0
        self._todo, self._done = self._done, []

    # -- snapshot and recover --------------------------------------------------
    def _snapshot_locked(self):
        if not self.snapshot_path:
            return
        state = {
            "epoch": self._epoch, "next_id": self._next_id,
            "todo": [t.to_json() for t in self._todo],
            # leases do not survive a restart: pending re-queues
            "pending": [l.task.to_json() for l in self._pending.values()],
            "done": [t.to_json() for t in self._done],
            "discarded": [t.to_json() for t in self._discarded],
        }
        tmp = self.snapshot_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self.snapshot_path)

    def _recover(self):
        with open(self.snapshot_path) as f:
            state = json.load(f)
        self._epoch = state["epoch"]
        self._next_id = state["next_id"]
        self._todo = ([Task.from_json(d) for d in state["todo"]]
                      + [Task.from_json(d) for d in state["pending"]])
        self._done = [Task.from_json(d) for d in state["done"]]
        self._discarded = [Task.from_json(d) for d in state["discarded"]]


# ---------------------------------------------------------------------------
# the TCP wire (newline-delimited JSON)
# ---------------------------------------------------------------------------

class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        svc: MasterService = self.server.service       # type: ignore
        for line in self.rfile:
            try:
                req = json.loads(line)
                method = req["method"]
                tid = _trace.extract(req)
            except Exception as e:          # noqa: BLE001 - the wire
                self.wfile.write((json.dumps(
                    {"ok": False, "error": str(e)}) + "\n").encode())
                self.wfile.flush()
                continue
            with _trace.scope(tid) if tid else contextlib.nullcontext():
                resp = self._dispatch(svc, method, req)
            if tid:
                resp["trace"] = tid
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()

    @staticmethod
    def _dispatch(svc, method, req):
        try:
            if method == "get_task":
                task = svc.get_task(req.get("worker", ""),
                                    req.get("epoch"), req.get("req"))
                return {"ok": True, "task": task.to_json()}
            if method == "register":
                epoch = svc.register(req.get("worker", ""))
                return {"ok": True, "epoch": epoch}
            if method == "task_finished":
                svc.task_finished(req["task_id"])
                return {"ok": True}
            if method == "task_failed":
                svc.task_failed(req["task_id"])
                return {"ok": True}
            if method == "set_dataset":
                svc.set_dataset(req["paths"])
                return {"ok": True}
            return {"ok": False, "error": f"no method {method}"}
        except NoMoreTasks as e:
            return {"ok": False, "error": "no_more_tasks",
                    "detail": str(e), "retry": e.retryable}
        except AllTasksFailed as e:
            return {"ok": False, "error": "all_tasks_failed",
                    "detail": str(e)}
        except Exception as e:              # noqa: BLE001 - the wire
            return {"ok": False, "error": str(e)}


class MasterServer:
    """Threaded TCP server around a `MasterService`; binds port 0 by
    default and writes the bound port to ``port_file``."""

    def __init__(self, service: MasterService, host: str = "127.0.0.1",
                 port: int = 0, port_file: Optional[str] = None):
        self.service = service
        self._server = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=True)
        self._server.daemon_threads = True
        self._server.service = service                 # type: ignore
        self.host, self.port = self._server.server_address[:2]
        if port_file:
            # atomic: a reader sees no file or the whole port
            with _atomic_write(port_file) as f:
                f.write(str(self.port))
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class MasterClient:
    """The trainer's client: ``next_record()`` leases tasks and streams
    the records of their chunk ranges, read from the files directly."""

    def __init__(self, host: str, port: int, worker: str = "",
                 retry_interval: float = 0.2, timeout_sec: float = 30,
                 rpc_retries: int = 3):
        self._addr = (host, port)
        self._worker = worker or f"pid{os.getpid()}"
        self._retry = retry_interval
        self._timeout = timeout_sec
        self._rpc_retries = max(0, rpc_retries)
        self._sock = None
        self._rfile = None
        self._task: Optional[Task] = None
        self._records = None
        self._epoch = 0               # this client's pass id
        self._req_seq = 0             # get_task request ids (at-most-once)
        self._registered = False
        # seeded by the worker id: desynchronised across workers,
        # reproducible for each
        self._backoff = Backoff(base=retry_interval, cap=5.0,
                                seed=self._worker)

    def _connect(self):
        if self._sock is None:
            self._sock = socket.create_connection(self._addr,
                                                  timeout=self._timeout)
            self._rfile = self._sock.makefile("rb")

    def _call(self, method, **kw):
        """One RPC round trip.  Every master method is idempotent, so a
        dropped connection retries with bounded backoff (the master may
        be restarting from its snapshot)."""
        retry = Backoff(base=self._retry, cap=2.0, seed=self._worker)
        attempts = self._rpc_retries + 1
        for attempt in range(attempts):
            if _fault.maybe_fault("master.rpc"):
                # an injected lost connection
                self.close()
                if attempt + 1 >= attempts:
                    raise ConnectionError("fault injected: master rpc "
                                          "dropped")
                retry.sleep()
                continue
            try:
                self._connect()
                msg = _trace.inject(dict(method=method,
                                         worker=self._worker, **kw))
                self._sock.sendall((json.dumps(msg) + "\n").encode())
                line = self._rfile.readline()
                if not line:
                    raise ConnectionError("master closed the connection")
                return json.loads(line)
            except (OSError, ConnectionError):
                self.close()
                if attempt + 1 >= attempts:
                    raise
                retry.sleep()

    def register(self) -> int:
        """Announce this worker and adopt the master's current pass."""
        resp = self._call("register")
        if resp.get("ok"):
            self._epoch = max(self._epoch, int(resp["epoch"]))
        self._registered = True
        return self._epoch

    def set_dataset(self, paths: List[str]):
        resp = self._call("set_dataset", paths=paths)
        if not resp["ok"]:
            raise RuntimeError(resp["error"])

    def get_task(self) -> Task:
        # one request id a lease request: _call's retries retransmit it,
        # so a lost reply re-fetches that lease
        self._req_seq += 1
        resp = self._call("get_task", epoch=self._epoch, req=self._req_seq)
        if resp["ok"]:
            return Task.from_json(resp["task"])
        if resp["error"] == "no_more_tasks":
            raise NoMoreTasks(resp.get("detail", ""),
                              retryable=resp.get("retry", False))
        if resp["error"] == "all_tasks_failed":
            raise AllTasksFailed(resp.get("detail", ""))
        raise RuntimeError(resp["error"])

    def task_finished(self, task_id: int):
        self._call("task_finished", task_id=task_id)

    def task_failed(self, task_id: int):
        self._call("task_failed", task_id=task_id)

    def next_record(self) -> Optional[bytes]:
        """The next record of the current pass; None at the pass end.

        Blocks while every remaining task is leased to other workers,
        until a holder drains the pass or a lease expires and this client
        inherits its task.  One client a worker process.
        """
        if not self._registered:
            self.register()
        while True:
            if self._records is not None:
                rec = next(self._records, None)
                if rec is not None:
                    return rec
                self.task_finished(self._task.id)
                self._task, self._records = None, None
            try:
                self._task = self.get_task()
                self._epoch = max(self._epoch, self._task.epoch)
                self._backoff.reset()
            except NoMoreTasks as e:
                if e.retryable:
                    # seeded jittered backoff: survivors waiting on a dead
                    # peer's lease do not poll in lockstep
                    self._backoff.sleep()
                    continue
                self._epoch += 1      # advance to the next pass
                self._backoff.reset()
                return None
            self._records = iter(recordio.Scanner(
                self._task.path, chunk_begin=self._task.chunk_begin,
                chunk_end=self._task.chunk_end))

    def records(self):
        """The records of one pass."""
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec

    def close(self):
        if self._sock is not None:
            self._sock.close()
            self._sock = None
