"""Threaded TCP serving endpoint (counterpart of
``paddle_tpu/serving/server.py``; the wire is the JAX package's byte for
byte, so either package's client talks to either package's server).

One JSON object per line; tensors as ``{shape, dtype, base64 data}``
(`distributed.param_server`'s codec, `_encode` / `_decode`).  The server
binds port 0 and publishes the real port through a port file
(`write_port_file` / `wait_for_port_file`).  Connections persist; each
handler thread blocks in its engine, so the batcher sees every
connection at once.

Verbs: ``infer`` (routed by the message's ``"model"``, absent = the
registry default; ``"deadline_ms"`` is the remaining budget),
``generate`` (one ``{"token"}`` line per token unless ``"stream":
false``, then one ``{"done": true}`` line), ``stats``, ``metrics``
(Prometheus text, or a snapshot with ``"format": "json"``), ``models``,
``load``, ``unload``, ``reload``, ``apply_deltas`` (a model's row-delta
chain head onto its live predictor), ``inspect`` (the process's cost
reports, `observability.introspect.summary`), ``trace`` (this process's
spans and flight records of one trace id,
`observability.timeline.process_trace_doc`) and ``shutdown``.  Errors
are ``{"error", "code"}`` with code one of
``unknown_model`` / ``bad_feed`` / ``shutting_down`` / ``overloaded`` /
``deadline_exceeded`` / ``bad_request`` / ``internal``;
``shutting_down`` and ``overloaded`` are retriable (the request never
ran).  `drain_and_stop` flags shutdown first, lets in-flight requests
finish and reply, then stops the listener.
"""
from __future__ import annotations

import itertools
import json
import os
import socket
import socketserver
import tempfile
import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from .. import fault, profiler
from ..distributed.backoff import Backoff
from ..distributed.param_server import _decode, _encode
from ..io import _atomic_write
from ..observability import render_prometheus, snapshot, trace
from .engine import EngineOverloadedError, ServingEngine
from .registry import GenerationUnsupportedError, ModelRegistry, \
    UnknownModelError

#: where a server publishes its port when no port file is named, and
#: where the ``models`` / ``metrics`` CLI verbs look for it
SELECTED_PORT_FILE = os.path.join(tempfile.gettempdir(),
                                  "paddle_tpu_torch.serving_port")


def write_port_file(path: str, port: int):
    """Publish a selected port atomically: a reader sees no file or one
    complete line."""
    with _atomic_write(path) as f:
        f.write(f"{int(port)}\n")


def wait_for_port_file(path: str, timeout: float = 60.0,
                       poll_s: float = 0.05) -> int:
    """Block until ``path`` holds a complete port line; returns the port.

    The companion of `write_port_file`: atomic writers make a visible
    file complete by construction, but this waiter also tolerates legacy
    non-atomic writers (and NFS-ish laggards) by treating an empty or
    unparsable file as "not yet" rather than an error, until
    ``timeout``."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            with open(path) as f:
                line = f.readline().strip()
            if line:
                return int(line)
        except (OSError, ValueError):
            pass
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"no complete port line at {path} after {timeout}s")
        time.sleep(poll_s)


class ServingError(RuntimeError):
    """A structured error reply from the endpoint.

    ``code`` distinguishes who is at fault: ``unknown_model`` /
    ``bad_feed`` / ``bad_request`` are the caller's; ``shutting_down``
    and ``overloaded`` are retriable (the request never executed);
    ``deadline_exceeded`` means the latency budget ran out;
    ``internal`` is the server's."""

    def __init__(self, message: str, code: str = "internal"):
        super().__init__(f"serving error [{code}]: {message}")
        self.code = code
        self.message = message

    @property
    def retriable(self) -> bool:
        return self.code in RETRIABLE_CODES


#: wire codes a client may safely retry: the server guarantees the
#: request was rejected BEFORE execution (shed at admission or at the
#: shutdown gate), so a re-send can never double-execute
RETRIABLE_CODES = ("shutting_down", "overloaded")


# the exact teardown sentinels raised by ServingEngine.submit and the
# handler — substring-matching any 'closed' would misclassify real model
# faults (e.g. "I/O operation on closed file") as retriable
_SHUTDOWN_MESSAGES = ("ServingEngine is closed", "DecodeEngine is closed",
                      "server is closed")


def _code_for(exc: BaseException) -> str:
    """Map a server-side exception to its wire error code."""
    if isinstance(exc, UnknownModelError):
        return "unknown_model"
    if isinstance(exc, GenerationUnsupportedError):
        return "bad_request"
    if isinstance(exc, EngineOverloadedError):
        return "overloaded"
    if isinstance(exc, TimeoutError):
        # the engine future outlived the request's deadline budget
        # (TimeoutError is an OSError subclass — check it here, not in
        # the transport-retry tuple)
        return "deadline_exceeded"
    if isinstance(exc, (KeyError, ValueError, TypeError)):
        return "bad_feed"
    if isinstance(exc, RuntimeError) and any(m in str(exc)
                                             for m in _SHUTDOWN_MESSAGES):
        return "shutting_down"
    return "internal"


def _err(exc: BaseException, code: Optional[str] = None) -> Dict[str, Any]:
    # str(KeyError) quotes its arg; unwrap so messages read cleanly
    msg = exc.args[0] if (isinstance(exc, KeyError) and exc.args) else str(exc)
    return {"error": f"{type(exc).__name__}: {msg}"
            if code is None else str(msg),
            "code": code or _code_for(exc)}


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        for line in self.rfile:
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                break
            method = msg.get("method")
            registry: ModelRegistry = self.server.registry
            if method == "infer":
                # adopt the client's trace id (minting one for trace-less
                # clients) for the dynamic extent of the request: the
                # engine captures it at submit and the reply echoes it,
                # so the caller can join its span to ours
                with trace.from_message(msg) as tid:
                    # count BEFORE checking the drain flag (no
                    # check-then-act gap: a request is either visible to
                    # drain_and_stop's wait or sees the flag and gets the
                    # retriable shutting_down wire code), and keep the
                    # reply write inside the counted window — handler
                    # threads are daemons, so the drain must not return
                    # while a promised reply is still unsent
                    self.server._request_began()
                    try:
                        try:
                            if self.server.shutting_down.is_set():
                                raise RuntimeError("server is closed")
                            # deadline propagation: the
                            # message carries the REMAINING budget in
                            # relative ms; an already-expired budget
                            # sheds before touching the engine queue,
                            # and a live one bounds the future wait so
                            # the reply is an explicit deadline_exceeded
                            # instead of a client-side socket timeout
                            deadline_ms = msg.get("deadline_ms")
                            timeout = None
                            if deadline_ms is not None:
                                timeout = float(deadline_ms) / 1e3
                                if timeout <= 0:
                                    raise TimeoutError(
                                        "deadline expired before dispatch")
                            feed = {k: _decode(v)
                                    for k, v in msg["feed"].items()}
                            with profiler.record_block("serving.request"):
                                outs, entry = registry.infer_with_entry(
                                    msg.get("model"), feed,
                                    timeout=timeout)
                            names = entry.predictor.fetch_names
                            resp = {"fetch": {n: _encode(np.asarray(o))
                                              for n, o in zip(names, outs)},
                                    "model": entry.name,
                                    "trace": tid}
                        except Exception as e:  # noqa: BLE001 — error slot
                            resp = dict(_err(e), trace=tid)
                        self.wfile.write((json.dumps(resp) + "\n").encode())
                        self.wfile.flush()
                    finally:
                        self.server._request_done()
                continue
            elif method == "generate":
                # token-streaming autoregressive decode: one
                # request, MANY newline-JSON replies on the same
                # connection — a {"token": ...} line per emitted token
                # (suppressed for "stream": false), closed by exactly
                # one {"done": true, "tokens": [...]} line.  Errors are
                # the usual one structured error line.
                with trace.from_message(msg) as tid:
                    self.server._request_began()
                    try:
                        try:
                            if self.server.shutting_down.is_set():
                                raise RuntimeError("server is closed")
                            # the whole stream is one span (the JAX
                            # server spans only infer), so a generate's
                            # trace holds its request beside the engine's
                            # prefill and steps
                            with profiler.record_block("serving.request"):
                                entry = registry.generate_entry(
                                    msg.get("model"))
                                prompt = msg.get("prompt")
                                if isinstance(prompt, dict):
                                    prompt = _decode(prompt)
                                handle = entry.decode.submit(
                                    prompt,
                                    max_new_tokens=int(
                                        msg.get("max_new_tokens", 16)),
                                    eos_id=msg.get("eos_id"),
                                    deadline_ms=msg.get("deadline_ms"))
                                stream = bool(msg.get("stream", True))
                                count = 0
                                # events() only returns after a terminal
                                # event, but never let a contract break
                                # leave `resp` unbound past the loop
                                resp = {"error": "generation stream ended "
                                                 "without a terminal event",
                                        "code": "internal", "trace": tid}
                                for ev in handle.events():
                                    if ev[0] == "token":
                                        count += 1
                                        if stream:
                                            line = {"token": int(ev[2]),
                                                    "index": int(ev[1]),
                                                    "model": entry.name,
                                                    "trace": tid}
                                            self.wfile.write(
                                                (json.dumps(line)
                                                 + "\n").encode())
                                            self.wfile.flush()
                                            fault.maybe_fault(
                                                "serve.stream_token")
                                    elif ev[0] == "error":
                                        raise ev[1]
                                    else:
                                        resp = {"done": True,
                                                "tokens": [int(t)
                                                           for t in ev[2]],
                                                "finish_reason": ev[1],
                                                "count": count,
                                                "model": entry.name,
                                                "trace": tid}
                        except Exception as e:  # noqa: BLE001
                            resp = dict(_err(e), trace=tid)
                        self.wfile.write((json.dumps(resp) + "\n").encode())
                        self.wfile.flush()
                    finally:
                        self.server._request_done()
                continue
            elif method == "stats":
                try:
                    entry = registry.get(msg.get("model"))
                    resp = {"stats": registry.stats_for(entry),
                            "model": entry.name}
                except Exception as e:  # noqa: BLE001
                    resp = _err(e)
            elif method == "metrics":
                # GET-style exposition of the whole process registry
                # (engine series + executor/predictor/reader families)
                if msg.get("format") == "json":
                    resp = {"metrics": snapshot()}
                else:
                    resp = {"metrics": render_prometheus()}
            elif method == "inspect":
                # every (program, feed signature) this process has run,
                # with its cost report
                from ..observability import introspect
                resp = {"introspection": introspect.summary()}
            elif method == "trace":
                # this process's spans and flight records of one trace
                # id, with the (wall, perf) clock origin a stitcher
                # aligns them by
                from ..observability import timeline as _tl
                resp = {"trace": {
                    "id": msg.get("id"),
                    "processes": [_tl.process_trace_doc(
                        msg.get("id"), role="serve")]}}
            elif method == "models":
                resp = {"models": registry.describe()}
            elif method == "load":
                try:
                    entry = registry.load(
                        msg["model"], msg["dir"],
                        params_filename=msg.get("params_filename"),
                        transpile=msg.get("transpile", True),
                        mesh=msg.get("mesh"),
                        engine_opts=msg.get("options"),
                        warmup=msg.get("warmup"))
                    resp = {"ok": True, "model": entry.describe()}
                except Exception as e:  # noqa: BLE001
                    resp = _err(e, "bad_request"
                                if isinstance(e, (KeyError, ValueError))
                                else None)
            elif method == "unload":
                try:
                    registry.unload(msg["model"])
                    resp = {"ok": True}
                except Exception as e:  # noqa: BLE001
                    resp = _err(e)
            elif method == "reload":
                try:
                    reloaded = registry.reload(msg["model"])
                    resp = {"ok": True, "reloaded": reloaded,
                            "model": registry.get(msg["model"]).describe()}
                except Exception as e:  # noqa: BLE001
                    resp = _err(e)
            elif method == "apply_deltas":
                # streaming embedding deltas: rows patched on the live
                # predictor, no engine drained or rebuilt
                try:
                    resp = {"ok": True,
                            "delta": registry.apply_deltas(msg["model"])}
                except Exception as e:  # noqa: BLE001
                    resp = _err(e)
            elif method == "shutdown":
                resp = {"ok": True}
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()
                # flag first: embedders (the serve CLI) wait on this to
                # tear down the engine and exit the process
                self.server.shutting_down.set()
                threading.Thread(target=self.server.shutdown,
                                 daemon=True).start()
                return
            else:
                resp = {"error": f"unknown method {method!r}",
                        "code": "bad_request"}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


class InferenceServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, registry, host: str = "127.0.0.1", port: int = 0,
                 port_file: Optional[str] = None):
        super().__init__((host, port), _Handler)
        if isinstance(registry, ServingEngine):
            # the single-engine shape InferenceServer(engine): wrap the
            # lone engine as the registry default so the wire behaves
            # identically for model-field-free clients
            engine = registry
            registry = ModelRegistry()
            registry.add(engine.model, engine)
        self.registry: ModelRegistry = registry
        self.host = host
        self.port = self.server_address[1]
        # set on remote shutdown OR stop(): whatever owns the process can
        # wait on it for "this server is done" regardless of trigger
        self.shutting_down = threading.Event()
        # in-flight request accounting for the graceful drain:
        # requests past the shutting_down gate but not yet replied
        self._active = 0
        self._active_cv = threading.Condition()
        if port_file is None:
            port_file = SELECTED_PORT_FILE
        if port_file:
            # atomic: a concurrent waiter sees no file or a complete line
            write_port_file(port_file, self.port)
        self._thread: Optional[threading.Thread] = None

    @property
    def engine(self) -> ServingEngine:
        """The default model's engine (single-model embedders' handle)."""
        return self.registry.get(None).engine

    def start(self) -> "InferenceServer":
        self._thread = threading.Thread(target=self.serve_forever,
                                        kwargs={"poll_interval": 0.1},
                                        daemon=True, name="serving-endpoint")
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0):
        self.shutting_down.set()
        self.shutdown()
        self.server_close()
        if self._thread is not None:
            self._thread.join(timeout)

    # -- graceful drain -------------------------------------------------
    def _request_began(self):
        with self._active_cv:
            self._active += 1

    def _request_done(self):
        with self._active_cv:
            self._active -= 1
            if self._active == 0:
                self._active_cv.notify_all()

    def drain_and_stop(self, timeout: float = 30.0) -> bool:
        """Preemption-safe teardown, the serving counterpart of
        checkpoint+resume: flag shutdown FIRST (new ``infer`` messages —
        even on live persistent connections — get the retriable
        ``shutting_down`` wire code), wait for every in-flight request to
        finish through the engines' normal dispatch path, then stop the
        listener.  Returns False if in-flight work outlived ``timeout``.
        The caller still owns engine teardown (``registry.close`` drains
        queued-but-unsubmitted work)."""
        self.shutting_down.set()
        end = time.monotonic() + timeout
        drained = True
        with self._active_cv:
            while self._active > 0:
                remaining = end - time.monotonic()
                if remaining <= 0:
                    drained = False
                    break
                self._active_cv.wait(timeout=remaining)
        self.stop()
        return drained


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------

# socket/connection failures that one transparent reconnect may cure on
# an idempotent call (ConnectionError and socket.timeout are OSErrors)
_RETRYABLE = (OSError,)


class ServingClient:
    """Persistent-connection client: one socket, many requests.

    Idempotent calls (``infer``, ``stats``, ``metrics``, ``models``)
    survive transient failures transparently:
    connection errors reconnect-and-retry, and the *retriable* wire
    codes — ``shutting_down`` (server draining) and ``overloaded``
    (admission shed; the request never executed) — retry instead of
    raising.  Retries are bounded (``retries``) and paced by a seeded
    `distributed.backoff.Backoff` — seeded per CLIENT (endpoint + pid +
    an instance counter, a per-caller identity), so a
    thousand clients hammering one restarting server desynchronize:
    seeding by endpoint alone would put every client on the identical
    jitter schedule and the herd would retry in lockstep.  Mutating
    admin verbs (``load``/``unload``/``reload``) are never retried."""

    _instances = itertools.count()

    def __init__(self, endpoint: str, timeout: float = 60.0,
                 retries: int = 3, backoff: Optional[Backoff] = None):
        host, port = endpoint.rsplit(":", 1)
        self._host, self._port = host, int(port)
        self._timeout = timeout
        self._retries = max(0, int(retries))
        self._backoff = backoff or Backoff(
            base=0.02, cap=1.0,
            seed=f"{endpoint}|{os.getpid()}|{next(self._instances)}")
        self._connect()
        #: trace id of the most recent infer() reply — the handle that
        #: links this client's request to the server's engine.batch and
        #: executor.run spans (and the server-side metrics/profiles)
        self.last_trace: Optional[str] = None

    def _connect(self):
        self._sock = socket.create_connection((self._host, self._port),
                                              timeout=self._timeout)
        self._sock.settimeout(self._timeout)
        self._f = self._sock.makefile("rwb")

    def _send_recv(self, payload: bytes) -> Dict[str, Any]:
        if self._f is None:
            # a prior retry episode ended with the socket closed —
            # surface it as the retriable connection error it is (a
            # ValueError from writing a closed file would bypass the
            # reconnect machinery and brick the client permanently)
            raise ConnectionError("client connection is closed")
        self._f.write(payload)
        self._f.flush()
        line = self._f.readline()
        if not line:
            raise ConnectionError("serving endpoint closed the connection")
        try:
            return json.loads(line)
        except ValueError as e:
            # a peer killed mid-write leaves a truncated line, and the
            # stream is desynchronized — close so the next attempt
            # reconnects, and surface the retriable connection error it
            # really is (a JSONDecodeError would bypass every retry
            # path and fail an idempotent request non-retriably)
            self.close()
            raise ConnectionError(f"garbled reply from endpoint: {e}") \
                from e

    def raw_call(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """One send/receive, no retry, no error-raising: the reply dict
        as the server wrote it (errors included), for a caller with its
        own retry policy."""
        if self._f is None:
            self._connect()
        return self._send_recv((json.dumps(msg) + "\n").encode())

    def stream_call(self, msg: Dict[str, Any]):
        """Send one message and yield EVERY reply line until a terminal
        one (``done`` or ``error``) — the ``generate`` verb's transport.
        No retry: a connection death mid-stream surfaces as
        ConnectionError (generation is greedy, so a caller may replay the
        request and skip the tokens it already has)."""
        if self._f is None:
            self._connect()
        self._f.write((json.dumps(msg) + "\n").encode())
        self._f.flush()
        terminal = False
        try:
            while True:
                line = self._f.readline()
                if not line:
                    raise ConnectionError(
                        "serving endpoint closed the connection "
                        "mid-stream")
                try:
                    obj = json.loads(line)
                except ValueError as e:
                    raise ConnectionError(
                        f"garbled stream line from endpoint: {e}") from e
                if obj.get("done") or "error" in obj:
                    terminal = True
                yield obj
                if terminal:
                    return
        finally:
            if not terminal:
                # the caller abandoned the stream (or it died) with
                # token lines still buffered — the connection is
                # desynchronized for any later call; close so the next
                # verb reconnects clean instead of reading stale lines
                self.close()

    def generate_stream(self, prompt, model: Optional[str] = None,
                        max_new_tokens: int = 16,
                        eos_id: Optional[int] = None,
                        deadline_ms: Optional[float] = None,
                        stream: bool = True):
        """Stream one generation: yields ``{"token", "index", ...}``
        dicts as the engine emits them, then the final ``{"done": true,
        "tokens": [...], "finish_reason": ...}`` line.  Raises a typed
        `ServingError` on a structured error reply."""
        with trace.scope(trace.ensure()) as tid:
            msg: Dict[str, Any] = trace.inject(
                {"method": "generate",
                 "prompt": [int(x) for x in np.asarray(prompt).reshape(-1)],
                 "max_new_tokens": int(max_new_tokens),
                 "stream": bool(stream)})
            if model is not None:
                msg["model"] = model
            if eos_id is not None:
                msg["eos_id"] = int(eos_id)
            if deadline_ms is not None:
                msg["deadline_ms"] = float(deadline_ms)
            for obj in self.stream_call(msg):
                if "error" in obj:
                    raise ServingError(obj["error"],
                                       obj.get("code", "internal"))
                self.last_trace = obj.get("trace", tid)
                yield obj

    def generate(self, prompt, model: Optional[str] = None,
                 max_new_tokens: int = 16, eos_id: Optional[int] = None,
                 deadline_ms: Optional[float] = None) -> Dict[str, Any]:
        """Non-streaming generation: one reply with the full token
        list."""
        final = None
        for obj in self.generate_stream(prompt, model=model,
                                        max_new_tokens=max_new_tokens,
                                        eos_id=eos_id,
                                        deadline_ms=deadline_ms,
                                        stream=False):
            final = obj
        return final

    def _call(self, msg: Dict[str, Any],
              idempotent: bool = False,
              deadline: Optional[float] = None) -> Dict[str, Any]:
        payload = (json.dumps(msg) + "\n").encode()
        self._backoff.reset()
        attempts = 0
        needs_connect = self._f is None   # self-heal a closed client
        while True:
            reconnect = False
            try:
                if deadline is not None and attempts > 0:
                    # deadline_ms is the REMAINING budget: a retry after
                    # a backoff sleep must re-state what is actually
                    # left (and give up locally once nothing is), not
                    # replay the original payload's stale number.  The
                    # FIRST attempt always goes out as written — the
                    # server is the authority on shedding, and it
                    # counts/records the shed where operators look.
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise ServingError(
                            f"deadline expired after {attempts} "
                            "attempt(s)", "deadline_exceeded")
                    msg["deadline_ms"] = remaining * 1e3
                    payload = (json.dumps(msg) + "\n").encode()
                if needs_connect:
                    # the reconnect itself may fail while a restarting
                    # server has not re-bound its port yet — that's one
                    # more retriable attempt, not a hard failure
                    self._connect()
                    needs_connect = False
                resp = self._send_recv(payload)
                if "error" not in resp:
                    return resp
                code = resp.get("code", "internal")
                if not (idempotent and code in RETRIABLE_CODES):
                    raise ServingError(resp["error"], code)
                # retriable shed: never executed, safe to re-send.  A
                # draining server will close the socket — reconnect (the
                # replacement process may be on the same port already).
                reconnect = code == "shutting_down"
                err: Exception = ServingError(resp["error"], code)
            except _RETRYABLE as e:
                if not idempotent:
                    raise
                reconnect = True
                err = e
            if attempts >= self._retries:
                raise err
            attempts += 1
            self._backoff.sleep()
            if reconnect:
                self.close()
                needs_connect = True

    def infer(self, feed: Dict[str, Any],
              model: Optional[str] = None,
              deadline_ms: Optional[float] = None,
              priority: Optional[int] = None) -> Dict[str, np.ndarray]:
        # mint (or inherit) a trace id, span the round trip, carry the id
        # on the wire; the reply echoes it back for correlation.  A
        # retried send reuses the same id — it is one logical request.
        with trace.scope(trace.ensure()) as tid:
            msg = trace.inject(
                {"method": "infer",
                 "feed": {k: _encode(np.asarray(v))
                          for k, v in feed.items()}})
            if model is not None:
                msg["model"] = model
            deadline = None
            if deadline_ms is not None:
                # the relative remaining budget: _call restates it per
                # retry attempt
                msg["deadline_ms"] = float(deadline_ms)
                deadline = time.monotonic() + float(deadline_ms) / 1e3
            if priority is not None:
                # the fleet frontend's admission queue orders by it
                msg["priority"] = int(priority)
            with profiler.record_block("client.request"):
                resp = self._call(msg, idempotent=True, deadline=deadline)
        self.last_trace = resp.get("trace", tid)
        return {k: _decode(v) for k, v in resp["fetch"].items()}

    def stats(self, model: Optional[str] = None) -> Dict[str, Any]:
        msg: Dict[str, Any] = {"method": "stats"}
        if model is not None:
            msg["model"] = model
        return self._call(msg, idempotent=True)["stats"]

    def metrics(self, format: str = "prometheus"):
        """Pull the server's metrics registry: Prometheus exposition text
        (default) or a nested-dict JSON snapshot (``format='json'``)."""
        return self._call({"method": "metrics", "format": format},
                          idempotent=True)["metrics"]

    # -- multi-model admin surface ------------------------------------------
    def inspect(self) -> Dict[str, Any]:
        """The server's introspection registry: per-program cost reports
        and per-layer aggregates."""
        return self._call({"method": "inspect"},
                          idempotent=True)["introspection"]

    def trace(self, trace_id: str) -> Dict[str, Any]:
        """One trace id's slices: ``{"id", "processes":
        [process_trace_doc, ...]}`` (one process for a ``serve``); feed
        ``processes`` to ``timeline.stitch_processes`` for the merged
        Chrome trace."""
        return self._call({"method": "trace", "id": str(trace_id)},
                          idempotent=True)["trace"]

    def models(self) -> Dict[str, Any]:
        """Registry listing: {'default': name, 'models': {name: info}}."""
        return self._call({"method": "models"}, idempotent=True)["models"]

    def load_model(self, name: str, model_dir: str,
                   params_filename: Optional[str] = None,
                   mesh: Optional[Dict[str, int]] = None,
                   options: Optional[Dict[str, Any]] = None,
                   warmup: Optional[list] = None) -> Dict[str, Any]:
        msg: Dict[str, Any] = {"method": "load", "model": name,
                               "dir": model_dir}
        if params_filename is not None:
            msg["params_filename"] = params_filename
        if mesh is not None:
            msg["mesh"] = mesh
        if options is not None:
            msg["options"] = options
        if warmup is not None:
            msg["warmup"] = warmup
        return self._call(msg)["model"]

    def unload_model(self, name: str):
        self._call({"method": "unload", "model": name})

    def reload_model(self, name: str) -> bool:
        """Hot-swap a model from its dir; False = manifest fingerprint
        unchanged, nothing happened."""
        return self._call({"method": "reload", "model": name})["reloaded"]

    def apply_deltas(self, name: str) -> Dict[str, Any]:
        """Apply the model dir's ``__delta__.json`` row deltas to the live
        model: ``{applied, stale, seq, step, rows}`` (``stale`` asks for
        a reload)."""
        return self._call({"method": "apply_deltas",
                           "model": name})["delta"]

    def close(self):
        f, sock = self._f, self._sock
        # None-out FIRST: a later call finds no live handles and
        # reconnects instead of writing a closed file
        self._f = None
        self._sock = None
        try:
            if f is not None:
                f.close()
            if sock is not None:
                sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def infer_round_trip(endpoint: str, feed: Dict[str, Any],
                     timeout: float = 60.0,
                     model: Optional[str] = None) -> Dict[str, np.ndarray]:
    with ServingClient(endpoint, timeout=timeout) as c:
        return c.infer(feed, model=model)


def serving_stats(endpoint: str, timeout: float = 60.0,
                  model: Optional[str] = None) -> Dict[str, Any]:
    with ServingClient(endpoint, timeout=timeout) as c:
        return c.stats(model=model)


def serving_metrics(endpoint: str, format: str = "prometheus",
                    timeout: float = 60.0):
    """One-shot metrics pull from a live InferenceServer (the
    `python -m paddle_tpu metrics` verb's transport)."""
    with ServingClient(endpoint, timeout=timeout) as c:
        return c.metrics(format=format)


def list_models(endpoint: str, timeout: float = 60.0) -> Dict[str, Any]:
    """One-shot registry listing (the `models` CLI verb's transport)."""
    with ServingClient(endpoint, timeout=timeout) as c:
        return c.models()


def serving_introspection(endpoint: str,
                          timeout: float = 60.0) -> Dict[str, Any]:
    """One-shot report pull (the ``inspect`` CLI verb's transport against
    a live endpoint)."""
    with ServingClient(endpoint, timeout=timeout) as c:
        return c.inspect()


def shutdown_serving(endpoint: str, timeout: float = 10.0):
    try:
        with ServingClient(endpoint, timeout=timeout) as c:
            c._call({"method": "shutdown"})
    except OSError:
        pass
