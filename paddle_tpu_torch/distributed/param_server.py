"""The parameter server: ListenAndServ / Send's runtime (counterpart of
``paddle_tpu/distributed/param_server.py``, byte for byte its wire, so
either package's trainer talks to either package's server).

A pserver process runs a program whose ``listen_and_serv`` op serves a
sub-block over TCP, and a trainer program's ``send`` op makes a
synchronous round trip (`ops.dist_ops`).  The wire is newline-delimited
JSON with base64 tensors (`_encode` / `_decode`, the codec the serving
wire shares); it is a host-side control plane, not a data plane.

- The server writes its bound port to the selected-port file
  (`SELECTED_PORT_FILE`, read when the server starts, so a test can
  repoint it), so a caller can bind port 0 and find the real port.
- `ParamServerService` barriers on ``fan_in`` sends a round, sums the
  vars the trainers sent (gradient aggregation), runs the served
  computation once and hands every waiter its round's result.  A waiter
  whose round does not complete within ``round_deadline`` withdraws its
  contribution and gets the diagnostic over the wire; a round whose
  computation raised fails every waiter alike (`_RoundFailure`).
- `send_round_trip` waits for the reply ``round_deadline +
  REPLY_WAIT_MARGIN`` by default, so that diagnostic arrives before the
  socket times out, and retries only the connect.
- Metrics: ``pserver_rounds_total``, ``pserver_round_seconds``,
  ``pserver_straggler_gap_seconds`` (last send minus first send of a
  round) and ``pserver_round_timeouts_total``; the fault point
  ``pserver.send`` drops a send; the trainer's trace id rides the wire.
"""
from __future__ import annotations

import base64
import json
import os
import socket
import socketserver
import tempfile
import threading
from typing import Dict, List, Optional

import numpy as np

from .. import fault as _fault
from ..io import _atomic_write
from ..observability import default_registry as _obs_registry
from ..observability import trace as _trace
from .backoff import Backoff

#: where a server publishes its port when no port file is named
SELECTED_PORT_FILE = os.path.join(tempfile.gettempdir(),
                                  "paddle.selected_port")

# no-ops until the process registry is enabled
_PS_ROUNDS = _obs_registry().counter(
    "pserver_rounds_total", "completed aggregation rounds")
_PS_ROUND_S = _obs_registry().histogram(
    "pserver_round_seconds", "first send -> round result, per round")
_PS_STRAGGLER_S = _obs_registry().histogram(
    "pserver_straggler_gap_seconds",
    "last send - first send within a round")
_PS_TIMEOUTS = _obs_registry().counter(
    "pserver_round_timeouts_total",
    "trainer waits aborted by the round deadline")

# the server aborts an incomplete round after its deadline; a client
# keeps its socket open the deadline + REPLY_WAIT_MARGIN, so the
# server's diagnostic reaches it over the wire
DEFAULT_ROUND_DEADLINE = 600.0
REPLY_WAIT_MARGIN = 60.0


def _encode(arr: np.ndarray) -> dict:
    """The wire form of an array: shape, dtype name, base64 bytes."""
    arr = np.ascontiguousarray(arr)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "data": base64.b64encode(arr.tobytes()).decode("ascii")}


def _decode(d: dict) -> np.ndarray:
    return np.frombuffer(base64.b64decode(d["data"]),
                         dtype=np.dtype(d["dtype"])).reshape(d["shape"])


class _RoundFailure:
    """Sentinel round result: serve_fn raised; every waiter re-raises."""

    def __init__(self, message: str):
        self.message = message


class ParamServerService:
    """Runs the served computation once a round.

    ``serve_fn(feed: {name: np.ndarray}) -> {name: np.ndarray}`` is built
    by the listen_and_serv rule from its sub-block; ``fan_in`` sends make
    a round (module docstring)."""

    def __init__(self, serve_fn, fan_in: int = 1,
                 round_deadline: float = DEFAULT_ROUND_DEADLINE):
        self.serve_fn = serve_fn
        self.fan_in = max(1, fan_in)
        self.round_deadline = round_deadline
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._round_feeds: List[dict] = []
        #: per-round results: a slow waiter gets its own round's
        self._round_outs: Dict[int, dict] = {}
        #: waiters yet to read a round's result (evicted at zero)
        self._round_readers: Dict[int, int] = {}
        self._round_id = 0
        #: send time per feed, beside _round_feeds (a withdrawn sender
        #: takes its time with it)
        self._round_times: List[float] = []

    def handle_send(self, feed: Dict[str, np.ndarray]):
        """Block until fan_in sends arrive, run the computation once on
        the summed vars, return its outputs (the trainers' gradients are
        summed before the optimize block)."""
        import time
        with self._cv:
            my_round = self._round_id
            self._round_feeds.append(feed)
            self._round_times.append(time.monotonic())
            if len(self._round_feeds) == self.fan_in:
                t_first = self._round_times[0]
                _PS_STRAGGLER_S.observe(time.monotonic() - t_first)
                merged: Dict[str, np.ndarray] = {}
                for f in self._round_feeds:
                    for k, v in f.items():
                        # several trainers sending one var: the sum
                        merged[k] = (merged[k] + v) if k in merged else v
                try:
                    out = self.serve_fn(merged)
                except Exception as e:           # noqa: BLE001
                    # the round completes with an error every waiter
                    # re-raises; its feeds do not leak into the next
                    out = _RoundFailure(f"{type(e).__name__}: {e}")
                self._round_outs[my_round] = out
                self._round_readers[my_round] = self.fan_in
                self._round_feeds = []
                self._round_times = []
                self._round_id += 1
                _PS_ROUNDS.inc()
                _PS_ROUND_S.observe(time.monotonic() - t_first)
                self._cv.notify_all()
            else:
                deadline = time.monotonic() + self.round_deadline
                while my_round not in self._round_outs:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        # withdraw this trainer's contribution: a retry
                        # must not count its gradient twice
                        if my_round == self._round_id:
                            # identity, not ==: dicts of ndarrays do not
                            # support equality comparison
                            for idx, f in enumerate(self._round_feeds):
                                if f is feed:
                                    del self._round_feeds[idx]
                                    del self._round_times[idx]
                                    break
                        _PS_TIMEOUTS.inc()
                        raise RuntimeError(
                            f"pserver round {my_round} incomplete after "
                            f"{self.round_deadline:.0f}s — a trainer "
                            f"likely died mid-round (have "
                            f"{len(self._round_feeds)}/{self.fan_in} "
                            "sends)")
                    self._cv.wait(timeout=min(remaining, 60.0))
            out = self._round_outs[my_round]
            self._round_readers[my_round] -= 1
            if self._round_readers[my_round] == 0:
                del self._round_outs[my_round]
                del self._round_readers[my_round]
            if isinstance(out, _RoundFailure):
                raise RuntimeError(
                    f"pserver optimize block failed: {out.message}")
            return out


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        for line in self.rfile:
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                break
            if msg.get("method") == "send":
                # the round runs under the trainer's trace id
                with _trace.from_message(msg, mint=False) as tid:
                    feed = {k: _decode(v) for k, v in msg["vars"].items()}
                    try:
                        out = self.server.service.handle_send(feed)
                        resp = {"vars": {k: _encode(np.asarray(v))
                                         for k, v in (out or {}).items()}}
                    except RuntimeError as e:
                        # deadline and round errors ride the error slot
                        resp = {"error": str(e)}
                    if tid:
                        resp["trace"] = tid
            elif msg.get("method") == "shutdown":
                resp = {"ok": True}
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()
                threading.Thread(target=self.server.shutdown,
                                 daemon=True).start()
                return
            else:
                resp = {"error": f"unknown method {msg.get('method')!r}"}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


class ParamServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, service: ParamServerService, host="127.0.0.1",
                 port=0, port_file: Optional[str] = None):
        super().__init__((host, port), _Handler)
        self.service = service
        self.port = self.server_address[1]
        # the module attribute is read here, so a caller can repoint it
        if port_file is None:
            port_file = SELECTED_PORT_FILE
        if port_file:
            # atomic: a reader sees no file or the whole port
            with _atomic_write(port_file) as f:
                f.write(str(self.port))

    def serve_until_shutdown(self):
        self.serve_forever(poll_interval=0.1)


def send_round_trip(endpoint: str, feed: Dict[str, np.ndarray],
                    timeout: float = 60.0,
                    read_timeout: Optional[float] = None,
                    round_deadline: Optional[float] = None,
                    connect_retries: int = 0,
                    ) -> Dict[str, np.ndarray]:
    """One synchronous send and receive.

    ``timeout`` bounds the TCP connect only; ``read_timeout`` bounds the
    wait for the server's reply.  Its default is DERIVED from the
    server's round deadline (``round_deadline`` if the caller knows the
    configured value, else DEFAULT_ROUND_DEADLINE) plus
    REPLY_WAIT_MARGIN, so when a peer trainer dies mid-round the
    server's "trainer died mid-round (have k/fan_in sends)" diagnostic
    reaches the survivors over the wire (protocol error slot) instead of
    their sockets timing out first with a bare timeout.

    ``connect_retries`` > 0 retries a CONNECT failure (pserver still
    booting / restarting) with bounded jittered backoff.  Only the
    connect is ever retried: once the send is on the wire the gradient
    may already be in a round, and re-sending would double-count it."""
    if read_timeout is None:
        read_timeout = ((DEFAULT_ROUND_DEADLINE if round_deadline is None
                         else round_deadline) + REPLY_WAIT_MARGIN)
    elif round_deadline is not None:
        assert read_timeout > round_deadline, (
            f"read_timeout {read_timeout}s must exceed the server's "
            f"round_deadline {round_deadline}s or the round-incomplete "
            "diagnostic can never arrive before the socket times out")
    host, port = endpoint.rsplit(":", 1)
    retry = Backoff(base=0.1, cap=2.0, seed=f"send:{endpoint}")
    for attempt in range(max(0, connect_retries) + 1):
        if _fault.maybe_fault("pserver.send"):
            # an injected lost send: the server never sees it
            raise ConnectionError("fault injected: pserver send dropped")
        try:
            s = socket.create_connection((host, int(port)), timeout=timeout)
        except OSError:
            if attempt >= max(0, connect_retries):
                raise
            retry.sleep()
            continue
        with s:
            s.settimeout(read_timeout)
            f = s.makefile("rwb")
            msg = _trace.inject(
                {"method": "send",
                 "vars": {k: _encode(np.asarray(v))
                          for k, v in feed.items()}})
            f.write((json.dumps(msg) + "\n").encode())
            f.flush()
            resp = json.loads(f.readline())
            if "error" in resp:
                raise RuntimeError(f"pserver error: {resp['error']}")
            return {k: _decode(v) for k, v in resp["vars"].items()}


def shutdown_server(endpoint: str, timeout: float = 10.0):
    host, port = endpoint.rsplit(":", 1)
    try:
        with socket.create_connection((host, int(port)),
                                      timeout=timeout) as s:
            f = s.makefile("rwb")
            f.write((json.dumps({"method": "shutdown"}) + "\n").encode())
            f.flush()
            f.readline()
    except OSError:
        pass
