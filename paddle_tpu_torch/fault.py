"""Deterministic fault injection (counterpart of ``paddle_tpu/fault.py``).

Kill points are count-based, never random: a spec names a point, the hit
number that fires and the action, so a test (or a subprocess armed by
``FLAGS_fault_points``) dies at the same instruction every run.

Spec grammar (comma-separated list)::

    point[@n[+]][:action]

``point``   a dotted site name; the port's sites are ``train.step`` (each
            logical step of ``Executor.train_loop``), ``checkpoint.write``
            (each var file), ``checkpoint.pre_commit``,
            ``checkpoint.post_commit``, ``io.save_vars`` (each var file
            of ``io.save_vars``), ``io.pre_replace`` (each atomic
            file publish), the fleet's ``fleet.route`` (each forward
            attempt), ``fleet.health`` (each heartbeat sweep) and
            ``replica.spawn`` (each spawn attempt), the server's
            ``serve.stream_token`` (after each streamed token line), and
            the checkpoint watcher's ``watcher.roll`` (before each
            replica) and ``watcher.health_gate``
``@n``      fire on the n-th hit of the point, once (default 1); ``@n+``
            fires on the n-th hit and every hit after it
``action``  ``exit`` (``os._exit(137)``, the kill -9 analog), ``raise``
            (`FaultInjected`, the default), ``drop`` (``maybe_fault``
            returns True and the caller drops the operation) or ``stop``
            (the process stops itself with SIGSTOP and goes on when sent
            SIGCONT: a chaos test paces a replica one site at a time)

Every site calls ``maybe_fault("site")``: one dict check when nothing is
armed.
"""
from __future__ import annotations

import os
import signal
import threading
from typing import Dict, Tuple

from .flags import FLAGS

__all__ = ["FaultInjected", "arm", "reset", "maybe_fault", "hits", "armed"]

_ACTIONS = ("exit", "raise", "drop", "stop")
_EXIT_CODE = 137              # what the shell reports for SIGKILL


class FaultInjected(RuntimeError):
    """An armed ``raise`` kill point fired."""

    def __init__(self, point: str, hit: int):
        super().__init__(f"fault injected at {point!r} (hit {hit})")
        self.point = point
        self.hit = hit


_lock = threading.Lock()
# point -> (fire_on_hit, action, sticky); sticky = fire on every hit >= n
_armed: Dict[str, Tuple[int, str, bool]] = {}
_hits: Dict[str, int] = {}


def _parse(spec: str) -> Dict[str, Tuple[int, str, bool]]:
    out: Dict[str, Tuple[int, str, bool]] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        point, _, action = part.partition(":")
        action = action or "raise"
        if action not in _ACTIONS:
            raise ValueError(f"fault action {action!r} not in {_ACTIONS} "
                             f"(spec {part!r})")
        point, _, n = point.partition("@")
        if not point:
            raise ValueError(f"empty fault point in spec {part!r}")
        sticky = n.endswith("+")
        if sticky:
            n = n[:-1]
        out[point] = (int(n) if n else 1, action, sticky)
    return out


def arm(spec: str) -> None:
    """Add kill points (the flag's grammar)."""
    with _lock:
        _armed.update(_parse(spec))


def reset() -> None:
    """Clear hit counters and programmatic arms, then re-arm what
    ``FLAGS.fault_points`` says."""
    with _lock:
        _armed.clear()
        _hits.clear()
        _armed.update(_parse(FLAGS.fault_points))


def armed() -> Dict[str, Tuple[int, str, bool]]:
    with _lock:
        return dict(_armed)


def hits(point: str) -> int:
    """How many times ``point`` has been hit since the last reset."""
    with _lock:
        return _hits.get(point, 0)


def maybe_fault(point: str) -> bool:
    """Hit a kill point.  True iff the caller must drop the operation
    (``drop``); ``raise`` raises, ``exit`` never returns, ``stop``
    returns False once the process is continued."""
    if not _armed:
        return False
    with _lock:
        entry = _armed.get(point)
        if entry is None:
            return False
        n = _hits.get(point, 0) + 1
        _hits[point] = n
        fire_on, action, sticky = entry
        if (n < fire_on) if sticky else (n != fire_on):
            return False
    if action == "exit":
        os._exit(_EXIT_CODE)
    if action == "raise":
        raise FaultInjected(point, n)
    if action == "stop":
        os.kill(os.getpid(), signal.SIGSTOP)
        return False
    return True               # drop


reset()
