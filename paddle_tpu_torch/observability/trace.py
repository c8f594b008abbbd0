"""Request-scoped trace ids (counterpart of
``paddle_tpu/observability/trace.py``).

A trace id is a 16-hex-character token minted once per request.  It
rides a ``contextvar`` within a process and the ``"trace"`` field of the
newline-JSON wire messages, so a client's request, the batch that served
it and the reply carry one id.  A fused batch belongs to every request
in it, so the context holds a tuple of ids.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Dict, Optional, Tuple

_current: contextvars.ContextVar[Tuple[str, ...]] = contextvars.ContextVar(
    "paddle_tpu_torch_trace", default=())

WIRE_KEY = "trace"


def new_trace_id() -> str:
    """A fresh 64-bit trace id (hex)."""
    return os.urandom(8).hex()


def current_ids() -> Tuple[str, ...]:
    return _current.get()


def current_id() -> Optional[str]:
    ids = _current.get()
    return ids[0] if ids else None


@contextlib.contextmanager
def scope(*trace_ids: str):
    """Activate the given trace id(s) for the block; none mints one."""
    ids = tuple(trace_ids) or (new_trace_id(),)
    token = _current.set(ids)
    try:
        yield ids[0]
    finally:
        _current.reset(token)


def ensure() -> str:
    """The current trace id, or a fresh one (not installed)."""
    return current_id() or new_trace_id()


def inject(msg: Dict) -> Dict:
    """Stamp the active trace id onto an outgoing wire message."""
    tid = current_id()
    if tid is not None:
        msg[WIRE_KEY] = tid
    return msg


def extract(msg: Dict) -> Optional[str]:
    tid = msg.get(WIRE_KEY)
    return str(tid) if tid else None


@contextlib.contextmanager
def from_message(msg: Dict, mint: bool = True):
    """Serve-side entry: activate the message's trace id (minting one
    when absent and ``mint``), yielding the active id."""
    tid = extract(msg)
    if tid is None and not mint:
        yield None
        return
    with scope(tid or new_trace_id()) as active:
        yield active
