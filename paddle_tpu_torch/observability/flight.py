"""Always-on flight recorder (counterpart of
``paddle_tpu/observability/flight.py``).

A bounded ring of the last N records (one per batch dispatch or decode
iteration), written even with the profiler and metrics off, and dumped
as atomic JSON when something goes wrong (a worker fault, SIGUSR1), so a
wedged serving process leaves a post-mortem.  A record costs one tuple
and one ``deque.append``.
"""
from __future__ import annotations

import json
import os
import signal
import tempfile
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

DEFAULT_CAPACITY = 512

_registry_lock = threading.Lock()
_recorders: "weakref.WeakSet[FlightRecorder]" = weakref.WeakSet()
_sigusr1_installed = False


def default_dump_path(name: str) -> str:
    """A pid-scoped dump file in the temporary directory."""
    safe = "".join(c if (c.isalnum() or c in "._-") else "_" for c in name)
    return os.path.join(tempfile.gettempdir(),
                        f"paddle_tpu_torch.flight.{os.getpid()}.{safe}.json")


class FlightRecorder:
    """A bounded ring of records with a fixed field layout; ``push`` is
    the hot path (a bound ``deque.append``)."""

    __slots__ = ("name", "fields", "capacity", "dump_path", "meta",
                 "_ring", "push", "__weakref__")

    def __init__(self, name: str, fields: Sequence[str],
                 capacity: int = DEFAULT_CAPACITY,
                 dump_path: Optional[str] = None,
                 meta: Optional[Dict[str, Any]] = None):
        self.name = str(name)
        self.fields = tuple(fields)
        self.capacity = int(capacity)
        self.dump_path = dump_path or default_dump_path(self.name)
        self.meta = dict(meta or {})
        self._ring: deque = deque(maxlen=self.capacity)
        self.push = self._ring.append
        with _registry_lock:
            _recorders.add(self)

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, **values):
        """Keyword form for cold paths; missing fields are 0."""
        self.push(tuple(values.get(f, 0) for f in self.fields))

    def records(self) -> List[Dict[str, Any]]:
        """The ring as dicts, oldest first."""
        return [dict(zip(self.fields, r)) for r in list(self._ring)]

    def last(self) -> Optional[Dict[str, Any]]:
        ring = list(self._ring)
        return dict(zip(self.fields, ring[-1])) if ring else None

    def clear(self):
        self._ring.clear()

    def dump(self, path: Optional[str] = None, reason: str = "manual",
             extra: Optional[Dict[str, Any]] = None) -> str:
        """Write the ring as one self-describing JSON file, atomically;
        returns the path."""
        from ..io import _atomic_write
        path = path or self.dump_path
        doc = {"recorder": self.name, "reason": reason,
               "dumped_at": time.time(), "pid": os.getpid(),
               "capacity": self.capacity, "fields": list(self.fields),
               "meta": self.meta, "records": self.records()}
        if extra:
            doc.update(extra)
        with _atomic_write(path) as f:
            json.dump(doc, f)
        return path


def recorders() -> List[FlightRecorder]:
    with _registry_lock:
        return list(_recorders)


def dump_all(reason: str = "sigusr1") -> List[str]:
    """Dump every live recorder's ring; one unwritable path does not
    lose the rest."""
    paths = []
    for rec in recorders():
        try:
            paths.append(rec.dump(reason=reason))
        except OSError:
            pass
    return paths


def install_signal_handler() -> bool:
    """Install the SIGUSR1 dump-all handler once.  Only the main thread
    may set signal handlers; elsewhere this returns False and the rings
    still dump on the error paths."""
    global _sigusr1_installed
    if _sigusr1_installed:
        return True
    if threading.current_thread() is not threading.main_thread():
        return False
    try:
        signal.signal(signal.SIGUSR1, lambda signum, frame: dump_all())
    except (ValueError, OSError, AttributeError):
        return False
    _sigusr1_installed = True
    return True
