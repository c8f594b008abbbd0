"""CSP concurrency: channels, ``go`` and ``select`` (counterpart of
``paddle_tpu/concurrency.py``).

Two faces over one channel type:

- the host API (`Channel`, `Go`/`go`, `Select`, `select_loop`) overlaps
  input with compute around ``Executor.run``: a `Go` thread reads and
  stages batches and sends them on a `Channel`, the training loop
  receives them;
- program mode (``make_channel(in_program=True)``, `channel_send`,
  `channel_recv`, `channel_close`, `ProgramGo`, `ProgramSelect`) appends
  ``channel_*``, ``go`` and ``select`` ops, which the executor interprets
  (`ops.csp_ops`): a channel is a host object in the env, a ``go`` block
  runs on a thread over the shared env, and a payload stays a tensor on
  its device.

The protocol is the JAX package's: a send/recv handshake on one lock and
two condition variables, unbuffered sends that block until a receiver
takes the cell, and a select that waits on a `SelectWaiter` notified by
every watched channel (no sleep-polling), whose sequence number is read
before each scan.  A program built by either package's front end
serializes to the same JSON.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Sequence


class ChannelClosed(Exception):
    pass


class SelectWaiter:
    """The condition variable a select blocks on while it watches many
    channels.  A sequence number, read before the selector probes its
    cases, closes the missed-wakeup window: `wait` returns at once if a
    channel event landed in between."""

    def __init__(self):
        self._cv = threading.Condition()
        self._seq = 0

    def notify(self):
        with self._cv:
            self._seq += 1
            self._cv.notify_all()

    def snapshot(self) -> int:
        with self._cv:
            return self._seq

    def wait(self, snapshot: int, timeout: Optional[float] = None) -> bool:
        """Block until a channel event after ``snapshot``; True if one
        arrived, False on timeout."""
        with self._cv:
            while self._seq == snapshot:
                if not self._cv.wait(timeout):
                    return False
            return True


class Channel:
    """A buffered (``capacity`` > 0) or unbuffered (rendezvous) channel."""

    def __init__(self, capacity: int = 0, dtype=None):
        self._capacity = capacity
        self._dtype = dtype
        self._closed = False
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._buf: List[Any] = []
        self._recv_waiting = 0
        # selects watching this channel, notified on every state change
        self._waiters: List[SelectWaiter] = []

    # -- select support --------------------------------------------------
    def add_waiter(self, waiter: SelectWaiter):
        with self._lock:
            self._waiters.append(waiter)

    def remove_waiter(self, waiter: SelectWaiter):
        with self._lock:
            try:
                self._waiters.remove(waiter)
            except ValueError:
                pass

    def _notify_waiters(self):
        # called with self._lock held; a waiter's notify takes only its
        # own cv, and no thread takes a channel lock while it holds a
        # waiter's cv, so the lock order is acyclic
        for w in self._waiters:
            w.notify()

    def ready_for_recv(self) -> bool:
        with self._lock:
            return bool(self._buf) or self._closed

    def ready_for_send(self) -> bool:
        with self._lock:
            if self._closed:
                return True            # the attempt raises ChannelClosed
            if self._capacity > 0:
                return len(self._buf) < self._capacity
            return self._recv_waiting > 0

    def send(self, value, timeout: Optional[float] = None) -> bool:
        """Send ``value``; False when ``timeout`` passed first (the value
        was not delivered).  Raises `ChannelClosed` on a closed
        channel."""
        cell = [value]
        with self._lock:
            if self._closed:
                raise ChannelClosed("send on closed channel")
            if self._capacity > 0:
                while len(self._buf) >= self._capacity and not self._closed:
                    if not self._not_full.wait(timeout):
                        return False
                if self._closed:
                    raise ChannelClosed("send on closed channel")
                self._buf.append(cell)
                self._not_empty.notify()
                self._notify_waiters()
                return True
            # unbuffered: deposit, then block until a receiver takes it
            self._buf.append(cell)
            self._not_empty.notify()
            self._notify_waiters()

            def queued():
                # identity, not ==: tensor payloads make list equality
                # raise, and equal payloads would match another sender's
                # cell
                return any(c is cell for c in self._buf)

            def unqueue():
                self._buf[:] = [c for c in self._buf if c is not cell]

            while queued() and not self._closed:
                if not self._not_full.wait(timeout):
                    if not queued():
                        # a receiver took the cell inside the timed-out
                        # wakeup window: the value was delivered
                        return True
                    unqueue()
                    return False
            if queued():               # closed before the handoff
                unqueue()
                raise ChannelClosed("send on closed channel")
            return True

    def recv(self, timeout: Optional[float] = None):
        """-> (value, ok); ok False means closed and drained (Go's
        ``v, ok := <-ch``).  Raises TimeoutError after ``timeout``."""
        with self._lock:
            self._recv_waiting += 1
            self._not_full.notify()
            self._notify_waiters()      # unbuffered sends become ready
            try:
                while not self._buf and not self._closed:
                    if not self._not_empty.wait(timeout):
                        raise TimeoutError("channel recv timed out")
                if self._buf:
                    cell = self._buf.pop(0)
                    self._not_full.notify_all()
                    self._notify_waiters()
                    return cell[0], True
                return None, False
            finally:
                self._recv_waiting -= 1

    def close(self):
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
            self._notify_waiters()

    @property
    def closed(self):
        return self._closed

    def __iter__(self):
        while True:
            v, ok = self.recv()
            if not ok:
                return
            yield v


class Go:
    """Run host work concurrently on daemon threads: ``Go(fn, *args)``,
    or ``g = Go(); g(fn, *args)``; `join` waits for them."""

    def __init__(self, fn: Optional[Callable] = None, *args, **kwargs):
        self._threads: List[threading.Thread] = []
        if fn is not None:
            self._spawn(fn, *args, **kwargs)

    def _spawn(self, fn, *args, **kwargs):
        t = threading.Thread(target=fn, args=args, kwargs=kwargs, daemon=True)
        t.start()
        self._threads.append(t)
        return t

    def __call__(self, fn, *args, **kwargs):
        return self._spawn(fn, *args, **kwargs)

    def join(self, timeout=None):
        for t in self._threads:
            t.join(timeout)


go = Go  # idiom: go(worker, ch)


def select_loop(cases, default=None):
    """The select loop of the host `Select` and the ``select`` op.

    ``cases``: list of (Channel, attempt_fn); ``attempt_fn()`` returns
    (fired, result), probing readiness itself and using a short bounded
    wait for the window between the probe and the rendezvous.
    ``default``: a thunk run at once when no case fires in a full scan
    (Go's non-blocking default).

    The scan starts at a random case and rotates a step each pass, so an
    always-ready early case cannot starve later ones.  Without a default
    the loop blocks on a `SelectWaiter` that every watched channel
    notifies, its sequence number read before each scan, with a 250 ms
    rescan as the bound on a missed notification.  With a default the
    loop runs one pass and registers no waiter."""
    import random
    waiter = None
    chans = {id(ch): ch for ch, _ in cases}
    if default is None:
        # also with zero cases: Go's `select {}` blocks forever
        waiter = SelectWaiter()
        for ch in chans.values():
            ch.add_waiter(waiter)
    rotation = random.randrange(len(cases)) if cases else 0
    try:
        while True:
            snap = waiter.snapshot() if waiter is not None else 0
            n = len(cases)
            for i in range(n):
                _, attempt = cases[(i + rotation) % n]
                fired, result = attempt()
                if fired:
                    return result
            rotation += 1
            if default is not None:
                return default()
            waiter.wait(snap, timeout=0.25)
    finally:
        if waiter is not None:
            for ch in chans.values():
                ch.remove_waiter(waiter)


class Select:
    """Wait on several channel operations; the first ready case wins.
    With a default case the channel cases are probed once, without
    blocking, and the default runs when none is ready."""

    def __init__(self, cases: Sequence[tuple]):
        """cases: ("recv", ch, callback) / ("send", ch, value, callback)
        / ("default", callback)."""
        self._cases = list(cases)

    def run(self, poll_interval: float = 0.001):
        default = next((c for c in self._cases if c[0] == "default"), None)

        def recv_attempt(ch, cb):
            def attempt():
                if not ch.ready_for_recv():
                    return False, None
                # bounded wait: a competitor may drain the channel
                # between the probe and the recv
                try:
                    v, ok = ch.recv(timeout=poll_interval)
                except TimeoutError:
                    return False, None
                return True, (cb(v, ok) if cb else (v, ok))
            return attempt

        def send_attempt(ch, value, cb):
            def attempt():
                if not ch.ready_for_send():
                    return False, None
                if not ch.send(value, timeout=poll_interval):
                    return False, None   # the receiver left; rescan
                return True, (cb() if cb else None)
            return attempt

        cases = []
        for case in self._cases:
            if case[0] == "recv":
                cases.append((case[1], recv_attempt(case[1], case[2])))
            elif case[0] == "send":
                cases.append((case[1], send_attempt(case[1], case[2],
                                                    case[3])))
        default_fn = ((lambda: default[1]() if default[1] else None)
                      if default is not None else None)
        return select_loop(cases, default_fn)


# ---------------------------------------------------------------------------
# program mode: channel, go and select ops in the current default program
# ---------------------------------------------------------------------------

def _is_program_var(x):
    from .core.program import Variable
    return isinstance(x, Variable)


def make_channel(dtype=None, capacity: int = 0, in_program: bool = False):
    """A host `Channel`; with ``in_program=True``, a ``channel_create``
    op and the channel's variable."""
    if not in_program:
        return Channel(capacity=capacity, dtype=dtype)
    from . import unique_name
    from .core.types import VarType
    from .layer_helper import LayerHelper
    helper = LayerHelper("channel_create")
    ch = helper.block.create_var(name=unique_name.generate("channel"),
                                 type=VarType.RAW, dtype=None)
    helper.append_op(type="channel_create", inputs={},
                     outputs={"Out": [ch]},
                     attrs={"capacity": int(capacity)})
    return ch


def channel_send(channel, value, is_copy: bool = False):
    """A blocking send on a host `Channel`; on a program variable, a
    ``channel_send`` op, returning its Status variable."""
    if not _is_program_var(channel):
        return channel.send(value)
    from .layer_helper import LayerHelper
    helper = LayerHelper("channel_send")
    status = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="channel_send",
                     inputs={"Channel": [channel], "X": [value]},
                     outputs={"Status": [status]},
                     attrs={"is_copy": bool(is_copy)})
    return status


def channel_recv(channel, return_value=None):
    """(value, ok) from a host `Channel`; on a program variable, a
    ``channel_recv`` op, returning its (Out, Status) variables."""
    if not _is_program_var(channel):
        return channel.recv()
    from .layer_helper import LayerHelper
    helper = LayerHelper("channel_recv")
    if return_value is None:
        return_value = helper.create_variable_for_type_inference("float32")
    status = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="channel_recv",
                     inputs={"Channel": [channel]},
                     outputs={"Out": [return_value], "Status": [status]})
    return return_value, status


def channel_close(channel):
    if not _is_program_var(channel):
        return channel.close()
    from .layer_helper import LayerHelper
    helper = LayerHelper("channel_close")
    helper.append_op(type="channel_close",
                     inputs={"Channel": [channel]}, outputs={})


class ProgramGo:
    """``with ProgramGo():`` captures a sub-block as a ``go`` op, which
    the executor runs on a thread."""

    def __init__(self, name=None):
        from .core.program import default_main_program
        self.main_program = default_main_program()
        self.parent_block = self.main_program.current_block()
        self.sub_block = None

    def __enter__(self):
        self.sub_block = self.main_program.create_block()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        self.main_program.rollback()
        self.parent_block.append_op(
            type="go", inputs={}, outputs={},
            attrs={"sub_block": self.sub_block.idx})
        return False


class ProgramSelect:
    """``with ProgramSelect() as sel:`` with ``with sel.case(...)`` and
    ``with sel.default()`` builds one ``select`` op whose cases carry
    their own sub-blocks."""

    def __init__(self, name=None):
        from .core.program import default_main_program
        self.main_program = default_main_program()
        self.parent_block = self.main_program.current_block()
        self._cases = []

    def __enter__(self):
        return self

    def case(self, channel_action_fn, channel, value, is_copy=False):
        kind = ("send" if channel_action_fn is channel_send else "recv")
        return _SelectCase(self, kind, channel, value)

    def default(self):
        return _SelectCase(self, "default", None, None)

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        self.parent_block.append_op(
            type="select", inputs={}, outputs={},
            attrs={"cases": list(self._cases)})
        return False


class _SelectCase:
    def __init__(self, select, kind, channel, value):
        self.select = select
        self.kind = kind
        self.channel = channel
        self.value = value
        self.sub_block = None

    def __enter__(self):
        self.sub_block = self.select.main_program.create_block()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        self.select.main_program.rollback()
        case = {"type": self.kind, "sub_block": self.sub_block.idx}
        if self.channel is not None:
            case["channel"] = self.channel.name
            case["value"] = self.value.name
        self.select._cases.append(case)
        return False
