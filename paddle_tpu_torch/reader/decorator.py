"""Reader decorators (counterpart of ``paddle_tpu/reader/decorator.py``).

A reader is a zero-arg callable returning an iterable of samples;
decorators wrap readers into new readers, the reference's contract.
`device_prefetch` stages batches on the card from a pump thread (pinned
buffers, ``non_blocking`` copies on a side stream, one event a batch),
and `StackedBatch` is the K-step window `Executor.train_loop` takes.
"""
from __future__ import annotations

import itertools
import random
import threading
import queue as _queue

import numpy as np

from ..observability import default_registry as _obs_registry

_XMAP_OCCUPANCY = _obs_registry().gauge(
    "reader_xmap_queue_occupancy",
    "mapped samples waiting in the xmap done-queue")
_READER_SAMPLES = _obs_registry().counter(
    "reader_samples_total", "samples yielded by instrumented readers",
    labelnames=("reader",))
_XMAP_SAMPLES = _READER_SAMPLES.labels(reader="xmap")
_BUFFERED_SAMPLES = _READER_SAMPLES.labels(reader="buffered")
_READER_EXCEPTIONS = _obs_registry().counter(
    "reader_exceptions_total",
    "exceptions raised inside reader pipelines", labelnames=("reader",))
_XMAP_EXCEPTIONS = _READER_EXCEPTIONS.labels(reader="xmap")
_BUFFERED_EXCEPTIONS = _READER_EXCEPTIONS.labels(reader="buffered")
_DEVICE_PREFETCH_DEPTH = _obs_registry().gauge(
    "reader_prefetch_depth",
    "batches staged on device ahead of dispatch",
    labelnames=("source",)).labels(source="device_prefetch")
_DEVICE_PREFETCH_EXC = _READER_EXCEPTIONS.labels(reader="device_prefetch")


class ComposeNotAligned(ValueError):
    pass


def map_readers(func, *readers):
    """decorator.py map_readers: func over zipped reader outputs."""
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)
    return reader


def shuffle(reader, buf_size):
    """decorator.py shuffle contract: pool up to ``buf_size`` samples,
    emit the pool in random order, refill until the source drains."""
    def data_reader():
        stream = iter(reader())
        while True:
            pool = list(itertools.islice(stream, buf_size))
            if not pool:
                return
            random.shuffle(pool)
            yield from pool
    return data_reader


def chain(*readers):
    def reader():
        for r in readers:
            yield from r()
    return reader


def compose(*readers, **kwargs):
    """decorator.py compose: zip readers into flat tuples."""
    check_alignment = kwargs.pop("check_alignment", True)

    def flat(row):
        out = []
        for cell in row:
            out.extend(cell if isinstance(cell, tuple) else (cell,))
        return tuple(out)

    def reader():
        streams = [r() for r in readers]
        if not check_alignment:
            yield from (flat(row) for row in zip(*streams))
            return
        hole = object()
        for row in itertools.zip_longest(*streams, fillvalue=hole):
            if any(cell is hole for cell in row):
                raise ComposeNotAligned(
                    "outputs of readers are not aligned")
            yield flat(row)
    return reader


def _pumped(reader, size, exc_counter, transform=None, on_yield=None,
            depth_gauge=None, thread_name=None):
    """The pump thread behind ``buffered`` and ``device_prefetch``: a
    daemon thread (named ``thread_name``) stays up to ``size`` samples
    ahead of the consumer, applying ``transform`` before it enqueues.
    Items cross the queue as (more, sample) pairs; a source (or
    transform) exception crosses the same queue and re-raises in the
    consumer.  A consumer that drops the generator sets a stop event,
    and the pump ends at its next put instead of holding its samples."""
    def data_reader():
        slots: _queue.Queue = _queue.Queue(maxsize=size)
        stop = threading.Event()
        source = reader()

        def put(item):
            while not stop.is_set():
                try:
                    slots.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def pump():
            try:
                for sample in source:
                    if not put((True, transform(sample) if transform
                                else sample)):
                        return
                    if depth_gauge is not None:
                        depth_gauge.set(slots.qsize())
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                exc_counter.inc()
                put((False, exc))
            else:
                put((False, None))

        threading.Thread(target=pump, name=thread_name, daemon=True).start()
        try:
            while True:
                more, payload = slots.get()
                if depth_gauge is not None:
                    depth_gauge.set(slots.qsize())
                if not more:
                    if payload is not None:
                        raise payload
                    return
                if on_yield is not None:
                    on_yield()
                yield payload
        finally:
            stop.set()
    return data_reader


def buffered(reader, size):
    """decorator.py buffered contract: a pump thread stays up to ``size``
    samples ahead of the consumer."""
    return _pumped(reader, size, _BUFFERED_EXCEPTIONS,
                   on_yield=_BUFFERED_SAMPLES.inc)


class StackedBatch(dict):
    """K feed dicts stacked along a new leading axis: one window of
    ``Executor.train_loop``.  ``k`` is the number of logical steps;
    every array leaf has shape ``[k, ...]``.  A feed whose first batch
    is stacked makes the loop run in windows by itself (any ``k``, 1
    too: stacked leaves never feed as one batch); a stacked batch
    arriving mid-stream in a per-step loop, or mixed with plain batches
    in one window, raises rather than mis-feeding."""

    def __init__(self, data, k):
        super().__init__(data)
        self.k = int(k)


def stage_to_device(x, device, stream=None):
    """One host array (numpy or a CPU tensor) on ``device``: on a CUDA
    device a pinned copy of it and a ``non_blocking`` copy on ``stream``
    (the current stream when None), so the host does not wait for the
    transfer.  Anything else passes through."""
    import torch
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if not isinstance(x, torch.Tensor):
        return x
    if device.type != "cuda":
        return x.to(device)
    if x.device.type != "cpu":
        return x.to(device)
    pinned = x.pin_memory()
    if stream is None:
        return pinned.to(device, non_blocking=True)
    with torch.cuda.stream(stream):
        # the caching host allocator keeps ``pinned`` until this copy ends
        return pinned.to(device, non_blocking=True)


class _Staged:
    """A batch whose device copies were issued on a side stream: the
    consumer waits on the copies' event, and every staged tensor is
    recorded on the consumer's stream so the allocator does not reuse
    its memory while the consumer may still read it."""

    __slots__ = ("batch", "event", "device")

    def __init__(self, batch, event, device):
        self.batch = batch
        self.event = event
        self.device = device

    def take(self):
        if self.event is not None:
            import torch
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(self.event)
            for t in _tensors(self.batch):
                if t.device.type == "cuda":
                    t.record_stream(consumer)
        return self.batch


def _tensors(x):
    import torch
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _stage_tree(x, device, stream):
    if isinstance(x, dict):
        out = {k: _stage_tree(v, device, stream) for k, v in x.items()}
        return (StackedBatch(out, x.k) if isinstance(x, StackedBatch)
                else out)
    if isinstance(x, (list, tuple)):
        return type(x)(_stage_tree(v, device, stream) for v in x)
    if isinstance(x, np.ndarray) or _is_cpu_tensor(x):
        return stage_to_device(x, device, stream)
    return x


def _is_cpu_tensor(x):
    import torch
    return isinstance(x, torch.Tensor) and x.device.type == "cpu"


def _device_of(place):
    import torch
    if place is None:
        return torch.device("cuda", torch.cuda.current_device())
    return place.torch_device()


def device_prefetch(reader, size=2, place=None, stack=None,
                    thread_name=None):
    """Stage a reader's batches into device memory up to ``size`` ahead of
    the consumer: a pump thread copies batch i+1 while step i runs.

    Samples may be feed dicts, tuples/lists or bare arrays; every numpy
    array (or CPU tensor) leaf becomes a tensor on the place's device
    (``place`` a `core.place` Place; default the current CUDA device),
    everything else passes through.  On a CUDA device each leaf is
    pinned and copied ``non_blocking`` on a side stream; the consumer
    waits on that batch's copies (a CUDA event) before it sees the
    batch, and each staged tensor is ``record_stream``-ed to the
    consumer's stream.  `Executor.train_loop` takes the tensors as they
    are.

    ``stack=K`` groups K consecutive feed-dict batches into one
    `StackedBatch`, each leaf ``np.stack``-ed on the host and staged in
    one copy, so ``train_loop`` gets a whole window of K steps at once.
    A ragged tail yields a smaller stack.  ``thread_name`` names the
    pump thread.
    """
    import torch

    state = {}

    def transform(sample):
        device = _device_of(place)
        stream = None
        if device.type == "cuda":
            stream = state.get("stream")
            if stream is None:
                stream = state["stream"] = torch.cuda.Stream(device)
        staged = _stage_tree(sample, device, stream)
        event = None
        if stream is not None:
            event = torch.cuda.Event()
            event.record(stream)
        return _Staged(staged, event, device)

    if stack is None:
        source = reader
    else:
        stack = int(stack)
        if stack < 1:
            raise ValueError(f"stack must be >= 1, got {stack}")

        def source():
            buf = []
            for sample in reader():
                if not isinstance(sample, dict):
                    raise ValueError(
                        "device_prefetch(stack=K) needs feed-dict samples; "
                        f"got {type(sample).__name__}")
                buf.append(sample)
                if len(buf) == stack:
                    yield _stack_group(buf)
                    buf = []
            if buf:
                yield _stack_group(buf)

    pumped = _pumped(source, size, _DEVICE_PREFETCH_EXC,
                     transform=transform,
                     depth_gauge=_DEVICE_PREFETCH_DEPTH,
                     thread_name=thread_name)

    def data_reader():
        for staged in pumped():
            yield staged.take()
    return data_reader


def _stack_group(group):
    import torch
    out = {}
    for name in group[0]:
        vals = [g[name] for g in group]
        if all(isinstance(v, torch.Tensor) for v in vals):
            out[name] = torch.stack(vals)
        else:
            out[name] = np.stack([np.asarray(v) for v in vals])
    return StackedBatch(out, len(group))


def firstn(reader, n):
    def data_reader():
        yield from itertools.islice(reader(), n)
    return data_reader


def resumable(reader):
    """Position-tracking reader for preemption-safe resume.

    The returned reader counts every sample it yields in ``.position``
    (what a checkpoint manifest records as the reader position) and
    honors ``set_position(n)``: the next pass opened by calling the
    reader skips its first ``n`` samples.
    ``Executor.train_loop(resume_from=...)`` seeks a resumable feed
    instead of pulling and dropping batches one by one."""

    class _Resumable:
        def __init__(self):
            self.position = 0
            self._start = 0

        def set_position(self, n: int):
            self._start = max(0, int(n))

        def __call__(self):
            self.position = 0
            start, self._start = self._start, 0
            for sample in reader():
                if self.position < start:
                    self.position += 1
                    continue
                self.position += 1
                yield sample

    return _Resumable()


def cache(reader):
    all_data = []

    def data_reader():
        if not all_data:
            all_data.extend(reader())
        yield from all_data
    return data_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """decorator.py xmap_readers contract: apply ``mapper`` over the
    reader's samples on ``process_num`` threads, ``buffer_size`` items of
    slack on each side.  With ``order=True`` results come out in source
    order — workers park on a condition variable until their ticket is
    the next one due (the reference spin-waits here)."""
    def xreader():
        feed_q: _queue.Queue = _queue.Queue(buffer_size)
        done_q: _queue.Queue = _queue.Queue(buffer_size)
        turn = {"next": 0}
        gate = threading.Condition()
        DRAIN = ("drain", None)

        def feeder():
            try:
                for ticket, sample in enumerate(reader()):
                    feed_q.put(("sample", (ticket, sample)))
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                done_q.put(("error", exc))
            finally:
                for _ in range(process_num):
                    feed_q.put(DRAIN)

        def mapper_thread():
            try:
                while True:
                    kind, payload = feed_q.get()
                    if kind == "drain":
                        return
                    ticket, sample = payload
                    result = mapper(sample)
                    if order:
                        # Reserve the turn under the gate, then do the
                        # (possibly blocking) done_q.put OUTSIDE it: a
                        # full done-queue used to park the turn-holder
                        # inside the lock, deadlocking against the
                        # consumer's error path, which needs the gate to
                        # broadcast the abort — and serializing every
                        # other worker behind one slow consumer.
                        with gate:
                            gate.wait_for(
                                lambda: turn["next"] in (ticket, -1))
                            if turn["next"] == -1:   # aborted: unpark
                                return
                            turn["next"] = ticket + 1
                            gate.notify_all()
                        done_q.put(("ordered", (ticket, result)))
                    else:
                        done_q.put(("sample", result))
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                done_q.put(("error", exc))
            finally:
                done_q.put(DRAIN)

        threading.Thread(target=feeder, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=mapper_thread, daemon=True).start()
        live = process_num
        pending = {}        # ordered arrivals ahead of their turn; soft-
        next_out = 0        # bounded ~process_num (grows past that only
        while live:         # while a reserver stalls before its put)
            kind, payload = done_q.get()
            _XMAP_OCCUPANCY.set(done_q.qsize())
            if kind == "drain":
                live -= 1
            elif kind == "error":
                _XMAP_EXCEPTIONS.inc()
                with gate:
                    turn["next"] = -1    # release any parked ordered worker
                    gate.notify_all()
                raise payload
            elif kind == "ordered":
                # the puts race outside the gate, so re-sequence by ticket
                ticket, result = payload
                pending[ticket] = result
                while next_out in pending:
                    _XMAP_SAMPLES.inc()
                    yield pending.pop(next_out)
                    next_out += 1
            else:
                _XMAP_SAMPLES.inc()
                yield payload
    return xreader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """decorator.py multiprocess_reader on threads: every reader runs on a
    thread of its own and their samples interleave in one queue."""
    def reader():
        q = _queue.Queue(queue_size)
        end = object()
        done = [0]
        lock = threading.Lock()

        def worker(r):
            for sample in r():
                q.put(sample)
            with lock:
                done[0] += 1
                if done[0] == len(readers):
                    q.put(end)

        for r in readers:
            t = threading.Thread(target=worker, args=(r,))
            t.daemon = True
            t.start()
        while True:
            sample = q.get()
            if sample is end:
                break
            yield sample
    return reader
