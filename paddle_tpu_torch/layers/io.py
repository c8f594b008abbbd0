"""Input layers (counterpart of ``paddle_tpu/layers/io.py``): ``data``
and the reader ops.

The reader ops build a host-side pipeline of `Reader` handles, as the
JAX package does: ``open_recordio_file`` / ``open_files`` read samples
written by `recordio_writer`, ``shuffle``, ``batch`` and ``multi_pass``
decorate them, ``double_buffer`` stages each batch on the device from a
background thread, and ``read_file`` declares one data var a field and
binds the pipeline to the program.  ``Executor.run`` with no feed then
pulls the next batch and raises `EOFException` at the end of a pass;
``Executor.train_loop(feed=None)`` trains through it.

``double_buffer`` on the card: the producer thread pins each field and
copies it ``non_blocking`` on a side stream, records an event, and the
consumer's stream waits on that event before the batch is used; each
staged tensor is ``record_stream``-ed to the consumer's stream, so the
caching allocator cannot hand its memory out while the step may still
read it (`reader.decorator.device_prefetch`, which ``double_buffer``
is).  ``place=None`` means the card.  An abandoned generator sets the
producer's stop event, and the producer ends at its next put.

``ListenAndServ`` and ``Send`` are the parameter-server path of
``dist_ops.py`` and refuse (ROADMAP queue A item 4).
"""
from __future__ import annotations

import numpy as np

from .. import recordio, recordio_writer, unique_name
from ..core.executor import EOFException
from ..core.types import VarType
from ..layer_helper import LayerHelper
from ..reader import decorator

#: the name of the thread `double_buffer` starts for each pass
DOUBLE_BUFFER_THREAD = "double_buffer"


class Reader:
    """A reader-op pipeline stage: ``make_iter()`` starts a pass over its
    samples (or batches); decorators derive new stages from it."""

    def __init__(self, make_iter, var_names=None):
        self._make_iter = make_iter
        self._it = None
        self.var_names = var_names or []
        self.shapes = None
        self.dtypes = None
        self.lod_levels = None

    def _derive(self, make_iter):
        """A new stage with this one's field metadata."""
        r = Reader(make_iter, self.var_names)
        r.shapes, r.dtypes = self.shapes, self.dtypes
        r.lod_levels = self.lod_levels
        return r

    def reset(self):
        """Start the next `next_feed` on a new pass."""
        self._it = None

    def _next(self):
        if self._it is None:
            self._it = iter(self._make_iter())
        try:
            return next(self._it)
        except StopIteration:
            self._it = None
            raise EOFException("pass end")

    def next_feed(self):
        """The next batch as a feed dict of the bound data vars."""
        batch = self._next()
        if isinstance(batch, dict):
            return batch
        if not self.var_names:
            raise ValueError("reader has no bound vars; call read_file "
                             "first")
        fields = batch if isinstance(batch, (tuple, list)) else (batch,)
        if len(fields) != len(self.var_names):
            raise ValueError(
                f"reader yielded {len(fields)} fields for "
                f"{len(self.var_names)} bound vars {self.var_names}")
        return dict(zip(self.var_names, fields))


def _samples(filenames):
    for fn in filenames:
        for rec in recordio.Scanner(fn):
            yield recordio_writer.deserialize_sample(rec)


def _with_fields(r, shapes, lod_levels, dtypes):
    r.shapes, r.dtypes = shapes, dtypes
    r.lod_levels = lod_levels
    return r


def open_recordio_file(filename, shapes, lod_levels=None, dtypes=None,
                       pass_num=1, for_parallel=False):
    """Samples of a file written by
    `recordio_writer.convert_reader_to_recordio_file`, ``pass_num``
    times over."""
    def gen():
        for _ in range(pass_num):
            yield from _samples([filename])

    return _with_fields(Reader(gen), shapes, lod_levels, dtypes)


def open_files(filenames, shapes=None, lod_levels=None, dtypes=None,
               thread_num=1, buffer_size=64):
    """Samples of several files in order, read ahead by a pump thread up
    to ``buffer_size`` samples."""
    return _with_fields(
        Reader(decorator.buffered(lambda: _samples(filenames),
                                  buffer_size)),
        shapes, lod_levels, dtypes)


def batch(reader: Reader, batch_size: int, drop_last=True):
    """Batches of ``batch_size`` samples, each field ``np.stack``-ed."""
    def gen():
        buf = []
        for sample in reader._make_iter():
            buf.append(sample)
            if len(buf) == batch_size:
                yield tuple(np.stack([s[i] for s in buf])
                            for i in range(len(buf[0])))
                buf = []
        if buf and not drop_last:
            yield tuple(np.stack([s[i] for s in buf])
                        for i in range(len(buf[0])))

    return reader._derive(gen)


def shuffle(reader: Reader, buffer_size: int):
    """Pools of ``buffer_size`` samples in Python ``random``'s order."""
    return reader._derive(decorator.shuffle(reader._make_iter, buffer_size))


def multi_pass(reader: Reader, pass_num: int):
    def gen():
        for _ in range(pass_num):
            yield from reader._make_iter()
    return reader._derive(gen)


def double_buffer(reader: Reader, place=None, name=None, capacity=2):
    """Up to ``capacity`` batches staged on the place's device (the card
    when ``place`` is None) by a producer thread while the consumer
    computes: `reader.decorator.device_prefetch` (module docstring)."""
    return reader._derive(decorator.device_prefetch(
        reader._make_iter, capacity, place,
        thread_name=DOUBLE_BUFFER_THREAD))


def read_file(reader: Reader, main_program=None):
    """One data var per field of ``reader``, bound to the program: ->
    the vars (one Variable for a single field)."""
    if not reader.shapes:
        raise ValueError("reader needs `shapes` to declare vars")
    dtypes = reader.dtypes or ["float32"] * len(reader.shapes)
    out_vars = []
    helper = LayerHelper("read_file", main_program=main_program)
    block = helper.main_program.global_block()
    for shape, dtype in zip(reader.shapes, dtypes):
        name = unique_name.generate("read_file")
        out_vars.append(block.create_var(name=name, shape=tuple(shape),
                                         dtype=dtype, is_data=True,
                                         stop_gradient=True))
    reader.var_names = [v.name for v in out_vars]
    helper.main_program._bound_reader = reader
    return out_vars if len(out_vars) > 1 else out_vars[0]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=VarType.LOD_TENSOR, stop_gradient=True):
    """Declare an input variable; ``append_batch_size`` prepends a -1
    batch dim."""
    helper = LayerHelper("data", name=name)
    shape = list(shape)
    if lod_level > 0 and shape == [1]:
        shape = [-1]
    if append_batch_size:
        shape = [-1] + shape
    block = helper.main_program.global_block()
    return block.create_var(name=name, shape=shape, dtype=dtype, type=type,
                            stop_gradient=stop_gradient, lod_level=lod_level,
                            is_data=True)


_PSERVER = ("the parameter-server ops (listen_and_serv, send) are not "
            "ported (ROADMAP queue A item 4: dist_ops.py)")


class ListenAndServ:
    """Refused: the parameter server as an operator."""

    def __init__(self, endpoint, inputs=None, fan_in=1, optimizer_mode=True):
        raise NotImplementedError(_PSERVER)


def Send(endpoint, send_vars, get_vars):
    """Refused: a send/recv round trip to a ListenAndServ endpoint."""
    raise NotImplementedError(_PSERVER)
