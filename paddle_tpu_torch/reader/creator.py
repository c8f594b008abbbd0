"""Reader creators (counterpart of ``paddle_tpu/reader/creator.py``):
``np_array``, ``text_file`` and the recordio creators."""
from __future__ import annotations

import numpy as np


def np_array(x):
    """A reader over the rows of an array."""
    def reader():
        yield from np.asarray(x)
    return reader


def text_file(path):
    """A reader over the lines of a text file, without their newlines."""
    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")
    return reader


def recordio(paths, buf_size=100):
    """A reader over the raw records of recordio file(s), in file order
    (``paths`` a list or a comma-separated string)."""
    from ..recordio import scanner

    if isinstance(paths, str):
        paths = paths.split(",")

    def reader():
        for path in paths:
            yield from scanner(path)
    return reader


def recordio_threaded(paths, num_threads=2, queue_capacity=1024):
    """`recordio` with the files read ahead of the consumer by a pump
    thread, up to ``queue_capacity`` records; the order is `recordio`'s.
    The JAX package reads with its C++ loader's ``num_threads`` threads
    when that is built; the port reads with one thread (the C++ twin is
    ROADMAP queue A item 6)."""
    from .decorator import buffered
    return buffered(recordio(paths), queue_capacity)
