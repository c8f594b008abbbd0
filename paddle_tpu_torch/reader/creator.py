"""Reader creators (counterpart of ``paddle_tpu/reader/creator.py``):
``np_array``, ``text_file`` and the recordio creators, which read
through the C++ runtime (`native`)."""
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
    """A reader over the raw records of recordio file(s) through the C++
    `native.FileLoader`: ``num_threads`` threads (at most one a file)
    parse records into a queue of ``queue_capacity`` ahead of the
    consumer.  Each file's records keep their order; across files the
    order is the threads', so it is `recordio`'s only with one thread."""
    from .. import native

    if isinstance(paths, str):
        paths = paths.split(",")

    def reader():
        loader = native.FileLoader(paths, num_threads=num_threads,
                                   queue_capacity=queue_capacity)
        try:
            yield from loader
        finally:
            loader.close()
    return reader
