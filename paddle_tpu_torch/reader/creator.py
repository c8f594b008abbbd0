"""Reader creators (counterpart of ``paddle_tpu/reader/creator.py``:
``np_array`` and ``text_file``; the recordio creators wait for the
recordio format, ROADMAP queue A item 6)."""
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
