"""Dataset plumbing (counterpart of ``paddle_tpu/dataset/common.py``): the
synthetic path and ``convert``.

The JAX package generates each dataset's synthetic fallback once and
caches it on disk under its data home; the port generates it in memory
(the generators are seeded, so the samples are the same) and writes
nothing outside the process.
"""
from __future__ import annotations

import pickle
from typing import Callable, Dict, Tuple

_CACHE: Dict[Tuple[str, str], object] = {}


def cached_synthetic(module_name: str, tag: str, generator: Callable):
    """Generate-once deterministic synthetic data, memoised by
    (module, tag)."""
    key = (module_name, tag)
    if key not in _CACHE:
        _CACHE[key] = generator()
    return _CACHE[key]


def convert(output_path, reader, line_count, name_prefix):
    """Write a reader's samples as recordio shards of ``line_count``
    pickled samples, ``{output_path}/{name_prefix}-00000`` on; -> the
    number of shards (the JAX package's shards, record for record)."""
    from ..recordio import writer
    idx = 0
    batch = []

    def _flush(b, i):
        with writer(f"{output_path}/{name_prefix}-{i:05d}") as w:
            for sample in b:
                w.write(pickle.dumps(sample, protocol=2))
        return i + 1

    for d in reader():
        batch.append(d)
        if len(batch) == line_count:
            idx = _flush(batch, idx)
            batch = []
    if batch:
        idx = _flush(batch, idx)
    return idx
