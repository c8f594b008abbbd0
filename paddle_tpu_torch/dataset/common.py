"""Dataset plumbing (counterpart of ``paddle_tpu/dataset/common.py``): the
synthetic path only.

The JAX package generates each dataset's synthetic fallback once and
caches it on disk under its data home; the port generates it in memory
(the generators are seeded, so the samples are the same) and writes
nothing outside the process.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

_CACHE: Dict[Tuple[str, str], object] = {}


def cached_synthetic(module_name: str, tag: str, generator: Callable):
    """Generate-once deterministic synthetic data, memoised by
    (module, tag)."""
    key = (module_name, tag)
    if key not in _CACHE:
        _CACHE[key] = generator()
    return _CACHE[key]
