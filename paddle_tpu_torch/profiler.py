"""Profiler spans (counterpart of ``paddle_tpu/profiler.py``; only
``record_block`` is ported).

``record_block(name)`` is ``torch.profiler.record_function`` while a
torch profiler runs: the serving spans (``serving.request``,
``engine.batch``, ``executor.run``, ``decode.prefill``, ``decode.step``)
appear by name, beside the kernels they launched, in a trace of the
card.  Otherwise it is a shared no-op context (``record_function``
costs ~15 us a span even with no profiler).  The host span log,
``--timeline``, ``--profile`` and ``--xprof`` are not ported yet.
"""
from __future__ import annotations

import contextlib

import torch

_NULL_BLOCK = contextlib.nullcontext()


def record_block(name: str):
    """A span around the block, named ``name`` in a torch.profiler
    trace."""
    if not getattr(torch.autograd.profiler, "_is_profiler_enabled", True):
        return _NULL_BLOCK
    return torch.profiler.record_function(name)
