"""DataFeeder: Python batches -> a feed dict (counterpart of
``paddle_tpu/data_feeder.py``).

Dense slots become stacked numpy arrays.  Ragged slots (lod_level > 0,
the reference's LoD) become a padded [batch, max_len, ...] array and a
companion ``<name>@SEQ_LEN`` int32 length vector, the representation the
executor reads.  Pad lengths are rounded up to powers of two (at least
8), as the JAX feeder does to bound its recompilations, so both packages
see the same arrays.

Under ``FLAGS_use_pinned_memory`` the batch is staged on the feeder's
place as the JAX feeder stages it on its device: `feed` returns tensors,
on a CUDA place from pinned host copies copied ``non_blocking`` on the
current stream (the host goes on batching while they travel), on the
CPU as CPU tensors.  No place means the current card.  The executor
takes tensors already on its device as they are.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .core.lowering import LEN_SUFFIX
from .core.place import resolve_device
from .core.program import Variable
from .core.types import convert_dtype
from .flags import FLAGS
from .reader.decorator import stage_to_device


def _round_up_pow2(n: int, minimum: int = 8) -> int:
    m = minimum
    while m < n:
        m *= 2
    return m


class DataFeeder:
    def __init__(self, feed_list: Sequence[Variable], place=None,
                 program=None, bucket_lengths: bool = True):
        self.feed_list = list(feed_list)
        self.place = place
        self.bucket_lengths = bucket_lengths

    def feed(self, iterable) -> Dict[str, np.ndarray]:
        rows = list(iterable)
        out: Dict[str, np.ndarray] = {}
        for i, var in enumerate(self.feed_list):
            col = [row[i] for row in rows]
            dtype = np.dtype(convert_dtype(var.dtype))
            if var.lod_level and var.lod_level > 0:
                arr, lens = self._pad_ragged(col, dtype, var)
                out[var.name] = arr
                out[var.name + LEN_SUFFIX] = lens
            else:
                out[var.name] = self._stack_dense(col, dtype, var)
        if FLAGS.use_pinned_memory:
            device = resolve_device(None if self.place is None
                                    else self.place.torch_device())
            out = {k: stage_to_device(v, device) for k, v in out.items()}
        return out

    @staticmethod
    def _stack_dense(col, dtype, var):
        batch = np.stack([np.asarray(c, dtype=dtype) for c in col], axis=0)
        want = tuple(var.shape) if var.shape else None
        if want and want[0] in (-1, None):
            want = want[1:]          # strip the appended batch dim
        if want and all(d > 0 for d in want) and batch.shape[1:] != want:
            n_got = (int(np.prod(batch.shape[1:], dtype=np.int64))
                     if batch.ndim > 1 else 1)
            if n_got == int(np.prod(want)):
                # a flat sample of the declared size (784 -> 1x28x28)
                return batch.reshape((batch.shape[0],) + want)
        # declared trailing dims, like [1] labels fed as scalars
        want_ndim = len(var.shape) if var.shape else batch.ndim
        while batch.ndim < want_ndim:
            batch = batch[..., None]
        return batch

    def _pad_ragged(self, col, dtype, var):
        seqs = [np.asarray(c, dtype=dtype) for c in col]
        lens = np.asarray([len(s) for s in seqs], dtype=np.int32)
        max_len = int(lens.max()) if len(lens) else 1
        if self.bucket_lengths:
            max_len = _round_up_pow2(max_len)
        tail = seqs[0].shape[1:] if seqs and seqs[0].ndim > 1 else ()
        want_tail = (tuple(var.shape[2:])
                     if var.shape and len(var.shape) > 2 else tail)
        out = np.zeros((len(seqs), max_len) + tuple(want_tail), dtype=dtype)
        for i, s in enumerate(seqs):
            if s.ndim == 1 and want_tail:
                s = s[:, None]
            out[i, :len(s)] = s.reshape((len(s),) + tuple(want_tail))
        return out, lens
