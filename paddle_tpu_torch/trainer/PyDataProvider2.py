"""PyDataProvider2 (parity: python/paddle/trainer/PyDataProvider2.py —
`@provider`:365 wrapping user generator functions, input-type declarations,
cache/shuffle settings).

In the reference, PyDataProvider2.cpp calls the decorated generator from the
C++ trainer and converts slots by declared InputType.  Here the decorated
provider IS a host-side sample source: iterate it directly, hand it to the
v2 trainer, or adapt it to the fluid reader pipeline with
``provider_to_reader``.
"""
from __future__ import annotations

import functools
import logging
import random
from typing import Callable, Dict, Optional

import numpy as np


# The type system is shared with the v2 API (reference: v2.data_type is a
# re-export of PyDataProvider2's types; here v2/data_type.py is canonical).
from ..v2.data_type import (InputType, DataType, SequenceType,  # noqa: E402
                            dense_vector, dense_vector_sequence, dense_array,
                            integer_value, integer_value_sequence,
                            sparse_binary_vector,
                            sparse_binary_vector_sequence,
                            sparse_float_vector,
                            sparse_float_vector_sequence)


class CacheType:
    NO_CACHE = 0
    CACHE_PASS_IN_MEM = 1


def dense_slot(dim, seq_type=SequenceType.NO_SEQUENCE):
    return InputType(dim, seq_type, DataType.Dense)


def sparse_non_value_slot(dim, seq_type=SequenceType.NO_SEQUENCE):
    return InputType(dim, seq_type, DataType.SparseNonValue)


def sparse_value_slot(dim, seq_type=SequenceType.NO_SEQUENCE):
    return InputType(dim, seq_type, DataType.SparseValue)


def index_slot(value_range, seq_type=SequenceType.NO_SEQUENCE):
    return InputType(value_range, seq_type, DataType.Index)


def dense_vector_sub_sequence(dim):
    return dense_slot(dim, SequenceType.SUB_SEQUENCE)


def sparse_value_vector_sequence(dim):
    return sparse_value_slot(dim, SequenceType.SEQUENCE)


def integer_value_sub_sequence(dim):
    return index_slot(dim, SequenceType.SUB_SEQUENCE)


class DataProvider:
    """The object `@provider` produces: a reusable sample source bound to a
    file list, with the declared slot types attached."""

    def __init__(self, generator: Callable, input_types,
                 should_shuffle: Optional[bool], pool_size: int,
                 cache: int, init_hook: Optional[Callable], kwargs):
        self._gen = generator
        # dict input_types keep their slot names (reference dict-sample
        # protocol); slot_names orders dict-form samples
        self.input_types = input_types
        self.slot_names = (list(input_types.keys())
                           if isinstance(input_types, dict) else None)
        self.should_shuffle = should_shuffle
        self.pool_size = pool_size
        self.cache = cache
        self._init_hook = init_hook
        self._kwargs = kwargs
        self._cache_store: Dict[tuple, list] = {}   # file_list -> samples
        self.check = False
        self.check_fail_continue = False

    def _ordered_types(self):
        t = self.input_types
        return list(t.values()) if isinstance(t, dict) else t

    def _ordered_fields(self, sample):
        """Sample fields in declared slot order (dict samples by name)."""
        if isinstance(sample, dict):
            if not self.slot_names:
                raise ValueError("dict sample but input_types is not a dict")
            return tuple(sample[k] for k in self.slot_names)
        if isinstance(sample, (tuple, list)):
            return tuple(sample)
        return (sample,)

    class _Settings:
        pass

    def _make_settings(self, file_list):
        s = DataProvider._Settings()
        s.input_types = self.input_types
        s.file_list = list(file_list)
        s.logger = logging.getLogger("PyDataProvider2")
        if self._init_hook:
            self._init_hook(s, file_list=s.file_list, **self._kwargs)
        return s

    def _check_sample(self, sample):
        fields = self._ordered_fields(sample)
        types = self._ordered_types()
        if types is None or len(fields) != len(types):
            raise ValueError(f"sample has {len(fields)} slots, declared "
                             f"{types!r}")
        for f, t in zip(fields, types):
            if t.type == DataType.Index and t.seq_type == SequenceType.NO_SEQUENCE:
                v = int(np.asarray(f).reshape(-1)[0])
                if not (0 <= v < t.dim):
                    raise ValueError(f"index {v} out of range [0, {t.dim})")
            elif t.type == DataType.Dense and t.seq_type == SequenceType.NO_SEQUENCE:
                a = np.asarray(f)
                if a.size != t.dim:
                    raise ValueError(f"dense slot size {a.size} != declared "
                                     f"dim {t.dim}")

    def __call__(self, file_list=("",), is_train: bool = True):
        """Iterate samples across the file list (the C++ driver called the
        generator once per file).

        should_shuffle=None follows the reference: shuffle only training
        passes; pass is_train=False for deterministic eval iteration.
        The pass cache is keyed per file list, so one provider shared
        between train and test (define_py_data_sources2) caches both.
        """
        key = tuple(file_list)
        if self.cache == CacheType.CACHE_PASS_IN_MEM and key in self._cache_store:
            samples = self._cache_store[key]
        else:
            settings = self._make_settings(file_list)
            samples = []
            for fn in settings.file_list:
                for sample in self._gen(settings, fn):
                    if self.check:
                        try:
                            self._check_sample(sample)
                        except ValueError:
                            if self.check_fail_continue:
                                continue
                            raise
                    samples.append(sample)
            if self.cache == CacheType.CACHE_PASS_IN_MEM:
                self._cache_store[key] = samples
        shuffle_now = (self.should_shuffle is True
                       or (self.should_shuffle is None and is_train))
        if shuffle_now:
            samples = list(samples)
            random.shuffle(samples)
        return iter(samples)


def provider(input_types=None, should_shuffle=None, pool_size=-1,
             min_pool_size=-1, can_over_batch_size=True, calc_batch_size=None,
             cache=CacheType.NO_CACHE, check=False, check_fail_continue=False,
             init_hook=None, **kwargs):
    """PyDataProvider2.py:365 parity decorator.

    @provider(input_types=[dense_vector(784), integer_value(10)])
    def process(settings, filename):
        ...
        yield features, label
    """
    def deco(fn):
        dp = DataProvider(fn, input_types, should_shuffle, pool_size,
                          cache, init_hook, kwargs)
        dp.check = check
        dp.check_fail_continue = check_fail_continue
        functools.update_wrapper(dp, fn)
        return dp

    return deco


def provider_to_reader(dp: DataProvider, file_list=("",), is_train=True):
    """Adapt a @provider to the fluid reader protocol (a creator returning
    a sample iterator), so it plugs into layers.batch/shuffle/double_buffer
    and DataFeeder.  Dict samples are ordered by the declared slot names."""
    def reader():
        for sample in dp(file_list, is_train=is_train):
            yield tuple(np.asarray(f) for f in dp._ordered_fields(sample))
    return reader
