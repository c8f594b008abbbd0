"""IMDB sentiment (counterpart of ``paddle_tpu/dataset/imdb.py``):
synthetic reviews of ragged length whose label is carried by dedicated
positive and negative token ranges."""
from __future__ import annotations

import numpy as np

from . import common

_VOCAB_SIZE = 5148
_N_TRAIN = 2000
_N_TEST = 400
_POS_TOKENS = (10, 60)    # token ids signalling positive
_NEG_TOKENS = (60, 110)   # token ids signalling negative


def word_dict():
    return {f"w{i}": i for i in range(_VOCAB_SIZE)}


def _synthetic(n, seed):
    def gen():
        rng = np.random.RandomState(seed)
        samples = []
        for _ in range(n):
            length = rng.randint(8, 100)
            label = rng.randint(0, 2)
            words = rng.randint(200, _VOCAB_SIZE, size=length)
            lo, hi = _POS_TOKENS if label == 1 else _NEG_TOKENS
            n_signal = max(2, length // 6)
            idx = rng.choice(length, size=n_signal, replace=False)
            words[idx] = rng.randint(lo, hi, size=n_signal)
            samples.append((words.astype(np.int64).tolist(), int(label)))
        return samples
    return common.cached_synthetic("imdb", f"{n}_{seed}", gen)


def _reader(samples):
    def reader():
        yield from samples
    return reader


def train(word_idx=None):
    return _reader(_synthetic(_N_TRAIN, 0))


def test(word_idx=None):
    return _reader(_synthetic(_N_TEST, 1))


def fetch():
    _synthetic(_N_TRAIN, 0)
