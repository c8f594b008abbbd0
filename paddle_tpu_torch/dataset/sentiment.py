"""Movie-review sentiment (counterpart of
``paddle_tpu/dataset/sentiment.py``): imdb-like synthetic reviews over a
smaller vocabulary."""
from __future__ import annotations

import numpy as np

from . import common

NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000
_VOCAB = 2000


def get_word_dict():
    return {f"w{i}": i for i in range(_VOCAB)}


def _synthetic(n, seed):
    def gen():
        rng = np.random.RandomState(seed)
        samples = []
        for _ in range(n):
            ln = rng.randint(10, 80)
            label = rng.randint(0, 2)
            words = rng.randint(100, _VOCAB, size=ln)
            lo, hi = (5, 40) if label else (40, 80)
            idx = rng.choice(ln, size=max(2, ln // 5), replace=False)
            words[idx] = rng.randint(lo, hi, size=len(idx))
            samples.append((words.astype(np.int64).tolist(), int(label)))
        return samples
    return common.cached_synthetic("sentiment", f"{n}_{seed}", gen)


def train():
    def reader():
        yield from _synthetic(NUM_TRAINING_INSTANCES, 0)
    return reader


def test():
    def reader():
        yield from _synthetic(NUM_TOTAL_INSTANCES - NUM_TRAINING_INSTANCES, 1)
    return reader


def fetch():
    _synthetic(NUM_TRAINING_INSTANCES, 0)
