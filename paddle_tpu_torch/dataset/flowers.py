"""Oxford-102 flowers (counterpart of ``paddle_tpu/dataset/flowers.py``):
synthetic 3x224x224 images, a blocky class template plus noise, flattened,
with int labels."""
from __future__ import annotations

import numpy as np

from . import common

_N_CLASSES = 102
_N_TRAIN = 600
_N_TEST = 100
_SHAPE = (3, 224, 224)


def _synthetic(n, seed):
    def gen():
        rng = np.random.RandomState(77)
        templates = rng.rand(_N_CLASSES, 16).astype(np.float32)
        r = np.random.RandomState(seed)
        labels = r.randint(0, _N_CLASSES, size=n).astype(np.int64)
        return templates, labels
    return common.cached_synthetic("flowers", f"{n}_{seed}", gen)


def _reader(n, seed):
    def reader():
        templates, labels = _synthetic(n, seed)
        rng = np.random.RandomState(seed + 1)
        for i in range(n):
            lab = int(labels[i])
            base = np.tile(templates[lab].reshape(4, 4).repeat(56, 0)
                           .repeat(56, 1), (3, 1, 1)).astype(np.float32)
            img = np.clip(base + rng.rand(*_SHAPE).astype(np.float32) * 0.3,
                          0, 1)
            yield img.reshape(-1), lab
    return reader


def train(mapper=None, buffered_size=1024, use_xmap=True):
    return _reader(_N_TRAIN, 0)


def test(mapper=None, buffered_size=1024, use_xmap=True):
    return _reader(_N_TEST, 1)


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    return _reader(_N_TEST, 2)


def fetch():
    _synthetic(_N_TRAIN, 0)
