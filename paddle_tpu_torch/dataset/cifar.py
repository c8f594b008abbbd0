"""CIFAR-10/100 (counterpart of ``paddle_tpu/dataset/cifar.py``): the
synthetic images, a class template plus noise as 3072-dim float vectors
in [0, 1], with int labels."""
from __future__ import annotations

import numpy as np

from . import common

_N_TRAIN = 4000
_N_TEST = 800


def _synthetic(n, num_classes, seed):
    def gen():
        rng = np.random.RandomState(1234 + num_classes)
        templates = rng.rand(num_classes, 3072).astype(np.float32)
        r = np.random.RandomState(seed)
        labels = r.randint(0, num_classes, size=n).astype(np.int64)
        imgs = np.clip(templates[labels] * 0.6 + r.rand(n, 3072) * 0.4, 0, 1)
        return imgs.astype(np.float32), labels
    return common.cached_synthetic("cifar", f"{num_classes}_{n}_{seed}", gen)


def _reader(n, num_classes, seed):
    def reader():
        imgs, labels = _synthetic(n, num_classes, seed)
        for img, lab in zip(imgs, labels):
            yield img, int(lab)
    return reader


def train10():
    return _reader(_N_TRAIN, 10, 0)


def test10():
    return _reader(_N_TEST, 10, 1)


def train100():
    return _reader(_N_TRAIN, 100, 0)


def test100():
    return _reader(_N_TEST, 100, 1)


def fetch():
    _synthetic(_N_TRAIN, 10, 0)
