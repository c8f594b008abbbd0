"""MNIST (counterpart of ``paddle_tpu/dataset/mnist.py``): synthetic
digits, a fixed random template per class plus noise, 784 floats in
[-1, 1] with int labels."""
from __future__ import annotations

import numpy as np

from . import common

_N_TRAIN = 8000
_N_TEST = 1000


def _synthetic(n, seed):
    def gen():
        rng = np.random.RandomState(42)
        templates = rng.randn(10, 784).astype(np.float32)
        rng2 = np.random.RandomState(seed)
        labels = rng2.randint(0, 10, size=n).astype(np.int64)
        images = (templates[labels] * 0.5
                  + rng2.randn(n, 784).astype(np.float32) * 0.5)
        images = np.clip(images, -1.0, 1.0)
        return images.astype(np.float32), labels
    return common.cached_synthetic("mnist", f"{n}_{seed}", gen)


def _reader_creator(n, seed):
    def reader():
        images, labels = _synthetic(n, seed)
        for img, lab in zip(images, labels):
            yield img, int(lab)
    return reader


def train():
    return _reader_creator(_N_TRAIN, 0)


def test():
    return _reader_creator(_N_TEST, 1)


def fetch():
    _synthetic(_N_TRAIN, 0)


def convert(path):
    common.convert(path, train(), 1000, "mnist_train")
    common.convert(path, test(), 1000, "mnist_test")
