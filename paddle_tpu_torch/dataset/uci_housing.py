"""UCI housing (counterpart of ``paddle_tpu/dataset/uci_housing.py``):
13 synthetic features with a fixed linear target plus noise, split 80/20
into train and test."""
from __future__ import annotations

import numpy as np

from . import common

feature_names = ["CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE", "DIS",
                 "RAD", "TAX", "PTRATIO", "B", "LSTAT"]


def _synthetic():
    def gen():
        rng = np.random.RandomState(7)
        n = 640
        w = rng.randn(13).astype(np.float32)
        b = 0.5
        x = rng.randn(n, 13).astype(np.float32)
        y = x @ w + b + 0.01 * rng.randn(n).astype(np.float32)
        data = np.concatenate([x, y[:, None]], axis=1)
        split = int(n * 0.8)
        return data[:split], data[split:]
    return common.cached_synthetic("uci_housing", "v1", gen)


def _reader(part):
    def reader():
        for row in _synthetic()[part]:
            yield row[:-1].astype(np.float32), row[-1:].astype(np.float32)
    return reader


def train():
    return _reader(0)


def test():
    return _reader(1)


def fetch():
    _synthetic()
