"""PASCAL VOC2012 segmentation (counterpart of
``paddle_tpu/dataset/voc2012.py``): synthetic 3x64x64 images with blocky
int32 segmentation masks over 21 classes."""
from __future__ import annotations

import numpy as np

_N_CLASSES = 21
_N_TRAIN = 200
_N_TEST = 50
_H = _W = 64


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            img = rng.rand(3, _H, _W).astype(np.float32)
            label = np.zeros((_H, _W), dtype=np.int32)
            for _ in range(rng.randint(1, 4)):
                cls = rng.randint(1, _N_CLASSES)
                y0, x0 = rng.randint(0, _H // 2), rng.randint(0, _W // 2)
                h, w = rng.randint(8, _H // 2), rng.randint(8, _W // 2)
                label[y0:y0 + h, x0:x0 + w] = cls
                img[:, y0:y0 + h, x0:x0 + w] += cls / _N_CLASSES
            yield np.clip(img, 0, 1), label
    return reader


def train():
    return _reader(_N_TRAIN, 0)


def test():
    return _reader(_N_TEST, 1)


def val():
    return _reader(_N_TEST, 2)


def fetch():
    pass
