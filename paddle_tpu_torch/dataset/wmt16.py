"""WMT16 en-de (counterpart of ``paddle_tpu/dataset/wmt16.py``): wmt14's
synthetic reversed translation with wmt16's interface (vocabulary sizes
per side, <s>/<e>/<unk> as ids 0/1/2)."""
from __future__ import annotations

import numpy as np

from . import common

_N_TRAIN = 1500
_N_TEST = 200


def _synthetic(n, seed, src_dict_size, trg_dict_size):
    def gen():
        rng = np.random.RandomState(seed)
        pairs = []
        for _ in range(n):
            ln = rng.randint(4, 20)
            src = rng.randint(3, src_dict_size - 3, size=ln)
            trg = ((src[::-1] + 11 - 3) % (trg_dict_size - 3)) + 3
            pairs.append((src.tolist(), trg.tolist()))
        return pairs
    return common.cached_synthetic(
        "wmt16", f"{n}_{seed}_{src_dict_size}_{trg_dict_size}", gen)


def _reader_creator(samples):
    def reader():
        for src, trg in samples:
            yield src, [0] + trg, trg + [1]
    return reader


def train(src_dict_size=10000, trg_dict_size=10000, src_lang="en"):
    return _reader_creator(_synthetic(_N_TRAIN, 0, src_dict_size,
                                      trg_dict_size))


def test(src_dict_size=10000, trg_dict_size=10000, src_lang="en"):
    return _reader_creator(_synthetic(_N_TEST, 1, src_dict_size,
                                      trg_dict_size))


def validation(src_dict_size=10000, trg_dict_size=10000, src_lang="en"):
    return _reader_creator(_synthetic(300, 2, src_dict_size, trg_dict_size))


def get_dict(lang, dict_size, reverse=False):
    words = ["<s>", "<e>", "<unk>"] + [f"{lang}{i}"
                                       for i in range(3, dict_size)]
    if reverse:
        return dict(enumerate(words))
    return {w: i for i, w in enumerate(words)}


def fetch():
    _synthetic(_N_TRAIN, 0, 10000, 10000)
