"""WMT14 en-fr (counterpart of ``paddle_tpu/dataset/wmt14.py``): the
synthetic translation pairs.  The target is the source reversed with a
fixed vocabulary offset (a learnable task that exercises attention),
ragged lengths 4-19, and the <s>/<e>/<unk> specials (ids 0/1/2)."""
from __future__ import annotations

import numpy as np

from . import common

START = "<s>"
END = "<e>"
UNK = "<unk>"
START_ID, END_ID, UNK_ID = 0, 1, 2

_DICT_SIZE = 1000
_N_TRAIN = 1500
_N_TEST = 200


def _synthetic(n, seed, dict_size):
    def gen():
        rng = np.random.RandomState(seed)
        pairs = []
        for _ in range(n):
            ln = rng.randint(4, 20)
            src = rng.randint(3, dict_size - 3, size=ln)
            trg = ((src[::-1] + 7 - 3) % (dict_size - 3)) + 3
            pairs.append((src.tolist(), trg.tolist()))
        return pairs
    return common.cached_synthetic("wmt14", f"{n}_{seed}_{dict_size}", gen)


def _reader_creator(samples):
    """Yield (source ids, <s> + target ids, target ids + <e>) triples."""
    def reader():
        for src, trg in samples:
            yield src, [START_ID] + trg, trg + [END_ID]
    return reader


def train(dict_size=_DICT_SIZE):
    return _reader_creator(_synthetic(_N_TRAIN, 0, dict_size))


def test(dict_size=_DICT_SIZE):
    return _reader_creator(_synthetic(_N_TEST, 1, dict_size))


def get_dict(dict_size=_DICT_SIZE, reverse=False):
    words = [START, END, UNK] + [f"tok{i}" for i in range(3, dict_size)]
    if reverse:
        return dict(enumerate(words))
    return {w: i for i, w in enumerate(words)}
