"""CoNLL-2005 semantic role labelling (counterpart of
``paddle_tpu/dataset/conll05.py``): synthetic sentences whose BIO labels
are a function of the distance to a marked predicate.  A sample has nine
slots: word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2 (the predicate's
context words), predicate, mark, label."""
from __future__ import annotations

import numpy as np

from . import common

_WORD_VOCAB = 4000
_PRED_VOCAB = 300
_N_LABELS = 9      # BIO over 4 roles + O
_N_TRAIN = 1200
_N_TEST = 200


def get_dict():
    word_dict = {f"w{i}": i for i in range(_WORD_VOCAB)}
    verb_dict = {f"v{i}": i for i in range(_PRED_VOCAB)}
    label_dict = {f"L{i}": i for i in range(_N_LABELS)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    rng = np.random.RandomState(5)
    return rng.randn(_WORD_VOCAB, 32).astype(np.float32)


def _samples(n, seed):
    def gen():
        rng = np.random.RandomState(seed)
        out = []
        for _ in range(n):
            L = rng.randint(5, 30)
            words = rng.randint(0, _WORD_VOCAB, size=L)
            pred_pos = rng.randint(0, L)
            pred = int(words[pred_pos] % _PRED_VOCAB)
            mark = np.zeros(L, dtype=np.int64)
            mark[pred_pos] = 1
            dist = np.abs(np.arange(L) - pred_pos)
            label = np.where(dist == 0, 1,
                             np.where(dist == 1, 2,
                                      np.where(dist == 2, 3, 0)))

            def ctx(off):
                idx = np.clip(pred_pos + off, 0, L - 1)
                return np.full(L, words[idx], dtype=np.int64)
            out.append((words.astype(np.int64), ctx(-2), ctx(-1), ctx(0),
                        ctx(1), ctx(2), np.full(L, pred, dtype=np.int64),
                        mark, label.astype(np.int64)))
        return out
    return common.cached_synthetic("conll05", f"{n}_{seed}", gen)


def _reader(n, seed):
    def reader():
        for row in _samples(n, seed):
            yield tuple(x.tolist() for x in row)
    return reader


def train():
    return _reader(_N_TRAIN, 0)


def test():
    return _reader(_N_TEST, 1)


def fetch():
    _samples(_N_TRAIN, 0)
