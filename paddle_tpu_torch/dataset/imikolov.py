"""PTB language model (counterpart of ``paddle_tpu/dataset/imikolov.py``):
synthetic text from a fixed first-order Markov chain over the
vocabulary, as n-grams or as 20-token sentences."""
from __future__ import annotations

import numpy as np

from . import common

N = 5          # the default n-gram order
_VOCAB = 2074
_N_TRAIN_TOKENS = 30000
_N_TEST_TOKENS = 5000


class DataType:
    NGRAM = 1
    SEQ = 2


def build_dict(min_word_freq=50):
    return {f"w{i}": i for i in range(_VOCAB)}


def _chain(seed, n_tokens):
    def gen():
        rng = np.random.RandomState(99)
        # each word has 8 likely successors
        succ = rng.randint(0, _VOCAB, size=(_VOCAB, 8))
        r = np.random.RandomState(seed)
        toks = np.empty(n_tokens, dtype=np.int64)
        cur = r.randint(0, _VOCAB)
        for i in range(n_tokens):
            toks[i] = cur
            cur = succ[cur, r.randint(0, 8)]
        return toks
    return common.cached_synthetic("imikolov", f"{seed}_{n_tokens}", gen)


def _reader_creator(tokens, n, data_type):
    def reader():
        if data_type == DataType.NGRAM:
            for i in range(len(tokens) - n + 1):
                yield tuple(int(t) for t in tokens[i:i + n])
        else:
            L = 20
            for i in range(0, len(tokens) - L, L):
                sent = [int(t) for t in tokens[i:i + L]]
                yield sent[:-1], sent[1:]
    return reader


def train(word_idx=None, n=N, data_type=DataType.NGRAM):
    return _reader_creator(_chain(0, _N_TRAIN_TOKENS), n, data_type)


def test(word_idx=None, n=N, data_type=DataType.NGRAM):
    return _reader_creator(_chain(1, _N_TEST_TOKENS), n, data_type)


def fetch():
    _chain(0, _N_TRAIN_TOKENS)
