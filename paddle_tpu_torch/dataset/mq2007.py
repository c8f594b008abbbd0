"""MQ2007 learning to rank (counterpart of
``paddle_tpu/dataset/mq2007.py``): synthetic 46-dim query-document
features with linear relevance, in pointwise, pairwise or listwise
form."""
from __future__ import annotations

import numpy as np

from . import common

_N_QUERIES = 120
_DOCS_PER_Q = 8
_DIM = 46


def _world(seed):
    def gen():
        rng = np.random.RandomState(13)
        w = rng.randn(_DIM)
        r = np.random.RandomState(seed)
        queries = []
        for _ in range(_N_QUERIES):
            feats = r.randn(_DOCS_PER_Q, _DIM).astype(np.float32)
            scores = feats @ w
            rel = np.digitize(scores, np.quantile(scores, [0.5, 0.8]))
            queries.append((feats, rel.astype(np.int64)))
        return queries
    return common.cached_synthetic("mq2007", f"{seed}", gen)


def _pointwise(queries):
    def reader():
        for feats, rel in queries:
            for f, r in zip(feats, rel):
                yield int(r), f
    return reader


def _pairwise(queries):
    def reader():
        for feats, rel in queries:
            for i in range(len(rel)):
                for j in range(len(rel)):
                    if rel[i] > rel[j]:
                        yield 1.0, feats[i], feats[j]
    return reader


def _listwise(queries):
    def reader():
        yield from queries
    return reader


_FORMATS = {"pointwise": _pointwise, "pairwise": _pairwise,
            "listwise": _listwise}


def train(format="pairwise"):
    return _FORMATS[format](_world(0))


def test(format="pairwise"):
    return _FORMATS[format](_world(1))


def fetch():
    _world(0)
