"""The port's datasets (``paddle_tpu_torch/dataset``) against the JAX
package's synthetic fallback, on the CPU: the first 64 samples of every
split of the twelve modules and wmt14 are bitwise the JAX module's (the
same Python types, numpy dtypes and bytes).  The JAX package caches its
synthetic data under its data home, which each test points at
``tmp_path``.  ``common.convert``'s recordio shards hold the samples,
pickled, in both packages' scanners."""
import itertools
import pickle

import numpy as np
import pytest

from paddle_tpu import dataset as jdataset
from paddle_tpu import recordio as jrecordio
from paddle_tpu.dataset import common as jcommon
from paddle_tpu_torch import dataset
from paddle_tpu_torch import recordio

N = 64

#: module -> (split name, call) pairs: every split each JAX module has
SPLITS = {
    "cifar": [(s, lambda m, s=s: getattr(m, s)())
              for s in ("train10", "test10", "train100", "test100")],
    "conll05": [("train", lambda m: m.train()), ("test", lambda m: m.test())],
    "flowers": [(s, lambda m, s=s: getattr(m, s)())
                for s in ("train", "test", "valid")],
    "imdb": [("train", lambda m: m.train()), ("test", lambda m: m.test())],
    "imikolov": [
        ("train", lambda m: m.train()), ("test", lambda m: m.test()),
        ("train 3-gram", lambda m: m.train(n=3)),
        ("train sequences", lambda m: m.train(data_type=m.DataType.SEQ)),
        ("test sequences", lambda m: m.test(data_type=m.DataType.SEQ))],
    "mnist": [("train", lambda m: m.train()), ("test", lambda m: m.test())],
    "movielens": [("train", lambda m: m.train()),
                  ("test", lambda m: m.test())],
    "mq2007": [(f"{split} {fmt}", lambda m, s=split, f=fmt:
                getattr(m, s)(format=f))
               for split in ("train", "test")
               for fmt in ("pointwise", "pairwise", "listwise")],
    "sentiment": [("train", lambda m: m.train()),
                  ("test", lambda m: m.test())],
    "uci_housing": [("train", lambda m: m.train()),
                    ("test", lambda m: m.test())],
    "voc2012": [(s, lambda m, s=s: getattr(m, s)())
                for s in ("train", "test", "val")],
    "wmt14": [("train", lambda m: m.train()), ("test", lambda m: m.test()),
              ("train dict 300", lambda m: m.train(dict_size=300))],
    "wmt16": [(s, lambda m, s=s: getattr(m, s)())
              for s in ("train", "test", "validation")]
              + [("train 500/700", lambda m: m.train(500, 700))],
}


@pytest.fixture(autouse=True)
def _jax_data_home(tmp_path, monkeypatch):
    """The JAX package's synthetic cache in a fresh directory."""
    monkeypatch.setattr(jcommon, "DATA_HOME", str(tmp_path / "jax_home"))
    yield


def _same(a, b, where="sample"):
    """Bitwise equality of nested samples: types, dtypes, shapes, bytes."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, (float, np.floating)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), where
    else:
        assert a == b, where


@pytest.mark.parametrize("module,split,call", [
    (m, s, c) for m, splits in SPLITS.items() for s, c in splits])
def test_first_samples_match_jax(module, split, call):
    got = list(itertools.islice(call(getattr(dataset, module))(), N))
    want = list(itertools.islice(call(getattr(jdataset, module))(), N))
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, f"{module} {split} sample {i}")


def test_metadata_matches_jax():
    """The dictionaries and side tables the readers come with."""
    for name in ("get_dict", "get_embedding"):
        _same(getattr(dataset.conll05, name)(),
              getattr(jdataset.conll05, name)(), name)
    assert dataset.imdb.word_dict() == jdataset.imdb.word_dict()
    assert dataset.imikolov.build_dict() == jdataset.imikolov.build_dict()
    assert (dataset.sentiment.get_word_dict()
            == jdataset.sentiment.get_word_dict())
    assert (dataset.wmt16.get_dict("de", 50, reverse=True)
            == jdataset.wmt16.get_dict("de", 50, reverse=True))
    for fn in ("max_user_id", "max_movie_id", "max_job_id", "categories",
               "get_movie_title_dict"):
        assert (getattr(dataset.movielens, fn)()
                == getattr(jdataset.movielens, fn)()), fn
    pm, jm = dataset.movielens.movie_info(), jdataset.movielens.movie_info()
    assert [(m.index, m.categories, m.title) for m in pm.values()] == [
        (m.index, m.categories, m.title) for m in jm.values()]
    pu, ju = dataset.movielens.user_info(), jdataset.movielens.user_info()
    assert [vars(u) for u in pu.values()] == [vars(u) for u in ju.values()]
    assert dataset.uci_housing.feature_names == (
        jdataset.uci_housing.feature_names)


def test_convert_shards_read_in_both_scanners(tmp_path):
    """common.convert of 250 uci_housing samples in shards of 100: three
    shards, each read by the port's and the JAX package's Scanner to the
    same records, which unpickle to the samples; the JAX convert's shards
    hold the same records."""
    reader = lambda: itertools.islice(dataset.uci_housing.train()(), 250)
    out, jout = tmp_path / "port", tmp_path / "jax"
    out.mkdir()
    jout.mkdir()
    assert dataset.common.convert(str(out), reader, 100, "uci") == 3
    assert jcommon.convert(str(jout), reader, 100, "uci") == 3
    records = []
    for i in range(3):
        path = str(out / f"uci-{i:05d}")
        got = list(recordio.Scanner(path))
        assert got == list(jrecordio.Scanner(path))
        assert got == list(jrecordio.Scanner(str(jout / f"uci-{i:05d}")))
        records += got
    assert len(records) == 250
    for rec, sample in zip(records, reader()):
        _same(pickle.loads(rec), sample)


def test_mnist_convert(tmp_path, monkeypatch):
    """mnist.convert writes the train and test shards of 1000 samples
    (the train split cut to 2500 samples here)."""
    monkeypatch.setattr(dataset.mnist, "_N_TRAIN", 2500)
    dataset.mnist.convert(str(tmp_path))
    first = list(recordio.Scanner(str(tmp_path / "mnist_test-00000")))
    assert len(first) == 1000
    _same(pickle.loads(first[0]), next(dataset.mnist.test()()))
    assert (tmp_path / "mnist_train-00002").exists()
    assert not (tmp_path / "mnist_train-00003").exists()
