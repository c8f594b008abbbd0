"""The port's reader decorators and creators (twins of
tests/test_reader_decorators.py: the reference's decorator_test.py
contract), each run beside the JAX package's on the same readers."""
import numpy as np
import pytest

from paddle_tpu import reader as jrdr
from paddle_tpu_torch import reader as rdr


def _range_reader(n):
    def reader():
        yield from range(n)
    return reader


def test_shuffle_emits_every_sample_once():
    for buf in (1, 7, 64, 1000):
        got = sorted(rdr.shuffle(_range_reader(100), buf)())
        assert got == list(range(100))


def test_buffered_preserves_order_and_count():
    for size in (1, 3, 100):
        assert list(rdr.buffered(_range_reader(50), size)()) == list(range(50))


def test_buffered_is_restartable():
    r = rdr.buffered(_range_reader(5), 2)
    assert list(r()) == list(r()) == [0, 1, 2, 3, 4]


def test_firstn():
    assert list(rdr.firstn(_range_reader(10), 3)()) == [0, 1, 2]
    assert list(rdr.firstn(_range_reader(2), 5)()) == [0, 1]


def test_compose_flattens_tuples():
    a = _range_reader(3)

    def b():
        def r():
            for i in range(3):
                yield (i * 10, i * 100)
        return r
    got = list(rdr.compose(a, b())())
    assert got == [(0, 0, 0), (1, 10, 100), (2, 20, 200)]


def test_compose_misaligned_raises():
    with pytest.raises(rdr.ComposeNotAligned):
        list(rdr.compose(_range_reader(3), _range_reader(5))())


def test_map_readers():
    got = list(rdr.map_readers(lambda x, y: x + y,
                               _range_reader(4), _range_reader(4))())
    assert got == [0, 2, 4, 6]


def test_chain():
    assert list(rdr.chain(_range_reader(2), _range_reader(3))()) \
        == [0, 1, 0, 1, 2]


def test_cache_replays_without_rereading():
    calls = [0]

    def src():
        calls[0] += 1
        yield from range(3)
    r = rdr.cache(src)
    assert list(r()) == [0, 1, 2]
    assert list(r()) == [0, 1, 2]
    assert calls[0] == 1


@pytest.mark.parametrize("order", [False, True])
def test_xmap_readers(order):
    got = list(rdr.xmap_readers(lambda x: x * 2, _range_reader(40),
                                process_num=4, buffer_size=8,
                                order=order)())
    if order:
        assert got == [2 * i for i in range(40)]
    else:
        assert sorted(got) == [2 * i for i in range(40)]


def _failing_reader(n_ok):
    def reader():
        yield from range(n_ok)
        raise IOError("disk read failed")
    return reader


def test_buffered_propagates_source_error():
    r = rdr.buffered(_failing_reader(2), 4)
    got = []
    with pytest.raises(IOError, match="disk read failed"):
        for x in r():
            got.append(x)
    assert got == [0, 1]


def test_compose_handles_array_samples():
    import numpy as np

    def arr_reader():
        def r():
            for _ in range(3):
                yield np.zeros(3)
        return r
    got = list(rdr.compose(arr_reader(), arr_reader())())
    assert len(got) == 3 and len(got[0]) == 2


@pytest.mark.parametrize("order", [False, True])
def test_xmap_propagates_mapper_error(order):
    def bad_mapper(x):
        if x == 5:
            raise ValueError("decode error")
        return x
    with pytest.raises(ValueError, match="decode error"):
        list(rdr.xmap_readers(bad_mapper, _range_reader(20),
                              process_num=3, buffer_size=4, order=order)())


def test_xmap_propagates_reader_error():
    with pytest.raises(IOError, match="disk read failed"):
        list(rdr.xmap_readers(lambda x: x, _failing_reader(3),
                              process_num=2, buffer_size=4)())


def test_multiprocess_reader_collects_all():
    got = sorted(rdr.multiprocess_reader(
        [_range_reader(10), _range_reader(10)])())
    assert got == sorted(list(range(10)) * 2)


def test_same_outputs_as_the_jax_decorators():
    """Deterministic decorators give the JAX package's samples."""
    def cases(m):
        r = _range_reader(12)
        return [m.buffered(r, 3), m.firstn(r, 5), m.chain(r, r),
                m.map_readers(lambda a, b: a * b, r, r),
                m.compose(r, r), m.cache(r),
                m.xmap_readers(lambda x: x + 1, r, 3, 4, order=True),
                m.creator.np_array(np.arange(6).reshape(3, 2))]
    for got, want in zip(cases(rdr), cases(jrdr)):
        assert [np.asarray(s).tolist() for s in got()] == \
            [np.asarray(s).tolist() for s in want()]


def test_text_file_creator(tmp_path):
    path = tmp_path / "lines.txt"
    path.write_text("a b\nc\n\nd\n")
    assert list(rdr.creator.text_file(str(path))()) == \
        list(jrdr.creator.text_file(str(path))()) == ["a b", "c", "", "d"]


def test_stage_to_device_on_the_cpu():
    """On the CPU a numpy leaf becomes a tensor with the same values;
    anything that is not an array passes through."""
    import torch
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = rdr.stage_to_device(x, torch.device("cpu"))
    assert isinstance(t, torch.Tensor) and np.array_equal(t.numpy(), x)
    assert rdr.stage_to_device("tag", torch.device("cpu")) == "tag"
