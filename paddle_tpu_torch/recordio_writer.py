"""Readers to recordio files (counterpart of
``paddle_tpu/recordio_writer.py``).

Each record is one sample, a tuple of numpy arrays, in the JAX package's
layout: u32 n_fields, then per field u8 dtype code, u8 ndim, ndim i64
dims and the array's little-endian bytes.  The dtype codes are the JAX
package's, so samples cross between the packages unchanged;
`layers.io.open_recordio_file` reads them back.
"""
from __future__ import annotations

import struct
from typing import Callable, Iterable, List

import numpy as np

from . import recordio

_DTYPES = [np.float32, np.float64, np.int32, np.int64, np.uint8, np.bool_,
           np.float16, np.int8, np.int16, np.uint16, np.uint32, np.uint64]
_CODE = {np.dtype(d): i for i, d in enumerate(_DTYPES)}


def serialize_sample(sample) -> bytes:
    if not isinstance(sample, (tuple, list)):
        sample = (sample,)
    out = [struct.pack("<I", len(sample))]
    for field in sample:
        a = np.ascontiguousarray(np.asarray(field))
        if a.dtype not in _CODE:
            if np.issubdtype(a.dtype, np.floating):
                a = a.astype(np.float32)      # e.g. longdouble
            else:
                raise TypeError(
                    f"unsupported sample dtype {a.dtype}; supported: "
                    f"{[np.dtype(d).name for d in _DTYPES]}")
        out.append(struct.pack("<BB", _CODE[a.dtype], a.ndim))
        out.append(struct.pack(f"<{a.ndim}q", *a.shape))
        out.append(a.tobytes())
    return b"".join(out)


def deserialize_sample(data: bytes):
    """A record back to its tuple of (read-only) arrays."""
    (n,) = struct.unpack_from("<I", data, 0)
    off = 4
    fields = []
    for _ in range(n):
        code, ndim = struct.unpack_from("<BB", data, off)
        off += 2
        shape = struct.unpack_from(f"<{ndim}q", data, off)
        off += 8 * ndim
        dt = np.dtype(_DTYPES[code])
        count = int(np.prod(shape)) if ndim else 1
        a = np.frombuffer(data, dtype=dt, count=count, offset=off
                          ).reshape(shape)
        off += count * dt.itemsize
        fields.append(a)
    return tuple(fields)


def convert_reader_to_recordio_file(
        filename: str, reader_creator: Callable[[], Iterable],
        feeder=None, compressor=None, max_num_records: int = 1000) -> int:
    """Write every sample of ``reader_creator()`` into one recordio file;
    -> the number of records."""
    n = 0
    with recordio.Writer(filename, max_chunk_records=max_num_records) as w:
        for sample in reader_creator():
            w.write(serialize_sample(sample))
            n += 1
    return n


def convert_reader_to_recordio_files(
        filename: str, batch_per_file: int,
        reader_creator: Callable[[], Iterable], feeder=None,
        compressor=None, max_num_records: int = 1000) -> List[str]:
    """Shards of ``batch_per_file`` samples: ``filename-00000``,
    ``-00001``, ...; -> their paths."""
    paths = []
    w = None
    idx = in_file = 0
    try:
        for sample in reader_creator():
            if w is None or in_file >= batch_per_file:
                if w is not None:
                    w.close()
                path = f"{filename}-{idx:05d}"
                paths.append(path)
                w = recordio.Writer(path, max_chunk_records=max_num_records)
                idx += 1
                in_file = 0
            w.write(serialize_sample(sample))
            in_file += 1
    finally:
        if w is not None:
            w.close()
    return paths
