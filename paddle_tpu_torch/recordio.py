"""Chunked record files (counterpart of ``paddle_tpu/recordio.py``), byte
for byte the JAX package's format: a file written by either package
reads in the other.

Each chunk is a 20-byte header
  magic(4) | crc32 of the stored payload(4) | compressor(4) |
  num_records(4) | payload_len(4)
(little-endian u32s) followed by the payload, ``[len(4) | bytes]*`` over
the chunk's records, zlib-compressed unless the compressor is
``NO_COMPRESS``.  Chunks decode independently, so a scanner can read a
``[begin, end)`` range of them (a shard).

`writer` and `scanner` are the preferred entry points: they return the
C++ `native.NativeWriter` and `native.NativeScanner` of a path.
`Writer` and `Scanner` are the plain Python versions of the same
format.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, List, Optional

MAGIC = 0x01020304
NO_COMPRESS = 0
ZLIB_COMPRESS = 2
_HEADER = struct.Struct("<IIIII")


class Writer:
    """Buffers records and writes a chunk every ``max_chunk_records``
    records or ``max_chunk_bytes`` bytes, and at `flush` / `close`."""

    def __init__(self, path_or_file, max_chunk_records: int = 1000,
                 max_chunk_bytes: int = 16 << 20,
                 compressor: int = ZLIB_COMPRESS):
        self._own = isinstance(path_or_file, (str, os.PathLike))
        self._f = open(path_or_file, "wb") if self._own else path_or_file
        self._max_records = max_chunk_records
        self._max_bytes = max_chunk_bytes
        self._compressor = compressor
        self._records: List[bytes] = []
        self._nbytes = 0

    def write(self, record: bytes):
        if isinstance(record, str):
            record = record.encode("utf-8")
        self._records.append(record)
        self._nbytes += len(record)
        if (len(self._records) >= self._max_records
                or self._nbytes >= self._max_bytes):
            self.flush()

    def flush(self):
        if not self._records:
            return
        payload = b"".join(struct.pack("<I", len(r)) + r
                           for r in self._records)
        if self._compressor == ZLIB_COMPRESS:
            payload = zlib.compress(payload)
        header = _HEADER.pack(MAGIC, zlib.crc32(payload) & 0xFFFFFFFF,
                              self._compressor, len(self._records),
                              len(payload))
        self._f.write(header + payload)
        self._records = []
        self._nbytes = 0

    def close(self):
        self.flush()
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class Scanner:
    """Iterates the records of a file, optionally only those of chunks
    ``[chunk_begin, chunk_end)``; a bad magic or checksum raises
    IOError."""

    def __init__(self, path: str, chunk_begin: int = 0,
                 chunk_end: Optional[int] = None):
        self._path = path
        self._begin = chunk_begin
        self._end = chunk_end

    def __iter__(self) -> Iterator[bytes]:
        with open(self._path, "rb") as f:
            idx = 0
            while True:
                head = f.read(_HEADER.size)
                if len(head) < _HEADER.size:
                    break
                magic, crc, comp, nrec, plen = _HEADER.unpack(head)
                if magic != MAGIC:
                    raise IOError(f"bad chunk magic in {self._path}")
                payload = f.read(plen)
                if self._end is not None and idx >= self._end:
                    break
                if idx < self._begin:
                    idx += 1
                    continue
                idx += 1
                if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                    raise IOError(f"chunk CRC mismatch in {self._path}")
                if comp == ZLIB_COMPRESS:
                    payload = zlib.decompress(payload)
                off = 0
                for _ in range(nrec):
                    (rlen,) = struct.unpack_from("<I", payload, off)
                    off += 4
                    yield payload[off:off + rlen]
                    off += rlen


def num_chunks(path: str) -> int:
    """The number of chunks in a file (the unit of a sharded read)."""
    n = 0
    with open(path, "rb") as f:
        while True:
            head = f.read(_HEADER.size)
            if len(head) < _HEADER.size:
                break
            *_rest, plen = _HEADER.unpack(head)
            f.seek(plen, os.SEEK_CUR)
            n += 1
    return n


def writer(path, **kw):
    """The C++ writer of ``path``."""
    from . import native
    return native.NativeWriter(os.fspath(path), **kw)


def scanner(path: str, chunk_begin: int = 0,
            chunk_end: Optional[int] = None):
    """The C++ scanner of ``path``'s chunks ``[chunk_begin, chunk_end)``."""
    from . import native
    return native.NativeScanner(os.fspath(path), chunk_begin, chunk_end)
