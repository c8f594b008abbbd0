"""ctypes bindings of the native C++ runtime (counterpart of
``paddle_tpu/native.py``).

The C++ (``paddle_tpu_torch/native/``: the recordio writer and scanner,
the blocking queue and the threaded file loader, the buddy memory pool,
the CPU inference runner and its C API ``paddle_tpu_capi.h``) imports
nothing of JAX and reads the artifacts ``io.save_inference_model``
writes.  It builds at first use, one ``g++`` per source, all started
together, then one link::

    g++ -O2 -fPIC -std=c++17 -c <src>.cc -o <src>.o        (each source)
    g++ <objects> -shared -lz -lpthread -o libpaddle_tpu_native-<hash>.so

under ``build/native`` at the root of the checkout (``.gitignore``'s
``build/``).  The hash covers the sources, the compiler and the flags,
so an edited source is rebuilt and an unchanged one is loaded as it is;
each process builds under temporary names and renames the library into
place, so parallel test workers build safely.  A failed build raises
with the compiler's output: nothing falls back to Python.

The PJRT runner of the JAX package compiles exported StableHLO through
a PJRT plugin; the port has no XLA, and its four names raise (ROADMAP
queue C: XLA-only options).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Sequence

SRC_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
SOURCES = ("recordio.cc", "blocking_queue.cc", "memory_pool.cc",
           "infer_cpu.cc", "capi.cc")
CXX = "g++"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17"]
LD_FLAGS = ["-shared", "-lz", "-lpthread"]
LIB_NAME = "paddle_tpu_native"

_lib = None
_lib_lock = threading.Lock()


def _configure(lib):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rio_writer_open.restype = ctypes.c_void_p
    lib.rio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                    ctypes.c_uint64, ctypes.c_uint64]
    lib.rio_writer_write.restype = ctypes.c_int
    lib.rio_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_uint64]
    lib.rio_writer_close.restype = ctypes.c_int
    lib.rio_writer_close.argtypes = [ctypes.c_void_p]

    lib.rio_scanner_open.restype = ctypes.c_void_p
    lib.rio_scanner_open.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_int64]
    lib.rio_scanner_next.restype = ctypes.c_int64
    lib.rio_scanner_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(u8p)]
    lib.rio_scanner_error.restype = ctypes.c_char_p
    lib.rio_scanner_error.argtypes = [ctypes.c_void_p]
    lib.rio_scanner_close.argtypes = [ctypes.c_void_p]
    lib.rio_num_chunks.restype = ctypes.c_int64
    lib.rio_num_chunks.argtypes = [ctypes.c_char_p]

    lib.bq_create.restype = ctypes.c_void_p
    lib.bq_create.argtypes = [ctypes.c_uint64]
    lib.bq_push.restype = ctypes.c_int
    lib.bq_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.bq_pop.restype = ctypes.c_void_p
    lib.bq_pop.argtypes = [ctypes.c_void_p]
    lib.bq_size.restype = ctypes.c_uint64
    lib.bq_size.argtypes = [ctypes.c_void_p]
    lib.bq_close.argtypes = [ctypes.c_void_p]
    lib.bq_destroy.argtypes = [ctypes.c_void_p]
    lib.blob_data.restype = u8p
    lib.blob_data.argtypes = [ctypes.c_void_p]
    lib.blob_len.restype = ctypes.c_uint64
    lib.blob_len.argtypes = [ctypes.c_void_p]
    lib.blob_free.argtypes = [ctypes.c_void_p]

    lib.loader_open.restype = ctypes.c_void_p
    lib.loader_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                ctypes.c_uint64]
    lib.loader_next.restype = ctypes.c_void_p
    lib.loader_next.argtypes = [ctypes.c_void_p]
    lib.loader_error.restype = ctypes.c_char_p
    lib.loader_error.argtypes = [ctypes.c_void_p]
    lib.loader_close.argtypes = [ctypes.c_void_p]

    lib.infer_cpu_load.restype = ctypes.c_void_p
    lib.infer_cpu_load.argtypes = [ctypes.c_char_p]
    _configure_predictor_api(lib, "infer_cpu")

    lib.mp_create.restype = ctypes.c_void_p
    lib.mp_create.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
    lib.mp_alloc.restype = ctypes.c_void_p
    lib.mp_alloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.mp_free.restype = ctypes.c_int
    lib.mp_free.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    for fn in ("mp_used", "mp_peak", "mp_capacity"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.mp_destroy.argtypes = [ctypes.c_void_p]
    _configure_capi(lib)
    return lib


def _configure_capi(lib):
    """restype/argtypes of the C API (``paddle_tpu_capi.h``)."""
    vp, i64, i64p = ctypes.c_void_p, ctypes.c_int64, \
        ctypes.POINTER(ctypes.c_int64)
    for name, res, args in (
            ("pt_tensor_create", vp, [ctypes.c_int, i64p, i64]),
            ("pt_tensor_destroy", None, [vp]),
            ("pt_tensor_data", vp, [vp]),
            ("pt_tensor_data_const", vp, [vp]),
            ("pt_tensor_dtype", ctypes.c_int, [vp]),
            ("pt_tensor_ndim", i64, [vp]),
            ("pt_tensor_dims", ctypes.c_int, [vp, i64p]),
            ("pt_tensor_numel", i64, [vp]),
            ("pt_predictor_load", vp, [ctypes.c_char_p]),
            ("pt_predictor_destroy", None, [vp]),
            ("pt_predictor_ok", ctypes.c_int, [vp]),
            ("pt_predictor_error", ctypes.c_char_p, [vp]),
            ("pt_predictor_num_inputs", i64, [vp]),
            ("pt_predictor_input_name", ctypes.c_char_p, [vp, i64]),
            ("pt_predictor_set_input", ctypes.c_int,
             [vp, ctypes.c_char_p, vp]),
            ("pt_predictor_run", ctypes.c_int, [vp]),
            ("pt_predictor_num_outputs", i64, [vp]),
            ("pt_predictor_output", vp, [vp, i64])):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def _lib_path() -> Path:
    h = hashlib.sha256()
    for f in sorted(SRC_DIR.iterdir()):
        if f.suffix in (".cc", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join([CXX, *CXX_FLAGS, *LD_FLAGS]).encode())
    return BUILD_DIR / f"lib{LIB_NAME}-{h.hexdigest()[:12]}.so"


def _build(path: Path):
    """Compile every source in parallel, link, rename into ``path``;
    raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.tmp{os.getpid()}"
    objs, procs, failed = [], [], []
    try:
        for src in SOURCES:
            obj = BUILD_DIR / f"{tag}.{Path(src).stem}.o"
            objs.append(obj)
            cmd = [CXX, *CXX_FLAGS, "-c", str(SRC_DIR / src), "-o", str(obj)]
            try:
                procs.append((src, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            except OSError as e:
                failed.append(f"{CXX} {src}: {e}")
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{CXX} {src} failed ({proc.returncode}):"
                              f"\n{out}")
        if failed:
            raise RuntimeError("native build failed:\n" + "\n".join(failed))
        tmp = BUILD_DIR / f"{tag}.so"
        link = subprocess.run([CXX, *map(str, objs), *LD_FLAGS, "-o",
                               str(tmp)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"native link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(tmp, path)
    finally:
        for obj in objs:
            if obj.exists():
                obj.unlink()


def load_library(build: bool = True):
    """The loaded native library, built first when it is missing (and
    ``build``).  Raises RuntimeError when it cannot be built or
    loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            path = _lib_path()
            if not path.exists():
                if not build:
                    raise RuntimeError(f"native library {path} is not built")
                _build(path)
            _lib = _configure(ctypes.CDLL(str(path)))
    return _lib


def available() -> bool:
    """Whether the native library loads (building it if needed)."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


# ---------------------------------------------------------------------------
# Python wrappers
# ---------------------------------------------------------------------------

class NativeWriter:
    """The C++ recordio writer (the on-disk format of `recordio.Writer`)."""

    def __init__(self, path: str, compressor: int = 2,
                 max_chunk_records: int = 1000,
                 max_chunk_bytes: int = 16 << 20):
        self._lib = load_library()
        self._h = self._lib.rio_writer_open(
            os.fsencode(path), compressor, max_chunk_records, max_chunk_bytes)
        if not self._h:
            raise IOError(f"cannot open {path}")

    def write(self, record: bytes):
        if isinstance(record, str):
            record = record.encode("utf-8")
        if self._lib.rio_writer_write(self._h, record, len(record)) != 0:
            raise IOError("recordio write failed")

    def close(self):
        if self._h:
            rc = self._lib.rio_writer_close(self._h)
            self._h = None
            if rc != 0:
                raise IOError("recordio close/flush failed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class NativeScanner:
    """The C++ recordio scanner, with ``[chunk_begin, chunk_end)`` range
    reads."""

    def __init__(self, path: str, chunk_begin: int = 0,
                 chunk_end: Optional[int] = None):
        self._lib = load_library()
        self._path = path
        self._begin = chunk_begin
        self._end = -1 if chunk_end is None else chunk_end

    def __iter__(self) -> Iterator[bytes]:
        h = self._lib.rio_scanner_open(os.fsencode(self._path), self._begin,
                                       self._end)
        if not h:
            raise IOError(f"cannot open {self._path}")
        try:
            data = ctypes.POINTER(ctypes.c_uint8)()
            while True:
                n = self._lib.rio_scanner_next(h, ctypes.byref(data))
                if n == -1:
                    return
                if n == -2:
                    err = self._lib.rio_scanner_error(h).decode()
                    raise IOError(f"{err} in {self._path}")
                yield ctypes.string_at(data, n)
        finally:
            self._lib.rio_scanner_close(h)


def native_num_chunks(path: str) -> int:
    n = load_library().rio_num_chunks(os.fsencode(path))
    if n < 0:
        raise IOError(f"cannot open {path}")
    return n


class BlockingQueue:
    """A bounded multi-producer, multi-consumer queue of byte blobs."""

    def __init__(self, capacity: int = 256):
        self._lib = load_library()
        self._h = self._lib.bq_create(capacity)

    def push(self, data: bytes) -> bool:
        return self._lib.bq_push(self._h, data, len(data)) == 0

    def pop(self) -> Optional[bytes]:
        blob = self._lib.bq_pop(self._h)
        if not blob:
            return None
        try:
            return ctypes.string_at(self._lib.blob_data(blob),
                                    self._lib.blob_len(blob))
        finally:
            self._lib.blob_free(blob)

    def __len__(self):
        return self._lib.bq_size(self._h)

    def close(self):
        self._lib.bq_close(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.bq_destroy(self._h)
            self._h = None


class FileLoader:
    """The threaded C++ recordio loader: up to ``num_threads`` threads,
    one a file at a time, parse records into one bounded queue.  Each
    file's records keep their order; across files the order is the
    threads' (one thread reads the files in turn, in ``paths``'
    order)."""

    def __init__(self, paths: Sequence[str], num_threads: int = 2,
                 queue_capacity: int = 1024):
        self._lib = load_library()
        joined = "\n".join(paths).encode()
        self._h = self._lib.loader_open(joined, num_threads, queue_capacity)

    def __iter__(self) -> Iterator[bytes]:
        while True:
            if self._h is None:
                raise ValueError("loader is closed")
            blob = self._lib.loader_next(self._h)
            if not blob:
                err = self._lib.loader_error(self._h).decode()
                if err:
                    raise IOError(err)
                return
            try:
                yield ctypes.string_at(self._lib.blob_data(blob),
                                       self._lib.blob_len(blob))
            finally:
                self._lib.blob_free(blob)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.loader_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


class _BasePredictor:
    """The ctypes surface of a native inference runner's C API: load,
    stage the feeds, run, read the outputs (symbols ``<_PREFIX>_*``)."""

    _DTYPES = {0: "float32", 1: "float64", 2: "int32", 3: "int64"}
    _CODES = {"float32": 0, "float64": 1, "int32": 2, "int64": 3}
    _PREFIX = ""

    def _fn(self, name):
        return getattr(self._lib, f"{self._PREFIX}_{name}")

    def _check_load_error(self):
        err = self._fn("error")(self._h).decode()
        if err:
            self._fn("destroy")(self._h)
            self._h = None
            raise IOError(f"{self._PREFIX} load failed: {err}")

    @property
    def feed_names(self) -> List[str]:
        n = self._fn("num_feeds")(self._h)
        return [self._fn("feed_name")(self._h, i).decode() for i in range(n)]

    @property
    def fetch_names(self) -> List[str]:
        n = self._fn("num_fetches")(self._h)
        return [self._fn("fetch_name")(self._h, i).decode()
                for i in range(n)]

    def run(self, feed: dict):
        import numpy as np
        for name, value in feed.items():
            arr = np.ascontiguousarray(value)
            if arr.dtype == np.float64:
                arr = arr.astype(np.float32)  # the framework's default
            code = self._CODES.get(str(arr.dtype))
            if code is None:
                raise TypeError(f"unsupported feed dtype {arr.dtype}")
            dims = (ctypes.c_int64 * arr.ndim)(*arr.shape)
            if self._fn("stage_feed")(
                    self._h, name.encode(), code, dims, arr.ndim,
                    arr.ctypes.data_as(ctypes.c_void_p)) != 0:
                raise RuntimeError(
                    f"stage feed failed: {self._fn('error')(self._h).decode()}")
        n = self._fn("run")(self._h)
        if n < 0:
            raise RuntimeError(
                f"inference failed: {self._fn('error')(self._h).decode()}")
        outs = []
        for i in range(n):
            nd = self._fn("output_ndim")(self._h, i)
            dims = (ctypes.c_int64 * max(nd, 1))()
            self._fn("output_dims")(self._h, i, dims)
            shape = tuple(dims[j] for j in range(nd))
            dtype = self._DTYPES[self._fn("output_dtype")(self._h, i)]
            nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
            ptr = self._fn("output_data")(self._h, i)
            buf = ctypes.string_at(ptr, nbytes)
            outs.append(np.frombuffer(buf, dtype=dtype).reshape(shape).copy())
        return outs

    def __del__(self):
        if getattr(self, "_h", None):
            self._fn("destroy")(self._h)
            self._h = None


def _configure_predictor_api(lib, prefix):
    """restype/argtypes of one runner's C API."""
    g = lambda name: getattr(lib, f"{prefix}_{name}")  # noqa: E731
    g("error").restype = ctypes.c_char_p
    g("error").argtypes = [ctypes.c_void_p]
    for fn in ("num_feeds", "num_fetches", "run"):
        g(fn).restype = ctypes.c_int64
        g(fn).argtypes = [ctypes.c_void_p]
    for fn in ("feed_name", "fetch_name"):
        g(fn).restype = ctypes.c_char_p
        g(fn).argtypes = [ctypes.c_void_p, ctypes.c_int64]
    g("stage_feed").restype = ctypes.c_int
    g("stage_feed").argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_void_p]
    g("output_ndim").restype = ctypes.c_int64
    g("output_ndim").argtypes = [ctypes.c_void_p, ctypes.c_int64]
    g("output_dims").argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.POINTER(ctypes.c_int64)]
    g("output_dtype").restype = ctypes.c_int
    g("output_dtype").argtypes = [ctypes.c_void_p, ctypes.c_int64]
    g("output_data").restype = ctypes.c_void_p
    g("output_data").argtypes = [ctypes.c_void_p, ctypes.c_int64]
    g("destroy").argtypes = [ctypes.c_void_p]


class CpuPredictor(_BasePredictor):
    """The C++ CPU inference runner over a model ``io.save_inference_model``
    wrote (JSON ``__model__`` and one ``.npy`` a persistable; NCHW
    convolutions), run entirely in C++."""

    _PREFIX = "infer_cpu"

    def __init__(self, model_dir: str):
        self._lib = load_library()
        self._h = self._lib.infer_cpu_load(os.fsencode(model_dir))
        self._check_load_error()


def capi_run(model_dir: str, feed: dict) -> List["np.ndarray"]:
    """One forward of a saved model through the C API, as a C program
    embedding ``paddle_tpu_capi.h`` makes it: ``pt_predictor_load``, a
    ``pt_tensor_create`` and ``pt_predictor_set_input`` a feed,
    ``pt_predictor_run``, then each ``pt_predictor_output`` copied out.
    Raises with the predictor's error."""
    import numpy as np
    lib = load_library()
    p = lib.pt_predictor_load(os.fsencode(model_dir))
    tensors = []
    try:
        if lib.pt_predictor_ok(p) != 0:
            raise IOError(lib.pt_predictor_error(p).decode())
        for name, value in feed.items():
            arr = np.ascontiguousarray(value)
            code = _BasePredictor._CODES.get(str(arr.dtype))
            if code is None:
                raise TypeError(f"unsupported feed dtype {arr.dtype}")
            dims = (ctypes.c_int64 * arr.ndim)(*arr.shape)
            t = lib.pt_tensor_create(code, dims, arr.ndim)
            tensors.append(t)
            ctypes.memmove(lib.pt_tensor_data(t), arr.ctypes.data,
                           arr.nbytes)
            if lib.pt_predictor_set_input(p, name.encode(), t) != 0:
                raise RuntimeError(lib.pt_predictor_error(p).decode())
        if lib.pt_predictor_run(p) != 0:
            raise RuntimeError(lib.pt_predictor_error(p).decode())
        outs = []
        for i in range(lib.pt_predictor_num_outputs(p)):
            out = lib.pt_predictor_output(p, i)
            nd = lib.pt_tensor_ndim(out)
            dims = (ctypes.c_int64 * max(nd, 1))()
            lib.pt_tensor_dims(out, dims)
            shape = tuple(dims[j] for j in range(nd))
            dtype = _BasePredictor._DTYPES[lib.pt_tensor_dtype(out)]
            nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
            buf = ctypes.string_at(lib.pt_tensor_data_const(out), nbytes)
            outs.append(np.frombuffer(buf, dtype=dtype).reshape(shape).copy())
        return outs
    finally:
        for t in tensors:
            lib.pt_tensor_destroy(t)
        lib.pt_predictor_destroy(p)


_PJRT = ("the PJRT runner compiles exported StableHLO through a PJRT "
         "plugin; the port has no XLA (ROADMAP queue C: XLA-only options)")


def load_pjrt_library():
    raise RuntimeError(f"load_pjrt_library: {_PJRT}")


def pjrt_plugin_candidates() -> List[str]:
    raise RuntimeError(f"pjrt_plugin_candidates: {_PJRT}")


def default_pjrt_plugin() -> Optional[str]:
    raise RuntimeError(f"default_pjrt_plugin: {_PJRT}")


class PjrtPredictor(_BasePredictor):
    _PREFIX = "pjrt_runner"

    def __init__(self, model_dir: str, plugin_path: Optional[str] = None):
        raise RuntimeError(f"PjrtPredictor: {_PJRT}")


class MemoryPool:
    """A buddy-allocator host memory pool."""

    def __init__(self, capacity: int = 64 << 20, min_block: int = 256):
        self._lib = load_library()
        self._h = self._lib.mp_create(capacity, min_block)
        if not self._h:
            raise MemoryError("cannot create pool")

    def alloc(self, n: int) -> Optional[int]:
        p = self._lib.mp_alloc(self._h, n)
        return p or None

    def free(self, ptr: int):
        if self._lib.mp_free(self._h, ptr) != 0:
            raise ValueError("pointer not owned by pool")

    @property
    def used(self) -> int:
        return self._lib.mp_used(self._h)

    @property
    def peak(self) -> int:
        return self._lib.mp_peak(self._h)

    @property
    def capacity(self) -> int:
        return self._lib.mp_capacity(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.mp_destroy(self._h)
            self._h = None
