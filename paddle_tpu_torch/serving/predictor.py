"""In-process inference over a saved model (counterpart of
``paddle_tpu/serving/predictor.py``).

The JAX predictor keeps one compiled executable per feed signature.  The
port interprets the pruned program eagerly (`core.lowering.Interpreter`)
under ``torch.inference_mode()`` on its device, over a snapshot of the
parameters that it copies onto the device once, at construction: a
training run that later updates the scope does not reach it.

What stays of the executable cache is its accounting.  The first call
at a feed signature is the cold one here too (the kernels' libraries
load, cuBLAS and cuDNN choose their algorithms for the shape), so
``run_with_info`` reports ``hit`` for a signature this predictor has run
before, and ``stats()`` counts ``cache_hits`` / ``cache_misses`` and
``shapes_seen``.  The JAX keys only XLA can give (``disk_hits``,
``cached_executables``, compile seconds) are left out.

Precision, as the JAX predictor's ``_apply_precision``:

- ``"bf16"`` casts every f32 parameter to bf16 and sets ``program.amp``;
- ``"int8"`` also quantizes each f32 2-D matrix of at least
  ``INT8_MIN_ELEMENTS`` elements to int8 with per-column absmax scales
  (`core.lowering.quantize_int8`).  A matrix a product reads is
  dequantized to bf16 inside each forward; a table that only
  ``lookup_table`` reads stays int8 and the rule dequantizes the rows it
  gathers (``@QSCALE@`` env key).

The hot-row embedding cache (``embedding_cache_rows=N``, the JAX
eligibility rule): a table that only ``lookup_table`` reads, whose ids
are a feed, leaves the device parameters and is served through a
`HotRowCache` of N rows with the full table in host memory; the cache
resolves each batch's ids to rows on the host side of the call, and the
rows reach the rule under ``<Out>@CACHED_ROWS@``.  Under int8 the cache
holds int8 rows.  `apply_row_deltas` patches table rows in place (a
published trainer delta), through the cache or as one scatter into a new
device tensor.

Refused with a ValueError: ``compile_cache`` (eager PyTorch has no
executable to persist; the nearest analog, the kernels' ``.so`` build
cache in ``build/kernels``, is keyed by source hash already).
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import profiler
from ..core.lowering import (CACHED_ROWS_SUFFIX, INT8_MIN_ELEMENTS,
                             QSCALE_SUFFIX, Interpreter, dequantize_int8,
                             quantize_int8)
from ..core.place import resolve_device
from ..core.program import Program, Variable
from ..core.scope import Scope, global_scope, scope_guard
from ..core.types import to_torch_dtype
from ..observability import default_registry as _obs_registry
from .hot_rows import HotRowCache

# the predictor is the executor layer of a serving process: the JAX
# package's executor_* families, under layer="predictor"
_PRED_CACHE = _obs_registry().counter(
    "executor_cache_events_total",
    "compile-cache lookups by the executor layer",
    labelnames=("layer", "result"))
_PRED_CACHE_HIT = _PRED_CACHE.labels(layer="predictor", result="hit")
_PRED_CACHE_MISS = _PRED_CACHE.labels(layer="predictor", result="miss")
_PRED_RUN_S = _obs_registry().histogram(
    "executor_run_seconds", "jitted step execution time",
    labelnames=("layer",)).labels(layer="predictor")


def _refuse_xla_options(compile_cache):
    if compile_cache is not None:
        raise ValueError(
            "compile_cache persists XLA executables; eager PyTorch has "
            "none to persist (the kernels' build cache in build/kernels "
            "is the port's analog; ROADMAP queue C: XLA-only options)")


class Predictor:
    """Runs a fixed inference program on one device over a parameter
    snapshot."""

    PRECISIONS = ("f32", "bf16", "int8")
    #: int8 candidates: f32 2-D matrices of at least this many elements
    INT8_MIN_ELEMENTS = INT8_MIN_ELEMENTS
    QSCALE_SUFFIX = QSCALE_SUFFIX

    def __init__(self, program: Program, feed_names: Sequence[str],
                 fetch_vars: Sequence, scope: Optional[Scope] = None,
                 compile_cache=None, precision: str = "f32",
                 embedding_cache_rows: int = 0, device=None):
        _refuse_xla_options(compile_cache)
        if precision not in self.PRECISIONS:
            raise ValueError(f"precision must be one of {self.PRECISIONS},"
                             f" got {precision!r}")
        self.program = program
        self.feed_names = list(feed_names)
        self.fetch_names = [v.name if isinstance(v, Variable) else str(v)
                            for v in fetch_vars]
        self.precision = str(precision)
        self.device = resolve_device(device)
        scope = scope or global_scope()
        self._params: Dict[str, torch.Tensor] = {}
        self._quantized: Dict[str, str] = {}     # param -> its scale key
        #: int8 tables read only by lookup_table: the rule dequantizes
        #: the gathered rows, the table stays int8
        self._gather_quantized: set = set()
        for v in program.global_block().vars.values():
            if v.persistable:
                val = scope.get(v.name)
                if val is not None:
                    self._params[v.name] = self._own_copy(val)
        if self.precision != "f32":
            self._apply_precision()
        self._setup_row_caches(embedding_cache_rows)
        # the computation's identity, the JAX recipe: two loads of one
        # __model__ share it
        self.fingerprint = hashlib.sha1(
            json.dumps(program.to_dict(), sort_keys=True).encode()
        ).hexdigest()[:16]
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(program.random_seed or 0))
        self._lock = threading.Lock()
        self._seen: set = set()
        self.cache_hits = 0
        self.cache_misses = 0

    def _own_copy(self, val) -> torch.Tensor:
        """The predictor's own device copy of a scope value."""
        if isinstance(val, torch.Tensor):
            return val.detach().to(self.device, copy=True)
        return torch.tensor(np.asarray(val), device=self.device)

    # -- precision -----------------------------------------------------
    def _apply_precision(self):
        self.program.amp = True        # the bf16 activation stream
        lookup_only = (self._lookup_only_params()
                       if self.precision == "int8" else set())
        for name, val in list(self._params.items()):
            if val.dtype != torch.float32:
                continue
            if (self.precision == "int8" and val.dim() == 2
                    and val.numel() >= self.INT8_MIN_ELEMENTS):
                q, scale = quantize_int8(val)
                skey = name + QSCALE_SUFFIX
                self._params[name] = q
                self._params[skey] = scale
                self._quantized[name] = skey
                if name in lookup_only:
                    self._gather_quantized.add(name)
            else:
                self._params[name] = val.to(torch.bfloat16)

    # -- hot-row cache ---------------------------------------------------
    def _setup_row_caches(self, budget_rows: int):
        """Move each eligible table into a `HotRowCache`: every use a
        lookup_table "W" input (the int8 gather-dequant rule) and every
        site's ids a feed (in-graph ids cannot be resolved on the host),
        as the JAX predictor decides."""
        self._row_caches: Dict[str, HotRowCache] = {}
        #: (Out name, Ids feed name, table name) of each cached site
        self._cached_lookups: List = []
        if not budget_rows:
            return
        eligible = self._lookup_only_params()
        feedable = set(self.feed_names)
        sites: Dict[str, List] = {}
        for op in self.program.global_block().ops:
            if op.type != "lookup_table":
                continue
            w = op.desc.inputs["W"][0]
            if w in eligible and w in self._params:
                sites.setdefault(w, []).append(
                    (op.desc.outputs["Out"][0], op.desc.inputs["Ids"][0]))
        for name, pairs in sites.items():
            if (not all(ids in feedable for _, ids in pairs)
                    or self._params[name].dim() != 2):
                continue
            # the table never stays on the device
            self._row_caches[name] = HotRowCache(
                self._params.pop(name), budget_rows, name=name,
                device=self.device)
            self._cached_lookups.extend((o, i, name) for o, i in pairs)

    def _cached_rows(self, feed: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Each cached site's rows, keyed for the rule, resolved on the
        host from the ids as the caller sent them."""
        out = {}
        for out_name, ids_name, table in self._cached_lookups:
            ids = feed[ids_name]
            ids = (ids.cpu().numpy() if isinstance(ids, torch.Tensor)
                   else np.asarray(ids))
            if ids.ndim >= 2 and ids.shape[-1] == 1:
                ids = ids.reshape(ids.shape[:-1])   # the rule's squeeze
            out[out_name + CACHED_ROWS_SUFFIX] = \
                self._row_caches[table].lookup(ids)
        return out

    def apply_row_deltas(self, updates: Dict[str, Any]) -> int:
        """Patch embedding rows from a published delta: ``updates`` maps a
        table name to ``(rows, values)``.  A cached table goes through its
        cache (`HotRowCache.apply_delta`); a device table takes one
        scatter into a new tensor, swapped in under the lock, so a request
        in flight finishes on the tensor it started with.  An int8 table
        refuses: its scales came from the whole table at load.  Returns
        the rows applied."""
        total = 0
        for name, (rows, values) in updates.items():
            if name in self._quantized:
                raise ValueError(
                    f"table {name!r} is int8-quantized; row deltas "
                    "cannot recompute its per-channel scales — reload "
                    "the model instead")
            cache = self._row_caches.get(name)
            if cache is not None:
                total += cache.apply_delta(rows, values)
                continue
            cur = self._params.get(name)
            if cur is None or cur.dim() != 2:
                raise KeyError(f"table {name!r} is not a [V, D] param of "
                               "this predictor")
            rows = np.asarray(rows).reshape(-1).astype(np.int64)
            v = int(cur.shape[0])
            if rows.size and ((rows < 0) | (rows >= v)).any():
                raise ValueError(f"delta rows outside [0, {v})")
            new = cur.clone()
            new[torch.from_numpy(rows).to(cur.device)] = torch.as_tensor(
                np.asarray(values)).to(cur.device, cur.dtype)
            with self._lock:
                self._params[name] = new
            total += int(rows.size)
        return total

    def _lookup_only_params(self) -> set:
        """Params whose every use is a lookup_table "W" input of the
        global block (and no sub-block reads them)."""
        only: Dict[str, bool] = {}
        for op in self.program.global_block().ops:
            for slot, names in op.desc.inputs.items():
                for n in names:
                    if n in self._params:
                        is_lt = op.type == "lookup_table" and slot == "W"
                        only[n] = only.get(n, True) and is_lt
        for blk in self.program.blocks[1:]:
            for op in blk.ops:
                for n in op.desc.input_names():
                    if n in only:
                        only[n] = False
        return {n for n, v in only.items() if v}

    # ------------------------------------------------------------------
    @classmethod
    def from_model_dir(cls, model_dir: str,
                       params_filename: Optional[str] = None,
                       transpile: bool = True,
                       scope: Optional[Scope] = None,
                       compile_cache=None, **kwargs) -> "Predictor":
        """Load a `save_inference_model` artifact (saved by either
        package) into a private scope and wrap it; ``transpile=True``
        folds each BatchNorm into its convolution first.  ``device``
        (a keyword) is the card unless ``"cpu"``."""
        from .. import io as _io
        from ..inference_transpiler import InferenceTranspiler
        _refuse_xla_options(compile_cache)
        scope = scope or Scope()
        with scope_guard(scope):
            program, feed_names, fetch_vars = _io.load_inference_model(
                model_dir, None, params_filename=params_filename)
            if transpile:
                InferenceTranspiler().transpile(program, scope=scope)
        return cls(program, feed_names, fetch_vars, scope=scope, **kwargs)

    # ------------------------------------------------------------------
    def run(self, feed: Dict[str, Any], return_numpy: bool = True) -> List:
        return self.run_with_info(feed, return_numpy=return_numpy)[0]

    def run_with_info(self, feed: Dict[str, Any], return_numpy: bool = True):
        """Run one batch; returns (fetches, hit), ``hit`` True when this
        feed signature ran before.  Numpy fetches of a bf16 value come
        back as f32 (numpy has no bf16)."""
        prepared = self._prepare_feed(feed)
        cached = self._cached_rows(feed)
        feed = prepared
        sig = tuple((n, tuple(feed[n].shape), feed[n].dtype)
                    for n in self.feed_names)
        with self._lock:
            hit = sig in self._seen
            if hit:
                self.cache_hits += 1
            else:
                self._seen.add(sig)
                self.cache_misses += 1
        (_PRED_CACHE_HIT if hit else _PRED_CACHE_MISS).inc()
        t0 = time.perf_counter()
        with profiler.record_block("executor.run"), \
                _on_device(self.device), torch.inference_mode():
            outs = self._forward(feed, cached)
            if return_numpy:
                outs = [(o.float() if o.dtype == torch.bfloat16 else o)
                        .cpu().numpy() for o in outs]
        _PRED_RUN_S.observe(time.perf_counter() - t0)
        return outs, hit

    def _forward(self, feed: Dict[str, torch.Tensor],
                 cached: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        with self._lock:
            env: Dict[str, Any] = dict(self._params)
        # int8: a matrix a product reads is dequantized here, per call,
        # f32 multiply stored bf16 (the JAX forward's expand)
        for name, skey in self._quantized.items():
            if name in self._gather_quantized:
                continue
            env[name] = dequantize_int8(env[name], env.pop(skey))
        env.update(feed)
        env.update(cached)
        Interpreter(self.program, self.device, self._generator,
                    self.fetch_names).run_block(self.program.global_block(),
                                                env)
        return [env[n] for n in self.fetch_names]

    def warmup(self, batch_sizes: Sequence[int]):
        """Run the given batch sizes once with zero feeds built from the
        declared feed shapes, so the first real request at each is warm."""
        block = self.program.global_block()
        for b in batch_sizes:
            feed = {}
            for name in self.feed_names:
                var = block.vars[name]
                shape = list(var.shape)
                if shape and (shape[0] is None or shape[0] < 0):
                    shape[0] = int(b)
                if any(d is None or d < 0 for d in shape[1:]):
                    raise ValueError(
                        f"feed var {name!r} has non-batch dynamic dims "
                        f"{var.shape}; warmup cannot synthesize a "
                        "representative shape — warm it with a real "
                        "request through run() instead")
                feed[name] = torch.zeros(
                    [int(d) for d in shape], dtype=to_torch_dtype(var.dtype))
            self.run(feed)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {"fingerprint": self.fingerprint,
                   "precision": self.precision,
                   "device": str(self.device),
                   "quantized_params": len(self._quantized),
                   "cache_hits": self.cache_hits,
                   "cache_misses": self.cache_misses,
                   "shapes_seen": len(self._seen)}
        if self._row_caches:
            out["embedding_cache"] = {n: c.stats()
                                      for n, c in self._row_caches.items()}
        return out

    def _prepare_feed(self, feed: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Each feed as a tensor of its declared dtype on the device."""
        missing = [n for n in self.feed_names if n not in feed]
        if missing:
            raise KeyError(f"missing feeds {missing}; "
                           f"model expects {self.feed_names}")
        block = self.program.global_block()
        out = {}
        for name in self.feed_names:
            value = feed[name]
            if isinstance(value, torch.Tensor):
                t = value
            else:
                arr = np.ascontiguousarray(value)
                if not arr.flags.writeable:     # a wire buffer
                    arr = arr.copy()
                t = torch.from_numpy(arr)
            var = block.vars.get(name)
            want = (to_torch_dtype(var.dtype)
                    if var is not None and var.dtype is not None
                    else t.dtype)
            out[name] = t.to(self.device, want)
        return out


def _on_device(device: torch.device):
    """The device as the current CUDA device of this thread (a kernel
    launches on the thread's current device); nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
