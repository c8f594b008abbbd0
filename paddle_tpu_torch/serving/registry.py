"""Named, versioned models behind one endpoint (counterpart of
``paddle_tpu/serving/registry.py``).

Each model is a `Predictor` plus its own `ServingEngine` (for
``infer``), and a `DecodeEngine` (for ``generate``) whenever its
artifact ships ``__generation__.json``:

- ``load(name, dir)`` brings a model up; the first one loaded is the
  default, where a message without a ``"model"`` field goes;
- ``reload(name)`` is a no-op when the directory's manifest fingerprint
  is the loaded one, and otherwise builds fresh engines, flips the
  pointer, and drains the old ones in the background (requests finish on
  the engine that took them);
- ``unload(name)`` drains and drops (the engines' series unmount).

- ``apply_deltas(name)`` patches embedding rows of the live predictor
  from the ``__delta__.json`` chain head in the model's directory (the
  format the JAX package's ``ModelPublisher.publish_deltas`` writes;
  `write_row_delta` writes one link), without a rebuild or a drain.

Every engine is labelled with the model's name, and lifecycle events
count in ``serving_model_events_total{model,event}`` and
``serving_models``; rows patched by deltas in
``embedding_delta_rows_total{model}``.  ``mesh=`` serves a model
through a `ShardedPredictor` (rank 0 of the mesh serves, the other ranks
run its ``follow`` loop) with no decode engine.  Refused with an error
that names the ROADMAP item: ``compile_cache`` (XLA-only).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.place import resolve_device
from ..io import MANIFEST_FILENAME, _atomic_write
from ..models.transformer import read_generation_spec
from ..observability import default_registry
from .decode_engine import DecodeEngine
from .engine import ServingEngine
from .predictor import Predictor


#: the delta chain head in a model directory, which
#: ``fleet_control.ModelPublisher.publish_deltas`` writes (the JAX
#: package's name)
DELTA_FILENAME = "__delta__.json"


class UnknownModelError(KeyError):
    """The model routed to is not loaded (wire code unknown_model)."""


class GenerationUnsupportedError(ValueError):
    """``generate`` routed to a model without a decode engine (wire code
    bad_request)."""


def read_manifest(model_dir: str) -> Optional[Dict[str, Any]]:
    """The ``__manifest__.json`` beside a saved model, or None."""
    try:
        with open(os.path.join(model_dir, MANIFEST_FILENAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class _Entry:
    """One mounted model; reload swaps whole entries, never mutates one."""

    __slots__ = ("name", "predictor", "engine", "model_dir", "version",
                 "fingerprint", "loaded_at", "load_opts", "decode",
                 "delta_seq", "delta_step")

    def __init__(self, name, predictor, engine, model_dir, version,
                 fingerprint, load_opts, decode=None):
        #: the last applied delta link's seq and step; None until the
        #: first apply (a fresh load is the chain's base)
        self.delta_seq = None
        self.delta_step = None
        self.name = name
        self.predictor = predictor
        self.engine = engine
        self.decode = decode
        self.model_dir = model_dir
        self.version = version
        self.fingerprint = fingerprint
        self.loaded_at = time.time()
        self.load_opts = load_opts

    def describe(self) -> Dict[str, Any]:
        d = {"model": self.name,
             "version": self.version,
             "model_dir": self.model_dir,
             "manifest_fingerprint": self.fingerprint,
             "program_fingerprint": self.predictor.fingerprint,
             "loaded_at": self.loaded_at,
             "feed_names": list(self.predictor.feed_names),
             "fetch_names": list(self.predictor.fetch_names),
             "device": str(self.predictor.device)}
        sharding = getattr(self.predictor, "sharding_info", None)
        if sharding is not None:
            d["sharding"] = sharding()
        if self.delta_seq is not None:
            d["delta_seq"] = self.delta_seq
            d["delta_step"] = self.delta_step
        if self.decode is not None:
            pc = self.decode.prefix_cache
            d["decode"] = {"slots": self.decode.slots,
                           "block_len": self.decode.block_len,
                           "num_blocks": self.decode.allocator.num_blocks,
                           "numerics": self.decode.numerics,
                           "kv_dtype": self.decode.kv_dtype,
                           "prefix_cache_blocks":
                               pc.capacity_blocks if pc else 0}
        return d

    def close(self, drain_timeout: float = 30.0, unmount: bool = True):
        self.engine.close(timeout=drain_timeout, unmount=unmount)
        if self.decode is not None:
            self.decode.close(timeout=drain_timeout, unmount=unmount)
        stop = getattr(self.predictor, "stop_followers", None)
        if stop is not None:
            stop()


class ModelRegistry:
    """Named, versioned models behind one serving endpoint; ``device``
    is where ``load`` places a model unless it is given its own (the
    card unless ``"cpu"``)."""

    def __init__(self, device=None):
        self.device = device
        self._lock = threading.RLock()
        # loads swap the process-global scope inside the predictor's
        # from_model_dir: two wire loads must not interleave there
        self._build_lock = threading.Lock()
        self._models: Dict[str, _Entry] = {}
        self._default: Optional[str] = None
        reg = default_registry()
        self._m_events = reg.counter(
            "serving_model_events_total",
            "model registry lifecycle events",
            labelnames=("model", "event"))
        self._m_models = reg.gauge(
            "serving_models", "models currently loaded")
        self._m_delta_rows = reg.counter(
            "embedding_delta_rows_total",
            "embedding rows patched live from published row deltas",
            labelnames=("model",))

    # -- mounting ----------------------------------------------------------
    def load(self, name: str, model_dir: str,
             params_filename: Optional[str] = None, transpile: bool = True,
             mesh=None, engine_opts: Optional[Dict[str, Any]] = None,
             warmup: Optional[List[int]] = None,
             compile_cache: Optional[str] = None,
             precision: str = "f32", decode=None,
             embedding_cache_rows: int = 0, device=None) -> _Entry:
        """Build a predictor and its engines from a saved model dir and
        publish them under ``name``.  ``decode`` is a dict of
        `DecodeEngine` options (``numerics``, ``precision`` and the rest),
        or False for no decode engine; ``embedding_cache_rows`` serves
        lookup-only tables through a hot-row cache of that many rows."""
        name = str(name)
        load_opts = {"params_filename": params_filename,
                     "transpile": transpile,
                     "engine_opts": dict(engine_opts or {}),
                     "warmup": list(warmup or []),
                     "compile_cache": compile_cache,
                     "precision": precision, "decode": decode,
                     "embedding_cache_rows": int(embedding_cache_rows),
                     "mesh": mesh,
                     # resolved first: without CUDA and without "cpu"
                     # this raises before any file is read
                     "device": resolve_device(
                         device if device is not None else self.device)}
        with self._lock:
            if name in self._models:
                raise ValueError(
                    f"model {name!r} is already loaded; use reload() to "
                    "swap it or unload() first")
        entry = self._build(name, model_dir, version=1, load_opts=load_opts)
        with self._lock:
            if name in self._models:          # lost a concurrent load race
                entry.close()
                raise ValueError(f"model {name!r} is already loaded")
            self._models[name] = entry
            if self._default is None:
                self._default = name
            self._m_models.set(len(self._models))
        self._m_events.labels(model=name, event="load").inc()
        return entry

    def add(self, name: str, engine: ServingEngine,
            model_dir: str = "", fingerprint: Optional[str] = None) -> _Entry:
        """Publish an engine built elsewhere (``InferenceServer(engine)``
        wraps through here); it cannot be reloaded."""
        entry = _Entry(str(name), engine.predictor, engine, model_dir,
                       version=1, fingerprint=fingerprint, load_opts=None)
        with self._lock:
            if entry.name in self._models:
                raise ValueError(f"model {entry.name!r} is already loaded")
            self._models[entry.name] = entry
            if self._default is None:
                self._default = entry.name
            self._m_models.set(len(self._models))
        self._m_events.labels(model=entry.name, event="load").inc()
        return entry

    def _build(self, name, model_dir, version, load_opts) -> _Entry:
        precision = load_opts["precision"]
        device = load_opts["device"]
        mesh = load_opts.get("mesh")
        kw = {}
        cls = Predictor
        if mesh is not None:
            from .sharded import ShardedPredictor
            cls, kw = ShardedPredictor, {"mesh": mesh}
        with self._build_lock:
            predictor = cls.from_model_dir(
                model_dir, params_filename=load_opts["params_filename"],
                transpile=load_opts["transpile"],
                compile_cache=load_opts["compile_cache"],
                precision=precision,
                embedding_cache_rows=load_opts["embedding_cache_rows"],
                device=device, **kw)
        if mesh is not None and predictor.mesh.size > 1:
            # rank 0 serves; the other ranks follow its batches
            predictor.lead()
        engine = ServingEngine(predictor, model=name,
                               **load_opts["engine_opts"])
        try:
            if load_opts["warmup"]:
                try:
                    predictor.warmup(load_opts["warmup"])
                except ValueError:
                    pass   # non-batch dynamic dims: the first request warms
            decode_engine = None
            dopts = load_opts["decode"]
            if mesh is not None:
                dopts = False   # the decode engine runs on one device
            if dopts is not False and read_generation_spec(model_dir):
                kw = dict(dopts) if isinstance(dopts, dict) else {}
                kw.setdefault("precision", precision)
                decode_engine = DecodeEngine.from_model_dir(
                    model_dir, params_filename=load_opts["params_filename"],
                    device=device, model=name, **kw)
        except BaseException:
            # a bad decode configuration must not leak the running
            # classifier engine's workers and series
            engine.close()
            raise
        manifest = read_manifest(model_dir)
        return _Entry(name, predictor, engine, model_dir, version,
                      manifest.get("fingerprint") if manifest else None,
                      load_opts, decode=decode_engine)

    # -- lifecycle ---------------------------------------------------------
    def unload(self, name: str, drain_timeout: float = 30.0):
        with self._lock:
            entry = self._models.pop(str(name), None)
            if entry is None:
                raise UnknownModelError(f"model {name!r} is not loaded")
            if self._default == entry.name:
                # the sole survivor becomes the default, else none
                rest = list(self._models)
                self._default = rest[0] if len(rest) == 1 else None
            self._m_models.set(len(self._models))
        entry.close(drain_timeout)
        self._m_events.labels(model=entry.name, event="unload").inc()
        return entry

    def reload(self, name: str, drain_timeout: float = 30.0) -> bool:
        """Hot swap ``name`` from its model dir; False (nothing done)
        when the manifest fingerprint on disk is the loaded one."""
        with self._lock:
            old = self._models.get(str(name))
            if old is None:
                raise UnknownModelError(f"model {name!r} is not loaded")
            if old.load_opts is None:
                raise ValueError(
                    f"model {name!r} was add()ed from a live engine, not "
                    "a model dir; it cannot be reloaded")
        manifest = read_manifest(old.model_dir)
        if (manifest is not None and old.fingerprint is not None
                and manifest.get("fingerprint") == old.fingerprint):
            self._m_events.labels(model=old.name, event="reload_noop").inc()
            return False
        fresh = self._build(old.name, old.model_dir, old.version + 1,
                            old.load_opts)
        with self._lock:
            if self._models.get(old.name) is not old:
                fresh.close()
                raise RuntimeError(
                    f"model {name!r} changed during reload; not swapping")
            self._models[old.name] = fresh
        threading.Thread(target=old.close, args=(drain_timeout,),
                         daemon=True,
                         name=f"drain-{old.name}-v{old.version}").start()
        self._m_events.labels(model=old.name, event="reload").inc()
        return True

    def apply_deltas(self, name: str) -> Dict[str, Any]:
        """Apply the ``__delta__.json`` chain head of ``name``'s model dir
        to its live predictor (device tables, hot-row caches), with no
        rebuild and no drain.

        The lineage is checked before any row moves: the first link must
        name this entry's manifest fingerprint as its base, and each later
        link's ``prev_seq`` must be the seq last applied.  A mismatch (a
        missed link, a restarted chain, a replica loaded since) returns
        ``stale: True``, the caller's cue to reload.  Returns ``{applied,
        stale, seq, step, rows}``; ``applied`` False with ``stale`` False
        means nothing new (re-polling the same head is a no-op)."""
        with self._lock:
            entry = self._models.get(str(name))
            if entry is None:
                raise UnknownModelError(f"model {name!r} is not loaded")
        try:
            with open(os.path.join(entry.model_dir, DELTA_FILENAME)) as f:
                record = json.load(f)
        except (OSError, ValueError):
            return {"applied": False, "stale": False, "seq": None,
                    "step": None, "rows": 0}
        seq = record.get("seq")
        if seq is None or seq == entry.delta_seq:
            return {"applied": False, "stale": False,
                    "seq": entry.delta_seq, "step": entry.delta_step,
                    "rows": 0}
        if entry.delta_seq is None:
            ok = (record.get("prev_seq") is None
                  and record.get("base_fingerprint") == entry.fingerprint)
        else:
            ok = record.get("prev_seq") == entry.delta_seq
        if not ok:
            return {"applied": False, "stale": True, "seq": seq,
                    "step": record.get("step"), "rows": 0}
        updates: Dict[str, Any] = {}
        for tname, info in (record.get("tables") or {}).items():
            with np.load(os.path.join(entry.model_dir, info["file"])) as d:
                updates[tname] = (d["rows"].copy(), d["values"].copy())
        rows = entry.predictor.apply_row_deltas(updates)
        entry.delta_seq = int(seq)
        entry.delta_step = record.get("step")
        if rows:
            self._m_delta_rows.labels(model=entry.name).inc(rows)
        self._m_events.labels(model=entry.name, event="delta_apply").inc()
        return {"applied": True, "stale": False, "seq": int(seq),
                "step": record.get("step"), "rows": int(rows)}

    def close(self, drain_timeout: float = 30.0, unmount: bool = True):
        """Unload everything; ``unmount=False`` keeps the engines' series
        visible for a final snapshot."""
        with self._lock:
            entries = list(self._models.values())
            self._models.clear()
            self._default = None
            self._m_models.set(0)
        for e in entries:
            e.close(drain_timeout, unmount)

    # -- routing -----------------------------------------------------------
    @property
    def default_model(self) -> Optional[str]:
        return self._default

    @default_model.setter
    def default_model(self, name: Optional[str]):
        with self._lock:
            if name is not None and str(name) not in self._models:
                raise UnknownModelError(f"model {name!r} is not loaded")
            self._default = None if name is None else str(name)

    def get(self, name: Optional[str] = None) -> _Entry:
        """The live entry of a wire model name; None routes to the
        default model."""
        with self._lock:
            if name is None:
                if self._default is not None:
                    return self._models[self._default]
                if len(self._models) == 1:
                    return next(iter(self._models.values()))
                raise UnknownModelError(
                    "no model name given and no default model is set "
                    f"(loaded: {sorted(self._models)})")
            entry = self._models.get(str(name))
            if entry is None:
                raise UnknownModelError(
                    f"model {name!r} is not loaded "
                    f"(loaded: {sorted(self._models)})")
            return entry

    def infer(self, name: Optional[str], feed: Dict[str, Any],
              timeout: Optional[float] = None):
        return self.infer_with_entry(name, feed, timeout=timeout)[0]

    def infer_with_entry(self, name: Optional[str], feed: Dict[str, Any],
                         timeout: Optional[float] = None):
        """Route one request; returns (fetches, the entry that served
        it).  A reload may close the engine between resolving and
        submitting: one re-resolve retries on the fresh engine."""
        entry = self.get(name)
        try:
            return entry.engine.infer(feed, timeout=timeout), entry
        except RuntimeError as e:
            # only the closed-engine race retries: any other failure
            # would run twice and hide the first error
            if "ServingEngine is closed" not in str(e):
                raise
            current = self.get(name)
            if current is entry:
                raise
            return current.engine.infer(feed, timeout=timeout), current

    def generate_entry(self, name: Optional[str]) -> _Entry:
        """The target of a ``generate`` request."""
        entry = self.get(name)
        if entry.decode is None:
            raise GenerationUnsupportedError(
                f"model {entry.name!r} has no decode engine: its "
                "artifact ships no __generation__.json (see "
                "models.transformer.save_generation_model)")
        return entry

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def describe(self) -> Dict[str, Any]:
        """The ``models`` wire verb's listing."""
        with self._lock:
            entries = list(self._models.values())
            default = self._default
        return {"default": default,
                "models": {e.name: e.describe() for e in entries}}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            entries = list(self._models.values())
        return {e.name: e.engine.stats() for e in entries}

    def stats_for(self, entry: _Entry) -> Dict[str, Any]:
        """One entry's stats, with its decode engine's section."""
        out = entry.engine.stats()
        if entry.decode is not None:
            out["decode"] = entry.decode.stats()
        return out


def write_row_delta(model_dir: str, tables: Dict[str, Tuple[Any, Any]],
                    step: int) -> Dict[str, Any]:
    """Publish one link of a row-delta chain into ``model_dir`` in the
    format of the JAX package's ``ModelPublisher.publish_deltas``: the
    payloads ``deltas/step_<step>/<table>.npz`` (``rows`` int64 and
    ``values``) first, then ``__delta__.json`` atomically, naming the
    chain's base (the manifest fingerprint, for the first link) and the
    previous link's seq.  ``tables`` maps a table name to ``(rows,
    values)``.  The port has no checkpoint publisher yet; tests and the
    smoke run write their deltas with this.  Returns the record."""
    head: Dict[str, Any] = {}
    try:
        with open(os.path.join(model_dir, DELTA_FILENAME)) as f:
            head = json.load(f)
    except (OSError, ValueError):
        pass
    manifest = read_manifest(model_dir) or {}
    ddir = os.path.join("deltas", f"step_{int(step)}")
    os.makedirs(os.path.join(model_dir, ddir), exist_ok=True)
    out_tables = {}
    for name, (rows, values) in tables.items():
        fname = name.replace("/", "_") + ".npz"
        rows = np.asarray(rows, np.int64).reshape(-1)
        np.savez(os.path.join(model_dir, ddir, fname), rows=rows,
                 values=np.asarray(values))
        out_tables[name] = {"rows": int(rows.size),
                            "file": os.path.join(ddir, fname)}
    record = {"seq": int(head.get("seq", 0)) + 1, "step": int(step),
              "base_step": head.get("step"),
              "base_fingerprint": head.get("base_fingerprint",
                                           manifest.get("fingerprint")),
              "prev_seq": head.get("seq"), "tables": out_tables}
    with _atomic_write(os.path.join(model_dir, DELTA_FILENAME)) as f:
        json.dump(record, f, indent=1)
    return record
