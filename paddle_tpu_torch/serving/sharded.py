"""The sharded predictor: one model serving from every rank of a mesh
(counterpart of ``paddle_tpu/serving/sharded.py``).

`ShardedPredictor` is a `Predictor` whose parameters are placed once by
a `parallel.Partitioner` (replicated by default; a ``param_spec`` rule or
a `LogicalAxisRules` table shards them, the same table a model trained
under) and whose forward runs on the mesh:

- ``numerics="fast"`` (default): each rank takes its data-axis slice of
  the batch (a batch the axis does not divide stays whole), the
  tensor-parallel products run on their shards (`parallel.partitioner`),
  and the outputs are gathered, so every rank holds the whole reply;
- ``numerics="exact"``: the batch and every parameter shard are gathered
  at entry and the forward is the single-device one: replies are bitwise
  the `Predictor`'s, storage stays sharded.

The saved program's ``is_distributed`` tables row-shard over the mesh's
``"ep"`` axis by the rule training places them by
(`parallel.embedding.bind_program_tables`) and are served through the
sharded lookup in both numerics, never gathered; `sharding_info` names
them.  With ``embedding_cache_rows`` a table lives in its hot-row cache
instead, and its looked-up rows follow the batch's slice.

Every rank runs the forward (SPMD).  Behind a server only rank 0 owns
the engine and the socket: `lead` makes rank 0's forward first broadcast
the batch's feed signature and arrays to the followers, and the other
ranks run `follow` (every batch rank 0 runs, until `stop_followers`).
The engine and server paths above the predictor are unchanged.
`ParamSpecRule` is re-exported from the partitioner, as in the JAX
package.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Sequence

import torch

from ..core.lowering import CACHED_ROWS_SUFFIX, Interpreter
from ..core.program import Program
from ..core.scope import Scope
from ..parallel import collectives as coll
from ..parallel.embedding import (RowTables, bind_program_tables,
                                  row_sharded_state)
from ..parallel.logical_axes import PartitionSpec
from ..parallel.partitioner import ParamSpecRule, Partitioner  # noqa: F401
from .predictor import Predictor

#: the followers' stop signal (a header of None)
_STOP = None


class ShardedPredictor(Predictor):
    """A `Predictor` over a mesh (module docstring).  ``mesh`` is a
    `parallel.Mesh`, an axes dict or an ``"ax=N"`` spec, or None for the
    process mesh; ``data_axis`` falls back to the mesh's first axis when
    the mesh lacks it."""

    def __init__(self, program: Program, feed_names: Sequence[str],
                 fetch_vars: Sequence, scope: Optional[Scope] = None,
                 mesh=None, data_axis: str = "dp",
                 param_spec: Optional[ParamSpecRule] = None,
                 precision: str = "f32", numerics: str = "fast",
                 **kwargs):
        from ..parallel import mesh as mesh_lib
        from ..parallel.partitioner import resolve_mesh
        if mesh is None and mesh_lib.get_mesh() is None:
            raise ValueError(
                "ShardedPredictor needs a mesh: pass mesh={'dp': N} (or a "
                "parallel Mesh), or set one via parallel.mesh.set_mesh")
        rmesh = resolve_mesh(mesh)
        if data_axis not in rmesh.shape:
            data_axis = tuple(rmesh.shape)[0]
        self.partitioner = Partitioner(mesh=rmesh, data_axis=data_axis,
                                       param_spec=param_spec,
                                       numerics=numerics)
        self.mesh = self.partitioner.mesh
        self.data_axis = self.partitioner.data_axis
        super().__init__(program, feed_names, fetch_vars, scope=scope,
                         precision=precision, **kwargs)
        part = self.partitioner
        # the program's distributed tables row-shard by the rule training
        # uses (the JAX predictor binds them here too)
        bind_program_tables(part, program)
        #: sharded param -> its spec (the resident value is the shard)
        self._specs: Dict[str, PartitionSpec] = {}
        self._placed: Dict[str, PartitionSpec] = {}
        for name, val in list(self._params.items()):
            spec = part.param_spec(name, tuple(val.shape))
            self._placed[name] = spec
            if part.use_sharding and part.is_sharded(spec):
                if self._quantized:
                    raise ValueError("int8 serving shards no parameter: "
                                     "use precision f32 or bf16 on a "
                                     "sharding mesh")
                self._params[name] = part.shard(val, spec).clone()
                self._specs[name] = spec
        part.warn_rule_misses()
        #: the row-sharded tables (and accumulators) -> their axis
        self._rows = row_sharded_state(program, part, self._specs)
        self._leading = False
        self._mesh_lock = threading.Lock()

    # -- the forward on the mesh ---------------------------------------
    def _forward(self, feed: Dict[str, torch.Tensor],
                 cached: Dict[str, torch.Tensor],
                 env: Optional[Dict[str, Any]] = None):
        part = self.partitioner
        if not part.use_sharding:
            return super()._forward(feed, cached, env)
        with self._mesh_lock:
            if self._leading:
                self._send(feed)
            return self._mesh_forward(feed, cached, env)

    def _mesh_forward(self, feed, cached, env=None):
        part = self.partitioner
        env = {} if env is None else env
        with self._lock:
            env.update(self._params)
        block = self.program.global_block()
        step = tables = None
        rows = self._rows
        if part.numerics == "exact":
            for name, spec in self._specs.items():
                if name not in rows:
                    env[name] = part.gather(env[name], spec)
            feed = {n: (part.gather(part.shard(v, s), s)
                        if part.is_sharded(s) else v)
                    for n, v in feed.items()
                    for s in (part.feed_spec(tuple(v.shape)),)}
        else:
            step = part.step(self.program, self._specs)
            feed = step.slice_feed(feed)
            # a cached site's rows are cut as its ids were
            ids_of = {o + CACHED_ROWS_SUFFIX: i
                      for o, i, _ in self._cached_lookups}
            cached = {k: (part.shard(v, part.feed_spec(tuple(v.shape)))
                          if ids_of.get(k) in step.sliced else v)
                      for k, v in cached.items()}
        if rows:
            tables = RowTables(part, rows, step)
            if step is not None:
                step.tables = tables
        if step is not None:
            step.prepare(env)
        env.update(feed)
        env.update(cached)
        Interpreter(self.program, self.device, self._generator,
                    self.fetch_names, partitioner=step,
                    tables=tables).run_block(block, env)
        outs = [env[n] for n in self.fetch_names]
        if step is not None:
            outs = [step.fetch(block, n, v)
                    for n, v in zip(self.fetch_names, outs)]
        return outs

    def _report_mesh(self) -> Dict[str, Any]:
        summary: Dict[str, int] = {}
        for spec in self._placed.values():
            summary[str(spec)] = summary.get(str(spec), 0) + 1
        return {"partitioner": self.partitioner,
                "sharding_summary": summary}

    # -- leader and followers ------------------------------------------
    def lead(self):
        """Rank 0 behind a server: every forward first sends its batch to
        the followers (`follow`)."""
        if self.mesh.rank != 0:
            raise RuntimeError("only rank 0 leads a sharded predictor")
        self._leading = self.partitioner.use_sharding
        return self

    def _send(self, feed: Dict[str, torch.Tensor]):
        sig = [(n, tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for n, v in feed.items()]
        coll.broadcast_object(sig, src=0)
        group = self.mesh.world_group()
        for n, v in feed.items():
            coll.broadcast(v.contiguous(), group, "world", src=0)

    def follow(self):
        """A follower rank's loop: run every batch rank 0's forward runs,
        until rank 0 calls `stop_followers`."""
        if self.mesh.rank == 0:
            raise RuntimeError("rank 0 leads; the other ranks follow")
        group = self.mesh.world_group()
        while True:
            sig = coll.broadcast_object(None, src=0)
            if sig is _STOP:
                return
            feed = {}
            for n, shape, dtype in sig:
                t = torch.empty(shape, dtype=getattr(torch, dtype),
                                device=self.device)
                feed[n] = coll.broadcast(t, group, "world", src=0)
            with torch.inference_mode():
                self._mesh_forward(feed, {})

    def stop_followers(self):
        """Rank 0: release the followers from `follow`."""
        if self._leading:
            with self._mesh_lock:
                coll.broadcast_object(_STOP, src=0)
                self._leading = False

    # -- identity ------------------------------------------------------
    def sharding_info(self) -> Dict[str, Any]:
        """JSON-safe mesh description (the registry's ``models``
        listing)."""
        info = self.partitioner.describe()
        if self.partitioner.numerics == "fast":
            info.pop("numerics", None)
        info.pop("rule", None)
        info["sharded_params"] = sorted(
            n for n, s in self._placed.items() if tuple(s))
        return info

    def stats(self) -> Dict[str, Any]:
        s = super().stats()
        s["sharding"] = self.sharding_info()
        return s
