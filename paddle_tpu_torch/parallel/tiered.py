"""Tiered embedding tables: device-resident hot rows over a host-RAM
store (counterpart of ``paddle_tpu/parallel/tiered.py``).

``train_loop(tiered={table: C})`` trains an ``is_sparse`` table whose
``[V, D]`` footprint need not fit the device.  The scope variable, and
every same-shape optimizer accumulator under the table's name
(``<table>.moment1_0``, a velocity), becomes a ``[C, D]`` device pool;
the whole table stays in host RAM.  Before each step the batch's ids are
made resident (LRU eviction of rows the batch does not need) and
remapped on the host to pool slots, so the step (gather, SelectedRows
gradient, sparse update) runs on the pool and never holds ``[V, D]`` on
the device.  A fused window (``steps_per_launch=K``) stages the union of
its K batches' ids once.

Numerics: a step reads and writes only the rows of the ids it was fed,
all resident, so training on the pool is bitwise training on the whole
table: the remap permutes the merge's segment order (by slot instead of
id), and each duplicate group still sums in feed order.

Overlap, as ``double_buffer`` stages: the planning for step i+1 runs on
the host while step i runs.  An eviction gathers its rows on the compute
stream (after step i) and copies them to pinned host memory
``non_blocking`` on a side stream, ordered by an event; the host store
takes them one step later (`_drain`).  An upload copies its rows to the
card on the side stream, and the compute stream waits for that copy's
event before writing them into the pool.

Refused, as in the JAX package: distributed (row-sharded) tables,
``padding_idx`` lookups (the padding id is an id, not a slot), tables
read by anything but ``is_sparse`` lookups and the sparse optimizers,
and ids vars read by any other op (they would see slot numbers).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


class _TableTier:
    """One table's residency: the host store, the slot maps, and the
    eviction copies in flight.  ``names`` is the param and its same-shape
    accumulators: they share slots, so a row's param and moments move
    together."""

    __slots__ = ("name", "names", "host", "vocab", "cap", "slot_ids",
                 "id_slot", "last_used", "pending")

    def __init__(self, name: str, names: List[str],
                 host: Dict[str, np.ndarray], cap: int):
        self.name = name
        self.names = names
        self.host = host                        # name -> [V, D] array
        self.vocab = int(host[name].shape[0])
        self.cap = int(cap)
        self.slot_ids = np.full((cap,), -1, np.int64)    # slot -> id
        self.id_slot = np.full((self.vocab,), -1, np.int64)
        self.last_used = np.zeros((cap,), np.int64)
        #: [(ids, {name: host rows}, copy-done event or None, device
        #: gathers kept alive until the copy is done)]
        self.pending: List[Any] = []


class TieredTables:
    """The residency manager of one ``train_loop(tiered=...)``: ``specs``
    maps table names to their device row budget C (module docstring)."""

    def __init__(self, program, scope, specs: Dict[str, int],
                 partitioner=None, device=None):
        self.scope = scope
        self.device = torch.device(device or "cpu")
        self.steps = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.tables: Dict[str, _TableTier] = {}
        self.ids_of: Dict[str, str] = {}        # ids feed name -> table
        self._stream = None
        sharded = set(getattr(partitioner, "table_specs", None) or {})
        blocks = list(program.blocks)
        for name, cap in specs.items():
            if name in sharded:
                raise ValueError(
                    f"tiered table {name!r} is distributed/sharded; tier "
                    "a replicated table or drop it from table_specs")
            ids_name = None
            # the sparse optimizers read the table by its SelectedRows
            # rows, which are the remapped slots: they follow the pool
            benign = ("backward", "sgd", "momentum", "adam")
            for block in blocks:
                for op in block.ops:
                    ins = op.desc.inputs
                    if (op.type == "lookup_table"
                            and ins.get("W", [None])[0] == name):
                        if not op.desc.attrs.get("is_sparse"):
                            raise ValueError(
                                f"tiered table {name!r} needs "
                                "is_sparse=True lookups; a dense [V, D] "
                                "gradient cannot flow through a [C, D] "
                                "pool")
                        pad = op.desc.attrs.get("padding_idx", -1)
                        if pad is not None and pad >= 0:
                            raise ValueError(
                                f"tiered table {name!r} has padding_idx="
                                f"{pad}; padding ids do not survive the "
                                "slot remap")
                        ids_name = ins["Ids"][0]
                    elif (op.type not in benign
                          and any(name in v for v in ins.values())):
                        raise ValueError(
                            f"tiered table {name!r} is read by "
                            f"{op.type!r}; only is_sparse lookup_table "
                            "consumers keep the slot remap sound")
            if ids_name is None:
                raise ValueError(
                    f"tiered table {name!r} has no lookup_table consumer")
            for block in blocks:
                for op in block.ops:
                    if op.type in ("lookup_table", "backward", "feed"):
                        continue
                    for v in op.desc.inputs.values():
                        if ids_name in v:
                            raise ValueError(
                                f"ids var {ids_name!r} of tiered table "
                                f"{name!r} feeds {op.type!r}; the slot "
                                "remap would corrupt it")
            val = scope.get(name)
            if val is None or np.ndim(val) != 2:
                raise ValueError(f"tiered table {name!r} not a [V, D] "
                                 "scope variable")
            vocab = int(np.shape(val)[0])
            cap = int(cap)
            if not 0 < cap <= vocab:
                raise ValueError(
                    f"tiered capacity {cap} for {name!r} must be in "
                    f"(0, {vocab}]")
            group = [name] + sorted(
                n for n in scope.local_var_names()
                if n.startswith(name + ".") and scope.get(n) is not None
                and tuple(np.shape(scope.get(n))) == tuple(np.shape(val)))
            host = {n: _numpy(scope.get(n)) for n in group}
            self.tables[name] = _TableTier(name, group, host, cap)
            self.ids_of[ids_name] = name
            # the scope holds the [C, D] pools from the first step on
            for n in group:
                scope.set(n, torch.zeros(
                    (cap,) + tuple(host[n].shape[1:]),
                    dtype=torch.from_numpy(host[n][:0]).dtype,
                    device=self.device))

    # -- device copies ---------------------------------------------------
    def _side(self):
        """The side stream of the card's copies (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _drain(self, tier: _TableTier):
        """Write the evictions of an earlier step into the host store
        (their copies finished under the steps since)."""
        for ids, rows, done, _ in tier.pending:
            if done is not None:
                done.synchronize()
            for n, host_rows in rows.items():
                tier.host[n][ids] = host_rows.numpy()
        tier.pending = []

    def _evict(self, tier: _TableTier, ids: np.ndarray, slots: np.ndarray):
        """Gather the rows at ``slots`` of every pool (ordered after the
        step in flight) and start their copy to the host."""
        dslots = torch.as_tensor(slots, device=self.device)
        gathers = {n: self.scope.get_local(n).index_select(0, dslots)
                   for n in tier.names}
        side = self._side()
        if side is None:
            tier.pending.append((ids, gathers, None, None))
            return
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            rows = {}
            for n, g in gathers.items():
                rows[n] = torch.empty(g.shape, dtype=g.dtype,
                                      pin_memory=True)
                rows[n].copy_(g, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        tier.pending.append((ids, rows, done, gathers))

    def _upload(self, tier: _TableTier, need: np.ndarray,
                slots: np.ndarray):
        """Write the host rows of ``need`` into the pools at ``slots``."""
        dslots = torch.as_tensor(slots, device=self.device)
        side = self._side()
        for n in tier.names:
            rows = torch.from_numpy(np.ascontiguousarray(tier.host[n][need]))
            if side is None:
                self.scope.get_local(n).index_copy_(0, dslots, rows)
                continue
            rows = rows.pin_memory()
            with torch.cuda.stream(side):
                dev_rows = rows.to(self.device, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(side)
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ready)
            dev_rows.record_stream(cur)
            self.scope.get_local(n).index_copy_(0, dslots, dev_rows)

    # -- the per-step hooks ------------------------------------------------
    def step(self, raw: Dict[str, Any]) -> Dict[str, Any]:
        """Plan one batch's residency, apply it to the pools, and return
        the feed with its ids remapped to slots."""
        return self._step_ids(raw, {f: _numpy(raw[f]) for f in self.ids_of
                                    if f in raw})

    def step_window(self, raws: List[Dict[str, Any]]
                    ) -> List[Dict[str, Any]]:
        """A fused window: residency for the union of its batches' ids
        (they run as one launch), each batch remapped by that plan."""
        union = {}
        for f in self.ids_of:
            parts = [_numpy(r[f]) for r in raws if f in r]
            if parts:
                union[f] = np.concatenate([p.reshape(-1) for p in parts])
        self._step_ids(dict(raws[0]), union, remap=False)
        out = []
        for r in raws:
            r2 = dict(r)
            for f, tname in self.ids_of.items():
                if f in r2:
                    r2[f] = self._remap(self.tables[tname], _numpy(r2[f]))
            out.append(r2)
        return out

    def _remap(self, tier: _TableTier, ids: np.ndarray) -> np.ndarray:
        wrapped = np.where(ids < 0, ids + tier.vocab, ids)
        slots = tier.id_slot[wrapped]
        if (slots < 0).any():
            raise AssertionError(
                f"tiered table {tier.name!r}: id missing from pool "
                "after planning (internal residency bug)")
        return slots.astype(ids.dtype)

    def _step_ids(self, raw, ids_by_feed, remap=True):
        self.steps += 1
        out = dict(raw)
        for feed_name, ids in ids_by_feed.items():
            tier = self.tables[self.ids_of[feed_name]]
            self._drain(tier)
            flat = ids.reshape(-1)
            flat = np.where(flat < 0, flat + tier.vocab, flat)
            if ((flat < 0) | (flat >= tier.vocab)).any():
                raise ValueError(
                    f"tiered table {tier.name!r}: ids outside "
                    f"[0, {tier.vocab})")
            uniq = np.unique(flat)
            resident = tier.id_slot[uniq] >= 0
            need = uniq[~resident]
            self.hits += int(resident.sum())
            self.misses += int(need.size)
            if need.size:
                self._make_resident(tier, need, uniq)
            tier.last_used[tier.id_slot[uniq]] = self.steps
            if remap and feed_name in out:
                out[feed_name] = self._remap(tier, _numpy(out[feed_name]))
        return out

    def _make_resident(self, tier: _TableTier, need: np.ndarray,
                       batch_uniq: np.ndarray):
        free = np.flatnonzero(tier.slot_ids < 0)
        if free.size < need.size:
            n_evict = need.size - free.size
            occupied = np.flatnonzero(tier.slot_ids >= 0)
            # never evict a row this batch also needs
            in_batch = np.isin(tier.slot_ids[occupied], batch_uniq)
            cands = occupied[~in_batch]
            if cands.size < n_evict:
                raise ValueError(
                    f"tiered table {tier.name!r}: batch needs "
                    f"{need.size} new rows but capacity {tier.cap} has "
                    f"only {free.size} free + {cands.size} evictable "
                    "slots; raise the tier budget or shrink the batch")
            # LRU among the evictable slots
            order = np.argpartition(tier.last_used[cands],
                                    n_evict - 1)[:n_evict]
            victims = cands[order]
            evict_ids = tier.slot_ids[victims]
            self._evict(tier, evict_ids, victims)
            tier.id_slot[evict_ids] = -1
            tier.slot_ids[victims] = -1
            self.evictions += int(n_evict)
            free = np.concatenate([free, victims])
        slots = free[:need.size]
        tier.slot_ids[slots] = need
        tier.id_slot[need] = slots
        self._upload(tier, need, slots)

    # -- lifecycle -------------------------------------------------------
    def export_full(self) -> Dict[str, np.ndarray]:
        """The whole ``[V, D]`` array of every tiered name (the checkpoint
        form): the host store with the resident rows written over it."""
        out = {}
        for tier in self.tables.values():
            self._drain(tier)
            live_slots = np.flatnonzero(tier.slot_ids >= 0)
            ids = tier.slot_ids[live_slots]
            for n in tier.names:
                full = tier.host[n].copy()
                if live_slots.size:
                    pool = self.scope.get_local(n)
                    full[ids] = pool.index_select(0, torch.as_tensor(
                        live_slots, device=pool.device)).cpu().numpy()
                out[n] = full
        return out

    def finalize(self):
        """End of the loop: fold the resident rows back and give the scope
        its whole ``[V, D]`` tables again (checkpoints, saves and later
        runs see the real shapes)."""
        for n, arr in self.export_full().items():
            self.scope.set(n, torch.from_numpy(arr).to(self.device))

    def stats(self) -> Dict[str, Any]:
        total = self.hits + self.misses
        return {"steps": self.steps, "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "tiered_hit_rate": (self.hits / total) if total else None,
                "tiered_pool_rows": sum(t.cap for t in
                                        self.tables.values())}


def _numpy(value) -> np.ndarray:
    """A feed or scope value as a host numpy array (a copy of a tensor)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy().copy()
    return np.array(value)
