"""Device cache of an embedding table's hottest rows, with the full table
in host memory behind it (counterpart of
``paddle_tpu/serving/hot_rows.py``).

For a recommender whose table does not fit the card but whose ids are
skewed (Zipf): a ``[C, D]`` tensor on the device holds the hot head, and
each lookup gathers the hits there and the misses from the host table
(pinned when the cache is on CUDA), one host gather and one copy to the
device for the misses of a batch.  The `Predictor` takes a lookup-only
table out of its device parameters and feeds the rows this cache returns
under ``<Out>@CACHED_ROWS@`` (core/lowering.py), so replies are bitwise
the uncached predictor's: the cache holds the table's bytes.

Promotion is by frequency, as in the JAX cache: every ``refresh_every``
lookups the top ``budget_rows`` ids by aged count own the slots (a
resident row wins a tie and keeps its slot, so a steady hot set uploads
nothing), then every count halves.  Only ids with a nonzero count and
the residents are ranked.  Under ``precision="int8"`` the host table and
the cache hold int8 rows, which the lookup_table rule dequantizes.

The bookkeeping (counters, slot maps) and the snapshot of the cache
tensor are taken under one lock; the host gather, the copy of the miss
rows and the device gathers run outside it.  A refresh or a delta
replaces the cache tensor instead of writing into it, so a snapshot stays
consistent with the slots read beside it.

Metrics: ``embedding_cache_{hits,misses,promotions}_total{table=}`` on
the process registry.
"""
from __future__ import annotations

import threading
from typing import Any, Dict

import numpy as np
import torch

from ..core.place import resolve_device
from ..observability import default_registry as _obs_registry

_CACHE_HITS = _obs_registry().counter(
    "embedding_cache_hits_total",
    "hot-row cache lookups served from the device-resident cache",
    labelnames=("table",))
_CACHE_MISSES = _obs_registry().counter(
    "embedding_cache_misses_total",
    "hot-row cache lookups that paid a host gather",
    labelnames=("table",))
_CACHE_PROMOTIONS = _obs_registry().counter(
    "embedding_cache_promotions_total",
    "rows promoted into the device-resident cache",
    labelnames=("table",))


class HotRowCache:
    """A ``budget_rows``-row device cache over a host ``[V, D]`` table;
    a promotion sweep every ``refresh_every`` lookups.  ``device`` is the
    card unless ``"cpu"``."""

    def __init__(self, table, budget_rows: int, name: str = "table",
                 refresh_every: int = 512, device=None):
        host = (table.detach().to("cpu", copy=True)
                if isinstance(table, torch.Tensor)
                else torch.from_numpy(np.array(table)))
        if host.dim() != 2:
            raise ValueError(f"HotRowCache wants a [V, D] table, got "
                             f"shape {tuple(host.shape)}")
        self.device = resolve_device(device)
        host = host.contiguous()
        self._host = host.pin_memory() if self.device.type == "cuda" \
            else host
        V, D = host.shape
        self.name = str(name)
        self.budget_rows = C = int(max(1, min(int(budget_rows), V)))
        self.refresh_every = max(1, int(refresh_every))
        self._cache = torch.zeros((C, D), dtype=host.dtype,
                                  device=self.device)
        self._slot_of = np.full((V,), -1, np.int64)    # row id -> slot
        self._row_in_slot = np.full((C,), -1, np.int64)
        self._counts = np.zeros((V,), np.int64)        # aged frequencies
        self._nz: set = set()       # ids with a nonzero aged count
        self._since_refresh = 0
        self.hits = 0
        self.misses = 0
        self.promotions = 0
        self.delta_rows = 0
        # lookups come from the serving engine's workers at once: the
        # slot maps, the counters and the cache tensor are one unit
        self._lock = threading.Lock()
        self._m_hits = _CACHE_HITS.labels(table=self.name)
        self._m_misses = _CACHE_MISSES.labels(table=self.name)
        self._m_promotions = _CACHE_PROMOTIONS.labels(table=self.name)

    def _to_device(self, rows: torch.Tensor) -> torch.Tensor:
        return rows.to(self.device, non_blocking=rows.is_pinned())

    def _gather_host(self, ids: np.ndarray) -> torch.Tensor:
        """Host rows ``ids`` on the device: gathered into pinned memory
        when the cache is on CUDA, so the copy runs asynchronously."""
        idx = torch.from_numpy(np.ascontiguousarray(ids, np.int64))
        if self.device.type != "cuda":
            return self._host.index_select(0, idx)
        buf = torch.empty((idx.numel(), self._host.shape[1]),
                          dtype=self._host.dtype, pin_memory=True)
        torch.index_select(self._host, 0, idx, out=buf)
        return self._to_device(buf)

    # -- lookup --------------------------------------------------------
    def lookup(self, ids) -> torch.Tensor:
        """Rows for ``ids`` (any shape, host values) as ``[*ids.shape,
        D]`` on the device, bitwise the host table's bytes whether a row
        came from the cache or the host.  Out-of-range ids follow the
        lookup_table rule: ``[-V, 0)`` wraps, any other id outside
        ``[0, V)`` gives the fill row (NaN, or the int8 minimum) and is
        not counted."""
        V, D = self._host.shape
        arr = np.asarray(ids)
        raw = arr.astype(np.int64).reshape(-1)
        raw = np.where((raw < 0) & (raw >= -V), raw + V, raw)
        oob = (raw < 0) | (raw >= V)
        flat = np.where(oob, 0, raw)
        valid = ~oob
        with self._lock:
            np.add.at(self._counts, flat[valid], 1)
            self._nz.update(np.unique(flat[valid]).tolist())
            slots = self._slot_of[flat]       # advanced indexing: a copy
            cache = self._cache
            hit = (slots >= 0) & valid
            n_hit = int(hit.sum())
            n_miss = int((valid & ~hit).sum())
            self.hits += n_hit
            self.misses += n_miss
            self._since_refresh += 1
            if self._since_refresh >= self.refresh_every:
                self._refresh_locked()
        if n_hit:
            self._m_hits.inc(n_hit)
        if n_miss:
            self._m_misses.inc(n_miss)
        out = cache.index_select(0, self._to_device(
            torch.from_numpy(np.where(hit, slots, 0))))
        if n_miss:
            miss_pos = np.nonzero(valid & ~hit)[0]
            out.index_copy_(0, self._to_device(torch.from_numpy(miss_pos)),
                            self._gather_host(flat[miss_pos]))
        if oob.any():
            fill = (torch.iinfo(out.dtype).min if not out.is_floating_point()
                    else float("nan"))
            out.index_fill_(0, self._to_device(
                torch.from_numpy(np.nonzero(oob)[0])), fill)
        return out.reshape(arr.shape + (D,))

    # -- promotion -----------------------------------------------------
    def refresh(self):
        """Promotion sweep: the top ``budget_rows`` ids by aged count own
        the cache.  Resident rows keep their slots (no upload); only the
        newly promoted rows are copied."""
        with self._lock:
            self._refresh_locked()

    def _refresh_locked(self):
        self._since_refresh = 0
        C = self.budget_rows
        counts = self._counts
        resident = self._row_in_slot[self._row_in_slot >= 0]
        cand = np.union1d(np.fromiter(self._nz, np.int64, len(self._nz)),
                          resident)
        if cand.size == 0:
            return
        # residents win ties: evicting a count-k row for another count-k
        # row buys nothing and costs an upload
        eff = counts[cand] * 2
        eff[np.isin(cand, resident, assume_unique=True)] += 1
        keep = (np.argpartition(-eff, C - 1)[:C] if C < cand.size
                else np.arange(cand.size))
        keep = keep[eff[keep] > 0]
        hot = cand[keep[np.argsort(-eff[keep], kind="stable")]]
        hot_set = set(hot.tolist())
        free = [s for s, r in enumerate(self._row_in_slot)
                if r < 0 or r not in hot_set]
        promote = [r for r in hot.tolist() if self._slot_of[r] < 0]
        promote = promote[:len(free)]
        if promote:
            slots = np.asarray(free[:len(promote)], np.int64)
            for s, r in zip(slots, promote):
                old = self._row_in_slot[s]
                if old >= 0:
                    self._slot_of[old] = -1
                self._row_in_slot[s] = r
                self._slot_of[r] = s
            self._cache = self._cache.index_copy(
                0, self._to_device(torch.from_numpy(slots)),
                self._gather_host(np.asarray(promote, np.int64)))
            self.promotions += len(promote)
            self._m_promotions.inc(len(promote))
        # age: halve the nonzero counts; an id whose count reaches 0
        # leaves the candidates
        if self._nz:
            nz = np.fromiter(self._nz, np.int64, len(self._nz))
            halved = counts[nz] // 2
            counts[nz] = halved
            self._nz.difference_update(nz[halved == 0].tolist())

    # -- streaming deltas ----------------------------------------------
    def apply_delta(self, rows, values) -> int:
        """Apply a published row delta: the host table takes the new
        bytes, and the resident ones among those rows take them in their
        slots too, so a stale row never serves again.  Returns the rows
        applied."""
        rows = np.asarray(rows).reshape(-1).astype(np.int64)
        V, D = self._host.shape
        values = torch.as_tensor(np.asarray(values)).to(self._host.dtype)
        if tuple(values.shape) != (rows.size, D):
            raise ValueError(f"delta values shape {tuple(values.shape)} "
                             f"!= ({rows.size}, {D})")
        if rows.size and ((rows < 0) | (rows >= V)).any():
            raise ValueError(f"delta rows outside [0, {V})")
        with self._lock:
            self._host[torch.from_numpy(rows)] = values
            slots = self._slot_of[rows]
            res = slots >= 0
            if res.any():
                self._cache = self._cache.index_copy(
                    0, self._to_device(torch.from_numpy(slots[res])),
                    self._gather_host(rows[res]))
            self.delta_rows += int(rows.size)
        return int(rows.size)

    # -- introspection -------------------------------------------------
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return (self.hits / total) if total else 0.0

    def device_bytes(self) -> int:
        return self._cache.numel() * self._cache.element_size()

    def host_bytes(self) -> int:
        return self._host.numel() * self._host.element_size()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"budget_rows": self.budget_rows,
                    "table_rows": int(self._host.shape[0]),
                    "hits": self.hits, "misses": self.misses,
                    "promotions": self.promotions,
                    "hit_rate": round(self.hit_rate(), 4),
                    "device_bytes": self.device_bytes(),
                    "host_bytes": self.host_bytes()}
