"""Continuous-batching autoregressive decode engine (counterpart of
``paddle_tpu/serving/decode_engine.py``).

Orca-style iteration-level scheduling over a vLLM-style paged KV cache:

- A fixed pool of S *slots* advances by ONE decode forward per
  iteration: every active slot emits one token per step.
- New requests join the running batch at any iteration boundary as
  others finish (continuous batching, no drain barrier).
- A cold request's prompt is written into its slot by a *prefill*
  before the slot joins the decode batch.  The prefill runs at the
  prompt's own length: the JAX engine pads prompts to power-of-two
  buckets so that XLA compiles a few executables, and eager PyTorch
  needs no buckets.
- Per-layer K/V live in paged block pools ``[num_blocks, block_len,
  heads, head_dim]`` on the device, with the host-side `BlockAllocator`
  handing each slot a page-table row (ops/kv_cache_ops.py).  The pools
  are written in place; their dtype follows the model's precision (bf16
  halves the KV bytes).
- The prefix cache (``prefix_cache_blocks > 0``): a radix tree of full
  prompt blocks (`PrefixCache`).  A released request's prefill-written
  full prompt blocks move into the tree instead of the free list; a new
  request whose prompt starts with a cached path adopts those blocks by
  reference (`BlockAllocator.incref`).  A hot request runs no prefill:
  its uncached prompt tail is replayed through the decode step, one
  token per step, at its own positions, and it emits nothing until the
  last prompt token's logits give the first generated token.  When the
  whole prompt is cached, its last block is copied on write (a ``copy_``
  of each layer's K and V block, ordered on the stream before the
  replay writes it), since a shared block is never written.  The tree
  evicts least-recently-used leaves nobody references, and yields its
  blocks to live traffic under pool pressure (`PrefixCache.evict_for`).

Two models behind one small interface (``new_kv_pools``, ``prefill``,
``decode``, ``spec``, ``device``), and the engine around them is the same:

- ``DecodeEngine(model)`` with a `TransformerLM` (what
  ``DecodeEngine.from_model_dir``, the registry and the server build): an
  ``nn.Module`` that computes each step as tensor functions;
- ``DecodeEngine(scope, spec, ...)``, the JAX engine's constructor: the
  generation Programs of ``models.transformer.build_generation_programs``
  over the parameters in ``scope``, each run by a `_GenPredictor` on the
  port's interpreter (`GenerationPrograms`).  Its prefill pads a prompt to
  the JAX engine's buckets (powers of two from 8 up to ``max_len``).

Numerics, the JAX engine's ``numerics=``: ``"fast"`` (default) decodes
through the paged-attention kernel, within f32 rounding of the full
recompute.  ``"exact"`` is the verification mode: every emitted token's
logits are bitwise the full-prefix recompute's (`greedy_decode_full` with
``numerics="exact"``).  The JAX engine gets that from XLA's op-at-a-time
dispatch on the CPU; the port gets it from kernels whose row results do
not depend on the batch (``TransformerLM`` with ``exact=True``, or the
Programs' ``exact_lowering``: the row-stable product kernel, the flash
forward in f32 over the full ``max_len`` span, the LayerNorm kernel).
So exact mode needs
``pages_per_slot * block_len == max_len``, and its prefill runs at the
single ``max_len`` bucket.

Precision: the model's, "f32", "bf16" (bf16 KV pools) or "int8" (int8
weights dequantized in every forward, f32 KV pools).

Generation is greedy.  The argmax runs on the device; full logits are
copied to the host only for requests that ask for them
(``capture_logits``).  Every metric family is the JAX engine's
(``decode_*``, labelled by ``model``), mounted on the process default
registry; the flight recorder keeps one record per iteration.

Introspection: the first decode step and the first prefill of each
bucket register a cost report (`observability.introspect`, layer
``predictor``: the Programs' predictors register their own, a
`TransformerLM` through its `step_cost`).
``stats()["inter_token_attribution"]`` is one decode step's device time
by class (`attribution.decode_attribution`): the first ``stats()`` on the
card asks the engine thread to run its next decode step under
``torch.profiler``, and the result is kept.
``stats()["pool_copy_bytes_per_token"]`` is the bytes of the pool tensors
a decode step returned that are not the pools it was fed: 0, since both
models write the pools in place (None before the first step).
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import profiler
from ..core.place import resolve_device
from ..core.scope import Scope
from ..io import load_generation_model
from ..models.transformer import TransformerLM
from ..observability import MetricsRegistry, default_registry, trace
from ..observability import attribution as _attribution
from ..observability import flight as _flight
from ..observability import introspect as _introspect
from ..observability.registry import _LatencyWindow
from .engine import EngineOverloadedError
from .predictor import Predictor


class _GenPredictor(Predictor):
    """A `Predictor` that sets its program's ``exact_lowering``
    (``numerics="exact"``: the row-stable kernels).  The JAX predictor's
    ``donate`` has no counterpart: the KV pools are written in place."""

    def __init__(self, program, feed_names, fetch_vars, scope=None,
                 exact: bool = False, **kwargs):
        program.exact_lowering = bool(exact)
        super().__init__(program, feed_names, fetch_vars, scope=scope,
                         **kwargs)


class GenerationPrograms:
    """The generation Programs as the engine's model: the prefill and the
    decode step of `build_generation_programs`, each run by a
    `_GenPredictor` over a snapshot of ``scope``'s parameters on
    ``device``.  ``prefill`` and ``decode`` take and return what
    `TransformerLM`'s do; the programs fetch the logits and the written
    pools (the very tensors fed)."""

    def __init__(self, scope: Scope, spec: Dict[str, Any], block_len: int,
                 exact: bool = False, precision: str = "f32", device=None,
                 compile_cache=None):
        from ..models import transformer as _T
        if spec["d_model"] % spec["n_heads"]:
            raise ValueError("d_model must be a multiple of n_heads")
        self.spec = dict(spec)
        self.exact = bool(exact)
        self.precision = str(precision)
        self.device = resolve_device(device)
        self.kv_dtype = "bfloat16" if precision == "bf16" else "float32"
        progs = _T.build_generation_programs(
            self.spec, block_len=block_len, exact=self.exact,
            kv_dtype=self.kv_dtype)
        self.pool_names = [n for n in progs["decode"]["feed_names"]
                           if n.startswith(("kv_k_", "kv_v_"))]
        #: bytes of the last decode's returned pools that are copies
        self.pool_copy_bytes: Optional[int] = None
        self.prefill_pred, self.decode_pred = (
            _GenPredictor(progs[m]["program"], progs[m]["feed_names"],
                          progs[m]["fetch_vars"], scope=scope,
                          exact=self.exact, precision=self.precision,
                          device=self.device, compile_cache=compile_cache)
            for m in ("prefill", "decode"))

    def new_kv_pools(self, num_blocks: int, block_len: int
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Zeroed per-layer (K, V) pools in the programs' pool dtype."""
        spec = self.spec
        shape = (num_blocks, block_len, spec["n_heads"],
                 spec["d_model"] // spec["n_heads"])
        dtype = (torch.bfloat16 if self.kv_dtype == "bfloat16"
                 else torch.float32)
        return [(torch.zeros(shape, dtype=dtype, device=self.device),
                 torch.zeros(shape, dtype=dtype, device=self.device))
                for _ in range(spec["n_layers"])]

    def _check(self, exact):
        if exact is not None and bool(exact) != self.exact:
            raise ValueError(f"the programs were built with exact="
                             f"{self.exact}")

    def _feed(self, tokens, pools, pages, index, length=None):
        feed = {"tokens": tokens, "kv_index": index, "kv_pages": pages}
        if length is not None:
            feed["kv_len"] = length
        for (k, v), i in zip(pools, range(0, len(self.pool_names), 2)):
            feed[self.pool_names[i]] = k
            feed[self.pool_names[i + 1]] = v
        return feed

    def prefill(self, tokens: torch.Tensor, pools, pages: torch.Tensor,
                length: torch.Tensor, exact: Optional[bool] = None
                ) -> torch.Tensor:
        """The prefill program: the prompt ``tokens [B, T]`` (valid rows
        ``length [B]``) into the cache from position 0 -> next-token
        logits ``[B, V]``."""
        self._check(exact)
        index = torch.zeros(tokens.shape[0], dtype=torch.int32,
                            device=tokens.device)
        return self.prefill_pred.run(
            self._feed(tokens, pools, pages, index, length),
            return_numpy=False)[0]

    def decode(self, tokens: torch.Tensor, pools, pages: torch.Tensor,
               index: torch.Tensor, exact: Optional[bool] = None
               ) -> torch.Tensor:
        """The decode program: ``tokens [S]`` at positions ``index [S]``
        -> next-token logits ``[S, V]``, each slot's K/V appended."""
        self._check(exact)
        outs = self.decode_pred.run(self._feed(tokens, pools, pages, index),
                                    return_numpy=False)
        fed = [t.untyped_storage().data_ptr() for pair in pools for t in pair]
        self.pool_copy_bytes = sum(
            o.numel() * o.element_size() for o, ptr in zip(outs[1:], fed)
            if o.untyped_storage().data_ptr() != ptr)
        return outs[0]


def _prefill_buckets(max_len: int) -> List[int]:
    """The JAX engine's prompt buckets: powers of two from 8, and
    ``max_len``."""
    buckets, b = [], 8
    while b < max_len:
        buckets.append(b)
        b *= 2
    return buckets + [max_len]


class BlockAllocator:
    """Host-side free list over the KV block pool.  Block ids are
    0..num_blocks-1; ``num_blocks`` itself is the IDLE sentinel a page
    table carries for unmapped pages (writes to it are dropped, reads
    clamp to the last block — see ops/kv_cache_ops.py).

    Per-block reference counts let the prefix cache share a committed
    prompt block between slots: ``incref`` when a slot adopts a cached
    block, ``decref`` when it lets go.  They count adopting slots only (a
    block the cache holds idle sits at 0), and ``free`` refuses a block
    that a slot still references."""

    def __init__(self, num_blocks: int):
        self.num_blocks = int(num_blocks)
        self._free = deque(range(self.num_blocks))
        self._refs: Dict[int, int] = {}

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_blocks - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n blocks or None — never a partial grant (a slot that could
        stall mid-generation waiting for blocks would head-of-line block
        the whole batch)."""
        if n > len(self._free):
            return None
        return [self._free.popleft() for _ in range(n)]

    def free(self, blocks: Sequence[int]):
        for b in blocks:
            if not (0 <= b < self.num_blocks):
                raise ValueError(f"freeing foreign block {b}")
            if self._refs.get(b, 0) > 0:
                raise ValueError(f"freeing block {b} with {self._refs[b]} "
                                 "live references")
            self._free.append(b)

    def incref(self, block: int) -> int:
        self._refs[block] = self._refs.get(block, 0) + 1
        return self._refs[block]

    def decref(self, block: int) -> int:
        n = self._refs.get(block, 0) - 1
        if n < 0:
            raise ValueError(f"decref of unreferenced block {block}")
        if n == 0:
            del self._refs[block]
        else:
            self._refs[block] = n
        return n

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)


class _PrefixNode:
    """One full block of prompt tokens: the edge from its parent is the
    block's ``block_len``-token tuple, and the node owns the pool block
    that holds those positions' K/V."""

    __slots__ = ("key", "block", "parent", "children", "last_used")

    def __init__(self, key, block, parent):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[tuple, "_PrefixNode"] = {}
        self.last_used = 0.0


class PrefixCache:
    """Radix tree over prompt tokens at block granularity.

    Only prefill-written blocks enter the tree: a hot request's replayed
    tail is written by the decode step, whose values may differ from the
    prefill's in the last bits.  The tree holds at most
    ``capacity_blocks`` pool blocks; it evicts the least recently used
    leaf whose refcount is 0 (an interior node is pinned by its
    children), and a full tree with every leaf referenced stops
    inserting.  The tree lives and dies with its engine, so a reloaded
    model starts empty."""

    def __init__(self, allocator: BlockAllocator, block_len: int,
                 capacity_blocks: int):
        self.allocator = allocator
        self.block_len = int(block_len)
        self.capacity_blocks = int(capacity_blocks)
        self.root = _PrefixNode((), None, None)
        self.cached_blocks = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def match(self, prompt: Sequence[int]) -> List[_PrefixNode]:
        """The longest cached path of full prompt blocks (node i holds
        positions i*L .. (i+1)*L-1); touches the path's LRU clocks."""
        L = self.block_len
        path: List[_PrefixNode] = []
        node = self.root
        now = time.monotonic()
        for start in range(0, len(prompt) - L + 1, L):
            child = node.children.get(tuple(prompt[start:start + L]))
            if child is None:
                break
            child.last_used = now
            path.append(child)
            node = child
        return path

    def adopt(self, path: Sequence[_PrefixNode]) -> List[int]:
        """Reference the path's blocks for one slot."""
        for node in path:
            self.allocator.incref(node.block)
        return [node.block for node in path]

    def release(self, path: Sequence[_PrefixNode]):
        for node in path:
            self.allocator.decref(node.block)

    def insert(self, prompt: Sequence[int], blocks: Sequence[int],
               committed_blocks: int) -> List[int]:
        """Take ownership of a released slot's first ``committed_blocks``
        blocks (its prefill-written full prompt blocks).  Returns the
        blocks the tree did not take (duplicates of a cached path, or
        overflow past capacity) for the caller to free."""
        L = self.block_len
        rejected: List[int] = []
        node = self.root
        now = time.monotonic()
        for i in range(committed_blocks):
            key = tuple(prompt[i * L:(i + 1) * L])
            child = node.children.get(key)
            if child is not None:
                # the same tokens at the same positions: keep the
                # resident block, surrender the duplicate
                rejected.append(blocks[i])
                child.last_used = now
                node = child
                continue
            if (self.cached_blocks >= self.capacity_blocks
                    and not self._evict(protect=node)):
                rejected.extend(blocks[i:])
                return rejected
            child = _PrefixNode(key, blocks[i], node)
            child.last_used = now
            node.children[key] = child
            node = child
            self.cached_blocks += 1
        return rejected

    def _leaves(self):
        stack = [self.root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                if child.children:
                    stack.append(child)
                else:
                    yield child

    def _evict(self, protect: Optional[_PrefixNode] = None) -> bool:
        """Drop the least recently used refcount-0 leaf and free its
        block; ``protect`` pins the path being inserted under."""
        protected = set()
        node = protect
        while node is not None:
            protected.add(id(node))
            node = node.parent
        victim = None
        for leaf in self._leaves():
            if id(leaf) in protected or self.allocator.refcount(leaf.block):
                continue
            if victim is None or leaf.last_used < victim.last_used:
                victim = leaf
        if victim is None:
            return False
        del victim.parent.children[victim.key]
        self.allocator.free([victim.block])
        self.cached_blocks -= 1
        self.evictions += 1
        return True

    def evict_for(self, n: int) -> int:
        """Free up to ``n`` blocks for an admission under pool pressure
        (cached prefixes yield to live traffic)."""
        freed = 0
        while freed < n and self._evict():
            freed += 1
        return freed

    def stats(self) -> Dict[str, Any]:
        lookups = self.hits + self.misses
        return {"capacity_blocks": self.capacity_blocks,
                "cached_blocks": self.cached_blocks,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": round(self.hits / lookups, 4) if lookups
                else None}


class GenerateHandle:
    """Consumer side of one generation stream.

    ``events()`` yields ``("token", gen_index, token_id, step, logits)``
    tuples as the engine emits them (``logits`` is None unless the
    request captures them), then exactly one ``("done", finish_reason,
    tokens)``; an engine-side failure yields ``("error", exception)``
    instead.  ``result()`` drains to the end and returns the summary."""

    def __init__(self, prompt_len: int):
        import queue
        self._q: "queue.Queue" = queue.Queue()
        self.prompt_len = prompt_len

    def _emit(self, ev):
        self._q.put(ev)

    def events(self, timeout: Optional[float] = None):
        """Yield events; ``timeout`` bounds the wait for EACH event and
        surfaces as TimeoutError."""
        import queue as _queue
        while True:
            try:
                ev = self._q.get(timeout=timeout)
            except _queue.Empty:
                raise TimeoutError(
                    f"no generation event within {timeout}s") from None
            yield ev
            if ev[0] in ("done", "error"):
                return

    def result(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Drain to completion; ``timeout`` bounds the WHOLE stream."""
        import queue as _queue
        deadline = None if timeout is None else time.monotonic() + timeout
        logits: List[Any] = []
        while True:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("generation timed out")
            try:
                ev = self._q.get(timeout=remaining)
            except _queue.Empty:
                raise TimeoutError("generation timed out") from None
            if ev[0] == "token":
                if ev[4] is not None:
                    logits.append(ev[4])
            elif ev[0] == "error":
                raise ev[1]
            else:
                out = {"tokens": list(ev[2]), "finish_reason": ev[1],
                       "prompt_len": self.prompt_len}
                if logits:
                    out["logits"] = logits
                return out


class _Request:
    __slots__ = ("prompt", "max_new", "eos_id", "deadline", "handle",
                 "t_submit", "trace", "capture_logits")

    def __init__(self, prompt, max_new, eos_id, deadline, capture_logits):
        self.prompt = prompt
        self.max_new = max_new
        self.eos_id = eos_id
        self.deadline = deadline
        self.capture_logits = capture_logits
        self.handle = GenerateHandle(len(prompt))
        self.t_submit = time.monotonic()
        self.trace = trace.current_ids()


class _Slot:
    __slots__ = ("sid", "req", "blocks", "pos", "tokens", "budget",
                 "last_token", "t_prev",
                 # prefix cache: the adopted tree nodes (released at the
                 # end), the prompt tail still to replay, and how many of
                 # the slot's own leading blocks are prefill-written full
                 # prompt blocks (inserted into the tree at the end)
                 "prefix_path", "replay", "insertable")

    def __init__(self, sid: int):
        self.sid = sid
        self.req: Optional[_Request] = None
        self.blocks: List[int] = []
        self.tokens: List[int] = []
        self.prefix_path: List[_PrefixNode] = []
        self.replay: deque = deque()
        self.insertable = 0

    @property
    def active(self) -> bool:
        return self.req is not None


def _ms(summary, key):
    return round(summary[key] * 1e3, 3) if summary else None


def _p50_p99(summary):
    return ({"p50": _ms(summary, "p50"), "p99": _ms(summary, "p99")}
            if summary else None)


class DecodeEngine:
    """S decode slots over one model and its paged KV pools.

    ``source`` is a `TransformerLM` (``spec``, ``precision``, ``device``
    and ``compile_cache`` are then the model's and stay None), or, as
    the JAX engine is built, a `Scope` holding a saved generation
    model's parameters with its ``spec``: the engine then serves the
    generation Programs (`GenerationPrograms`) in ``precision`` on
    ``device`` (the card unless ``"cpu"``).  The ``model`` keyword is
    the name the metric series carry (kept as ``model_name``; the
    attribute ``model`` is the model served)."""

    def __init__(self, source, spec: Optional[Dict[str, Any]] = None,
                 slots: int = 4, block_len: int = 16,
                 pages_per_slot: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 max_queue_depth: Optional[int] = None,
                 warmup: bool = False, numerics: str = "fast",
                 prefix_cache_blocks: int = 0,
                 precision: Optional[str] = None, device=None,
                 model: str = "default", compile_cache=None):
        if numerics not in ("fast", "exact"):
            raise ValueError(f"numerics must be fast|exact, got {numerics!r}")
        self.model_name = str(model)
        self.numerics = numerics
        #: the model's keyword for the exact paths (none in fast mode)
        self._exact_kw = {"exact": True} if numerics == "exact" else {}
        self.block_len = int(block_len)
        if isinstance(source, TransformerLM):
            if spec is not None or precision is not None or \
                    device is not None or compile_cache is not None:
                raise ValueError("spec, precision, device and compile_cache "
                                 "are the TransformerLM's own")
            self.model = source
        elif isinstance(source, Scope):
            if spec is None:
                raise ValueError("DecodeEngine(scope, spec): the spec of "
                                 "the model in the scope is missing")
            self.model = GenerationPrograms(
                source, spec, self.block_len, exact=numerics == "exact",
                precision=precision or "f32", device=device,
                compile_cache=compile_cache)
        else:
            raise TypeError(f"DecodeEngine serves a TransformerLM or a "
                            f"Scope, not {type(source).__name__}")
        self.spec = dict(self.model.spec)
        self.device = self.model.device
        self.slots = int(slots)
        max_len = int(self.spec["max_len"])
        if pages_per_slot is None:
            pages_per_slot = -(-max_len // self.block_len)
        self.pages_per_slot = int(pages_per_slot)
        #: longest sequence one slot can hold
        self.max_tokens = min(max_len, self.pages_per_slot * self.block_len)
        if numerics == "exact" and \
                self.pages_per_slot * self.block_len != max_len:
            # the verification mode compares with a full recompute at
            # T = max_len, so the gathered span must be that long
            raise ValueError(
                "numerics='exact' needs pages_per_slot*block_len == "
                f"max_len ({self.pages_per_slot}*{self.block_len} != "
                f"{max_len})")
        #: prefill lengths: exact mode's single max_len bucket, the JAX
        #: buckets for the Programs, else (None) the prompt's own
        if numerics == "exact":
            self.prefill_buckets: Optional[List[int]] = [max_len]
        elif isinstance(self.model, GenerationPrograms):
            self.prefill_buckets = _prefill_buckets(max_len)
        else:
            self.prefill_buckets = None
        if num_blocks is None:
            num_blocks = self.slots * self.pages_per_slot
        self.allocator = BlockAllocator(num_blocks)
        prefix_cache_blocks = int(prefix_cache_blocks)
        if prefix_cache_blocks >= self.allocator.num_blocks:
            raise ValueError(
                f"prefix_cache_blocks={prefix_cache_blocks} must leave "
                f"room for live traffic in a {self.allocator.num_blocks}"
                "-block pool")
        self.prefix_cache = (PrefixCache(self.allocator, self.block_len,
                                         prefix_cache_blocks)
                             if prefix_cache_blocks > 0 else None)
        self._evictions_synced = 0
        self.max_queue_depth = (None if max_queue_depth is None
                                else int(max_queue_depth))
        self._pools = self.model.new_kv_pools(self.allocator.num_blocks,
                                              self.block_len)
        self.kv_dtype = str(self._pools[0][0].dtype).replace("torch.", "")
        self._slots = [_Slot(i) for i in range(self.slots)]
        self._pages = np.full((self.slots, self.pages_per_slot),
                              self.allocator.num_blocks, np.int32)
        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._closed = False
        # written by the engine thread only
        self._busy_s = 0.0
        self._iterations = 0
        self._prefills = 0
        self._step_s = _LatencyWindow()
        #: introspection: reported (mode, batch, length) calls of a
        #: TransformerLM, the kept attribution and its request flag
        self._reported: set = set()
        self._inter_token_attr = None
        self._attr_wanted = False
        self._attr_error: Optional[str] = None
        self._init_metrics()
        if warmup:
            try:
                self.warm()
            except BaseException:
                default_registry().unmount(self.metrics)
                raise
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"decode-engine-{self.model_name}")
        self._thread.start()

    def _init_metrics(self):
        self.metrics = MetricsRegistry(enabled=True)
        m, lab = self.metrics, dict(model=self.model_name)

        def series(kind, name, help):
            return getattr(m, kind)(name, help,
                                    labelnames=("model",)).labels(**lab)

        self._m_requests = series("counter", "decode_requests_total",
                                  "generation requests submitted")
        self._m_tokens = series("counter", "decode_tokens_total",
                                "tokens emitted across all slots")
        self._m_iterations = series("counter", "decode_iterations_total",
                                    "fused decode steps dispatched")
        self._m_prefills = series("counter", "decode_prefills_total",
                                  "prompt prefill dispatches")
        self._m_active = series("gauge", "decode_active_slots",
                                "slots mid-generation")
        self._m_queue = series("gauge", "decode_queue_depth",
                               "requests waiting for a slot")
        self._m_blocks = series("gauge", "decode_blocks_in_use",
                                "KV pool blocks allocated")
        self._m_occupancy = series("histogram", "decode_slot_occupancy",
                                   "active/total slots per iteration")
        self._m_ttft = series("histogram", "decode_ttft_seconds",
                              "submit to first emitted token")
        self._m_itl = series("histogram", "decode_inter_token_seconds",
                             "gap between consecutive tokens of one stream")
        self._m_shed = series("counter", "decode_shed_total",
                              "submits rejected at the queue bound")
        self._m_expired = series(
            "counter", "decode_expired_total",
            "queued requests whose deadline lapsed before a slot freed")
        self._m_finished = m.counter(
            "decode_finished_total", "completed streams by finish reason",
            labelnames=("model", "reason"))
        self._m_prefix_hits = series(
            "counter", "decode_prefix_hits_total",
            "admitted requests that adopted a cached prompt prefix")
        self._m_prefix_misses = series(
            "counter", "decode_prefix_misses_total",
            "admitted requests with no cached prefix to adopt")
        self._m_prefix_evictions = series(
            "counter", "decode_prefix_evictions_total",
            "prefix-cache blocks evicted (LRU refcount-0 leaves)")
        self._m_ttft_hot = series(
            "histogram", "decode_ttft_hot_seconds",
            "submit to first token for prefix-cache hits (~one decode "
            "step instead of a prefill)")
        default_registry().mount(m)
        default_registry().enable()
        self.flight = _flight.FlightRecorder(
            f"decode.{self.model_name}",
            ("ts", "iteration", "active", "queued", "admitted", "finished",
             "tokens_total", "step_s"),
            meta={"model": self.model_name, "slots": self.slots,
                  "block_len": self.block_len,
                  "num_blocks": self.allocator.num_blocks,
                  "numerics": self.numerics})
        _flight.install_signal_handler()

    @classmethod
    def from_model_dir(cls, model_dir: str, params_filename=None,
                       precision: str = "f32", device=None,
                       model: str = "default", numerics: str = "fast",
                       **kwargs) -> "DecodeEngine":
        """Serve a `save_generation_model` artifact (saved by either
        package) on ``device`` (the card unless ``"cpu"``); ``model`` is
        the name its metric series carry."""
        lm = load_generation_model(model_dir, params_filename,
                                   precision=precision, device=device)
        return cls(lm, numerics=numerics, model=model, **kwargs)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def warm(self):
        """Run one prefill and one decode step on idle (sentinel) pages,
        so that the kernels are built and loaded before the first
        request.  Idle pages take no writes.  On the card the decode
        step runs under ``torch.profiler`` and its trace is dropped:
        CUPTI's first start in a process takes seconds, and paid here,
        before a server publishes its port, the live step that the first
        ``stats()`` asks to profile costs milliseconds."""
        idle = self._tensor(self._pages)
        with torch.inference_mode():
            self._prefill_call(
                self._tensor(np.zeros((1, self._bucket_for(1)), np.int64)),
                idle[:1], self._tensor(np.ones(1, np.int32)))
            step = (self._tensor(np.zeros(self.slots, np.int64)), idle,
                    self._tensor(np.zeros(self.slots, np.int32)))
            if self.device.type == "cuda":
                self._profiled_decode(*step, keep=False)
            else:
                self._decode_call(*step)

    # -- submission ----------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               capture_logits: bool = False) -> GenerateHandle:
        vocab = int(self.spec["vocab"])
        # an id in [-V, 0) wraps, as the JAX lookup does; the model never
        # gathers an id outside the table (on the card that would be a
        # device assert)
        prompt = [int(t) + vocab if -vocab <= int(t) < 0 else int(t)
                  for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        bad = [t for t in prompt if not 0 <= t < vocab]
        if bad:
            raise ValueError(f"prompt token ids {bad[:4]} are outside the "
                             f"vocabulary [0, {vocab})")
        if len(prompt) >= self.max_tokens:
            raise ValueError(
                f"prompt of {len(prompt)} tokens leaves no room in a "
                f"{self.max_tokens}-token slot "
                f"(pages_per_slot={self.pages_per_slot} x "
                f"block_len={self.block_len}, max_len="
                f"{self.spec['max_len']})")
        max_new = max(1, int(max_new_tokens))
        # a request whose worst-case footprint exceeds the WHOLE pool
        # could never be admitted — fail it now, not at its deadline
        budget = min(max_new, self.max_tokens - len(prompt))
        need = -(-(len(prompt) + budget) // self.block_len)
        if need > self.allocator.num_blocks:
            raise ValueError(
                f"request needs {need} KV blocks "
                f"({len(prompt)}+{budget} tokens at block_len="
                f"{self.block_len}) but the pool holds only "
                f"{self.allocator.num_blocks}; lower max_new_tokens or "
                "grow num_blocks")
        if eos_id is None:
            eos_id = self.spec.get("eos_id")
        deadline = (time.monotonic() + float(deadline_ms) / 1e3
                    if deadline_ms is not None else None)
        req = _Request(prompt, max_new, eos_id, deadline, capture_logits)
        with self._cv:
            if self._closed:
                raise RuntimeError("DecodeEngine is closed")
            if (self.max_queue_depth is not None
                    and len(self._queue) >= self.max_queue_depth):
                self._m_shed.inc()
                raise EngineOverloadedError(self.model_name,
                                            len(self._queue),
                                            self.max_queue_depth)
            self._queue.append(req)
            self._m_requests.inc()
            self._m_queue.set(len(self._queue))
            self._cv.notify_all()
        return req.handle

    def generate(self, prompt, max_new_tokens: int = 16,
                 eos_id: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 timeout: Optional[float] = None) -> Dict[str, Any]:
        """Synchronous submit+drain — the one-call offline surface."""
        return self.submit(prompt, max_new_tokens, eos_id,
                           deadline_ms).result(timeout=timeout)

    # -- introspection -------------------------------------------------
    def _prefill_call(self, tokens, pages, length):
        # a TransformerLM prefills at the prompt's length: its reports
        # go by the JAX engine's buckets, at the bucket's cost
        buckets = (self.prefill_buckets
                   or _prefill_buckets(int(self.spec["max_len"])))
        n = tokens.shape[1]
        key = ("prefill", tokens.shape[0],
               next((b for b in buckets if n <= b), buckets[-1]))
        return self._reported_call(
            key, {"tokens": tokens, "kv_pages": pages, "kv_len": length},
            lambda: self.model.prefill(tokens, self._pools, pages, length,
                                       **self._exact_kw))

    def _decode_call(self, tokens, pages, index):
        key = ("decode", tokens.shape[0], 1)
        return self._reported_call(
            key, {"tokens": tokens, "kv_pages": pages, "kv_index": index},
            lambda: self.model.decode(tokens, self._pools, pages, index,
                                      **self._exact_kw))

    def _reported_call(self, key, feed, call):
        """``call()``; the first call of a `TransformerLM` at ``key``
        (mode, batch, length) also registers its report (the Programs'
        predictors register their own)."""
        if key in self._reported or not isinstance(self.model,
                                                   TransformerLM):
            return call()
        with _introspect.first_run_memory(self.device) as peak:
            out = call()
        self._reported.add(key)
        mode, batch, t = key
        model = self.model
        flops, nbytes = model.step_cost(
            mode, batch, t, span=self.pages_per_slot * self.block_len)
        fp = hashlib.sha1(json.dumps(
            [self.spec, model.precision, mode, self.numerics],
            sort_keys=True).encode()).hexdigest()[:16]
        pools = [t for pair in self._pools for t in pair]
        _introspect.record_run(
            layer="predictor", device=self.device, fingerprint=fp,
            feed_sig=_introspect.feed_signature(feed), fetch_names=["logits"],
            flops=flops, bytes_accessed=nbytes,
            argument_bytes=_introspect.tensor_bytes(
                list(model.parameters()) + pools + list(feed.values())),
            output_bytes=_introspect.tensor_bytes(
                out if isinstance(out, (list, tuple)) else [out]),
            temp_bytes=peak[0], dtype=model.precision)
        return out

    def _inter_token_attribution(self):
        """One decode step's device time by class, measured once: on the
        card a first call asks the engine thread to profile its next
        decode step and returns None until it has."""
        if self._inter_token_attr is None and self.device.type == "cuda":
            self._attr_wanted = True
        return self._inter_token_attr

    def _pool_copy_bytes_per_token(self):
        """Bytes of the decode step's returned pools that are copies, not
        the fed pools (None before the first decode step)."""
        if self._iterations == 0:
            return None
        return int(getattr(self.model, "pool_copy_bytes", 0) or 0)

    def _profiled_decode(self, tokens, pages, index, keep=True):
        """The decode step under ``torch.profiler``, its attribution kept
        (`attribution.decode_attribution`) unless ``keep`` is False (the
        warm-up's window, which only pays the profiler's first start).
        While another profiler runs the step runs plain and the next one
        tries again; a profiler that fails leaves the step as it was and
        its reason in ``_attr_error``."""
        if _attribution.torch_profiling():
            return self._decode_call(tokens, pages, index)
        if keep:
            self._attr_wanted = False
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        try:
            prof.start()
        except Exception as e:  # noqa: BLE001 — a measurement aid only
            self._attr_error = f"profiler start: {type(e).__name__}: {e}"
            return self._decode_call(tokens, pages, index)
        try:
            logits = self._decode_call(tokens, pages, index)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            if keep:
                self._inter_token_attr = _attribution.decode_attribution(
                    path)
                if self._inter_token_attr is None:
                    self._attr_error = ("the profiled step held no device "
                                        "events")
        except Exception as e:  # noqa: BLE001
            self._attr_error = f"trace: {type(e).__name__}: {e}"
        finally:
            os.unlink(path)
        return logits

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            queued = len(self._queue)
        tokens = int(self._m_tokens.value)
        busy = self._busy_s
        occ = self._m_occupancy.summary()
        prefix = None
        if self.prefix_cache is not None:
            prefix = dict(self.prefix_cache.stats())
            prefix["ttft_hot_ms"] = _p50_p99(self._m_ttft_hot.summary())
        step = self._step_s.eval() if self._step_s.count else None
        return {
            "slots": self.slots,
            "active_slots": sum(1 for s in self._slots if s.active),
            "queue_depth": queued,
            "requests": int(self._m_requests.value),
            "tokens_total": tokens,
            "iterations": self._iterations,
            "prefills": self._prefills,
            "dispatches_per_token": round(
                (self._iterations + self._prefills) / max(tokens, 1), 4),
            "tokens_per_sec": round(tokens / busy, 2) if busy > 0 else None,
            "occupancy_mean": round(occ["mean"], 4) if occ else None,
            "ttft_ms": _p50_p99(self._m_ttft.summary()),
            "inter_token_ms": _p50_p99(self._m_itl.summary()),
            "step_ms": _p50_p99(step),
            "inter_token_attribution": self._inter_token_attribution(),
            "pool_copy_bytes_per_token": self._pool_copy_bytes_per_token(),
            "prefix": prefix,
            "blocks": {"total": self.allocator.num_blocks,
                       "in_use": self.allocator.in_use,
                       "block_len": self.block_len},
            "numerics": self.numerics,
            "kv_dtype": self.kv_dtype,
            "shed": int(self._m_shed.value),
            "expired": int(self._m_expired.value),
            "finished": {labels["reason"]: int(series.value)
                         for labels, series in self._m_finished.items()},
            **({"prefill": self.model.prefill_pred.stats(),
                "decode": self.model.decode_pred.stats()}
               if isinstance(self.model, GenerationPrograms) else {}),
        }

    def close(self, timeout: float = 30.0, unmount: bool = True):
        """Stop admitting, let active slots finish generating (drain),
        resolve still-queued requests with the shutdown error, and join
        the engine thread."""
        with self._cv:
            self._closed = True
            queued = list(self._queue)
            self._queue.clear()
            self._m_queue.set(0)
            self._cv.notify_all()
        for req in queued:
            req.handle._emit(("error",
                              RuntimeError("DecodeEngine is closed")))
        self._thread.join(timeout)
        if self._thread.is_alive():
            # drain overran its budget: resolve what is left so no
            # consumer blocks forever on a daemon thread
            for slot in self._slots:
                req = slot.req
                if req is not None:
                    req.handle._emit(
                        ("error", RuntimeError("DecodeEngine is closed")))
        if unmount:
            default_registry().unmount(self.metrics)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- engine thread -------------------------------------------------
    def _loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            self._drive()

    def _drive(self):
        while True:
            with self._cv:
                while (not self._closed and not self._queue
                       and not any(s.active for s in self._slots)):
                    self._cv.wait(0.05)
                if (self._closed and not self._queue
                        and not any(s.active for s in self._slots)):
                    return
            try:
                admitted = self._admit()
                finished = 0
                t0 = time.perf_counter()
                if any(s.active for s in self._slots):
                    finished = self._step()
                self.flight.push((
                    time.time(), self._iterations,
                    sum(1 for s in self._slots if s.active),
                    len(self._queue), admitted, finished,
                    int(self._m_tokens.value), time.perf_counter() - t0))
            except Exception as e:  # noqa: BLE001 — the thread must survive
                try:
                    self.flight.dump(
                        reason=f"decode driver: {type(e).__name__}")
                except OSError:
                    pass
                # fail every in-flight stream; the engine stays up for
                # new requests
                for slot in self._slots:
                    if slot.active:
                        slot.req.handle._emit(("error", e))
                        self._release(slot)

    def _admit(self) -> int:
        """Move queued requests into free slots (runs at EVERY iteration
        boundary, so arrivals join a running batch)."""
        admitted = []
        with self._cv:
            # purge every queued request whose deadline lapsed
            now = time.monotonic()
            expired = [r for r in self._queue
                       if r.deadline is not None and now > r.deadline]
            for req in expired:
                self._queue.remove(req)
                self._m_expired.inc()
                req.handle._emit(("error", TimeoutError(
                    "deadline expired before a decode slot freed")))
            while self._queue:
                head = self._queue[0]
                slot = next((s for s in self._slots if not s.active), None)
                if slot is None:
                    break
                budget = min(head.max_new,
                             self.max_tokens - len(head.prompt))
                need = -(-(len(head.prompt) + budget) // self.block_len)
                # adopt the longest cached prefix by reference, before
                # any allocation or eviction below can reap it.  A
                # full-prompt hit splits off its last node to copy on
                # write: the replay of the last prompt token writes into
                # that block, and a shared block is never written.
                path = (self.prefix_cache.match(head.prompt)
                        if self.prefix_cache is not None else [])
                cow_node = None
                if path and len(path) * self.block_len >= len(head.prompt):
                    cow_node = path[-1]
                    path = path[:-1]
                adopted = self.prefix_cache.adopt(path) if path else []
                if cow_node is not None:
                    self.allocator.incref(cow_node.block)
                fresh = need - len(adopted)
                blocks = self.allocator.alloc(fresh)
                if blocks is None and self.prefix_cache is not None:
                    # live traffic beats cached prefixes
                    self.prefix_cache.evict_for(
                        fresh - self.allocator.available)
                    blocks = self.allocator.alloc(fresh)
                if blocks is None:
                    if path:
                        self.prefix_cache.release(path)
                    if cow_node is not None:
                        self.allocator.decref(cow_node.block)
                    break            # pool pressure: wait for frees
                self._queue.popleft()
                slot.req = head
                slot.blocks = blocks
                slot.budget = budget
                slot.tokens = []
                n_adopt = len(adopted)
                row = np.full(self.pages_per_slot, self.allocator.num_blocks,
                              np.int32)
                row[:n_adopt] = adopted
                row[n_adopt:n_adopt + len(blocks)] = blocks
                self._pages[slot.sid] = row
                slot.prefix_path = path
                slot.insertable = 0
                hot = bool(path) or cow_node is not None
                if cow_node is not None:
                    # every prompt position is cached: replay just the
                    # last prompt token into the copied block
                    slot.pos = len(head.prompt) - 1
                    slot.replay = deque(head.prompt[-1:])
                elif hot:
                    slot.pos = n_adopt * self.block_len
                    slot.replay = deque(head.prompt[slot.pos:])
                else:
                    slot.replay = deque()      # cold: the prefill covers it
                if self.prefix_cache is not None:
                    if hot:
                        self.prefix_cache.hits += 1
                        self._m_prefix_hits.inc()
                    else:
                        self.prefix_cache.misses += 1
                        self._m_prefix_misses.inc()
                admitted.append((slot, cow_node))
            self._m_queue.set(len(self._queue))
        for slot, cow_node in admitted:
            if cow_node is not None:
                self._cow_copy(cow_node.block, slot.blocks[0])
                self.allocator.decref(cow_node.block)
            if slot.replay:
                # hot: no prefill; the decode step replays the tail
                slot.t_prev = time.monotonic()
            else:
                self._prefill(slot)
        self._sync_prefix_metrics()
        self._m_blocks.set(self.allocator.in_use)
        self._m_active.set(sum(1 for s in self._slots if s.active))
        return len(admitted)

    def _cow_copy(self, src: int, dst: int):
        """Copy block ``src`` into block ``dst`` in every layer's K and V
        pool; on the engine's stream, so it lands before the replay's
        first write to ``dst``."""
        for k, v in self._pools:
            k[dst].copy_(k[src])
            v[dst].copy_(v[src])

    def _sync_prefix_metrics(self):
        if self.prefix_cache is None:
            return
        delta = self.prefix_cache.evictions - self._evictions_synced
        if delta > 0:
            self._m_prefix_evictions.inc(delta)
            self._evictions_synced += delta

    def _trace_scope(self, reqs):
        ids = tuple(t for r in reqs for t in r.trace)
        return trace.scope(*ids) if ids else contextlib.nullcontext()

    def _bucket_for(self, n: int) -> int:
        """The prefill length of an n-token prompt."""
        if self.prefill_buckets is None:
            return n
        return next((b for b in self.prefill_buckets if n <= b),
                    self.prefill_buckets[-1])

    def _prefill(self, slot: _Slot):
        req = slot.req
        t0 = time.perf_counter()
        with self._trace_scope([req]), profiler.record_block(
                "decode.prefill"):
            toks = np.zeros((1, self._bucket_for(len(req.prompt))),
                            np.int64)
            toks[0, :len(req.prompt)] = req.prompt
            logits = self._prefill_call(
                self._tensor(toks),
                self._tensor(self._pages[slot.sid:slot.sid + 1]),
                self._tensor(np.array([len(req.prompt)], np.int32)))
            tok = int(logits[0].argmax())
            row = (logits[0].float().cpu().numpy() if req.capture_logits
                   else None)
        self._busy_s += time.perf_counter() - t0
        self._prefills += 1
        self._m_prefills.inc()
        slot.pos = len(req.prompt)
        if self.prefix_cache is not None:
            # only prefill-written blocks are cacheable
            slot.insertable = len(req.prompt) // self.block_len
        now = time.monotonic()
        self._m_ttft.observe(now - req.t_submit)
        slot.t_prev = now
        self._emit_token(slot, tok, row)

    def _emit_token(self, slot: _Slot, tok: int, logits):
        req = slot.req
        slot.tokens.append(tok)
        slot.last_token = tok
        self._m_tokens.inc()
        req.handle._emit(("token", len(slot.tokens) - 1, tok,
                          self._iterations, logits))
        # finish checks: EOS, token budget, slot capacity, deadline
        reason = None
        if req.eos_id is not None and tok == req.eos_id:
            reason = "eos"
        elif len(slot.tokens) >= slot.budget:
            reason = "length"
        elif slot.pos >= self.max_tokens:
            # the emitted token would be written at position `pos` by the
            # next step; no room means the stream ends here
            reason = "length"
        elif (req.deadline is not None
              and time.monotonic() > req.deadline):
            reason = "deadline"
        if reason is not None:
            self._finish(slot, reason)

    def _finish(self, slot: _Slot, reason: str):
        self._m_finished.labels(model=self.model_name, reason=reason).inc()
        req, tokens = slot.req, list(slot.tokens)
        # release first: a consumer that has its "done" finds the blocks
        # freed or cached already
        self._release(slot)
        req.handle._emit(("done", reason, tokens))
        with self._cv:
            self._cv.notify_all()   # a freed slot may unblock admission

    def _release(self, slot: _Slot):
        if slot.prefix_path:
            self.prefix_cache.release(slot.prefix_path)
        if self.prefix_cache is not None and slot.insertable > 0:
            # the prefill-written full prompt blocks move into the tree
            # (refcount 0: idle and evictable, not freed); what it does
            # not keep goes back with the decode-written tail
            n = slot.insertable
            rejected = self.prefix_cache.insert(slot.req.prompt,
                                                slot.blocks[:n], n)
            self.allocator.free(list(rejected) + slot.blocks[n:])
        else:
            self.allocator.free(slot.blocks)
        self._pages[slot.sid] = self.allocator.num_blocks
        slot.req = None
        slot.blocks = []
        slot.tokens = []
        slot.prefix_path = []
        slot.replay = deque()
        slot.insertable = 0
        self._sync_prefix_metrics()
        self._m_blocks.set(self.allocator.in_use)
        self._m_active.set(sum(1 for s in self._slots if s.active))

    def _step(self) -> int:
        """ONE decode forward advancing every active slot by one token
        (a hot slot still replaying its prompt tail writes that token's
        K/V and emits nothing).  Returns the streams it finished."""
        active = [s for s in self._slots if s.active]
        tokens = np.zeros(self.slots, np.int64)
        index = np.zeros(self.slots, np.int32)
        for s in active:
            tokens[s.sid] = s.replay[0] if s.replay else s.last_token
            index[s.sid] = s.pos
        t0 = time.perf_counter()
        with self._trace_scope([s.req for s in active]), \
                profiler.record_block("decode.step"):
            call = (self._profiled_decode if self._attr_wanted
                    else self._decode_call)
            logits = call(self._tensor(tokens), self._tensor(self._pages),
                          self._tensor(index))
            next_tokens = logits.argmax(dim=-1).cpu().numpy()
            rows = (logits.float().cpu().numpy()
                    if any(s.req.capture_logits for s in active) else None)
        dt = time.perf_counter() - t0
        self._busy_s += dt
        self._step_s.update(dt)
        self._iterations += 1
        self._m_iterations.inc()
        self._m_occupancy.observe(len(active) / self.slots)
        finished_before = sum(1 for s in self._slots if not s.active)
        now = time.monotonic()
        for s in active:
            s.pos += 1
            row = rows[s.sid].copy() if s.req.capture_logits else None
            if s.replay:
                s.replay.popleft()
                if s.replay:
                    # mid-replay: no emission, but a lapsed deadline
                    # still ends the stream
                    if (s.req.deadline is not None
                            and now > s.req.deadline):
                        self._finish(s, "deadline")
                    continue
                # the last prompt token's logits are the first token's
                self._m_ttft.observe(now - s.req.t_submit)
                self._m_ttft_hot.observe(now - s.req.t_submit)
            else:
                self._m_itl.observe(now - s.t_prev)
            s.t_prev = now
            self._emit_token(s, int(next_tokens[s.sid]), row)
        return sum(1 for s in self._slots
                   if not s.active) - finished_before


# ---------------------------------------------------------------------------
# offline decode (the O(T^2) baseline and the KV-cache offline path)
# ---------------------------------------------------------------------------

def _as_model(model: Union[str, os.PathLike, TransformerLM], precision,
              device) -> TransformerLM:
    if isinstance(model, TransformerLM):
        return model
    return load_generation_model(str(model), precision=precision,
                                 device=device)


def _load_full_predictor(model_dir: str, spec: Dict[str, Any],
                         exact: bool, precision: str = "f32",
                         device=None) -> _GenPredictor:
    """The full-prefix LM program (``transformer_lm_logits`` at ``T =
    max_len``, the saved model's parameter names) over the parameters in
    ``model_dir``, as a `_GenPredictor` (``exact``: the row-stable
    kernels); the exact generation Programs' logits are bitwise its
    rows."""
    from .. import io as _io
    from .. import layers, unique_name
    from ..core.program import Program, program_guard
    from ..core.scope import scope_guard
    from ..models import transformer as _T
    scope = Scope()
    with scope_guard(scope):
        _io.load_inference_model(model_dir, None)
    main = Program()
    with program_guard(main, Program()), unique_name.guard():
        toks = layers.data(name="tokens", shape=[spec["max_len"]],
                           dtype="int64")
        logits = _T.transformer_lm_logits(
            toks, spec["vocab"], spec["max_len"], spec["n_layers"],
            spec["d_model"], spec["n_heads"], spec["d_ff"])
    return _GenPredictor(main, ["tokens"], [logits], scope=scope,
                         exact=exact, precision=precision, device=device)


def greedy_decode_full(model, prompts: Sequence[Sequence[int]],
                       max_new_tokens: int = 16,
                       eos_id: Optional[int] = None,
                       capture_logits: bool = False,
                       precision: str = "f32", device=None,
                       numerics: str = "fast",
                       predictor: Optional[Predictor] = None
                       ) -> Dict[str, Any]:
    """The O(T^2) offline baseline: every emitted token re-runs the whole
    prefix through the model (`TransformerLM.forward`) and reads each
    sequence's last position.  ``model`` is a `TransformerLM` or a saved
    model directory.  Padding past a sequence's length is inert under the
    causal mask.  ``numerics="exact"`` runs the exact paths at
    ``T = max_len`` (as the JAX baseline always does), the shapes at which
    the exact decode engine's logits are bitwise these.  With
    ``predictor`` (`_load_full_predictor`'s) the recompute runs that
    program at ``T = max_len`` instead, and ``model`` is only read for its
    spec (a directory is not loaded)."""
    if numerics not in ("fast", "exact"):
        raise ValueError(f"numerics must be fast|exact, got {numerics!r}")
    if predictor is not None:
        from ..models.transformer import read_generation_spec
        spec = (model.spec if isinstance(model, TransformerLM)
                else read_generation_spec(str(model)))

        def step(toks, last):
            # the program's feed is [B, max_len]; its logits [B, T, V]
            (full,) = predictor.run({"tokens": toks}, return_numpy=False)
            rows = torch.arange(len(last), device=full.device)
            return full[rows, torch.from_numpy(last).to(full.device)]
        t_fixed = spec["max_len"]
    else:
        m = _as_model(model, precision, device)
        spec = m.spec
        exact = numerics == "exact"

        def step(toks, last):
            return m(torch.from_numpy(toks).to(m.device),
                     torch.from_numpy(last).to(m.device), exact=exact)
        t_fixed = spec["max_len"] if exact else None
    if eos_id is None:
        eos_id = spec.get("eos_id")
    max_len = spec["max_len"]
    b = len(prompts)
    seqs = [list(map(int, p)) for p in prompts]
    done = [len(s) >= max_len for s in seqs]
    out_tokens: List[List[int]] = [[] for _ in range(b)]
    logits_trace: List[np.ndarray] = []
    reasons = ["length"] * b
    dispatches = 0
    with torch.inference_mode():
        for _ in range(max_new_tokens):
            if all(done):
                break
            t = t_fixed or max(len(s) for s in seqs)
            toks = np.zeros((b, t), np.int64)
            for i, s in enumerate(seqs):
                toks[i, :len(s)] = s
            lg = step(toks, np.array([len(s) - 1 for s in seqs], np.int64))
            dispatches += 1
            nxt = lg.argmax(dim=-1).cpu().numpy()
            if capture_logits:
                logits_trace.append(lg.float().cpu().numpy())
            for i in range(b):
                if done[i]:
                    continue
                tok = int(nxt[i])
                out_tokens[i].append(tok)
                seqs[i].append(tok)
                if eos_id is not None and tok == eos_id:
                    done[i] = True
                    reasons[i] = "eos"
                elif len(seqs[i]) >= max_len:
                    done[i] = True
    out = {"tokens": out_tokens, "finish_reasons": reasons,
           "dispatches": dispatches}
    if capture_logits:
        out["logits"] = logits_trace
    return out


def greedy_decode_kv(model, prompts: Sequence[Sequence[int]],
                     max_new_tokens: int = 16,
                     eos_id: Optional[int] = None, block_len: int = 16,
                     capture_logits: bool = False, precision: str = "f32",
                     device=None, numerics: str = "fast",
                     **engine_kwargs) -> Dict[str, Any]:
    """The same offline generation through the KV cache: one DecodeEngine
    with a slot per prompt — prefill once, then one step per token;
    bitwise `greedy_decode_full` under ``numerics="exact"``."""
    engine = DecodeEngine(_as_model(model, precision, device),
                          slots=len(prompts), block_len=block_len,
                          numerics=numerics, **engine_kwargs)
    try:
        handles = [engine.submit(p, max_new_tokens, eos_id=eos_id,
                                 capture_logits=capture_logits)
                   for p in prompts]
        results = [h.result(timeout=300.0) for h in handles]
    finally:
        stats = engine.stats()
        engine.close()
    out = {"tokens": [r["tokens"] for r in results],
           "finish_reasons": [r["finish_reason"] for r in results],
           "dispatches": stats["iterations"] + stats["prefills"],
           "stats": stats}
    if capture_logits:
        out["logits"] = [r.get("logits", []) for r in results]
    return out
