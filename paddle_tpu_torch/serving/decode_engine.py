"""Continuous-batching autoregressive decode engine (counterpart of
``paddle_tpu/serving/decode_engine.py``).

Orca-style iteration-level scheduling over a vLLM-style paged KV cache:

- A fixed pool of S *slots* advances by ONE decode forward per
  iteration: every active slot emits one token per step.
- New requests join the running batch at any iteration boundary as
  others finish (continuous batching, no drain barrier).
- A request's prompt is written into its slot by a *prefill* before the
  slot joins the decode batch.  The prefill runs at the prompt's own
  length: the JAX engine pads prompts to power-of-two buckets so that
  XLA compiles a few executables, and eager PyTorch needs no buckets.
- Per-layer K/V live in paged block pools ``[num_blocks, block_len,
  heads, head_dim]`` on the device, with the host-side `BlockAllocator`
  handing each slot a page-table row (ops/kv_cache_ops.py).  The pools
  are written in place; their dtype follows the model's precision (bf16
  halves the KV bytes).

Generation is greedy.  The argmax runs on the device; full logits are
copied to the host only for requests that ask for them
(``capture_logits``).

Not ported yet: the prefix cache, ``numerics="exact"``, the compile
cache, the metrics registry, the flight recorder and trace scopes.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..io import load_generation_model
from ..models.transformer import TransformerLM
from .engine import EngineOverloadedError


class BlockAllocator:
    """Host-side free list over the KV block pool.  Block ids are
    0..num_blocks-1; ``num_blocks`` itself is the IDLE sentinel a page
    table carries for unmapped pages (writes to it are dropped, reads
    clamp to the last block — see ops/kv_cache_ops.py)."""

    def __init__(self, num_blocks: int):
        self.num_blocks = int(num_blocks)
        self._free = deque(range(self.num_blocks))

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
            self._free.append(b)


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
                 "t_submit", "capture_logits")

    def __init__(self, prompt, max_new, eos_id, deadline, capture_logits):
        self.prompt = prompt
        self.max_new = max_new
        self.eos_id = eos_id
        self.deadline = deadline
        self.capture_logits = capture_logits
        self.handle = GenerateHandle(len(prompt))
        self.t_submit = time.monotonic()


class _Slot:
    __slots__ = ("sid", "req", "blocks", "pos", "tokens", "budget",
                 "last_token", "t_prev")

    def __init__(self, sid: int):
        self.sid = sid
        self.req: Optional[_Request] = None
        self.blocks: List[int] = []
        self.tokens: List[int] = []

    @property
    def active(self) -> bool:
        return self.req is not None


def _percentiles(samples, scale=1e3) -> Optional[Dict[str, float]]:
    if not samples:
        return None
    a = np.asarray(samples, np.float64) * scale
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99))}


class DecodeEngine:
    """S decode slots over one `TransformerLM` and its paged KV pools."""

    def __init__(self, model: TransformerLM, slots: int = 4,
                 block_len: int = 16, pages_per_slot: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 max_queue_depth: Optional[int] = None,
                 warmup: bool = False):
        self.model = model
        self.spec = dict(model.spec)
        self.device = model.device
        self.slots = int(slots)
        self.block_len = int(block_len)
        max_len = int(self.spec["max_len"])
        if pages_per_slot is None:
            pages_per_slot = -(-max_len // self.block_len)
        self.pages_per_slot = int(pages_per_slot)
        #: longest sequence one slot can hold
        self.max_tokens = min(max_len, self.pages_per_slot * self.block_len)
        if num_blocks is None:
            num_blocks = self.slots * self.pages_per_slot
        self.allocator = BlockAllocator(num_blocks)
        self.max_queue_depth = (None if max_queue_depth is None
                                else int(max_queue_depth))
        self.kv_dtype = str(model.dtype).replace("torch.", "")
        self._pools = model.new_kv_pools(self.allocator.num_blocks,
                                         self.block_len)
        self._slots = [_Slot(i) for i in range(self.slots)]
        self._pages = np.full((self.slots, self.pages_per_slot),
                              self.allocator.num_blocks, np.int32)
        self._cv = threading.Condition()
        self._queue: deque = deque()
        self._closed = False
        # counters and samples; written by the engine thread only
        self._busy_s = 0.0
        self._iterations = 0
        self._prefills = 0
        self._tokens = 0
        self._requests = 0
        self._shed = 0
        self._expired = 0
        self._finished: Dict[str, int] = {}
        self._ttft: List[float] = []
        self._itl: List[float] = []
        self._step_s: List[float] = []
        if warmup:
            self.warm()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                         name="decode-engine")
        self._thread.start()

    @classmethod
    def from_model_dir(cls, model_dir: str, params_filename=None,
                       precision: str = "f32", device=None,
                       **kwargs) -> "DecodeEngine":
        """Serve a `save_generation_model` artifact (saved by either
        package) on ``device`` (the card unless ``"cpu"``)."""
        model = load_generation_model(model_dir, params_filename,
                                      precision=precision, device=device)
        return cls(model, **kwargs)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def warm(self):
        """Run one prefill and one decode step on idle (sentinel) pages,
        so that the kernels are built and loaded before the first
        request.  Idle pages take no writes."""
        idle = self._tensor(self._pages)
        with torch.inference_mode():
            self.model.prefill(self._tensor(np.zeros((1, 1), np.int64)),
                               self._pools, idle[:1],
                               self._tensor(np.ones(1, np.int32)))
            self.model.decode(self._tensor(np.zeros(self.slots, np.int64)),
                              self._pools, idle,
                              self._tensor(np.zeros(self.slots, np.int32)))

    # -- submission ----------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               capture_logits: bool = False) -> GenerateHandle:
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
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
                self._shed += 1
                raise EngineOverloadedError("decode", len(self._queue),
                                            self.max_queue_depth)
            self._queue.append(req)
            self._requests += 1
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
    def stats(self) -> Dict[str, Any]:
        with self._cv:
            queued = len(self._queue)
            finished = dict(self._finished)
        tokens = self._tokens
        busy = self._busy_s
        return {
            "slots": self.slots,
            "active_slots": sum(1 for s in self._slots if s.active),
            "queue_depth": queued,
            "requests": self._requests,
            "tokens_total": tokens,
            "iterations": self._iterations,
            "prefills": self._prefills,
            "dispatches_per_token": (self._iterations + self._prefills)
            / max(tokens, 1),
            "tokens_per_sec": tokens / busy if busy > 0 else None,
            "ttft_ms": _percentiles(self._ttft),
            "inter_token_ms": _percentiles(self._itl),
            "step_ms": _percentiles(self._step_s),
            "blocks": {"total": self.allocator.num_blocks,
                       "in_use": self.allocator.in_use,
                       "block_len": self.block_len},
            "kv_dtype": self.kv_dtype,
            "shed": self._shed,
            "expired": self._expired,
            "finished": finished,
        }

    def close(self, timeout: float = 30.0):
        """Stop admitting, let active slots finish generating (drain),
        resolve still-queued requests with the shutdown error, and join
        the engine thread."""
        with self._cv:
            self._closed = True
            queued = list(self._queue)
            self._queue.clear()
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
                self._admit()
                if any(s.active for s in self._slots):
                    self._step()
            except Exception as e:  # noqa: BLE001 — the thread must survive
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
                self._expired += 1
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
                blocks = self.allocator.alloc(need)
                if blocks is None:
                    break            # pool pressure: wait for frees
                self._queue.popleft()
                slot.req = head
                slot.blocks = blocks
                slot.budget = budget
                slot.tokens = []
                row = np.full(self.pages_per_slot, self.allocator.num_blocks,
                              np.int32)
                row[:len(blocks)] = blocks
                self._pages[slot.sid] = row
                admitted.append(slot)
        for slot in admitted:
            self._prefill(slot)
        return len(admitted)

    def _prefill(self, slot: _Slot):
        req = slot.req
        t0 = time.perf_counter()
        logits = self.model.prefill(
            self._tensor(np.asarray([req.prompt], np.int64)), self._pools,
            self._tensor(self._pages[slot.sid:slot.sid + 1]),
            self._tensor(np.array([len(req.prompt)], np.int32)))
        tok = int(logits[0].argmax())
        row = logits[0].float().cpu().numpy() if req.capture_logits else None
        self._busy_s += time.perf_counter() - t0
        self._prefills += 1
        slot.pos = len(req.prompt)
        now = time.monotonic()
        self._ttft.append(now - req.t_submit)
        slot.t_prev = now
        self._emit_token(slot, tok, row)

    def _emit_token(self, slot: _Slot, tok: int, logits):
        req = slot.req
        slot.tokens.append(tok)
        slot.last_token = tok
        self._tokens += 1
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
        with self._cv:
            self._finished[reason] = self._finished.get(reason, 0) + 1
        slot.req.handle._emit(("done", reason, list(slot.tokens)))
        self._release(slot)

    def _release(self, slot: _Slot):
        self.allocator.free(slot.blocks)
        self._pages[slot.sid] = self.allocator.num_blocks
        slot.req = None
        slot.blocks = []
        slot.tokens = []

    def _step(self):
        """ONE decode forward advancing every active slot by one token."""
        active = [s for s in self._slots if s.active]
        tokens = np.zeros(self.slots, np.int64)
        index = np.zeros(self.slots, np.int32)
        for s in active:
            tokens[s.sid] = s.last_token
            index[s.sid] = s.pos
        t0 = time.perf_counter()
        logits = self.model.decode(self._tensor(tokens), self._pools,
                                   self._tensor(self._pages),
                                   self._tensor(index))
        next_tokens = logits.argmax(dim=-1).cpu().numpy()
        rows = (logits.float().cpu().numpy()
                if any(s.req.capture_logits for s in active) else None)
        dt = time.perf_counter() - t0
        self._busy_s += dt
        self._step_s.append(dt)
        self._iterations += 1
        now = time.monotonic()
        for s in active:
            s.pos += 1
            self._itl.append(now - s.t_prev)
            s.t_prev = now
            self._emit_token(s, int(next_tokens[s.sid]),
                             rows[s.sid].copy() if s.req.capture_logits
                             else None)


# ---------------------------------------------------------------------------
# offline decode (the O(T^2) baseline and the KV-cache offline path)
# ---------------------------------------------------------------------------

def _as_model(model: Union[str, os.PathLike, TransformerLM], precision,
              device) -> TransformerLM:
    if isinstance(model, TransformerLM):
        return model
    return load_generation_model(str(model), precision=precision,
                                 device=device)


def greedy_decode_full(model, prompts: Sequence[Sequence[int]],
                       max_new_tokens: int = 16,
                       eos_id: Optional[int] = None,
                       capture_logits: bool = False,
                       precision: str = "f32", device=None
                       ) -> Dict[str, Any]:
    """The O(T^2) offline baseline: every emitted token re-runs the whole
    prefix through the model (`TransformerLM.forward`) and reads each
    sequence's last position.  ``model`` is a `TransformerLM` or a saved
    model directory.  Padding past a sequence's length is inert under the
    causal mask."""
    m = _as_model(model, precision, device)
    if eos_id is None:
        eos_id = m.spec.get("eos_id")
    max_len = m.spec["max_len"]
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
            t = max(len(s) for s in seqs)
            toks = np.zeros((b, t), np.int64)
            for i, s in enumerate(seqs):
                toks[i, :len(s)] = s
            last = np.array([len(s) - 1 for s in seqs], np.int64)
            lg = m(torch.from_numpy(toks).to(m.device),
                   torch.from_numpy(last).to(m.device))
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
                     device=None, **engine_kwargs) -> Dict[str, Any]:
    """The same offline generation through the KV cache: one DecodeEngine
    with a slot per prompt — prefill once, then one step per token."""
    engine = DecodeEngine(_as_model(model, precision, device),
                          slots=len(prompts), block_len=block_len,
                          **engine_kwargs)
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
