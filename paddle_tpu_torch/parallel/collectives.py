"""The port's collectives over a mesh's sub-groups.

Every collective of the parallel paths goes through this module, for two
reasons:

- ``torch.distributed.nn.functional.all_gather`` differentiates through
  ``scatter``, which gloo refuses on CUDA tensors (its CUDA support is
  ``broadcast`` and ``all_reduce``), and the card's two-rank route is
  gloo over CUDA tensors;
- DTensor's sharding propagation cannot see the port's ctypes kernels,
  so the partitioned step places its own collectives.

On gloo with a CUDA tensor the all-gather is an all-reduce SUM of a zero
buffer with this rank's slice written in, over the slice's bytes read as
int32 words: an integer sum of zeros and one value passes every bit
pattern through (a float buffer of +0.0 would turn -0.0 into +0.0 and
break the bitwise checks of ``numerics="exact"``).  Elsewhere it is the
backend's own all-gather.

Every call is counted by kind (``all-gather``, ``all-reduce``,
``broadcast``), mesh axis and payload bytes (the bytes the collective
delivers to this rank); `ledger` gives the counts in the JAX
``collective_ledger`` form, which the cost reports read.

The autograd Functions are Megatron's:

- `gather` (all-gather forward; backward keeps this rank's slice, the
  gathered value being computed alike on every rank of the group);
- `copy_to` (Megatron's f: identity forward, all-reduce backward), on
  the replicated input of a column-sharded product;
- `reduce_from` (Megatron's g: all-reduce forward, identity backward),
  on the partial sums of a row-sharded product.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

_lock = threading.Lock()
#: (kind, axis) -> [calls, bytes]
_counts: Dict[Tuple[str, str], list] = {}


def _count(kind: str, axis: str, nbytes: int):
    with _lock:
        ent = _counts.setdefault((kind, str(axis)), [0, 0])
        ent[0] += 1
        ent[1] += int(nbytes)


def reset_counts():
    """Set every count to 0."""
    with _lock:
        _counts.clear()


def counts() -> Dict[Tuple[str, str], Tuple[int, int]]:
    """``{(kind, axis): (calls, bytes)}`` since the last reset."""
    with _lock:
        return {k: (v[0], v[1]) for k, v in _counts.items()}


def ledger(since: Optional[Dict] = None) -> Optional[Dict]:
    """The counts (minus a `counts` snapshot ``since``) as the JAX
    ``collective_ledger``: ``{"total_bytes", "count", "kinds": {kind:
    {"count", "bytes"}}, "axes": {axis: {"count", "bytes"}}}``; None when
    nothing ran."""
    now = counts()
    since = since or {}
    kinds: Dict[str, Dict[str, int]] = {}
    axes: Dict[str, Dict[str, int]] = {}
    for (kind, axis), (n, b) in now.items():
        n0, b0 = since.get((kind, axis), (0, 0))
        n, b = n - n0, b - b0
        if n <= 0:
            continue
        for table, key in ((kinds, kind), (axes, axis)):
            ent = table.setdefault(key, {"count": 0, "bytes": 0})
            ent["count"] += n
            ent["bytes"] += b
    if not kinds:
        return None
    return {"total_bytes": sum(e["bytes"] for e in kinds.values()),
            "count": sum(e["count"] for e in kinds.values()),
            "kinds": kinds, "axes": axes}


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _words(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as int32 words (zero-padded to a whole word)."""
    flat = t.contiguous().reshape(-1).view(torch.uint8)
    pad = (-flat.numel()) % 4
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(torch.int32)


def all_gather(t: torch.Tensor, group, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in group-rank order
    (the mesh coordinate along ``axis``); bit-exact on every backend."""
    n = _size(group)
    if n == 1:
        return t
    t = t.detach().contiguous()
    _count("all-gather", axis, t.numel() * t.element_size() * n)
    if t.is_cuda and _gloo(group):
        words = _words(t)
        buf = torch.zeros((n, words.numel()), dtype=torch.int32,
                          device=t.device)
        buf[dist.get_rank(group)] = words
        dist.all_reduce(buf, group=group)
        nbytes = t.numel() * t.element_size()
        parts = [buf[i].view(torch.uint8)[:nbytes].view(t.dtype)
                 .reshape(t.shape) for i in range(n)]
    elif dist.get_backend(group) == "nccl":
        out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
        parts = list(out.unbind(0))
    else:
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce(t: torch.Tensor, group, axis: str, op: str = "sum"
               ) -> torch.Tensor:
    """A reduced copy of ``t`` over the group (``op`` "sum" or "max")."""
    if _size(group) == 1:
        return t
    out = t.detach().clone().contiguous()
    _count("all-reduce", axis, out.numel() * out.element_size())
    dist.all_reduce(out, op=(dist.ReduceOp.MAX if op == "max"
                             else dist.ReduceOp.SUM), group=group)
    return out


def broadcast(t: torch.Tensor, group, axis: str, src: int = 0
              ) -> torch.Tensor:
    """``t`` from global rank ``src``, in place on the other ranks."""
    if _size(group) == 1:
        return t
    _count("broadcast", axis, t.numel() * t.element_size())
    dist.broadcast(t, src=src, group=group)
    return t


def broadcast_object(obj, src: int = 0):
    """A picklable object from global rank ``src`` over the world."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    _count("broadcast", "world", 0)
    return box[0]


def local_slice(t: torch.Tensor, dim: int, index: int, parts: int
                ) -> torch.Tensor:
    """Slice ``index`` of ``parts`` equal slices of ``t`` along ``dim``."""
    size = t.shape[dim] // parts
    return t[(slice(None),) * dim + (slice(index * size,
                                           (index + 1) * size),)]


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, axis, dim)

    @staticmethod
    def backward(ctx, g):
        n = _size(ctx.group)
        return (local_slice(g, ctx.dim, dist.get_rank(ctx.group), n)
                .contiguous(), None, None, None)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        return all_reduce(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def gather(x: torch.Tensor, group, axis: str, dim: int) -> torch.Tensor:
    """Differentiable all-gather along ``dim`` (module docstring)."""
    if _size(group) == 1:
        return x
    if not x.requires_grad:
        return all_gather(x, group, axis, dim)
    return _Gather.apply(x, group, axis, dim)


def copy_to(x: torch.Tensor, group, axis: str) -> torch.Tensor:
    """Megatron's f over ``group``."""
    if _size(group) == 1 or not torch.is_grad_enabled():
        return x
    return _CopyTo.apply(x, group, axis)


def reduce_from(x: torch.Tensor, group, axis: str) -> torch.Tensor:
    """Megatron's g over ``group``."""
    if _size(group) == 1:
        return x
    if not (x.requires_grad and torch.is_grad_enabled()):
        return all_reduce(x, group, axis)
    return _ReduceFrom.apply(x, group, axis)
