"""The port's hand-written CUDA kernels, their wrappers, their plain
PyTorch versions and the autograd Functions that pair a forward kernel
with its backward (counterpart of the kernels of
``paddle_tpu/ops/pallas_kernels.py`` on the serving and training paths).

=======================  ========================  ===========================
wrapper                  CUDA source (ops/csrc)    replaces (Pallas kernel)
=======================  ========================  ===========================
`paged_attention`        paged_attention.cu        ``_paged_attn_kernel``
`flash_attention_fwd`    flash_attention.cu        ``_flash_kernel``
`flash_attention_bwd`    flash_attention_bwd.cu    ``_flash_bwd_dq_kernel``,
                                                   ``_flash_bwd_dkv_kernel``
`layer_norm_fwd`         layer_norm.cu             ``_ln_fwd_kernel``
`layer_norm_bwd`         layer_norm_bwd.cu         ``_ln_bwd_kernel``
`softmax_xent_fwd`       softmax_xent.cu           ``_sm_xent_fwd_kernel``
`softmax_xent_bwd`       softmax_xent.cu           ``_sm_xent_bwd_kernel``
`batch_norm_bwd`         batch_norm_bwd.cu         ``_bn_bwd_kernel``
`lstm_fwd`               lstm.cu                   ``_lstm_fwd_kernel``
`lstm_bwd`               lstm.cu                   ``_lstm_bwd_kernel``
`gru_fwd`                gru.cu                    ``_gru_fwd_kernel``
`gru_bwd`                gru.cu                    ``_gru_bwd_kernel``
`row_stable_mm`          row_stable_mm.cu          none: XLA's per-op f32 dot
                                                   of ``numerics="exact"``
=======================  ========================  ===========================

Each source's header comment says what bounds the kernel on the H100
and what its design does about it.

The two flash sources run every product on the tensor cores
(``mma.sync``, building blocks in ``csrc/flash_mma.cuh``): bf16 inputs in
bf16 with f32 accumulators, rounding p and ds to bf16 only as the
operands of their products (as ``_reference_attention`` rounds p; the
plain versions and the Pallas kernels keep them in f32); f32 inputs in
3xTF32 (each operand split into a tf32 high and low part, three products
summed in f32), which keeps f32's accuracy without the TF32 rounding the
port turns off elsewhere.

Paged attention splits each slot's positions over blocks and merges
them in a second kernel (flash-decoding); the LayerNorm forward and
backward keep a row of up to 1024 features in one warp's registers (the
backward's warps walk the rows of a one-wave grid and sum dscale and dbias
of their columns in registers).  `paged_geometry`, `layer_norm_geometry`
and `layer_norm_bwd_geometry` pick their launch shapes.  The BatchNorm
backward streams x and dy twice with 16-byte loads in a grid of one wave
of resident blocks (`bn_bwd_geometry`, from the library's occupancy
query).  The LSTM and GRU backward run their gates and dw products as
tiled tensor-core products around the serial recurrence, which forms
dh_prev each step from partial sums the blocks exchange (one exchange a
step for the LSTM, two for the GRU); the LSTM and GRU forward stage each
step product's operand (h_prev; the GRU's r * h_prev too) with 16-byte
copies and split the product over the warps on the tensor cores (bf16
for a bf16 w, 3xTF32 for f32).  `row_stable_mm` is the exact decode
path's product: each output element summed over k in one order with
separately rounded multiplies and adds, so a row's bits do not depend on
M (the plain version does the same arithmetic, so the two agree bit for
bit); a small-M tile code (a block a strip of columns over all rows)
and a large-M one (128 x 128 tiles) share that arithmetic, and
`row_stable_mm_geometry` picks between them by M and the strip by N.

A wrapper takes the plain version only for tensors on the CPU.  For CUDA
tensors it checks device, dtype, shape and contiguity, launches its
kernel on the current stream (no allocation inside the kernel, no
synchronisation) and raises if the launch reports an error — there is no
fallback.  Each launch adds one to the kernel's ``launches`` count
(`KERNELS`), so a run can show that its main path went through the
kernels; a kernel with more than one tile code also counts each code's
launches (``path_launches``): the attention kernels by head-dim code
(`head_dim_code`), the recurrent ones by path (`recurrent_path`:
"persistent" or "stepwise"), the row-stable product by tile code.
The flash kernels also add their product flops to the open
`kernel_flops` tallies of the launching thread, which
``torch.utils.flop_counter.FlopCounterMode`` cannot see (a ctypes launch
is no aten op).  The plain versions are what the CPU tests
hold against the JAX package and what ``chip_smoke.py`` holds each
kernel against on the card.
They compute in f32, or in f64 for f64 inputs (``gradcheck``).

`FlashAttention`, `LayerNorm`, `SoftmaxXent`, `BatchNormTrain`,
`FusedLSTM` and `FusedGRU` are the ``torch.autograd.Function``s of the
training paths (the counterparts of the JAX package's ``custom_vjp``s):
forward through the forward wrapper (plain torch for BatchNorm, whose
forward the JAX package leaves to XLA), backward through the backward
wrapper, so the same autograd wiring runs the kernels on the card and the
plain versions on the CPU.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import threading
from typing import Tuple

import torch

from . import _build


class Kernel:
    """One CUDA kernel: where it lives, what it replaces, and how often the
    wrapper has launched it (a plain integer, counted under a lock: the
    serving engines launch from several threads at once)."""

    _count_lock = threading.Lock()

    def __init__(self, name: str, source: str, entry: str, replaces: str,
                 argtypes, paths: Tuple[str, ...] = ()):
        self.name = name
        self.source = source
        self.entry = entry
        self.replaces = replaces
        self.argtypes = argtypes
        self.launches = 0
        #: launches by tile code, for a kernel with more than one
        self.path_launches = dict.fromkeys(paths, 0)
        self._fn = None

    def launch(self, *args, path: str = None, flops: int = 0):
        if self._fn is None:
            fn = getattr(_build.load(self.source), self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc == _COOPERATIVE_TOO_LARGE:
            raise RuntimeError(
                f"{self.name}: this shape cannot be placed on the card: the "
                "kernel's grid-wide barrier needs every block resident at "
                "once, and its blocks do not fit (cooperative launch too "
                "large)")
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {rc}")
        with self._count_lock:
            self.launches += 1
            if path is not None:
                self.path_launches[path] += 1
        for tally in getattr(_flop_tallies, "open", ()):
            tally[0] += flops


#: cudaErrorCooperativeLaunchTooLarge (its value since CUDA 10), returned
#: by the recurrent kernels when their grid cannot be co-resident
_COOPERATIVE_TOO_LARGE = 720


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float

#: the head-dim codes the attention kernels are compiled for (`head_dim_code`)
HEAD_DIM_CODES = (16, 32, 64, 128)
_HEAD_DIM_PATHS = tuple(f"d{c}" for c in HEAD_DIM_CODES)

PAGED_ATTENTION = Kernel(
    "paged_attention", "paged_attention", "ptt_paged_attention",
    "paddle_tpu/ops/pallas_kernels.py:704 _paged_attn_kernel",
    [_P] * 7 + [_I] * 9 + [_F, _I, _P], paths=_HEAD_DIM_PATHS)
FLASH_ATTENTION_FWD = Kernel(
    "flash_attention_fwd", "flash_attention", "ptt_flash_attention_fwd",
    "paddle_tpu/ops/pallas_kernels.py:54 _flash_kernel",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    paths=_HEAD_DIM_PATHS)
LAYER_NORM_FWD = Kernel(
    "layer_norm_fwd", "layer_norm", "ptt_layer_norm_fwd",
    "paddle_tpu/ops/pallas_kernels.py:1388 _ln_fwd_kernel",
    [_P] * 6 + [_I, _I, _F, _I, _I, _I, _P])
FLASH_ATTENTION_BWD = Kernel(
    "flash_attention_bwd", "flash_attention_bwd", "ptt_flash_attention_bwd",
    "paddle_tpu/ops/pallas_kernels.py:274 _flash_backward "
    "(:164 _flash_bwd_dq_kernel, :217 _flash_bwd_dkv_kernel)",
    [_P] * 10 + [_I, _I, _I, _I, _I, _F, _I, _P], paths=_HEAD_DIM_PATHS)
LAYER_NORM_BWD = Kernel(
    "layer_norm_bwd", "layer_norm_bwd", "ptt_layer_norm_bwd",
    "paddle_tpu/ops/pallas_kernels.py:1437 _ln_bwd_kernel",
    [_P] * 9 + [_I] * 6 + [_P])
SOFTMAX_XENT_FWD = Kernel(
    "softmax_xent_fwd", "softmax_xent", "ptt_softmax_xent_fwd",
    "paddle_tpu/ops/pallas_kernels.py:1634 _sm_xent_fwd_kernel",
    [_P, _P, _P, _P, _I, _I, _I, _P])
SOFTMAX_XENT_BWD = Kernel(
    "softmax_xent_bwd", "softmax_xent", "ptt_softmax_xent_bwd",
    "paddle_tpu/ops/pallas_kernels.py:1671 _sm_xent_bwd_kernel",
    [_P, _P, _P, _P, _P, _I, _I, _I, _P])

BATCH_NORM_BWD = Kernel(
    "batch_norm_bwd", "batch_norm_bwd", "ptt_batch_norm_bwd",
    "paddle_tpu/ops/pallas_kernels.py:1277 _bn_bwd_kernel "
    "(bn_bwd_onepass :1798)",
    [_P] * 10 + [_L] + [_I] * 10 + [_P])

#: the two paths of the recurrent kernels (`recurrent_path`)
RECURRENT_PATHS = ("persistent", "stepwise")

LSTM_FWD = Kernel(
    "lstm_fwd", "lstm", "ptt_lstm_fwd",
    "paddle_tpu/ops/pallas_kernels.py:853 _lstm_fwd_kernel "
    "(_lstm_pallas_fwd :944)",
    [_P] * 8 + [_I] * 5 + [_P], paths=RECURRENT_PATHS)
LSTM_BWD = Kernel(
    "lstm_bwd", "lstm", "ptt_lstm_bwd",
    "paddle_tpu/ops/pallas_kernels.py:885 _lstm_bwd_kernel "
    "(_lstm_pallas_bwd :979)",
    [_P] * 15 + [_I] * 6 + [_P], paths=RECURRENT_PATHS)
GRU_FWD = Kernel(
    "gru_fwd", "gru", "ptt_gru_fwd",
    "paddle_tpu/ops/pallas_kernels.py:1078 _gru_fwd_kernel "
    "(_gru_pallas_fwd :1164)",
    [_P] * 8 + [_I] * 5 + [_P], paths=RECURRENT_PATHS)
GRU_BWD = Kernel(
    "gru_bwd", "gru", "ptt_gru_bwd",
    "paddle_tpu/ops/pallas_kernels.py:1104 _gru_bwd_kernel "
    "(_gru_pallas_bwd :1189)",
    [_P] * 13 + [_I] * 6 + [_P], paths=RECURRENT_PATHS)

ROW_STABLE_MM = Kernel(
    "row_stable_mm", "row_stable_mm", "ptt_row_stable_mm",
    "none (no Pallas kernel): the f32 dots of numerics='exact', which XLA "
    "CPU runs op by op (paddle_tpu/serving/decode_engine.py:54 "
    "_GenPredictor)",
    [_P] * 4 + [_I] * 4 + [_P], paths=("small", "large"))

KERNELS = (PAGED_ATTENTION, FLASH_ATTENTION_FWD, FLASH_ATTENTION_BWD,
           LAYER_NORM_FWD, LAYER_NORM_BWD, SOFTMAX_XENT_FWD,
           SOFTMAX_XENT_BWD, BATCH_NORM_BWD, LSTM_FWD, LSTM_BWD, GRU_FWD,
           GRU_BWD, ROW_STABLE_MM)

_FLOAT_TYPES = (torch.float32, torch.bfloat16)


def head_dim_code(d: int) -> int:
    """The compiled code of the flash and paged-attention kernels that
    runs head dim ``d``: the least of `HEAD_DIM_CODES` at or above ``d``,
    for ``d`` a multiple of 8 from 8 to 128 (the kernels zero-fill the
    columns past ``d`` in shared memory and store only ``d``; common.cuh
    ``head_dim_code`` is the same map).  Raises ValueError for any other
    ``d``: a multiple of 8 keeps every row 16-byte aligned in f32 and
    bf16, which the kernels' 16-byte copies need."""
    if d % 8 or not 8 <= d <= HEAD_DIM_CODES[-1]:
        raise ValueError(f"head_dim {d}: the attention kernels take a "
                         f"multiple of 8 from 8 to {HEAD_DIM_CODES[-1]}")
    return next(c for c in HEAD_DIM_CODES if c >= d)


#: each thread's open `kernel_flops` tallies
_flop_tallies = threading.local()


@contextlib.contextmanager
def kernel_flops():
    """Tally the product flops of the kernels this thread launches inside
    the block: yields a one-item list whose item is the running total.
    The flash kernels report theirs (`flash_attention_flops`); on CPU
    tensors the wrappers run their plain versions, which launch nothing
    and whose aten products ``FlopCounterMode`` counts."""
    tally = [0]
    if not hasattr(_flop_tallies, "open"):
        _flop_tallies.open = []
    _flop_tallies.open.append(tally)
    try:
        yield tally
    finally:
        _flop_tallies.open.remove(tally)


def flash_attention_pairs(tq: int, tk: int, causal: bool) -> int:
    """The (query, key) pairs attention computes: all ``tq * tk``, or
    under the bottom-right aligned causal mask (query i sees
    ``clamp(i + tk - tq + 1, 0, tk)`` keys) their sum."""
    if not causal:
        return tq * tk
    off = tk - tq + 1
    lo = min(max(-off, 0), tq)          # rows before lo see no key
    hi = min(max(tk - off, lo), tq)     # rows from hi on see all tk
    return (hi - lo) * (lo + hi - 1 + 2 * off) // 2 + (tq - hi) * tk


def flash_attention_flops(bh: int, tq: int, tk: int, d: int, causal: bool,
                          backward: bool = False) -> int:
    """The flash kernels' product flops over ``bh`` batch-heads: forward
    S = QK^T and PV (4 a pair and feature), backward S again, dO V^T,
    P^T dO, dS K and dS^T Q (10)."""
    return (10 if backward else 4) * bh * flash_attention_pairs(
        tq, tk, causal) * d


def reset_launches():
    with Kernel._count_lock:
        for k in KERNELS:
            k.launches = 0
            k.path_launches = dict.fromkeys(k.path_launches, 0)


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the plain versions' accumulation dtype: f64 stays f64
    (``gradcheck``), anything else computes in f32."""
    return t.double() if t.dtype == torch.float64 else t.float()


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s card, straight
    from PyTorch's C side: `torch.cuda.current_stream` builds a Python
    Stream object first, several us a call on the H100's host
    (PERF.md)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_cuda(name: str, *tensors: torch.Tensor):
    dev = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{tensors[0].device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is "
                             "not contiguous")


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

def gather_slot_kv(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[N, L, H, D] pool + [S, P] table -> [S, H, P*L, D] per-slot keys in
    position order; sentinel ids clamp to the last block (the JAX
    package's ``mode="clip"``)."""
    s, p = table.shape
    n, block_len = pool.shape[0], pool.shape[1]
    ids = table.long().clamp(0, n - 1).reshape(-1)
    g = pool.index_select(0, ids).reshape((s, p * block_len) + pool.shape[2:])
    return g.transpose(1, 2)


def paged_attention_plain(q, pool_k, pool_v, table, index):
    """Plain version: gather each slot's pages, attend positions
    0..Index[s] in f32.  A slot with no live position gives 0."""
    s, _, _, d = q.shape
    k = gather_slot_kv(pool_k, table).float()            # [S, H, T, D]
    v = gather_slot_kv(pool_v, table).float()
    t_tot = k.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) / math.sqrt(d)
    live = (torch.arange(t_tot, device=q.device)[None, :]
            <= index.reshape(s, 1).long())                  # [S, T]
    scores = scores.masked_fill(~live[:, None, None, :], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v)
    out = torch.where(live.any(-1)[:, None, None, None], out,
                      torch.zeros((), device=q.device))
    return out.to(q.dtype)


#: the split-K paged-attention kernel (csrc/paged_attention.cu): the
#: positions one split block covers, at most and at least (the wrapper
#: halves the first towards the second while the grid holds fewer than
#: two blocks per SM of the H100's 132), and the 16-byte chunks of one
#: position's row a lane holds at most (kChunks)
_PAGED_SPLIT_MAX, _PAGED_SPLIT_MIN = 64, 16
_PAGED_MIN_BLOCKS = 2 * 132
_PAGED_LANE_CHUNKS = 4


@functools.lru_cache(maxsize=None)
def paged_geometry(slots: int, heads: int, head_dim: int, pages: int,
                   block_len: int, itemsize: int) -> Tuple[int, int, int,
                                                           int]:
    """Launch geometry of the split-K paged-attention kernel -> (split,
    n_splits, heads_per_block, scratch_floats).  A split block covers
    ``split`` positions of one slot for ``heads_per_block`` heads; the
    grid covers the table's capacity (``pages * block_len``) in
    ``n_splits`` splits, since the host does not read ``index``.  Heads
    are grouped so that a lane holds at most ``_PAGED_LANE_CHUNKS``
    16-byte chunks of a position's row.  The scratch holds each split's
    f32 accumulator row and (m, l) pair per head."""
    capacity = pages * block_len
    lanes_per_head = head_dim * itemsize // 16
    groups = -(-heads * lanes_per_head // (32 * _PAGED_LANE_CHUNKS))
    split = _PAGED_SPLIT_MAX
    while split > _PAGED_SPLIT_MIN and \
            slots * groups * -(-capacity // split) < _PAGED_MIN_BLOCKS:
        split //= 2
    n_splits = -(-capacity // split)
    return (split, n_splits, -(-heads // groups),
            slots * n_splits * heads * (head_dim + 2))


def paged_attention(q: torch.Tensor, pool_k: torch.Tensor,
                    pool_v: torch.Tensor, table: torch.Tensor,
                    index: torch.Tensor) -> torch.Tensor:
    """One decode query per slot over its paged prefix: q [S, H, 1, D],
    pools [N, L, H, D], table [S, P] int32, index [S] int32 (the query's
    position; it sees positions 0..Index[s]) -> [S, H, 1, D].  On the
    card: split-K over each slot's positions (`paged_geometry`), q and
    the pools 16-byte aligned; head dim ``d`` runs the code
    `head_dim_code` (its launches counted by code in
    ``PAGED_ATTENTION.path_launches``); a call repeats bit for bit."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, pool_k, pool_v, table, index)
    s, h, one, d = q.shape
    n, block_len = pool_k.shape[0], pool_k.shape[1]
    if one != 1 or pool_k.shape[2:] != (h, d) or pool_v.shape != pool_k.shape:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} and pools "
                         f"{tuple(pool_k.shape)}/{tuple(pool_v.shape)}")
    if table.dim() != 2 or table.shape[0] != s or index.shape != (s,):
        raise ValueError(f"paged_attention: table {tuple(table.shape)} / "
                         f"index {tuple(index.shape)} for {s} slots")
    if q.dtype not in _FLOAT_TYPES or pool_k.dtype != q.dtype \
            or pool_v.dtype != q.dtype:
        raise ValueError(f"paged_attention: dtypes {q.dtype}/{pool_k.dtype}"
                         f"/{pool_v.dtype}")
    if table.dtype != torch.int32 or index.dtype != torch.int32:
        raise ValueError("paged_attention: table and index must be int32")
    code = head_dim_code(d)
    _check_cuda("paged_attention", q, pool_k, pool_v, table, index)
    ptrs = (q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr())
    if (ptrs[0] | ptrs[1] | ptrs[2]) & 15:
        raise ValueError("paged_attention: q and the pools must be 16-byte "
                         "aligned")
    pages = table.shape[1]
    split, n_splits, heads_per_block, floats = paged_geometry(
        s, h, code, pages, block_len, q.element_size())
    out = torch.empty_like(q)
    scratch = torch.empty(floats, dtype=torch.float32, device=q.device)
    PAGED_ATTENTION.launch(
        *ptrs, table.data_ptr(), index.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), s, h, d, n, block_len, pages, split, n_splits,
        heads_per_block, 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16), _stream(q), path=f"d{code}")
    return out


# ---------------------------------------------------------------------------
# FlashAttention-2 forward and backward
# ---------------------------------------------------------------------------

def flash_attention_fwd_plain(q, k, v, causal=False):
    """Plain version: f32 scores, bottom-right aligned causal mask, lse per
    row; a fully masked row gives out 0 and lse -inf."""
    d = q.shape[-1]
    tq, tk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", _acc(q), _acc(k)) / math.sqrt(d)
    if causal:
        mask = torch.ones(tq, tk, dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)                         # [B, H, Tq]
    live = torch.isfinite(lse)[..., None]
    p = torch.where(live, torch.exp(s - lse[..., None]),
                    torch.zeros((), device=q.device))
    out = torch.einsum("bhqk,bhkd->bhqd", p, _acc(v))
    return out.to(q.dtype), lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over [B, H, T, D] -> (out [B, H, Tq, D] in q's dtype,
    lse [B, H, Tq] f32).  Causal masking is bottom-right aligned (key j
    visible to query i when j <= i + Tk - Tq); any Tq, Tk work.  On the
    card: bf16 products with p rounded to bf16 for P.V, or 3xTF32 for
    f32 (module docstring); inputs 16-byte aligned; head dim ``d`` runs
    the code `head_dim_code` (launches counted by code in
    ``path_launches``); any number of batch-heads (the kernel takes them
    65535 at a time)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if q.dtype not in _FLOAT_TYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_fwd: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    code = head_dim_code(d)
    _check_cuda("flash_attention_fwd", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    FLASH_ATTENTION_FWD.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b * h, tq, tk, d, int(bool(causal)),
        1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16), _stream(q),
        path=f"d{code}", flops=flash_attention_flops(b * h, tq, tk, d,
                                                      causal))
    return out, lse


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=False):
    """Plain version: p recomputed from the saved lse (0 where masked and
    on fully masked rows), delta = rowsum(dO * O), then
    ds = p * (dO V^T - delta) / sqrt(D); dq = ds K, dk = ds^T Q,
    dv = p^T dO."""
    d = q.shape[-1]
    tq, tk = q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, of, gf = (_acc(t) for t in (q, k, v, out, dout))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal:
        mask = torch.ones(tq, tk, dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        s = s.masked_fill(~mask, float("-inf"))
    lse = _acc(lse)
    live = torch.isfinite(lse)[..., None]
    p = torch.where(live, torch.exp(s - torch.where(live, lse[..., None],
                                                    torch.zeros_like(
                                                        lse[..., None]))),
                    torch.zeros((), dtype=s.dtype, device=q.device))
    delta = (gf * of).sum(-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of `flash_attention_fwd`: from q, k, v, its out and lse
    ([B, H, Tq] f32) and dO (shaped like out) -> (dq, dk, dv) in the
    inputs' dtype.  Same masking contract and numerics as the forward (p
    and ds rounded to bf16 as product operands for bf16); no atomics, so
    a launch repeats bit for bit."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape != k.shape \
            or out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} out "
                         f"{tuple(out.shape)} dout {tuple(dout.shape)}")
    if lse.shape != (b, h, tq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype}, want ({b}, {h}, {tq}) float32")
    if q.dtype not in _FLOAT_TYPES or any(
            t.dtype != q.dtype for t in (k, v, out, dout)):
        raise ValueError(f"flash_attention_bwd: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}/{out.dtype}/{dout.dtype}")
    code = head_dim_code(d)
    _check_cuda("flash_attention_bwd", q, k, v, out, lse, dout)
    delta = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    FLASH_ATTENTION_BWD.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b * h, tq, tk, d, int(bool(causal)),
        1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16), _stream(q),
        path=f"d{code}", flops=flash_attention_flops(b * h, tq, tk, d,
                                                      causal, backward=True))
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the row-stable product of numerics="exact"
# ---------------------------------------------------------------------------

def row_stable_mm_plain(x, w, bias=None):
    """Plain version: ``x [M, K] . w [K, N] (+ bias [N])`` in f32 as K
    elementwise multiply-adds, ``acc = acc + x[:, k] * w[k]`` in order of
    k from zero, then ``+ bias``: each product and sum rounded on its own,
    so a row's result depends on that row alone, on any device."""
    xf, wf = x.float(), w.float()
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    prod = torch.empty_like(acc)
    for k in range(x.shape[1]):
        torch.mul(xf[:, k:k + 1], wf[k:k + 1], out=prod)
        acc.add_(prod)
    return acc if bias is None else acc.add_(bias.float())


#: the row-stable product's small-M code (csrc/row_stable_mm.cu) takes
#: M up to ROW_STABLE_SMALL_M rows, the most it holds (on the H100 it
#: beats the 128 x 128 code at every M it takes: PERF.md), in strips of
#: 8, 16 or 32 columns a block
ROW_STABLE_SMALL_M = 64
_ROW_STABLE_STRIPS = (32, 16, 8)


@functools.lru_cache(maxsize=None)
def row_stable_mm_geometry(m: int, n: int, sms: int) -> int:
    """The columns a block of `row_stable_mm` owns for an [M, N] output
    on a card of ``sms`` SMs: 0 for the 128 x 128 code, above
    ROW_STABLE_SMALL_M rows; for the small-M code (a block a strip of
    columns over all rows) the widest strip that still gives half the SMs
    a block.  Both codes do each element's arithmetic alike, so the
    choice never moves a bit.  A wider strip reads each row of w in
    longer runs (128 bytes at 32 columns), which an SM streams about
    three times faster than 32-byte runs; a narrower one spreads a small
    N over more SMs, which a long K needs (measured on the H100 with
    ``row_stable_builds.py``: PERF.md)."""
    if m > ROW_STABLE_SMALL_M:
        return 0
    return next((s for s in _ROW_STABLE_STRIPS if 2 * -(-n // s) >= sms),
                _ROW_STABLE_STRIPS[-1])


def row_stable_mm(x: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor = None) -> torch.Tensor:
    """``x [M, K] . w [K, N] (+ bias [N])`` -> f32 ``[M, N]``, every
    element summed over k in one fixed order with separately rounded
    multiplies and adds: bit for bit `row_stable_mm_plain`, whatever M.
    On the card: f32, contiguous, 16-byte aligned, K and N multiples of
    4; the tile code and strip by `row_stable_mm_geometry`, each code's
    launches counted in ``ROW_STABLE_MM.path_launches``."""
    if x.device.type == "cpu":
        return row_stable_mm_plain(x, w, bias)
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1] or (
            bias is not None and bias.shape != (w.shape[1],)):
        raise ValueError(f"row_stable_mm: x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} bias "
                         f"{None if bias is None else tuple(bias.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if any(t.dtype != torch.float32 for t in (x, w)) or (
            bias is not None and bias.dtype != torch.float32):
        raise ValueError("row_stable_mm: operands must be float32")
    if k % 4 or n % 4:
        raise ValueError(f"row_stable_mm: K={k} and N={n} must be "
                         "multiples of 4")
    # the large code's grid holds a 128-row tile a block in y
    if m > 65535 * 128:
        raise ValueError(f"row_stable_mm: M={m} rows exceed the grid")
    tensors = (x, w) if bias is None else (x, w, bias)
    _check_cuda("row_stable_mm", *tensors)
    if (x.data_ptr() | w.data_ptr()) & 15:
        raise ValueError("row_stable_mm: x and w must be 16-byte aligned")
    strip = row_stable_mm_geometry(m, n, _sm_count(x.get_device()))
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    ROW_STABLE_MM.launch(x.data_ptr(), w.data_ptr(),
                         None if bias is None else bias.data_ptr(),
                         out.data_ptr(), m, n, k, strip, _stream(x),
                         path="small" if strip else "large")
    return out


# ---------------------------------------------------------------------------
# LayerNorm forward and backward
# ---------------------------------------------------------------------------

def layer_norm_fwd_plain(x2, scale, bias, eps=1e-5):
    """Plain version: two-pass f32 statistics over [R, F] rows."""
    xf = _acc(x2)
    mean = xf.mean(dim=1)
    var = (xf - mean[:, None]).square().mean(dim=1)
    y = (xf - mean[:, None]) * torch.rsqrt(var + eps)[:, None]
    y = y * _acc(scale)[None, :] + _acc(bias)[None, :]
    return y.to(x2.dtype), mean, var


#: the LayerNorm forward (csrc/layer_norm.cu): the longest row of the
#: warp-per-row kernel, and the shared memory a block-per-row kernel may
#: use to keep its row (the default limit, no opt-in needed)
_LN_WARP_MAX_F = 1024
_LN_ROW_CACHE_BYTES = 48 * 1024


@functools.lru_cache(maxsize=None)
def layer_norm_geometry(features: int, itemsize: int,
                        aligned: bool = True) -> Tuple[int, int]:
    """Launch geometry of the LayerNorm forward -> (block_threads,
    cache_bytes).  (0, 0) takes the warp-per-row kernel: rows of at most
    1024 features in whole 16-byte chunks, with every pointer 16-byte
    aligned.  Any other row takes one block of 256 threads (128 under
    1024 features), which keeps the row in ``cache_bytes`` of shared
    memory when it fits (0: re-read through L2)."""
    row = features * itemsize
    if features <= _LN_WARP_MAX_F and row % 16 == 0 and aligned:
        return 0, 0
    return (256 if features >= 1024 else 128,
            row if row <= _LN_ROW_CACHE_BYTES else 0)


def layer_norm_fwd(x2: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LayerNorm over [R, F] rows -> (y in x's dtype, mean [R] f32,
    var [R] f32); scale and bias are f32 [F]."""
    if x2.device.type == "cpu":
        return layer_norm_fwd_plain(x2, scale, bias, eps)
    if x2.dim() != 2:
        raise ValueError(f"layer_norm_fwd: x must be [R, F], got "
                         f"{tuple(x2.shape)}")
    r, f = x2.shape
    if scale.shape != (f,) or bias.shape != (f,):
        raise ValueError(f"layer_norm_fwd: scale {tuple(scale.shape)} / "
                         f"bias {tuple(bias.shape)} for F={f}")
    if x2.dtype not in _FLOAT_TYPES or scale.dtype != torch.float32 \
            or bias.dtype != torch.float32:
        raise ValueError(f"layer_norm_fwd: dtypes {x2.dtype}/{scale.dtype}/"
                         f"{bias.dtype}")
    _check_cuda("layer_norm_fwd", x2, scale, bias)
    xp, sp, bp = x2.data_ptr(), scale.data_ptr(), bias.data_ptr()
    threads, cache = layer_norm_geometry(f, x2.element_size(),
                                         not (xp | sp | bp) & 15)
    y = torch.empty_like(x2)
    mean = torch.empty(r, dtype=torch.float32, device=x2.device)
    var = torch.empty(r, dtype=torch.float32, device=x2.device)
    LAYER_NORM_FWD.launch(xp, sp, bp, y.data_ptr(), mean.data_ptr(),
                          var.data_ptr(), r, f, float(eps), threads, cache,
                          int(x2.dtype == torch.bfloat16), _stream(x2))
    return y, mean, var


#: the LayerNorm backward (csrc/layer_norm_bwd.cu): rows (warps) of a
#: warp-per-row block, and the largest F whose [2, F] f32 accumulator fits
#: a block-per-row block's shared memory
_LN_ROW_WARPS = 8
_LN_BWD_MAX_F = 227 * 1024 // 8


def layer_norm_bwd_path(features: int, itemsize: int,
                       aligned: bool) -> Tuple[int, int]:
    """Path of the LayerNorm backward -> (warp, vec).  warp 1 takes the
    warp-per-row kernel: rows of at most 1024 features in whole 16-byte
    chunks with every pointer 16-byte ``aligned`` (as the forward's
    `layer_norm_geometry`); any other row takes one block of 256 threads
    a row.  ``vec`` is the elements a thread loads at once: 16 bytes'
    worth, or 1 when the row is not in whole chunks or a pointer is
    misaligned."""
    chunked = features * itemsize % 16 == 0 and aligned
    return (int(chunked and features <= _LN_WARP_MAX_F),
            16 // itemsize if chunked else 1)


def layer_norm_bwd_geometry(rows: int, features: int, itemsize: int,
                            aligned: bool, per_sm: int, sms: int
                            ) -> Tuple[int, int, int]:
    """Launch geometry of the LayerNorm backward -> (warp, vec, blocks):
    the path (`layer_norm_bwd_path`) and a grid of one wave of what the
    card holds (``per_sm`` blocks of the path's kernel on each of ``sms``
    SMs), but no more blocks than there is work: the warp path's blocks
    take ``_LN_ROW_WARPS`` rows at once, the block path's one.  Each
    walker (warp w of block k, the (k * _LN_ROW_WARPS + w)th, on the warp
    path; block k on the block path) takes a run of ceil(rows / walkers)
    consecutive rows."""
    warp, vec = layer_norm_bwd_path(features, itemsize, aligned)
    work = -(-rows // _LN_ROW_WARPS) if warp else rows
    return warp, vec, max(1, min(per_sm * sms, work))


@functools.lru_cache(maxsize=None)
def _ln_bwd_launch(rows: int, features: int, itemsize: int, aligned: bool,
                   device: int) -> Tuple[int, int, int]:
    """`layer_norm_bwd_geometry` on card ``device``, with the blocks of
    the path's kernel one SM holds at once from the library
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    warp, vec = layer_norm_bwd_path(features, itemsize, aligned)
    fn = _build.load(LAYER_NORM_BWD.source).ptt_layer_norm_bwd_residency
    fn.argtypes = [_I] * 4 + [_P]
    fn.restype = ctypes.c_int
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(features, warp, vec, int(itemsize == 2),
                ctypes.byref(per_sm))
    if rc != 0 or per_sm.value < 1:
        raise RuntimeError(f"layer_norm_bwd residency query failed: CUDA "
                           f"error {rc}, {per_sm.value} blocks")
    return layer_norm_bwd_geometry(rows, features, itemsize, aligned,
                                   per_sm.value, _sm_count(device))


def layer_norm_bwd_plain(x2, scale, mean, inv, dy):
    """Plain version: closed-form dx from the saved f32 mean and inv;
    dscale and dbias summed over rows in f32."""
    xf, g = _acc(x2), _acc(dy)
    mean, inv = _acc(mean), _acc(inv)
    xn = (xf - mean[:, None]) * inv[:, None]
    dbias = g.sum(dim=0)
    dscale = (g * xn).sum(dim=0)
    dxn = g * _acc(scale)[None, :]
    dx = inv[:, None] * (dxn - dxn.mean(dim=1, keepdim=True)
                         - xn * (dxn * xn).mean(dim=1, keepdim=True))
    return dx.to(x2.dtype), dscale, dbias


def layer_norm_bwd(x2: torch.Tensor, scale: torch.Tensor, mean: torch.Tensor,
                   inv: torch.Tensor, dy: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of `layer_norm_fwd` over [R, F] rows: x2 and dy in x's
    dtype, f32 scale [F], f32 mean and inv = rsqrt(var + eps) [R] ->
    (dx in x's dtype, dscale [F] f32, dbias [F] f32)."""
    if x2.device.type == "cpu":
        return layer_norm_bwd_plain(x2, scale, mean, inv, dy)
    if x2.dim() != 2 or dy.shape != x2.shape:
        raise ValueError(f"layer_norm_bwd: x {tuple(x2.shape)} and dy "
                         f"{tuple(dy.shape)} must be one [R, F] shape")
    r, f = x2.shape
    if scale.shape != (f,) or mean.shape != (r,) or inv.shape != (r,):
        raise ValueError(f"layer_norm_bwd: scale {tuple(scale.shape)}, mean "
                         f"{tuple(mean.shape)}, inv {tuple(inv.shape)} for "
                         f"[{r}, {f}]")
    if x2.dtype not in _FLOAT_TYPES or dy.dtype != x2.dtype or any(
            t.dtype != torch.float32 for t in (scale, mean, inv)):
        raise ValueError(f"layer_norm_bwd: dtypes {x2.dtype}/{dy.dtype}/"
                         f"{scale.dtype}/{mean.dtype}/{inv.dtype}")
    if f > _LN_BWD_MAX_F:
        raise ValueError(f"layer_norm_bwd: F {f} > {_LN_BWD_MAX_F}")
    _check_cuda("layer_norm_bwd", x2, scale, mean, inv, dy)
    dx = torch.empty_like(x2)
    ptrs = (x2.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr())
    warp, vec, blocks = _ln_bwd_launch(
        r, f, x2.element_size(),
        not (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) & 15, x2.get_device())
    part = torch.empty((2, blocks, f), dtype=torch.float32,
                       device=x2.device)
    # the kernel writes every element unless there are no rows to sum
    alloc = torch.empty if r else torch.zeros
    dscale = alloc(f, dtype=torch.float32, device=x2.device)
    dbias = alloc(f, dtype=torch.float32, device=x2.device)
    LAYER_NORM_BWD.launch(
        ptrs[0], ptrs[1], mean.data_ptr(), inv.data_ptr(), ptrs[2], ptrs[3],
        part.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), r, f, warp,
        vec, blocks, int(x2.dtype == torch.bfloat16), _stream(x2))
    return dx, dscale, dbias


# ---------------------------------------------------------------------------
# softmax cross-entropy (hard labels) forward and backward
# ---------------------------------------------------------------------------

def softmax_xent_fwd_plain(x2, labels):
    """Plain version: f32 logsumexp and gold logit per row; a label
    outside [0, V) picks gold 0."""
    v = x2.shape[1]
    xf = _acc(x2)
    lse = torch.logsumexp(xf, dim=1)
    lab = labels.long()
    valid = (lab >= 0) & (lab < v)
    gold = xf.gather(1, lab.clamp(0, v - 1)[:, None])[:, 0]
    gold = torch.where(valid, gold, torch.zeros_like(gold))
    return lse - gold, lse


def softmax_xent_fwd(x2: torch.Tensor, labels: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hard-label softmax cross-entropy over [R, V] logits and [R] labels
    (int32; int64 is cast) -> (loss [R] f32, lse [R] f32)."""
    if x2.device.type == "cpu":
        return softmax_xent_fwd_plain(x2, labels)
    if x2.dim() != 2 or labels.shape != (x2.shape[0],):
        raise ValueError(f"softmax_xent_fwd: logits {tuple(x2.shape)} and "
                         f"labels {tuple(labels.shape)}")
    if x2.dtype not in _FLOAT_TYPES:
        raise ValueError(f"softmax_xent_fwd: logits dtype {x2.dtype}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"softmax_xent_fwd: labels dtype {labels.dtype}")
    labels = labels.to(torch.int32).contiguous()
    _check_cuda("softmax_xent_fwd", x2, labels)
    r, v = x2.shape
    loss = torch.empty(r, dtype=torch.float32, device=x2.device)
    lse = torch.empty(r, dtype=torch.float32, device=x2.device)
    SOFTMAX_XENT_FWD.launch(
        x2.data_ptr(), labels.data_ptr(), loss.data_ptr(), lse.data_ptr(),
        r, v, int(x2.dtype == torch.bfloat16), _stream(x2))
    return loss, lse


def softmax_xent_bwd_plain(x2, labels, lse, dloss):
    """Plain version: (softmax - onehot) * dloss in x's dtype."""
    v = x2.shape[1]
    p = torch.exp(_acc(x2) - _acc(lse)[:, None])
    onehot = torch.arange(v, device=x2.device)[None, :] \
        == labels.long()[:, None]
    return ((p - onehot.to(p.dtype)) * _acc(dloss)[:, None]).to(x2.dtype)


def softmax_xent_bwd(x2: torch.Tensor, labels: torch.Tensor,
                     lse: torch.Tensor, dloss: torch.Tensor) -> torch.Tensor:
    """Gradient of `softmax_xent_fwd`'s loss: logits [R, V], labels [R],
    the saved lse [R] f32 and dloss [R] f32 -> dlogits [R, V] in the
    logits' dtype, with no probability tensor in between."""
    if x2.device.type == "cpu":
        return softmax_xent_bwd_plain(x2, labels, lse, dloss)
    r = x2.shape[0]
    if x2.dim() != 2 or labels.shape != (r,) or lse.shape != (r,) \
            or dloss.shape != (r,):
        raise ValueError(f"softmax_xent_bwd: logits {tuple(x2.shape)}, "
                         f"labels {tuple(labels.shape)}, lse "
                         f"{tuple(lse.shape)}, dloss {tuple(dloss.shape)}")
    if x2.dtype not in _FLOAT_TYPES or lse.dtype != torch.float32 \
            or dloss.dtype != torch.float32:
        raise ValueError(f"softmax_xent_bwd: dtypes {x2.dtype}/{lse.dtype}/"
                         f"{dloss.dtype}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"softmax_xent_bwd: labels dtype {labels.dtype}")
    labels = labels.to(torch.int32).contiguous()
    _check_cuda("softmax_xent_bwd", x2, labels, lse, dloss)
    v = x2.shape[1]
    dx = torch.empty_like(x2)
    SOFTMAX_XENT_BWD.launch(
        x2.data_ptr(), labels.data_ptr(), lse.data_ptr(), dloss.data_ptr(),
        dx.data_ptr(), r, v, int(x2.dtype == torch.bfloat16), _stream(x2))
    return dx


# ---------------------------------------------------------------------------
# BatchNorm training backward
# ---------------------------------------------------------------------------
#
# x and dy come as a [N', C, S] view: element (n, c, s) at n*C*S + c*S + s,
# so NHWC activations are (N*H*W, C, 1) and NCHW ones (N, C, H*W).

#: threads of a BatchNorm backward block (batch_norm_bwd.cu kThreads)
_BN_THREADS = 256


def bn_bwd_geometry(rows: int, c: int, s: int, vec: int, sums_per_sm: int,
                    dx_per_sm: int, sms: int):
    """Launch shape of the BatchNorm backward over a [rows, C, S] view ->
    (bcols, rpp, gx_sums, gx_dx, gy).  ``vec`` is the elements a thread
    loads at once (16 bytes' worth, or 1), ``sums_per_sm``/``dx_per_sm``
    the blocks of the sums and dx kernels one SM holds at once.

    Channels-last (S == 1): a block covers ``bcols`` vectors of a row (at
    most 256, one a thread) and ``rpp`` rows a pass; gy column groups
    cover the C / vec vectors of a row; block x of a group walks rows
    bx * rpp + lane + k * gx * rpp.  Channel-major (S > 1): gy = C, one
    channel a block, whose rows * S / vec vectors the gx blocks walk.
    Each kernel's grid is one wave of what the card holds (gx * gy at
    most blocks-per-SM x SMs), but no more blocks than there is work."""
    if s == 1:
        cols = c // vec
        bcols = min(cols, _BN_THREADS)
        rpp = _BN_THREADS // bcols
        gy = -(-cols // bcols)
        work = -(-rows // rpp)
    else:
        bcols, rpp, gy = 1, 1, c
        work = -(-rows * (s // vec) // _BN_THREADS)

    def wave(per_sm):
        return max(1, min(per_sm * sms // gy, work))
    return bcols, rpp, wave(sums_per_sm), wave(dx_per_sm), gy


def bn_bwd_vec(c: int, s: int, itemsize: int, aligned: bool) -> int:
    """Elements a BatchNorm backward thread loads at once over a [N', C,
    S] view: 16 bytes' worth when the contiguous dimension (C for S == 1,
    else S) is a multiple of that and the tensors are 16-byte
    ``aligned``, else 1."""
    vec = 16 // itemsize
    return vec if aligned and (c if s == 1 else s) % vec == 0 else 1


@functools.lru_cache(maxsize=None)
def _bn_residency(device: int, is_bf16: int, relu: int, channel_major: int,
                  vec: int) -> Tuple[int, int]:
    """(sums, dx) blocks of the BatchNorm backward kernels one SM of card
    ``device`` holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
    in the library)."""
    fn = _build.load(BATCH_NORM_BWD.source).ptt_batch_norm_bwd_residency
    fn.argtypes = [_I] * 4 + [_P, _P]
    fn.restype = ctypes.c_int
    sums, dx = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(is_bf16, relu, channel_major, int(vec > 1),
                ctypes.byref(sums), ctypes.byref(dx))
    if rc != 0 or sums.value < 1 or dx.value < 1:
        raise RuntimeError(f"batch_norm_bwd residency query failed: CUDA "
                           f"error {rc}, blocks {sums.value}/{dx.value}")
    return sums.value, dx.value


def batch_norm_apply(x3, scale, bias, mean, inv, act=None):
    """relu?((x - mean) * inv * scale + bias) over a [N', C, S] view with
    per-channel vectors, computed in f32 (f64 for f64 inputs) and returned
    in x's dtype: the training forward from the batch statistics, and the
    inference forward from the running ones."""
    def v(t):
        return _acc(t).reshape(1, -1, 1)
    y = (_acc(x3) - v(mean)) * v(inv) * v(scale) + v(bias)
    if act == "relu":
        y = torch.relu(y)
    return y.to(x3.dtype)


def batch_norm_bwd_plain(x3, dy3, scale, bias, mean, inv, act=None):
    """Plain version: the closed form in f32 -- dy masked by the
    pre-activation under relu, dbias and dscale summed over n and s,
    dx = (dy' - dbias/R - xn * dscale/R) * scale * inv."""
    def v(t):
        return _acc(t).reshape(1, -1, 1)
    xf, g = _acc(x3), _acc(dy3)
    xn = (xf - v(mean)) * v(inv)
    if act == "relu":
        g = torch.where(xn * v(scale) + v(bias) > 0, g,
                        torch.zeros((), dtype=g.dtype, device=g.device))
    n = x3.shape[0] * x3.shape[2]
    dbias = g.sum(dim=(0, 2))
    dscale = (g * xn).sum(dim=(0, 2))
    t = g - (dbias / n).reshape(1, -1, 1) - xn * (dscale / n).reshape(1, -1, 1)
    dx = t * (v(scale) * v(inv))
    return dx.to(x3.dtype), dscale, dbias


def batch_norm_bwd(x3: torch.Tensor, dy3: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                   act=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BatchNorm training backward over a [N', C, S] view: x3 and dy3 in
    x's dtype, f32 scale, bias, mean and inv = rsqrt(var + eps) [C], act
    None or "relu" (fused into the forward) -> (dx in x's dtype, dscale
    [C] f32, dbias [C] f32).  The cotangents of mean and inv are zero:
    the closed form already accounts for them."""
    if x3.device.type == "cpu":
        return batch_norm_bwd_plain(x3, dy3, scale, bias, mean, inv, act)
    if x3.dim() != 3 or dy3.shape != x3.shape:
        raise ValueError(f"batch_norm_bwd: x {tuple(x3.shape)} and dy "
                         f"{tuple(dy3.shape)} must be one [N', C, S] shape")
    n, c, s = x3.shape
    if any(t.shape != (c,) for t in (scale, bias, mean, inv)):
        raise ValueError(f"batch_norm_bwd: per-channel vectors "
                         f"{[tuple(t.shape) for t in (scale, bias, mean, inv)]}"
                         f" for C={c}")
    if x3.dtype not in _FLOAT_TYPES or dy3.dtype != x3.dtype or any(
            t.dtype != torch.float32 for t in (scale, bias, mean, inv)):
        raise ValueError(f"batch_norm_bwd: dtypes {x3.dtype}/{dy3.dtype}/"
                         f"{[str(t.dtype) for t in (scale, bias, mean, inv)]}")
    if act not in (None, "relu"):
        raise ValueError(f"batch_norm_bwd: act {act!r} not in (None, 'relu')")
    _check_cuda("batch_norm_bwd", x3, dy3, scale, bias, mean, inv)
    if s > 1 and c > 65535:
        raise ValueError(f"batch_norm_bwd: C={c} > 65535 channels with S > "
                         "1 (one grid row a channel)")
    dx = torch.empty_like(x3)
    dev = x3.get_device()
    relu, bf16 = int(act == "relu"), int(x3.dtype == torch.bfloat16)
    vec = bn_bwd_vec(c, s, x3.element_size(), all(
        t.data_ptr() % 16 == 0 for t in (x3, dy3, dx)))
    bcols, rpp, gx_sums, gx_dx, gy = bn_bwd_geometry(
        max(n, 1), c, s, vec, *_bn_residency(dev, bf16, relu, int(s > 1),
                                             vec), _sm_count(dev))
    part = torch.empty((gx_sums, 2, c), dtype=torch.float32,
                       device=x3.device)
    # the kernels write every element unless there are no rows to sum
    alloc = torch.empty if x3.numel() else torch.zeros
    dscale = alloc(c, dtype=torch.float32, device=x3.device)
    dbias = alloc(c, dtype=torch.float32, device=x3.device)
    BATCH_NORM_BWD.launch(
        x3.data_ptr(), dy3.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        mean.data_ptr(), inv.data_ptr(), dx.data_ptr(), part.data_ptr(),
        dscale.data_ptr(), dbias.data_ptr(), n, c, s, int(vec > 1), bcols,
        rpp, gx_sums, gx_dx, gy, relu, bf16, _stream(x3))
    return dx, dscale, dbias


# ---------------------------------------------------------------------------
# LSTM and GRU recurrences, forward and backward
# ---------------------------------------------------------------------------
#
# Time-major, as the Pallas kernels: xs [T, B, G*H] holds the pre-projected
# gate inputs with the bias folded in (G = 4, gates i | f | g | o; G = 3,
# gates r | z | c), w [H, G*H] is the recurrent weight (f32, or bf16 under
# program.amp), mask [T, B, 1] is 1 on a live step and 0 on padding (a
# padded step carries h and c through), h0 and c0 are [B, H].  Products
# with a bf16 w take bf16 operands and accumulate in f32, as the Pallas
# kernels' dots do; everything else is f32.  The backward kernels
# recompute the gates from the saved states, walking t down from T - 1.
#
# Two paths (recurrent.cuh): "persistent", one cooperative launch for all
# T steps whose blocks keep their columns of w in shared memory, where its
# grid fits one block an SM; else "stepwise", one launch a step (the
# GRU's forward and backward two) streaming w from device memory.  The
# wrappers choose by the library's own query (`recurrent_paths`), from the
# shape, before any launch; `recurrent_path` is the same rule in Python.

#: the H100's SMs and the most shared memory one of its blocks may ask for
#: (227 KB), the card `recurrent_path` reckons for by default
H100_SMS, H100_SMEM_OPTIN = 132, 232448

#: threads and warps of a recurrent block (recurrent.cuh kThreads)
_RNN_WARPS = 8


def _units_per_block(h: int, sms: int) -> int:
    """recurrent.cuh units_per_block: the fewest of 1, 2, 4, 8 hidden
    units a block that need no more blocks than ``sms``, else 8."""
    hb = 1
    while hb < 8 and -(-h // hb) > sms:
        hb *= 2
    return hb


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _fwd_smem(kind: str, h: int, b: int, hb: int, ws: int,
              optin: int) -> int:
    """Shared memory of a persistent forward block (lstm.cu / gru.cu
    fwd_smem) at the most rows of the batch it stages at once that fit
    ``optin`` (recurrent.cuh staged_rows)."""
    ldk = _up(h, 16) + 16 // ws
    if kind == "lstm":
        np_ = _up(4 * hb, 16)
        w_rows, red_cols, x_cols = np_, np_ + 4, 4 * hb
    else:
        npr, npc = _up(2 * hb, 16), _up(hb, 16)
        w_rows, red_cols, x_cols = npr + npc, npr + 4, 2 * hb

    def smem(mc):
        return (_up(w_rows * ldk * ws, 16) + _up(mc * ldk * ws, 16)
                + 4 * (_RNN_WARPS * mc * red_cols + mc * x_cols + mc
                       + 2 * b * hb))
    mc = _up(b, 16)
    while mc > 16 and smem(mc) > optin:
        mc -= 16
    return smem(mc)


def _bwd_smem(kind: str, h: int, b: int, hb: int, ws: int) -> int:
    """Shared memory of a persistent backward recurrence block (lstm.cu /
    gru.cu bwd_smem)."""
    bf16 = ws == 2
    if kind == "lstm":
        ko = _up(4 * hb, 16) if bf16 else 4 * hb
        ld, carried = ko + (8 if bf16 else 1), 2 * b * hb
    else:
        kr = _up(2 * hb, 16) if bf16 else 2 * hb
        kc = _up(hb, 16) if bf16 else hb
        ld, carried = kr + kc + (8 if bf16 else 1), 13 * b * hb + 2 * b
    seg = _up(b * hb, 4)
    return (_up((_up(h, 16) + _up(b, 16)) * ld * ws, 16)
            + 4 * (max(1024, seg) + carried))


def recurrent_path(kind: str, direction: str, h: int, b: int,
                   w_bf16: bool, sms: int = H100_SMS,
                   smem_optin: int = H100_SMEM_OPTIN) -> str:
    """The path the ``kind`` ("lstm" or "gru") kernel of ``direction``
    ("fwd", or "bwd" for the backward's recurrence) takes at hidden width
    ``h`` and batch ``b`` on a card of ``sms`` SMs whose blocks may ask
    for ``smem_optin`` bytes: "persistent" when its grid fits one block
    an SM (no more blocks than SMs, units a block as
    ``units_per_block``, the GRU forward's 8) and a block's shared memory
    (its columns of w for all of h, the staged operand, the partial
    tiles) fits, else "stepwise".  recurrent.cuh ``persistent_fits`` is
    the same rule, with the card's occupancy query beside it."""
    if kind not in ("lstm", "gru") or direction not in ("fwd", "bwd"):
        raise ValueError(f"recurrent_path: {kind!r}, {direction!r}")
    ws = 2 if w_bf16 else 4
    hb = 8 if (kind, direction) == ("gru", "fwd") else \
        _units_per_block(h, sms)
    smem = (_fwd_smem(kind, h, b, hb, ws, smem_optin) if direction == "fwd"
            else _bwd_smem(kind, h, b, hb, ws))
    fits = -(-h // hb) <= sms and smem <= smem_optin
    return "persistent" if fits else "stepwise"


@functools.lru_cache(maxsize=None)
def recurrent_paths(source: str, device: int, h: int, b: int,
                    w_bf16: bool) -> Tuple[str, str]:
    """(forward, backward) path of the library of ``source`` ("lstm" or
    "gru") at ``h``, ``b`` on card ``device``, from the library's own
    query (ptt_lstm_paths / ptt_gru_paths: recurrent.cuh
    persistent_fits)."""
    fn = getattr(_build.load(source), f"ptt_{source}_paths")
    fn.argtypes = [_I, _I, _I, _P, _P]
    fn.restype = ctypes.c_int
    fwd, bwd = ctypes.c_int(-1), ctypes.c_int(-1)
    with torch.cuda.device(device):
        rc = fn(b, h, int(w_bf16), ctypes.byref(fwd), ctypes.byref(bwd))
    if rc != 0 or fwd.value not in (0, 1) or bwd.value not in (0, 1):
        raise RuntimeError(f"{source} path query failed: CUDA error {rc}")
    return tuple(RECURRENT_PATHS[1 - v] for v in (fwd.value, bwd.value))


def _rnn_path(kernel: Kernel, xs: torch.Tensor, h: int, b: int, bf16: bool,
              path) -> str:
    """The path a recurrent wrapper launches: ``path`` when the caller
    forces one (a shape the persistent grid cannot hold is then refused at
    the launch), else the library's choice for the shape."""
    if path is None:
        fwd, bwd = recurrent_paths(kernel.source, xs.get_device(), h, b, bf16)
        return fwd if kernel.name.endswith("_fwd") else bwd
    if path not in RECURRENT_PATHS:
        raise ValueError(f"{kernel.name}: path {path!r} not in "
                         f"{RECURRENT_PATHS}")
    return path

def _mm(t, w):
    """``t`` as an operand of a product with ``w``: rounded to bf16 and
    back when w is bf16 (the Pallas kernels' ``.astype(w.dtype)``)."""
    return t.to(w.dtype).to(t.dtype) if w.dtype == torch.bfloat16 else t


def _prev(x0, xs):
    """[x0, xs[0], ..., xs[T-2]]: the state each step starts from."""
    return torch.cat([_acc(x0)[None], _acc(xs[:-1])])


def lstm_fwd_plain(xs, w, h0, c0, mask):
    """Plain version of `lstm_fwd`: the Pallas kernel's step in torch."""
    hid = w.shape[0]
    wf = _acc(w)
    h, c = _acc(h0), _acc(c0)
    hs, cs = [], []
    for t in range(xs.shape[0]):
        gates = _acc(xs[t]) + _mm(h, w) @ wf
        i = torch.sigmoid(gates[:, :hid])
        f = torch.sigmoid(gates[:, hid:2 * hid])
        g = torch.tanh(gates[:, 2 * hid:3 * hid])
        o = torch.sigmoid(gates[:, 3 * hid:])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = _acc(mask[t])
        h = m * h_new + (1 - m) * h
        c = m * c_new + (1 - m) * c
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def lstm_bwd_plain(xs, w, h0, c0, mask, hs, cs, dhs, dcs):
    """Plain version of `lstm_bwd`: the Pallas backward kernel's step in
    torch, t from T - 1 down to 0."""
    hid = w.shape[0]
    wf = _acc(w)
    hprev, cprev = _prev(h0, hs), _prev(c0, cs)
    dh_c = torch.zeros_like(hprev[0])
    dc_c = torch.zeros_like(dh_c)
    dw = torch.zeros_like(wf)
    dxs = [None] * xs.shape[0]
    for t in reversed(range(xs.shape[0])):
        h_prev, c_prev, m = hprev[t], cprev[t], _acc(mask[t])
        gates = _acc(xs[t]) + _mm(h_prev, w) @ wf
        i = torch.sigmoid(gates[:, :hid])
        f = torch.sigmoid(gates[:, hid:2 * hid])
        g = torch.tanh(gates[:, 2 * hid:3 * hid])
        o = torch.sigmoid(gates[:, 3 * hid:])
        tanh_c = torch.tanh(f * c_prev + i * g)
        dh = _acc(dhs[t]) + dh_c
        dc_out = _acc(dcs[t]) + dc_c
        dh_new = m * dh
        dc_new = m * dc_out + dh_new * o * (1 - tanh_c * tanh_c)
        dgates = torch.cat([dc_new * g * i * (1 - i),
                            dc_new * c_prev * f * (1 - f),
                            dc_new * i * (1 - g * g),
                            dh_new * tanh_c * o * (1 - o)], dim=1)
        dxs[t] = dgates
        dg = _mm(dgates, w)
        dw = dw + _mm(h_prev, w).T @ dg
        dh_c = (1 - m) * dh + dg @ wf.T
        dc_c = f * dc_new + (1 - m) * dc_out
    return torch.stack(dxs), dw, dh_c, dc_c


def gru_fwd_plain(xs, w, h0, mask):
    """Plain version of `gru_fwd`: the Pallas kernel's step in torch."""
    hid = w.shape[0]
    wf = _acc(w)
    h = _acc(h0)
    hs = []
    for t in range(xs.shape[0]):
        x = _acc(xs[t])
        rz = torch.sigmoid(x[:, :2 * hid] + _mm(h, w) @ wf[:, :2 * hid])
        r, z = rz[:, :hid], rz[:, hid:]
        c = torch.tanh(x[:, 2 * hid:] + _mm(r * h, w) @ wf[:, 2 * hid:])
        m = _acc(mask[t])
        h = m * ((1 - z) * h + z * c) + (1 - m) * h
        hs.append(h)
    return torch.stack(hs)


def gru_bwd_plain(xs, w, h0, mask, hs, dhs):
    """Plain version of `gru_bwd`: the Pallas backward kernel's step in
    torch, t from T - 1 down to 0."""
    hid = w.shape[0]
    wf = _acc(w)
    w_rz, w_c = wf[:, :2 * hid], wf[:, 2 * hid:]
    hprev = _prev(h0, hs)
    dh_c = torch.zeros_like(hprev[0])
    dw = torch.zeros_like(wf)
    dxs = [None] * xs.shape[0]
    for t in reversed(range(xs.shape[0])):
        h_prev, m, x = hprev[t], _acc(mask[t]), _acc(xs[t])
        rz = torch.sigmoid(x[:, :2 * hid] + _mm(h_prev, w) @ w_rz)
        r, z = rz[:, :hid], rz[:, hid:]
        rh = r * h_prev
        c = torch.tanh(x[:, 2 * hid:] + _mm(rh, w) @ w_c)
        dh = _acc(dhs[t]) + dh_c
        dh_new = m * dh
        dh_prev = (1 - m) * dh + dh_new * (1 - z)
        dz = dh_new * (c - h_prev)
        dc_in = dh_new * z * (1 - c * c)
        drh = _mm(dc_in, w) @ w_c.T
        dh_prev = dh_prev + drh * r
        drz_in = torch.cat([drh * h_prev * r * (1 - r), dz * z * (1 - z)],
                           dim=1)
        dh_c = dh_prev + _mm(drz_in, w) @ w_rz.T
        dxs[t] = torch.cat([drz_in, dc_in], dim=1)
        dw = dw + torch.cat([_mm(h_prev, w).T @ _mm(drz_in, w),
                             _mm(rh, w).T @ _mm(dc_in, w)], dim=1)
    return torch.stack(dxs), dw, dh_c


def _check_recurrent(name, gates, xs, w, states, seqs, mask):
    """Shapes, dtypes and contiguity of a recurrent kernel's arguments ->
    (T, B, H).  ``states`` are [B, H], ``seqs`` [T, B, H]."""
    if xs.dim() != 3 or xs.shape[2] % gates or xs.shape[0] < 1 \
            or xs.shape[1] < 1:
        raise ValueError(f"{name}: xs must be [T >= 1, B >= 1, {gates}*H], "
                         f"got {tuple(xs.shape)}")
    t, b, g = xs.shape
    h = g // gates
    if w.shape != (h, g):
        raise ValueError(f"{name}: w {tuple(w.shape)}, want ({h}, {g})")
    if mask.shape != (t, b, 1):
        raise ValueError(f"{name}: mask {tuple(mask.shape)}, want "
                         f"({t}, {b}, 1)")
    for s in states:
        if s.shape != (b, h):
            raise ValueError(f"{name}: state {tuple(s.shape)}, want "
                             f"({b}, {h})")
    for s in seqs:
        if s.shape != (t, b, h):
            raise ValueError(f"{name}: sequence {tuple(s.shape)}, want "
                             f"({t}, {b}, {h})")
    if w.dtype not in _FLOAT_TYPES or any(
            x.dtype != torch.float32 for x in (xs, mask, *states, *seqs)):
        raise ValueError(f"{name}: w must be f32 or bf16 and the rest f32, "
                         f"got w {w.dtype}, xs {xs.dtype}")
    _check_cuda(name, xs, w, mask, *states, *seqs)
    return t, b, h


def lstm_fwd(xs: torch.Tensor, w: torch.Tensor, h0: torch.Tensor,
             c0: torch.Tensor, mask: torch.Tensor, path: str = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole-T LSTM recurrence: xs [T, B, 4H] f32, w [H, 4H] f32 or
    bf16, h0 and c0 [B, H] f32, mask [T, B, 1] f32 -> (hs, cs), each
    [T, B, H] f32.  One launch for all T steps, or one a step where the
    card cannot hold that (``path``: `recurrent_paths`' choice unless
    forced; counted in ``LSTM_FWD.path_launches``)."""
    if xs.device.type == "cpu":
        return lstm_fwd_plain(xs, w, h0, c0, mask)
    t, b, h = _check_recurrent("lstm_fwd", 4, xs, w, (h0, c0), (), mask)
    hs = torch.empty((t, b, h), dtype=torch.float32, device=xs.device)
    cs = torch.empty_like(hs)
    # a bf16 w: each step's h as the next step's bf16 operand, two slots
    # of [B, H rounded up to 16] whose padding stays 0 (lstm.cu)
    bf16 = w.dtype == torch.bfloat16
    h16 = torch.zeros((2, b, -(-h // 16) * 16), dtype=torch.bfloat16,
                      device=xs.device) if bf16 else None
    path = _rnn_path(LSTM_FWD, xs, h, b, bf16, path)
    LSTM_FWD.launch(xs.data_ptr(), w.data_ptr(), h0.data_ptr(),
                    c0.data_ptr(), mask.data_ptr(), hs.data_ptr(),
                    cs.data_ptr(), h16.data_ptr() if bf16 else None, t, b, h,
                    int(bf16), int(path == "stepwise"), _stream(xs),
                    path=path)
    return hs, cs


@functools.lru_cache(maxsize=None)
def rnn_exchange_floats(source: str, device: int, h: int, b: int) -> int:
    """f32 elements of a recurrent backward's exchange buffer at ``h``,
    ``b`` on card ``device``, as the library of ``source`` ("lstm" or
    "gru") sizes it (ptt_rnn_exchange_floats, recurrent.cuh: its units a
    block and its layout are the kernels' own)."""
    fn = _build.load(source).ptt_rnn_exchange_floats
    fn.argtypes = [_I, _I, _P]
    fn.restype = ctypes.c_int
    floats = ctypes.c_longlong(0)
    with torch.cuda.device(device):
        rc = fn(h, b, ctypes.byref(floats))
    if rc != 0 or floats.value < 1:
        raise RuntimeError(f"{source} exchange size query failed: CUDA "
                           f"error {rc}, {floats.value} floats")
    return floats.value


def rnn_dw_splits(h: int, tb: int, gates: int) -> int:
    """Runs of k a recurrent backward's dw product [H, T*B] x [T*B,
    gates*H] is split into (summed in order after): enough 64 x 64 output
    tiles x runs for about 1024 blocks, at most 8 runs, and no more runs
    than T*B holds 128s of k."""
    tiles = -(-h // 64) * -(-gates * h // 64)
    return max(1, min(8, 1024 // tiles, -(-tb // 128)))


def lstm_bwd(xs: torch.Tensor, w: torch.Tensor, h0: torch.Tensor,
             c0: torch.Tensor, mask: torch.Tensor, hs: torch.Tensor,
             cs: torch.Tensor, dhs: torch.Tensor, dcs: torch.Tensor,
             path: str = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
    """Gradients of `lstm_fwd` from its inputs, its outputs hs and cs and
    their cotangents dhs and dcs -> (dxs [T, B, 4H], dw [H, 4H], dh0,
    dc0), all f32.  One C call: the gates' product, the recurrence (one
    cooperative launch for all T steps, or T + 1 launches stepwise:
    ``path`` as `lstm_fwd`'s) and dw's product."""
    if xs.device.type == "cpu":
        return lstm_bwd_plain(xs, w, h0, c0, mask, hs, cs, dhs, dcs)
    t, b, h = _check_recurrent("lstm_bwd", 4, xs, w, (h0, c0),
                               (hs, cs, dhs, dcs), mask)
    hprev, cprev = _prev(h0, hs), _prev(c0, cs)
    dxs = torch.empty_like(xs)
    # dgates as the dw product's bf16 operand (rows padded to whole
    # 16-byte chunks)
    bf16 = w.dtype == torch.bfloat16
    dg16 = torch.empty((t, b, -(-4 * h // 8) * 8), dtype=torch.bfloat16,
                       device=xs.device) if bf16 else None
    dw = torch.empty((h, 4 * h), dtype=torch.float32, device=xs.device)
    # the exchange of dh_prev's partial sums, in two halves (lstm.cu)
    exch = torch.empty(rnn_exchange_floats(LSTM_BWD.source, xs.get_device(),
                                           h, b),
                       dtype=torch.float32, device=xs.device)
    splits = rnn_dw_splits(h, t * b, 4)
    part = torch.empty((splits, h, 4 * h), dtype=torch.float32,
                       device=xs.device) if splits > 1 else None
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    path = _rnn_path(LSTM_BWD, xs, h, b, bf16, path)
    # stepwise: dh and dc carried from one launch to the next
    carry = torch.empty((2, b, h), dtype=torch.float32,
                        device=xs.device) if path == "stepwise" else None
    LSTM_BWD.launch(xs.data_ptr(), w.data_ptr(), hprev.data_ptr(),
                    cprev.data_ptr(), mask.data_ptr(), dhs.data_ptr(),
                    dcs.data_ptr(), dxs.data_ptr(),
                    dg16.data_ptr() if bf16 else None, exch.data_ptr(),
                    dw.data_ptr(),
                    part.data_ptr() if splits > 1 else None,
                    dh0.data_ptr(), dc0.data_ptr(),
                    carry.data_ptr() if carry is not None else None, t, b, h,
                    splits, int(bf16), int(path == "stepwise"), _stream(xs),
                    path=path)
    return dxs, dw, dh0, dc0


def gru_fwd(xs: torch.Tensor, w: torch.Tensor, h0: torch.Tensor,
            mask: torch.Tensor, path: str = None) -> torch.Tensor:
    """The whole-T GRU recurrence, gate columns r | z | c: xs [T, B, 3H]
    f32, w [H, 3H] f32 or bf16, h0 [B, H] f32, mask [T, B, 1] f32 -> hs
    [T, B, H] f32.  One launch for all T steps, or two a step where the
    card cannot hold that (``path`` as `lstm_fwd`'s)."""
    if xs.device.type == "cpu":
        return gru_fwd_plain(xs, w, h0, mask)
    t, b, h = _check_recurrent("gru_fwd", 3, xs, w, (h0,), (), mask)
    hs = torch.empty((t, b, h), dtype=torch.float32, device=xs.device)
    # the step's operands published for every block (gru.cu): r * h_prev,
    # and for a bf16 w h too, each as bf16 [B, H rounded up to 16] whose
    # padding stays 0; for an f32 w r * h_prev alone, f32 [B, H]
    bf16 = w.dtype == torch.bfloat16
    if bf16:
        rh, h16 = torch.zeros((2, b, -(-h // 16) * 16), dtype=torch.bfloat16,
                              device=xs.device)
    else:
        rh = torch.empty((b, h), dtype=torch.float32, device=xs.device)
    path = _rnn_path(GRU_FWD, xs, h, b, bf16, path)
    # stepwise: z from the r|z launch to the c launch of a step
    zs = torch.empty((b, h), dtype=torch.float32,
                     device=xs.device) if path == "stepwise" else None
    GRU_FWD.launch(xs.data_ptr(), w.data_ptr(), h0.data_ptr(),
                   mask.data_ptr(), hs.data_ptr(), rh.data_ptr(),
                   h16.data_ptr() if bf16 else None,
                   zs.data_ptr() if zs is not None else None, t, b, h,
                   int(bf16), int(path == "stepwise"), _stream(xs),
                   path=path)
    return hs


def gru_bwd(xs: torch.Tensor, w: torch.Tensor, h0: torch.Tensor,
            mask: torch.Tensor, hs: torch.Tensor, dhs: torch.Tensor,
            path: str = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of `gru_fwd` from its inputs, its output hs and the
    cotangent dhs -> (dxs [T, B, 3H], dw [H, 3H], dh0), all f32.  One C
    call: the gates' products, the recurrence (one cooperative launch for
    all T steps, or 2T + 1 launches stepwise: ``path`` as `lstm_fwd`'s)
    and dw's products."""
    if xs.device.type == "cpu":
        return gru_bwd_plain(xs, w, h0, mask, hs, dhs)
    t, b, h = _check_recurrent("gru_bwd", 3, xs, w, (h0,), (hs, dhs), mask)
    hprev = _prev(h0, hs)
    dxs = torch.empty_like(xs)
    # the dgates as the dw products' bf16 operand (rows padded to whole
    # 16-byte chunks)
    bf16 = w.dtype == torch.bfloat16
    dg16 = torch.empty((t, b, -(-3 * h // 8) * 8), dtype=torch.bfloat16,
                       device=xs.device) if bf16 else None
    # exchanges 1 (drh) and 2 (dh_prev's last term) of the recurrence
    exch = torch.empty(rnn_exchange_floats(GRU_BWD.source, xs.get_device(),
                                           h, b),
                       dtype=torch.float32, device=xs.device)
    dw = torch.empty((h, 3 * h), dtype=torch.float32, device=xs.device)
    splits = rnn_dw_splits(h, t * b, 3)
    part = torch.empty((splits, h, 3 * h), dtype=torch.float32,
                       device=xs.device) if splits > 1 else None
    dh0 = torch.empty_like(h0)
    rh = torch.empty((t, b, h), dtype=torch.float32, device=xs.device)
    path = _rnn_path(GRU_BWD, xs, h, b, bf16, path)
    # stepwise: the carried dh and (a)'s part of dh_prev between launches
    carry = torch.empty((2, b, h), dtype=torch.float32,
                        device=xs.device) if path == "stepwise" else None
    GRU_BWD.launch(xs.data_ptr(), w.data_ptr(), hprev.data_ptr(),
                   mask.data_ptr(), dhs.data_ptr(), dxs.data_ptr(),
                   dg16.data_ptr() if bf16 else None, exch.data_ptr(),
                   dw.data_ptr(), part.data_ptr() if splits > 1 else None,
                   dh0.data_ptr(), rh.data_ptr(),
                   carry.data_ptr() if carry is not None else None, t, b, h,
                   splits, int(bf16), int(path == "stepwise"), _stream(xs),
                   path=path)
    return dxs, dw, dh0


# ---------------------------------------------------------------------------
# autograd Functions of the training path
# ---------------------------------------------------------------------------

class FlashAttention(torch.autograd.Function):
    """Attention over [B, H, T, D] whose backward is the flash backward
    kernel (the JAX package's ``_own_flash_attention`` custom VJP):
    saves q, k, v, out and lse, never a [T, T] tensor."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), ctx.causal)
        return dq, dk, dv, None


class LayerNorm(torch.autograd.Function):
    """LayerNorm over [R, F] rows -> (y, mean, var) whose backward is the
    LayerNorm backward kernel (``fused_layer_norm``'s custom VJP).  mean
    and var come out stop-gradient: the closed-form dx already folds
    their derivatives in.  dscale and dbias return in scale's dtype."""

    @staticmethod
    def forward(ctx, x2, scale, bias, eps):
        y, mean, var = layer_norm_fwd(x2, scale, bias, eps)
        ctx.save_for_backward(x2, scale, mean, torch.rsqrt(var + eps))
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x2, scale, mean, inv = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(x2, scale, mean, inv,
                                           dy.contiguous())
        return dx, dscale.to(scale.dtype), dbias.to(scale.dtype), None


class SoftmaxXent(torch.autograd.Function):
    """Hard-label softmax cross-entropy over [R, V] -> loss [R] whose
    backward is the softmax-xent backward kernel (``fused_softmax_xent``'s
    custom VJP): saves the logits, the labels and one lse per row."""

    @staticmethod
    def forward(ctx, x2, labels):
        loss, lse = softmax_xent_fwd(x2, labels)
        ctx.save_for_backward(x2, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        x2, labels, lse = ctx.saved_tensors
        dloss = dloss.to(lse.dtype).contiguous()
        return softmax_xent_bwd(x2, labels, lse, dloss), None


class BatchNormTrain(torch.autograd.Function):
    """Training-mode BatchNorm over a [N', C, S] view from batch
    statistics passed in detached, with the relu optionally fused, whose
    backward is the BatchNorm backward kernel (the JAX package's
    ``_bn_train_core`` custom VJP): saves x and the per-channel vectors,
    never an f32 activation-sized tensor.  mean and inv get no gradient:
    the closed-form dx already folds in their derivatives."""

    @staticmethod
    def forward(ctx, x3, scale, bias, mean, inv, act):
        ctx.save_for_backward(x3, scale, bias, mean, inv)
        ctx.act = act
        return batch_norm_apply(x3, scale, bias, mean, inv, act)

    @staticmethod
    def backward(ctx, dy):
        x3, scale, bias, mean, inv = ctx.saved_tensors
        dx, dscale, dbias = batch_norm_bwd(x3, dy.contiguous(), scale, bias,
                                           mean, inv, ctx.act)
        return (dx, dscale.to(scale.dtype), dbias.to(bias.dtype), None, None,
                None)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """A recurrent kernel's operand: f32 (f64 stays f64 for gradcheck on
    the plain versions), contiguous."""
    if t.dtype not in (torch.float32, torch.float64):
        t = t.float()
    return t.contiguous()


class FusedLSTM(torch.autograd.Function):
    """The whole-T LSTM over time-major [T, B, 4H] inputs whose backward
    is the LSTM backward kernel (the JAX package's ``fused_lstm`` custom
    VJP): saves the inputs and hs/cs only, and the backward recomputes the
    gates.  A bf16 xs runs in f32 with hs, cs and the gradients rounded to
    its dtype, as the Pallas kernels keep an f32 carry; dw returns in w's
    dtype (bf16 under program.amp), as the JAX VJP does."""

    @staticmethod
    def forward(ctx, xs, w, h0, c0, mask):
        hs, cs = lstm_fwd(_f32(xs), w.contiguous(), _f32(h0), _f32(c0),
                          _f32(mask))
        hs, cs = hs.to(xs.dtype), cs.to(xs.dtype)
        ctx.save_for_backward(xs, w, h0, c0, mask, hs, cs)
        return hs, cs

    @staticmethod
    def backward(ctx, dhs, dcs):
        xs, w, h0, c0, mask, hs, cs = ctx.saved_tensors
        dxs, dw, dh0, dc0 = lstm_bwd(
            _f32(xs), w.contiguous(), _f32(h0), _f32(c0), _f32(mask),
            _f32(hs), _f32(cs), _f32(dhs), _f32(dcs))
        return (dxs.to(xs.dtype), dw.to(w.dtype), dh0.to(h0.dtype),
                dc0.to(c0.dtype), None)


class FusedGRU(torch.autograd.Function):
    """The whole-T GRU over time-major [T, B, 3H] inputs ([r | z | c]
    gate columns) whose backward is the GRU backward kernel (the JAX
    package's ``fused_gru`` custom VJP); dtypes as `FusedLSTM`."""

    @staticmethod
    def forward(ctx, xs, w, h0, mask):
        hs = gru_fwd(_f32(xs), w.contiguous(), _f32(h0),
                     _f32(mask)).to(xs.dtype)
        ctx.save_for_backward(xs, w, h0, mask, hs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        xs, w, h0, mask, hs = ctx.saved_tensors
        dxs, dw, dh0 = gru_bwd(_f32(xs), w.contiguous(), _f32(h0),
                               _f32(mask), _f32(hs), _f32(dhs))
        return dxs.to(xs.dtype), dw.to(w.dtype), dh0.to(h0.dtype), None
