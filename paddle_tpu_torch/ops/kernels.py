"""The port's hand-written CUDA kernels, their wrappers and their plain
PyTorch versions (counterpart of the three forward kernels of
``paddle_tpu/ops/pallas_kernels.py`` that the serving path runs).

=====================  ==========================  =========================
wrapper                CUDA source (ops/csrc)      replaces (Pallas kernel)
=====================  ==========================  =========================
`paged_attention`      paged_attention.cu          ``_paged_attn_kernel``
`flash_attention_fwd`  flash_attention.cu          ``_flash_kernel``
`layer_norm_fwd`       layer_norm.cu               ``_ln_fwd_kernel``
=====================  ==========================  =========================

Each source's header comment says what bounds the kernel on the H100
and what its design does about it.

A wrapper takes the plain version only for tensors on the CPU.  For CUDA
tensors it checks device, dtype, shape and contiguity, launches its
kernel on the current stream (no allocation inside the kernel, no
synchronisation) and raises if the launch reports an error — there is no
fallback.  Each launch adds one to the kernel's ``launches`` count
(`KERNELS`), so a run can show that its main path went through the
kernels.  The plain versions are what the CPU tests hold against the JAX
package and what ``chip_smoke.py`` holds each kernel against on the card.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import _build


class Kernel:
    """One CUDA kernel: where it lives, what it replaces, and how often the
    wrapper has launched it (a plain integer)."""

    def __init__(self, name: str, source: str, entry: str, replaces: str,
                 argtypes):
        self.name = name
        self.source = source
        self.entry = entry
        self.replaces = replaces
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def launch(self, *args):
        if self._fn is None:
            fn = getattr(_build.load(self.source), self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {rc}")
        self.launches += 1


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

PAGED_ATTENTION = Kernel(
    "paged_attention", "paged_attention", "ptt_paged_attention",
    "paddle_tpu/ops/pallas_kernels.py:704 _paged_attn_kernel",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P])
FLASH_ATTENTION_FWD = Kernel(
    "flash_attention_fwd", "flash_attention", "ptt_flash_attention_fwd",
    "paddle_tpu/ops/pallas_kernels.py:54 _flash_kernel",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P])
LAYER_NORM_FWD = Kernel(
    "layer_norm_fwd", "layer_norm", "ptt_layer_norm_fwd",
    "paddle_tpu/ops/pallas_kernels.py:1388 _ln_fwd_kernel",
    [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P])

KERNELS = (PAGED_ATTENTION, FLASH_ATTENTION_FWD, LAYER_NORM_FWD)

_FLOAT_TYPES = (torch.float32, torch.bfloat16)
_PAGED_HEAD_DIMS = (16, 32, 64, 128)
_FLASH_HEAD_DIMS = (32, 64)


def reset_launches():
    for k in KERNELS:
        k.launches = 0


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name: str, *tensors: torch.Tensor):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
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


def paged_attention(q: torch.Tensor, pool_k: torch.Tensor,
                    pool_v: torch.Tensor, table: torch.Tensor,
                    index: torch.Tensor) -> torch.Tensor:
    """One decode query per slot over its paged prefix: q [S, H, 1, D],
    pools [N, L, H, D], table [S, P] int32, index [S] int32 (the query's
    position; it sees positions 0..Index[s]) -> [S, H, 1, D]."""
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
    if d not in _PAGED_HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {d} not in "
                         f"{_PAGED_HEAD_DIMS}")
    _check_cuda("paged_attention", q, pool_k, pool_v, table, index)
    out = torch.empty_like(q)
    PAGED_ATTENTION.launch(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        table.data_ptr(), index.data_ptr(), out.data_ptr(), s, h, d, n,
        block_len, table.shape[1], 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16), _stream(q))
    return out


# ---------------------------------------------------------------------------
# FlashAttention-2 forward
# ---------------------------------------------------------------------------

def flash_attention_fwd_plain(q, k, v, causal=False):
    """Plain version: f32 scores, bottom-right aligned causal mask, lse per
    row; a fully masked row gives out 0 and lse -inf."""
    d = q.shape[-1]
    tq, tk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        mask = torch.ones(tq, tk, dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)                         # [B, H, Tq]
    live = torch.isfinite(lse)[..., None]
    p = torch.where(live, torch.exp(s - lse[..., None]),
                    torch.zeros((), device=q.device))
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype), lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over [B, H, T, D] -> (out [B, H, Tq, D] in q's dtype,
    lse [B, H, Tq] f32).  Causal masking is bottom-right aligned (key j
    visible to query i when j <= i + Tk - Tq); any Tq, Tk work."""
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
    if d not in _FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {d} not in "
                         f"{_FLASH_HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"flash_attention_fwd: batch*heads {b * h} > 65535")
    _check_cuda("flash_attention_fwd", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    FLASH_ATTENTION_FWD.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b * h, tq, tk, d, int(bool(causal)),
        1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16), _stream(q))
    return out, lse


# ---------------------------------------------------------------------------
# LayerNorm forward
# ---------------------------------------------------------------------------

def layer_norm_fwd_plain(x2, scale, bias, eps=1e-5):
    """Plain version: two-pass f32 statistics over [R, F] rows."""
    xf = x2.float()
    mean = xf.mean(dim=1)
    var = (xf - mean[:, None]).square().mean(dim=1)
    y = (xf - mean[:, None]) * torch.rsqrt(var + eps)[:, None]
    y = y * scale.float()[None, :] + bias.float()[None, :]
    return y.to(x2.dtype), mean, var


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
    y = torch.empty_like(x2)
    mean = torch.empty(r, dtype=torch.float32, device=x2.device)
    var = torch.empty(r, dtype=torch.float32, device=x2.device)
    LAYER_NORM_FWD.launch(
        x2.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        mean.data_ptr(), var.data_ptr(), r, f, float(eps),
        int(x2.dtype == torch.bfloat16), _stream(x2))
    return y, mean, var
