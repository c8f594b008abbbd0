"""Device resolution and the dtype table (counterpart of
``paddle_tpu/core/place.py`` and the dtype table of
``paddle_tpu/core/types.py``).

Every entry point of the port takes a ``device`` argument.  ``None``
means the card: ``cuda`` when CUDA is present, and an error when it is
not — the port never drops to the CPU on its own.  ``"cpu"`` runs the
plain PyTorch versions of the kernels, which is what the CPU tests ask
for.
"""
from __future__ import annotations

import torch

#: canonical dtype names (the JAX package's spelling) -> torch dtypes
_DTYPE_TABLE = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int32": torch.int32,
    "int64": torch.int64,
}

#: serving precision -> activation / parameter dtype
_PRECISION_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raise without CUDA);
    anything else -> ``torch.device(device)``, checked for CUDA when it
    names a CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: paddle_tpu_torch runs on the card unless "
                "the caller passes device='cpu'")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is absent")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_torch_dtype(name) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` / ``"int32"`` / ``"int64"`` (or a
    torch dtype, returned as is) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPE_TABLE[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def precision_dtype(precision: str) -> torch.dtype:
    """Serving precision (``"f32"`` or ``"bf16"``) -> torch dtype."""
    try:
        return _PRECISION_DTYPE[precision]
    except KeyError:
        raise ValueError(
            f"precision must be f32|bf16, got {precision!r}") from None
