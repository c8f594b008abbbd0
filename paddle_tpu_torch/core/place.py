"""Device resolution and places (counterpart of
``paddle_tpu/core/place.py``).

Every entry point of the port takes a ``device`` argument.  ``None``
means the card: ``cuda`` when CUDA is present, and an error when it is
not — the port never drops to the CPU on its own.  ``"cpu"`` runs the
plain PyTorch versions of the kernels, which is what the CPU tests ask
for.  The Fluid front end names devices by place: `CUDAPlace` (the card)
and `CPUPlace`; `Executor()` with no place means the card.
"""
from __future__ import annotations

import torch

from .types import to_torch_dtype  # noqa: F401  (the one dtype table)

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


def precision_dtype(precision: str) -> torch.dtype:
    """Serving precision (``"f32"`` or ``"bf16"``) -> torch dtype."""
    try:
        return _PRECISION_DTYPE[precision]
    except KeyError:
        raise ValueError(
            f"precision must be f32|bf16, got {precision!r}") from None


class CPUPlace:
    """The host: tensors on the CPU, kernels' plain versions."""

    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    def torch_device(self) -> torch.device:
        return resolve_device("cpu")

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"


class CUDAPlace(CPUPlace):
    """A card: CUDA tensors and the port's kernels (raises without CUDA)."""

    def torch_device(self) -> torch.device:
        return resolve_device(f"cuda:{self.device_id}")
