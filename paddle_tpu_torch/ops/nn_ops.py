"""Neural-network ops of the serving path (counterpart of
``paddle_tpu/ops/nn_ops.py``; only ``layer_norm`` is ported so far)."""
from __future__ import annotations

import math

import torch

from .kernels import layer_norm_fwd


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               begin_norm_axis: int = 1, epsilon: float = 1e-5):
    """layer_norm_op.cc over the trailing axes from ``begin_norm_axis``:
    returns (Y shaped like x, Mean and Variance shaped like
    ``x.shape[:begin_norm_axis]``).  The rows go to the LayerNorm kernel
    for CUDA tensors and to its plain version for CPU tensors; the
    statistics are f32, Y is in x's dtype."""
    f = math.prod(x.shape[begin_norm_axis:])
    x2 = x.reshape(-1, f)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    y, mean, var = layer_norm_fwd(x2, scale.reshape(f).float(),
                                  bias.reshape(f).float(), epsilon)
    lead = x.shape[:begin_norm_axis]
    return y.reshape(x.shape), mean.reshape(lead), var.reshape(lead)
