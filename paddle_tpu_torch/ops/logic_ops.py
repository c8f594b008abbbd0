"""In-graph metric ops (counterpart of ``paddle_tpu/ops/logic_ops.py``;
``accuracy``)."""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("accuracy", doc="accuracy_op.cc: top-k accuracy from Indices")
def _accuracy(ctx):
    indices = ctx.input("Indices")       # [N, k] from top_k
    label = ctx.input("Label")           # [N, 1]
    n = indices.shape[0]
    correct = (indices == label.to(indices.dtype)).any(dim=1)
    num_correct = correct.sum(dtype=torch.int32)
    ctx.set_output("Accuracy", num_correct.float() / n)
    ctx.set_output("Correct", num_correct)
    ctx.set_output("Total", torch.tensor(n, dtype=torch.int32,
                                         device=indices.device))
