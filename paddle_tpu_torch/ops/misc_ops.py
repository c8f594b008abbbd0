"""Miscellaneous op rules (counterpart of ``paddle_tpu/ops/misc_ops.py``;
the ops the training programs use)."""
from __future__ import annotations

from ..core.registry import register_op


@register_op("sharding_constraint",
             doc="pins an activation's logical-axis layout on a mesh; the "
                 "port runs on one card with no mesh, so it is the "
                 "identity")
def _sharding_constraint(ctx):
    ctx.set_output("Out", ctx.input("X"))
