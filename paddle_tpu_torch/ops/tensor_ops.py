"""Tensor creation and manipulation op rules (counterpart of
``paddle_tpu/ops/tensor_ops.py``; the ops the training programs use)."""
from __future__ import annotations

import torch

from ..core.registry import register_op
from ..core.types import to_torch_dtype


def _dtype(ctx, key="dtype", default="float32") -> torch.dtype:
    return to_torch_dtype(ctx.attr(key, default))


@register_op("fill_constant")
def _fill_constant(ctx):
    ctx.set_output("Out", torch.full(tuple(ctx.attr("shape", [1])),
                                     ctx.attr("value", 0.0),
                                     dtype=_dtype(ctx), device=ctx.device))


@register_op("assign_value")
def _assign_value(ctx):
    vals = torch.tensor(ctx.attr("values"), dtype=_dtype(ctx))
    ctx.set_output("Out", vals.reshape(ctx.attr("shape")).to(ctx.device))


@register_op("reshape")
def _reshape(ctx):
    x = ctx.input("X")
    # Fluid semantics: 0 keeps the input's dim, -1 is inferred
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(ctx.attr("shape"))]
    ctx.set_output("Out", x.reshape(shape))


@register_op("transpose")
def _transpose(ctx):
    ctx.set_output("Out", ctx.input("X").permute(*ctx.attr("axis")))


@register_op("slice")
def _slice(ctx):
    x = ctx.input("Input")
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(ctx.attr("axes"), ctx.attr("starts"),
                       ctx.attr("ends")):
        idx[a] = slice(s, e)
    ctx.set_output("Out", x[tuple(idx)])


def _generator(ctx) -> torch.Generator:
    """A nonzero ``seed`` attribute pins the op's own stream (the JAX
    rule's ``PRNGKey(seed)``); 0 draws from the executor's generator."""
    seed = ctx.attr("seed", 0)
    if not seed:
        return ctx.next_rng()
    g = torch.Generator(device=ctx.device)
    g.manual_seed(int(seed))
    return g


@register_op("uniform_random")
def _uniform_random(ctx):
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    u = torch.rand(tuple(ctx.attr("shape")), generator=_generator(ctx),
                   dtype=_dtype(ctx), device=ctx.device)
    ctx.set_output("Out", u * (hi - lo) + lo)


@register_op("gaussian_random")
def _gaussian_random(ctx):
    n = torch.randn(tuple(ctx.attr("shape")), generator=_generator(ctx),
                    dtype=_dtype(ctx), device=ctx.device)
    ctx.set_output("Out", ctx.attr("mean", 0.0) + ctx.attr("std", 1.0) * n)
