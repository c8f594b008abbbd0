"""Loss-scaling op rules of mixed-precision training (counterpart of
``paddle_tpu/ops/amp_ops.py``).

Both rules stay on the device: ``check_finite_and_unscale`` reduces every
gradient's finiteness (a SelectedRows gradient's by its row values) to
one boolean tensor, and ``update_loss_scaling``
moves the scale with selects, so a step never waits on the host to learn
that it overflowed.  The update skip itself is the interpreter's
(`core.lowering`): an optimize op wired with ``FoundInf`` and the
``skip_on_found_inf`` attribute commits its outputs only where the flag
is false.  Under a fast mesh the flag is max-reduced over every rank
(`parallel.partitioner.StepSharding.any_rank`).
"""
from __future__ import annotations

import torch

from ..core.lowering import ROWS_SUFFIX, VALUES_SUFFIX
from ..core.registry import register_op


@register_op("check_finite_and_unscale",
             doc="check_finite_and_unscale_op.cc: one device boolean for "
                 "all gradients, gradients unscaled into f32")
def _check_finite_and_unscale(ctx):
    scale = ctx.input("Scale")
    inv = 1.0 / scale.reshape(()).float()
    finite = []
    for n_in, n_out in zip(ctx.op.desc.inputs.get("X", []),
                           ctx.output_names("Out")):
        g = ctx.env.get(n_in)
        if g is not None:
            finite.append(torch.isfinite(g).all())
            ctx.env[n_out] = g.float() * inv
            continue
        # a SelectedRows gradient (an is_sparse table): check and unscale
        # its row values, carry its rows
        vals = ctx.env.get(n_in + VALUES_SUFFIX)
        if vals is not None:
            finite.append(torch.isfinite(vals).all())
            ctx.env[n_out + VALUES_SUFFIX] = vals.float() * inv
            ctx.env[n_out + ROWS_SUFFIX] = ctx.env[n_in + ROWS_SUFFIX]
    if finite:
        found = torch.logical_not(torch.stack(finite).all())
    else:
        found = torch.zeros((), dtype=torch.bool, device=scale.device)
    step = ctx.interpreter.partitioner
    if step is not None:
        # every rank skips together, so the loss scales stay equal
        found = step.any_rank(found)
    ctx.set_output("FoundInf", found)


@register_op("update_loss_scaling",
             doc="update_loss_scaling_op.cc: an overflow multiplies the "
                 "scale by decr_ratio (floored) and zeroes the clean-step "
                 "counter; incr_every_n_steps clean steps multiply it by "
                 "incr_ratio")
def _update_loss_scaling(ctx):
    found = ctx.input("FoundInf").reshape(()).bool()
    scale = ctx.input("LossScaling").reshape(()).float()
    good = ctx.input("GoodSteps").reshape(()).int()
    incr_every = int(ctx.attr("incr_every_n_steps", 1000))
    incr_ratio = float(ctx.attr("incr_ratio", 2.0))
    decr_ratio = float(ctx.attr("decr_ratio", 0.5))
    min_scale = float(ctx.attr("min_loss_scaling", 1.0))
    max_scale = float(ctx.attr("max_loss_scaling", 2.0 ** 31))
    zero = torch.zeros_like(good)
    good_new = torch.where(found, zero, good + 1)
    grow = good_new >= incr_every
    scale_new = torch.where(
        found, torch.clamp(scale * decr_ratio, min=min_scale),
        torch.where(grow, torch.clamp(scale * incr_ratio, max=max_scale),
                    scale))
    good_new = torch.where(grow, zero, good_new)
    ctx.set_output("LossScalingOut", scale_new.reshape(1))
    ctx.set_output("GoodStepsOut", good_new.reshape(1))
