"""GPipe pipeline parallelism over a ``"pp"`` mesh axis (counterpart of
``paddle_tpu/parallel/pipeline.py``).

Every rank of the axis holds one stage's parameters; microbatches march
through the ring with `collectives.ppermute`'s hop, one stage hop a
tick, for ``n_micro + n_stages - 1`` ticks (bubble
``(n_stages - 1) / (n_micro + n_stages - 1)``).  The JAX package runs
the schedule as one differentiable ``lax.scan`` under ``shard_map``; the
port is SPMD (`parallel.mesh`): every rank runs `pipeline_local` with
its own stage.

- A rank calls ``stage_fn`` only on ticks where it holds a real
  microbatch, so each stage runs ``n_micro`` times forward and
  ``n_micro`` times backward.  The JAX scan also computes the fill and
  drain ticks; their values are discarded and their gradient is zero,
  so the result is the same.  Those ticks hop zeros.
- The tick loop makes ``n_micro + n_stages - 1`` hops forward, as the
  JAX scan does, and as many reverse hops backward.  The backward
  (`_Pipeline`) is driven by hand in reverse tick order, so every rank
  makes its hops in the same order whatever its stage computed.
- The last stage's output reaches every rank through
  `collectives.reduce_from` (an all-reduce of the output, zeros on the
  other ranks: the JAX ``psum(where(last, out, 0))``).  Every rank then
  computes the same loss from the same output, so that all-reduce's
  backward is the identity (Megatron's g): an all-reduce there would
  make the gradients ``n_stages`` times too large.

``stacked_params`` keeps the JAX contract: a pytree whose leaves have a
leading ``[n_stages]`` dim; the rank uses its own stage's slice, and the
gradient reaches only that slice.

`pipeline_window`'s reports take a stage's flops from its first window:
the aten products ``FlopCounterMode`` sees plus the product flops the
kernels report (`kernels.kernel_flops`: the flash kernels' on the
card, where their plain versions' products would be aten ops).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from . import collectives as coll
from ..ops import kernels as K


class _Pipeline(torch.autograd.Function):
    """The tick loop of one rank (module docstring).  ``flat`` are the
    stage's parameter leaves; the backward differentiates each real
    tick's stage graph, kept from the forward."""

    @staticmethod
    def forward(ctx, x_micro, spec, stage_fn, group, axis, n, idx, track,
                *flat):
        n_micro = x_micro.shape[0]
        leaves = [p.detach().requires_grad_(track and p.requires_grad)
                  for p in flat]
        params = pytree.tree_unflatten(leaves, spec)
        buf = torch.zeros_like(x_micro[0])
        ticks, outs = [], []
        for t in range(n_micro + n - 1):
            m = t - idx
            if 0 <= m < n_micro:
                a_in = (x_micro[m] if idx == 0 else buf).detach()
                a_in.requires_grad_(track and (idx > 0
                                               or x_micro.requires_grad))
                with torch.set_grad_enabled(track):
                    a_out = stage_fn(params, a_in)
                ticks.append((a_in, a_out))
                if idx == n - 1:
                    outs.append(a_out.detach())
                sent = a_out.detach()
            else:
                ticks.append(None)
                sent = torch.zeros_like(buf)
            buf = coll.hop(sent, group, axis, 1)
        ctx.meta = (ticks, leaves, group, axis, n, idx,
                    x_micro.requires_grad)
        if idx == n - 1:
            return torch.stack(outs)
        return torch.zeros_like(x_micro)

    @staticmethod
    def backward(ctx, g_out):
        ticks, leaves, group, axis, n, idx, x_grad = ctx.meta
        n_micro = g_out.shape[0]
        wanted = [p for p in leaves if p.requires_grad]
        grads = [torch.zeros_like(p) if p.requires_grad else None
                 for p in leaves]
        dx = torch.zeros_like(g_out) if x_grad else None
        g_in = torch.zeros_like(g_out[0])
        for t in range(n_micro + n - 2, -1, -1):
            # the reverse of tick t's hop: the gradient of what this rank
            # sent at tick t comes back from the rank it went to
            g = coll.hop(g_in, group, axis, -1)
            g_in = torch.zeros_like(g_out[0])
            if ticks[t] is None:
                continue
            a_in, a_out = ticks[t]
            m = t - idx
            if idx == n - 1:
                g = g_out[m]
            wrt = ([a_in] if a_in.requires_grad else []) + wanted
            if not wrt:
                continue
            got = torch.autograd.grad(a_out, wrt, g, allow_unused=True)
            if a_in.requires_grad:
                if idx == 0:
                    dx[m] = got[0]
                else:
                    g_in = got[0]
                got = got[1:]
            it = iter(got)
            for i, p in enumerate(leaves):
                if p.requires_grad:
                    d = next(it)
                    if d is not None:
                        grads[i] += d
        ctx.meta = None
        return (dx, None, None, None, None, None, None, None, *grads)


def pipeline_local(stage_fn: Callable, stage_params, x_micro, mesh,
                   axis: str = "pp") -> torch.Tensor:
    """One rank's pipeline (module docstring).

    ``stage_fn(params, x) -> y``: this rank's stage (same shape in and
    out); ``stage_params``: its parameters; ``x_micro``: ``[n_micro,
    micro_batch, ...]``, read by stage 0 only (every rank passes the same
    shape).  -> ``[n_micro, micro_batch, ...]``: the outputs on the last
    stage, zeros on the others."""
    group, n, idx = coll.on_axis(mesh, axis)
    flat, spec = pytree.tree_flatten(stage_params)
    track = torch.is_grad_enabled() and any(
        t.requires_grad for t in [x_micro] + flat)
    return _Pipeline.apply(x_micro, spec, stage_fn, group, axis, n, idx,
                           track, *flat)


def pipeline_apply(stage_fn: Callable, stacked_params, x, mesh,
                   axis: str = "pp", n_microbatches: int = 4) -> torch.Tensor:
    """``stage_{n-1}(... stage_0(x))`` with GPipe microbatch scheduling
    over ``mesh[axis]``, the same value on every rank of the axis.

    ``stacked_params``: a pytree whose leaves have a leading
    ``[n_stages]`` dim (the rank uses its own stage's slice); ``x``:
    ``[batch, ...]``, the same on every rank, batch dividing into
    ``n_microbatches``."""
    group, n, idx = coll.on_axis(mesh, axis)
    for leaf in pytree.tree_leaves(stacked_params):
        if leaf.shape[0] != n:
            raise ValueError(f"stacked_params leading dim {leaf.shape[0]} "
                             f"!= mesh['{axis}'] size {n}")
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} does not divide into "
                         f"{n_microbatches} microbatches")
    x_m = x.reshape((n_microbatches, b // n_microbatches) + x.shape[1:])
    params = pytree.tree_map(lambda p: p[idx], stacked_params)
    out = pipeline_local(stage_fn, params, x_m, mesh, axis)
    # the last stage's output to every rank (zeros elsewhere)
    out = coll.reduce_from(out, group, axis)
    return out.reshape((b,) + tuple(out.shape[2:]))


def pipeline_reference(stage_fn: Callable, stacked_params, x):
    """Serial oracle: the stages in order on one device."""
    n_stages = pytree.tree_leaves(stacked_params)[0].shape[0]
    for i in range(n_stages):
        x = stage_fn(pytree.tree_map(lambda p, i=i: p[i], stacked_params),
                     x)
    return x


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """The GPipe schedule's idle share: each of ``n_stages`` ranks works
    ``n_microbatches`` of the ``n_microbatches + n_stages - 1`` ticks."""
    n_stages, n_micro = int(n_stages), int(n_microbatches)
    if n_stages < 1 or n_micro < 1:
        raise ValueError(f"need n_stages>=1, n_microbatches>=1, got "
                         f"({n_stages}, {n_micro})")
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_window(stage_fn: Callable, stacked_params, x_windows, mesh,
                    axis: str = "pp", n_microbatches: int = 4,
                    record: bool = True):
    """K pipelined windows: ``x_windows`` ``[K, batch, ...]`` ->
    ``(outputs [K, batch, ...], schedule)``, the schedule with the JAX
    keys (``n_stages``, ``n_microbatches``, ``windows``,
    ``ticks_per_window``, ``bubble_fraction``, and with ``record`` the
    ``report_seqs`` of this rank's reports: one for the whole run,
    ``layer="pipeline"``, and one for the stage it runs,
    ``layer="pipeline_stage"``)."""
    n_stages = int(mesh.shape.get(axis, 1))
    k, b = int(x_windows.shape[0]), int(x_windows.shape[1])
    if b % n_microbatches:
        raise ValueError(f"batch {b} does not divide into "
                         f"{n_microbatches} microbatches")
    schedule = {
        "n_stages": n_stages,
        "n_microbatches": int(n_microbatches),
        "windows": k,
        "ticks_per_window": int(n_microbatches) + n_stages - 1,
        "bubble_fraction": bubble_fraction(n_stages, n_microbatches),
    }
    from torch.utils.flop_counter import FlopCounterMode
    since = coll.counts()
    # the first window's n_micro stage calls give the stage's flops
    with FlopCounterMode(display=False) as fc, \
            K.kernel_flops() as kernel_fc:
        outs = [pipeline_apply(stage_fn, stacked_params, x_windows[0], mesh,
                               axis, n_microbatches)]
    outs += [pipeline_apply(stage_fn, stacked_params, x_windows[i], mesh,
                            axis, n_microbatches) for i in range(1, k)]
    out = torch.stack(outs)
    if record:
        schedule["report_seqs"] = _record_pipeline_reports(
            stacked_params, x_windows, out, mesh, axis, n_microbatches, k,
            (fc.get_total_flops() + kernel_fc[0]) / n_microbatches,
            coll.ledger(since))
    return out, schedule


def _record_pipeline_reports(stacked_params, x_windows, out, mesh, axis,
                             n_micro, k, stage_flops, ledger):
    """This rank's reports (`observability.introspect.record_run`): the
    whole run's (``steps=K``, every rank of the axis) and its stage's
    (one microbatch call)."""
    from ..observability import introspect

    _, n, idx = coll.on_axis(mesh, axis)
    mesh_shape = {str(a): int(s) for a, s in mesh.shape.items()}
    dtype = str(x_windows.dtype).replace("torch.", "")
    leaves = pytree.tree_leaves(stacked_params)
    stage_bytes = sum(p[idx].numel() * p.element_size() for p in leaves)
    micro = x_windows.shape[1] // n_micro
    micro_shape = (micro,) + tuple(x_windows.shape[2:])
    micro_bytes = x_windows[0, :micro].numel() * x_windows.element_size()
    whole = introspect.record_run(
        layer="pipeline", device=x_windows.device,
        fingerprint=f"pipeline[{axis}]",
        feed_sig=(("x", tuple(x_windows.shape), dtype),),
        fetch_names=("out",),
        # the stage runs n_micro microbatches a window
        flops=stage_flops * n_micro, steps=k,
        argument_bytes=stage_bytes + introspect.tensor_bytes([x_windows]),
        output_bytes=introspect.tensor_bytes([out]), dtype=dtype,
        mesh_shape=mesh_shape, num_devices=n, collectives=ledger)
    stage = introspect.record_run(
        layer="pipeline_stage", device=x_windows.device,
        fingerprint=f"pipeline[{axis}]:stage{idx}",
        feed_sig=(("x", micro_shape, dtype),), fetch_names=(f"stage{idx}",),
        flops=stage_flops, steps=1, argument_bytes=stage_bytes + micro_bytes,
        output_bytes=micro_bytes, dtype=dtype, mesh_shape={axis: 1},
        num_devices=1)
    return [whole.seq, stage.seq]
