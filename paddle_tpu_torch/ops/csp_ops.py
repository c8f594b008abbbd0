"""In-program CSP op rules (counterpart of ``paddle_tpu/ops/csp_ops.py``):
``channel_create``, ``channel_send``, ``channel_recv``,
``channel_close``, ``go`` and ``select``.

A channel is a host `concurrency.Channel` in the env.  The port is
eager, so a payload stays a tensor on its device: a send hands the
receiver the tensor itself (the rules write no tensor in place), and
``is_copy`` sends a ``clone()``.  A receive on a closed, drained channel
gives zeros of the output var's shape and dtype on the executor's
device, and a Status of False.

``go`` runs its block on a daemon thread over the shared env (writes in
the block are visible outside; the channel rendezvous is the
synchronisation), with every op of the block run.  Grad mode, autocast
and the current CUDA device and stream belong to each thread in torch,
so the thread takes the spawning thread's.  The thread is recorded
under ``@GO_THREADS@``; the executor joins it before the run returns and
raises what the block raised (`core.lowering.join_go_threads`).

``select`` is `concurrency.select_loop` over its cases: a case fires when
its channel is ready, performs the send or receive, then runs its
sub-block; a receive case fires on a closed, drained channel too,
leaving its value var as it was.  With a default case the channel cases
are probed once and the default runs when none is ready.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..concurrency import Channel, ChannelClosed, select_loop
from ..core.lowering import GO_THREADS, ExecContext
from ..core.registry import register_op
from ..core.types import to_torch_dtype

#: the bounded wait of a select case between its readiness probe and the
#: rendezvous (a competing thread may win it)
_PROBE_S = 0.001


def _status(ctx: ExecContext, ok: bool) -> torch.Tensor:
    return torch.tensor(bool(ok), device=ctx.device)


def _payload(ctx: ExecContext, v) -> torch.Tensor:
    """A received value as a tensor: a tensor as it is, anything a host
    sender put on the channel on the executor's device."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v), device=ctx.device)


@register_op("channel_create",
             doc="channel_create: a host Channel object in the env")
def _channel_create(ctx: ExecContext):
    ctx.set_output("Out", Channel(capacity=ctx.attr("capacity", 0)))


@register_op("channel_send", doc="channel_send: blocking send; Status "
                                 "False on a closed channel")
def _channel_send(ctx: ExecContext):
    ch = ctx.input("Channel")
    x = ctx.input("X")
    if ctx.attr("is_copy", False) and isinstance(x, torch.Tensor):
        x = x.clone()
    ok = True
    try:
        ch.send(x)
    except ChannelClosed:
        ok = False
    ctx.set_output("Status", _status(ctx, ok))


@register_op("channel_recv", doc="channel_recv: blocking recv; Status "
                                 "False once closed and drained")
def _channel_recv(ctx: ExecContext):
    ch = ctx.input("Channel")
    v, ok = ch.recv()
    if not ok:
        var = ctx.block._find_var_recursive(ctx.output_name("Out"))
        shape = tuple(d for d in ((var.shape if var is not None else None)
                                  or (1,)) if d and d > 0) or (1,)
        dtype = to_torch_dtype((var.dtype if var is not None else None)
                               or "float32")
        v = torch.zeros(shape, dtype=dtype, device=ctx.device)
    ctx.set_output("Out", _payload(ctx, v))
    ctx.set_output("Status", _status(ctx, ok))


@register_op("channel_close", doc="channel_close")
def _channel_close(ctx: ExecContext):
    ctx.input("Channel").close()


def _thread_state(ctx: ExecContext):
    """The spawning thread's grad mode, autocast state, CUDA device and
    stream, as a context maker for another thread."""
    grad = torch.is_grad_enabled()
    autocast = {dt: (torch.is_autocast_enabled(dt),
                     torch.get_autocast_dtype(dt)) for dt in ("cuda", "cpu")}
    dev = ctx.device
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

    def enter(stack):
        stack.enter_context(torch.set_grad_enabled(grad))
        for dt, (on, dtype) in autocast.items():
            if on:
                stack.enter_context(torch.autocast(dt, dtype=dtype))
        if stream is not None:
            stack.enter_context(torch.cuda.device(dev))
            stack.enter_context(torch.cuda.stream(stream))
    return enter


@register_op("go", doc="go_op: run a sub-block on a host thread over the "
                       "shared env")
def _go(ctx: ExecContext):
    import contextlib
    sub = ctx.program.blocks[ctx.attr("sub_block")]
    env = ctx.env
    enter = _thread_state(ctx)

    def run():
        try:
            with contextlib.ExitStack() as stack:
                enter(stack)
                ctx.run_sub_block(sub, env)
        except ChannelClosed:
            pass
        except BaseException as e:  # noqa: BLE001  (raised at the join)
            thread.error = e

    thread = threading.Thread(target=run, daemon=True)
    thread.error = None
    env.setdefault(GO_THREADS, []).append(thread)
    thread.start()


@register_op("select",
             doc="select_op: block until one channel case is ready, "
                 "perform its send or receive, then run that case's "
                 "sub-block; the wait is a condition variable every "
                 "watched channel notifies; with a default case the "
                 "channel cases get one probe each and the default runs "
                 "when none is ready; the scan origin rotates per pass")
def _select(ctx: ExecContext):
    # cases: [{type: send|recv|default, channel: var name, value: var
    # name, sub_block: idx}, ...]
    cases = ctx.attr("cases")
    default = next((c for c in cases if c["type"] == "default"), None)

    def make_attempt(case, ch):
        kind = case["type"]

        def attempt():
            try:
                if kind == "send":
                    if not ch.ready_for_send():
                        return False, None
                    if not ch.send(ctx.env[case["value"]],
                                   timeout=_PROBE_S):
                        return False, None
                else:
                    if not ch.ready_for_recv():
                        return False, None
                    v, ok = ch.recv(timeout=_PROBE_S)
                    if ok:
                        ctx.env[case["value"]] = _payload(ctx, v)
                    # closed and drained: the case still fires
            except TimeoutError:
                return False, None
            except ChannelClosed:
                pass                                 # the case still fires
            _run_case(ctx, case)
            return True, None
        return attempt

    loop_cases = []
    for case in cases:
        if case["type"] != "default":
            ch = ctx.env[case["channel"]]
            loop_cases.append((ch, make_attempt(case, ch)))
    default_fn = ((lambda: _run_case(ctx, default))
                  if default is not None else None)
    select_loop(loop_cases, default_fn)


def _run_case(ctx: ExecContext, case):
    idx = case.get("sub_block", -1)
    if idx is not None and idx >= 0:
        ctx.run_sub_block(ctx.program.blocks[idx], ctx.env)
