"""The parameter server's op rules, ``listen_and_serv`` and ``send``
(counterpart of ``paddle_tpu/ops/dist_ops.py``): a host-side TCP control
plane (`distributed.param_server`), not a data plane; the mesh's
collectives (`parallel`) are the data plane."""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import register_op
from ..core.types import to_torch_dtype


@register_op("listen_and_serv",
             doc="serve a program sub-block over TCP; fan_in sends a "
                 "round, summed; the bound port to the selected-port file")
def _listen_and_serv(ctx):
    from ..distributed.param_server import ParamServer, ParamServerService

    sub = ctx.program.blocks[ctx.attr("sub_block")]
    out_names = ctx.attr("out_vars")
    endpoint = ctx.attr("endpoint", "127.0.0.1:0")
    fan_in = ctx.attr("Fanin", 1)
    host, _, port = endpoint.partition(":")
    device = ctx.device
    # one server env across rounds: the state an optimize sub-block
    # writes carries over to the next round
    server_env = dict(ctx.env)

    def serve_fn(feed):
        server_env.update({k: torch.tensor(np.asarray(v), device=device)
                           for k, v in feed.items()})
        with torch.no_grad():
            ctx.run_sub_block(sub, server_env)
        out = {}
        for n in out_names:
            if n in server_env:
                out[n] = server_env[n].detach().cpu().numpy()
                ctx.env[n] = server_env[n]
        return out

    service = ParamServerService(
        serve_fn, fan_in=fan_in,
        round_deadline=ctx.attr("round_deadline", 600.0))
    server = ParamServer(service, host=host or "127.0.0.1",
                         port=int(port or 0))
    # the op serves until a shutdown message arrives
    server.serve_until_shutdown()
    server.server_close()


@register_op("send",
             doc="one synchronous round trip against a ListenAndServ "
                 "endpoint, in op order")
def _send(ctx):
    from ..distributed.param_server import send_round_trip

    endpoint = ctx.attr("endpoint")
    in_names = ctx.input_names("X")
    out_names = ctx.output_names("Out")
    specs = []
    for n in out_names:
        var = ctx.block.vars.get(n)
        if var is None or var.shape is None or any(
                (d is None or d < 0) for d in var.shape):
            raise ValueError(
                f"send: output var {n!r} needs a concrete shape "
                "(create_var with the expected recv shape)")
        specs.append((tuple(var.shape), to_torch_dtype(var.dtype)))
    feed = {n: ctx.env[n].detach().cpu().numpy() for n in in_names}
    got = send_round_trip(endpoint, feed)
    for n, (shape, dtype) in zip(out_names, specs):
        if n not in got:
            raise KeyError(f"send: server block did not produce var {n!r}; "
                           f"served vars: {sorted(got)}")
        ctx.env[n] = torch.tensor(np.asarray(got[n]),
                                  device=ctx.device).to(dtype).reshape(shape)
