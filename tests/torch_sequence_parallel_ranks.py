"""Rank-side functions of tests/test_torch_sequence_parallel.py (run by
`_torch_mesh_pool.RankPool` on every rank of a gloo world; they import
the port only).  Every rank gets the same global arrays, takes its own
shard, and returns plain numpy values for the test to compare with the
JAX package."""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from paddle_tpu_torch.parallel import (collectives, create_mesh,
                                       pipeline_apply, pipeline_reference,
                                       pipeline_window,
                                       sequence_parallel_attention)
from paddle_tpu_torch.observability import introspect


def _shard(a, n, r, dim=1):
    size = a.shape[dim] // n
    return np.take(a, np.arange(r * size, (r + 1) * size), axis=dim)


def attention(strategy, causal, q, k, v, w=None, dtype="float32"):
    """This rank's output shard of `sequence_parallel_attention` over the
    global [B, T, H, D] q, k, v on an "sp" axis of the whole world (and
    with ``w`` the q, k, v gradient shards of sum(out * w)), with the
    collectives' ledgers of the forward and of the whole."""
    n = dist.get_world_size()
    mesh = create_mesh({"sp": n})
    r = mesh.coords["sp"]
    dt = getattr(torch, dtype)
    ts = [torch.tensor(_shard(a, n, r)).to(dt).requires_grad_(w is not None)
          for a in (q, k, v)]
    collectives.reset_counts()
    out = sequence_parallel_attention(*ts, mesh, axis="sp",
                                      strategy=strategy, causal=causal)
    fwd = collectives.ledger()
    res = {"out": out.detach().float().numpy(), "fwd": fwd}
    if w is not None:
        wt = torch.tensor(_shard(w, n, r)).to(dt)
        (out.float() * wt.float()).sum().backward()
        res["grads"] = [t.grad.float().numpy() for t in ts]
        res["all"] = collectives.ledger()
    return res


def refuse_heads():
    """Ulysses over 6 heads on the 4-rank axis -> the error text."""
    mesh = create_mesh({"sp": dist.get_world_size()})
    x = torch.zeros(1, 2, 6, 8)
    try:
        sequence_parallel_attention(x, x, x, mesh, strategy="ulysses")
    except ValueError as e:
        return str(e)
    return None


def ppermute_round_trip(shift):
    """Each rank's tensor hopped by ``shift``: (what arrived, the
    gradient of sum(arrived * (rank + 1)) back at the sender, counts)."""
    n = dist.get_world_size()
    mesh = create_mesh({"sp": n})
    group, r = mesh.group("sp"), mesh.coords["sp"]
    x = (torch.arange(6, dtype=torch.float32) + 10 * r).reshape(2, 3)
    x.requires_grad_(True)
    collectives.reset_counts()
    got = collectives.ppermute(x, group, "sp", shift)
    (got * (r + 1)).sum().backward()
    return {"got": got.detach().numpy(), "grad": x.grad.numpy(),
            "ledger": collectives.ledger()}


def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def pipeline(params, x, n_micro, grad=False, axes=None):
    """`pipeline_apply` of the JAX test's stage over the "pp" axis of a
    mesh of ``axes`` (all the world on "pp" by default) -> (output, with
    ``grad`` this rank's stage's gradients of sum(out ** 2), the ledger,
    the reference's output)."""
    mesh = create_mesh(axes or {"pp": dist.get_world_size()})
    idx = mesh.coords.get("pp", 0)
    ps = {k: torch.tensor(v).requires_grad_(grad) for k, v in params.items()}
    xt = torch.tensor(x)
    collectives.reset_counts()
    out = pipeline_apply(_stage, ps, xt, mesh, axis="pp",
                         n_microbatches=n_micro)
    res = {"out": out.detach().numpy(), "ledger": None}
    if grad:
        (out ** 2).sum().backward()
        res["grads"] = {k: t.grad[idx].numpy() for k, t in ps.items()}
        res["other_rows_zero"] = all(
            bool((torch.cat([t.grad[:idx], t.grad[idx + 1:]]) == 0).all())
            for t in ps.values())
    res["ledger"] = collectives.ledger()
    with torch.no_grad():
        res["reference"] = pipeline_reference(
            _stage, {k: torch.tensor(v) for k, v in params.items()},
            xt).numpy()
    return res


def window(params, xw, n_micro):
    """`pipeline_window` -> (outputs, schedule, this rank's reports)."""
    mesh = create_mesh({"pp": dist.get_world_size()})
    since = introspect.count()
    ps = {k: torch.tensor(v) for k, v in params.items()}
    out, sched = pipeline_window(_stage, ps, torch.tensor(xw), mesh,
                                 n_microbatches=n_micro)
    reps = [r for r in introspect.reports(since_seq=since)
            if r["layer"] in ("pipeline", "pipeline_stage")]
    return {"out": out.numpy(), "schedule": sched, "reports": reps}
