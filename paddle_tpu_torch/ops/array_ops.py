"""Tensor-array and debug-print op rules (counterpart of
``paddle_tpu/ops/array_ops.py``).

An array is a Python list in the env, as in the JAX package; the port
runs eagerly, so an index is always a concrete value (read from the
device: one sync a read or write with a device index).

``print`` prints the message and the value when the op runs; the JAX
rule's ``jax.debug.print`` prints it when the device computes it, which
for the port's eager ops is the same moment.  ``print_grad`` is an
identity whose backward prints the cotangent flowing through it.
``seq_text_printer`` appends decoded id sequences to a file.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import register_op


def _index(i) -> int:
    return int(i.reshape(()).item()) if isinstance(i, torch.Tensor) \
        else int(i)


@register_op("write_to_array")
def _write_to_array(ctx):
    name = ctx.output_name("Out")
    arr = ctx.env.get(name)
    arr = list(arr) if isinstance(arr, list) else []
    idx = _index(ctx.input("I"))
    while len(arr) <= idx:
        arr.append(None)
    arr[idx] = ctx.input("X")
    ctx.env[name] = arr


@register_op("read_from_array")
def _read_from_array(ctx):
    ctx.set_output("Out", ctx.input("X")[_index(ctx.input("I"))])


@register_op("array_length")
def _array_length(ctx):
    ctx.set_output("Out", torch.tensor(len(ctx.input("X")),
                                       dtype=torch.int32, device=ctx.device))


@register_op("print")
def _print(ctx):
    x = ctx.input("In")
    print(ctx.attr("message", "") + f" {x.detach().cpu().numpy()}",
          flush=True)
    ctx.set_output("Out", x)


def print_cotangent(dy: torch.Tensor):
    """The ``[gradient_printer]`` line of a cotangent (the JAX probe's)."""
    print(f"[gradient_printer] {dy.detach().cpu().numpy()}", flush=True)


class GradProbe(torch.autograd.Function):
    """Identity whose backward prints the cotangent."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        print_cotangent(dy)
        return dy


@register_op("print_grad",
             doc="print_op.cc print_phase=backward: an identity whose "
                 "backward prints the cotangent through this edge")
def _print_grad(ctx):
    ctx.set_output("Out", GradProbe.apply(ctx.input("In")))
    ctx.set_seq_len("Out", ctx.seq_len_of("In"))


@register_op("seq_text_printer",
             doc="v1 seqtext_printer_evaluator: decode id sequences "
                 "through a dict and append them to a file")
def _seq_text_printer(ctx):
    ids = ctx.input("Ids").detach().cpu().numpy()
    lengths = ctx.seq_len_of("Ids")
    sample_ids = ctx.input("SampleIds")
    dict_file = ctx.attr("dict_file", "") or ""
    vocab = None
    if dict_file:
        with open(dict_file) as f:
            vocab = [line.rstrip("\n") for line in f]
    sep = " " if ctx.attr("delimited", True) else ""
    if ids.ndim == 1:
        ids = ids[:, None]
    n = ids.shape[0]
    lens = (lengths.cpu().numpy() if lengths is not None
            else np.full((n,), ids.shape[1]))
    sids = (sample_ids.cpu().numpy().reshape(-1)
            if sample_ids is not None else None)
    with open(ctx.attr("result_file"), "a") as f:
        for i in range(n):
            toks = ids[i, :int(lens[i])].reshape(-1)
            text = sep.join(vocab[int(t)] if vocab and 0 <= int(t) < len(vocab)
                            else str(int(t)) for t in toks)
            sid = int(sids[i]) if sids is not None else i
            f.write(f"{sid}\t{text}\n")
    ctx.set_output("Out", torch.zeros((), dtype=torch.int32,
                                      device=ctx.device))
