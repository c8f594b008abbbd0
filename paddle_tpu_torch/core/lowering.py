"""Interpreting a block op by op with torch functions (counterpart of
``paddle_tpu/core/lowering.py``).

The JAX package traces a whole block into one XLA computation; the port
runs each op's rule eagerly on the executor's device, over an ``env``
(variable name -> tensor) seeded from the scope and the feeds.

Training without replaying the forward: the JAX ``backward`` rule
re-interprets ops ``[0, forward_op_end)`` inside ``jax.grad`` and XLA
removes the duplicate.  Eagerly, a replay would double the forward.
Instead, when the block holds a ``backward`` op, the interpreter runs the
forward ops with autograd recording: the backward op's parameters enter
the env as leaves that require grad, and every output the program marks
``stop_gradient`` is detached.  The backward rule then differentiates the
recorded graph once (`core.backward`), and the ops after it (the
optimizer's) run without recording.

Ragged values keep the JAX package's representation: a padded dense
tensor plus a companion int32 length vector named ``<name>@SEQ_LEN`` in
the env (fed beside the data, carried along by the rules).  Sub-blocks
(a DynamicRNN's step block) are run by their op's rule, which hands each
of their ops an `ExecContext` whose ``block`` is the sub-block.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from .program import Block, Operator, Program
from .registry import OpRegistry

#: suffix of the companion length vector of a ragged value
LEN_SUFFIX = "@SEQ_LEN"
#: suffix of an int8 parameter's per-column dequantization scales in the
#: env (serving.Predictor at precision "int8"; the lookup_table rule
#: dequantizes only the rows it gathers)
QSCALE_SUFFIX = "@QSCALE@"
#: suffix of a lookup_table output's pre-gathered rows in the env (the
#: serving hot-row cache feeds them; the table itself is not in the env)
CACHED_ROWS_SUFFIX = "@CACHED_ROWS@"
#: int8 serving quantizes f32 2-D matrices of at least this many elements
INT8_MIN_ELEMENTS = 256


def quantize_int8(val: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column absmax int8 quantization of an f32 ``[K, N]`` matrix
    (the JAX predictor's ``_apply_precision``) -> (int8 values, f32
    scales ``[N]``): scales ``amax / 127`` (1 where a column is all
    zeros), values rounded and clipped to +-127."""
    amax = val.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(val / scale[None, :]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 values (a matrix, or rows gathered from one) times their
    column scales, multiplied in f32 and stored bf16 (the JAX forward's
    expand)."""
    return (q.float() * scale).to(torch.bfloat16)


class ExecContext:
    """One op's view of the env, handed to its rule."""

    __slots__ = ("op", "env", "program", "block", "interpreter")

    def __init__(self, op: Operator, env: Dict[str, Any], program: Program,
                 block: Block, interpreter: "Interpreter"):
        self.op = op
        self.env = env
        self.program = program
        self.block = block
        self.interpreter = interpreter

    # -- inputs/outputs ------------------------------------------------------
    def input(self, slot: str, default=None):
        names = self.op.desc.inputs.get(slot, [])
        if not names:
            return default
        return self.env[names[0]]

    def inputs(self, slot: str) -> List[Any]:
        return [self.env[n] for n in self.op.desc.inputs.get(slot, [])]

    def input_name(self, slot: str) -> Optional[str]:
        names = self.op.desc.inputs.get(slot, [])
        return names[0] if names else None

    def output_name(self, slot: str) -> Optional[str]:
        names = self.op.desc.outputs.get(slot, [])
        return names[0] if names else None

    def output_names(self, slot: str) -> List[str]:
        return self.op.desc.outputs.get(slot, [])

    def set_output(self, slot: str, value, idx: int = 0):
        names = self.op.desc.outputs.get(slot, [])
        if names:
            self.env[names[idx]] = value

    def output_needed(self, slot: str) -> bool:
        """True when a later op or the fetch list reads this output (a
        rule skips an output nobody reads, as XLA would drop it)."""
        name = self.output_name(slot)
        return name is not None and name in self.interpreter.needed

    # -- attrs ---------------------------------------------------------------
    def attr(self, key: str, default=None):
        return self.op.desc.attrs.get(key, default)

    # -- sequence-length companions ------------------------------------------
    def seq_len_of(self, slot: str):
        """The length vector of a ragged input, if one was fed (None for
        a dense one)."""
        name = self.input_name(slot)
        if name is None:
            return None
        return self.env.get(name + LEN_SUFFIX)

    def set_seq_len(self, slot: str, lengths):
        name = self.output_name(slot)
        if name is not None and lengths is not None:
            self.env[name + LEN_SUFFIX] = lengths

    # -- device and randomness -------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.interpreter.device

    def next_rng(self) -> torch.Generator:
        """The executor's generator (seeded once from the program's
        random_seed); its bits are not JAX's threefry bits."""
        return self.interpreter.generator


class Interpreter:
    """Runs a block's ops over an env on one device."""

    def __init__(self, program: Program, device: torch.device,
                 generator: torch.Generator,
                 fetch_names: Iterable[str] = ()):
        self.program = program
        self.device = device
        self.generator = generator
        self.fetch_names = tuple(fetch_names)
        self.needed = set()

    def run_block(self, block: Block, env: Dict[str, Any]):
        # an output read only inside a sub-block (a DynamicRNN's step
        # block) is needed too
        self.needed = set(self.fetch_names)
        for b in self.program.blocks:
            for op in b.ops:
                self.needed.update(op.desc.input_names())
        bwd_at = next((i for i, op in enumerate(block.ops)
                       if op.type == "backward"), None)
        if bwd_at is not None:
            for name in block.ops[bwd_at].desc.attrs["params"]:
                env[name] = env[name].detach().requires_grad_(True)
        for i, op in enumerate(block.ops):
            rule = OpRegistry.get(op.type)
            ctx = ExecContext(op, env, self.program, block, self)
            record = bwd_at is not None and i < bwd_at
            with torch.set_grad_enabled(record):
                rule.fn(ctx)
            if record:
                self._stop_gradients(op, block, env)
        return env

    @staticmethod
    def _stop_gradients(op: Operator, block: Block, env: Dict[str, Any]):
        for name in op.desc.output_names():
            var = block.vars.get(name)
            val = env.get(name)
            if (var is not None and var.desc.stop_gradient
                    and isinstance(val, torch.Tensor) and val.requires_grad):
                env[name] = val.detach()


def run_startup(program: Program, scope, device: torch.device,
                generator: torch.Generator):
    """Interpret a startup program to materialise its persistables into
    the scope, on ``device``."""
    env: Dict[str, Any] = dict(scope._vars)
    with torch.no_grad():
        Interpreter(program, device, generator).run_block(
            program.global_block(), env)
    for v in program.global_block().vars.values():
        if v.persistable and v.name in env:
            scope.set(v.name, env[v.name])
