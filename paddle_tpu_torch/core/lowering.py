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

Optimize ops commit in place.  An op of the ``optimize`` role (the
optimizer, the loss scaler, ModelAverage's accumulation) computes its
outputs out of place; the interpreter then copies each output into the
tensor its name held before the op (the scope's own parameter or
accumulator), so a step copies no state and scope tensors keep their
storage.  An op wired with ``FoundInf`` and ``skip_on_found_inf``
(`optimizer.MixedPrecision`) commits with ``torch.where(found, old,
new)`` instead: on an overflowed step every parameter, moment and beta
pow keeps its pre-step bits, with no host sync and no rule edited one by
one.  (The JAX interpreter selects back immutable values; eager in-place
updates would alias the snapshot, hence the out-of-place rules.)

``check_nan_inf`` poisons every non-finite floating output of an op with
NaN on the device (the JAX ``_guard_outputs``), so the executor's one
finite check of the fetches sees it.

Ragged values keep the JAX package's representation: a padded dense
tensor plus a companion int32 length vector named ``<name>@SEQ_LEN`` in
the env (fed beside the data, carried along by the rules).  Sub-blocks
(a DynamicRNN's step block, a While's body) are run by their op's rule,
which hands each of their ops an `ExecContext` whose ``block`` is the
sub-block.

Dead ops are skipped.  XLA drops what no output needs; an eager
interpreter would run it.  Before a block runs, one backward pass over
its ops marks an op live when one of its outputs is fetched, read by a
later live op, read in a sub-block or persistable, or when it is an
optimize-role, in-place, printing or control op, a ``kv_cache_write``
(it writes the KV pools in place, which a prefill that fetches only its
logits must still see), an op with no outputs, or a rule that draws from
the executor's generator (skipping one would shift every later draw).
The rest do not run (a training program's unfetched inference head,
say).  ``Interpreter.skip_dead_ops = False``
runs every op, for measuring what the skip saves.

``calc_gradient`` may append several ``backward`` ops: the interpreter
records up to the last live one, and each keeps the graph for the next.

Meshes.  Under a fast-numerics mesh the executor hands the interpreter
the step's `parallel.partitioner.StepSharding` (``partitioner=``); the
rules that shard read it (the column and row products, the gradient
reduction of the ``backward`` rule, the loss scaler's flag, the ZeRO
optimizer branch).  Exact numerics runs the plain interpreter on the
gathered state.

``Interpreter.memo`` holds what the rules of one run share: the KV-cache
write plan, computed once for every ``kv_cache_write`` of a generation
step (one host sync a step instead of one a layer).  It lives and dies
with the run's interpreter.

SelectedRows.  A table a live ``backward`` op lists in
``sparse_params`` never requires grad: its ``is_sparse`` lookups make
their gathered rows the autograd leaves (``Interpreter.sparse_leaves``),
and the sparse branches of ``sgd``, ``momentum`` and ``adam`` hand the
commit a `RowUpdate`, which scatters only the merged rows into the
scope's tensor (``index_copy_``; under ``skip_on_found_inf`` the old
rows go back in where the step overflowed).

Rematerialisation (``memory_optimize`` sets ``program._memory_opt``).
The recorded forward ``[0, record_end)`` runs in segments at
``program._remat_bounds`` (clipped to the recorded slice), or at a
uniform sqrt(N) split without them, as the JAX backward rule cuts it.
Each segment runs its ops over its own copy of the env under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: autograd
keeps none of the tensors the segment saves for backward, and the env
keeps only the segment's live-out values (read by a later op, a
sub-block or the fetch list, persistable, or a length companion of
one).  The backward recomputes a segment from a snapshot of the env at
its entry.  A recompute draws again from the executor's generator at
the state it had on the segment's entry (and leaves it as it was), so
dropout masks repeat.  Print, KV-write and control ops, whose effects
must not happen twice, run outside any segment.  The dead-op skip and
``check_nan_inf`` see the same ops as without remat.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

import torch

from .program import Block, Operator, Program
from .registry import OpRegistry

#: suffix of the companion length vector of a ragged value
LEN_SUFFIX = "@SEQ_LEN"
#: suffixes of a SelectedRows gradient's row ids and row values in the env
#: (an is_sparse table's ``@GRAD``, `core.backward`)
ROWS_SUFFIX, VALUES_SUFFIX = "@ROWS", "@VALUES"
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

    def input_names(self, slot: str) -> List[str]:
        return self.op.desc.inputs.get(slot, [])

    def output_name(self, slot: str) -> Optional[str]:
        names = self.op.desc.outputs.get(slot, [])
        return names[0] if names else None

    def output_names(self, slot: str) -> List[str]:
        return self.op.desc.outputs.get(slot, [])

    def set_output(self, slot: str, value, idx: int = 0):
        names = self.op.desc.outputs.get(slot, [])
        if names:
            self.env[names[idx]] = value

    def set_outputs(self, slot: str, values):
        for name, value in zip(self.op.desc.outputs.get(slot, []), values):
            self.env[name] = value

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

    # -- sub-blocks ------------------------------------------------------------
    def run_sub_block(self, block: Block, env: Dict[str, Any]):
        """Run every op of a sub-block over ``env``, in order (a control
        op's body: no op of it is skipped)."""
        for op in block.ops:
            OpRegistry.get(op.type).fn(
                ExecContext(op, env, self.program, block, self.interpreter))


#: ops that always run: side effects the env does not show
PRINT_OPS = {"print", "print_grad", "seq_text_printer"}
#: ops that write an input tensor in place (the KV pools)
WRITE_OPS = {"kv_cache_write"}
#: attributes naming the sub-blocks a control op runs
SUB_BLOCK_ATTRS = ("sub_block", "true_block", "false_block")


class RowUpdate:
    """An optimize op's output that changes only some rows of the tensor
    its name holds: ``rows`` (int64, distinct, in range) take ``values``.
    The commit scatters them in place."""

    __slots__ = ("base", "rows", "values")

    def __init__(self, base: torch.Tensor, rows: torch.Tensor,
                 values: torch.Tensor):
        self.base, self.rows, self.values = base, rows, values


def remat_bounds(program: Program, record_end: int) -> List[int]:
    """The segment bounds of the recorded forward ``[0, record_end)``:
    the transpiler's liveness cuts, else a uniform sqrt(N) split (the JAX
    backward rule's)."""
    bounds = getattr(program, "_remat_bounds", None)
    if bounds:
        return sorted({min(b, record_end) for b in bounds}
                      | {0, record_end})
    n_seg = max(1, int(math.sqrt(record_end)))
    return [round(i * record_end / n_seg) for i in range(n_seg + 1)]


class Interpreter:
    """Runs a block's ops over an env on one device."""

    #: skip the ops no fetch, persistable or side effect needs (see the
    #: module docstring); False runs every op
    skip_dead_ops = True

    def __init__(self, program: Program, device: torch.device,
                 generator: torch.Generator,
                 fetch_names: Iterable[str] = (),
                 check_nan_inf: bool = False, partitioner=None):
        self.program = program
        #: the step's `parallel.partitioner.StepSharding` under a fast
        #: mesh (None otherwise): the product, constraint, gradient,
        #: loss-scaler and ZeRO branches of the rules read it
        self.partitioner = partitioner
        self.device = device
        self.generator = generator
        self.fetch_names = tuple(fetch_names)
        self.check_nan_inf = check_nan_inf
        self.needed = set()
        self.last_backward = None
        #: values the rules of this run share, by a key of the rule's
        #: choosing (module docstring)
        self.memo: Dict[Any, Any] = {}
        #: the SelectedRows tables of this run's live backward ops
        self.sparse_tables: Set[str] = set()
        #: lookup Out name -> (gathered rows, the autograd leaf; flat ids)
        self.sparse_leaves: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        #: names read outside the block being run (sub-blocks, fetches)
        self._outer_reads: Set[str] = set()

    def live_ops(self, block: Block) -> List[bool]:
        """Which ops of ``block`` run; also sets ``needed`` to the names a
        live op, a sub-block or the fetch list reads."""
        needed = set(self.fetch_names)
        for b in self.program.blocks:
            if b is not block:
                for op in b.ops:
                    needed.update(op.desc.input_names())
        self._outer_reads = set(needed)
        live = [True] * len(block.ops)
        for i in range(len(block.ops) - 1, -1, -1):
            op = block.ops[i]
            ins, outs = op.desc.input_names(), op.desc.output_names()
            control = any(k in op.desc.attrs for k in SUB_BLOCK_ATTRS)
            keep = (not self.skip_dead_ops or not outs or control
                    or op.type in PRINT_OPS or op.type in WRITE_OPS
                    or op.desc.attrs.get("op_role") == "optimize"
                    or OpRegistry.get(op.type).draws_rng
                    or any(n in needed for n in outs)
                    or any(n in ins for n in outs)
                    or any(self._persistable(block, n) for n in outs))
            live[i] = keep
            if keep:
                needed.update(ins)
                if control:
                    # a control op reads its carried vars' values on entry
                    needed.update(outs)
        self.needed = needed
        return live

    @staticmethod
    def _persistable(block: Block, name: str) -> bool:
        var = block._find_var_recursive(name)
        return var is not None and var.persistable

    def run_block(self, block: Block, env: Dict[str, Any]):
        live = self.live_ops(block)
        bwd = [i for i, op in enumerate(block.ops)
               if op.type == "backward" and live[i]]
        record_end = bwd[-1] if bwd else 0
        # the backward rule keeps the graph for a later backward op
        self.last_backward = block.ops[record_end] if bwd else None
        for i in bwd:
            self.sparse_tables.update(
                block.ops[i].desc.attrs.get("sparse_params") or ())
        for i in bwd:
            for name in block.ops[i].desc.attrs["params"]:
                val = env.get(name)
                if (name not in self.sparse_tables
                        and isinstance(val, torch.Tensor)
                        and val.is_floating_point()
                        and not val.requires_grad):
                    env[name] = val.detach().requires_grad_(True)
        start = 0
        if record_end and getattr(self.program, "_memory_opt", False):
            self._run_remat(block, env, live, record_end)
            start = record_end
        for i in range(start, len(block.ops)):
            if live[i]:
                self._run_op(block, env, i, i < record_end)
        return env

    def _run_op(self, block: Block, env: Dict[str, Any], i: int,
                record: bool):
        op = block.ops[i]
        rule = OpRegistry.get(op.type)
        ctx = ExecContext(op, env, self.program, block, self)
        prev = None
        if op.desc.attrs.get("op_role") == "optimize":
            prev = {n: env[n] for n in op.desc.output_names()
                    if isinstance(env.get(n), torch.Tensor)}
        with torch.set_grad_enabled(record):
            rule.fn(ctx)
        if record:
            self._stop_gradients(op, block, env)
        if prev:
            self._commit(op, env, prev)
        if self.check_nan_inf:
            self._poison_nonfinite(op, env, prev or {})

    # -- rematerialisation ---------------------------------------------------
    @staticmethod
    def _replay_safe(op: Operator) -> bool:
        """False for an op whose effect must not happen twice (a print, a
        KV write, a control op running a sub-block)."""
        return not (op.type in PRINT_OPS or op.type in WRITE_OPS
                    or any(k in op.desc.attrs for k in SUB_BLOCK_ATTRS))

    def _run_remat(self, block: Block, env: Dict[str, Any],
                   live: List[bool], record_end: int):
        """Ops ``[0, record_end)`` in checkpointed segments (module
        docstring); ops that must not replay run between them."""
        runs = []             # (lo, hi) checkpointed, or (i, None) plain
        bounds = remat_bounds(self.program, record_end)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            run_lo = lo
            for i in range(lo, hi + 1):
                if i < hi and self._replay_safe(block.ops[i]):
                    continue
                if any(live[run_lo:i]):
                    runs.append((run_lo, i))
                if i < hi and live[i]:
                    runs.append((i, None))
                run_lo = i + 1
        # keep[hi]: the names a sub-block, a fetch or a live op at hi or
        # later reads (a checkpointed run's live-out)
        ends = {hi for _, hi in runs if hi is not None}
        keep: Dict[int, Set[str]] = {}
        acc = set(self._outer_reads)
        for i in range(len(block.ops) - 1, -1, -1):
            if live[i]:
                acc.update(block.ops[i].desc.input_names())
            if i in ends:
                keep[i] = set(acc)
        for lo, hi in runs:
            if hi is None:
                self._run_op(block, env, lo, True)
            else:
                self._run_segment(block, env, live, lo, hi, keep[hi])

    def _run_segment(self, block: Block, env: Dict[str, Any],
                     live: List[bool], lo: int, hi: int, keep: Set[str]):
        from torch.utils.checkpoint import checkpoint
        snap = dict(env)
        gen = self.generator
        entry_state = gen.get_state()
        runs = [0]

        def segment():
            replay = runs[0] > 0
            runs[0] += 1
            if replay:
                # the recompute draws what the first run drew
                resume_state = gen.get_state()
                gen.set_state(entry_state)
            try:
                env2 = dict(snap)
                for i in range(lo, hi):
                    if live[i]:
                        self._run_op(block, env2, i, True)
                return env2
            finally:
                if replay:
                    gen.set_state(resume_state)

        out = checkpoint(segment, use_reentrant=False,
                         preserve_rng_state=False)
        for name in snap:
            if name not in out:
                env.pop(name, None)          # a delete_var in the segment
        for name, val in out.items():
            if snap.get(name) is val:
                continue
            if (name in keep or not isinstance(val, torch.Tensor)
                    or (name.endswith(LEN_SUFFIX)
                        and name[:-len(LEN_SUFFIX)] in keep)
                    or self._persistable(block, name)):
                env[name] = val

    @staticmethod
    def _commit(op: Operator, env: Dict[str, Any], prev: Dict[str, Any]):
        """Copy an optimize op's outputs into the tensors their names held
        before it (a `RowUpdate` scatters its rows); under
        ``skip_on_found_inf`` keep the old values where the step's
        FoundInf is set."""
        found = None
        if op.desc.attrs.get("skip_on_found_inf"):
            names = op.desc.inputs.get("FoundInf", [])
            if names and names[0] in env:
                found = env[names[0]].reshape(()).bool()
        with torch.no_grad():
            for name, old in prev.items():
                new = env[name]
                if isinstance(new, RowUpdate):
                    vals = new.values.to(old.dtype)
                    if found is not None:
                        vals = torch.where(
                            found, old.index_select(0, new.rows), vals)
                    old.index_copy_(0, new.rows, vals)
                    env[name] = old
                    continue
                if (new is old or not isinstance(new, torch.Tensor)
                        or new.shape != old.shape):
                    continue
                if found is None:
                    old.copy_(new)
                else:
                    torch.where(found, old, new.to(old.dtype), out=old)
                env[name] = old

    @staticmethod
    def _poison_nonfinite(op: Operator, env: Dict[str, Any],
                          committed: Dict[str, Any]):
        for name in op.desc.output_names():
            val = env.get(name)
            if (name in committed or not isinstance(val, torch.Tensor)
                    or not val.is_floating_point()):
                continue
            bad = torch.logical_not(torch.isfinite(val).all())
            # the poison is detached: a NaN must not reach the gradients
            # of the steps where nothing is bad (0 * NaN in where's VJP)
            env[name] = torch.where(bad, val.detach() * float("nan"), val)

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
