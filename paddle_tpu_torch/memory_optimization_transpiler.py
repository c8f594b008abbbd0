"""Memory optimization pass (counterpart of
``paddle_tpu/memory_optimization_transpiler.py``; the reference's
``memory_optimization_transpiler.py:43-381``).

A copy of the JAX package's pure-Python pass: the same liveness
analysis, the same remat bounds and the same ``delete_var`` insertion,
so a program transpiled by either package is the same program.

- ``memory_optimize`` marks the program for rematerialisation and
  records segment bounds at the narrowest live sets
  (``program._remat_bounds``).  The port's interpreter runs the recorded
  forward in those segments under ``torch.utils.checkpoint``
  (`core.lowering`): only values live across a boundary stay for the
  backward, everything inside a segment is recomputed.
- ``release_memory`` inserts ``delete_var`` ops after each variable's
  last use (reference :381); the ``delete_var`` rule pops the env entry.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Set

from .core.program import OpDesc, Operator, Program, default_main_program

_DTYPE_BYTES = {"float32": 4, "float64": 8, "float16": 2, "bfloat16": 2,
                "int64": 8, "int32": 4, "int16": 2, "int8": 1, "uint8": 1,
                "bool": 1}


class ControlFlowGraph:
    """Dataflow liveness over a block's op list (reference
    memory_optimization_transpiler.py:43: uses/defs, then a backward
    live-out sweep; straight-line, since control flow lives in
    sub-blocks that run as single ops)."""

    def __init__(self, program: Program, block_idx: int = 0,
                 op_end: Optional[int] = None):
        self.program = program
        self.block = program.blocks[block_idx]
        self.ops = self.block.ops[:op_end] if op_end is not None \
            else list(self.block.ops)
        n = len(self.ops)
        self.uses: List[Set[str]] = [set() for _ in range(n)]
        self.defs: List[Set[str]] = [set() for _ in range(n)]
        for i, op in enumerate(self.ops):
            for names in op.desc.inputs.values():
                self.uses[i].update(names)
            for names in op.desc.outputs.values():
                self.defs[i].update(names)
        self._analyze()

    def _analyze(self):
        n = len(self.ops)
        self.live_in: List[Set[str]] = [set() for _ in range(n)]
        self.live_out: List[Set[str]] = [set() for _ in range(n)]
        live: Set[str] = set()
        for i in range(n - 1, -1, -1):
            self.live_out[i] = set(live)
            live = (live - self.defs[i]) | self.uses[i]
            self.live_in[i] = set(live)

    def var_bytes(self, name: str) -> int:
        var = self.block.vars.get(name)
        if var is None or not var.shape:
            return 4
        numel = 1
        for s in var.shape:
            numel *= abs(s) if s else 1
        return numel * _DTYPE_BYTES.get(str(var.dtype), 4)

    def live_out_bytes(self, i: int) -> int:
        return sum(self.var_bytes(v) for v in self.live_out[i]
                   if not self._persistable(v))

    def _persistable(self, name: str) -> bool:
        var = self.block.vars.get(name)
        return bool(var is not None and var.persistable)

    def last_uses(self) -> Dict[int, List[str]]:
        """op index -> vars whose last read is that op (release points)."""
        seen: Set[str] = set()
        out: Dict[int, List[str]] = {}
        for i in range(len(self.ops) - 1, -1, -1):
            for v in self.uses[i]:
                if v not in seen and not self._persistable(v):
                    seen.add(v)
                    out.setdefault(i, []).append(v)
        return out

    def remat_bounds(self, n_segments: Optional[int] = None) -> List[int]:
        """Segment boundaries placed at the narrowest live sets: only
        values live across a boundary are kept for the backward pass."""
        n = len(self.ops)
        if n == 0:
            return [0]
        k = n_segments or max(1, int(math.sqrt(n)))
        if k >= n:
            return list(range(n + 1))
        # the largest segment's recompute sets the backward's peak, so cuts
        # start from evenly spaced targets, each snapped to the locally
        # narrowest live set within a small window (the JAX pass's rule)
        window = max(1, n // (4 * k))
        cuts: List[int] = []
        for s in range(1, k):
            pos = round(n * s / k) - 1
            lo = max(0, pos - window)
            hi = min(n - 2, pos + window)
            best = min(range(lo, hi + 1), key=self.live_out_bytes)
            if not cuts or best > cuts[-1]:
                cuts.append(best)
        return [0] + [c + 1 for c in cuts] + [n]


def memory_optimize(input_program: Program = None, skip_opt_set=None,
                    print_log: bool = False, level: int = 0):
    """Liveness-guided rematerialisation (reference
    memory_optimization_transpiler.py:362): narrow-waist segments instead
    of a uniform sqrt(N) split."""
    program = input_program or default_main_program()
    program._memory_opt = True
    program._memory_opt_skip = set(skip_opt_set or ())
    try:
        cfg = ControlFlowGraph(program, op_end=_forward_op_end(program))
        program._remat_bounds = cfg.remat_bounds()
        if print_log:
            widths = [cfg.live_out_bytes(b - 1) / 2**20
                      for b in program._remat_bounds[1:-1]]
            print(f"[memory_optimize] {len(program._remat_bounds) - 1} "
                  f"remat segments; cut live-sets (MiB): "
                  f"{[round(w, 1) for w in widths]}")
    except Exception:
        program._remat_bounds = None       # the interpreter splits sqrt(N)
    return program


def _forward_op_end(program: Program):
    """Index of the forward slice's end: the first backward op's recorded
    forward_op_end, else the whole block (inference programs)."""
    for op in program.global_block().ops:
        if op.type == "backward":
            return op.desc.attrs.get("forward_op_end")
    return None


def release_memory(input_program: Program = None, skip_opt_set=None):
    """Insert ``delete_var`` ops after each non-persistable variable's
    last use (reference :381).  Data vars and anything in skip_opt_set
    are left alone."""
    program = input_program or default_main_program()
    skip = set(skip_opt_set or ())
    block = program.global_block()
    cfg = ControlFlowGraph(program)          # liveness over the FULL list
    plan = cfg.last_uses()
    # insertions shift op indices, so every backward op's forward_op_end
    # grows by the number of delete_vars inserted before it
    fwd_end = _forward_op_end(program)
    new_ops = []
    inserted_before = {}                      # original idx -> running count
    count = 0
    for i, op in enumerate(cfg.ops):
        inserted_before[i] = count
        new_ops.append(op)
        if fwd_end is not None and i >= fwd_end - 1:
            continue                          # only thin out the forward slice
        victims = [v for v in plan.get(i, ())
                   if v not in skip
                   and block.vars.get(v) is not None
                   and not block.vars[v].desc.is_data]
        if victims:
            desc = OpDesc(type="delete_var",
                          inputs={"X": victims}, outputs={}, attrs={})
            new_ops.append(Operator(block, desc))
            count += 1
    for op in new_ops:
        if op.type == "backward":
            fe = op.desc.attrs.get("forward_op_end")
            if fe is not None:
                op.desc.attrs["forward_op_end"] = \
                    fe + inserted_before.get(fe, count)
    block.ops[:len(cfg.ops)] = new_ops
    return program
