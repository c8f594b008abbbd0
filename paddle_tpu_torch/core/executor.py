"""Executor (counterpart of ``paddle_tpu/core/executor.py``).

``Executor(place).run(program, feed, fetch_list)`` interprets the
program's global block on the place's device (`core.lowering`):

- a startup-like program (no feeds, no fetches, reads no data var)
  materialises its persistables into the scope;
- feeds are cast to each data var's declared dtype on the device; a
  ragged feed's ``<name>@SEQ_LEN`` length vector stays int32;
- state lives in the scope as device tensors and is updated in place by
  the optimizer ops: a step copies no state, and every scope tensor
  leaves the step as a plain leaf (no autograd history);
- fetches come back detached, as numpy unless ``return_numpy=False``.

``Executor()`` with no place means the card and raises without CUDA.
Not ported yet: ``train_loop``, fused K-step launches, readers, the
flight recorder and ``check_nan_inf``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from . import lowering
from .place import CUDAPlace
from .program import Program, Variable, default_main_program
from .scope import Scope, global_scope
from .types import to_torch_dtype


class Executor:
    def __init__(self, place=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.torch_device()
        self._generator: Optional[torch.Generator] = None

    def _rng(self, program: Program) -> torch.Generator:
        """One generator per executor on its device, seeded from the
        first program it runs."""
        if self._generator is None:
            g = torch.Generator(device=self.device)
            g.manual_seed(int(program.random_seed or 0))
            self._generator = g
        return self._generator

    def run(self,
            program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence[Union[Variable, str]]] = None,
            scope: Optional[Scope] = None,
            return_numpy: bool = True):
        program = program or default_main_program()
        scope = scope or global_scope()
        feed = feed or {}
        fetch_names = [f.name if isinstance(f, Variable) else f
                       for f in (fetch_list or [])]
        if self._is_startup_like(program, feed, fetch_names):
            lowering.run_startup(program, scope, self.device,
                                 self._rng(program))
            return []
        block = program.global_block()
        env = self._state(block, scope)
        env.update(self._prepare_feed(block, feed))
        lowering.Interpreter(program, self.device, self._rng(program),
                             fetch_names).run_block(block, env)
        for v in block.vars.values():
            if v.persistable and v.name in env:
                val = env[v.name]
                scope.set(v.name, val.detach()
                          if isinstance(val, torch.Tensor) else val)
        fetches = [env[n].detach() for n in fetch_names]
        if return_numpy:
            # a snapshot: a fetched scope tensor keeps training in place
            return [f.to("cpu", copy=True).numpy() for f in fetches]
        return fetches

    def _state(self, block, scope: Scope) -> Dict[str, Any]:
        """The block's persistables from the scope, as tensors on this
        executor's device (a value that is not one yet is placed once and
        written back, so later steps update it in place)."""
        env = {}
        for v in block.vars.values():
            if not v.persistable:
                continue
            val = scope.get(v.name)
            if val is None:
                continue
            if not isinstance(val, torch.Tensor):
                # a copy: the optimizer updates scope tensors in place
                val = torch.tensor(np.asarray(val), device=self.device)
                scope.set(v.name, val)
            elif val.device != self.device:
                val = val.to(self.device)
                scope.set(v.name, val)
            env[v.name] = val
        return env

    def _prepare_feed(self, block, feed: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for name, value in feed.items():
            var = block.vars.get(name)
            t = (value if isinstance(value, torch.Tensor)
                 else torch.as_tensor(np.asarray(value)))
            if name.endswith(lowering.LEN_SUFFIX):
                want = torch.int32
            elif var is not None and var.dtype is not None:
                want = to_torch_dtype(var.dtype)
            else:
                want = t.dtype
            out[name] = t.to(self.device, want)
        return out

    @staticmethod
    def _is_startup_like(program: Program, feed, fetch_names) -> bool:
        if feed or fetch_names:
            return False
        block = program.global_block()
        return all(not any(n in block.vars and block.vars[n].desc.is_data
                           for n in op.desc.input_names())
                   for op in block.ops)
