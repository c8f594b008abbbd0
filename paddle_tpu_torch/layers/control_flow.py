"""Control-flow layers (counterpart of ``paddle_tpu/layers/control_flow.py``;
``DynamicRNN`` and ``StaticRNN`` only — While, IfElse, Switch and the
tensor arrays are not ported).

DynamicRNN/StaticRNN build a step sub-block and one ``dynamic_rnn`` op,
which ``ops/rnn_ops.py`` runs over time.
"""
from __future__ import annotations

import contextlib
from typing import List

from .. import unique_name
from ..core.program import Variable
from ..layer_helper import LayerHelper


class DynamicRNN:
    """A variable-length RNN over ragged batches; the step logic is layer
    code written inside ``rnn.block()``."""

    BEFORE_RNN = 0
    IN_RNN = 1
    AFTER_RNN = 2

    def __init__(self, name=None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self.status = DynamicRNN.BEFORE_RNN
        self.main_program = self.helper.main_program
        self.parent_block = self.main_program.current_block()
        self.sub_block = None
        self._step_inputs = []     # (outer_name, inner_name)
        self._static_inputs = []   # (outer_name, inner_name)
        self._memories = []        # spec dicts
        self._mem_vars = {}        # inner step var name -> spec
        self._outputs = []         # in-block var names
        self._out_vars: List[Variable] = []
        self._first_step_input = None
        self._dynamic = True

    @contextlib.contextmanager
    def block(self):
        if self.status != DynamicRNN.BEFORE_RNN:
            raise ValueError("rnn.block() can only be entered once")
        self.sub_block = self.main_program.create_block()
        self.status = DynamicRNN.IN_RNN
        yield
        self.main_program.rollback()
        self.status = DynamicRNN.AFTER_RNN
        if not self._outputs:
            raise ValueError("rnn.output must be called inside the block")
        for name in self._outputs:
            inner = self.sub_block.var(name)
            out = self.parent_block.create_var(
                name=unique_name.generate(self.helper.name + ".out"),
                dtype=inner.dtype, lod_level=1)
            if inner.shape and self._first_step_input is not None:
                fsi = self.parent_block.var(self._first_step_input)
                t = fsi.shape[1] if fsi.shape and len(fsi.shape) > 1 else -1
                out.desc.shape = (inner.shape[0], t) + tuple(inner.shape[1:])
            self._out_vars.append(out)
        self.parent_block.append_op(
            type="dynamic_rnn",
            inputs={"StepInputs": [o for o, _ in self._step_inputs],
                    "StaticInputs": [o for o, _ in self._static_inputs],
                    "InitMems": [m["init"] for m in self._memories
                                 if m.get("init")]},
            outputs={"Out": self._out_vars},
            attrs={"sub_block": self.sub_block.idx,
                   "step_inputs": list(self._step_inputs),
                   "static_inputs": list(self._static_inputs),
                   "memories": list(self._memories),
                   "output_vars": list(self._outputs),
                   "dynamic": self._dynamic})

    def _assert_in_rnn(self, method):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError(f"{method} must be invoked inside rnn.block()")

    def step_input(self, x):
        self._assert_in_rnn("step_input")
        v = self.sub_block.create_var(
            name=unique_name.generate(self.helper.name + ".step_in"),
            dtype=x.dtype)
        if x.shape and len(x.shape) >= 2:
            v.desc.shape = (x.shape[0],) + tuple(x.shape[2:])
        if self._first_step_input is None:
            self._first_step_input = x.name
        self._step_inputs.append((x.name, v.name))
        return v

    def static_input(self, x):
        self._assert_in_rnn("static_input")
        v = self.sub_block.create_var(
            name=unique_name.generate(self.helper.name + ".static_in"),
            dtype=x.dtype, lod_level=x.lod_level)
        v.desc.shape = x.shape
        self._static_inputs.append((x.name, v.name))
        return v

    def memory(self, init=None, shape=None, value=0.0, need_reorder=False,
               dtype="float32"):
        self._assert_in_rnn("memory")
        v = self.sub_block.create_var(
            name=unique_name.generate(self.helper.name + ".mem"),
            dtype=init.dtype if init is not None else dtype)
        spec = {"step": v.name, "new": v.name,  # identity until update_memory
                "init": init.name if init is not None else None,
                "value": value, "shape": list(shape) if shape else None,
                "dtype": (init.dtype if init is not None else dtype)}
        if init is not None and init.shape:
            v.desc.shape = init.shape
        elif shape:
            v.desc.shape = (-1,) + tuple(shape)
        self._memories.append(spec)
        self._mem_vars[v.name] = spec
        return v

    def update_memory(self, ex_mem, new_mem):
        self._assert_in_rnn("update_memory")
        spec = self._mem_vars.get(ex_mem.name)
        if spec is None:
            raise ValueError("update_memory: first arg must come from "
                             "rnn.memory")
        spec["new"] = new_mem.name

    def output(self, *outputs):
        self._assert_in_rnn("output")
        for o in outputs:
            self._outputs.append(o.name)

    def __call__(self, *args, **kwargs):
        if self.status != DynamicRNN.AFTER_RNN:
            raise ValueError("rnn() is only valid after the rnn.block() "
                             "scope")
        return self._out_vars[0] if len(self._out_vars) == 1 \
            else self._out_vars


class StaticRNN(DynamicRNN):
    """Fixed-length steps (no length masking)."""

    def __init__(self, name=None):
        super().__init__(name=name)
        self._dynamic = False

    def step(self):
        return self.block()
