"""In-graph evaluators holding state across batches (counterpart of
``paddle_tpu/evaluator.py``).

An Evaluator owns persistable state variables that ops update each batch,
and a host-side ``eval``/``reset``; ``reset`` runs ``fill_constant`` ops
of a reset program.
"""
from __future__ import annotations

import numpy as np
import torch

from . import layers, unique_name
from .core.program import Program, program_guard
from .core.scope import global_scope
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper


class Evaluator:
    def __init__(self, name, **kwargs):
        self.states = []
        self.metrics = []
        self.helper = LayerHelper(name, **kwargs)

    def reset(self, executor, reset_program=None):
        if reset_program is None:
            reset_program = Program()
        with program_guard(main_program=reset_program):
            for var in self.states:
                g_var = reset_program.global_block().create_var(
                    name=var.name, shape=var.shape, dtype=var.dtype,
                    persistable=True)
                layers.fill_constant(shape=var.shape, dtype=var.dtype,
                                     value=0.0, out=g_var)
        executor.run(reset_program)

    def eval(self, executor, eval_program=None):
        raise NotImplementedError

    def create_state(self, suffix, dtype, shape):
        state = self.helper.create_or_get_global_variable(
            name="_".join([unique_name.generate(self.helper.name), suffix]),
            shape=shape, dtype=dtype, persistable=True,
            initializer=ConstantInitializer(0.0))
        state.desc.persistable = True
        self.states.append(state)
        return state


def _host(value) -> np.ndarray:
    return (value.detach().cpu().numpy() if isinstance(value, torch.Tensor)
            else np.asarray(value))


class Accuracy(Evaluator):
    """Streaming accuracy over Correct/Total state variables."""

    def __init__(self, input, label, k=1, **kwargs):
        super().__init__("accuracy", **kwargs)
        self.total = self.create_state("total", "int64", [1])
        self.correct = self.create_state("correct", "int64", [1])

        batch_correct = layers.create_tensor("int32")
        batch_total = layers.create_tensor("int32")
        acc = layers.accuracy(input=input, label=label, k=k,
                              correct=batch_correct, total=batch_total)
        new_total = layers.elementwise_add(
            self.total, layers.cast(batch_total, "int64"))
        new_correct = layers.elementwise_add(
            self.correct, layers.cast(batch_correct, "int64"))
        layers.assign(new_total, self.total)
        layers.assign(new_correct, self.correct)
        self.metrics.append(acc)

    def eval(self, executor, eval_program=None):
        scope = global_scope()
        total = _host(scope.get(self.total.name))
        correct = _host(scope.get(self.correct.name))
        return float(correct.sum()) / max(float(total.sum()), 1.0)
