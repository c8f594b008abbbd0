"""Optimizers (counterpart of ``paddle_tpu/optimizer.py``; the `Optimizer`
base, `SGDOptimizer`, `MomentumOptimizer` and `AdamOptimizer`).

``minimize(loss)`` = `append_backward` + one optimize op per parameter.
The global learning rate and the accumulators are persistable vars
created in the startup program, under the JAX package's names
(``learning_rate_0``, ``fc_0.w_0.moment1_0``, ...), so optimizer state
carries across.

Not ported yet: ``MixedPrecision`` (``amp=True``) and loss scaling
(``program.amp`` alone, without them, is ported), gradient clipping and
regularization, the other optimizers.
"""
from __future__ import annotations

from collections import defaultdict
from typing import List, Tuple

from . import layers, unique_name
from .core.backward import append_backward
from .core.program import Parameter, Variable, default_main_program
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None,
                 amp=False):
        if amp:
            raise NotImplementedError("mixed precision (amp=True) is not "
                                      "ported")
        if regularization is not None:
            raise NotImplementedError("regularization is not ported")
        self._learning_rate = learning_rate
        self._learning_rate_map = {}
        self._accumulators = defaultdict(dict)
        self.helper = None

    # -- learning rate -------------------------------------------------------
    def _create_global_learning_rate(self):
        program = default_main_program()
        if id(program) in self._learning_rate_map:
            return
        self._learning_rate_map[id(program)] = layers.create_global_var(
            name=unique_name.generate("learning_rate"),
            shape=[1], value=float(self._learning_rate),
            dtype="float32", persistable=True)

    def _global_learning_rate(self):
        return self._learning_rate_map.get(id(default_main_program()))

    def _create_param_lr(self, param_and_grad):
        if param_and_grad[0].optimize_attr.get("learning_rate", 1.0) != 1.0:
            raise NotImplementedError("per-parameter learning rates are not "
                                      "ported")
        return self._global_learning_rate()

    # -- accumulators --------------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        helper = self.helper or LayerHelper(type(self).__name__.lower())
        var = helper.create_or_get_global_variable(
            name=unique_name.generate(f"{param.name}.{name}"),
            shape=shape or list(param.shape),
            dtype=dtype or param.dtype, persistable=True,
            initializer=ConstantInitializer(fill_value))
        var.desc.persistable = True
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- per-optimizer hooks -------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # -- minimize ------------------------------------------------------------
    def _create_optimization_pass(self, parameters_and_grads, loss):
        self.helper = LayerHelper(type(self).__name__.lower())
        block = loss.block
        self._create_global_learning_rate()
        self._create_accumulators(block,
                                  [p for p, g in parameters_and_grads
                                   if g is not None])
        return [self._append_optimize_op(block, pg)
                for pg in parameters_and_grads
                if pg[1] is not None and pg[0].trainable]

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None
                 ) -> Tuple[list, List[Tuple[Parameter, Variable]]]:
        program = loss.block.program
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        for p, _ in params_grads:
            if p.regularizer is not None or p.desc.gradient_clip_attr:
                raise NotImplementedError(
                    f"{p.name}: gradient clipping and regularization are "
                    "not ported")
        try:
            program._op_role = "optimize"
            optimize_ops = self._create_optimization_pass(params_grads, loss)
        finally:
            program._op_role = "forward"
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "sgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p]})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        return block.append_op(
            "adam",
            inputs={"Param": [p], "Grad": [g], "Moment1": [m1],
                    "Moment2": [m2], "Beta1Pow": [b1p], "Beta2Pow": [b2p],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2],
                     "Beta1PowOut": [b1p], "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
