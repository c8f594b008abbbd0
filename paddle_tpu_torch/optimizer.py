"""Optimizers (counterpart of ``paddle_tpu/optimizer.py``).

``minimize(loss)`` = `append_backward`, gradient clipping
(`clip.append_gradient_clip_ops`), weight decay
(`regularizer.append_regularization_ops`) and one optimize op per
parameter: SGD, Momentum, Adagrad, Adam, Adamax, DecayedAdagrad,
Adadelta, RMSProp, Ftrl, ProximalGD and ProximalAdagrad.  The global
learning rate (a float, or a Variable such as an LR schedule's) and the
accumulators are persistable vars created in the startup program, under
the JAX package's names (``learning_rate_0``, ``fc_0.w_0.moment1_0``,
...), so a program built by either front end is the same program and
optimizer state carries across.  A parameter's own learning rate
(``ParamAttr(learning_rate=...)``) multiplies the global one.

`MixedPrecision` (``amp=True`` on any optimizer) trains under
``program.amp`` with f32 master weights and a dynamic loss scale;
`ModelAverage` keeps a windowed average of the parameters.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import List, Tuple

import torch

from . import layers, unique_name
from .clip import append_gradient_clip_ops
from .core.backward import append_backward
from .core.program import Parameter, Variable, default_main_program
from .core.scope import global_scope
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None,
                 amp=False):
        self.regularization = regularization
        self._name = name
        self._learning_rate = learning_rate
        self._learning_rate_map = {}
        self._accumulators = defaultdict(dict)
        self.helper = None
        #: ``amp=True`` (or a dict of MixedPrecision knobs) routes
        #: ``minimize`` through `MixedPrecision`
        self._amp = amp

    # -- learning rate -------------------------------------------------------
    def _create_global_learning_rate(self):
        program = default_main_program()
        if id(program) in self._learning_rate_map:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[id(program)] = self._learning_rate
            return
        self._learning_rate_map[id(program)] = layers.create_global_var(
            name=unique_name.generate("learning_rate"),
            shape=[1], value=float(self._learning_rate),
            dtype="float32", persistable=True)

    def _global_learning_rate(self):
        return self._learning_rate_map.get(id(default_main_program()))

    def _create_param_lr(self, param_and_grad):
        param_lr = param_and_grad[0].optimize_attr.get("learning_rate", 1.0)
        base = self._global_learning_rate()
        if param_lr == 1.0:
            return base
        return layers.elementwise_mul(
            base, layers.fill_constant([1], "float32", param_lr))

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
        if self._amp:
            knobs = self._amp if isinstance(self._amp, dict) else {}
            return MixedPrecision(self, **knobs).minimize(
                loss, startup_program, parameter_list, no_grad_set)
        program = loss.block.program
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        try:
            # clip and decay rewrite gradients (backward role, so
            # clone(for_test=True) strips them); updates are optimize
            program._op_role = "backward"
            params_grads = append_gradient_clip_ops(params_grads)
            params_grads = append_regularization_ops(params_grads,
                                                     self.regularization)
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


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "MomentOut": [m]},
            attrs={"epsilon": self._epsilon})


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


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "adamax",
            inputs={"Param": [p], "Grad": [g],
                    "Moment": [self._get_accumulator("moment", p)],
                    "InfNorm": [self._get_accumulator("inf_norm", p)],
                    "Beta1Pow": [self._get_accumulator("beta1_pow_acc", p)],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p],
                     "MomentOut": [self._get_accumulator("moment", p)],
                     "InfNormOut": [self._get_accumulator("inf_norm", p)],
                     "Beta1PowOut": [self._get_accumulator("beta1_pow_acc", p)]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "decayed_adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "MomentOut": [m]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("_avg_squared_grad", p)
            self._add_accumulator("_avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        g1 = self._get_accumulator("_avg_squared_grad", p)
        g2 = self._get_accumulator("_avg_squared_update", p)
        return block.append_op(
            "adadelta",
            inputs={"Param": [p], "Grad": [g], "AvgSquaredGrad": [g1],
                    "AvgSquaredUpdate": [g2]},
            outputs={"ParamOut": [p], "AvgSquaredGradOut": [g1],
                     "AvgSquaredUpdateOut": [g2]},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon, self._momentum = rho, epsilon, momentum

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        mom = self._get_accumulator("momentum", p)
        ms = self._get_accumulator("mean_square", p)
        return block.append_op(
            "rmsprop",
            inputs={"Param": [p], "Grad": [g], "Moment": [mom],
                    "MeanSquare": [ms],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "MomentOut": [mom],
                     "MeanSquareOut": [ms]},
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            "ftrl",
            inputs={"Param": [p], "Grad": [g], "SquaredAccumulator": [sq],
                    "LinearAccumulator": [lin],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power})


class ProximalGDOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2 = l1, l2

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "proximal_gd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p]},
            attrs={"l1": self._l1, "l2": self._l2})


class ProximalAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2 = l1, l2

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "proximal_adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [p], "MomentOut": [m]},
            attrs={"l1": self._l1, "l2": self._l2})


class ModelAverage(Optimizer):
    """A running average of the parameters over a window of steps.

    Construct after ``minimize``: it appends one ``average_accumulates``
    op per trainable parameter to the default main program (optimize
    role, so ``clone(for_test=True)`` strips them).  ``apply()`` puts the
    averaged values in the global scope, as a context manager that
    restores the live ones on exit, or reference-style:
    ``ma.apply(exe, need_restore=False)`` ... ``ma.restore(exe)``.
    """

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, **kwargs):
        super().__init__(0.0, **kwargs)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        program = default_main_program()
        block = program.global_block()
        self.params = [v for v in block.vars.values()
                       if isinstance(v, Parameter) and v.trainable]
        self.helper = LayerHelper("model_average")
        self._acc = {}
        self._stash = None
        prev_role = program._op_role
        program._op_role = "optimize"
        try:
            for p in self.params:
                self._append_average_accumulate_op(block, p)
        finally:
            program._op_role = prev_role

    def _append_average_accumulate_op(self, block, param):
        sum_1 = self._add_accumulator("sum_1", param)
        sum_2 = self._add_accumulator("sum_2", param)
        num_acc = self._add_accumulator("num_accumulates", param,
                                        dtype="int64", shape=[1])
        old_num = self._add_accumulator("old_num_accumulates", param,
                                        dtype="int64", shape=[1])
        num_upd = self._add_accumulator("num_updates", param,
                                        dtype="int64", shape=[1])
        self._acc[param.name] = (sum_1, sum_2, num_acc, old_num, num_upd)
        block.append_op(
            "average_accumulates",
            inputs={"Param": [param], "InSum1": [sum_1], "InSum2": [sum_2],
                    "InNumAccumulates": [num_acc],
                    "InOldNumAccumulates": [old_num],
                    "InNumUpdates": [num_upd]},
            outputs={"OutSum1": [sum_1], "OutSum2": [sum_2],
                     "OutNumAccumulates": [num_acc],
                     "OutOldNumAccumulates": [old_num],
                     "OutNumUpdates": [num_upd]},
            attrs={"average_window": self.average_window,
                   "max_average_window": self.max_average_window,
                   "min_average_window": self.min_average_window})

    def _averaged(self, scope, param):
        sum_1, sum_2, num_acc, old_num, _ = self._acc[param.name]
        live = torch.as_tensor(scope.get(param.name))
        n = (int(torch.as_tensor(scope.get(num_acc.name)).reshape(-1)[0])
             + int(torch.as_tensor(scope.get(old_num.name)).reshape(-1)[0]))
        if n == 0:
            return live.clone()
        s = (torch.as_tensor(scope.get(sum_1.name))
             + torch.as_tensor(scope.get(sum_2.name)))
        return (s / n).to(live.dtype)

    def apply(self, executor=None, need_restore=True):
        """Put the averaged parameters in the global scope; the live
        tensors are kept aside for `restore`."""
        scope = global_scope()
        self._stash = {p.name: scope.get(p.name) for p in self.params}
        for p in self.params:
            scope.set(p.name, self._averaged(scope, p))

        @contextlib.contextmanager
        def _ctx():
            try:
                yield
            finally:
                if need_restore:
                    self.restore(executor)
        return _ctx()

    def restore(self, executor=None):
        """Put the live parameters back."""
        if self._stash is None:
            return
        scope = global_scope()
        for name, val in self._stash.items():
            scope.set(name, val)
        self._stash = None


class MixedPrecision:
    """Mixed-precision training around any `Optimizer`: bf16 compute,
    f32 master weights, dynamic loss scaling.

    ``minimize(loss)``:

    1. turns on ``program.amp`` (bf16 matmul/conv operands and
       activations; parameters and optimizer state stay f32);
    2. multiplies the loss by a persistable ``loss_scaling`` scalar and
       differentiates the scaled loss;
    3. appends ``check_finite_and_unscale``: one device boolean
       (``found_inf``) over every gradient, and the gradients unscaled
       into f32 before clipping and weight decay see them;
    4. appends ``update_loss_scaling``: an overflow multiplies the scale
       by ``decr_ratio`` (floored at ``min_loss_scaling``) and zeroes
       the clean-step counter; ``incr_every_n_steps`` clean steps in a
       row multiply it by ``incr_ratio``.  Scale and counter are
       persistable, so they ride checkpoints;
    5. wires ``FoundInf`` and ``skip_on_found_inf`` into every optimize
       op of the inner optimizer: on an overflow the interpreter keeps
       every parameter, moment and beta pow bitwise as it was.

    The fetched loss stays the unscaled loss.  Under ``check_nan_inf``
    the executor counts an overflowed step as a skip, not a
    `NonFiniteError`.
    """

    def __init__(self, optimizer, init_loss_scaling=2.0 ** 15,
                 incr_every_n_steps=1000, incr_ratio=2.0, decr_ratio=0.5,
                 min_loss_scaling=1.0, use_dynamic_loss_scaling=True):
        self._inner = optimizer
        self.init_loss_scaling = float(init_loss_scaling)
        self.incr_every_n_steps = int(incr_every_n_steps)
        self.incr_ratio = float(incr_ratio)
        self.decr_ratio = float(decr_ratio)
        self.min_loss_scaling = float(min_loss_scaling)
        self.use_dynamic_loss_scaling = bool(use_dynamic_loss_scaling)
        self._scale_var = None
        self._good_var = None
        self._found_var = None

    def _create_state(self, block):
        self._scale_var = layers.create_global_var(
            name=unique_name.generate("loss_scaling"), shape=[1],
            value=self.init_loss_scaling, dtype="float32", persistable=True)
        self._good_var = layers.create_global_var(
            name=unique_name.generate("loss_scaling_good_steps"), shape=[1],
            value=0, dtype="int32", persistable=True)
        self._found_var = block.create_var(
            name=unique_name.generate("found_inf"), shape=[1], dtype="bool")

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        program = loss.block.program
        block = loss.block
        program.amp = True
        inner = self._inner
        prev_role = program._op_role
        try:
            # the scaled loss, the backward and the unscale are train-only
            program._op_role = "backward"
            self._create_state(block)
            scaled = layers.elementwise_mul(loss, self._scale_var)
            params_grads = append_backward(scaled, parameter_list,
                                           no_grad_set)
            grad_names = [g.name for _, g in params_grads if g is not None]
            block.append_op(
                "check_finite_and_unscale",
                inputs={"X": grad_names, "Scale": [self._scale_var]},
                outputs={"Out": grad_names, "FoundInf": [self._found_var]})
            params_grads = append_gradient_clip_ops(params_grads)
            params_grads = append_regularization_ops(
                params_grads, inner.regularization)
            program._op_role = "optimize"
            if self.use_dynamic_loss_scaling:
                block.append_op(
                    "update_loss_scaling",
                    inputs={"FoundInf": [self._found_var],
                            "LossScaling": [self._scale_var],
                            "GoodSteps": [self._good_var]},
                    outputs={"LossScalingOut": [self._scale_var],
                             "GoodStepsOut": [self._good_var]},
                    attrs={"incr_every_n_steps": self.incr_every_n_steps,
                           "incr_ratio": self.incr_ratio,
                           "decr_ratio": self.decr_ratio,
                           "min_loss_scaling": self.min_loss_scaling})
            optimize_ops = inner._create_optimization_pass(params_grads,
                                                           loss)
            for op in optimize_ops:
                if op is None:
                    continue
                op.desc.inputs["FoundInf"] = [self._found_var.name]
                op.desc.attrs["skip_on_found_inf"] = True
        finally:
            program._op_role = prev_role
        program._loss_scaling = {
            "scale": self._scale_var.name,
            "good_steps": self._good_var.name,
            "found_inf": self._found_var.name,
            "incr_every_n_steps": self.incr_every_n_steps,
        }
        return optimize_ops, params_grads


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
ProximalGD = ProximalGDOptimizer
ProximalAdagrad = ProximalAdagradOptimizer
