"""v2 optimizers (reference: python/paddle/v2/optimizer.py).

Each is a thin config object; ``to_fluid()`` yields the framework's native
optimizer that emits update ops into the train Program (replacing the
reference's ParameterUpdater/pserver machinery).
"""
from __future__ import annotations

from .. import optimizer as fluid_opt
from ..regularizer import L2DecayRegularizer

__all__ = ["Optimizer", "Momentum", "Adam", "Adamax", "AdaGrad",
           "DecayedAdaGrad", "AdaDelta", "RMSProp", "ModelAverage",
           "L2Regularization"]


def L2Regularization(rate):
    return L2DecayRegularizer(regularization_coeff=rate)


class ModelAverage(object):
    """Config marker for parameter averaging (wired by the trainer)."""

    def __init__(self, average_window, min_average_window=10000,
                 max_average_window=10000):
        self.average_window = average_window
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window


class Optimizer(object):
    def __init__(self, learning_rate=0.01, regularization=None,
                 model_average=None, gradient_clipping_threshold=None,
                 learning_rate_decay_a=0.0, learning_rate_decay_b=0.0,
                 learning_rate_schedule=None, batch_size=None, **kwargs):
        self.learning_rate = learning_rate
        self.regularization = regularization
        self.model_average = model_average
        self.gradient_clipping_threshold = gradient_clipping_threshold

    def to_fluid(self):
        return fluid_opt.SGD(learning_rate=self.learning_rate,
                             regularization=self.regularization)


class Momentum(Optimizer):
    def __init__(self, momentum=0.9, sparse=False, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def to_fluid(self):
        return fluid_opt.Momentum(learning_rate=self.learning_rate,
                                  momentum=self.momentum,
                                  regularization=self.regularization)


class Adam(Optimizer):
    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def to_fluid(self):
        return fluid_opt.Adam(learning_rate=self.learning_rate,
                              beta1=self.beta1, beta2=self.beta2,
                              epsilon=self.epsilon,
                              regularization=self.regularization)


class Adamax(Optimizer):
    def __init__(self, beta1=0.9, beta2=0.999, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def to_fluid(self):
        return fluid_opt.Adamax(learning_rate=self.learning_rate,
                                beta1=self.beta1, beta2=self.beta2,
                                regularization=self.regularization)


class AdaGrad(Optimizer):
    def to_fluid(self):
        return fluid_opt.Adagrad(learning_rate=self.learning_rate,
                                 regularization=self.regularization)


class DecayedAdaGrad(Optimizer):
    def __init__(self, rho=0.95, epsilon=1e-6, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def to_fluid(self):
        return fluid_opt.DecayedAdagrad(learning_rate=self.learning_rate,
                                        decay=self.rho, epsilon=self.epsilon,
                                        regularization=self.regularization)


class AdaDelta(Optimizer):
    def __init__(self, rho=0.95, epsilon=1e-6, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def to_fluid(self):
        return fluid_opt.Adadelta(learning_rate=self.learning_rate,
                                  rho=self.rho, epsilon=self.epsilon,
                                  regularization=self.regularization)


class RMSProp(Optimizer):
    def __init__(self, rho=0.95, epsilon=1e-6, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def to_fluid(self):
        return fluid_opt.RMSProp(learning_rate=self.learning_rate,
                                 rho=self.rho, epsilon=self.epsilon,
                                 regularization=self.regularization)
