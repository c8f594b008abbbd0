"""v1 optimizer settings DSL (reference: trainer_config_helpers/optimizers.py).

The reference's ``settings(...)`` mutates the global trainer config; here
each optimizer object converts to the framework's native fluid-style
optimizer (``to_fluid()``), used by the v2 trainer.
"""
from __future__ import annotations

from .. import optimizer as fluid_opt
from ..regularizer import L1DecayRegularizer, L2DecayRegularizer

__all__ = [
    "BaseSGDOptimizer", "MomentumOptimizer", "AdamaxOptimizer",
    "AdamOptimizer", "AdaGradOptimizer", "RMSPropOptimizer",
    "DecayedAdaGradOptimizer", "AdaDeltaOptimizer", "settings",
]


class BaseSGDOptimizer(object):
    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def to_fluid(self, learning_rate, regularization=None):
        return fluid_opt.SGD(learning_rate=learning_rate,
                             regularization=regularization)


class MomentumOptimizer(BaseSGDOptimizer):
    def __init__(self, momentum=0.9, sparse=False):
        super().__init__()
        self.momentum = momentum

    def to_fluid(self, learning_rate, regularization=None):
        return fluid_opt.Momentum(learning_rate=learning_rate,
                                  momentum=self.momentum,
                                  regularization=regularization)


class AdamOptimizer(BaseSGDOptimizer):
    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8):
        super().__init__()
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def to_fluid(self, learning_rate, regularization=None):
        return fluid_opt.Adam(learning_rate=learning_rate, beta1=self.beta1,
                              beta2=self.beta2, epsilon=self.epsilon,
                              regularization=regularization)


class AdamaxOptimizer(BaseSGDOptimizer):
    def __init__(self, beta1=0.9, beta2=0.999):
        super().__init__()
        self.beta1, self.beta2 = beta1, beta2

    def to_fluid(self, learning_rate, regularization=None):
        return fluid_opt.Adamax(learning_rate=learning_rate,
                                beta1=self.beta1, beta2=self.beta2,
                                regularization=regularization)


class AdaGradOptimizer(BaseSGDOptimizer):
    def to_fluid(self, learning_rate, regularization=None):
        return fluid_opt.Adagrad(learning_rate=learning_rate,
                                 regularization=regularization)


class DecayedAdaGradOptimizer(BaseSGDOptimizer):
    def __init__(self, rho=0.95, epsilon=1e-6):
        super().__init__()
        self.rho, self.epsilon = rho, epsilon

    def to_fluid(self, learning_rate, regularization=None):
        return fluid_opt.DecayedAdagrad(learning_rate=learning_rate,
                                        decay=self.rho,
                                        epsilon=self.epsilon,
                                        regularization=regularization)


class AdaDeltaOptimizer(BaseSGDOptimizer):
    def __init__(self, rho=0.95, epsilon=1e-6):
        super().__init__()
        self.rho, self.epsilon = rho, epsilon

    def to_fluid(self, learning_rate, regularization=None):
        return fluid_opt.Adadelta(learning_rate=learning_rate,
                                  rho=self.rho, epsilon=self.epsilon,
                                  regularization=regularization)


class RMSPropOptimizer(BaseSGDOptimizer):
    def __init__(self, rho=0.95, epsilon=1e-6):
        super().__init__()
        self.rho, self.epsilon = rho, epsilon

    def to_fluid(self, learning_rate, regularization=None):
        return fluid_opt.RMSProp(learning_rate=learning_rate, rho=self.rho,
                                 epsilon=self.epsilon,
                                 regularization=regularization)


class _Settings(object):
    """Captured global settings (the reference mutates conf globals)."""

    def __init__(self):
        self.learning_rate = 0.01
        self.learning_method = BaseSGDOptimizer()
        self.regularization = None
        self.batch_size = None
        self.gradient_clipping_threshold = None


_SETTINGS = _Settings()


def settings(batch_size=None, learning_rate=0.01, learning_method=None,
             regularization=None, is_async=False, model_average=None,
             gradient_clipping_threshold=None):
    """Record global optimization settings (reference optimizers.py settings)."""
    _SETTINGS.batch_size = batch_size
    _SETTINGS.learning_rate = learning_rate
    _SETTINGS.learning_method = learning_method or BaseSGDOptimizer()
    _SETTINGS.regularization = regularization
    _SETTINGS.gradient_clipping_threshold = gradient_clipping_threshold
    return _SETTINGS


def current_settings():
    return _SETTINGS
