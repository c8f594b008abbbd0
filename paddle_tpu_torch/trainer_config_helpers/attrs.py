"""Parameter/layer attribute configs (reference: trainer_config_helpers/attrs.py).

``ParameterAttribute`` carries the v1-era init/regularization knobs and
converts to the framework's native ``ParamAttr`` (initializer objects emitted
as init ops into the startup program, replacing gserver's Parameter init).
"""
from __future__ import annotations

from ..param_attr import ParamAttr
from ..initializer import (ConstantInitializer, NormalInitializer,
                           UniformInitializer)
from ..regularizer import L1DecayRegularizer, L2DecayRegularizer

__all__ = ["ParameterAttribute", "ExtraLayerAttribute", "ParamAttr",
           "ExtraAttr"]


class ParameterAttribute(object):
    """v1 parameter attribute: name, init distribution, lr scale, decay."""

    def __init__(self, name=None, is_static=False, initial_std=None,
                 initial_mean=None, initial_max=None, initial_min=None,
                 l1_rate=None, l2_rate=None, learning_rate=None,
                 momentum=None, gradient_clipping_threshold=None,
                 sparse_update=False, initializer=None):
        self.name = name
        self.is_static = is_static
        self.initial_std = initial_std
        self.initial_mean = initial_mean
        self.initial_max = initial_max
        self.initial_min = initial_min
        self.l1_rate = l1_rate
        self.l2_rate = l2_rate
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.gradient_clipping_threshold = gradient_clipping_threshold
        self.sparse_update = sparse_update
        self.initializer = initializer

    def to_param_attr(self):
        init = self.initializer
        if init is None:
            if self.initial_max is not None or self.initial_min is not None:
                lo = self.initial_min if self.initial_min is not None else -1.0
                hi = self.initial_max if self.initial_max is not None else 1.0
                init = UniformInitializer(low=lo, high=hi)
            elif self.initial_std == 0 and not self.initial_mean:
                init = ConstantInitializer(0.0)
            elif self.initial_std is not None or self.initial_mean is not None:
                init = NormalInitializer(loc=self.initial_mean or 0.0,
                                         scale=(1.0 if self.initial_std is None
                                                else self.initial_std))
        reg = None
        if self.l2_rate:
            reg = L2DecayRegularizer(self.l2_rate)
        elif self.l1_rate:
            reg = L1DecayRegularizer(self.l1_rate)
        return ParamAttr(
            name=self.name, initializer=init,
            learning_rate=(1.0 if self.learning_rate is None
                           else self.learning_rate),
            regularizer=reg, trainable=not self.is_static)

    @staticmethod
    def to_attr(arg):
        """Normalize None/ParameterAttribute/ParamAttr/str/bool → ParamAttr-ish."""
        if arg is None:
            return None
        if isinstance(arg, ParameterAttribute):
            return arg.to_param_attr()
        if arg is False:
            return False
        return ParamAttr.to_attr(arg)


class ExtraLayerAttribute(object):
    """Per-layer extras: dropout and (accepted, advisory) device/error-clip."""

    def __init__(self, error_clipping_threshold=None, drop_rate=None,
                 device=None):
        self.error_clipping_threshold = error_clipping_threshold
        self.drop_rate = drop_rate
        self.device = device

    @staticmethod
    def to_kwargs(attr):
        if attr is None:
            return {}
        return {"drop_rate": attr.drop_rate}


ExtraAttr = ExtraLayerAttribute
