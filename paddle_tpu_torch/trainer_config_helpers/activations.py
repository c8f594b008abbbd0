"""Activation config objects (reference: trainer_config_helpers/activations.py).

Each activation is a small object whose ``name`` keys into the framework's
activation registry (`layers` act strings); gserver's per-activation C++
classes (reference paddle/gserver/activations) are replaced by the port's
activation op rules.  Counterpart of
``paddle_tpu/trainer_config_helpers/activations.py``.
"""
from __future__ import annotations

__all__ = [
    "BaseActivation", "TanhActivation", "SigmoidActivation",
    "SoftmaxActivation", "IdentityActivation", "LinearActivation",
    "ReluActivation", "BReluActivation", "SoftReluActivation",
    "STanhActivation", "AbsActivation", "SquareActivation",
    "ExpActivation", "LogActivation", "SequenceSoftmaxActivation",
]


class BaseActivation(object):
    """An activation spec: ``name`` is the op string understood by layers."""

    def __init__(self, name, support_hppl=True):
        self.name = name
        self.support_hppl = support_hppl

    def __repr__(self):
        return self.name


class TanhActivation(BaseActivation):
    def __init__(self):
        super().__init__("tanh")


class SigmoidActivation(BaseActivation):
    def __init__(self):
        super().__init__("sigmoid")


class SoftmaxActivation(BaseActivation):
    def __init__(self):
        super().__init__("softmax")


class SequenceSoftmaxActivation(BaseActivation):
    def __init__(self):
        super().__init__("sequence_softmax")


class IdentityActivation(BaseActivation):
    def __init__(self):
        super().__init__(None)


LinearActivation = IdentityActivation


class ReluActivation(BaseActivation):
    def __init__(self):
        super().__init__("relu")


class BReluActivation(BaseActivation):
    def __init__(self):
        super().__init__("brelu")


class SoftReluActivation(BaseActivation):
    def __init__(self):
        super().__init__("soft_relu")


class STanhActivation(BaseActivation):
    def __init__(self):
        super().__init__("stanh")


class AbsActivation(BaseActivation):
    def __init__(self):
        super().__init__("abs")


class SquareActivation(BaseActivation):
    def __init__(self):
        super().__init__("square")


class ExpActivation(BaseActivation):
    def __init__(self):
        super().__init__("exp")


class LogActivation(BaseActivation):
    def __init__(self):
        super().__init__("log")


def to_act_name(act):
    """Normalize an activation spec (object, string, or None) to a string."""
    if act is None:
        return None
    if isinstance(act, str):
        return act or None
    return act.name
