"""Host-side weighted averaging (counterpart of ``paddle_tpu/average.py``):
``WeightedAverage`` aggregates scalar metrics across batches (reset, add,
eval; ValueError on input that is not a number or numpy array, and on an
eval before any add)."""
from __future__ import annotations

import numpy as np

__all__ = ["WeightedAverage"]


class WeightedAverage(object):
    def __init__(self):
        self.reset()

    def reset(self):
        self._acc = None           # (sum of value*weight, sum of weight)

    @staticmethod
    def _check(x, what):
        if isinstance(x, np.ndarray) or np.isscalar(x):
            return
        raise ValueError(f"{what} must be a number or numpy array")

    def add(self, value, weight):
        self._check(value, "value")
        self._check(weight, "weight")
        total, mass = self._acc if self._acc is not None else (0.0, 0.0)
        self._acc = (total + value * weight, mass + weight)

    def eval(self):
        if self._acc is None:
            raise ValueError("eval() before any add()")
        total, mass = self._acc
        return total / mass
