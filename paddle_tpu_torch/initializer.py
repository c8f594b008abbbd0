"""Initializers (counterpart of ``paddle_tpu/initializer.py``: Constant,
Uniform, Normal, Xavier and NumpyArray).

Each initializer appends an init op (fill_constant / uniform_random /
gaussian_random / assign_value) to the STARTUP program's block holding
the parameter, with the JAX package's attributes.
"""
from __future__ import annotations

import math


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    """initializer.py:103 Constant."""

    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op("fill_constant",
                        outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "value": float(self.value)})


class UniformInitializer(Initializer):
    """initializer.py:145 Uniform."""

    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op("uniform_random",
                        outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "min": self.low, "max": self.high,
                               "seed": self.seed})


class NormalInitializer(Initializer):
    """initializer.py:196 Normal."""

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op("gaussian_random",
                        outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "mean": self.loc, "std": self.scale,
                               "seed": self.seed})


def _fan_in_out(var):
    shape = var.shape
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    # conv filters are OIHW: fan_in = I*rf, fan_out = O*rf
    if len(shape) > 2:
        return shape[1] * receptive, shape[0] * receptive
    return shape[0], shape[1]


class XavierInitializer(Initializer):
    """initializer.py:246 Xavier (Glorot)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        import numpy as np
        self.value = np.asarray(value)

    def __call__(self, var, block):
        block.append_op("assign_value",
                        outputs={"Out": [var.name]},
                        attrs={"shape": list(self.value.shape), "dtype": var.dtype,
                               "values": self.value.flatten().tolist()})


# fluid-style aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
