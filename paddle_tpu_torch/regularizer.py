"""Weight decay (counterpart of ``paddle_tpu/regularizer.py``).

`append_regularization_ops` adds the decay term onto each gradient as
ops of the main program (``scale``/``sign`` and ``sum``), the JAX
package's ops and names; a parameter's own regularizer wins over the
optimizer's.
"""
from __future__ import annotations

from .core.types import VarType


class WeightDecayRegularizer:
    def append_ops(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    """grad += coeff * param."""

    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def append_ops(self, param, grad, block):
        decay = block.create_var(name=grad.name + ".l2decay",
                                 shape=param.shape, dtype=param.dtype)
        block.append_op("scale", inputs={"X": [param]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self.coeff})
        return _sum(block, param, grad, decay)


class L1DecayRegularizer(WeightDecayRegularizer):
    """grad += coeff * sign(param)."""

    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def append_ops(self, param, grad, block):
        sign = block.create_var(name=grad.name + ".sign",
                                shape=param.shape, dtype=param.dtype)
        block.append_op("sign", inputs={"X": [param]},
                        outputs={"Out": [sign]})
        decay = block.create_var(name=grad.name + ".l1decay",
                                 shape=param.shape, dtype=param.dtype)
        block.append_op("scale", inputs={"X": [sign]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self.coeff})
        return _sum(block, param, grad, decay)


def _sum(block, param, grad, decay):
    out = block.create_var(name=grad.name + ".reg", shape=param.shape,
                           dtype=param.dtype)
    block.append_op("sum", inputs={"X": [grad, decay]},
                    outputs={"Out": [out]})
    return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(params_grads, regularization=None):
    """(param, grad) pairs with each regularized grad replaced by the
    decayed one; SelectedRows grads are left alone, as the reference
    does."""
    out = []
    for param, grad in params_grads:
        reg = param.regularizer or regularization
        if (reg is None or grad is None
                or grad.desc.type == VarType.SELECTED_ROWS):
            out.append((param, grad))
            continue
        out.append((param, reg.append_ops(param, grad, grad.block)))
    return out
