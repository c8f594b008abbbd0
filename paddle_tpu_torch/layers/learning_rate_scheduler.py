"""Learning-rate schedules (counterpart of
``paddle_tpu/layers/learning_rate_scheduler.py``: noam, exponential,
natural_exp, inverse_time, polynomial and piecewise decay).

Each returns a Variable computed in every step from one persistable
counter (``@LR_DECAY_COUNTER@``) that an ``increment`` op, put first in
the block, advances once a step.  The ops are the JAX package's, so a
schedule built by either front end serializes to the same program.
"""
from __future__ import annotations

import math

from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper
from . import nn as _nn
from . import ops as _ops
from . import tensor as _tensor

_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable f32 counter that starts at ``begin`` in the first
    step and grows by ``step`` each step."""
    helper = LayerHelper("global_step_counter")
    name = counter_name or _COUNTER_NAME
    counter = helper.create_or_get_global_variable(
        name, shape=[1], dtype="float32", persistable=True,
        initializer=ConstantInitializer(float(begin - step)))
    gblock = helper.main_program.global_block()
    if not any(op.type == "increment" and op.desc.inputs.get("X") == [name]
               for op in gblock.ops):
        gblock.prepend_op(type="increment", inputs={"X": [counter]},
                          outputs={"Out": [counter]},
                          attrs={"step": float(step)})
    counter.stop_gradient = True
    return counter


def noam_decay(d_model, warmup_steps):
    """lr = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)."""
    global_step = autoincreased_step_counter()
    a = _ops.pow(global_step, factor=-0.5)
    b = _ops.scale(global_step, scale=warmup_steps ** -1.5)
    return _ops.scale(_nn.elementwise_min(a, b), scale=d_model ** -0.5)


def _decay_steps(decay_steps, staircase):
    div = _ops.scale(autoincreased_step_counter(), scale=1.0 / decay_steps)
    return _ops.floor(div) if staircase else div


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    div = _decay_steps(decay_steps, staircase)
    # decay_rate ** div as exp(div * ln(decay_rate))
    powed = _ops.exp(_ops.scale(div, scale=math.log(decay_rate)))
    return _ops.scale(powed, scale=learning_rate)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    div = _decay_steps(decay_steps, staircase)
    return _ops.scale(_ops.exp(_ops.scale(div, scale=-decay_rate)),
                      scale=learning_rate)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    div = _decay_steps(decay_steps, staircase)
    denom = _ops.scale(div, scale=decay_rate, bias=1.0)
    return _nn.elementwise_div(
        _tensor.fill_constant([1], "float32", learning_rate), denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    global_step = autoincreased_step_counter()
    if cycle:
        div = _ops.ceil(_ops.scale(global_step, scale=1.0 / decay_steps))
        # max(div, 1): the first step's ceil is 1 already, a restart's 0
        div = _nn.elementwise_max(
            div, _tensor.fill_constant([1], "float32", 1.0))
        decay_var = _ops.scale(div, scale=float(decay_steps))
    else:
        decay_var = _tensor.fill_constant([1], "float32",
                                          float(decay_steps))
        global_step = _nn.elementwise_min(global_step, decay_var)
    frac = _nn.elementwise_div(global_step, decay_var)
    one_minus = _ops.scale(frac, scale=-1.0, bias=1.0)
    powed = _ops.pow(one_minus, factor=power)
    return _ops.scale(powed, scale=learning_rate - end_learning_rate,
                      bias=end_learning_rate)


def piecewise_decay(boundaries, values):
    """``values[i]`` while the step is below ``boundaries[i]``, the last
    value after the last boundary."""
    assert len(values) == len(boundaries) + 1
    global_step = autoincreased_step_counter()
    lr = _tensor.fill_constant([1], "float32", values[-1])
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        cond = _nn.compare_op(
            "less_than", global_step,
            _tensor.fill_constant([1], "float32", float(b)))
        helper = LayerHelper("piecewise_select")
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op(type="where_select",
                         inputs={"Cond": [cond],
                                 "X": [_tensor.fill_constant([1], "float32",
                                                             v)],
                                 "Y": [lr]},
                         outputs={"Out": [out]})
        out.desc.shape = (1,)
        lr = out
    return lr
