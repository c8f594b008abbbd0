"""Gradient and error clipping (counterpart of ``paddle_tpu/clip.py``).

A parameter's ``gradient_clip_attr`` (`set_gradient_clip`, or
``ParamAttr(gradient_clip=...)``) decides how its gradient is clipped:
by value (``clip``), by its own L2 norm (``clip_by_norm``) or by the
joint L2 norm of a group (``squared_l2_norm`` of each, their sum, one
scale for all).  `append_gradient_clip_ops` appends the JAX package's
ops under its names; SelectedRows gradients are not clipped.
"""
from __future__ import annotations

from . import layers
from .core.program import default_main_program
from .core.types import VarType


class BaseErrorClipAttr:
    def append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    """Clips an activation's gradient (its error) by value."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def append_clip_op(self, block, grad_name):
        block.append_op("clip", inputs={"X": [grad_name]},
                        outputs={"Out": [grad_name]},
                        attrs={"min": self.min, "max": self.max})


class BaseGradientClipAttr:
    def process_context(self, context, param, grad):
        pass

    def create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def create_operators(self, param, grad):
        out = grad.block.create_var(name=grad.name + ".clip",
                                    shape=param.shape, dtype=param.dtype)
        grad.block.append_op("clip", inputs={"X": [grad]},
                             outputs={"Out": [out]},
                             attrs={"min": self.min, "max": self.max})
        return param, out


class GradientClipByNorm(BaseGradientClipAttr):
    """Each gradient's own L2 norm capped at ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def create_operators(self, param, grad):
        out = grad.block.create_var(name=grad.name + ".clip",
                                    shape=param.shape, dtype=param.dtype)
        grad.block.append_op("clip_by_norm", inputs={"X": [grad]},
                             outputs={"Out": [out]},
                             attrs={"max_norm": self.clip_norm})
        return param, out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """The joint L2 norm of a group's gradients capped at ``clip_norm``:
    every gradient of the group is multiplied by
    ``clip_norm / max(global_norm, clip_norm)``."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm
        self.group_name = group_name

    def process_context(self, context, param, grad):
        ctx = context.setdefault(self.group_name,
                                 {"grads": [], "clip_norm": self.clip_norm})
        ctx["grads"].append(grad)

    def create_operators(self, param, grad):
        ctx = _CLIP_CONTEXT.get(self.group_name)
        if ctx is None:
            return param, grad
        if "scale_var" not in ctx:
            # the group's scale, built once at its first gradient
            block = grad.block
            sq_sums = []
            for g in ctx["grads"]:
                sq = block.create_var(name=g.name + ".sq", dtype=g.dtype)
                block.append_op("squared_l2_norm", inputs={"X": [g]},
                                outputs={"Out": [sq]})
                sq.desc.shape = (1,)
                sq_sums.append(sq)
            total = layers.sums(sq_sums) if len(sq_sums) > 1 else sq_sums[0]
            global_norm = layers.sqrt(total)
            clip_const = layers.fill_constant([1], global_norm.dtype,
                                              self.clip_norm)
            denom = layers.elementwise_max(global_norm, clip_const)
            ctx["scale_var"] = layers.elementwise_div(clip_const, denom)
        return param, layers.elementwise_mul(grad, ctx["scale_var"])


_CLIP_CONTEXT = {}


def set_gradient_clip(clip, param_list=None, program=None):
    """Give ``clip`` to every parameter of ``program`` (or those of
    ``param_list``)."""
    program = program or default_main_program()
    params = (program.all_parameters() if param_list is None else
              [program.global_block().var(p if isinstance(p, str) else p.name)
               for p in param_list])
    for p in params:
        p.desc.gradient_clip_attr = clip


def append_gradient_clip_ops(params_grads):
    global _CLIP_CONTEXT
    _CLIP_CONTEXT = {}

    def dense(g):
        return g is None or g.desc.type != VarType.SELECTED_ROWS

    for p, g in params_grads:
        attr = p.desc.gradient_clip_attr
        if dense(g) and isinstance(attr, BaseGradientClipAttr):
            attr.process_context(_CLIP_CONTEXT, p, g)
    out = []
    for p, g in params_grads:
        attr = p.desc.gradient_clip_attr
        if dense(g) and isinstance(attr, BaseGradientClipAttr):
            out.append(attr.create_operators(p, g))
        else:
            out.append((p, g))
    _CLIP_CONTEXT = {}
    return out
