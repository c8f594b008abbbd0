"""LayerHelper: shared layer plumbing (counterpart of
``paddle_tpu/layer_helper.py``).

Creates parameters in BOTH the main program (as Parameter vars) and the
startup program (var + initializer op), infers dtypes from inputs, and
appends bias and activation ops.
"""
from __future__ import annotations

from typing import Optional

from . import unique_name
from .core.program import (default_main_program, default_startup_program,
                           Variable)
from .initializer import ConstantInitializer, XavierInitializer
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        if kwargs.get("name") is None:
            self.name = unique_name.generate(layer_type)
        else:
            self.name = kwargs["name"]

    @property
    def main_program(self):
        return self.kwargs.get("main_program") or default_main_program()

    @property
    def startup_program(self):
        return self.kwargs.get("startup_program") or default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    # ------------------------------------------------------------------
    @property
    def param_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("bias_attr"))

    # ------------------------------------------------------------------
    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        if attr is False:
            return None
        attr = ParamAttr.to_attr(attr)
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name, "w" if not is_bias else "b"]))
        if default_initializer is None:
            default_initializer = (ConstantInitializer(0.0) if is_bias
                                   else XavierInitializer())
        init = attr.initializer or default_initializer

        # main program: Parameter metadata
        param = self.main_program.global_block().create_parameter(
            name=attr.name, shape=shape, dtype=dtype,
            initializer=init, trainable=attr.trainable,
            regularizer=attr.regularizer,
            gradient_clip_attr=attr.gradient_clip,
            do_model_average=attr.do_model_average,
            learning_rate=attr.learning_rate)
        # startup program: var + init op
        sblock = self.startup_program.global_block()
        if not sblock.has_var(attr.name):
            svar = sblock.create_parameter(
                name=attr.name, shape=shape, dtype=dtype, initializer=init)
            init(svar, sblock)
        return param

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, stop_gradient=stop_gradient)

    def create_or_get_global_variable(self, name, shape, dtype,
                                      persistable=True, initializer=None):
        gblock = self.main_program.global_block()
        if gblock.has_var(name):
            return gblock.var(name)
        var = gblock.create_var(name=name, shape=shape, dtype=dtype,
                                persistable=persistable)
        sblock = self.startup_program.global_block()
        if not sblock.has_var(name):
            svar = sblock.create_var(name=name, shape=shape, dtype=dtype,
                                     persistable=persistable)
            (initializer or ConstantInitializer(0.0))(svar, sblock)
        return var

    # ------------------------------------------------------------------
    def append_op(self, **kwargs):
        return self.block.append_op(**kwargs)

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        size = input_var.shape[dim_start:dim_end]
        bias_attr = self.bias_attr
        if bias_attr is False or bias_attr is None:
            return input_var
        b = self.create_parameter(bias_attr, shape=list(size),
                                  dtype=input_var.dtype, is_bias=True)
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(type="elementwise_add",
                       inputs={"X": [input_var], "Y": [b]},
                       outputs={"Out": [out]},
                       attrs={"axis": dim_start})
        return out

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act_type = act.pop("type")
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(type=act_type, inputs={"X": [input_var]},
                       outputs={"Out": [out]}, attrs=act)
        out.desc.shape = input_var.shape  # activations preserve shape
        out.desc.lod_level = input_var.lod_level
        return out
