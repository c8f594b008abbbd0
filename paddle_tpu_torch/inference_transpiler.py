"""Inference graph rewrites (counterpart of
``paddle_tpu/inference_transpiler.py``): fold each BatchNorm into the
convolution before it.

The fold runs on the host against the scope's values: the filter
becomes ``W * scale / std`` per output channel, and a bias
``(0 - mean) * scale / std + bias`` is added to the convolution's output
under the BatchNorm's output name, so its consumers are unchanged.

Where the JAX transpiler and this one differ (ROADMAP queue C): the JAX
one adds the bias at axis 1 and drops the BatchNorm's fused ``act``,
which is right only for an NCHW BatchNorm without activation.  This one
adds the bias on the BatchNorm's channel axis (the last for NHWC) and
keeps its activation as a ``relu`` op after the add, so a folded NHWC
ResNet computes what the unfolded one does.  On an NCHW conv + BatchNorm
without ``act`` both emit the same ops.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.program import OpDesc, Operator, Program
from .core.scope import Scope, global_scope


def _host(val) -> np.ndarray:
    if isinstance(val, torch.Tensor):
        val = val.detach().cpu().numpy()
    return np.asarray(val, dtype=np.float32)


class InferenceTranspiler:
    def transpile(self, program: Program, place=None, scope: Scope = None):
        scope = scope or global_scope()
        block = program.global_block()
        ops = block.ops
        i = 0
        while i < len(ops) - 1:
            op, nxt = ops[i], ops[i + 1]
            if (op.type == "conv2d" and nxt.type == "batch_norm"
                    and op.desc.outputs.get("Output")
                    == nxt.desc.inputs.get("X")
                    and self._fold(block, scope, op, nxt)):
                ops.remove(nxt)      # the bias add now follows the conv
                continue
            i += 1
        return program

    def _fold(self, block, scope, conv_op, bn_op) -> bool:
        def get(op, slot):
            return op.desc.inputs.get(slot, [None])[0]

        w_name = get(conv_op, "Filter")
        names = [w_name, get(bn_op, "Scale"), get(bn_op, "Bias"),
                 get(bn_op, "Mean"), get(bn_op, "Variance")]
        vals = [scope.get(n) for n in names]
        if any(v is None for v in vals):
            return False
        w, scale, bias, mean, var = (_host(v) for v in vals)
        std = np.sqrt(var + bn_op.desc.attrs.get("epsilon", 1e-5))
        alpha = scale / std                               # [C_out]
        scope.set(w_name, w * alpha[:, None, None, None])
        bias_name = w_name + ".bn_fused_bias"
        scope.set(bias_name, ((0.0 - mean) * alpha + bias).astype(np.float32))
        block.create_var(name=bias_name, shape=[len(alpha)],
                         dtype="float32", persistable=True)
        bn_out = bn_op.desc.outputs["Y"][0]
        conv_out = conv_op.desc.outputs["Output"][0]
        fused_out = block.create_var(name=conv_out + ".fused",
                                     dtype=block.vars[conv_out].dtype)
        conv_op.desc.outputs["Output"] = [fused_out.name]
        channels_last = bn_op.desc.attrs.get("data_layout",
                                             "NCHW").endswith("C")
        act = bn_op.desc.attrs.get("act")
        add_out = bn_out
        if act:
            add_out = block.create_var(name=bn_out + ".prebias_act",
                                       dtype=block.vars[conv_out].dtype).name
        new_ops = [Operator(block, OpDesc(
            "elementwise_add", {"X": [fused_out.name], "Y": [bias_name]},
            {"Out": [add_out]},
            {"axis": -1 if channels_last else 1}))]
        if act:
            new_ops.append(Operator(block, OpDesc(
                act, {"X": [add_out]}, {"Out": [bn_out]}, {})))
        idx = block.ops.index(conv_op)
        block.ops[idx + 1:idx + 1] = new_ops
        return True
