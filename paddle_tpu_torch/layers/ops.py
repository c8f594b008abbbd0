"""Pass-through layers (counterpart of ``paddle_tpu/layers/ops.py``;
``scale`` and ``amp_cast``).  Activations reach programs through a
layer's ``act`` argument (`LayerHelper.append_activation`)."""
from __future__ import annotations

from ..layer_helper import LayerHelper


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None,
          out=None):
    helper = LayerHelper("scale", input=x, act=act, name=name)
    out = out or helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    out.desc.shape = x.shape
    return helper.append_activation(out)


def amp_cast(x, name=None):
    """Where a model's activation stream drops to bf16 under
    ``program.amp``; the identity at full precision."""
    helper = LayerHelper("amp_cast", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="amp_cast", inputs={"X": [x]},
                     outputs={"Out": [out]})
    out.desc.shape = x.shape
    out.desc.lod_level = x.lod_level
    return out
