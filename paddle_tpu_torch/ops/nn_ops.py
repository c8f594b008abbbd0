"""Neural-network ops (counterpart of ``paddle_tpu/ops/nn_ops.py``):
`layer_norm` for the serving model, and the op rules of the training
programs — ``layer_norm``, ``softmax_with_cross_entropy`` (hard labels),
``lookup_table`` (dense gradient) and ``dropout``.

The LayerNorm and loss-head rules go through the autograd Functions of
`ops.kernels`, so their backward runs the LayerNorm and softmax-xent
backward kernels on the card and the plain versions on the CPU."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from . import kernels as K


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               begin_norm_axis: int = 1, epsilon: float = 1e-5):
    """layer_norm_op.cc over the trailing axes from ``begin_norm_axis``:
    returns (Y shaped like x, Mean and Variance shaped like
    ``x.shape[:begin_norm_axis]``).  The rows go to the LayerNorm kernel
    for CUDA tensors and to its plain version for CPU tensors; the
    statistics are f32, Y is in x's dtype.  Forward only (serving)."""
    f = math.prod(x.shape[begin_norm_axis:])
    x2 = x.reshape(-1, f)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    y, mean, var = K.layer_norm_fwd(x2, scale.reshape(f).float(),
                                    bias.reshape(f).float(), epsilon)
    lead = x.shape[:begin_norm_axis]
    return y.reshape(x.shape), mean.reshape(lead), var.reshape(lead)


@register_op("layer_norm", doc="layer_norm_op.cc")
def _layer_norm(ctx):
    x = ctx.input("X")
    scale, bias = ctx.input("Scale"), ctx.input("Bias")
    begin = ctx.attr("begin_norm_axis", 1)
    f = math.prod(x.shape[begin:])
    x2 = x.reshape(-1, f).contiguous()
    sc = (scale.reshape(f).float() if scale is not None
          else torch.ones(f, device=x.device))
    b = (bias.reshape(f).float() if bias is not None
         else torch.zeros(f, device=x.device))
    y, mean, var = K.LayerNorm.apply(x2, sc, b, ctx.attr("epsilon", 1e-5))
    ctx.set_output("Y", y.reshape(x.shape))
    ctx.set_output("Mean", mean.reshape(x.shape[:begin]))
    ctx.set_output("Variance", var.reshape(x.shape[:begin]))


@register_op("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ctx):
    logits = ctx.input("Logits")           # [..., V], any rank >= 2
    label = ctx.input("Label")
    if ctx.attr("soft_label", False):
        raise NotImplementedError("soft_label softmax_with_cross_entropy "
                                  "is not ported")
    lab = label[..., 0] if label.dim() == logits.dim() else label
    v = logits.shape[-1]
    loss = K.SoftmaxXent.apply(logits.reshape(-1, v).contiguous(),
                               lab.reshape(-1))
    ctx.set_output("Loss", loss.reshape(tuple(lab.shape) + (1,)))
    # the [.., V] probabilities only when something reads them
    if ctx.output_needed("Softmax"):
        ctx.set_output("Softmax", torch.softmax(logits.float(), dim=-1))


@register_op("lookup_table", doc="lookup_table_op.cc: embedding gather")
def _lookup_table(ctx):
    ids = ctx.input("Ids")
    w = ctx.input("W")
    flat = ids[..., 0] if ids.dim() >= 2 and ids.shape[-1] == 1 else ids
    out = F.embedding(flat.long(), w)
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        # the padding row reads (and so trains) as zeros
        out = out.masked_fill((flat == padding_idx)[..., None], 0.0)
    ctx.set_output("Out", out)


@register_op("dropout")
def _dropout(ctx):
    x = ctx.input("X")
    prob = ctx.attr("dropout_prob", 0.5)
    if ctx.attr("is_test", False):
        ctx.set_output("Out", x * (1.0 - prob))
        return
    if prob == 0.0:
        ctx.set_output("Out", x)
        if ctx.output_needed("Mask"):
            ctx.set_output("Mask", torch.ones_like(x))
        return
    keep = torch.rand(x.shape, generator=ctx.next_rng(), device=x.device)
    mask = (keep < 1.0 - prob).to(x.dtype)
    ctx.set_output("Mask", mask)
    ctx.set_output("Out", x * mask)
