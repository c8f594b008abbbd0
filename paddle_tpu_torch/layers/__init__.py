"""Layers DSL (counterpart of ``paddle_tpu/layers``): the layer functions
the training programs call, each appending ops to the current block."""
from .. import ops as _ops  # registers the op rules  # noqa: F401

from .io import data  # noqa: F401
from .misc import sharding_constraint  # noqa: F401
from .nn import (accuracy, batch_norm, conv2d,  # noqa: F401
                 cross_entropy, dropout, elementwise_add, elementwise_op,
                 embedding, fc, layer_norm, mean, pool2d, softmax,
                 softmax_with_cross_entropy, topk)
from .ops import amp_cast, scale  # noqa: F401
from .tensor import (create_global_var, reshape, slice,  # noqa: F401
                     transpose)
from . import io, misc, nn, ops, tensor  # noqa: F401
