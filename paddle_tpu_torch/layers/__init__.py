"""Layers DSL (counterpart of ``paddle_tpu/layers``): the layer functions,
each appending ops to the current block."""
from .. import ops as _ops  # registers the op rules  # noqa: F401

from .nn import *          # noqa: F401,F403
from .tensor import *      # noqa: F401,F403
from .ops import *         # noqa: F401,F403
from .sequence import *    # noqa: F401,F403
from .misc import *        # noqa: F401,F403
from .control_flow import DynamicRNN, StaticRNN  # noqa: F401
from .io import data  # noqa: F401
from . import (control_flow, io, misc, nn, ops, sequence,  # noqa: F401
               tensor)
