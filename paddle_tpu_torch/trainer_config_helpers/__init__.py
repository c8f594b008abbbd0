"""v1 config DSL parity (reference: python/paddle/trainer_config_helpers).

Counterpart of ``paddle_tpu/trainer_config_helpers``.  The reference's v1
DSL builds a protobuf ``ModelConfig`` that a C++ trainer interprets
layer-by-layer (config_parser.py + gserver).  Here the same layer
vocabulary builds a *lazy layer graph* that ``parse_network`` lowers onto
the port's Program IR (`core.program`), which the port's Executor
interprets op by op on the card.  Programs, parameter names and the
Program JSON are the JAX package's for the same config.
"""
from .activations import *  # noqa: F401,F403
from .poolings import *  # noqa: F401,F403
from .attrs import *  # noqa: F401,F403
from .layers import *  # noqa: F401,F403
from .networks import *  # noqa: F401,F403
from .optimizers import *  # noqa: F401,F403
from .evaluators import *  # noqa: F401,F403
from . import activations, poolings, attrs, layers, networks, optimizers  # noqa: F401
from . import evaluators  # noqa: F401
from .data_sources import (define_py_data_sources2,  # noqa: F401
                           get_data_source, clear_data_sources)
