"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

It sits beside the JAX package and imports nothing of it.  Module names
mirror the JAX package's, so each counterpart is found by name.  Three
slices are ported:

- training through the Fluid front end: a user script written for the
  JAX package runs with the import changed::

      import paddle_tpu_torch as fluid
      from paddle_tpu_torch.models import transformer
      tokens, labels, avg_cost = transformer.transformer_lm_train_program(...)
      exe = fluid.Executor(fluid.CUDAPlace(0))
      exe.run(fluid.default_startup_program())
      (loss,) = exe.run(feed={...}, fetch_list=[avg_cost])

  The Executor interprets the Program op by op; one ``backward`` op
  differentiates the recorded forward, one optimizer op per parameter
  (``adam``, ``momentum``, ``sgd``) updates it in place.  Two models:
  the transformer LM (Adam, f32) and ResNet (`models.resnet`, Momentum,
  with ``program.amp`` for bf16 convolutions);
- serving the transformer LM: `serving.decode_engine.DecodeEngine` over a
  paged KV cache.

Their kernels (paged attention, FlashAttention-2 forward and backward,
LayerNorm forward and backward, softmax cross-entropy forward and
backward, BatchNorm training backward) are written in CUDA
(``ops/csrc``).  Entry points run on the card unless the caller asks for
the CPU (``Executor(CPUPlace())``, ``device="cpu"``).
"""
from . import (core, initializer, io, layers, nets, optimizer,  # noqa: F401
               unique_name)
from .core import (Executor, CPUPlace, CUDAPlace, Program,  # noqa: F401
                   Variable, Parameter, append_backward,
                   default_main_program, default_startup_program,
                   global_scope, program_guard, scope_guard)
from .param_attr import ParamAttr  # noqa: F401

__version__ = "0.3.0"
