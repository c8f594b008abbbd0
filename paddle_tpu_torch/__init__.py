"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

It sits beside the JAX package and imports nothing of it.  Module names
mirror the JAX package's, so each counterpart is found by name.  Ported
so far:

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
  (every optimizer of the JAX package) updates it in place.  The
  training loop is ported whole: `optimizer.MixedPrecision` (dynamic
  loss scaling with a bitwise skip on overflow), gradient clipping
  (`clip`), weight decay (`regularizer`), the LR schedules,
  `optimizer.ModelAverage`, ``Executor.train_loop`` with
  ``check_nan_inf``, K-step windows and `checkpoint` resume, the fault
  points (`fault`), `flags` and the `reader` decorators.  The dense op
  families (math, tensor, logic and the dense nn rules), their layers,
  ``Variable``'s operators, the ``nets`` image helpers, `DataFeeder`,
  `metrics`, `evaluator` and `average` are ported.  The models: the
  transformer LM (Adam, f32), ResNet (`models.resnet`, Momentum, with
  ``program.amp`` for bf16 convolutions), LeNet-5 (`models.lenet`) and
  VGG-16 with BatchNorm (`models.vgg`), and the sequence family: the
  stacked dynamic LSTM (`models.stacked_lstm`, a DynamicRNN cell plus
  ``dynamic_lstm`` layers) and ``dynamic_gru`` classifiers, fed padded
  ids with a ``<name>@SEQ_LEN`` length vector.  Detection: the SSD op
  rules and layers (`layers.multi_box_head`, ``ssd_loss``,
  ``detection_output``, ``detection_map``).  Input: the reader ops
  (`layers.open_recordio_file` ... ``read_file``) over `recordio` files
  written by `recordio_writer`, which ``Executor.run`` and
  ``train_loop`` read when a step has no feed, and every `dataset`
  (synthetic, no download);
- serving the transformer LM: `serving.decode_engine.DecodeEngine` over a
  paged KV cache, with a radix prefix cache;
- the serving front door: `serving.Predictor` over a saved inference
  model (``io.save_inference_model`` / ``load_inference_model``), the
  dynamic batcher `serving.ServingEngine`, `serving.ModelRegistry`, the
  TCP `serving.InferenceServer` (the JAX package's wire), and
  ``python -m paddle_tpu_torch serve``;
- the legacy training API: the v1 config DSL (`trainer_config_helpers`),
  ``import paddle_tpu_torch.v2 as paddle`` (``paddle.trainer.SGD``,
  ``paddle.infer`` and the JAX package's parameter tars),
  `trainer.PyDataProvider2` and `debuger`;
- CSP (`concurrency`: channels, ``Go``, ``Select``, and their ops in a
  Program) and the native C++ runtime (`native`: the recordio writer
  and scanner, the threaded loader, the blocking queue, the memory pool,
  the C++ CPU inference runner and its C API), built with g++ at first
  use.

Their kernels (paged attention, FlashAttention-2 forward and backward,
LayerNorm forward and backward, softmax cross-entropy forward and
backward, BatchNorm training backward, the LSTM and GRU recurrences
forward and backward) are written in CUDA (``ops/csrc``).  Entry points run on the card unless the caller asks for
the CPU (``Executor(CPUPlace())``, ``device="cpu"``, ``--device cpu``).
"""
from . import flags  # noqa: F401  (the FLAGS_* bootstrap runs first)
from .flags import FLAGS  # noqa: F401
from . import (average, backward, core, dataset,  # noqa: F401
               evaluator, initializer, io, layers, metrics, nets, optimizer,
               unique_name)
from . import checkpoint, clip, fault, reader, regularizer  # noqa: F401
from .checkpoint import CheckpointManager  # noqa: F401
from . import concurrency  # noqa: F401
from .concurrency import (Go, Select, make_channel, channel_send,  # noqa: F401
                          channel_recv, channel_close)
from .data_feeder import DataFeeder  # noqa: F401
from .core import (Executor, CPUPlace, CUDAPlace, Program,  # noqa: F401
                   Variable, Parameter, append_backward,
                   default_main_program, default_startup_program,
                   global_scope, program_guard, scope_guard)
from .core.lowering import LEN_SUFFIX  # noqa: F401
from .memory_optimization_transpiler import (memory_optimize,  # noqa: F401
                                             release_memory)
from .param_attr import ParamAttr  # noqa: F401

__version__ = "0.5.0"
