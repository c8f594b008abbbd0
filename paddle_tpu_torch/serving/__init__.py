"""Serving of the port (counterpart of ``paddle_tpu/serving``), one
layer per file:

- ``predictor.py``     — `Predictor`: in-process inference over a saved
  model on one device, in f32, bf16 or int8;
- ``engine.py``        — `ServingEngine`: the dynamic batcher (coalesce,
  pad to a bucket, one forward, scatter);
- ``decode_engine.py`` — `DecodeEngine`: continuous-batching decode over
  a paged KV cache, with the radix-tree prefix cache;
- ``registry.py``      — `ModelRegistry`: named, versioned models behind
  one endpoint, with draining reload and per-model metric labels;
- ``server.py``        — `InferenceServer` and `ServingClient`: the JAX
  package's newline-JSON wire, byte for byte.

``python -m paddle_tpu_torch serve`` wires them together.  Not ported
yet (ROADMAP queue A item 1): the sharded predictor, the compile cache
(XLA-only), hot rows, and the fleet.
"""
from .predictor import Predictor  # noqa: F401
from .engine import (ServingEngine, SlimFuture,  # noqa: F401
                     EngineOverloadedError)
from .registry import (ModelRegistry, UnknownModelError,  # noqa: F401
                       GenerationUnsupportedError, read_manifest)
from ..io import MANIFEST_FILENAME  # noqa: F401
from .decode_engine import (DecodeEngine, BlockAllocator,  # noqa: F401
                            GenerateHandle, PrefixCache,
                            greedy_decode_full, greedy_decode_kv)
from .server import (InferenceServer, ServingClient,  # noqa: F401
                     ServingError, RETRIABLE_CODES, infer_round_trip,
                     serving_stats, serving_metrics, list_models,
                     shutdown_serving, wait_for_port_file,
                     write_port_file)
