"""Ops of the port: the CUDA kernels (`kernels`), their build (`_build`),
the tensor functions the serving model calls (`nn_ops`, `kv_cache_ops`,
`attention_ops`) and the op rules the executor interprets (the CSP
rules in `csp_ops`).  Importing the package registers every rule."""
from . import (amp_ops, array_ops, attention_ops, beam_ops,  # noqa: F401
               control_ops, crf_ops, csp_ops, detection_ops, dist_ops,
               kv_cache_ops, lod_ops, logic_ops, math_ops, misc_ops,
               nn_ops, optimizer_ops, rnn_ops, sequence_ops, tensor_ops)
