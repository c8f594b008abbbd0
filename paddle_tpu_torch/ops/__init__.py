"""Ops of the port: the CUDA kernels (`kernels`), their build (`_build`),
the tensor functions the serving model calls (`nn_ops`, `kv_cache_ops`,
`attention_ops`) and the op rules the executor interprets.  Importing the
package registers every rule."""
from . import (attention_ops, logic_ops, math_ops,  # noqa: F401
               misc_ops, nn_ops, optimizer_ops, rnn_ops, sequence_ops,
               tensor_ops)
