"""Ops of the port: the CUDA kernels (`kernels`), their build (`_build`),
and the op functions the model calls (`nn_ops`, `kv_cache_ops`)."""
