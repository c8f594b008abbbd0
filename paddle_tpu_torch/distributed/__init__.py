"""Distributed helpers of the port (counterpart of
``paddle_tpu/distributed``): only `backoff`, which the serving client
retries with, is ported."""
