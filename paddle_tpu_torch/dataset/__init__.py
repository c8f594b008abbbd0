"""Datasets (counterpart of ``paddle_tpu/dataset``): the synthetic
readers only.  The JAX package tries a download and falls back to
deterministic synthetic data; the port has no download and no network
code, and gives the same samples as the JAX fallback for the same
arguments.  Ported: ``wmt14``."""
from . import common    # noqa: F401
from . import wmt14     # noqa: F401
