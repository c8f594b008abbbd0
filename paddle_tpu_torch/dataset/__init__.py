"""Datasets (counterpart of ``paddle_tpu/dataset``): the synthetic
readers only.  The JAX package tries a download and falls back to
deterministic synthetic data; the port has no download and no network
code, and gives the same samples as the JAX fallback for the same
arguments."""
from . import common    # noqa: F401
from . import mnist     # noqa: F401
from . import uci_housing  # noqa: F401
from . import imdb      # noqa: F401
from . import wmt14     # noqa: F401
from . import wmt16     # noqa: F401
from . import cifar     # noqa: F401
from . import imikolov  # noqa: F401
from . import movielens  # noqa: F401
from . import conll05   # noqa: F401
from . import sentiment  # noqa: F401
from . import flowers   # noqa: F401
from . import voc2012   # noqa: F401
from . import mq2007    # noqa: F401
