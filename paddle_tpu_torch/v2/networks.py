"""v2 networks namespace (reference: python/paddle/v2/networks.py)."""
from __future__ import annotations

from ..trainer_config_helpers.networks import *  # noqa: F401,F403
from ..trainer_config_helpers.networks import __all__  # noqa: F401
