"""Legacy v1 trainer package surface (parity: python/paddle/trainer/).

The config DSL lives in trainer_config_helpers; this package hosts
PyDataProvider2, the user-data-provider protocol the legacy C++ trainer
drove through PyDataProvider2.cpp.
"""
from . import PyDataProvider2  # noqa: F401
