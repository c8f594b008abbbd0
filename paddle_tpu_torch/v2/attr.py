"""v2 attr namespace (reference: python/paddle/v2/attr.py)."""
from __future__ import annotations

from ..trainer_config_helpers.attrs import (ParameterAttribute,  # noqa: F401
                                            ExtraLayerAttribute)

Param = ParameterAttribute
Extra = ExtraLayerAttribute
ParamAttr = ParameterAttribute
ExtraAttr = ExtraLayerAttribute

__all__ = ["Param", "Extra", "ParamAttr", "ExtraAttr",
           "ParameterAttribute", "ExtraLayerAttribute"]
