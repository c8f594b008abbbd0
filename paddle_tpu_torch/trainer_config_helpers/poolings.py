"""Sequence-pooling config objects (reference: trainer_config_helpers/poolings.py)."""
from __future__ import annotations

__all__ = [
    "BasePoolingType", "MaxPooling", "AvgPooling", "SumPooling",
    "SquareRootNPooling", "CudnnMaxPooling", "CudnnAvgPooling",
]


class BasePoolingType(object):
    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return self.name


class MaxPooling(BasePoolingType):
    def __init__(self, output_max_index=None):
        super().__init__("max")
        self.output_max_index = output_max_index


class AvgPooling(BasePoolingType):
    STRATEGY_AVG = "average"
    STRATEGY_SUM = "sum"
    STRATEGY_SQROOTN = "squarerootn"

    def __init__(self, strategy=STRATEGY_AVG):
        super().__init__("average")
        self.strategy = strategy


class SumPooling(BasePoolingType):
    def __init__(self):
        super().__init__("sum")


class SquareRootNPooling(BasePoolingType):
    def __init__(self):
        super().__init__("sqrt")


# cudnn variants are aliases: the port's pool rules pick the implementation.
CudnnMaxPooling = MaxPooling
CudnnAvgPooling = AvgPooling


def to_pool_name(pooling_type, default="sum"):
    if pooling_type is None:
        return default
    if isinstance(pooling_type, str):
        return pooling_type
    return pooling_type.name
