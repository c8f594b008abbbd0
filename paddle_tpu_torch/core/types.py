"""Type system of the port's IR (counterpart of
``paddle_tpu/core/types.py``): the variable taxonomy and the one dtype
table, canonical names (the JAX package's spelling) to torch dtypes."""
from __future__ import annotations

import enum

import numpy as np
import torch


class VarType(enum.Enum):
    """Variable taxonomy, with the JAX package's values (they appear in
    serialized programs)."""

    LOD_TENSOR = "lod_tensor"
    SELECTED_ROWS = "selected_rows"
    LOD_TENSOR_ARRAY = "tensor_array"
    STEP_SCOPES = "step_scopes"
    LOD_RANK_TABLE = "lod_rank_table"
    READER = "reader"
    CHANNEL = "channel"
    PLACE_LIST = "place_list"
    RAW = "raw"


#: canonical dtype names -> torch dtypes
_DTYPE_TABLE = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_CANONICAL = {v: k for k, v in _DTYPE_TABLE.items()}


def convert_dtype(dtype) -> str:
    """Any dtype spelling (name, numpy dtype, torch dtype) -> its
    canonical name."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _CANONICAL:
            raise ValueError(f"unsupported dtype {dtype!r}")
        return _CANONICAL[dtype]
    if isinstance(dtype, str) and dtype in _DTYPE_TABLE:
        return dtype
    try:
        name = np.dtype(dtype).name
    except TypeError:
        raise ValueError(f"unsupported dtype {dtype!r}") from None
    if name not in _DTYPE_TABLE:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return name


def to_torch_dtype(name) -> torch.dtype:
    """A dtype name (or torch dtype, returned as is) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPE_TABLE[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None

