"""Op registry: op type -> compute rule (counterpart of
``paddle_tpu/core/registry.py``).

Every op has ONE rule, a function of an `core.lowering.ExecContext`
written with torch functions; the rule runs on the executor's device, and
the port's kernel wrappers pick the CUDA kernel or its plain version from
the tensors' device.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional


class OpDef:
    __slots__ = ("type", "fn", "doc")

    def __init__(self, type: str, fn: Callable, doc: str = ""):
        self.type = type
        self.fn = fn
        self.doc = doc


class OpRegistry:
    _ops: Dict[str, OpDef] = {}

    @classmethod
    def register(cls, type: str, fn: Callable, doc: str = ""):
        if type in cls._ops:
            raise ValueError(f"op '{type}' registered twice")
        cls._ops[type] = OpDef(type, fn, doc)

    @classmethod
    def get(cls, type: str) -> OpDef:
        if type not in cls._ops:
            raise KeyError(
                f"op '{type}' has no registered compute rule "
                f"({len(cls._ops)} ops registered)")
        return cls._ops[type]

    @classmethod
    def has(cls, type: str) -> bool:
        return type in cls._ops

    @classmethod
    def registered_ops(cls):
        return sorted(cls._ops)


def register_op(type: str, doc: str = ""):
    """Decorator: @register_op("relu") def _rule(ctx): ..."""
    def deco(fn):
        OpRegistry.register(type, fn, doc or (fn.__doc__ or ""))
        return fn
    return deco
