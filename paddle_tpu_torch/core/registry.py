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
    __slots__ = ("type", "fn", "doc", "draws_rng")

    def __init__(self, type: str, fn: Callable, doc: str = "",
                 draws_rng: bool = False):
        self.type = type
        self.fn = fn
        self.doc = doc
        #: the rule draws from the executor's generator: it always runs,
        #: so that skipping it cannot shift a later draw
        self.draws_rng = draws_rng


class OpRegistry:
    _ops: Dict[str, OpDef] = {}

    @classmethod
    def register(cls, type: str, fn: Callable, doc: str = "",
                 draws_rng: bool = False):
        if type in cls._ops:
            raise ValueError(f"op '{type}' registered twice")
        cls._ops[type] = OpDef(type, fn, doc, draws_rng)

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


def register_op(type: str, doc: str = "", draws_rng: bool = False):
    """Decorator: @register_op("relu") def _rule(ctx): ...  Mark a rule
    that calls ``ctx.next_rng()`` with ``draws_rng=True``."""
    def deco(fn):
        OpRegistry.register(type, fn, doc or (fn.__doc__ or ""), draws_rng)
        return fn
    return deco
