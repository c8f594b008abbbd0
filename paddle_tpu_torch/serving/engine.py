"""Serving errors shared by the port's engines (counterpart of
``paddle_tpu/serving/engine.py``; only the overload error is ported)."""
from __future__ import annotations


class EngineOverloadedError(RuntimeError):
    """The bounded request queue is full.  Retriable: a well-behaved
    client backs off and retries, a fleet frontend routes the request to
    a less-loaded replica."""

    def __init__(self, model: str, depth: int, bound: int):
        super().__init__(
            f"engine is overloaded: model {model!r} queue depth {depth} at "
            f"bound {bound}")
        self.model = model
        self.depth = depth
        self.bound = bound
