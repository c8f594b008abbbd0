"""Scope: name -> value store (counterpart of ``paddle_tpu/core/scope.py``).

Values are torch tensors on the executor's device: parameters, optimizer
accumulators, the learning rate.  The executor updates them in place, so a
training step copies no state.  There is no lazy binding: eager PyTorch
has no compiled state to keep device-resident elsewhere.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict


class Scope:
    def __init__(self):
        self._vars: Dict[str, Any] = {}

    def get(self, name: str, default=None):
        return self._vars.get(name, default)

    def set(self, name: str, value):
        self._vars[name] = value

    def local_var_names(self):
        return list(self._vars)

    def clear(self):
        """Drop every variable."""
        self._vars.clear()


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = old
