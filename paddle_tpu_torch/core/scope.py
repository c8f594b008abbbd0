"""Scope: name -> value store (counterpart of ``paddle_tpu/core/scope.py``).

Values are torch tensors on the executor's device: parameters, optimizer
accumulators, the learning rate.  The executor updates them in place, so a
training step copies no state.  There is no lazy binding: eager PyTorch
has no compiled state to keep device-resident elsewhere.

Under a mesh (`parallel.Partitioner`) a sharded var's resident value is
this rank's shard (`set_local`, read back by `get_local`); ``get``
gathers the whole value from every rank, as ``np.asarray`` of a sharded
jax array does.  That gather is a collective: every rank of the mesh
calls ``get`` for the same names in the same order (SPMD).  ``set``
drops a var's sharding.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict


class Scope:
    def __init__(self):
        self._vars: Dict[str, Any] = {}
        #: sharded var -> (partitioner, spec)
        self._sharded: Dict[str, Any] = {}

    def get(self, name: str, default=None):
        val = self._vars.get(name, default)
        placed = self._sharded.get(name)
        if placed is None or val is None:
            return val
        part, spec = placed
        return part.gather(val, spec)

    def get_local(self, name: str, default=None):
        """The resident value: this rank's shard of a sharded var."""
        return self._vars.get(name, default)

    def sharding(self, name: str):
        """(partitioner, spec) of a sharded var, else None."""
        return self._sharded.get(name)

    def set(self, name: str, value):
        self._vars[name] = value
        self._sharded.pop(name, None)

    def set_local(self, name: str, value, partitioner, spec):
        """Store this rank's shard of ``name`` under ``spec``."""
        self._vars[name] = value
        self._sharded[name] = (partitioner, spec)

    def local_var_names(self):
        return list(self._vars)

    def clear(self):
        """Drop every variable."""
        self._vars.clear()
        self._sharded.clear()


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
