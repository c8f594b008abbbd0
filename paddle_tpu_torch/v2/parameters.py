"""v2 Parameters (reference: python/paddle/v2/parameters.py; counterpart
of ``paddle_tpu/v2/parameters.py``).

Numpy-facing view of model parameters.  The reference proxies into the
C++ GradientMachine; here the backing store is either a local dict of
host arrays or a live Scope of device tensors (when attached to a
trainer) — ``attach_scope`` plays the role of ``append_gradient_machine``.
Every read of a scope value goes through `_to_host` (a host copy, as
numpy), every write into a scope through `_to_scope` (on the device and
in the dtype of the value it replaces).

The tar is the JAX package's: one raw ``.npy`` entry a parameter, so a
tar written by either package loads into the other (`Parameters.from_tar`).
"""
from __future__ import annotations

import tarfile
import io as _io

import numpy as np
import torch

__all__ = ["Parameters", "create"]


def _to_host(val) -> np.ndarray:
    """A host copy of a scope value, as numpy (a bf16 tensor as f32)."""
    if isinstance(val, torch.Tensor):
        val = val.detach()
        if val.dtype == torch.bfloat16:
            val = val.float()
        return val.cpu().numpy()
    return np.array(val)


def _to_scope(scope, name, value, device):
    """Store ``value`` under ``name``: on the device and in the dtype of
    the tensor it replaces, else as a tensor on ``device``."""
    cur = scope.get(name)
    t = torch.as_tensor(np.asarray(value))
    scope.set(name, t.to(device=cur.device, dtype=cur.dtype)
              if isinstance(cur, torch.Tensor) else t.to(device))


def create(layers):
    """Instantiate parameters for a topology (reference parameters.create).

    Builds the network into a scratch Program, runs its startup (init ops)
    on the CPU with a generator seeded from the startup program's
    ``random_seed``, and snapshots every persistable var.
    """
    from .topology import Topology
    from ..core.program import Program, program_guard
    from ..core.scope import Scope
    from ..core.lowering import run_startup
    from ..trainer_config_helpers.layers import parse_network

    topo = layers if isinstance(layers, Topology) else Topology(layers)
    prog, startup = Program(), Program()
    with program_guard(prog, startup):
        parse_network(*(topo.layers + topo.extra_layers))
    scope = Scope()
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(startup.random_seed or 0))
    run_startup(startup, scope, torch.device("cpu"), gen)
    params = Parameters()
    for v in prog.global_block().vars.values():
        if getattr(v, "persistable", False):
            val = scope.get(v.name)
            if val is not None:
                params._params[v.name] = _to_host(val)
    return params


class Parameters(object):
    def __init__(self):
        self._params = {}
        self._scope = None           # live backing scope once training
        self._device = None          # its executor's device

    # -- scope attachment (gradient-machine analog) -------------------------
    def attach_scope(self, scope, device):
        """Point this object at a live scope; pending values are pushed,
        each on the device and in the dtype of the value it replaces (a
        name the scope lacks goes to ``device``, the executor's).

        If previously attached elsewhere (e.g. trainer scope → inference
        scope), current live values are snapshot first so training results
        carry over — the v2 flow `trainer.train(...); paddle.infer(params)`.
        """
        if self._scope is not None and self._scope is not scope:
            for name in self._names_in_scope():
                val = self._scope.get(name)
                if val is not None:
                    self._params[name] = _to_host(val)
        self._scope = scope
        self._device = device
        for name, val in self._params.items():
            _to_scope(scope, name, val, device)

    # -- dict protocol -------------------------------------------------------
    def keys(self):
        if self._scope is not None:
            return [n for n in self._names_in_scope()]
        return list(self._params.keys())

    def _names_in_scope(self):
        known = set(self._params)
        known.update(n for n in self._scope.local_var_names()
                     if not n.startswith("@"))
        return sorted(known)

    def names(self):
        return self.keys()

    def has_key(self, key):
        return key in self.keys()

    def __contains__(self, key):
        return self.has_key(key)

    def __iter__(self):
        return iter(self.keys())

    def __len__(self):
        return len(self.keys())

    def __getitem__(self, key):
        return self.get(key)

    def __setitem__(self, key, value):
        self.set(key, value)

    def get(self, parameter_name):
        if self._scope is not None:
            val = self._scope.get(parameter_name)
            if val is not None:
                return _to_host(val)
        if parameter_name in self._params:
            return np.asarray(self._params[parameter_name])
        raise KeyError(f"no parameter {parameter_name!r}")

    def get_shape(self, key):
        return tuple(self.get(key).shape)

    def set(self, parameter_name, value):
        value = np.asarray(value)
        self._params[parameter_name] = value
        if self._scope is not None:
            _to_scope(self._scope, parameter_name, value, self._device)

    # -- serialization (to_tar parity; entries are raw npy) ------------------
    def serialize(self, name, f):
        arr = self.get(name)
        np.save(f, arr, allow_pickle=False)

    def deserialize(self, name, f):
        self.set(name, np.load(f, allow_pickle=False))

    def to_tar(self, f):
        with tarfile.open(fileobj=f, mode="w") as tar:
            for name in self.keys():
                buf = _io.BytesIO()
                self.serialize(name, buf)
                raw = buf.getvalue()
                info = tarfile.TarInfo(name=name)
                info.size = len(raw)
                tar.addfile(info, _io.BytesIO(raw))

    @staticmethod
    def from_tar(f):
        params = Parameters()
        with tarfile.open(fileobj=f, mode="r") as tar:
            for member in tar.getmembers():
                data = tar.extractfile(member).read()
                params.deserialize(member.name, _io.BytesIO(data))
        return params

    def init_from_tar(self, f, exclude_params=()):
        other = Parameters.from_tar(f)
        for name in other.keys():
            if name not in exclude_params:
                self.set(name, other.get(name))
