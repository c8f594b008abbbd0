"""Loading saved models and training state (counterpart of the load side
of ``paddle_tpu/io.py``).

The JAX package saves variables as one ``<var>.npy`` each (or one
``.npz`` when a filename is given): a generation model's parameters plus
``__generation__.json`` with its hyperparameters, or a training
program's persistables (``save_persistables``: parameters, Adam moments
and beta-power accumulators or Momentum velocities, BatchNorm running
means and variances, the learning rate).  This module reads both with
numpy, so a model or a training run saved by the JAX package continues in
the port.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from .core.place import resolve_device
from .core.program import Program, default_main_program
from .core.scope import Scope, global_scope
from .core.types import to_torch_dtype
from .models.transformer import params_from_numpy, read_generation_spec


def _read_params(model_dir: str, params_filename: Optional[str] = None
                 ) -> Dict[str, np.ndarray]:
    """Name -> array of every parameter saved in ``model_dir``."""
    if params_filename is not None:
        path = os.path.join(model_dir, params_filename)
        if not os.path.exists(path) and not path.endswith(".npz"):
            path += ".npz"          # np.savez appends the suffix on save
        with np.load(path) as blob:
            return {k: blob[k] for k in blob.files}
    return {f[:-4]: np.load(os.path.join(model_dir, f))
            for f in sorted(os.listdir(model_dir)) if f.endswith(".npy")}


def load_generation_model(model_dir: str,
                          params_filename: Optional[str] = None,
                          precision: str = "f32", device=None):
    """The `TransformerLM` saved in ``model_dir`` (``spec`` on the
    returned module), on ``device`` (the card unless ``"cpu"``), in
    ``precision`` ("f32" or "bf16")."""
    spec = read_generation_spec(model_dir)
    if spec is None:
        raise ValueError(
            f"{model_dir} has no __generation__.json: save it with "
            "paddle_tpu.models.transformer.save_generation_model")
    return params_from_numpy(spec, _read_params(model_dir, params_filename),
                             precision=precision, device=device)


def _persistables(program: Program):
    return [v for v in program.list_vars()
            if v.persistable and not v.desc.is_data]


def scope_from_numpy(scope: Scope, program: Program,
                     arrays: Dict[str, np.ndarray], device=None):
    """Put every persistable of ``program`` into ``scope`` from ``arrays``
    (name -> array), as tensors of the declared dtype on ``device`` (the
    card unless ``"cpu"``).  Raises on a missing or surplus name and on a
    shape mismatch."""
    dev = resolve_device(device)
    wanted = {v.name: v for v in _persistables(program)}
    missing = sorted(set(wanted) - set(arrays))
    surplus = sorted(set(arrays) - set(wanted))
    if missing or surplus:
        raise ValueError(f"persistable names do not match the program: "
                         f"missing {missing}, surplus {surplus}")
    for name, var in wanted.items():
        src = np.asarray(arrays[name])
        if tuple(src.shape) != tuple(var.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} does not "
                             f"match the program's {tuple(var.shape)}")
        # a copy: the optimizer updates scope tensors in place
        scope.set(name, torch.tensor(src, dtype=to_torch_dtype(var.dtype),
                                     device=dev))


def load_persistables(executor, dirname: str,
                      main_program: Optional[Program] = None,
                      filename: Optional[str] = None):
    """Load what the JAX package's ``io.save_persistables`` wrote for
    ``main_program`` into the global scope, on ``executor``'s device."""
    program = main_program or default_main_program()
    scope_from_numpy(global_scope(), program,
                     _read_params(dirname, filename), executor.device)

