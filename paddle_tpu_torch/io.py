"""Saving and loading models and training state (counterpart of
``paddle_tpu/io.py``).

The file formats are the JAX package's, so an artifact either package
saves loads in the other:

- variables as one ``<var>.npy`` each, or one ``.npz`` when a filename
  is given (``save_vars`` / ``save_params`` / ``save_persistables``):
  a training program's persistables (parameters, Adam moments and
  beta-power accumulators or Momentum velocities, BatchNorm running
  means and variances, the learning rate), or a model's parameters;
- an inference model (``save_inference_model``): ``__model__`` (the
  program cloned for test and pruned to the fetches, as JSON, with the
  feed and fetch names), its persistables, and ``__manifest__.json``,
  whose ``fingerprint`` hashes the program and the parameter bytes (the
  registry's reload no-ops on an unchanged one);
- a generation model: an inference model plus ``__generation__.json``
  (`models.transformer.save_generation_model`).

Every write goes to a temporary file first and is published by
``os.replace``, so a reader sees the old file or the new one, never a
torn one.  ``export_stablehlo`` is XLA's and is refused.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .core.place import resolve_device
from .core.program import (Parameter, Program, Variable,
                           default_main_program)
from .core.scope import Scope, global_scope
from .core.types import to_torch_dtype
from .models.transformer import params_from_numpy, read_generation_spec

MODEL_FILENAME = "__model__"
MANIFEST_FILENAME = "__manifest__.json"


@contextlib.contextmanager
def _atomic_write(path: str, mode: str = "w"):
    """Write to ``<path>.tmp-<pid>`` and publish it with ``os.replace``
    (a kill mid-write truncates only the temporary file)."""
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, mode) as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def program_fingerprint(program: Program) -> str:
    """Structural identity of a program: the JAX package's recipe
    (``paddle_tpu/checkpoint/manager.py``), so both packages agree on
    what "the same program" means."""
    return hashlib.sha1(
        json.dumps(program.to_dict(), sort_keys=True).encode()
    ).hexdigest()[:16]


def _numpy(val) -> np.ndarray:
    """A scope value (a tensor on any device, or an array) as a
    C-ordered numpy array."""
    if isinstance(val, torch.Tensor):
        val = val.detach().cpu().numpy()
    return np.ascontiguousarray(val)


def _is_persistable(var: Variable) -> bool:
    return bool(var.persistable) and not var.desc.is_data


# ---------------------------------------------------------------------------
# save side
# ---------------------------------------------------------------------------

def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Write the scope's value of each var (``vars``, or the program's
    vars that ``predicate`` accepts) as ``<name>.npy``, or all into one
    ``<filename>.npz``.  A var with no value in the scope is skipped."""
    main_program = main_program or default_main_program()
    scope = global_scope()
    if vars is None:
        vars = [v for v in main_program.list_vars() if predicate(v)]
    os.makedirs(dirname, exist_ok=True)
    if filename is not None:
        blob = {v.name: _numpy(scope.get(v.name)) for v in vars
                if scope.get(v.name) is not None}
        # np.savez appends .npz when absent: pin the final name
        final = filename if filename.endswith(".npz") else filename + ".npz"
        with _atomic_write(os.path.join(dirname, final), "wb") as f:
            np.savez(f, **blob)
        return
    for var in vars:
        val = scope.get(var.name)
        if val is None:
            continue
        with _atomic_write(os.path.join(dirname, var.name + ".npy"),
                           "wb") as f:
            np.save(f, _numpy(val))


def save_params(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program,
              predicate=lambda v: isinstance(v, Parameter),
              filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    """Every persistable var: parameters, optimizer state, BatchNorm
    running statistics."""
    save_vars(executor, dirname, main_program, predicate=_is_persistable,
              filename=filename)


def save_inference_model(dirname, feeded_var_names: Sequence[str],
                         target_vars: Sequence[Variable], executor,
                         main_program: Optional[Program] = None,
                         model_filename=None, params_filename=None,
                         export_stablehlo: bool = False,
                         export_batch_size: int = 1) -> List[str]:
    """Export ``main_program`` cloned for test and pruned to
    ``target_vars``: ``__model__``, its persistables from the global
    scope, and ``__manifest__.json``.  Returns the fetch names."""
    if export_stablehlo:
        raise ValueError(
            "export_stablehlo lowers the program through XLA for the "
            "native PJRT runner; the port has no XLA and does not export "
            "it (ROADMAP queue C: XLA-only options)")
    main_program = main_program or default_main_program()
    os.makedirs(dirname, exist_ok=True)
    pruned = main_program.clone(for_test=True).prune(target_vars)
    fetch_names = [t.name for t in target_vars]
    meta = {"program": pruned.to_dict(),
            "feed_names": list(feeded_var_names),
            "fetch_names": fetch_names}
    with _atomic_write(
            os.path.join(dirname, model_filename or MODEL_FILENAME)) as f:
        json.dump(meta, f)
    save_persistables(executor, dirname, pruned, filename=params_filename)
    _write_manifest(dirname, pruned, list(feeded_var_names), fetch_names,
                    params_filename)
    return fetch_names


def _write_manifest(dirname, pruned: Program, feed_names, fetch_names,
                    params_filename):
    """``__manifest__.json``: the artifact's identity.  ``fingerprint``
    covers the program and the saved parameter bytes, so retrained
    weights under the same architecture change it."""
    scope = global_scope()
    program_fp = program_fingerprint(pruned)
    h = hashlib.sha1(program_fp.encode())
    var_names = []
    for v in sorted(pruned.global_block().vars.values(),
                    key=lambda v: v.name):
        if not _is_persistable(v):
            continue
        val = scope.get(v.name)
        if val is None:
            continue
        var_names.append(v.name)
        arr = _numpy(val)
        h.update(v.name.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    manifest = {"fingerprint": h.hexdigest()[:16],
                "program_fingerprint": program_fp,
                "vars": var_names,
                "feed_names": list(feed_names),
                "fetch_names": list(fetch_names),
                "params_filename": params_filename,
                "saved_at": time.time()}
    with _atomic_write(os.path.join(dirname, MANIFEST_FILENAME)) as f:
        json.dump(manifest, f, indent=1)
    return manifest


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """Read an inference model saved by either package: returns
    ``(program, feed_names, fetch_vars)``, with the program's
    persistables put into the global scope as numpy arrays (the
    predictor places its own copy on its device)."""
    with open(os.path.join(dirname, model_filename or MODEL_FILENAME)) as f:
        meta = json.load(f)
    program = Program.parse_from_string(json.dumps(meta["program"]))
    saved = _read_params(dirname, params_filename)
    scope = global_scope()
    for var in program.list_vars():
        if _is_persistable(var) and var.name in saved:
            scope.set(var.name, saved[var.name])
    fetch_vars = [program.global_block().var(n) for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars


# ---------------------------------------------------------------------------
# load side
# ---------------------------------------------------------------------------

def _read_params(model_dir: str, params_filename: Optional[str] = None
                 ) -> Dict[str, np.ndarray]:
    """Name -> array of every variable saved in ``model_dir``."""
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
    ``precision`` ("f32", "bf16" or "int8")."""
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

