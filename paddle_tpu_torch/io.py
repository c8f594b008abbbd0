"""Loading saved models (counterpart of the load side of
``paddle_tpu/io.py``).

The JAX package saves a generation model as one ``<var>.npy`` per
parameter (or one ``.npz`` when a params filename is given) plus
``__generation__.json`` with the hyperparameters.  This module reads that
artifact with numpy, so a model saved by the JAX package is served by
the port.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

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
