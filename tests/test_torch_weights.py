"""Weight carry-over from the JAX package to the port, and the port's
package boundary: it imports neither JAX nor the JAX package, and its
entry points never drop to the CPU on their own."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu import io as jax_io
from paddle_tpu.core.executor import Executor
from paddle_tpu.core.place import CPUPlace
from paddle_tpu.core.scope import Scope, scope_guard
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch import io as pio
from paddle_tpu_torch.core.place import resolve_device, to_torch_dtype
from paddle_tpu_torch.models.transformer import (TransformerLM, param_shapes,
                                                 params_from_numpy,
                                                 random_params)
from paddle_tpu_torch.serving.decode_engine import DecodeEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = dict(vocab=64, max_len=32, n_layers=2, d_model=32, n_heads=4,
            d_ff=48)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_weights"))
    spec = JT.save_generation_model(d, **SPEC, seed=9)
    scope = Scope()
    with scope_guard(scope):
        jax_io.load_inference_model(d, Executor(CPUPlace()))
    arrays = {name: np.asarray(scope.get(name))
              for name in param_shapes(spec)}
    return d, spec, arrays


def test_load_generation_model_equals_params_from_jax_scope(saved):
    d, spec, arrays = saved
    loaded = pio.load_generation_model(d, device="cpu")
    built = params_from_numpy(spec, arrays, device="cpu")
    a, b = loaded.named_artifact_tensors(), built.named_artifact_tensors()
    assert set(a) == set(b) == set(param_shapes(spec))
    for name in a:
        assert torch.equal(a[name], b[name]), name
        np.testing.assert_array_equal(a[name].numpy(), arrays[name])


def test_npz_params_file(saved, tmp_path):
    d, spec, arrays = saved
    import shutil
    shutil.copy(os.path.join(d, JT.GENERATION_SPEC_FILENAME), tmp_path)
    np.savez(tmp_path / "params.npz", **arrays)
    m = pio.load_generation_model(str(tmp_path), "params", device="cpu")
    assert torch.equal(m.head_w, torch.from_numpy(
        arrays[f"fc_{3 * SPEC['n_layers']}.w_0"]))


def test_missing_surplus_and_misshapen_names_raise(saved):
    _, spec, arrays = saved
    missing = dict(arrays)
    del missing["layer_norm_1.b_0"]
    with pytest.raises(ValueError, match="layer_norm_1.b_0"):
        params_from_numpy(spec, missing, device="cpu")
    surplus = dict(arrays, **{"fc_99.w_0": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="fc_99.w_0"):
        params_from_numpy(spec, surplus, device="cpu")
    bad = dict(arrays, **{"fc_0.w_0": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="fc_0.w_0"):
        params_from_numpy(spec, bad, device="cpu")


def test_bf16_precision_rounds_every_parameter(saved):
    _, spec, arrays = saved
    m = params_from_numpy(spec, arrays, precision="bf16", device="cpu")
    assert m.embedding.dtype == torch.bfloat16
    ln = m.named_artifact_tensors()["layer_norm_0.w_0"]
    assert ln.dtype == torch.float32          # what the LN kernel reads
    want = torch.from_numpy(arrays["layer_norm_0.w_0"]).to(torch.bfloat16)
    assert torch.equal(ln, want.float())


def test_random_params_cover_the_model():
    arrays = random_params(dict(SPEC, eos_id=None), seed=1)
    m = params_from_numpy(dict(SPEC), arrays, device="cpu")
    assert isinstance(m, TransformerLM)
    again = random_params(dict(SPEC), seed=1)
    assert all(np.array_equal(arrays[k], again[k]) for k in arrays)


def test_port_imports_no_jax_and_no_jax_package():
    code = ("import sys; import paddle_tpu_torch, paddle_tpu_torch.io, "
            "paddle_tpu_torch.nets, paddle_tpu_torch.ops.kernels, "
            "paddle_tpu_torch.ops.nn_ops, paddle_tpu_torch.ops.kv_cache_ops, "
            "paddle_tpu_torch.models.transformer, "
            "paddle_tpu_torch.serving.decode_engine, "
            "paddle_tpu_torch.core.executor, paddle_tpu_torch.layers, "
            "paddle_tpu_torch.optimizer, paddle_tpu_torch.ops.attention_ops, "
            "paddle_tpu_torch.ops.logic_ops, paddle_tpu_torch.models.resnet, "
            "paddle_tpu_torch.parallel.ring_attention, "
            "paddle_tpu_torch.parallel.pipeline, "
            "paddle_tpu_torch.distributed.param_server, "
            "paddle_tpu_torch.distributed.master, "
            "paddle_tpu_torch.ops.dist_ops, paddle_tpu_torch.v2, "
            "paddle_tpu_torch.v2.image, paddle_tpu_torch.v2.master, "
            "paddle_tpu_torch.v2.plot, paddle_tpu_torch.trainer_config_helpers, "
            "paddle_tpu_torch.trainer.PyDataProvider2, "
            "paddle_tpu_torch.debuger, paddle_tpu_torch.__main__, "
            "paddle_tpu_torch.concurrency, paddle_tpu_torch.ops.csp_ops, "
            "paddle_tpu_torch.native, paddle_tpu_torch.recordio, "
            "paddle_tpu_torch.reader.creator; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_without_cuda_raise(saved, monkeypatch):
    d, spec, _ = saved
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerLM(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine.from_model_dir(d)
    assert resolve_device("cpu") == torch.device("cpu")


def test_dtype_table():
    assert to_torch_dtype("float32") is torch.float32
    assert to_torch_dtype("bfloat16") is torch.bfloat16
    assert to_torch_dtype("int32") is torch.int32
    assert to_torch_dtype("int64") is torch.int64
    with pytest.raises(ValueError):
        to_torch_dtype("float8")
