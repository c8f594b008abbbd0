"""The port's Fluid front end against the JAX package's: the training
program it builds, the JSON both read and write, and the startup program's
initial values.

The transformer LM training program is built at a small size (2 layers,
d_model 32, 4 heads, d_ff 64, vocab 64, T 16) by both packages.  Program
structure must be identical.  Random initial values cannot be: the port
draws from a ``torch.Generator``, the JAX package from threefry, so the
random initializers are held to their distributions by statistics.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import transformer as JT
import paddle_tpu_torch as fluid
from paddle_tpu_torch import io as pio
from paddle_tpu_torch.core.program import Program
from paddle_tpu_torch.models import transformer as PT

CFG = dict(vocab=64, max_len=16, n_layers=2, d_model=32, n_heads=4, d_ff=64)


@pytest.fixture(autouse=True)
def _fresh_port():
    fluid.core.program.reset_default_programs()
    fluid.core.scope._global_scope = fluid.core.scope.Scope()
    yield


def _build_both():
    """(JAX main, JAX startup, port main, port startup, port avg_cost)."""
    JT.transformer_lm_train_program(**CFG)
    _, _, cost = PT.transformer_lm_train_program(**CFG)
    return (jfluid.default_main_program(), jfluid.default_startup_program(),
            fluid.default_main_program(), fluid.default_startup_program(),
            cost)


def _feed(seed=0, batch=4):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, CFG["vocab"], (batch, CFG["max_len"]))
    return {"tokens": tokens.astype(np.int64),
            "labels": np.roll(tokens, -1, axis=1).astype(np.int64)}


def test_train_program_is_the_jax_program():
    """Same ops in the same order with the same inputs, outputs and
    attributes; same variables (names, shapes, dtypes, persistables):
    the two programs serialize to the same JSON."""
    jmain, jstart, pmain, pstart, _ = _build_both()
    jops = [op.type for op in jmain.global_block().ops]
    assert [op.type for op in pmain.global_block().ops] == jops
    assert jops.count("fused_attention") == CFG["n_layers"]
    assert jops.count("backward") == 1
    assert jops.count("adam") == len([p for p in pmain.all_parameters()
                                      if p.trainable])
    jparams = {p.name: p.shape for p in jmain.all_parameters()}
    assert {p.name: p.shape for p in pmain.all_parameters()} == jparams
    assert "pos_encoding_0.w_0" in jparams
    assert ({v.name for v in pmain.list_vars() if v.persistable}
            == {v.name for v in jmain.list_vars() if v.persistable})
    assert pmain.to_dict() == jmain.to_dict()
    assert pstart.to_dict() == jstart.to_dict()


def test_trainable_false_table_gets_no_gradient_and_no_update():
    _, _, pmain, _, _ = _build_both()
    block = pmain.global_block()
    (bwd,) = [op for op in block.ops if op.type == "backward"]
    assert "pos_encoding_0.w_0" not in bwd.desc.attrs["params"]
    assert not block.has_var("pos_encoding_0.w_0@GRAD")
    assert all(op.desc.inputs["Param"] != ["pos_encoding_0.w_0"]
               for op in block.ops if op.type == "adam")


def test_jax_built_program_runs_in_the_port():
    """The JAX package's JSON parses in the port and trains: one step of
    the parsed program equals one step of the port-built program from
    the same state."""
    jmain, jstart, pmain, pstart, cost = _build_both()
    main = Program.parse_from_string(jmain.serialize_to_string())
    start = Program.parse_from_string(jstart.serialize_to_string())
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(start)
    state = {n: t.clone() for n, t in fluid.global_scope()._vars.items()}
    (want,) = exe.run(main, feed=_feed(), fetch_list=[cost.name])
    for n, t in state.items():
        fluid.global_scope().set(n, t)
    (got,) = exe.run(pmain, feed=_feed(), fetch_list=[cost])
    assert np.isfinite(want) and got == want


def test_port_built_program_parses_in_jax():
    jmain, _, pmain, _, _ = _build_both()
    parsed = jfluid.Program.parse_from_string(pmain.serialize_to_string())
    got = [(op.type, op.desc.inputs, op.desc.outputs)
           for op in parsed.global_block().ops]
    want = [(op.type, op.desc.inputs, op.desc.outputs)
            for op in jmain.global_block().ops]
    assert got == want


def test_startup_values_match_by_value_or_distribution():
    """Constants and the sinusoid table equal the JAX package's exactly.
    Xavier-uniform fc weights lie in [-a, a], a = sqrt(6 / (fan_in +
    fan_out)), with standard deviation a / sqrt(3); embeddings are
    N(0, 1 / d_model).  The port's std must be within 10% of the
    analytic value (the smallest table has 96 elements: the estimate's
    own spread is ~7% there, 1.6% at 2048) and its mean within 4
    standard errors of 0."""
    jmain, jstart, pmain, pstart, _ = _build_both()
    jstart.random_seed = pstart.random_seed = 7
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(pstart)
    init = {op.desc.outputs["Out"][0]: op for op in
            pstart.global_block().ops}
    for name in init:
        want = np.asarray(jfluid.global_scope().get(name))
        got = fluid.global_scope().get(name)
        assert isinstance(got, torch.Tensor) and not got.requires_grad
        got = got.numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        op = init[name]
        if op.type in ("fill_constant", "assign_value"):
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        n = got.size
        if op.type == "uniform_random":
            a = op.desc.attrs["max"]
            assert -op.desc.attrs["min"] == a
            assert np.all(np.abs(got) <= a), name
            std = a / math.sqrt(3.0)
        else:
            assert op.type == "gaussian_random", name
            std = op.desc.attrs["std"]
            assert op.desc.attrs["mean"] == 0.0
        assert abs(got.std() / std - 1.0) < 0.1, (name, got.std(), std)
        assert abs(got.mean()) < 4 * std / math.sqrt(n), name
        assert not np.array_equal(got, want)     # a different generator


def test_random_streams_follow_seeds():
    """The executor's generator follows the startup program's
    random_seed; a nonzero seed attribute pins an op's own stream."""
    def run(seed):
        fluid.core.program.reset_default_programs()
        fluid.core.scope._global_scope = fluid.core.scope.Scope()
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        fluid.layers.fc(input=x, size=8)
        fluid.layers.fc(input=x, size=8, param_attr=fluid.ParamAttr(
            initializer=fluid.initializer.Uniform(-1.0, 1.0, seed=5)))
        start = fluid.default_startup_program()
        start.random_seed = seed
        fluid.Executor(fluid.CPUPlace()).run(start)
        scope = fluid.global_scope()
        return scope.get("fc_0.w_0").numpy(), scope.get("fc_1.w_0").numpy()
    (a0, a1), (b0, b1), (c0, c1) = run(1), run(1), run(2)
    np.testing.assert_array_equal(a0, b0)
    assert not np.array_equal(a0, c0)
    np.testing.assert_array_equal(a1, c1)


def test_executor_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fluid.Executor()
    with pytest.raises(RuntimeError, match="CUDA"):
        fluid.Executor(fluid.CUDAPlace(0))
    assert fluid.Executor(fluid.CPUPlace()).device == torch.device("cpu")


def test_scope_from_numpy_checks_names_and_shapes():
    _, _, pmain, _, _ = _build_both()
    arrays = {v.name: np.zeros(v.shape, np.float32)
              for v in pmain.list_vars()
              if v.persistable and not v.desc.is_data}
    scope = fluid.core.scope.Scope()
    pio.scope_from_numpy(scope, pmain, arrays, device="cpu")
    assert scope.get("fc_0.w_0.moment1_0").shape == (32, 96)
    missing = dict(arrays)
    del missing["learning_rate_0"]
    with pytest.raises(ValueError, match="learning_rate_0"):
        pio.scope_from_numpy(scope, pmain, missing, device="cpu")
    surplus = dict(arrays, extra_0=np.zeros(1, np.float32))
    with pytest.raises(ValueError, match="extra_0"):
        pio.scope_from_numpy(scope, pmain, surplus, device="cpu")
    bad = dict(arrays, **{"fc_0.w_0": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="fc_0.w_0"):
        pio.scope_from_numpy(scope, pmain, bad, device="cpu")


def test_dropout_rule():
    """Out = X * Mask with a {0, 1} mask keeping ~1 - p (the reference's
    unscaled training dropout); X * (1 - p) at test time; X at p = 0.
    Masks come from the executor's generator, so they are checked by
    their statistics."""
    x = fluid.layers.data(name="x", shape=[4096], dtype="float32")
    train = fluid.layers.dropout(x, dropout_prob=0.25)
    test = fluid.layers.dropout(x, dropout_prob=0.25, is_test=True)
    keep = fluid.layers.dropout(x, dropout_prob=0.0)
    mask = fluid.default_main_program().global_block().ops[0] \
        .desc.outputs["Mask"][0]
    xv = np.random.RandomState(0).rand(2, 4096).astype(np.float32) + 1.0
    out, m, t, k = fluid.Executor(fluid.CPUPlace()).run(
        feed={"x": xv}, fetch_list=[train, mask, test, keep])
    assert set(np.unique(m)) == {0.0, 1.0}
    assert abs(m.mean() - 0.75) < 0.02
    np.testing.assert_array_equal(out, xv * m)
    np.testing.assert_allclose(t, xv * 0.75, rtol=1e-6)
    np.testing.assert_array_equal(k, xv)
