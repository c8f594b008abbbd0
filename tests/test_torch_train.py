"""Training through the port's Fluid front end against the JAX package.

The JAX package runs the startup program and ``save_persistables``; the
port loads that state with ``io.load_persistables``.  Both then take the
same Adam steps on the same seeded numpy feeds, on the CPU.  The JAX side
runs its LayerNorm and loss-head Pallas kernels in interpret mode
(``FLAGS_fused_layernorm`` / ``FLAGS_fused_softmax_xent``, the idiom of
tests/test_pallas_kernels.py); its attention on the CPU is
``_reference_attention`` under ``jax.grad``.  The port runs its kernels'
plain versions through the same autograd Functions the card uses.

Tolerances, all f32 on both sides with sums in another order:
- loss of every step: 1e-5 relative;
- every ``@GRAD`` of step 1: 1e-5 x the largest |gradient| of that
  parameter;
- parameters after 3 steps: 1e-5 absolute, except where Adam divides a
  near-zero gradient by its own root mean square.  There m / sqrt(v) of
  a gradient that is rounding noise is O(1) of either sign, so the step
  is +-lr whichever way the noise fell.  Such an element is excused when
  the JAX gradient of some step was below 1e-3 x that parameter's
  largest |gradient|; it must still lie within 3 x lr (the most three
  steps can move it), and at most 1% of all elements may be excused.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import io as jio
from paddle_tpu.models import transformer as JT
import paddle_tpu_torch as fluid
from paddle_tpu_torch import io as pio
from paddle_tpu_torch.models import transformer as PT

CFG = dict(vocab=64, max_len=16, n_layers=2, d_model=32, n_heads=4, d_ff=64)
LR = 1e-3


@pytest.fixture(autouse=True)
def _fresh_port():
    fluid.core.program.reset_default_programs()
    fluid.core.scope._global_scope = fluid.core.scope.Scope()
    yield


def _feeds(n, batch=4, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tokens = rng.randint(0, CFG["vocab"], (batch, CFG["max_len"]))
        out.append({"tokens": tokens.astype(np.int64),
                    "labels": np.roll(tokens, -1, axis=1).astype(np.int64)})
    return out


def test_three_adam_steps_match_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("FLAGS_fused_layernorm", "interpret")
    monkeypatch.setenv("FLAGS_fused_softmax_xent", "interpret")
    _, _, jcost = JT.transformer_lm_train_program(**CFG, lr=LR)
    jmain = jfluid.default_main_program()
    jfluid.default_startup_program().random_seed = 3
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    jio.save_persistables(jexe, str(tmp_path), jmain)

    _, _, cost = PT.transformer_lm_train_program(**CFG, lr=LR)
    main = fluid.default_main_program()
    exe = fluid.Executor(fluid.CPUPlace())
    pio.load_persistables(exe, str(tmp_path), main)

    params = [p.name for p in main.all_parameters() if p.trainable]
    fetch = [cost.name] + [p + "@GRAD" for p in params]
    small = {p: np.zeros(main.global_block().var(p).shape, bool)
             for p in params}
    for step, feed in enumerate(_feeds(3)):
        want = jexe.run(jmain, feed=feed, fetch_list=fetch)
        got = exe.run(main, feed=feed, fetch_list=fetch)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        for p, g, w in zip(params, got[1:], want[1:]):
            w = np.asarray(w)
            top = float(np.abs(w).max())
            small[p] |= np.abs(w) < 1e-3 * top
            if step == 0:
                assert np.abs(g - w).max() <= 1e-5 * top, p
    excused = total = 0
    for p in params:
        want = np.asarray(jfluid.global_scope().get(p))
        got = fluid.global_scope().get(p).numpy()
        err = np.abs(got - want)
        assert err.max() <= 3 * LR, p
        assert np.all((err <= 1e-5) | small[p]), p
        excused += int(np.sum((err > 1e-5) & small[p]))
        total += err.size
    assert excused <= 0.01 * total, (excused, total)


def test_state_updates_in_place_and_leaves_plain():
    """Scope tensors keep their storage across steps and leave each step
    without autograd history; the trainable=False table never moves."""
    _, _, cost = PT.transformer_lm_train_program(**CFG)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    scope = fluid.global_scope()
    names = ["fc_0.w_0", "fc_0.w_0.moment1_0", "fc_0.w_0.beta1_pow_acc_0",
             "layer_norm_0.w_0", "embedding_0.w_0"]
    ptrs = {n: scope.get(n).data_ptr() for n in names}
    before = {n: scope.get(n).clone() for n in names}
    table = scope.get("pos_encoding_0.w_0").clone()
    for feed in _feeds(2):
        (loss,) = exe.run(feed=feed, fetch_list=[cost])
        assert isinstance(loss, np.ndarray) and np.isfinite(loss)
    for n in names:
        t = scope.get(n)
        assert t.data_ptr() == ptrs[n], n
        assert not t.requires_grad and t.grad_fn is None, n
        assert not torch.equal(t, before[n]), n
    assert torch.equal(scope.get("pos_encoding_0.w_0"), table)
    np.testing.assert_allclose(
        scope.get("fc_0.w_0.beta1_pow_acc_0").numpy(), [0.9 ** 3],
        rtol=1e-6)
    (t,) = exe.run(feed=_feeds(1)[0], fetch_list=["fc_0.w_0@GRAD"],
                   return_numpy=False)
    assert isinstance(t, torch.Tensor) and not t.requires_grad


def test_fetches_and_loaded_state_are_not_aliased():
    """A fetched parameter is a snapshot, and state put in the scope from
    numpy is a copy: in-place optimizer steps change neither."""
    _, _, cost = PT.transformer_lm_train_program(**CFG)
    main = fluid.default_main_program()
    exe = fluid.Executor(fluid.CPUPlace())
    arrays = {v.name: np.full(v.shape, 0.5, np.float32)
              for v in main.list_vars()
              if v.persistable and not v.desc.is_data}
    arrays["learning_rate_0"][:] = LR
    pio.scope_from_numpy(fluid.global_scope(), main, arrays, device="cpu")
    feed = _feeds(1)[0]
    (w,) = exe.run(feed=feed, fetch_list=["fc_0.w_0"])
    w0 = w.copy()
    exe.run(feed=feed, fetch_list=[cost])
    np.testing.assert_array_equal(w, w0)
    assert np.all(arrays["fc_0.w_0"] == 0.5)
    assert not np.array_equal(fluid.global_scope().get("fc_0.w_0").numpy(),
                              w0)


def test_copy_task_halves_the_loss_in_40_steps():
    """The JAX package's convergence check (tests/test_transformer.py):
    one fixed batch whose labels are the tokens shifted by one."""
    _, _, cost = PT.transformer_lm_train_program(**CFG, lr=3e-3)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    rng = np.random.RandomState(0)
    seqs = rng.randint(2, CFG["vocab"], (16, CFG["max_len"])).astype(np.int64)
    feed = {"tokens": seqs, "labels": np.roll(seqs, -1, axis=1)}
    losses = [float(exe.run(feed=feed, fetch_list=[cost])[0])
              for _ in range(40)]
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
