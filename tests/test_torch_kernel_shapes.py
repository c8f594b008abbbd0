"""The port's kernels at the shapes the JAX package serves beyond the
kernels' first codes, on the CPU: the flash forward and backward and the
paged decode kernel at head dims 8 to 128, the map from a head dim to its
compiled code, the recurrent kernels' choice between their persistent and
stepwise paths, a one-layer LM with heads of 128 and the ``dynamic_lstm``
and ``dynamic_gru`` rules at H 256, each against the JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version (the CUDA
kernels are held against those same plain versions on the card by
chip_smoke.py); the JAX side runs its Pallas kernels in interpret mode.
Inputs are made with numpy from fixed seeds and handed to both packages.

Tolerances are tests/test_torch_kernels.py's (max abs error): f32 2e-5,
the same f32 math summed in another order; bf16 2e-2, outputs rounded to
bf16 at slightly different places; gradients times max(1, max |want|).
The LM and the programs: 1e-5 x the largest |value| (f32, sums in
another order), as tests/test_torch_train.py and
tests/test_torch_sequence.py hold them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import transformer as JT
from paddle_tpu.ops.pallas_kernels import (_flash_backward, _flash_forward,
                                           paged_attention_pallas)
import paddle_tpu_torch as fluid
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.ops import kernels as K

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: head dims off the first codes: 8 and 80 run a wider code, 16 and 128
#: are codes of their own
FLASH_DIMS = (8, 16, 80, 128)
PAGED_DIMS = (8, 80, 128)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    for pkg in (jfluid, fluid):
        pkg.core.program.reset_default_programs()
        pkg.core.scope._global_scope = pkg.core.scope.Scope()
    yield


def _pair(a, dtype):
    """numpy f32 array -> (jax array, torch tensor), both in ``dtype``."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(a, b, tol, rel=False):
    a, b = _np(a), _np(b)
    if rel:
        tol = tol * max(1.0, float(np.max(np.abs(b[np.isfinite(b)]),
                                          initial=0.0)))
    assert a.shape == b.shape
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin)
    assert np.array_equal(a[~fin], b[~fin])        # same infinities
    err = float(np.max(np.abs(a[fin] - b[fin]))) if fin.any() else 0.0
    assert err <= tol, err


# ---------------------------------------------------------------------------
# the head-dim codes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", range(1, 137))
def test_head_dim_code(d):
    """Every multiple of 8 from 8 to 128 runs the least of the codes 16,
    32, 64, 128 at or above it; any other head dim raises."""
    if d % 8 or d > 128:
        with pytest.raises(ValueError, match="multiple of 8"):
            K.head_dim_code(d)
        return
    want = 16 if d <= 16 else 32 if d <= 32 else 64 if d <= 64 else 128
    assert K.head_dim_code(d) == want
    assert want in K.HEAD_DIM_CODES


def test_head_dim_paths_are_the_codes():
    """The attention kernels count their launches by code."""
    for kern in (K.FLASH_ATTENTION_FWD, K.FLASH_ATTENTION_BWD,
                 K.PAGED_ATTENTION):
        assert tuple(kern.path_launches) == ("d16", "d32", "d64", "d128")


# ---------------------------------------------------------------------------
# FlashAttention at every head dim
# ---------------------------------------------------------------------------

def _flash_inputs(d, tq, tk, dtype, seed):
    rng = np.random.RandomState(seed)
    b, h = 2, 2
    arrays = [rng.randn(b, h, t, d).astype(np.float32)
              for t in (tq, tk, tk, tq)]
    return [_pair(a, dtype) for a in arrays], (b, h)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", FLASH_DIMS)
def test_flash_forward_head_dims_match_pallas(d, causal, dtype):
    """Ragged lengths at each head dim: 13 queries over 21 keys (the
    Pallas kernel takes them as one block each; the card's kernels mask
    the edge of their 64-row tiles)."""
    tq, tk = 13, 21
    ((jq, q), (jk, k), (jv, v), _), (b, h) = _flash_inputs(d, tq, tk, dtype,
                                                           d)
    want_out, want_lse = _flash_forward(jq, jk, jv, causal, tq, tk,
                                        interpret=True)
    got_out, got_lse = K.flash_attention_fwd(q, k, v, causal)
    assert got_out.shape == (b, h, tq, d) and got_out.dtype == q.dtype
    _close(got_out, want_out, TOL[dtype])
    _close(got_lse, np.asarray(want_lse).reshape(b, h, tq),
           2e-5 if dtype == "float32" else 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", FLASH_DIMS)
def test_flash_backward_head_dims_match_pallas(d, causal, dtype):
    """Ragged lengths, 21 queries over 13 keys as one block each
    (causal: the top rows see no key and get p = 0), both passes from the
    JAX forward's out and lse."""
    tq, tk = 21, 13
    ((jq, q), (jk, k), (jv, v), (jg, g)), (b, h) = _flash_inputs(
        d, tq, tk, dtype, 100 + d)
    jout, jlse = _flash_forward(jq, jk, jv, causal, tq, tk, interpret=True)
    want = _flash_backward(jq, jk, jv, jout, jlse, jg, causal, tq, tk,
                           interpret=True)
    out = torch.from_numpy(np.array(_np(jout))).to(q.dtype)
    lse = torch.from_numpy(np.array(jlse).reshape(b, h, tq))
    got = K.flash_attention_bwd(q, k, v, out, lse, g, causal)
    for gt, wt in zip(got, want):
        assert gt.dtype == q.dtype
        _close(gt, wt, TOL[dtype], rel=True)


# ---------------------------------------------------------------------------
# paged decode attention at every head dim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", PAGED_DIMS)
def test_paged_attention_head_dims_match_pallas(d, dtype):
    """Four slots over pages of 4 positions: full, ragged, idle (the
    sentinel row, index 0) and one ragged with sentinel tail pages."""
    rng = np.random.RandomState(d)
    s, h, block_len, pages = 4, 3, 4, 3
    n = s * pages
    q = rng.randn(s, h, 1, d).astype(np.float32)
    pk = rng.randn(n, block_len, h, d).astype(np.float32)
    pv = rng.randn(n, block_len, h, d).astype(np.float32)
    cap = pages * block_len
    index = np.array([cap - 1, cap // 2 + 1, 0, block_len - 2], np.int32)
    table = np.full((s, pages), n, np.int32)
    perm = rng.permutation(n).astype(np.int32)
    for i in (0, 1, 3):
        need = index[i] // block_len + 1
        table[i, :need] = perm[i * pages:i * pages + need]
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(pk, dtype)
    jv, tv = _pair(pv, dtype)
    want = paged_attention_pallas(jq, jk, jv, jnp.asarray(table),
                                  jnp.asarray(index), interpret=True)
    got = K.paged_attention(tq, tk, tv, torch.from_numpy(table),
                            torch.from_numpy(index))
    assert got.shape == (s, h, 1, d) and got.dtype == tq.dtype
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("d", PAGED_DIMS)
def test_paged_geometry_of_a_code(d):
    """The wrapper sizes the split kernel by the code: lanes a head and
    the scratch row are the code's, whatever the true head dim."""
    code = K.head_dim_code(d)
    split, n_splits, hpb, floats = K.paged_geometry(16, 16, code, 128, 16, 2)
    assert floats == 16 * n_splits * 16 * (code + 2)
    # a lane holds at most 4 16-byte chunks of a position's row
    assert hpb * code * 2 // 16 <= 32 * 4


# ---------------------------------------------------------------------------
# the recurrent kernels' paths
# ---------------------------------------------------------------------------
#
# Hand reckoning on the H100 (132 SMs, 227 KB = 232448 bytes a block): a
# persistent grid takes one block an SM, so at most 132 blocks; above 528
# hidden units a block owns 8 units (the GRU forward 8 at every H), so H
# reaches 132 x 8 = 1056 as long as a block's shared memory fits.  It does
# at B 32 and 128: the tightest block, the LSTM forward with an f32 w at
# B 128, holds w's 32 gate columns of 1060 f32 (135680 bytes), 16 staged
# rows of h (67840), 8 warps' [16 x 36] partial tiles, x and mask of 16
# rows and the units' h and c (28736): 232256 bytes, 192 under the limit.
# At 1064 units the grid needs 133 blocks: stepwise from there on.

@pytest.mark.parametrize("b", [32, 128])
@pytest.mark.parametrize("w_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_recurrent_path_largest_persistent_width(kind, direction, w_bf16,
                                                 b):
    persistent = [h for h in range(8, 4097, 8)
                  if K.recurrent_path(kind, direction, h, b,
                                      w_bf16) == "persistent"]
    assert max(persistent) == 132 * 8
    # and every narrower width is persistent too
    assert persistent == list(range(8, 132 * 8 + 1, 8))
    assert K.recurrent_path(kind, direction, 2048, b, w_bf16) == "stepwise"


def test_recurrent_path_tightest_block():
    """The LSTM forward's f32 block at H 1056 B 128 is 192 bytes under
    the H100's limit (the reckoning above): one card with 192 bytes less
    a block runs it stepwise, and a card with 131 SMs also."""
    assert K._fwd_smem("lstm", 1056, 128, 8, 4, K.H100_SMEM_OPTIN) == 232256
    assert K.recurrent_path("lstm", "fwd", 1056, 128, False,
                            smem_optin=232255) == "stepwise"
    assert K.recurrent_path("lstm", "fwd", 1056, 32, False,
                            sms=131) == "stepwise"
    assert K.recurrent_path("lstm", "fwd", 1048, 32, False,
                            sms=131) == "persistent"


def test_recurrent_wrappers_take_a_forced_path_only_by_name():
    """``path=`` is an internal override: a name outside the two raises
    before anything else is looked at (on the card; the CPU runs the plain
    version whatever the path)."""
    xs = torch.zeros(2, 3, 8)
    w = torch.zeros(2, 8)
    h0 = torch.zeros(3, 2)
    mask = torch.ones(2, 3, 1)
    hs, _ = K.lstm_fwd(xs, w, h0, h0, mask, path="stepwise")
    assert hs.shape == (2, 3, 2)
    with pytest.raises(ValueError, match="path"):
        K._rnn_path(K.LSTM_FWD, xs, 2, 3, False, "resident")
    assert K.RECURRENT_PATHS == ("persistent", "stepwise")
    for kern in (K.LSTM_FWD, K.LSTM_BWD, K.GRU_FWD, K.GRU_BWD):
        assert tuple(kern.path_launches) == K.RECURRENT_PATHS


# ---------------------------------------------------------------------------
# a one-layer LM with two heads of 128
# ---------------------------------------------------------------------------

LM = dict(vocab=64, max_len=16, n_layers=1, d_model=256, n_heads=2, d_ff=64)


def _lm_step(fl, T, feed, state=None):
    """The LM's logits and loss and every parameter's @GRAD of one step,
    built by package ``fl`` with model module ``T`` (the state of the JAX
    build handed to the port)."""
    tokens = fl.layers.data(name="tokens", shape=[LM["max_len"]],
                            dtype="int64")
    labels = fl.layers.data(name="labels", shape=[LM["max_len"]],
                            dtype="int64")
    logits = T.transformer_lm_logits(tokens, **LM)
    labels3 = fl.layers.reshape(labels, shape=[-1, LM["max_len"], 1])
    cost = fl.layers.mean(fl.layers.softmax_with_cross_entropy(
        logits=logits, label=labels3))
    fl.append_backward(cost)
    main = fl.default_main_program()
    fl.default_startup_program().random_seed = 5
    exe = fl.Executor(fl.CPUPlace())
    exe.run(fl.default_startup_program())
    params = sorted(p.name for p in main.all_parameters())
    if state is not None:
        for n in params:
            fl.global_scope().set(n, torch.from_numpy(state[n]))
    grads = [p.name + "@GRAD" for p in main.all_parameters() if p.trainable]
    got = exe.run(main, feed=feed,
                  fetch_list=[logits.name, cost.name] + sorted(grads))
    return dict(zip(["logits", "loss"] + sorted(grads), got)), {
        n: np.array(fl.global_scope().get(n)) for n in params}


def test_lm_with_heads_of_128_matches_jax(monkeypatch):
    """d_model 256 over 2 heads: the port's attention runs the flash
    Function at head dim 128 (its plain versions on the CPU), the JAX
    package its reference attention; logits, loss and every gradient."""
    monkeypatch.setenv("FLAGS_fused_layernorm", "interpret")
    monkeypatch.setenv("FLAGS_fused_softmax_xent", "interpret")
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, LM["vocab"], (3, LM["max_len"]))
    feed = {"tokens": tokens.astype(np.int64),
            "labels": np.roll(tokens, -1, axis=1).astype(np.int64)}
    want, state = _lm_step(jfluid, JT, feed)
    got, _ = _lm_step(fluid, PT, feed, state)
    assert got["logits"].shape == (3, LM["max_len"], LM["vocab"])
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w, np.float64)
        err = float(np.abs(np.asarray(got[name], np.float64) - w).max())
        assert err <= 1e-5 * max(1.0, float(np.abs(w).max())), (name, err)


# ---------------------------------------------------------------------------
# dynamic_lstm and dynamic_gru at H 256
# ---------------------------------------------------------------------------

RT, RB, RH = 5, 8, 256
LENS = np.array([5, 3, 5, 1, 4, 5, 2, 5], np.int32)


def _rnn_step(fl, build, feed, state=None):
    """``build(layers) -> (outputs, loss)`` in package ``fl``: the
    outputs and every parameter's @GRAD of one step (the state of the JAX
    build handed to the port)."""
    outs, loss = build(fl.layers)
    fl.append_backward(loss)
    main = fl.default_main_program()
    fl.default_startup_program().random_seed = 3
    exe = fl.Executor(fl.CPUPlace())
    exe.run(fl.default_startup_program())
    params = sorted(p.name for p in main.all_parameters())
    if state is not None:
        for n in params:
            fl.global_scope().set(n, torch.from_numpy(state[n]))
    fetch = [o.name for o in outs] + [p + "@GRAD" for p in params]
    return exe.run(main, feed=feed, fetch_list=fetch), {
        n: np.array(fl.global_scope().get(n)) for n in params}


def _compare_rnn(build, width):
    rng = np.random.RandomState(width)
    feed = {"x": rng.randn(RB, RT, width).astype(np.float32) * 0.5,
            "x@SEQ_LEN": LENS}
    want, state = _rnn_step(jfluid, build, feed)
    got, _ = _rnn_step(fluid, build, feed, state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        err = float(np.abs(np.asarray(g, np.float64) - w).max())
        assert err <= 1e-5 * max(1.0, float(np.abs(w).max())), err


def _x(layers, width):
    return layers.data(name="x", shape=[RT, width], dtype="float32",
                       lod_level=1)


@pytest.mark.parametrize("is_reverse", [False, True])
def test_dynamic_lstm_h256_matches_jax(is_reverse):
    def build(layers):
        hidden, cell = layers.dynamic_lstm(
            input=_x(layers, 4 * RH), size=4 * RH, use_peepholes=False,
            is_reverse=is_reverse)
        return (hidden, cell), layers.mean(hidden)
    _compare_rnn(build, 4 * RH)


@pytest.mark.parametrize("is_reverse", [False, True])
def test_dynamic_gru_h256_matches_jax(is_reverse):
    def build(layers):
        hidden = layers.dynamic_gru(input=_x(layers, 3 * RH), size=RH,
                                    is_reverse=is_reverse)
        return (hidden,), layers.mean(hidden)
    _compare_rnn(build, 3 * RH)
