"""The sequence and beam op rules and their layers in the port against the
JAX package, on the CPU.

Twins of tests/test_sequence_ops.py and of test_beam_search.py's op-level
hand cases: each program is built by the same code with each package's
front end (equal JSON), the port loads the JAX startup's parameters, and
both run on the same numpy feed.  Outputs agree to 2e-5 x max(1, max
|ref|), integers exactly, and the @GRADs of a weighted-sum loss (each
package's ``calc_gradient``) to 2e-5 as well.  The rules' one-op
forward and @GRAD parity is test_torch_ops_dense.py's (its specs come
from tests/test_op_grad.py); this file holds the layers, the rules with
no gradient (``sequence_erase``, ``sequence_mask``, ``beam_search``,
``beam_search_decode``, ``beam_init_scores``) and ``beam_search``'s
order on exact ties (``lax.top_k``'s: the lower flat index first).
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import io as jio
from paddle_tpu import layers as jlayers
from paddle_tpu import nets as jnets
from paddle_tpu.core.backward import calc_gradient as jcalc
import paddle_tpu_torch as fluid
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import layers as players
from paddle_tpu_torch import nets as pnets
from paddle_tpu_torch.backward import calc_gradient as pcalc

JAX = (jfluid, jlayers, jnets, jcalc)
PORT = (fluid, players, pnets, pcalc)
TOL = 2e-5


@pytest.fixture(autouse=True)
def _fresh():
    jfluid.core.program.reset_default_programs()
    fluid.core.program.reset_default_programs()
    jfluid.global_scope().clear()
    fluid.core.scope._global_scope = fluid.core.scope.Scope()
    yield


def _close(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got.astype(np.float64) - want).max()) \
        if want.size else 0.0
    assert err <= TOL * scale, f"{name}: {err:.3e} > {TOL} x {scale:.3g}"


def _both(build, feed, tmp_path, grad_of=()):
    """``build(fluid, layers, nets)`` -> the fetch vars, in both packages;
    with ``grad_of`` (data var names) a weighted sum of the first fetch
    is differentiated with each package's calc_gradient.  Every fetch
    and @GRAD must agree; returns the port's."""
    outs = []
    for f, L, N, cg in (JAX, PORT):
        f.core.program.reset_default_programs()
        fetch = list(build(f, L, N))
        if grad_of:
            block = f.default_main_program().global_block()
            w = L.data(name="loss_w", shape=list(feed["loss_w"].shape),
                       dtype="float32", append_batch_size=False)
            w.stop_gradient = True
            loss = L.reduce_sum(L.elementwise_mul(fetch[0], w))
            fetch += cg(loss, [block.var(n) for n in grad_of])
        outs.append((f, fetch))
    assert (jfluid.default_main_program().to_dict()
            == fluid.default_main_program().to_dict())
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    jio.save_persistables(jexe, str(tmp_path), jfluid.default_main_program())
    exe = fluid.Executor(fluid.CPUPlace())
    pio.load_persistables(exe, str(tmp_path), fluid.default_main_program())
    want = jexe.run(jfluid.default_main_program(), feed=feed,
                    fetch_list=outs[0][1])
    got = exe.run(fluid.default_main_program(), feed=feed,
                  fetch_list=outs[1][1])
    for k, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"fetch {k}")
    return got


def _u(shape, seed, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# test_sequence_ops.py twins
# ---------------------------------------------------------------------------

def test_sequence_pool_masks_padding(tmp_path):
    def build(f, L, N):
        x = L.data(name="x", shape=[5, 3], dtype="float32", lod_level=1)
        return [L.sequence_pool(x, p) for p in ("sum", "last", "max")]
    data = np.arange(30, dtype=np.float32).reshape(2, 5, 3)
    s, last, m = _both(build, {"x": data,
                               "x@SEQ_LEN": np.array([2, 4], np.int32)},
                       tmp_path)
    np.testing.assert_allclose(s[1], data[1, :4].sum(0))
    np.testing.assert_allclose(last[0], data[0, 1])
    np.testing.assert_allclose(m[1], data[1, :4].max(0))


def test_sequence_softmax_normalizes_within_length(tmp_path):
    def build(f, L, N):
        x = L.data(name="x", shape=[4], dtype="float32", lod_level=1)
        return [L.sequence_softmax(x)]
    (sm,) = _both(build, {"x": _u((2, 4), 1, -2, 2),
                          "x@SEQ_LEN": np.array([2, 3], np.int32),
                          "loss_w": _u((2, 4), 2, 0.5, 1.5)},
                  tmp_path, grad_of=["x"])[:1]
    np.testing.assert_allclose(sm[0, :2].sum(), 1.0, rtol=1e-5)
    assert sm[0, 2:].sum() == 0.0


def test_dynamic_lstm_respects_lengths(tmp_path):
    h = 8

    def build(f, L, N):
        x = L.data(name="x", shape=[6, 4 * h], dtype="float32", lod_level=1)
        return L.dynamic_lstm(input=x, size=4 * h, use_peepholes=False)
    hid, _ = _both(build, {"x": _u((3, 6, 4 * h), 3, -0.1, 0.1),
                           "x@SEQ_LEN": np.array([2, 6, 4], np.int32),
                           "loss_w": _u((3, 6, h), 4, 0.5, 1.5)},
                   tmp_path, grad_of=["x"])[:2]
    np.testing.assert_allclose(hid[0, 2], hid[0, 5], rtol=1e-6)
    assert not np.allclose(hid[1, 2], hid[1, 5])


def test_dynamic_rnn_accumulator(tmp_path):
    def build(f, L, N):
        x = L.data(name="x", shape=[7, 3], dtype="float32", lod_level=1)
        rnn = L.DynamicRNN()
        with rnn.block():
            acc = rnn.memory(shape=[3], value=0.0)
            new = L.elementwise_add(acc, rnn.step_input(x))
            rnn.update_memory(acc, new)
            rnn.output(new)
        return [L.sequence_pool(rnn(), "last")]
    data = _u((2, 7, 3), 5)
    (res,) = _both(build, {"x": data,
                           "x@SEQ_LEN": np.array([3, 7], np.int32)},
                   tmp_path)
    np.testing.assert_allclose(res[0], data[0, :3].sum(0), rtol=1e-5)


# ---------------------------------------------------------------------------
# the sequence layers (layers/sequence.py, layers/nn.py, nets)
# ---------------------------------------------------------------------------

SEQ = _u((3, 5, 4), 10)
LENS = np.array([5, 2, 3], np.int32)


def _seq_data(L, name="x", width=4):
    return L.data(name=name, shape=[5, width], dtype="float32", lod_level=1)


LAYER_CASES = {
    "sequence_conv": (
        lambda f, L, N: [L.sequence_conv(_seq_data(L), num_filters=6,
                                         filter_size=3, act="tanh")],
        (3, 5, 6)),
    "sequence_conv_pool": (
        lambda f, L, N: [N.sequence_conv_pool(_seq_data(L), num_filters=6,
                                              filter_size=3)],
        (3, 6)),
    "sequence_expand": (
        lambda f, L, N: [L.sequence_expand(
            L.data(name="v", shape=[4], dtype="float32"), _seq_data(L))],
        (3, 5, 4)),
    "sequence_reshape": (
        lambda f, L, N: [L.sequence_reshape(_seq_data(L), new_dim=2)],
        (3, 10, 2)),
    "sequence_concat": (
        lambda f, L, N: [L.sequence_concat([_seq_data(L),
                                            _seq_data(L, "y")])],
        (3, 10, 4)),
    "sequence_first_step": (
        lambda f, L, N: [L.sequence_first_step(_seq_data(L))], (3, 4)),
    "sequence_last_step": (
        lambda f, L, N: [L.sequence_last_step(_seq_data(L))], (3, 4)),
    "sequence_reverse": (
        lambda f, L, N: [L.sequence_reverse(_seq_data(L))], (3, 5, 4)),
    "sequence_slice": (
        lambda f, L, N: [L.sequence_slice(
            _seq_data(L),
            L.data(name="off", shape=[1], dtype="int64"),
            L.data(name="len", shape=[1], dtype="int64"))], (3, 5, 4)),
    "row_conv": (
        lambda f, L, N: [L.row_conv(_seq_data(L), future_context_size=2,
                                    act="relu")], (3, 5, 4)),
    "im2sequence": (
        lambda f, L, N: [L.im2sequence(
            L.data(name="img", shape=[2, 5, 4], dtype="float32"),
            filter_size=2, stride=[1, 2], padding=[1, 0, 0, 1])],
        (3, 10, 8)),
    "lstm_unit": (
        lambda f, L, N: list(L.lstm_unit(
            L.data(name="v", shape=[4], dtype="float32"),
            L.data(name="c", shape=[1], dtype="float32"))), (3, 1)),
    "hsigmoid": (
        lambda f, L, N: [L.hsigmoid(
            L.data(name="v", shape=[4], dtype="float32"),
            L.data(name="lab", shape=[1], dtype="int64"), num_classes=7)],
        (3, 1)),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_sequence_layer_matches_jax(case, tmp_path):
    build, out_shape = LAYER_CASES[case]
    feed = {"x": SEQ, "x@SEQ_LEN": LENS, "y": _u((3, 5, 4), 11),
            "y@SEQ_LEN": np.array([1, 5, 4], np.int32),
            "v": _u((3, 4), 12), "c": _u((3, 1), 13),
            "off": np.array([[1], [0], [2]], np.int64),
            "len": np.array([[3], [2], [1]], np.int64),
            "img": _u((3, 2, 5, 4), 14),
            "lab": np.array([[0], [6], [3]], np.int64),
            "loss_w": _u(out_shape, 15, 0.5, 1.5)}
    probe = []
    for f, L, N, cg in (PORT,):
        f.core.program.reset_default_programs()
        build(f, L, N)
        probe = [v for v in ("x", "y", "v", "c", "img")
                 if f.default_main_program().global_block().has_var(v)]
    got = _both(build, feed, tmp_path, grad_of=probe)
    assert got[0].shape == out_shape


@pytest.mark.parametrize("tokens", [[0], [2, 7]])
def test_sequence_erase_and_mask(tokens, tmp_path):
    def build(f, L, N):
        x = L.data(name="ids", shape=[1], dtype="int64", lod_level=1)
        helper = f.layer_helper.LayerHelper("sequence_erase", input=x)
        out = helper.create_variable_for_type_inference("int64")
        helper.append_op(type="sequence_erase", inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs={"tokens": tokens})
        return [out, L.sequence_mask_like(out), L.sequence_mask_like(x)]
    ids = np.array([[2, 0, 7, 7, 5, 0], [0, 0, 3, 2, 9, 9]], np.int64)
    out, m_out, m_in = _both(build, {"ids": ids,
                                     "ids@SEQ_LEN": np.array([5, 6],
                                                             np.int32)},
                             tmp_path)
    keep0 = [t for t in ids[0, :5] if t not in tokens]
    np.testing.assert_array_equal(out[0, :len(keep0)], keep0)
    assert m_out[0].sum() == len(keep0) and m_in[0].sum() == 5


def test_dynamic_rnn_lstm_trains(tmp_path):
    """The DynamicRNN LSTM cell of test_sequence_ops.py, 8 Adam steps in
    both packages from the same state: losses step for step."""
    hid = 16

    def build(f, L, N):
        data = L.data(name="words", shape=[32], dtype="int64", lod_level=1)
        label = L.data(name="label", shape=[1], dtype="int64")
        proj = L.fc(input=L.embedding(input=data, size=[200, hid]),
                    size=hid, num_flatten_dims=2, act="tanh")
        rnn = L.DynamicRNN()
        with rnn.block():
            word = rnn.step_input(proj)
            prev_h = rnn.memory(shape=[hid], value=0.0)
            prev_c = rnn.memory(shape=[hid], value=0.0)

            def gate(ipt, h):
                return L.sums(input=[L.fc(input=ipt, size=hid),
                                     L.fc(input=h, size=hid,
                                          bias_attr=False)])
            fg, ig, og = (L.sigmoid(gate(word, prev_h)) for _ in range(3))
            c = L.sums(input=[L.elementwise_mul(fg, prev_c),
                              L.elementwise_mul(ig, L.tanh(gate(word,
                                                                prev_h)))])
            h = L.elementwise_mul(og, L.tanh(c))
            rnn.update_memory(prev_h, h)
            rnn.update_memory(prev_c, c)
            rnn.output(h)
        logit = L.fc(input=L.sequence_pool(rnn(), "last"), size=2,
                     act="softmax")
        loss = L.mean(L.cross_entropy(input=logit, label=label))
        f.optimizer.Adam(learning_rate=0.01).minimize(loss)
        return [loss]
    runs = []
    for f, L, N, cg in (JAX, PORT):
        f.core.program.reset_default_programs()
        runs.append((f, build(f, L, N)[0]))
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    jio.save_persistables(jexe, str(tmp_path), jfluid.default_main_program())
    exe = fluid.Executor(fluid.CPUPlace())
    pio.load_persistables(exe, str(tmp_path), fluid.default_main_program())
    rng = np.random.RandomState(0)
    losses = ([], [])
    for _ in range(8):
        lens = rng.randint(4, 30, 16).astype(np.int32)
        feed = {"words": rng.randint(10, 200, (16, 32)).astype(np.int64),
                "words@SEQ_LEN": lens,
                "label": rng.randint(0, 2, (16, 1)).astype(np.int64)}
        for k, (f, exe_k) in enumerate(((jfluid, jexe), (fluid, exe))):
            (loss,) = exe_k.run(f.default_main_program(), feed=feed,
                                fetch_list=[runs[k][1]])
            losses[k].append(float(np.asarray(loss).reshape(-1)[0]))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)


# ---------------------------------------------------------------------------
# test_beam_search.py's op-level hand cases, and exact ties
# ---------------------------------------------------------------------------

def _beam_step(pre, probs, fin, beam, end_id, tmp_path):
    def build(f, L, N):
        v = probs.shape[1]
        ps = L.data(name="ps", shape=[1], dtype="float32")
        pr = L.data(name="pr", shape=[v], dtype="float32")
        fn = L.data(name="fin", shape=[1], dtype="float32")
        return L.beam_search(ps, pr, fn, beam_size=beam, end_id=end_id)
    return _both(build, {"ps": pre, "pr": probs, "fin": fin}, tmp_path)


def test_beam_search_step_hand_case(tmp_path):
    pr = np.array([[0.1, 0.2, 0.6, 0.1], [0.25, 0.25, 0.25, 0.25]],
                  np.float32)
    i, s, p, f = _beam_step(np.array([[0.0], [-1e9]], np.float32), pr,
                            np.zeros((2, 1), np.float32), 2, 3, tmp_path)
    assert list(p.reshape(-1)) == [0, 0]
    assert list(i.reshape(-1)) == [2, 1]
    np.testing.assert_allclose(s.reshape(-1), [np.log(0.6), np.log(0.2)],
                               rtol=1e-5)
    assert list(f.reshape(-1)) == [0.0, 0.0]


def test_beam_search_finished_propagates_end(tmp_path):
    i, s, p, f = _beam_step(np.array([[-0.5], [-0.6]], np.float32),
                            np.full((2, 4), 0.25, np.float32),
                            np.array([[1.0], [0.0]], np.float32), 2, 3,
                            tmp_path)
    row = list(p.reshape(-1)).index(0)
    assert i.reshape(-1)[row] == 3 and f.reshape(-1)[row] == 1.0
    np.testing.assert_allclose(s.reshape(-1)[row], -0.5, rtol=1e-6)


def test_beam_search_exact_ties_take_the_lower_index(tmp_path):
    """Every score ties: uniform probabilities on two live beams of equal
    score, a third beam at -1e9 (beam_init_scores), a finished beam
    forced to end_id, and probabilities clamped at 1e-20.  The port
    keeps lax.top_k's order: the lowest flat index (parent beam * V +
    token) first."""
    v, beam = 5, 3
    probs = np.full((2 * beam, v), 0.2, np.float32)
    probs[3:, :2] = 0.0                        # clamp to 1e-20: tied
    pre = np.array([[0.0], [0.0], [-1e9],      # sample 0: two tied beams
                    [-0.5], [-0.5], [-0.5]], np.float32)
    fin = np.array([[0.0], [0.0], [0.0], [1.0], [0.0], [0.0]], np.float32)
    i, s, p, f = _beam_step(pre, probs, fin, beam, 4, tmp_path)
    # sample 0: beam 0 tokens 0, 1, 2 (flat 0, 1, 2) before beam 1's
    assert list(p.reshape(-1)[:3]) == [0, 0, 0]
    assert list(i.reshape(-1)[:3]) == [0, 1, 2]
    # sample 1: finished beam 3 keeps its score at end_id 4 (flat 4);
    # then beam 4's tokens 2, 3 (flat 7, 8): ties with beam 5's
    assert list(p.reshape(-1)[3:]) == [3, 4, 4]
    assert list(i.reshape(-1)[3:]) == [4, 2, 3]
    assert list(f.reshape(-1)) == [0, 0, 0, 1, 0, 0]


def test_beam_search_decode_backtraces_and_trims(tmp_path):
    """beam_search_decode over hand-built steps: each sentence follows its
    parents back; num_results keeps each sample's best rows."""
    ids = np.array([[[1], [5], [7]], [[2], [6], [8]],
                    [[3], [4], [9]], [[1], [2], [3]]], np.int64)
    parents = np.array([[0, 1, 0], [1, 0, 1], [2, 3, 3], [3, 2, 2]],
                       np.int32)
    scores = _u((4, 1), 20)

    def build(f, L, N):
        ii = L.data(name="ids", shape=[3, 1], dtype="int64")
        pp = L.data(name="par", shape=[3], dtype="int32")
        ss = L.data(name="sc", shape=[1], dtype="float32")
        full = L.beam_search_decode(ii, pp, ss, beam_size=2, end_id=1)
        best = L.beam_search_decode(ii, pp, ss, beam_size=2, end_id=1,
                                    num_results=1)
        init = L.beam_init_scores(ss, 2)
        rep = L.repeat_batch(ss, 3)
        return list(full) + list(best) + [init, rep]
    sent, sc, sent1, sc1, init, rep = _both(
        build, {"ids": ids, "par": parents, "sc": scores}, tmp_path)
    # row 0: step 2 token 7 from row 0, step 1 token 5 from row 1,
    # step 0 token 2
    np.testing.assert_array_equal(sent[0], [2, 5, 7])
    np.testing.assert_array_equal(sent1, sent[[0, 2]])
    np.testing.assert_allclose(init.reshape(-1), [0, -1e9, 0, -1e9])
    np.testing.assert_allclose(rep.reshape(-1), np.repeat(scores, 3))


# ---------------------------------------------------------------------------
# the rules at a second shape (test_torch_ops_dense.py's harness: a one-op
# program built by the JAX front end, forward and @GRAD parity)
# ---------------------------------------------------------------------------

def _second_shape_specs():
    from test_op_grad import Spec
    rng = np.random.RandomState(30)

    def u(*shape):
        return rng.uniform(-1, 1, shape).astype(np.float32)
    seq = u(3, 6, 2)
    sl = {"X": [6, 1, 4]}
    return [
        Spec("sequence_first_step", {"X": seq}, seq_len=sl),
        Spec("sequence_last_step", {"X": seq}, seq_len=sl),
        Spec("sequence_softmax", {"X": u(3, 6, 1)}, seq_len=sl),
        Spec("sequence_conv", {"X": seq, "Filter": u(10, 3)},
             attrs={"contextLength": 5, "contextStart": -3,
                    "contextStride": 1}, seq_len=sl),
        Spec("sequence_expand", {"X": u(3, 2), "Y": u(3, 6, 2)},
             nodiff=("Y",), seq_len={"Y": [6, 1, 4]}),
        Spec("sequence_reshape", {"X": u(3, 6, 4)}, attrs={"new_dim": 8},
             seq_len={"X": [6, 2, 4]}),
        Spec("sequence_concat", {"X": [seq, u(3, 2, 2), u(3, 3, 2)]},
             seq_len=sl),
        Spec("sequence_pad", {"X": seq}, outs=("Out", "Length"),
             loss_outs=("Out",), seq_len=sl),
        Spec("sequence_unpad", {"X": seq,
                                "Length": np.array([6, 1, 4], np.int64)}),
        Spec("sequence_slice", {"X": seq,
                                "Offset": np.array([[0], [0], [3]], np.int64),
                                "Length": np.array([[6], [1], [1]],
                                                   np.int64)}, seq_len=sl),
        Spec("sequence_reverse", {"X": seq}, outs=("Y",)),
        Spec("sequence_reverse", {"X": seq}, outs=("Y",), seq_len=sl),
        Spec("lstm_unit", {"X": u(3, 8), "C_prev": u(3, 2)},
             attrs={"forget_bias": 1.0}, outs=("C", "H")),
        Spec("row_conv", {"X": seq, "Filter": u(4, 2)}, seq_len=sl),
        Spec("im2sequence", {"X": u(2, 1, 5, 5)},
             attrs={"kernels": [3, 2], "strides": [2, 1],
                    "paddings": [0, 1, 1, 0]}),
        Spec("lod_reset", {"X": seq, "Y": np.array([2, 1, 3], np.int32)},
             nodiff=("Y",)),
        Spec("repeat_batch", {"X": seq}, attrs={"times": 3}, seq_len=sl),
        Spec("shrink_rnn_memory", {"X": u(3, 2),
                                   "I": np.array([1], np.int64),
                                   "RankTable": np.array([0, 2, 1],
                                                         np.int32)},
             nodiff=("RankTable",), seq_len={"RankTable": [6, 1, 4]}),
        Spec("hsigmoid", {"X": u(5, 3), "W": u(12, 3), "Bias": u(12, 1),
                          "Label": np.arange(5, dtype=np.int64)[:, None] * 3},
             attrs={"num_classes": 13}),
        Spec("linear_chain_crf",
             {"Emission": u(3, 4, 3), "Transition": u(5, 3),
              "Label": rng.randint(0, 3, (3, 4)).astype(np.int64)},
             outs=("Alpha", "EmissionExps", "TransitionExps",
                   "LogLikelihood"), loss_outs=("LogLikelihood",),
             seq_len={"Emission": [4, 1, 3]}),
        Spec("warpctc", {"Logits": u(3, 6, 4),
                         "Label": rng.randint(1, 4, (3, 3)).astype(np.int64)},
             attrs={"blank": 0, "norm_by_times": True},
             outs=("Loss", "WarpCTCGrad"), loss_outs=("Loss",),
             seq_len={"Logits": [6, 4, 5], "Label": [3, 1, 2]}),
    ]


SECOND = _second_shape_specs()


@pytest.mark.parametrize("spec", SECOND,
                         ids=[f"{s.op}#{i}" for i, s in enumerate(SECOND)])
def test_rule_at_a_second_shape(spec):
    from test_torch_ops_dense import (GRAD_TOL, OUT_TOL, _assert_close,
                                      _build_spec, _port_run)
    prog, feed, outs, grads, fetch, ref = _build_spec(spec)
    got = _port_run(prog, feed, fetch)
    for name, g, w in zip(fetch, got, ref):
        _assert_close(f"{spec.op} {name}", g, w,
                      GRAD_TOL if name in grads else OUT_TOL)


@pytest.mark.parametrize("beam,v,seed", [(2, 7, 0), (3, 5, 1), (4, 11, 2),
                                         (3, 30, 3), (1, 9, 4)])
def test_beam_search_random_steps_match_jax(beam, v, seed, tmp_path):
    """Random pruning steps (three samples, some beams finished, one beam
    at -1e9): every output of the port's step is the JAX step's."""
    rng = np.random.RandomState(seed)
    bb = 3 * beam
    probs = rng.dirichlet(np.ones(v), size=bb).astype(np.float32)
    pre = rng.uniform(-4, 0, (bb, 1)).astype(np.float32)
    pre[beam - 1] = -1e9
    fin = (rng.rand(bb, 1) < 0.3).astype(np.float32)
    _beam_step(pre, probs, fin, beam, v - 1, tmp_path)
