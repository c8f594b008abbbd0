"""The structured-prediction rules (CRF, CTC, edit distance, chunk_eval,
NCE, hsigmoid), cross_entropy_over_beam and the debug/array bookkeeping
rules in the port against the JAX package, on the CPU.

Twins of tests/test_structured_ops.py (brute-force CRF and Viterbi
oracles, edit distance, CTC with the greedy decoder, chunk_eval) and of
tests/test_cross_entropy_over_beam.py (the hand-computed costs of the
numpy core, now the port's copy, and a finite-difference check of the
port's autograd Function): each program is built by the same code with
each package's front end (equal JSON), the port loads the JAX startup's
parameters, and the fetches agree to 2e-5 x max(1, max |ref|), integers
exactly.  ``nce`` draws its negatives from torch's generator, which
never matches threefry: its cost is held to the JAX formula on the
samples the port drew (read back through ``SampleLabels``), its draws by
their frequencies, and its gradient by central differences with the
generator reseeded.
"""
import itertools

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import io as jio
from paddle_tpu import layers as jlayers
from paddle_tpu.core.backward import calc_gradient as jcalc
from paddle_tpu.ops.beam_ops import _beam_training_cost
import paddle_tpu_torch as fluid
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import layers as players
from paddle_tpu_torch.backward import calc_gradient as pcalc
from paddle_tpu_torch.ops.beam_ops import BeamTrainingCost, _ceob_batch

JAX = (jfluid, jlayers, jcalc)
PORT = (fluid, players, pcalc)
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
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= TOL * scale, f"{name}: {err:.3e} > {TOL} x {scale:.3g}"


def _both(build, feed, tmp_path, grad_of=()):
    """Build with both front ends (equal programs), the JAX startup's state
    in the port; with ``grad_of`` the first fetch's sum is differentiated
    by each package's calc_gradient.  Fetches must agree -> the port's."""
    fetches = []
    for f, L, cg in (JAX, PORT):
        f.core.program.reset_default_programs()
        fetch = list(build(f, L))
        if grad_of:
            block = f.default_main_program().global_block()
            fetch += cg(L.reduce_sum(fetch[0]),
                        [block.var(n) for n in grad_of])
        fetches.append(fetch)
    assert (jfluid.default_main_program().to_dict()
            == fluid.default_main_program().to_dict())
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    jio.save_persistables(jexe, str(tmp_path), jfluid.default_main_program())
    exe = fluid.Executor(fluid.CPUPlace())
    pio.load_persistables(exe, str(tmp_path), fluid.default_main_program())
    want = jexe.run(jfluid.default_main_program(), feed=feed,
                    fetch_list=fetches[0])
    got = exe.run(fluid.default_main_program(), feed=feed,
                  fetch_list=fetches[1])
    for k, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"fetch {k}")
    return got


def _crf_attr(f, transition, name):
    return f.ParamAttr(name=name, initializer=f.initializer
                       .NumpyArrayInitializer(transition))


def _path_score(emission, path, transition):
    start, end, trans = transition[0], transition[1], transition[2:]
    s = start[path[0]] + end[path[-1]]
    s += sum(emission[t, path[t]] for t in range(len(path)))
    return s + sum(trans[path[t], path[t + 1]]
                   for t in range(len(path) - 1))


# ---------------------------------------------------------------------------
# test_structured_ops.py twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lens", [None, [3, 2]], ids=["full", "ragged"])
def test_linear_chain_crf_matches_bruteforce(lens, tmp_path):
    b, t, c = 2, 3, 3
    rng = np.random.RandomState(0)
    emission = rng.randn(b, t, c).astype(np.float32)
    label = rng.randint(0, c, size=(b, t)).astype(np.int64)
    transition = (rng.randn(c + 2, c) * 0.3).astype(np.float32)

    def build(f, L):
        em = L.data(name="em", shape=[t, c], dtype="float32",
                    lod_level=1 if lens else 0)
        lab = L.data(name="lab", shape=[t], dtype="int64")
        return [L.linear_chain_crf(input=em, label=lab, param_attr=_crf_attr(
            f, transition, "crf_w"))]
    feed = {"em": emission, "lab": label}
    if lens:
        feed["em@SEQ_LEN"] = np.array(lens, np.int32)
    nll, d_em = _both(build, feed, tmp_path, grad_of=["em"])
    for r in range(b):
        n = lens[r] if lens else t
        e = emission[r, :n].astype(np.float64)
        log_z = np.log(sum(np.exp(_path_score(e, p, transition))
                           for p in itertools.product(range(c), repeat=n)))
        want = log_z - _path_score(e, label[r, :n], transition)
        np.testing.assert_allclose(nll[r, 0], want, rtol=1e-4)


def test_crf_decoding_viterbi(tmp_path):
    b, t, c = 2, 4, 3
    rng = np.random.RandomState(3)
    emission = rng.randn(b, t, c).astype(np.float32)
    transition = (rng.randn(c + 2, c) * 0.5).astype(np.float32)

    def build(f, L):
        em = L.data(name="em", shape=[t, c], dtype="float32", lod_level=1)
        lab = L.data(name="lab", shape=[t], dtype="int64")
        attr = _crf_attr(f, transition, "crf_w2")
        L.linear_chain_crf(input=em, label=lab, param_attr=attr)
        return [L.crf_decoding(input=em, param_attr=attr),
                L.crf_decoding(input=em, param_attr=attr, label=lab)]
    lens = np.array([4, 3], np.int32)
    best = []
    for r in range(b):
        n = lens[r]
        p = max(itertools.product(range(c), repeat=n),
                key=lambda q: _path_score(emission[r], q, transition))
        best.append(list(p) + [0] * (t - n))
    label = np.array(best, np.int64)
    label[1, 0] = (label[1, 0] + 1) % c
    path, hits = _both(build, {"em": emission, "em@SEQ_LEN": lens,
                               "lab": label}, tmp_path)
    np.testing.assert_array_equal(path, best)
    assert hits[1, 0] == 0 and hits[0].all()


@pytest.mark.parametrize("normalized", [False, True])
def test_edit_distance(normalized, tmp_path):
    def build(f, L):
        hyp = L.data(name="hyp", shape=[1], dtype="int64", lod_level=1)
        ref = L.data(name="ref", shape=[1], dtype="int64", lod_level=1)
        return list(L.edit_distance(input=hyp, label=ref,
                                    normalized=normalized))
    feed = {"hyp": np.array([[1, 2, 3, 0, 0], [5, 6, 7, 8, 0],
                             [4, 4, 4, 4, 4]], np.int64),
            "hyp@SEQ_LEN": np.array([3, 4, 5], np.int32),
            "ref": np.array([[1, 3, 3, 4], [5, 6, 7, 8], [4, 1, 4, 0]],
                            np.int64),
            "ref@SEQ_LEN": np.array([4, 4, 3], np.int32)}
    dist, n = _both(build, feed, tmp_path)
    want = np.array([2.0, 0.0, 3.0])
    np.testing.assert_allclose(dist.reshape(-1),
                               want / [4, 4, 3] if normalized else want)
    assert int(n) == 3


def test_edit_distance_ignored_tokens(tmp_path):
    def build(f, L):
        hyp = L.data(name="hyp", shape=[1], dtype="int64", lod_level=1)
        ref = L.data(name="ref", shape=[1], dtype="int64", lod_level=1)
        return [L.edit_distance(input=hyp, label=ref,
                                ignored_tokens=[0, 9])[0]]
    (dist,) = _both(build, {
        "hyp": np.array([[1, 0, 2, 9, 3]], np.int64),
        "hyp@SEQ_LEN": np.array([5], np.int32),
        "ref": np.array([[1, 2, 3, 0]], np.int64),
        "ref@SEQ_LEN": np.array([4], np.int32)}, tmp_path)
    assert float(dist[0, 0]) == 0.0


@pytest.mark.parametrize("norm_by_times", [False, True])
def test_warpctc_and_greedy_decoder(norm_by_times, tmp_path):
    b, t, c = 2, 8, 5

    def build(f, L):
        logits = L.data(name="logits", shape=[t, c], dtype="float32",
                        lod_level=1)
        label = L.data(name="label", shape=[1], dtype="int64", lod_level=1)
        return [L.warpctc(input=logits, label=label, blank=0,
                          norm_by_times=norm_by_times),
                L.ctc_greedy_decoder(input=logits, blank=0)]
    rng = np.random.RandomState(0)
    feed = {"logits": rng.randn(b, t, c).astype(np.float32),
            "logits@SEQ_LEN": np.array([8, 6], np.int32),
            "label": np.array([[1, 2, 3], [2, 2, 0]], np.int64),
            "label@SEQ_LEN": np.array([3, 2], np.int32)}
    loss, dec, d_logits = _both(build, feed, tmp_path, grad_of=["logits"])
    assert loss.shape == (b, 1) and np.all(loss > 0)
    am = feed["logits"].argmax(-1)
    for r, n in enumerate((8, 6)):
        want = [k for j, k in enumerate(am[r, :n])
                if k != 0 and (j == 0 or k != am[r, j - 1])]
        np.testing.assert_array_equal(dec[r, :len(want)], want)
    # past each row's length the gradient is zero
    assert np.all(d_logits[1, 6:] == 0)


@pytest.mark.parametrize("scheme,num_types,inf,lab,want", [
    ("IOB", 2, [0, 1, 4, 2, 3, 4], [0, 1, 4, 2, 4, 4], (2, 2, 1)),
    ("IOE", 2, [0, 1, 4, 0, 0, 1], [0, 1, 4, 0, 1, 4], (2, 2, 1)),
    ("IOBES", 2, [3, 0, 2, 8, 4, 6], [3, 0, 2, 8, 7, 6], (3, 4, 2)),
    ("plain", 3, [0, 0, 1, 3, 2, 2], [0, 0, 1, 1, 2, 2], (3, 3, 2)),
])
def test_chunk_eval(scheme, num_types, inf, lab, want, tmp_path):
    def build(f, L):
        i = L.data(name="inf", shape=[6], dtype="int64", lod_level=1)
        la = L.data(name="lab", shape=[6], dtype="int64", lod_level=1)
        return list(L.chunk_eval(input=i, label=la, chunk_scheme=scheme,
                                 num_chunk_types=num_types))
    got = _both(build, {"inf": np.array([inf], np.int64),
                        "lab": np.array([lab], np.int64),
                        "inf@SEQ_LEN": np.array([6], np.int32),
                        "lab@SEQ_LEN": np.array([6], np.int32)}, tmp_path)
    assert tuple(int(v) for v in got[3:]) == want


def test_hsigmoid_layer_gradients(tmp_path):
    def build(f, L):
        x = L.data(name="x", shape=[5], dtype="float32")
        lab = L.data(name="lab", shape=[1], dtype="int64")
        return [L.hsigmoid(x, lab, num_classes=9)]
    rng = np.random.RandomState(7)
    _both(build, {"x": rng.randn(6, 5).astype(np.float32),
                  "lab": np.arange(6, dtype=np.int64)[:, None] + 2},
          tmp_path, grad_of=["x"])


# ---------------------------------------------------------------------------
# nce: the JAX formula on the port's samples; draws; gradient
# ---------------------------------------------------------------------------

def _nce_program(num_classes, num_neg, batch, dim):
    prog = fluid.Program()
    block = prog.global_block()
    for name, shape, dt in (("x", (batch, dim), "float32"),
                            ("label", (batch, 1), "int64"),
                            ("w", (num_classes, dim), "float32"),
                            ("b", (num_classes, 1), "float32")):
        block.create_var(name=name, shape=shape, dtype=dt, is_data=True)
    for name in ("cost", "samples"):
        block.create_var(name=name)
    block.append_op("nce", inputs={"Input": ["x"], "Label": ["label"],
                                   "Weight": ["w"], "Bias": ["b"]},
                    outputs={"Cost": ["cost"], "SampleLabels": ["samples"]},
                    attrs={"num_total_classes": num_classes,
                           "num_neg_samples": num_neg})
    return prog


def _softplus(x):
    return np.logaddexp(x, 0.0)


def test_nce_cost_is_the_jax_formula_on_its_samples():
    c, k, b, d = 7, 4, 5, 3
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(b, d).astype(np.float32),
            "label": rng.randint(0, c, (b, 1)).astype(np.int64),
            "w": rng.randn(c, d).astype(np.float32),
            "b": rng.randn(c, 1).astype(np.float32)}
    cost, neg = fluid.Executor(fluid.CPUPlace()).run(
        _nce_program(c, k, b, d), feed=feed, fetch_list=["cost", "samples"],
        scope=fluid.core.scope.Scope())
    assert neg.shape == (b, k) and neg.min() >= 0 and neg.max() < c

    def logit(ids):
        return ((feed["w"][ids] * (feed["x"][:, None] if ids.ndim == 2
                                   else feed["x"])).sum(-1)
                + feed["b"][:, 0][ids])
    log_q = np.log(k / c)
    want = (_softplus(-(logit(feed["label"][:, 0]) - log_q))
            + _softplus(logit(neg) - log_q).sum(1))
    np.testing.assert_allclose(cost[:, 0], want, rtol=1e-5)


def test_nce_draws_are_uniform():
    c, k, b = 6, 50, 400
    feed = {"x": np.zeros((b, 2), np.float32),
            "label": np.zeros((b, 1), np.int64),
            "w": np.zeros((c, 2), np.float32),
            "b": np.zeros((c, 1), np.float32)}
    (neg,) = fluid.Executor(fluid.CPUPlace()).run(
        _nce_program(c, k, b, 2), feed=feed, fetch_list=["samples"],
        scope=fluid.core.scope.Scope())
    freq = np.bincount(neg.reshape(-1), minlength=c) / neg.size
    se = np.sqrt((1 / c) * (1 - 1 / c) / neg.size)
    assert np.all(np.abs(freq - 1 / c) < 5 * se), freq


def test_nce_layer_gradient_by_finite_differences():
    """The nce layer's input @GRAD (the port's calc_gradient) against
    central differences, every run drawing the same negatives (the
    executor's generator reseeded from the program)."""
    fluid.core.program.reset_default_programs()
    x = players.data(name="x", shape=[3], dtype="float32")
    lab = players.data(name="lab", shape=[1], dtype="int64")
    loss = players.reduce_sum(players.nce(x, lab, num_total_classes=6,
                                          num_neg_samples=3))
    (gx,) = pcalc(loss, [x])
    fluid.Executor(fluid.CPUPlace()).run(fluid.default_startup_program())
    rng = np.random.RandomState(2)
    feed = {"x": rng.randn(4, 3).astype(np.float32),
            "lab": np.array([[0], [5], [2], [3]], np.int64)}

    def run(f, fetch):
        return fluid.Executor(fluid.CPUPlace()).run(
            fluid.default_main_program(), feed=f, fetch_list=fetch)
    (g,) = run(feed, [gx])
    fd = np.zeros_like(feed["x"], dtype=np.float64)
    for idx in np.ndindex(fd.shape):
        for sign in (1, -1):
            xp = feed["x"].astype(np.float64)
            xp[idx] += sign * 1e-3
            (v,) = run(dict(feed, x=xp.astype(np.float32)), [loss])
            fd[idx] += sign * float(np.asarray(v))
        fd[idx] /= 2e-3
    np.testing.assert_allclose(g, fd, rtol=1e-2, atol=1e-3)


# ---------------------------------------------------------------------------
# test_cross_entropy_over_beam.py twins
# ---------------------------------------------------------------------------

def _softmax(x):
    z = np.exp(x - np.max(x))
    return z / z.sum()


def test_ceob_single_expansion():
    scores = [np.array([[0.1, 0.9, 0.3, 0.5]], np.float32)]
    costs, grads, _ = _ceob_batch(scores, [np.array([4])],
                                  [np.array([[1, 3]])], [np.array([1])])
    sm = _softmax(np.array([0.9, 0.5]))
    assert np.isclose(costs[0], -np.log(sm[0]), atol=1e-6)
    expect = np.zeros(4, np.float32)
    expect[1], expect[3] = sm[0] - 1, sm[1]
    np.testing.assert_allclose(grads[0][0], expect, atol=1e-6)
    # the gold falls off the beam: it becomes an extra path
    costs, _, _ = _ceob_batch(scores, [np.array([4])],
                              [np.array([[1, 3]])], [np.array([2])])
    assert np.isclose(costs[0], -np.log(_softmax(
        np.array([0.9, 0.5, 0.3]))[2]), atol=1e-6)


def test_ceob_three_expansions_with_mid_chain_padding():
    a = np.array([0.2, -0.4, 0.7])
    b, c = np.array([0.5, -0.1]), np.array([0.3, 0.9])
    d, e, f = (np.array([0.1, 0.4]), np.array([-0.2, 0.6]),
               np.array([0.8, -0.3]))
    scores = [a.reshape(1, 3).astype(np.float32),
              np.stack([b, c]).astype(np.float32),
              np.stack([d, e, f]).astype(np.float32)]
    lens = [np.array([3]), np.array([2, 2]), np.array([2, 2, 2])]
    ids = [np.array([[2, 0]]), np.array([[1, -1], [0, 1]]),
           np.array([[0, -1], [1, 0], [0, 1]])]
    golds = [np.array([2]), np.array([1]), np.array([0])]
    costs, grads, _ = _ceob_batch(scores, lens, ids, golds)
    totals = np.array([a[2] + b[1] + d[0], a[0] + c[0] + e[1],
                       a[0] + c[0] + e[0], a[0] + c[1] + f[0],
                       a[0] + c[1] + f[1]])
    sm = _softmax(totals)
    assert np.isclose(costs[0], -np.log(sm[0]), atol=1e-6)
    g1 = np.zeros((2, 2))
    g1[0, 1], g1[1, 0], g1[1, 1] = sm[0] - 1, sm[1] + sm[2], sm[3] + sm[4]
    np.testing.assert_allclose(grads[1], g1, atol=1e-6)


def test_ceob_gold_falls_off_mid_chain_truncates():
    scores = [np.array([[0.2, -0.4, 0.7]], np.float32),
              np.array([[9.0, 9.0], [9.0, 9.0]], np.float32)]
    costs, grads, _ = _ceob_batch(
        scores, [np.array([3]), np.array([2, 2])],
        [np.array([[2, 0]]), np.array([[1, -1], [0, 1]])],
        [np.array([1]), np.array([0])])
    assert np.isclose(costs[0], -np.log(_softmax(
        np.array([0.7, 0.2, -0.4]))[2]), atol=1e-6)
    assert np.all(grads[1] == 0)


CEOB_ARGS = dict(
    s0=np.random.RandomState(0).randn(2, 5).astype(np.float32),
    s1=np.random.RandomState(1).randn(4, 3).astype(np.float32),
    lens=[np.array([5, 4]), np.array([3, 3, 2, 3])],
    ids=[np.array([[4, 1], [0, 2]]),
         np.array([[0, 2], [1, -1], [2, 0], [1, 1]])],
    golds=[np.array([4, 3]), np.array([2, 0])])


def test_ceob_function_matches_jax_and_finite_differences():
    """The port's autograd Function: costs and score gradients equal the
    JAX custom VJP's (upstream weights 0.7 and 1.3), and its gradient
    equals central differences of its costs."""
    import jax
    import jax.numpy as jnp
    a = CEOB_ARGS
    up = np.array([0.7, 1.3], np.float32)

    def port(s0, s1):
        flat = ([s0, s1] + [torch.from_numpy(x) for x in a["lens"]]
                + [torch.from_numpy(x) for x in a["ids"]]
                + [torch.from_numpy(x) for x in a["golds"]])
        return BeamTrainingCost.apply(2, *flat)

    def jcost(s0, s1):
        return _beam_training_cost(2, [s0, s1],
                                   [jnp.array(x) for x in a["lens"]],
                                   [jnp.array(x) for x in a["ids"]],
                                   [jnp.array(x) for x in a["golds"]])
    t0 = torch.tensor(a["s0"], requires_grad=True)
    t1 = torch.tensor(a["s1"], requires_grad=True)
    cost = port(t0, t1)
    (cost * torch.from_numpy(up)).sum().backward()
    jc = jcost(jnp.array(a["s0"]), jnp.array(a["s1"]))
    jg = jax.grad(lambda x, y: (jcost(x, y) * up).sum(), argnums=(0, 1))(
        jnp.array(a["s0"]), jnp.array(a["s1"]))
    _close(cost.detach().numpy(), np.asarray(jc))
    _close(t0.grad.numpy(), np.asarray(jg[0]))
    _close(t1.grad.numpy(), np.asarray(jg[1]))
    eps = 1e-3
    for arr, g, k in ((a["s0"], t0.grad.numpy(), 0),
                      (a["s1"], t1.grad.numpy(), 1)):
        for idx in np.ndindex(arr.shape):
            vals = []
            for sign in (1, -1):
                p = arr.copy()
                p[idx] += sign * eps
                args = ([torch.from_numpy(p), torch.from_numpy(a["s1"])]
                        if k == 0 else
                        [torch.from_numpy(a["s0"]), torch.from_numpy(p)])
                vals.append(float((port(*args).detach().numpy()
                                   * up).sum()))
            assert abs((vals[0] - vals[1]) / (2 * eps) - g[idx]) < 5e-3


def test_ceob_op_matches_jax(tmp_path):
    """The cross_entropy_over_beam op in a program (ragged score rows
    through @SEQ_LEN), JAX against the port, with the scores' @GRADs."""
    a = CEOB_ARGS

    def build(f, L):
        block = f.default_main_program().global_block()
        names = {}
        for k in range(2):
            s = L.data(name=f"s{k}", shape=[a[f's{k}'].shape[1]],
                       dtype="float32", lod_level=1)
            s.stop_gradient = False
            i = L.data(name=f"i{k}", shape=[2], dtype="int64")
            g = L.data(name=f"g{k}", shape=[1], dtype="int64")
            names[k] = (s, i, g)
        out = block.create_var(name="ceob", dtype="float32")
        block.append_op("cross_entropy_over_beam",
                        inputs={"Scores": [names[k][0] for k in range(2)],
                                "Ids": [names[k][1] for k in range(2)],
                                "Gold": [names[k][2] for k in range(2)]},
                        outputs={"Out": [out]})
        return [out]
    feed = {}
    for k in range(2):
        feed[f"s{k}"] = a[f"s{k}"]
        feed[f"s{k}@SEQ_LEN"] = a["lens"][k].astype(np.int32)
        feed[f"i{k}"] = a["ids"][k].astype(np.int64)
        feed[f"g{k}"] = a["golds"][k].astype(np.int64)[:, None]
    cost, g0, g1 = _both(build, feed, tmp_path, grad_of=["s0", "s1"])
    assert cost.shape == (2, 1) and np.isfinite(cost).all()


# ---------------------------------------------------------------------------
# the bookkeeping and debug rules
# ---------------------------------------------------------------------------

def test_print_grad_prints_the_cotangent(capsys, tmp_path):
    def build(f, L):
        x = L.data(name="x", shape=[2], dtype="float32")
        block = f.default_main_program().global_block()
        y = block.create_var(name="y_probe", dtype="float32")
        block.append_op("print_grad", inputs={"In": [x]},
                        outputs={"Out": [y]})
        return [L.scale(y, scale=3.0)]
    xs = np.array([[1.0, -2.0]], np.float32)
    out, gx = _both(build, {"x": xs}, tmp_path, grad_of=["x"])
    np.testing.assert_allclose(gx, np.full_like(xs, 3.0))
    assert "[gradient_printer] [[3. 3.]]" in capsys.readouterr().out


def test_seq_text_printer_appends_decoded_rows(tmp_path):
    vocab = tmp_path / "dict.txt"
    vocab.write_text("\n".join(["<s>", "<e>", "a", "b", "c"]) + "\n")
    outs = []
    for k, (f, L, cg) in enumerate((JAX, PORT)):
        f.core.program.reset_default_programs()
        ids = L.data(name="ids", shape=[1], dtype="int64", lod_level=1)
        block = f.default_main_program().global_block()
        tok = block.create_var(name="tok", dtype="int32")
        result = tmp_path / f"out{k}.txt"
        block.append_op("seq_text_printer", inputs={"Ids": [ids]},
                        outputs={"Out": [tok]},
                        attrs={"dict_file": str(vocab),
                               "result_file": str(result),
                               "delimited": True})
        f.Executor(f.CPUPlace()).run(
            f.default_main_program(),
            feed={"ids": np.array([[2, 3, 4], [4, 2, 0]], np.int64),
                  "ids@SEQ_LEN": np.array([3, 2], np.int32)},
            fetch_list=[tok])
        outs.append(result.read_text())
    assert outs[1] == outs[0] == "0\ta b c\n1\tc a\n"


def test_lod_array_length_and_delete_var(tmp_path):
    def build(f, L):
        x = L.data(name="x", shape=[3, 2], dtype="float32")
        arr = L.lod_tensor_to_array(x)
        block = f.default_main_program().global_block()
        n = block.create_var(name="n", dtype="int32")
        block.append_op("lod_array_length", inputs={"X": [arr]},
                        outputs={"Out": [n]})
        tmp = L.scale(x, scale=2.0)
        block.append_op("delete_var", inputs={"X": [tmp]})
        return [n]
    (n,) = _both(build, {"x": np.zeros((2, 3, 2), np.float32)}, tmp_path)
    assert n.shape == (1,) and int(n[0]) == 3
