"""The port's dense op rules against the JAX package's, op by op.

Each case builds a one-op program with the JAX front end from a spec of
`tests/test_op_grad.py` (its inputs and attributes, for every op the
port registers), appends that harness's weighted-sum loss and a
``calc_gradient`` ``backward`` op, serialises the program to JSON and
loads it in the port: both packages run the same program on the same
numpy feed.  Outputs must agree to 2e-5 x max(1, max |ref|) and the
inputs' @GRADs to 1e-4 x max(1, max |ref|); integer and bool outputs
exactly.

Rules without a gradient are held forward-only (`FORWARD_CASES`), random
rules by their distribution (`test_random_rule_statistics`), and the
coverage test accounts for every rule the port registers.  The repairs
to the port's loss rules and ``fc`` each have a test against the JAX
package.
"""
import zlib

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core.backward import calc_gradient
from paddle_tpu.core.program import reset_default_programs as jreset
import paddle_tpu_torch as fluid
from paddle_tpu_torch.core.program import Program
from paddle_tpu_torch.core.registry import OpRegistry
from test_op_grad import SPECS

OUT_TOL = 2e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _fresh():
    jreset()
    fluid.core.program.reset_default_programs()
    fluid.core.scope._global_scope = fluid.core.scope.Scope()
    yield


def _port_run(program_json, feed, fetch):
    prog = Program.parse_from_string(program_json)
    exe = fluid.Executor(fluid.CPUPlace())
    return exe.run(prog, feed=feed, fetch_list=fetch,
                   scope=fluid.core.scope.Scope())


def _jax_feed_vars(block, inputs, seq_len=None, nodiff=()):
    """Data vars for {slot: [arrays]}; -> (feed, slot -> names, the float
    vars to differentiate)."""
    feed, in_map, diff = {}, {}, []
    for slot, arrs in inputs.items():
        names = []
        for i, arr in enumerate(arrs):
            arr = np.asarray(arr)
            nm = f"{slot.lower()}_{i}"
            diffable = arr.dtype == np.float32 and slot not in nodiff
            v = block.create_var(name=nm, shape=arr.shape,
                                 dtype=str(arr.dtype),
                                 stop_gradient=not diffable, is_data=True)
            feed[nm] = arr.copy()
            names.append(nm)
            if diffable:
                diff.append(v)
        in_map[slot] = names
        if seq_len and slot in seq_len:
            feed[names[0] + "@SEQ_LEN"] = np.asarray(seq_len[slot], np.int32)
    return feed, in_map, diff


def _out_vars(block, outs, n_outs=None):
    out_map, out_vars = {}, {}
    for slot in outs:
        k = (n_outs or {}).get(slot, 1)
        vs = [block.create_var(name=f"o_{slot.lower()}_{i}", shape=(1,),
                               dtype="float32") for i in range(k)]
        out_map[slot] = [v.name for v in vs]
        out_vars[slot] = vs
    return out_map, out_vars


def _build_spec(spec):
    """The spec's one-op JAX program with the weighted-sum loss of
    test_op_grad.py and a calc_gradient backward op -> (program JSON,
    feed, output names, grad names, JAX's fetches)."""
    main = jfluid.default_main_program()
    block = main.global_block()
    feed, in_map, diff = _jax_feed_vars(block, spec.inputs, spec.seq_len,
                                        spec.nodiff)
    out_map, out_vars = _out_vars(block, spec.outs, spec.n_outs)
    block.append_op(spec.op, inputs=in_map, outputs=out_map,
                    attrs=spec.attrs)
    exe = jfluid.Executor(jfluid.CPUPlace())
    loss_vars = [v for s in (spec.loss_outs or spec.outs)
                 for v in out_vars[s]]
    probe = exe.run(main, feed=feed, fetch_list=loss_vars)
    keep = [(v, np.asarray(o)) for v, o in zip(loss_vars, probe)
            if np.asarray(o).dtype.kind == "f"]
    rng = np.random.RandomState(zlib.crc32(spec.op.encode()) % (2**31))
    parts = []
    for j, (v, o) in enumerate(keep):
        wv = block.create_var(name=f"lw_{j}", shape=o.shape, dtype="float32",
                              stop_gradient=True, is_data=True)
        feed[wv.name] = np.asarray(0.5 + rng.rand(*o.shape), np.float32)
        m = block.create_var(name=f"lm_{j}", shape=o.shape, dtype="float32")
        block.append_op("elementwise_mul", inputs={"X": [v], "Y": [wv]},
                        outputs={"Out": [m]}, attrs={"axis": -1})
        s = block.create_var(name=f"ls_{j}", shape=(1,), dtype="float32")
        block.append_op("reduce_sum", inputs={"X": [m]},
                        outputs={"Out": [s]}, attrs={"reduce_all": True})
        parts.append(s)
    loss = block.create_var(name="loss@", shape=(1,), dtype="float32")
    block.append_op("sum", inputs={"X": parts}, outputs={"Out": [loss]})
    grads = calc_gradient(loss, diff) if diff else []
    outs = [n for s in spec.outs for n in out_map[s]]
    fetch = outs + [loss.name] + [g.name for g in grads]
    try:
        ref = exe.run(main, feed=feed, fetch_list=fetch)
    except KeyError:
        # an output this mode of the JAX rule does not set (a test-mode
        # dropout's Mask): compare the loss's outputs only
        outs = [v.name for v in loss_vars]
        fetch = outs + [loss.name] + [g.name for g in grads]
        ref = exe.run(main, feed=feed, fetch_list=fetch)
    return (main.serialize_to_string(), feed, outs + [loss.name],
            [g.name for g in grads], fetch, ref)


def _same_dtype(got, want):
    """The fetched dtype is the JAX rule's, but a 64-bit input (JAX
    canonicalizes int64 to int32 and float64 to float32 with x64 off)
    stays 64-bit in the port."""
    got, want = np.dtype(got), np.dtype(want)
    return got == want or (got.name, want.name) in {("int64", "int32"),
                                                    ("float64", "float32")}


def _assert_close(name, got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert _same_dtype(got.dtype, want.dtype), (name, got.dtype, want.dtype)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    g, w = got.astype(np.float64), want.astype(np.float64)
    assert np.array_equal(np.isnan(g), np.isnan(w)), name
    finite = ~np.isnan(w)
    if not finite.any():
        return
    scale = max(1.0, float(np.abs(w[finite]).max()))
    err = float(np.abs(g[finite] - w[finite]).max())
    assert err <= tol * scale, (f"{name}: max abs err {err:.3e} > "
                                f"{tol} x {scale:.3g}")


#: rules whose draws the port cannot match (torch's generator, not
#: threefry): held by their samples in test_torch_structured_ops.py
SAMPLED = {"nce"}
PARITY_SPECS = [s for s in SPECS if OpRegistry.has(s.op)
                and s.op not in SAMPLED]


def _ids(specs):
    seen = {}
    ids = []
    for s in specs:
        n = seen.get(s.op, 0)
        seen[s.op] = n + 1
        ids.append(s.op if n == 0 else f"{s.op}#{n}")
    return ids


@pytest.mark.parametrize("spec", PARITY_SPECS, ids=_ids(PARITY_SPECS))
def test_op_parity(spec):
    """Forward outputs and the loss's @GRADs of the JAX-built one-op
    program, JAX against the port."""
    prog, feed, outs, grads, fetch, ref = _build_spec(spec)
    got = _port_run(prog, feed, fetch)
    for name, g, w in zip(fetch, got, ref):
        _assert_close(f"{spec.op} {name}", g, w,
                      GRAD_TOL if name in grads else OUT_TOL)


# ---------------------------------------------------------------------------
# rules with no gradient: forward only
# ---------------------------------------------------------------------------

def _u(shape, lo, hi, seed):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


A = _u((3, 4), -1, 1, 200)
B = np.where(np.arange(12).reshape(3, 4) % 3 == 0, A, _u((3, 4), -1, 1, 201))
BOOL_A = A > 0
BOOL_B = B > 0.2
PROBS = np.stack([1 - _u((16,), 0, 1, 202), _u((16,), 0, 1, 202)], axis=1)

#: (op, inputs, attrs, outputs) of the forward-only cases
FORWARD_CASES = [
    (op, {"X": A, "Y": B}, {}, ("Out",))
    for op in ("equal", "not_equal", "less_than", "less_equal",
               "greater_than", "greater_equal")] + [
    (op, {"X": BOOL_A, "Y": BOOL_B}, {}, ("Out",))
    for op in ("logical_and", "logical_or", "logical_xor")] + [
    ("logical_not", {"X": BOOL_A}, {}, ("Out",)),
    ("arg_max", {"X": A}, {"axis": 1}, ("Out",)),
    ("arg_min", {"X": A}, {"axis": 0}, ("Out",)),
    ("one_hot", {"X": np.array([[0], [3], [1], [5], [-1]], np.int64)},
     {"depth": 4}, ("Out",)),
    ("shape", {"Input": _u((2, 3, 5), 0, 1, 203)}, {}, ("Out",)),
    ("is_empty", {"X": A}, {}, ("Out",)),
    ("fill_constant_batch_size_like", {"Input": _u((5, 3), 0, 1, 204)},
     {"shape": [-1, 7], "dtype": "float32", "value": 2.5,
      "input_dim_idx": 0, "output_dim_idx": 0}, ("Out",)),
    ("fill_constant", {}, {"shape": [2, 3], "dtype": "int32",
                           "value": 7.0}, ("Out",)),
    ("assign_value", {}, {"shape": [2, 2], "dtype": "float32",
                          "values": [1.0, -2.0, 3.5, 0.25]}, ("Out",)),
    ("accuracy", {"Out": _u((4, 2), 0, 1, 205),
                  "Indices": np.array([[1, 0], [2, 1], [0, 3], [3, 2]],
                                      np.int64),
                  "Label": np.array([[1], [1], [2], [2]], np.int64)},
     {}, ("Accuracy", "Correct", "Total")),
    ("auc", {"Predict": PROBS,
             "Label": (np.arange(16) % 3 == 0).astype(np.int64)[:, None],
             "TP": np.arange(9, dtype=np.int64), "FP": np.ones(9, np.int64),
             "TN": np.full(9, 2, np.int64), "FN": np.zeros(9, np.int64)},
     {"curve": "ROC", "num_thresholds": 9},
     ("AUC", "TPOut", "FPOut", "TNOut", "FNOut")),
    ("precision_recall",
     {"MaxProbs": _u((6, 1), 0, 1, 206),
      "Indices": np.array([[0], [1], [2], [1], [0], [2]], np.int32),
      "Labels": np.array([[0], [2], [2], [1], [1], [2]], np.int32),
      "StatesInfo": np.arange(12, dtype=np.float32).reshape(3, 4)},
     {}, ("BatchMetrics", "AccumMetrics", "AccumStatesInfo")),
]


def _build_forward(op, inputs, attrs, outs):
    main = jfluid.default_main_program()
    block = main.global_block()
    feed, in_map, _ = _jax_feed_vars(block, {k: [v] for k, v in
                                             inputs.items()})
    out_map, _ = _out_vars(block, outs)
    block.append_op(op, inputs=in_map, outputs=out_map, attrs=attrs)
    fetch = [n for s in outs for n in out_map[s]]
    return main, feed, fetch


@pytest.mark.parametrize("op,inputs,attrs,outs", FORWARD_CASES,
                         ids=[c[0] for c in FORWARD_CASES])
def test_forward_only_parity(op, inputs, attrs, outs):
    main, feed, fetch = _build_forward(op, inputs, attrs, outs)
    ref = jfluid.Executor(jfluid.CPUPlace()).run(main, feed=feed,
                                                 fetch_list=fetch)
    got = _port_run(main.serialize_to_string(), feed, fetch)
    for name, g, w in zip(fetch, got, ref):
        _assert_close(f"{op} {name}", g, w, OUT_TOL)


#: random rules: (op, inputs, attrs, the distribution's mean and variance)
_TRUNC_VAR = 0.7737413          # N(0, 1) truncated to [-2, 2]
RANDOM_CASES = [
    ("uniform_random_batch_size_like",
     {"Input": np.zeros((20000, 2), np.float32)},
     {"shape": [-1, 3], "dtype": "float32", "min": -1.0, "max": 3.0},
     1.0, 16.0 / 12.0),
    ("gaussian_random_batch_size_like",
     {"Input": np.zeros((3, 20000), np.float32)},
     {"shape": [2, -1], "dtype": "float32", "mean": 0.5, "std": 2.0,
      "input_dim_idx": 1, "output_dim_idx": 1}, 0.5, 4.0),
    ("truncated_gaussian_random", {},
     {"shape": [200, 300], "dtype": "float32", "mean": -1.0, "std": 0.5},
     -1.0, 0.25 * _TRUNC_VAR),
    ("uniform_random", {}, {"shape": [300, 200], "dtype": "float32",
                            "min": 0.0, "max": 2.0}, 1.0, 4.0 / 12.0),
    ("gaussian_random", {}, {"shape": [300, 200], "dtype": "float32",
                             "mean": 3.0, "std": 0.5}, 3.0, 0.25),
]


@pytest.mark.parametrize("op,inputs,attrs,mean,var", RANDOM_CASES,
                         ids=[c[0] for c in RANDOM_CASES])
def test_random_rule_statistics(op, inputs, attrs, mean, var):
    """Same shape and dtype as the JAX rule's draw; the port's mean and
    variance within 5 standard errors of the distribution's (threefry's
    and torch's bits never match)."""
    main, feed, fetch = _build_forward(op, inputs, attrs, ("Out",))
    (ref,) = jfluid.Executor(jfluid.CPUPlace()).run(main, feed=feed,
                                                    fetch_list=fetch)
    (got,) = _port_run(main.serialize_to_string(), feed, fetch)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    n = got.size
    assert abs(got.mean() - mean) < 5 * np.sqrt(var / n), got.mean()
    # the sample variance's standard error, <= sqrt(2 var^2 / n) for
    # these light-tailed laws, doubled
    assert abs(got.var() - var) < 5 * np.sqrt(8 * var * var / n), got.var()
    if op == "truncated_gaussian_random":
        assert np.abs(got - mean).max() <= 2 * 0.5 + 1e-6


def test_sampling_id_frequencies():
    """sampling_id draws each id at its row's probability (a 0 entry
    never), int32 like the JAX rule."""
    probs = np.tile(np.array([[0.1, 0.0, 0.6, 0.3]], np.float32), (8000, 1))
    main, feed, fetch = _build_forward("sampling_id", {"X": probs}, {},
                                       ("Out",))
    (ref,) = jfluid.Executor(jfluid.CPUPlace()).run(main, feed=feed,
                                                    fetch_list=fetch)
    (got,) = _port_run(main.serialize_to_string(), feed, fetch)
    assert got.shape == ref.shape == (8000,) and got.dtype == ref.dtype
    freq = np.bincount(got, minlength=4) / got.size
    assert freq[1] == 0
    se = np.sqrt(probs[0] * (1 - probs[0]) / got.size)
    assert np.all(np.abs(freq - probs[0]) <= 5 * se + 1e-9), freq


# ---------------------------------------------------------------------------
# coverage accounting
# ---------------------------------------------------------------------------

#: registered rules with no gradient path, held forward-only above
NO_GRAD_PATH = ({c[0] for c in FORWARD_CASES}
                | {c[0] for c in RANDOM_CASES} | {"sampling_id"})
#: rules held against the JAX package in other port test files
ELSEWHERE = {
    "adam": "test_torch_train.py", "momentum": "test_torch_resnet.py",
    "sgd": "test_torch_book_models.py", "backward": "test_torch_train.py",
    "dynamic_rnn": "test_torch_stacked_lstm.py",
    **{op: "test_torch_optimizers.py" for op in (
        "adamax", "adagrad", "decayed_adagrad", "adadelta", "rmsprop",
        "ftrl", "proximal_gd", "proximal_adagrad", "average_accumulates")},
    "check_finite_and_unscale": "test_torch_mixed_precision.py",
    "update_loss_scaling": "test_torch_mixed_precision.py",
    **{op: "test_torch_control_flow.py" for op in (
        "while", "conditional_block", "if_else", "parallel_do",
        "write_to_array", "read_from_array", "array_length", "print",
        "lod_rank_table", "max_sequence_len", "lod_tensor_to_array",
        "array_to_lod_tensor")},
    **{op: "test_torch_sequence_ops.py" for op in (
        "sequence_erase", "sequence_mask", "beam_search",
        "beam_search_decode", "beam_init_scores")},
    **{op: "test_torch_structured_ops.py" for op in (
        "crf_decoding", "edit_distance", "chunk_eval", "ctc_align", "nce",
        "cross_entropy_over_beam", "print_grad", "seq_text_printer",
        "lod_array_length", "delete_var")},
    **{op: "test_torch_generation.py" for op in (
        "kv_cache_write", "paged_attention", "pos_encoding_add",
        "batched_select")},
    **{op: "test_torch_misc_ops.py" for op in (
        "fill", "max_pool2d_with_index", "max_pool3d_with_index",
        "positive_negative_pair")},
    **{op: "test_torch_detection.py" for op in (
        "prior_box", "bipartite_match", "mine_hard_examples",
        "multiclass_nms", "detection_map")},
    **{op: "test_torch_pserver.py" for op in ("listen_and_serv", "send")},
    **{op: "test_torch_csp.py" for op in (
        "channel_create", "channel_send", "channel_recv", "channel_close",
        "go", "select")},
}


def test_dense_coverage_accounting():
    """Every rule the port registers is held against the JAX rule by
    test_op_parity (forward and @GRAD), held forward-only here, or held
    by a named port test file; the dense families and the sequence, LoD,
    beam, control, array, CRF, misc, KV-cache and detection families
    are complete."""
    registered = set(OpRegistry.registered_ops())
    parity = {s.op for s in PARITY_SPECS}
    unaccounted = registered - parity - NO_GRAD_PATH - set(ELSEWHERE)
    assert not unaccounted, f"unaccounted rules: {sorted(unaccounted)}"
    assert not (NO_GRAD_PATH | set(ELSEWHERE)) - registered
    assert not parity & set(ELSEWHERE), parity & set(ELSEWHERE)
    assert len(registered) >= 237, len(registered)
    from paddle_tpu.core.registry import OpRegistry as JaxRegistry
    import inspect
    families = ("math_ops.py", "tensor_ops.py", "logic_ops.py", "nn_ops.py",
                "sequence_ops.py", "lod_ops.py", "beam_ops.py",
                "control_ops.py", "array_ops.py", "crf_ops.py",
                "misc_ops.py", "kv_cache_ops.py", "detection_ops.py")
    missing = sorted(
        n for n in JaxRegistry.registered_ops()
        if inspect.getsourcefile(JaxRegistry.get(n).fn).endswith(families)
        and n not in registered)
    assert missing == [], missing


# ---------------------------------------------------------------------------
# repairs of the port's loss rules and fc
# ---------------------------------------------------------------------------

def _loss_case(op, inputs, attrs, outs, seq_len=None, nodiff=()):
    """Run a one-op JAX program and the port on it: (JAX fetches, the
    port's), with the input @GRADs of the sum of the first output."""
    main = jfluid.default_main_program()
    block = main.global_block()
    feed, in_map, diff = _jax_feed_vars(
        block, {k: [v] for k, v in inputs.items()}, seq_len, nodiff)
    out_map, out_vars = _out_vars(block, outs)
    block.append_op(op, inputs=in_map, outputs=out_map, attrs=attrs)
    y = out_vars[outs[0]][0]
    loss = block.create_var(name="loss@", shape=(1,), dtype="float32")
    block.append_op("reduce_sum", inputs={"X": [y]},
                    outputs={"Out": [loss]}, attrs={"reduce_all": True})
    grads = calc_gradient(loss, diff)
    fetch = [y.name] + [g.name for g in grads]
    ref = jfluid.Executor(jfluid.CPUPlace()).run(main, feed=feed,
                                                 fetch_list=fetch)
    got = _port_run(main.serialize_to_string(), feed, fetch)
    return fetch, ref, got


def test_cross_entropy_out_of_range_labels_follow_jax():
    """A label in [-V, 0) wraps, any other label outside [0, V) gives a
    NaN loss (and no gradient), as jnp.take_along_axis does; the port's
    gather is clamped, so on the card no label fires a device assert."""
    v = 4
    probs = _u((6, v), 0.1, 1.0, 210)
    probs /= probs.sum(1, keepdims=True)
    label = np.array([[0], [-1], [v], [v + 3], [-v - 1], [2]], np.int64)
    fetch, ref, got = _loss_case("cross_entropy", {"X": probs,
                                                   "Label": label},
                                 {"soft_label": False}, ("Y",))
    assert np.isnan(ref[0][[2, 3, 4]]).all()
    assert np.isclose(ref[0][1, 0], -np.log(probs[1, v - 1]))
    for name, g, w in zip(fetch, got, ref):
        _assert_close(name, g, w, OUT_TOL)


def test_cross_entropy_masks_padded_tokens():
    """3-D per-token losses of a ragged batch are zero past each row's
    length (Label's @SEQ_LEN), and their gradient too."""
    probs = _u((3, 5, 4), 0.1, 1.0, 211)
    probs /= probs.sum(-1, keepdims=True)
    label = np.random.RandomState(212).randint(0, 4, (3, 5, 1))
    fetch, ref, got = _loss_case(
        "cross_entropy", {"X": probs, "Label": label.astype(np.int64)},
        {"soft_label": False}, ("Y",), seq_len={"Label": [5, 2, 3]})
    assert (ref[0][1, 2:] == 0).all() and (ref[0][0] != 0).all()
    for name, g, w in zip(fetch, got, ref):
        _assert_close(name, g, w, GRAD_TOL if "@GRAD" in name else OUT_TOL)


@pytest.mark.parametrize("op,prob_slot,out", [
    ("cross_entropy", "X", "Y"),
    ("softmax_with_cross_entropy", "Logits", "Loss")])
def test_soft_label_losses(op, prob_slot, out):
    """Soft labels: -sum(label * log p) on probabilities, or on the
    log-softmax of logits, with the gradient, against JAX."""
    x = _u((4, 5), 0.1, 1.0, 213)
    if op == "cross_entropy":
        x /= x.sum(1, keepdims=True)
    label = _u((4, 5), 0.0, 1.0, 214)
    label /= label.sum(1, keepdims=True)
    outs = (out, "Softmax") if op != "cross_entropy" else (out,)
    fetch, ref, got = _loss_case(op, {prob_slot: x, "Label": label},
                                 {"soft_label": True}, outs,
                                 nodiff=("Label",))
    for name, g, w in zip(fetch, got, ref):
        _assert_close(name, g, w, GRAD_TOL if "@GRAD" in name else OUT_TOL)


def test_softmax_with_cross_entropy_masks_padded_tokens():
    logits = _u((2, 4, 6), -2, 2, 215)
    label = np.random.RandomState(216).randint(0, 6, (2, 4, 1))
    fetch, ref, got = _loss_case(
        "softmax_with_cross_entropy",
        {"Logits": logits, "Label": label.astype(np.int64)},
        {"soft_label": False}, ("Loss", "Softmax"),
        seq_len={"Label": [4, 1]})
    assert (ref[0][1, 1:] == 0).all()
    for name, g, w in zip(fetch, got, ref):
        _assert_close(name, g, w, GRAD_TOL if "@GRAD" in name else OUT_TOL)


def test_fc_over_several_inputs_is_the_jax_program():
    """fc over a list: one mul an input (a param_attr each), summed by a
    sum op; same program as the JAX layer, and the same output from the
    same parameters."""
    from paddle_tpu import layers as jl
    from paddle_tpu_torch import layers as pl
    xs = [_u((3, 4), -1, 1, 217), _u((3, 2), -1, 1, 218)]
    for lay, pkg in ((jl, jfluid), (pl, fluid)):
        a = lay.data(name="a", shape=[4])
        b = lay.data(name="b", shape=[2])
        lay.fc(input=[a, b], size=5, act="tanh",
               param_attr=[pkg.ParamAttr(name="wa"),
                           pkg.ParamAttr(name="wb")])
    jmain, pmain = jfluid.default_main_program(), fluid.default_main_program()
    assert [op.type for op in pmain.global_block().ops] == [
        "mul", "mul", "sum", "elementwise_add", "tanh"]
    assert pmain.to_dict() == jmain.to_dict()
    assert (fluid.default_startup_program().to_dict()
            == jfluid.default_startup_program().to_dict())
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    params = {n: np.asarray(jfluid.global_scope().get(n))
              for n in ("wa", "wb", "fc_0.b_0")}
    out = jmain.global_block().ops[-1].desc.outputs["Out"][0]
    feed = {"a": xs[0], "b": xs[1]}
    (ref,) = jexe.run(jmain, feed=feed, fetch_list=[out])
    scope = fluid.core.scope.Scope()
    for n, v in params.items():
        scope.set(n, torch.from_numpy(v.copy()))
    (got,) = fluid.Executor(fluid.CPUPlace()).run(
        pmain, feed=feed, fetch_list=[out], scope=scope)
    _assert_close("fc", got, ref, OUT_TOL)
