"""The detection op rules and layers (``ops/detection_ops.py``,
``layers/detection.py``) in the port against the JAX package, on the CPU.

- Each of the ten rules as a one-op program built by the JAX front end
  and run by both packages (the port from its JSON), on seeded inputs
  that hold ties (quantized scores and similarities), boxes of zero area
  and padding rows: discrete outputs (indices, masks, NMS rows, gathered
  targets) exactly, f32 values at 2e-5 x max(1, max |ref|).
- Twins of tests/test_detection_ops.py's five tests on the port.
- A small SSD (32x32 images, a conv-BatchNorm-depthwise body, two
  ``multi_box_head`` maps, 3 classes, batch 2, 3 ground-truth boxes an
  image, one ``ssd_loss`` per ``layers.split`` slice summed by
  ``layers.sums``), built by both front ends (equal JSON) and run by the
  port as built by each: the loss of 3 Momentum steps, every @GRAD of
  step 1 and every persistable after step 3 at 1e-4 of its max; then the
  batched ``detection_output`` + ``detection_map`` of the inference clone
  (rows compared where no other candidate score lies within 1e-5, and the
  NMS rule alone on identical inputs exactly).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import io as jio
from paddle_tpu import layers as jlayers
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.backward import calc_gradient as jcalc
import paddle_tpu_torch as fluid
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import layers as players
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.backward import calc_gradient as pcalc
from paddle_tpu_torch.core.program import Program

TOL = 2e-5
MODEL_TOL = 1e-4
JAX = (jfluid, jlayers, jopt)
PORT = (fluid, players, popt)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The tier-1 run shares the cores among several pytest workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh():
    jfluid.core.program.reset_default_programs()
    fluid.core.program.reset_default_programs()
    jfluid.global_scope().clear()
    fluid.core.scope._global_scope = fluid.core.scope.Scope()
    yield


def _close(got, want, name="", tol=TOL, exact=False):
    """Integer and bool outputs (and ``exact`` ones) equal; floats to
    ``tol`` x max(1, max |want|), infinities and NaN where the reference
    has them."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype.kind in "biu" or exact:
        np.testing.assert_array_equal(got.astype(np.float64),
                                      want.astype(np.float64), err_msg=name)
        return
    g, w = got.astype(np.float64), want.astype(np.float64)
    odd = ~np.isfinite(w)
    assert np.array_equal(g[odd], w[odd], equal_nan=True), name
    if odd.all():
        return
    scale = max(1.0, float(np.abs(w[~odd]).max()))
    err = float(np.abs(g[~odd] - w[~odd]).max())
    assert err <= tol * scale, f"{name}: {err:.3e} > {tol} x {scale:.3g}"


def _one_op(op, inputs, attrs, outs):
    """A one-op program built by the JAX front end over data vars, run by
    both packages (the port from its JSON) -> (port's, JAX's) fetches."""
    main = jfluid.default_main_program()
    block = main.global_block()
    in_map, feed = {}, {}
    for slot, arr in inputs.items():
        arr = np.asarray(arr)
        name = slot.lower()
        block.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype),
                         is_data=True)
        in_map[slot] = [name]
        feed[name] = arr
    out_map = {s: [f"o_{s.lower()}"] for s in outs}
    for s in outs:
        block.create_var(name=out_map[s][0], shape=(1,), dtype="float32")
    block.append_op(op, inputs=in_map, outputs=out_map, attrs=attrs)
    fetch = [out_map[s][0] for s in outs]
    want = jfluid.Executor(jfluid.CPUPlace()).run(main, feed=feed,
                                                  fetch_list=fetch)
    got = fluid.Executor(fluid.CPUPlace()).run(
        Program.parse_from_string(main.serialize_to_string()), feed=feed,
        fetch_list=fetch, scope=fluid.core.scope.Scope())
    return got, [np.asarray(w) for w in want]


def _boxes(rng, n, zero_area=0, pad=0):
    """``n`` boxes (x1, y1, x2, y2) in [0, 1]: the last ``pad`` rows all
    zeros and the ``zero_area`` rows before them of zero width."""
    xy = rng.rand(n, 2).astype(np.float32) * 0.7
    wh = rng.rand(n, 2).astype(np.float32) * 0.3 + 0.02
    b = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    real = n - pad
    b[real - zero_area:real, 2] = b[real - zero_area:real, 0]
    b[real:] = 0.0
    return b


def _rng(seed):
    return np.random.RandomState(seed)


def _quantized(rng, shape, levels):
    return np.asarray(levels, np.float32)[rng.randint(0, len(levels), shape)]


def _nms_inputs(seed, b=2, m=12, c=3):
    """Boxes with exact duplicates (IoU 1), zero-area and padding rows;
    scores from four levels (ties; 0.005 under the default threshold)."""
    rng = _rng(seed)
    boxes = np.stack([_boxes(rng, m, zero_area=2, pad=2) for _ in range(b)])
    boxes[:, 1] = boxes[:, 0]
    boxes[:, 5] = boxes[:, 4]
    scores = _quantized(rng, (b, c, m), [0.005, 0.2, 0.4, 0.6])
    return boxes, scores


def _det_rows(rng, b, k, gt_boxes):
    """Detection rows (label, score, box): labels from {-1, 0, 1, 2},
    quantized scores, boxes near the ground truth or anywhere."""
    labels = rng.randint(-1, 3, (b, k)).astype(np.float32)
    scores = _quantized(rng, (b, k), [0.1, 0.5, 0.5, 0.9])
    g = gt_boxes.shape[1]
    near = gt_boxes[np.arange(b)[:, None], rng.randint(0, g, (b, k))]
    jitter = (rng.rand(b, k, 4).astype(np.float32) - 0.5) * 0.05
    boxes = np.where(rng.rand(b, k, 1) < 0.6, near + jitter,
                     np.stack([_boxes(rng, k) for _ in range(b)]))
    return np.concatenate([labels[..., None], scores[..., None],
                           boxes.astype(np.float32)], axis=2)


def _map_inputs(seed, v1=None):
    """(DetectRes, GTBoxes, GTLabels or None): 2 images, 8 detections, 4
    ground truths with a padding row; ``v1`` "difficult" or "plain" packs
    the labels (and a difficult flag) into the GTBoxes rows."""
    rng = _rng(seed)
    gtb = np.stack([_boxes(rng, 4, pad=1) for _ in range(2)])
    gtl = rng.randint(1, 3, (2, 4)).astype(np.int64)
    gtl[:, 3] = -1
    gtl[1, 0] = 0                                # background: never counts
    det = _det_rows(rng, 2, 8, gtb)
    if v1 is None:
        return det, gtb, gtl
    cols = [gtl.astype(np.float32)[..., None], gtb]
    if v1 == "difficult":
        cols.append(np.array([[[1], [0], [0], [0]], [[0], [1], [0], [0]]],
                             np.float32))
    return det, np.concatenate(cols, axis=2), None


def _recall_nine_tenths():
    """One image, 10 ground truths of class 1 and 12 detections, 9 of
    them on a ground truth: the last recall is 9/10, which must meet the
    11-point grid's 0.9 as f32 ``jnp.linspace`` puts it."""
    rng = _rng(28)
    gtb = _boxes(rng, 10)[None]
    det = np.zeros((1, 12, 6), np.float32)
    det[0, :, 0] = 1.0
    det[0, :, 1] = np.linspace(0.95, 0.4, 12, dtype=np.float32)
    det[0, :9, 2:] = gtb[0, :9]
    det[0, 9:, 2:] = _boxes(rng, 3) + 2.0
    return {"DetectRes": det, "GTBoxes": gtb,
            "GTLabels": np.ones((1, 10), np.int64)}


#: (op, inputs, attrs, outputs, exact) of each rule case
RULE_CASES = {
    "prior_box max sizes, flip, clip": (
        "prior_box", lambda: {"Input": np.zeros((1, 4, 3, 5), np.float32),
                              "Image": np.zeros((1, 3, 30, 50), np.float32)},
        {"min_sizes": [4.0, 9.0], "max_sizes": [8.0, 15.0],
         "aspect_ratios": [2.0, 3.0], "variances": [0.1, 0.1, 0.2, 0.2],
         "flip": True, "clip": True, "step_w": 0.0, "step_h": 0.0,
         "offset": 0.5}, ("Boxes", "Variances"), False),
    "prior_box steps, no clip": (
        "prior_box", lambda: {"Input": np.zeros((1, 2, 4, 3), np.float32),
                              "Image": np.zeros((1, 3, 32, 24), np.float32)},
        {"min_sizes": [6.0], "max_sizes": [], "aspect_ratios": [1.0, 2.0],
         "variances": [0.1, 0.1, 0.2, 0.2], "flip": False, "clip": False,
         "step_w": 8.0, "step_h": 12.0, "offset": 0.3},
        ("Boxes", "Variances"), False),
    "box_coder encode": (
        "box_coder", lambda: {
            "PriorBox": _boxes(_rng(1), 6),
            "PriorBoxVar": np.tile(np.float32([[0.1, 0.1, 0.2, 0.2]]),
                                   (6, 1)),
            "TargetBox": _boxes(_rng(2), 5, zero_area=1, pad=1)},
        {"code_type": "encode_center_size"}, ("OutputBox",), False),
    "box_coder decode [M, 4]": (
        "box_coder", lambda: {
            "PriorBox": _boxes(_rng(3), 6),
            "PriorBoxVar": np.tile(np.float32([[0.1, 0.1, 0.2, 0.2]]),
                                   (6, 1)),
            "TargetBox": _rng(4).randn(6, 4).astype(np.float32)},
        {"code_type": "decode_center_size"}, ("OutputBox",), False),
    "box_coder decode [N, M, 4]": (
        "box_coder", lambda: {
            "PriorBox": _boxes(_rng(5), 6),
            "PriorBoxVar": np.tile(np.float32([[0.1, 0.1, 0.2, 0.2]]),
                                   (6, 1)),
            "TargetBox": _rng(6).randn(3, 6, 4).astype(np.float32)},
        {"code_type": "decode_center_size"}, ("OutputBox",), False),
    "box_coder decode, no PriorBoxVar": (
        "box_coder", lambda: {
            "PriorBox": _boxes(_rng(7), 5),
            "TargetBox": _rng(8).randn(5, 4).astype(np.float32)},
        {"code_type": "decode_center_size"}, ("OutputBox",), False),
    "iou_similarity zero area and padding": (
        "iou_similarity", lambda: {
            "X": _boxes(_rng(9), 6, zero_area=1, pad=2),
            "Y": np.concatenate([_boxes(_rng(10), 7, zero_area=1),
                                 _boxes(_rng(9), 6, zero_area=1, pad=2)])},
        {}, ("Out",), False),
    "bipartite_match ties and a padding row": (
        "bipartite_match", lambda: {"DistMat": np.concatenate([
            _quantized(_rng(11), (3, 7), [0.0, 0.25, 0.5, 0.75]),
            np.zeros((1, 7), np.float32)])},
        {"match_type": "bipartite", "dist_threshold": 0.5},
        ("ColToRowMatchIndices", "ColToRowMatchDist"), True),
    "bipartite_match per_prediction": (
        "bipartite_match", lambda: {"DistMat": _quantized(
            _rng(12), (3, 9), [0.0, 0.3, 0.4, 0.6])},
        {"match_type": "per_prediction", "dist_threshold": 0.4},
        ("ColToRowMatchIndices", "ColToRowMatchDist"), True),
    "bipartite_match more gts than priors": (
        "bipartite_match", lambda: {"DistMat": _rng(13).rand(
            6, 4).astype(np.float32)},
        {"match_type": "per_prediction", "dist_threshold": 0.2},
        ("ColToRowMatchIndices", "ColToRowMatchDist"), True),
    "target_assign int labels": (
        "target_assign", lambda: {
            "X": np.array([[1], [2], [3], [0]], np.int64),
            "MatchIndices": np.array([[0, -1, 2, 2, -1, 1, 3]], np.int32)},
        {"mismatch_value": 0}, ("Out", "OutWeight"), True),
    "target_assign f32 rows": (
        "target_assign", lambda: {
            "X": _rng(14).randn(4, 4).astype(np.float32),
            "MatchIndices": np.array([[3, -1, 0, -1, 1]], np.int32)},
        {"mismatch_value": -1}, ("Out", "OutWeight"), True),
    "mine_hard_examples ties": (
        "mine_hard_examples", lambda: {
            "ClsLoss": _quantized(_rng(15), (2, 10), [0.0, 0.5, 1.0]),
            "MatchIndices": np.where(_rng(16).rand(2, 10) < 0.3,
                                     _rng(17).randint(0, 3, (2, 10)),
                                     -1).astype(np.int32)},
        {"neg_pos_ratio": 1.5, "mining_type": "max_negative"},
        ("NegIndices", "UpdatedMatchIndices"), True),
    "mine_hard_examples with LocLoss": (
        "mine_hard_examples", lambda: {
            "ClsLoss": _quantized(_rng(18), (2, 10), [0.0, 0.5, 1.0]),
            "LocLoss": _quantized(_rng(19), (2, 10), [0.0, 0.5]),
            "MatchIndices": np.where(_rng(20).rand(2, 10) < 0.4,
                                     _rng(21).randint(0, 3, (2, 10)),
                                     -1).astype(np.int32)},
        {"neg_pos_ratio": 3.0, "mining_type": "hard_example"},
        ("NegIndices", "UpdatedMatchIndices"), True),
    "multiclass_nms ties, duplicates, padding": (
        "multiclass_nms", lambda: dict(zip(("BBoxes", "Scores"),
                                           _nms_inputs(22))),
        {"background_label": 0, "score_threshold": 0.01,
         "nms_threshold": 0.3, "nms_top_k": 8, "keep_top_k": 10},
        ("Out",), True),
    "multiclass_nms keep_top_k past the candidates": (
        "multiclass_nms", lambda: dict(zip(("BBoxes", "Scores"),
                                           _nms_inputs(23, m=6, c=4))),
        {"background_label": 1, "score_threshold": 0.3,
         "nms_threshold": 0.5, "nms_top_k": 64, "keep_top_k": 40},
        ("Out",), True),
    "detection_map GTLabels": (
        "detection_map", lambda: dict(zip(("DetectRes", "GTBoxes",
                                           "GTLabels"), _map_inputs(24))),
        {"overlap_threshold": 0.5, "background_label": 0,
         "evaluate_difficult": True, "ap_version": "11point"},
        ("MAP", "AccumPosCount"), False),
    "detection_map v1 rows, difficult skipped": (
        "detection_map", lambda: dict(zip(("DetectRes", "GTBoxes"),
                                          _map_inputs(25, "difficult"))),
        {"overlap_threshold": 0.3, "background_label": 0,
         "evaluate_difficult": False, "ap_version": "11point"},
        ("MAP", "AccumPosCount"), False),
    "detection_map v1 rows without difficult": (
        "detection_map", lambda: dict(zip(("DetectRes", "GTBoxes"),
                                          _map_inputs(26, "plain"))),
        {"overlap_threshold": 0.5, "background_label": 0,
         "evaluate_difficult": True, "ap_version": "11point"},
        ("MAP", "AccumPosCount"), False),
    "detection_map recall 9/10": (
        "detection_map", _recall_nine_tenths,
        {"overlap_threshold": 0.5, "background_label": 0},
        ("MAP", "AccumPosCount"), False),
    "gather_encoded_target": (
        "gather_encoded_target", lambda: {
            "Encoded": _rng(27).randn(3, 7, 4).astype(np.float32),
            "MatchIndices": np.array([[2, -1, 0, 1, -1, 2, 0]], np.int32)},
        {}, ("Out", "OutWeight"), True),
    "abs_smooth_l1": (
        "abs_smooth_l1", lambda: {"X": np.float32(
            [[-2.5, -1.0, -0.999, -0.3, 0.0], [0.3, 0.999, 1.0, 1.001, 4.]])},
        {}, ("Out",), False),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_rule_matches_jax(case):
    op, make, attrs, outs, exact = RULE_CASES[case]
    got, want = _one_op(op, make(), attrs, outs)
    for slot, g, w in zip(outs, got, want):
        _close(g, w, f"{case} {slot}", exact=exact)


def test_every_detection_rule_is_held():
    """The cases above reach all ten rules, and the port registers
    exactly the JAX registry, csp_ops.py's 6 included."""
    from paddle_tpu.core.registry import OpRegistry as J
    from paddle_tpu_torch.core.registry import OpRegistry as P
    assert {c[0] for c in RULE_CASES.values()} == {
        "prior_box", "box_coder", "iou_similarity", "bipartite_match",
        "target_assign", "mine_hard_examples", "multiclass_nms",
        "detection_map", "gather_encoded_target", "abs_smooth_l1"}
    missing = set(J.registered_ops()) - set(P.registered_ops())
    assert missing == set()
    assert len(P.registered_ops()) == 245
    assert not set(P.registered_ops()) - set(J.registered_ops())


def test_abs_smooth_l1_gradient_matches_jax():
    """abs_smooth_l1's gradient through each package's calc_gradient: x
    where |x| < 1, else sign(x)."""
    x_val = np.float32([[-2.5, -1.0, -0.5, 0.0, 0.25, 0.999, 1.0, 3.0]])
    grads = []
    for f, L, cg in ((jfluid, jlayers, jcalc), (fluid, players, pcalc)):
        f.core.program.reset_default_programs()
        x = L.data(name="x", shape=[8], dtype="float32", stop_gradient=False)
        block = f.default_main_program().global_block()
        out = block.create_var(name="out", shape=(1, 8), dtype="float32")
        block.append_op("abs_smooth_l1", inputs={"X": [x]},
                        outputs={"Out": [out]})
        (g,) = cg(L.reduce_sum(out), [x])
        grads.append(f.Executor(f.CPUPlace()).run(
            f.default_main_program(), feed={"x": x_val}, fetch_list=[g])[0])
    _close(grads[1], grads[0], "dX")
    _close(grads[1], np.where(np.abs(x_val) < 1, x_val, np.sign(x_val)),
           "dX formula")


def test_nms_and_map_under_ties_are_order_stable():
    """multiclass_nms on all-equal scores keeps the lowest indices first
    (lax.top_k's order), and detection_map with all-equal scores counts
    the detections in row order (a stable argsort)."""
    boxes = np.stack([_boxes(_rng(30), 6)])
    scores = np.full((1, 2, 6), 0.5, np.float32)
    got, want = _one_op("multiclass_nms", {"BBoxes": boxes,
                                           "Scores": scores},
                        {"background_label": 0, "score_threshold": 0.01,
                         "nms_threshold": 1.1, "nms_top_k": 4,
                         "keep_top_k": 3}, ("Out",))
    _close(got[0], want[0], "Out", exact=True)
    np.testing.assert_array_equal(got[0][0, :, 2:], boxes[0, :3])
    jfluid.core.program.reset_default_programs()
    det, gtb, gtl = _map_inputs(31)
    det[..., 1] = 0.5
    got, want = _one_op("detection_map", {"DetectRes": det, "GTBoxes": gtb,
                                          "GTLabels": gtl},
                        {"overlap_threshold": 0.5, "background_label": 0},
                        ("MAP", "AccumPosCount"))
    _close(got[0], want[0], "MAP")
    _close(got[1], want[1], "AccumPosCount")


# ---------------------------------------------------------------------------
# twins of tests/test_detection_ops.py
# ---------------------------------------------------------------------------

def _run(fetch, feed):
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    return exe.run(fluid.default_main_program(), feed=feed, fetch_list=fetch)


def _np_iou(a, b):
    ix = np.maximum(np.minimum(a[:, None, 2], b[None, :, 2]) -
                    np.maximum(a[:, None, 0], b[None, :, 0]), 0)
    iy = np.maximum(np.minimum(a[:, None, 3], b[None, :, 3]) -
                    np.maximum(a[:, None, 1], b[None, :, 1]), 0)
    inter = ix * iy
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(aa[:, None] + ab[None, :] - inter, 1e-10)


def _sorted_boxes(rng, n):
    a = np.sort(rng.rand(n, 4).astype(np.float32) * 10, axis=-1)
    return np.stack([np.minimum(a[:, 0], a[:, 2]),
                     np.minimum(a[:, 1], a[:, 3]),
                     np.maximum(a[:, 0], a[:, 2]),
                     np.maximum(a[:, 1], a[:, 3])], 1)


def test_iou_similarity_matches_numpy():
    x = players.data(name="x", shape=[4], dtype="float32")
    y = players.data(name="y", shape=[4], dtype="float32")
    out = players.iou_similarity(x, y)
    rng = np.random.RandomState(0)
    a, b = _sorted_boxes(rng, 5), _sorted_boxes(rng, 3)
    (got,) = _run([out], {"x": a, "y": b})
    np.testing.assert_allclose(got, _np_iou(a, b), rtol=1e-5, atol=1e-6)


def test_box_coder_encode_decode_roundtrip():
    prior = players.data(name="prior", shape=[4], dtype="float32",
                         append_batch_size=False)
    pvar = players.data(name="pvar", shape=[4], dtype="float32",
                        append_batch_size=False)
    gt = players.data(name="gt", shape=[4], dtype="float32",
                      append_batch_size=False)
    enc = players.box_coder(prior, pvar, gt, code_type="encode_center_size")
    dec = players.box_coder(prior, pvar, enc, code_type="decode_center_size")
    pb = np.array([[0.1, 0.1, 0.5, 0.5], [0.4, 0.4, 0.9, 0.8]], np.float32)
    pv = np.full((2, 4), 0.1, np.float32)
    g = np.array([[0.2, 0.2, 0.6, 0.7], [0.0, 0.1, 0.3, 0.4],
                  [0.5, 0.5, 0.8, 0.9]], np.float32)
    got_enc, got_dec = _run([enc, dec], {"prior": pb, "pvar": pv, "gt": g})
    assert got_enc.shape == (3, 2, 4)
    for n in range(3):
        for m in range(2):
            np.testing.assert_allclose(got_dec[n, m], g[n], rtol=1e-4,
                                       atol=1e-5)


def test_bipartite_match_greedy():
    dist = players.data(name="d", shape=[3], dtype="float32",
                        append_batch_size=False)
    idx, val = players.bipartite_match(dist)
    d = np.array([[0.5, 0.9, 0.1],
                  [0.6, 0.7, 0.2]], np.float32)
    got_idx, got_val = _run([idx, val], {"d": d})
    assert got_idx.shape[-1] == 3
    assert got_idx[0, 1] == 0 and np.isclose(got_val[0, 1], 0.9)
    assert got_idx[0, 0] == 1 and np.isclose(got_val[0, 0], 0.6)
    assert got_idx[0, 2] == -1


def test_prior_box_geometry():
    feat = players.data(name="feat", shape=[8, 2, 2], dtype="float32")
    img = players.data(name="img", shape=[3, 32, 32], dtype="float32")
    boxes, variances = players.prior_box(
        feat, img, min_sizes=[4.0], aspect_ratios=[1.0], clip=True,
        variance=[0.1, 0.1, 0.2, 0.2])
    f = np.zeros((1, 8, 2, 2), np.float32)
    im = np.zeros((1, 3, 32, 32), np.float32)
    got_b, got_v = _run([boxes, variances], {"feat": f, "img": im})
    assert got_b.shape == (2, 2, 1, 4)
    np.testing.assert_allclose(got_b[0, 0, 0],
                               [6 / 32, 6 / 32, 10 / 32, 10 / 32], atol=1e-6)
    np.testing.assert_allclose(got_v[0, 0, 0], [0.1, 0.1, 0.2, 0.2])


def test_multiclass_nms_suppresses_overlaps():
    bboxes = players.data(name="b", shape=[1, 3, 4], append_batch_size=False,
                          dtype="float32")
    scores = players.data(name="s", shape=[1, 2, 3], append_batch_size=False,
                          dtype="float32")
    out = players.multiclass_nms(bboxes, scores, background_label=0,
                                 score_threshold=0.1, nms_threshold=0.5,
                                 keep_top_k=10)
    b = np.array([[[0.0, 0.0, 1.0, 1.0],
                   [0.05, 0.0, 1.0, 1.0],
                   [2.0, 2.0, 3.0, 3.0]]], np.float32)
    s = np.array([[[0.0, 0.0, 0.0],
                   [0.9, 0.8, 0.7]]], np.float32)
    (got,) = _run([out], {"b": b, "s": s})
    scores_kept = sorted(float(r[1]) for r in got[0] if r[0] >= 0)
    assert np.isclose(scores_kept[-1], 0.9)
    assert any(np.isclose(sc, 0.7) for sc in scores_kept)
    assert not any(np.isclose(sc, 0.8) for sc in scores_kept)


# ---------------------------------------------------------------------------
# a small SSD, trained and run for inference in both packages
# ---------------------------------------------------------------------------

HW, CLASSES, G, BATCH, LR = 32, 3, 3, 2, 0.01


def _ssd(L, opt):
    """The small SSD in the current default programs -> (loss, loc,
    scores, nmsed, map).  Inference ops sit in the main program before
    the optimizer: training fetches only the loss, and the inference
    clone runs them."""
    image = L.data(name="image", shape=[3, HW, HW], dtype="float32")
    gt_box = L.data(name="gt_box", shape=[G, 4], dtype="float32")
    gt_label = L.data(name="gt_label", shape=[G, 1], dtype="int64")

    def conv_bn(x, c, k, s, p, groups=1):
        return L.batch_norm(L.conv2d(x, c, k, s, p, groups=groups,
                                     bias_attr=False), act="relu")

    x = conv_bn(image, 8, 3, 2, 1)                 # 16 x 16
    x = conv_bn(x, 8, 3, 1, 1, groups=8)           # depthwise
    x = conv_bn(x, 16, 1, 1, 0)
    m1 = conv_bn(x, 16, 3, 2, 1)                   # 8 x 8
    m2 = conv_bn(m1, 16, 3, 2, 1)                  # 4 x 4
    locs, confs, boxes, vars_ = L.multi_box_head(
        [m1, m2], image, base_size=HW, num_classes=CLASSES,
        aspect_ratios=[[2.0], [2.0, 3.0]], min_sizes=[6.4, 12.8],
        max_sizes=[12.8, 22.4], flip=True, clip=True, offset=0.5)

    def flat(t, last):
        return L.reshape(L.transpose(t, [0, 2, 3, 1]), [0, -1, last])

    loc = L.concat([flat(t, 4) for t in locs], axis=1)        # [B, M, 4]
    conf = L.concat([flat(t, CLASSES) for t in confs], axis=1)
    prior = L.concat([L.reshape(b, [-1, 4]) for b in boxes], axis=0)
    pvar = L.concat([L.reshape(v, [-1, 4]) for v in vars_], axis=0)
    losses = []
    for lo, co, gb, gl in zip(L.split(loc, BATCH, dim=0),
                              L.split(conf, BATCH, dim=0),
                              L.split(gt_box, BATCH, dim=0),
                              L.split(gt_label, BATCH, dim=0)):
        losses.append(L.ssd_loss(L.reshape(lo, [-1, 4]), co,
                                 L.reshape(gb, [-1, 4]),
                                 L.reshape(gl, [-1, 1]), prior, pvar))
    loss = L.scale(L.sums(losses), scale=1.0 / BATCH)
    scores = L.transpose(L.softmax(conf), [0, 2, 1])           # [B, C, M]
    nmsed = L.detection_output(loc, scores, prior, pvar)
    mean_ap = L.detection_map(nmsed, gt_box, L.reshape(gt_label, [-1, G]))
    opt.Momentum(learning_rate=LR, momentum=0.9).minimize(loss)
    return loss, loc, scores, nmsed, mean_ap


def _ssd_feeds(n, seed=0):
    """Seeded images and 1-3 ground-truth boxes an image (labels 1-2),
    padded to G with zero boxes labelled 0."""
    rng = np.random.RandomState(seed)
    feeds = []
    for _ in range(n):
        gtb = np.zeros((BATCH, G, 4), np.float32)
        gtl = np.zeros((BATCH, G, 1), np.int64)
        for i in range(BATCH):
            k = rng.randint(1, G + 1)
            gtb[i, :k] = _boxes(rng, k)
            gtl[i, :k, 0] = rng.randint(1, CLASSES, k)
        feeds.append({"image": rng.rand(BATCH, 3, HW, HW).astype(np.float32),
                      "gt_box": gtb, "gt_label": gtl})
    return feeds


def _build_both(tmp_path):
    """The SSD by both front ends (equal JSON); the JAX startup's state
    saved to ``tmp_path`` -> (JAX executor, the JAX build's fetches)."""
    jf = _ssd(jlayers, jopt)
    jfluid.default_startup_program().random_seed = 3
    _ssd(players, popt)
    jmain, pmain = jfluid.default_main_program(), fluid.default_main_program()
    assert pmain.to_dict() == jmain.to_dict()
    assert (fluid.default_startup_program().to_dict()
            == jfluid.default_startup_program().to_dict())
    ops = [op.type for op in pmain.global_block().ops]
    assert ops.count("bipartite_match") == BATCH
    assert ops.count("softmax_with_cross_entropy") == 2
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    jio.save_persistables(jexe, str(tmp_path), jmain)
    return jexe, jf


def _port_runs(tmp_path, jmain):
    """The port's two runs: its own build and the JAX build parsed from
    JSON, each in a scope holding the JAX startup's state."""
    runs = []
    for prog in (fluid.default_main_program(),
                 Program.parse_from_string(jmain.serialize_to_string())):
        scope = fluid.core.scope.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            pio.load_persistables(exe, str(tmp_path), prog)
        runs.append((exe, prog, scope))
    return runs


def test_ssd_training_matches_jax(tmp_path):
    jexe, jf = _build_both(tmp_path)
    jmain = jfluid.default_main_program()
    params = [p.name for p in jmain.all_parameters() if p.trainable]
    fetch = [jf[0].name] + [p + "@GRAD" for p in params]
    feeds = _ssd_feeds(3)
    want = [[np.asarray(w) for w in jexe.run(jmain, feed=f,
                                             fetch_list=fetch)]
            for f in feeds]
    assert want[-1][0] < want[0][0] * 1.5 and np.isfinite(want[-1][0])
    persist = [v.name for v in jmain.list_vars()
               if v.persistable and not v.desc.is_data]
    for exe, prog, scope in _port_runs(tmp_path, jmain):
        for step, f in enumerate(feeds):
            got = exe.run(prog, feed=f, fetch_list=fetch, scope=scope)
            _close(got[0], want[step][0], f"loss of step {step + 1}",
                   MODEL_TOL)
            if step == 0:
                for name, g, w in zip(fetch[1:], got[1:], want[0][1:]):
                    _close(g, w, name, MODEL_TOL)
        for n in persist:
            _close(scope.get(n).numpy(), np.asarray(jfluid.global_scope()
                                                    .get(n)), n, MODEL_TOL)


def _apart(scores, bg=0, gap=1e-5):
    """Per image, the candidate scores (all classes but ``bg``) that no
    other candidate of the image comes within ``gap`` of."""
    out = []
    for s in scores:
        flat = np.sort(np.delete(s, bg, axis=0).reshape(-1))
        d = np.diff(flat)
        lone = np.ones(flat.size, bool)
        lone[1:] &= d > gap
        lone[:-1] &= d > gap
        out.append(set(flat[lone].tolist()))
    return out


def test_ssd_inference_matches_jax(tmp_path):
    """The inference clone in both packages from the JAX startup state:
    loc and scores at 1e-4; each ``detection_output`` row whose score no
    other candidate comes within 1e-5 of, in both packages, equal (label
    and score) and its box at 1e-4, over half the rows; then the NMS
    rule alone fed the JAX decoded boxes and scores, exactly, and
    ``detection_map`` fed the JAX rows."""
    jexe, jf = _build_both(tmp_path)
    jmain = jfluid.default_main_program()
    feed = _ssd_feeds(1, seed=4)[0]
    jtest = jmain.clone(for_test=True)
    want = [np.asarray(w) for w in jexe.run(jtest, feed=feed,
                                            fetch_list=list(jf[1:]))]
    compared = 0
    for exe, prog, scope in _port_runs(tmp_path, jmain):
        got = exe.run(prog.clone(for_test=True), feed=feed,
                      fetch_list=[v.name for v in jf[1:]], scope=scope)
        _close(got[0], want[0], "loc", MODEL_TOL)
        _close(got[1], want[1], "scores", MODEL_TOL)
        lone_j, lone_p = _apart(want[1]), _apart(got[1])
        for b in range(BATCH):
            for g_row, w_row in zip(got[2][b], want[2][b]):
                if w_row[0] < 0 or w_row[1] not in lone_j[b] \
                        or g_row[1] not in lone_p[b]:
                    continue
                compared += 1
                assert g_row[0] == w_row[0]
                _close(g_row[1:], w_row[1:], "row", MODEL_TOL)
        assert compared > BATCH * 20 // 2 // 2
    # the rules alone on identical inputs
    prior, pvar = _prior_and_var(jexe, jtest, feed)
    jfluid.core.program.reset_default_programs()
    _, (decoded,) = _one_op("box_coder", {"PriorBox": prior,
                                          "PriorBoxVar": pvar,
                                          "TargetBox": want[0]},
                            {"code_type": "decode_center_size"},
                            ("OutputBox",))
    jfluid.core.program.reset_default_programs()
    got, ref = _one_op("multiclass_nms", {"BBoxes": decoded,
                                          "Scores": want[1]},
                       {"background_label": 0, "score_threshold": 0.01,
                        "nms_threshold": 0.3, "nms_top_k": 64,
                        "keep_top_k": 20}, ("Out",))
    _close(got[0], ref[0], "Out", exact=True)
    jfluid.core.program.reset_default_programs()
    got, ref = _one_op("detection_map", {
        "DetectRes": ref[0], "GTBoxes": feed["gt_box"],
        "GTLabels": feed["gt_label"][..., 0]},
        {"overlap_threshold": 0.5, "background_label": 0}, ("MAP",))
    _close(got[0], ref[0], "MAP")


def _prior_and_var(jexe, jtest, feed):
    """The concatenated priors and variances of the JAX inference clone
    (the concat ops' outputs along axis 0)."""
    block = jtest.global_block()
    names = [op.desc.outputs["Out"][0] for op in block.ops
             if op.type == "concat" and op.desc.attrs.get("axis") == 0]
    return [np.asarray(v) for v in jexe.run(jtest, feed=feed,
                                            fetch_list=names[:2])]
