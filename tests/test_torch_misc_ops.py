"""The misc op rules and layers (``ops/misc_ops.py``, ``layers/misc.py``)
and the attention variants of ``nets.scaled_dot_product_attention`` in
the port against the JAX package, on the CPU.

Twins of the sixteen tests of tests/test_misc_ops.py from
test_minus_and_l1_norm on: each program is built by the same code with
each package's front end (equal JSON), the port loads the JAX startup's
parameters, the fetches agree to 2e-5 x max(1, max |ref|) (integers
exactly), and the JAX test's own oracle holds on the port's fetches.
Beyond them: ``Mask`` ties for both ``_with_index`` rules (the first
maximum in window order wins, with padding, overlapping windows and
rows of -inf), ``roi_pool``'s round half to even, a missing
``RoisBatchId`` and an empty bin, ``bilinear_interp`` at an output size
of 1, ``gru_unit`` with activations by number, ``lstmp`` time-reversed
with peepholes and its @GRADs, ``fill``; and the attention variants
(cross-attention, a single head, the dropout chain): equal at dropout 0,
the ``is_test`` scaling at dropout 0.35, and the two ValueErrors.
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
from paddle_tpu_torch.core.program import Program

JAX = (jfluid, jlayers, jcalc, jnets)
PORT = (fluid, players, pcalc, pnets)
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
    g, w = got.astype(np.float64), want.astype(np.float64)
    odd = ~np.isfinite(w)          # infinities equal, NaN where NaN
    assert np.array_equal(g[odd], w[odd], equal_nan=True), name
    if odd.all():
        return
    scale = max(1.0, float(np.abs(w[~odd]).max()))
    err = float(np.abs(g[~odd] - w[~odd]).max())
    assert err <= TOL * scale, f"{name}: {err:.3e} > {TOL} x {scale:.3g}"


def _both(build, feed, tmp_path, grad_of=(), for_test=False):
    """Build with both front ends (equal programs), the JAX startup's state
    in the port; with ``grad_of`` the first fetch's sum is differentiated
    by each package's calc_gradient, and with ``for_test`` both run the
    ``clone(for_test=True)``.  Fetches must agree -> the port's."""
    fetches = []
    for f, L, cg, nets in (JAX, PORT):
        f.core.program.reset_default_programs()
        fetch = list(build(f, L, nets))
        if grad_of:
            block = f.default_main_program().global_block()
            fetch += cg(L.reduce_sum(fetch[0]),
                        [block.var(n) for n in grad_of])
        fetches.append(fetch)
    jmain, pmain = (jfluid.default_main_program(),
                    fluid.default_main_program())
    assert jmain.to_dict() == pmain.to_dict()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    jio.save_persistables(jexe, str(tmp_path), jmain)
    exe = fluid.Executor(fluid.CPUPlace())
    pio.load_persistables(exe, str(tmp_path), pmain)
    if for_test:
        jmain, pmain = jmain.clone(for_test=True), pmain.clone(for_test=True)
    want = jexe.run(jmain, feed=feed, fetch_list=fetches[0])
    got = exe.run(pmain, feed=feed, fetch_list=fetches[1])
    for k, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"fetch {k}")
    return got


def _one_op(op, inputs, attrs, outs, tmp_path=None):
    """A one-op program built by the JAX front end over data vars, run by
    both packages (the port from its JSON) -> (the port's, the JAX
    fetches), compared."""
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
    for name, g, w in zip(fetch, got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype, name
        _close(g, w, f"{op} {name}")
    return got, want


# ---------------------------------------------------------------------------
# test_misc_ops.py twins
# ---------------------------------------------------------------------------

def test_minus_and_l1_norm(tmp_path):
    xs = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    ys = np.random.RandomState(1).randn(2, 4).astype(np.float32)

    def build(f, L, nets):
        x = L.data(name="x", shape=[4], dtype="float32")
        y = L.data(name="y", shape=[4], dtype="float32")
        out = L.minus(x, y)
        return [out, L.l1_norm(out)]
    got, got_n = _both(build, {"x": xs, "y": ys}, tmp_path)
    np.testing.assert_allclose(got, xs - ys, rtol=1e-6)
    np.testing.assert_allclose(got_n, np.abs(xs - ys).sum(), rtol=1e-5)


def test_label_smooth_uniform(tmp_path):
    onehot = np.eye(5, dtype=np.float32)[[1, 3]]

    def build(f, L, nets):
        lab = L.data(name="lab", shape=[5], dtype="float32")
        return [L.label_smooth(lab, epsilon=0.1)]
    (got,) = _both(build, {"lab": onehot}, tmp_path)
    np.testing.assert_allclose(got, 0.9 * onehot + 0.1 / 5, rtol=1e-6)


def test_modified_huber_loss_regions(tmp_path):
    xs = np.array([[-2.0], [0.5], [3.0]], np.float32)
    ys = np.array([[1.0], [1.0], [1.0]], np.float32)

    def build(f, L, nets):
        x = L.data(name="x", shape=[1], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        return [L.modified_huber_loss(x, y)]
    (got,) = _both(build, {"x": xs, "y": ys}, tmp_path)
    np.testing.assert_allclose(got, [[8.0], [0.25], [0.0]], rtol=1e-6)


def test_multiplex_row_select(tmp_path):
    a = np.arange(12, dtype=np.float32).reshape(4, 3)
    b = -np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([[0], [1], [1], [0]], np.int32)

    def build(f, L, nets):
        x1 = L.data(name="x1", shape=[3], dtype="float32")
        x2 = L.data(name="x2", shape=[3], dtype="float32")
        ids = L.data(name="ids", shape=[1], dtype="int32")
        return [L.multiplex([x1, x2], ids)]
    (got,) = _both(build, {"x1": a, "x2": b, "ids": idx}, tmp_path)
    np.testing.assert_allclose(got, np.stack([a[0], b[1], b[2], a[3]]))


def test_crop_offsets(tmp_path):
    a = np.arange(25, dtype=np.float32).reshape(5, 5)

    def build(f, L, nets):
        x = L.data(name="x", shape=[5, 5], append_batch_size=False,
                   dtype="float32")
        return [L.crop(x, shape=[2, 3], offsets=[1, 2])]
    (got,) = _both(build, {"x": a}, tmp_path)
    np.testing.assert_allclose(got, a[1:3, 2:5])


def _bilinear_oracle(img, oh, ow):
    h, w = img.shape
    rh = (h - 1) / (oh - 1) if oh > 1 else 0.0
    rw = (w - 1) / (ow - 1) if ow > 1 else 0.0
    res = np.zeros((oh, ow), np.float32)
    for i in range(oh):
        for j in range(ow):
            fi, fj = i * rh, j * rw
            i0, j0 = int(fi), int(fj)
            i1, j1 = min(i0 + 1, h - 1), min(j0 + 1, w - 1)
            di, dj = fi - i0, fj - j0
            res[i, j] = (img[i0, j0] * (1 - di) * (1 - dj)
                         + img[i1, j0] * di * (1 - dj)
                         + img[i0, j1] * (1 - di) * dj
                         + img[i1, j1] * di * dj)
    return res


@pytest.mark.parametrize("out_hw", [(7, 7), (1, 5)], ids=["7x7", "1x5"])
def test_bilinear_interp_matches_numpy(out_hw, tmp_path):
    """7x7 is the JAX test's; at an output size of 1 the ratio is 0."""
    oh, ow = out_hw
    a = np.random.RandomState(0).rand(2, 1, 4, 4).astype(np.float32)

    def build(f, L, nets):
        x = L.data(name="x", shape=[1, 4, 4], dtype="float32")
        return [L.bilinear_interp(x, out_h=oh, out_w=ow)]
    (got,) = _both(build, {"x": a}, tmp_path, grad_of=("x",))[:1]
    for b in range(2):
        np.testing.assert_allclose(got[b, 0], _bilinear_oracle(a[b, 0], oh,
                                                               ow),
                                   rtol=1e-5, atol=1e-6)


def test_conv_shift_circular(tmp_path):
    xs = np.random.RandomState(0).randn(2, 5).astype(np.float32)
    ys = np.random.RandomState(1).randn(2, 3).astype(np.float32)

    def build(f, L, nets):
        x = L.data(name="x", shape=[5], dtype="float32")
        y = L.data(name="y", shape=[3], dtype="float32")
        return [L.conv_shift(x, y)]
    (got,) = _both(build, {"x": xs, "y": ys}, tmp_path)
    want = np.zeros_like(xs)
    for b in range(2):
        for i in range(5):
            for j in range(-1, 2):
                want[b, i] += xs[b, (i + j) % 5] * ys[b, j + 1]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_bilinear_tensor_product(tmp_path):
    xs = np.random.RandomState(0).randn(5, 3).astype(np.float32)
    ys = np.random.RandomState(1).randn(5, 4).astype(np.float32)

    def build(f, L, nets):
        x = L.data(name="x", shape=[3], dtype="float32")
        y = L.data(name="y", shape=[4], dtype="float32")
        return [L.bilinear_tensor_product(x, y, size=2)]
    (got,) = _both(build, {"x": xs, "y": ys}, tmp_path)
    block = fluid.default_main_program().global_block()
    wname = [v.name for v in block.all_parameters() if "w" in v.name][0]
    w = np.asarray(fluid.global_scope().get(wname))
    want = np.einsum("bm,kmn,bn->bk", xs, w, ys)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_pool_with_index_and_unpool_roundtrip(tmp_path):
    a = np.random.RandomState(0).rand(2, 1, 4, 4).astype(np.float32)

    def build(f, L, nets):
        x = L.data(name="x", shape=[1, 4, 4], dtype="float32")
        pooled, mask = L.pool2d_with_index(x, pool_size=2, pool_stride=2)
        return [pooled, mask, L.unpool(pooled, mask, ksize=2, strides=2)]
    got_p, got_m, got_r = _both(build, {"x": a}, tmp_path)
    want = np.zeros_like(a)
    for b in range(2):
        for i in range(2):
            for j in range(2):
                tile = a[b, 0, 2 * i:2 * i + 2, 2 * j:2 * j + 2]
                assert got_p[b, 0, i, j] == tile.max()
                fi = int(got_m[b, 0, i, j])
                assert a[b, 0].flat[fi] == tile.max()
                want[b, 0].flat[fi] = got_p[b, 0, i, j]
    np.testing.assert_allclose(got_r, want)


def test_spp_shapes_and_values(tmp_path):
    a = np.random.RandomState(0).rand(2, 3, 4, 4).astype(np.float32)

    def build(f, L, nets):
        x = L.data(name="x", shape=[3, 4, 4], dtype="float32")
        return [L.spp(x, pyramid_height=2, pool_type="max")]
    (got,) = _both(build, {"x": a}, tmp_path)
    assert got.shape == (2, 3 * (1 + 4))
    np.testing.assert_allclose(got[:, :3], a.max(axis=(2, 3)), rtol=1e-6)
    lvl1 = got[:, 3:].reshape(2, 3, 2, 2)
    for i in range(2):
        for j in range(2):
            np.testing.assert_allclose(
                lvl1[:, :, i, j],
                a[:, :, 2 * i:2 * i + 2, 2 * j:2 * j + 2].max(axis=(2, 3)),
                rtol=1e-6)


def _roi_build(rois_shape, pooled, scale=1.0, batch_id=False):
    def build(f, L, nets):
        x = L.data(name="x", shape=[1, 6, 6], dtype="float32")
        rois = L.data(name="rois", shape=rois_shape, dtype="float32")
        bid = (L.data(name="bid", shape=[1], dtype="int32",
                      append_batch_size=False) if batch_id else None)
        return [L.roi_pool(x, rois, pooled_height=pooled[0],
                           pooled_width=pooled[1], spatial_scale=scale,
                           rois_batch_id=bid)]
    return build


def test_roi_pool_simple(tmp_path):
    a = np.arange(36, dtype=np.float32).reshape(1, 1, 6, 6)
    r = np.array([[0.0, 0.0, 3.0, 3.0]], np.float32)
    (got,) = _both(_roi_build([4], (2, 2)), {"x": a, "rois": r}, tmp_path)
    img = a[0, 0, :4, :4]
    want = np.array([[img[:2, :2].max(), img[:2, 2:].max()],
                     [img[2:, :2].max(), img[2:, 2:].max()]], np.float32)
    np.testing.assert_allclose(got[0, 0], want)


def test_roi_pool_overlapping_bins(tmp_path):
    a = np.zeros((1, 1, 6, 6), np.float32)
    a[0, 0, 1, 1] = 100.0
    r = np.array([[0.0, 0.0, 2.0, 2.0]], np.float32)
    (got,) = _both(_roi_build([4], (2, 2)), {"x": a, "rois": r}, tmp_path)
    np.testing.assert_allclose(got[0, 0], np.full((2, 2), 100.0))


def test_roi_pool_rounds_half_to_even_and_empty_bins(tmp_path):
    """Coordinates at .5 (after spatial_scale 0.5) round half to even; a
    roi past the image leaves bins empty (0); two images by
    RoisBatchId."""
    a = np.random.RandomState(4).randn(2, 1, 6, 6).astype(np.float32)
    r = np.array([[1.0, 3.0, 5.0, 9.0], [3.0, 1.0, 7.0, 5.0],
                  [8.0, 8.0, 16.0, 16.0], [0.0, 0.0, 1.0, 1.0]], np.float32)
    bid = np.array([0, 1, 1, 0], np.int32)
    (got,) = _both(_roi_build([4], (3, 2), scale=0.5, batch_id=True),
                   {"x": a, "rois": r, "bid": bid}, tmp_path)
    # roi 0 rounds (0.5, 1.5, 2.5, 4.5) to (0, 2, 2, 4)
    np.testing.assert_allclose(got[0, 0, 0, 0], a[0, 0, 2, 0:2].max())
    # roi 2 starts at (4, 4) and its 5x5 extent leaves the image's edge
    assert (got[2, 0][np.isclose(got[2, 0], 0.0)]).size >= 1


def test_gru_unit_formula(tmp_path):
    bsz, hid = 2, 3
    rng = np.random.RandomState(0)
    xs = rng.randn(bsz, 3 * hid).astype(np.float32)
    hs = rng.randn(bsz, hid).astype(np.float32)

    def build(f, L, nets):
        inp = L.data(name="inp", shape=[3 * hid], dtype="float32")
        hprev = L.data(name="hprev", shape=[hid], dtype="float32")
        new_h, reset_h, _ = L.gru_unit(inp, hprev, size=3 * hid,
                                       bias_attr=False)
        return [new_h, reset_h]
    got_h, got_r = _both(build, {"inp": xs, "hprev": hs}, tmp_path)
    block = fluid.default_main_program().global_block()
    w = np.asarray(fluid.global_scope().get(block.all_parameters()[0].name))

    def sig(v):
        return 1 / (1 + np.exp(-v))

    ur = sig(xs[:, :2 * hid] + hs @ w[:, :2 * hid])
    u, r = ur[:, :hid], ur[:, hid:]
    c = np.tanh(xs[:, 2 * hid:] + (r * hs) @ w[:, 2 * hid:])
    np.testing.assert_allclose(got_h, (1 - u) * hs + u * c, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got_r, r * hs, rtol=1e-4, atol=1e-5)


def test_gru_unit_activations_by_number(tmp_path):
    """The reference's enum numbers: 3 relu for the candidate, 1 sigmoid
    for the gates."""
    rng = np.random.RandomState(1)
    xs = rng.randn(3, 12).astype(np.float32)
    hs = rng.randn(3, 4).astype(np.float32)

    def build(f, L, nets):
        inp = L.data(name="inp", shape=[12], dtype="float32")
        hprev = L.data(name="hprev", shape=[4], dtype="float32")
        new_h, reset_h, gate = L.gru_unit(inp, hprev, size=12, activation=3,
                                          gate_activation=1)
        return [new_h, reset_h, gate]
    _both(build, {"inp": xs, "hprev": hs}, tmp_path,
          grad_of=("inp", "hprev"))


def test_dynamic_lstmp_shapes_and_masking(tmp_path):
    bsz, t, hid, proj = 2, 4, 3, 2
    xs = np.random.RandomState(0).randn(bsz, t, 4 * hid).astype(np.float32)
    feed = {"x": xs, "x@SEQ_LEN": np.array([4, 2], np.int32)}

    def build(f, L, nets):
        x = L.data(name="x", shape=[t, 4 * hid], dtype="float32",
                   lod_level=1)
        return list(L.dynamic_lstmp(x, size=4 * hid, proj_size=proj,
                                    use_peepholes=False))
    got_p, got_c = _both(build, feed, tmp_path)
    assert got_p.shape == (bsz, t, proj) and got_c.shape == (bsz, t, hid)
    np.testing.assert_allclose(got_p[1, 2], got_p[1, 1])
    np.testing.assert_allclose(got_p[1, 3], got_p[1, 1])


def test_dynamic_lstmp_reverse_with_peepholes(tmp_path):
    """Time reversed, peepholes from Bias[4H:7H], relu projection, ragged
    lengths: fetches and the @GRADs of x and of every parameter."""
    bsz, t, hid, proj = 3, 5, 4, 3
    xs = np.random.RandomState(2).randn(bsz, t, 4 * hid).astype(np.float32)
    feed = {"x": xs, "x@SEQ_LEN": np.array([5, 2, 4], np.int32)}

    def build(f, L, nets):
        x = L.data(name="x", shape=[t, 4 * hid], dtype="float32",
                   lod_level=1)
        x.stop_gradient = False
        proj_out, cell = L.dynamic_lstmp(
            x, size=4 * hid, proj_size=proj, use_peepholes=True,
            is_reverse=True, proj_activation="relu")
        return [proj_out, cell]
    block_params = ("lstmp_0.w_0", "lstmp_0.w_1", "lstmp_0.b_0", "x")
    got = _both(build, feed, tmp_path, grad_of=block_params)
    # the reversed recurrence's last step is time 0: a padded step of a
    # short sequence keeps the state the later steps left
    np.testing.assert_allclose(got[0][1, 2:], np.zeros((3, proj)))
    assert np.abs(got[3 + 2]).sum() > 0          # the bias' gradient


def test_positive_negative_pair_counts(tmp_path):
    s = np.array([[0.9], [0.1], [0.3], [0.7], [0.7]], np.float32)
    lab = np.array([[2.0], [1.0], [3.0], [1.0], [2.0]], np.float32)
    q = np.array([[0], [0], [1], [1], [1]], np.int32)

    def build(f, L, nets):
        score = L.data(name="s", shape=[1], dtype="float32")
        label = L.data(name="l", shape=[1], dtype="float32")
        qid = L.data(name="q", shape=[1], dtype="int32")
        return list(L.positive_negative_pair(score, label, qid))
    got_p, got_n, got_u = _both(build, {"s": s, "l": lab, "q": q}, tmp_path)
    assert got_p[0] == 1.0 and got_n[0] == 3.0 and got_u[0] == 1.0


def test_positive_negative_pair_weighted(tmp_path):
    s = np.array([[0.9], [0.1], [0.3], [0.7], [0.7]], np.float32)
    lab = np.array([[2.0], [1.0], [3.0], [1.0], [2.0]], np.float32)
    q = np.array([[0], [0], [1], [1], [1]], np.int32)
    w = np.array([[1.0], [3.0], [2.0], [4.0], [6.0]], np.float32)

    def build(f, L, nets):
        score = L.data(name="s", shape=[1], dtype="float32")
        label = L.data(name="l", shape=[1], dtype="float32")
        qid = L.data(name="q", shape=[1], dtype="int32")
        wvar = L.data(name="w", shape=[1], dtype="float32")
        return list(L.positive_negative_pair(score, label, qid,
                                             weight=wvar))
    got_p, got_n, got_u = _both(build, {"s": s, "l": lab, "q": q, "w": w},
                                tmp_path)
    assert got_p[0] == 2.0
    assert got_n[0] == 3.0 + 4.0 + 5.0
    assert got_u[0] == 5.0


# ---------------------------------------------------------------------------
# the rules without a gradient path: ties, fill
# ---------------------------------------------------------------------------

def _tied(shape, seed):
    """Values from a small set, so that most windows hold tied maxima; a
    plane of -inf and a NaN-free run of equal values."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 3, shape).astype(np.float32)
    a[0, 0] = -np.inf
    a[-1, -1] = 2.0
    return a


POOL_CASES = [
    ("max_pool2d_with_index", (2, 2, 5, 6),
     {"ksize": [3, 2], "strides": [2, 1], "paddings": [1, 0]}),
    ("max_pool2d_with_index", (1, 3, 4, 4),
     {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0],
      "global_pooling": True}),
    ("max_pool3d_with_index", (1, 2, 4, 5, 3),
     {"ksize": [2, 3, 2], "strides": [1, 2, 1], "paddings": [1, 1, 0]}),
]


@pytest.mark.parametrize("op,shape,attrs", POOL_CASES,
                         ids=["2d_pad_overlap", "2d_global", "3d_pad"])
def test_pool_with_index_ties_take_the_first_maximum(op, shape, attrs):
    """Out equal and Mask identical (int32) to the JAX reducer's on tied
    windows; each Mask points at a maximum of its window, the first one
    in row-major window order."""
    x = _tied(shape, 5)
    (out, mask), _ = _one_op(op, {"X": x}, attrs, ("Out", "Mask"))
    assert mask.dtype == np.int32
    flat = x.reshape(shape[:2] + (-1,))
    picked = np.take_along_axis(flat, mask.reshape(shape[:2] + (-1,)),
                                axis=2)
    np.testing.assert_array_equal(picked.reshape(out.shape), out)


def test_fill():
    got, _ = _one_op("fill", {}, {"value": [1, -2, 3, 4, 5, 6],
                                  "shape": [2, 3], "dtype": "int32"},
                     ("Out",))
    np.testing.assert_array_equal(got[0], [[1, -2, 3], [4, 5, 6]])


# ---------------------------------------------------------------------------
# nets.scaled_dot_product_attention variants
# ---------------------------------------------------------------------------

ATTN = {"cross": dict(num_heads=4, cross=True),
        "single_head": dict(num_heads=1, cross=False),
        "single_head_chain": dict(num_heads=1, cross=False, fused=False),
        "multi_head_chain": dict(num_heads=4, cross=False, fused=False),
        "cross_causal": dict(num_heads=2, cross=True, causal=True)}


def _attn_build(num_heads, cross, fused=True, causal=False, dropout=0.0):
    def build(f, L, nets):
        q = L.data(name="q", shape=[5, 16], dtype="float32")
        q.stop_gradient = False
        kv = L.data(name="kv", shape=[7, 16], dtype="float32") if cross \
            else q
        out = nets.scaled_dot_product_attention(
            q, kv, kv, num_heads=num_heads, dropout_rate=dropout,
            causal=causal, use_fused=fused)
        return [out]
    return build


def _attn_feed():
    rng = np.random.RandomState(7)
    return {"q": rng.randn(3, 5, 16).astype(np.float32),
            "kv": rng.randn(3, 7, 16).astype(np.float32)}


@pytest.mark.parametrize("case", sorted(ATTN))
def test_attention_variants_equal_at_dropout_zero(case, tmp_path):
    """Cross-attention (three fcs), one head ([B, 1, T, D] reshapes), the
    scale/matmul/softmax/matmul chain: equal programs, outputs and the
    query's @GRAD."""
    kw = ATTN[case]
    feed = _attn_feed()
    if not kw["cross"]:
        feed.pop("kv")
    got = _both(_attn_build(**kw), feed, tmp_path, grad_of=("q",))
    assert got[0].shape == (3, 5, 16)


@pytest.mark.parametrize("num_heads", [1, 4])
def test_attention_dropout_chain_scales_under_is_test(num_heads, tmp_path):
    """At dropout 0.35 the chain carries a dropout op; the for_test clone
    scales the weights by 0.65 in both packages (no mask drawn)."""
    feed = _attn_feed()
    feed.pop("kv")
    _both(_attn_build(num_heads, False, dropout=0.35), feed, tmp_path,
          for_test=True)
    types = [op.type for op in fluid.default_main_program()
             .global_block().ops]
    assert "dropout" in types and "fused_attention" not in types


def test_attention_refuses_causal_dropout_and_cached_dropout():
    q = players.data(name="q", shape=[5, 16], dtype="float32")
    with pytest.raises(ValueError):
        pnets.scaled_dot_product_attention(q, q, q, num_heads=2,
                                           dropout_rate=0.1, causal=True)
    with pytest.raises(ValueError):
        pnets.scaled_dot_product_attention(q, q, q, num_heads=2,
                                           dropout_rate=0.1, cache=object())
