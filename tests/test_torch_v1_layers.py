"""The port's v1 config DSL, ``trainer_config_helpers`` (twins of
tests/test_v1_layer_tail.py, tests/test_v1_evaluators.py,
tests/test_cross_entropy_over_beam.py and the two v1 tests of
tests/test_beam_search.py).

Each twin builds the same v1 graph through both packages, checks that
the two front ends emit the same Program JSON, runs the port from the
JAX startup's state on the same feeds and holds every fetch to the JAX
package's at 1e-4 (whole models, ROADMAP); the graphs trained through
``paddle.trainer.SGD`` start the port from the JAX ``parameters`` tar.
Discrete outputs (ids, indices, files) are equal.  Ops that draw random
numbers (``nce``'s negatives) are compared by shape and finiteness only:
the JAX and torch streams never match.

Beyond the JAX tests: the ``print_grad`` hook prints the cotangent the
JAX probe prints, and ``detection_output_layer`` without prior-box
variances runs in the port, where the JAX package raises
``AttributeError`` (it calls a ``layers.fill_zeros_like`` that does not
exist).
"""
import inspect
import re

import numpy as np
import pytest
import torch

from paddle_tpu.ops.beam_ops import _beam_training_cost
from paddle_tpu.ops.beam_ops import _ceob_batch as _jceob_batch

from paddle_tpu_torch.ops.beam_ops import BeamTrainingCost, _ceob_batch

from _torch_legacy_twins import (JAX, PORT, assert_close, assert_twins,
                                 assert_v2_twins, fresh, jax_state,
                                 load_into_port, run_graph, same_program,
                                 v2_twins)


@pytest.fixture(autouse=True)
def _fresh():
    fresh()
    yield


def _seq(dtype="float32", seq_type=1):
    """An ad-hoc input-type spec, as the JAX tests declare them."""
    return type("T", (), {"seq_type": seq_type, "dtype": dtype})()


def _numbers(text, prefix):
    """Every number printed after ``prefix``: on its line and on the
    indented lines that continue a multi-line array."""
    out, on = [], False
    for line in text.splitlines():
        if line.startswith(prefix):
            on, line = True, line[len(prefix):]
        elif not (on and line.startswith(" ")):
            on = False
        if on:
            out += [float(t) for t in re.findall(
                r"-?\d+\.?\d*(?:e[-+]?\d+)?", line)]
    return np.asarray(out)


# ---------------------------------------------------------------------------
# tests/test_v1_layer_tail.py: recurrent groups through the v2 trainer
# ---------------------------------------------------------------------------

def _seq_reader():
    """64 ragged id sequences; the first of each batch of 16 is of length
    9, so every batch pads to one shape (the JAX package compiles a step
    for each)."""
    rng = np.random.RandomState(0)

    def reader():
        for i in range(64):
            T = rng.randint(3, 10)
            T = 9 if i % 16 == 0 else T
            y = i % 2
            toks = rng.randint(0, 25, T) + (25 if y else 0)
            yield toks.astype("int64"), y
    return reader


def _train_seq_model(make_recurrence, passes=8, thresh=0.7):
    def build(pk):
        paddle = pk.v2
        data = paddle.layer.data(
            name="word", type=paddle.data_type.integer_value_sequence(50))
        label = paddle.layer.data(name="label",
                                  type=paddle.data_type.integer_value(2))
        emb = paddle.layer.embedding(input=data, size=16)
        last = paddle.layer.last_seq(input=make_recurrence(pk, emb, 16))
        pred = paddle.layer.fc(input=last, size=2,
                               act=paddle.activation.Softmax())
        return (paddle.layer.classification_cost(input=pred, label=label),)

    res = v2_twins(build, _seq_reader, lambda pk: pk.v2.optimizer.Adam(
        learning_rate=0.02), 16, passes)
    assert res.port.costs[-1] < res.port.costs[0] * thresh
    assert_v2_twins(res)


def test_lstmemory_group_trains_via_v2_trainer():
    _train_seq_model(lambda pk, emb, hid: pk.N.lstmemory_group(input=emb,
                                                               size=hid))


def test_gru_group_trains_via_v2_trainer():
    _train_seq_model(lambda pk, emb, hid: pk.N.simple_gru2(input=emb,
                                                           size=hid))


def test_recurrent_layer_trains():
    def rec(pk, emb, hid):
        proj = pk.L.fc_layer(input=emb, size=hid,
                             act=pk.A.LinearActivation())
        return pk.L.recurrent_layer(input=proj)
    _train_seq_model(rec)


def test_bidirectional_gru_builds():
    def build(pk):
        data = pk.v2.layer.data(
            name="word", type=pk.v2.data_type.integer_value_sequence(30))
        emb = pk.v2.layer.embedding(input=data, size=8)
        return [pk.N.bidirectional_gru(input=emb, size=8)]
    rng = np.random.RandomState(1)
    outs = run_graph(build, {"word": rng.randint(0, 30, (3, 5)),
                             "word@SEQ_LEN": np.array([5, 2, 4], np.int32)})
    assert outs[1][0].shape == (3, 16)
    assert_twins(outs)


# ---------------------------------------------------------------------------
# the wrapper tail
# ---------------------------------------------------------------------------

def test_elementwise_wrapper_tail():
    def build(pk):
        L = pk.L
        x = L.data_layer("x", size=6)
        y = L.data_layer("y", size=6)
        return [
            L.clip_layer(x, min=-0.5, max=0.5),
            L.dot_prod_layer(x, y),
            L.out_prod_layer(x, y),
            L.l2_distance_layer(x, y),
            L.row_l2_norm_layer(x),
            L.sum_to_one_norm_layer(L.clip_layer(x, min=0.1, max=2.0)),
            L.scale_shift_layer(x),
            L.resize_layer(x, size=3),
            L.repeat_layer(x, num_repeats=2),
            L.linear_comb_layer(weights=L.data_layer("w2", size=2),
                                vectors=L.data_layer("v6", size=6), size=3),
            L.tensor_layer(a=x, b=y, size=4),
            L.gated_unit_layer(x, size=5),
            L.factorization_machine(x, factor_size=3),
        ]
    rng = np.random.RandomState(0)
    feeds = {"x": rng.rand(2, 6).astype(np.float32),
             "y": rng.rand(2, 6).astype(np.float32),
             "w2": rng.rand(2, 2).astype(np.float32),
             "v6": rng.rand(2, 6).astype(np.float32)}
    outs = run_graph(build, feeds)
    want_shapes = [(2, 6), (2, 1), (2, 36), (2, 1), (2, 6), (2, 6), (2, 6),
                   (4, 3), (2, 12), (2, 3), (2, 4), (2, 5), (2, 1)]
    assert [o.shape for o in outs[1]] == want_shapes
    assert_twins(outs)
    np.testing.assert_allclose(outs[1][0], np.clip(feeds["x"], -0.5, 0.5),
                               atol=1e-6)
    np.testing.assert_allclose(outs[1][1].ravel(),
                               (feeds["x"] * feeds["y"]).sum(1), rtol=1e-5)
    np.testing.assert_allclose(outs[1][5].sum(1), np.ones(2), rtol=1e-5)


def test_image_wrapper_tail():
    def build(pk):
        L = pk.L
        img = L.data_layer("img", size=2 * 6 * 6, height=6, width=6)
        return [
            L.pad_layer(img, pad_c=[1, 0], pad_h=[0, 1], pad_w=[1, 1]),
            L.maxout_layer(L.img_conv_layer(img, filter_size=3,
                                            num_filters=4, padding=1),
                           groups=2),
            L.rotate_layer(img, height=6, width=6),
            L.switch_order_layer(img),
            L.bilinear_interp_layer(img, out_size_x=12, out_size_y=12),
            L.upsample_layer(img, scale=2),
            L.block_expand_layer(img, block_x=3, block_y=3, stride_x=3,
                                 stride_y=3),
            L.spp_layer(img, pyramid_height=2),
            L.prelu_layer(img),
            L.cross_channel_norm_layer(img),
        ]
    rng = np.random.RandomState(1)
    outs = run_graph(build, {"img": rng.rand(2, 2, 6, 6).astype(np.float32)})
    got = outs[1]
    assert got[0].shape == (2, 3, 7, 8)
    assert got[1].shape == (2, 2, 6, 6)
    assert got[4].shape == (2, 2, 12, 12)
    assert got[6].shape[1] == 4
    assert got[7].shape == (2, 2 * 5)
    assert_twins(outs)


def test_sequence_wrapper_tail():
    def build(pk):
        L = pk.L
        seq = L.data_layer("s", size=4, type=_seq())
        return [
            L.seq_reshape_layer(seq, reshape_size=2),
            L.kmax_seq_score_layer(L.fc_layer(
                seq, size=1, act=pk.A.LinearActivation()), beam_size=2),
            L.row_conv_layer(seq, context_len=2),
        ]
    rng = np.random.RandomState(2)
    outs = run_graph(build, {"s": rng.rand(2, 4, 4).astype(np.float32),
                             "s@SEQ_LEN": np.array([4, 3], np.int32)})
    assert outs[1][0].shape == (2, 8, 2)
    assert outs[1][2].shape == (2, 4, 4)
    assert np.array_equal(outs[1][1], outs[0][1])      # top-k indices
    assert_twins(outs)


def test_cost_tail():
    def build(pk):
        L = pk.L
        x = L.data_layer("x", size=4)
        y = L.data_layer("y", size=4)
        lab1 = L.data_layer("l1", size=1, type=_seq("int64", 0))
        left = L.data_layer("left", size=1)
        right = L.data_layer("right", size=1)
        lab01 = L.data_layer("l01", size=1)
        return [
            L.rank_cost(left=left, right=right, label=lab01),
            L.huber_regression_cost(input=left, label=right),
            L.huber_classification_cost(input=left, label=lab01),
            L.smooth_l1_cost(input=x, label=y),
            L.multi_binary_label_cross_entropy(
                input=L.fc_layer(x, size=4, act=pk.A.SigmoidActivation()),
                label=y),
            L.cross_entropy_with_selfnorm(input=L.fc_layer(
                x, size=3, act=pk.A.LinearActivation()), label=lab1),
            L.lambda_cost(input=L.data_layer("sc", size=5),
                          score=L.data_layer("rel", size=5)),
        ]
    rng = np.random.RandomState(3)
    feeds = {"x": rng.rand(4, 4).astype(np.float32),
             "y": rng.rand(4, 4).astype(np.float32),
             "l1": rng.randint(0, 3, (4, 1)).astype(np.int64),
             "left": rng.rand(4, 1).astype(np.float32),
             "right": rng.rand(4, 1).astype(np.float32),
             "l01": rng.randint(0, 2, (4, 1)).astype(np.float32),
             "sc": rng.rand(4, 5).astype(np.float32),
             "rel": rng.rand(4, 5).astype(np.float32)}
    outs = run_graph(build, feeds)
    assert all(np.isfinite(o).all() for o in outs[1])
    assert_twins(outs)


def test_mixed_layer_context_manager_and_projections():
    def build(pk):
        L = pk.L
        x = L.data_layer("x", size=6)
        with L.mixed_layer(size=6, act=pk.A.LinearActivation()) as m:
            m += L.identity_projection(x)
            m += L.dotmul_projection(x)
        sliced = L.mixed_layer(
            input=[L.slice_projection(x, slices=[(0, 2), (4, 6)])],
            size=4, act=pk.A.LinearActivation())
        op = L.mixed_layer(input=[L.dotmul_operator(a=x, b=x, scale=2.0)],
                           size=6, act=pk.A.LinearActivation())
        return [m, sliced, op]
    xv = np.random.RandomState(4).rand(3, 6).astype(np.float32)
    outs = run_graph(build, {"x": xv})
    assert outs[1][0].shape == (3, 6)
    np.testing.assert_allclose(outs[1][1], np.concatenate(
        [xv[:, 0:2], xv[:, 4:6]], 1), atol=1e-6)
    np.testing.assert_allclose(outs[1][2], 2 * xv * xv, rtol=1e-5)
    assert_twins(outs)


def test_hsigmoid_and_nce_layers_build():
    def build(pk):
        L = pk.L
        x = L.data_layer("x", size=8)
        lab = L.data_layer("l", size=1, type=_seq("int64", 0))
        return [L.hsigmoid(input=x, label=lab, num_classes=6),
                L.nce_layer(input=x, label=lab, num_classes=6,
                            num_neg_samples=2)]
    rng = np.random.RandomState(5)
    outs = run_graph(build, {"x": rng.rand(4, 8).astype(np.float32),
                             "l": rng.randint(0, 6, (4, 1)).astype(np.int64)})
    assert_close(outs[1][0], outs[0][0], what="hsigmoid")
    # nce draws its negatives: shape and finiteness only
    assert outs[1][1].shape == outs[0][1].shape
    assert all(np.isfinite(o).all() for o in outs[1])


def test_context_projection_matches_shifted_concat():
    def build(pk):
        seq = pk.L.data_layer("s", size=3, type=_seq())
        return [pk.L.mixed_layer(
            input=[pk.L.context_projection(seq, context_len=3)],
            size=9, act=pk.A.LinearActivation())]
    sv = np.random.RandomState(6).rand(1, 4, 3).astype(np.float32)
    outs = run_graph(build, {"s": sv, "s@SEQ_LEN": np.array([4], np.int32)})
    got = outs[1][0]
    assert got.shape == (1, 4, 9)
    np.testing.assert_allclose(got[0, :, 3:6], sv[0], atol=1e-6)
    np.testing.assert_allclose(got[0, 0, 0:3], np.zeros(3), atol=1e-6)
    assert_twins(outs)


def test_recurrent_group_reverse_matches_grumemory():
    T, D, H = 5, 6, 4

    def build(pk):
        L, fluid = pk.L, pk.fluid
        x = L.data_layer("x", size=D, type=_seq())
        fc = L.fc_layer(input=x, size=3 * H, act=pk.A.LinearActivation(),
                        param_attr=fluid.ParamAttr(name="wx"),
                        bias_attr=False)
        return [pk.N.gru_group(input=fc, size=H,
                               gru_param_attr=fluid.ParamAttr(name="wh"),
                               gru_bias_attr=False, reverse=rev,
                               name=f"g_{int(rev)}") for rev in (False, True)]
    xv = np.random.RandomState(8).rand(2, T, D).astype(np.float32)
    outs = run_graph(build, {"x": xv, "x@SEQ_LEN": np.array([T, 3],
                                                            np.int32)})
    assert not np.allclose(outs[1][0][0], outs[1][1][0]), \
        "reverse had no effect"
    assert_twins(outs)


def test_clip_global_norm_with_sparse_grad():
    rng = np.random.RandomState(0)
    feed = {"ids": rng.randint(0, 30, (4, 4)).astype(np.int64),
            "y": rng.randn(4, 8).astype(np.float32)}
    got = {}
    for pk in (JAX, PORT):
        FL, fluid = pk.layers, pk.fluid
        ids = FL.data("ids", shape=[4], dtype="int64")
        y = FL.data("y", shape=[8], dtype="float32")
        emb = FL.embedding(input=ids, size=[30, 8], is_sparse=True,
                           param_attr=fluid.ParamAttr(name="tbl"))
        h = FL.fc(FL.reduce_mean(emb, dim=1), size=8)
        cost = FL.mean(FL.square_error_cost(h, y))
        fluid.clip.set_gradient_clip(
            fluid.clip.GradientClipByGlobalNorm(clip_norm=1.0))
        fluid.optimizer.SGD(0.1).minimize(cost)
        exe = fluid.Executor(pk.place)
        exe.run(fluid.default_startup_program())
        if pk is JAX:
            state = jax_state()
        else:
            load_into_port(state)
        got[pk.name] = [float(exe.run(feed=feed, fetch_list=[cost])[0])
                        for _ in range(2)]
        got[pk.name + "_tbl"] = np.asarray(fluid.global_scope().get("tbl"))
    same_program()
    assert np.isfinite(got["port"]).all()
    assert_close(got["port"], got["jax"], what="costs")
    assert_close(got["port_tbl"], got["jax_tbl"], what="tbl")


def _detection_graph(pk, variance, keep_aux=True):
    """A tiny SSD head over an 8x8 map; without ``keep_aux`` the prior
    box carries no variances and detection_output_layer makes its
    defaults (0.1 each)."""
    L = pk.L
    n_priors = 8 * 8 * 2
    img = L.data_layer("img", size=3 * 8 * 8, height=8, width=8)
    conv = L.img_conv_layer(img, filter_size=3, num_filters=8, padding=1)
    pb = L.priorbox_layer(conv, img, aspect_ratio=[2.0], variance=variance,
                          min_size=[4.0])
    if not keep_aux:
        pb.extra["aux"].pop("variances")
    loc = L.fc_layer(img, size=n_priors * 4, act=pk.A.LinearActivation())
    conf = L.fc_layer(img, size=n_priors * 21, act=pk.A.LinearActivation())
    F = pk.layers
    return [L.detection_output_layer(
        input_loc=L.LayerOutput(
            "loc3d", "reshape", [loc], size=4,
            build=lambda p: F.reshape(p[0], [-1, n_priors, 4])),
        # class scores [B, C, M], a softmax over the classes of a prior
        input_conf=L.LayerOutput(
            "conf3d", "reshape", [conf], size=21,
            build=lambda p: F.transpose(F.softmax(
                F.reshape(p[0], [-1, n_priors, 21])), perm=[0, 2, 1])),
        priorbox=pb, num_classes=21)]


def test_detection_wrappers_build_and_run():
    rng = np.random.RandomState(1)
    outs = run_graph(lambda pk: _detection_graph(pk, [0.1, 0.1, 0.2, 0.2]),
                     {"img": rng.rand(2, 3, 8, 8).astype(np.float32)})
    assert outs[1][0].ndim >= 2
    # rows (label, score, box): labels equal, the rest within 1e-4
    assert np.array_equal(outs[1][0][..., 0], outs[0][0][..., 0])
    assert_twins(outs)


def test_detection_output_without_variances():
    """Default SSD variances through the registered fill_zeros_like rule:
    the port's output equals that of the same head whose prior box
    carries variances of 0.1.  The JAX layer calls a
    layers.fill_zeros_like that does not exist."""
    tenths = [0.1, 0.1, 0.1, 0.1]
    with pytest.raises(AttributeError, match="fill_zeros_like"):
        JAX.L.parse_network(*_detection_graph(JAX, tenths, keep_aux=False))
    img = np.random.RandomState(1).rand(2, 3, 8, 8).astype(np.float32)
    got = []
    for keep in (False, True):
        fresh()
        (det,) = PORT.L.parse_network(*_detection_graph(PORT, tenths, keep))
        types = [op.type for op in
                 PORT.fluid.default_main_program().global_block().ops]
        assert ("fill_zeros_like" in types) is not keep
        exe = PORT.fluid.Executor(PORT.place)
        exe.run(PORT.fluid.default_startup_program())
        scope = PORT.fluid.global_scope()
        if not keep:
            state = {n: scope.get(n).clone() for n in scope.local_var_names()}
        else:
            for n, v in state.items():
                scope.set(n, v)
        got.append(exe.run(feed={"img": img}, fetch_list=[det])[0])
    assert got[0].ndim == 3 and got[0].shape[-1] == 6
    assert np.array_equal(got[0], got[1])


def test_fluid_style_step_still_works():
    def build(pk):
        x = pk.L.data_layer("x", size=4, type=_seq())
        return [pk.L.recurrent_group(
            lambda xt: pk.layers.scale(xt, scale=2.0), [x])]
    xv = np.random.RandomState(2).rand(2, 3, 4).astype(np.float32)
    outs = run_graph(build, {"x": xv, "x@SEQ_LEN": np.array([3, 2],
                                                            np.int32)})
    np.testing.assert_allclose(outs[1][0][0], 2 * xv[0], atol=1e-6)
    assert_twins(outs)


def test_sub_nested_seq_layer_reference_signature():
    def build(pk):
        L = pk.L
        seq = L.data_layer("ns", size=3, type=_seq(seq_type=2))
        sel = L.data_layer("sel", size=1, type=_seq("int64", 0))
        out = L.sub_nested_seq_layer(input=seq, selected_indices=sel)
        return [out, L.last_seq(input=out)]
    for pk in (JAX, PORT):
        assert "selected_indices" in inspect.signature(
            pk.L.sub_nested_seq_layer).parameters
    rng = np.random.RandomState(7)
    data = rng.rand(4, 5, 3).astype(np.float32)
    outs = run_graph(build, {"ns": data,
                             "ns@SEQ_LEN": np.array([5, 2, 4, 1], np.int32),
                             "sel": np.array([2, 0], np.int64)})
    np.testing.assert_allclose(outs[1][0], data[[2, 0]])
    np.testing.assert_allclose(outs[1][1], np.stack([data[2, 3],
                                                     data[0, 4]]), rtol=1e-6)
    assert_twins(outs)


def test_warp_ctc_layer_reference_kwargs():
    T = 8
    rng = np.random.RandomState(8)
    feeds = {"lg": rng.rand(2, T, 6).astype(np.float32),
             "lg@SEQ_LEN": np.array([T, T - 2], np.int32),
             "lab": rng.randint(0, 5, (2, 3)).astype(np.int64),
             "lab@SEQ_LEN": np.array([3, 2], np.int32)}

    def build(norm):
        def b(pk):
            L = pk.L
            logits = L.data_layer("lg", size=6, type=_seq())
            lab = L.data_layer("lab", size=1, type=_seq("int64"))
            kw = {"size": 6, "norm_by_times": True} if norm else {}
            return [L.warp_ctc_layer(input=logits, label=lab, blank=5, **kw)]
        return b
    normed = run_graph(build(True), feeds)
    plain = run_graph(build(False), feeds)
    assert np.isfinite(normed[1][0]).all()
    assert_twins(normed)
    assert_twins(plain)
    # norm_by_times scales the gradient, not the loss (warpctc_op.cc:85)
    np.testing.assert_allclose(plain[1][0], normed[1][0], rtol=1e-6)
    for pk in (JAX, PORT):
        logits = pk.L.data_layer("lg", size=6, type=_seq())
        lab = pk.L.data_layer("lab", size=1, type=_seq("int64"))
        with pytest.raises(ValueError):
            pk.L.warp_ctc_layer(input=logits, label=lab, size=99)


def test_warpctc_norm_by_times_scales_gradient_only():
    B, T, C = 2, 6, 5

    def run(pk, norm):
        fluid, layers = pk.fluid, pk.layers
        fluid.core.program.reset_default_programs()
        fluid.global_scope().clear()
        rng = np.random.RandomState(9)
        logits = layers.create_parameter(shape=[B, T, C], dtype="float32",
                                         name="ctc_logits")
        loss = layers.warpctc(input=logits, label=layers.data(
            name="lab", shape=[1], dtype="int64", lod_level=1),
            blank=C - 1, norm_by_times=norm)
        avg = layers.mean(loss)
        fluid.backward.append_backward(avg)
        exe = fluid.Executor(pk.place)
        exe.run(fluid.default_startup_program())
        if pk is JAX:
            run.state = jax_state()
        else:
            load_into_port(run.state)
        outs = exe.run(fluid.default_main_program(),
                       feed={"lab": rng.randint(0, C - 1, (B, 3))
                             .astype(np.int64),
                             "lab@SEQ_LEN": np.array([3, 2], np.int32)},
                       fetch_list=[avg, "ctc_logits@GRAD"])
        return float(np.asarray(outs[0])), np.asarray(outs[1])

    for norm in (False, True):
        j = run(JAX, norm)
        p = run(PORT, norm)
        assert_close(p[0], j[0], what="loss")
        assert_close(p[1], j[1], what="grad")
        if not norm:
            loss_plain, g_plain = p
    np.testing.assert_allclose(loss_plain, p[0], rtol=1e-6)
    np.testing.assert_allclose(p[1], g_plain / 6.0, rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------------------
# tests/test_v1_evaluators.py
# ---------------------------------------------------------------------------

REF_EVALUATORS = [
    "evaluator_base", "classification_error_evaluator", "auc_evaluator",
    "pnpair_evaluator", "precision_recall_evaluator",
    "ctc_error_evaluator", "chunk_evaluator", "sum_evaluator",
    "column_sum_evaluator", "value_printer_evaluator",
    "gradient_printer_evaluator", "maxid_printer_evaluator",
    "maxframe_printer_evaluator", "seqtext_printer_evaluator",
    "classification_error_printer_evaluator", "detection_map_evaluator",
]


def test_all_reference_wrappers_present():
    assert not [n for n in REF_EVALUATORS if not hasattr(PORT.E, n)]
    assert PORT.E.__all__ == JAX.E.__all__
    for n in REF_EVALUATORS:       # the @evaluator category masks
        assert (getattr(getattr(PORT.E, n), "for_attr", None)
                == getattr(getattr(JAX.E, n), "for_attr", None)), n


def _dense(pk, name, n):
    return pk.L.data_layer(name=name, size=n,
                           type=pk.v2.data_type.dense_vector(n))


def _ids(pk, name, n, seq=False):
    t = (pk.v2.data_type.integer_value_sequence(n) if seq
         else pk.v2.data_type.integer_value(n))
    return pk.L.data_layer(name=name, size=1, type=t)


def test_pnpair_evaluator_ratio():
    outs = run_graph(lambda pk: [pk.E.pnpair_evaluator(
        _dense(pk, "score", 1), _dense(pk, "lbl", 1), _ids(pk, "qid", 10))], {
        "score": np.array([[0.9], [0.1], [0.5]], np.float32),
        "lbl": np.array([[2.0], [1.0], [0.0]], np.float32),
        "qid": np.array([[0], [0], [0]], np.int64)})
    assert abs(float(outs[1][0].reshape(-1)[0]) - 2.0) < 1e-4
    assert_twins(outs)


def test_ctc_error_evaluator_edit_distance():
    outs = run_graph(lambda pk: [pk.E.ctc_error_evaluator(
        input=_ids(pk, "hyp", 10, True), label=_ids(pk, "ref", 10, True))], {
        "hyp": np.array([[1, 2, 3]], np.int64),
        "hyp@SEQ_LEN": np.array([3], np.int32),
        "ref": np.array([[1, 3, 3]], np.int64),
        "ref@SEQ_LEN": np.array([3], np.int32)})
    assert abs(float(outs[1][0]) - 1.0 / 3.0) < 1e-5
    assert_twins(outs)


def test_sum_and_column_sum_evaluators():
    def build(pk):
        x = _dense(pk, "x", 3)
        return [pk.E.sum_evaluator(x), pk.E.column_sum_evaluator(x)]
    outs = run_graph(build, {"x": np.array([[1., 2., 3.], [4., 5., 6.]],
                                           np.float32)})
    assert abs(float(outs[1][0]) - 21.0) < 1e-5
    np.testing.assert_allclose(outs[1][1].reshape(-1), [5., 7., 9.],
                               rtol=1e-6)
    assert_twins(outs)


def test_classification_error_evaluator_value():
    eye = np.eye(4, dtype=np.float32)
    outs = run_graph(lambda pk: [pk.E.classification_error_evaluator(
        input=_dense(pk, "p", 4), label=_ids(pk, "l", 4))],
        {"p": eye[[0, 1, 2]], "l": np.array([[0], [1], [3]], np.int64)})
    assert abs(float(outs[1][0].reshape(-1)[0]) - 1.0 / 3.0) < 1e-5
    assert_twins(outs)


def test_printer_evaluators_run(capfd):
    def build(pk):
        x = _dense(pk, "x", 4)
        return [pk.E.value_printer_evaluator(x),
                pk.E.maxid_printer_evaluator(x, num_results=2)]
    capfd.readouterr()
    outs = run_graph(build, {"x": np.array([[0.1, 0.9, 0.3, 0.5]],
                                           np.float32)})
    text = capfd.readouterr()
    text = text.out + text.err
    assert_twins(outs)
    assert np.array_equal(outs[1][1], outs[0][1])
    # each package printed the value and the top-2 ids once
    for prefix, want in (("[value_printer] x:", [0.1, 0.9, 0.3, 0.5]),
                         ("[maxid_printer] x top2:", [1, 3])):
        got = _numbers(text, prefix)
        assert len(got) == 2 * len(want), (prefix, text)
        np.testing.assert_allclose(got, want * 2, rtol=1e-6)


def _grad_printer_net(pk):
    x = _dense(pk, "x", 2)
    h = pk.L.fc_layer(input=x, size=2)
    g = pk.E.gradient_printer_evaluator(h)        # no rewiring: pred uses h
    pred = pk.L.fc_layer(input=h, size=2, act=pk.A.SoftmaxActivation())
    cost = pk.L.classification_cost(input=pred, label=_ids(pk, "l", 2))
    return cost, g


def test_gradient_printer_flows_grad(capfd):
    """The port prints the cotangent reaching the flagged var, the one the
    JAX probe prints, and the step's cost and parameters match."""
    feed = {"x": np.array([[1.0, -1.0], [0.5, 2.0]], np.float32),
            "l": np.array([[1], [0]], np.int64)}
    got = {}
    for pk in (JAX, PORT):
        cost_v, h_v = pk.L.parse_network(*_grad_printer_net(pk))
        assert h_v.desc.print_grad is True
        pk.fluid.optimizer.SGD(learning_rate=0.1).minimize(cost_v)
        exe = pk.fluid.Executor(pk.place)
        exe.run(pk.fluid.default_startup_program())
        if pk is JAX:
            state = jax_state()
        else:
            load_into_port(state)
        capfd.readouterr()
        out = exe.run(pk.fluid.default_main_program(), feed=feed,
                      fetch_list=[cost_v])
        text = capfd.readouterr()
        got[pk.name] = (float(out[0]),
                        _numbers(text.out + text.err, "[gradient_printer]"))
    same_program()
    assert np.isfinite(got["port"][0])
    assert_close(got["port"][0], got["jax"][0], what="cost")
    assert got["port"][1].size == got["jax"][1].size == 4, got
    assert_close(got["port"][1], got["jax"][1], what="cotangent")
    # the flag is not serialised: the JSON stays the JAX package's
    prog = PORT.fluid.default_main_program()
    assert all("print_grad" not in v
               for v in prog.to_dict()["blocks"][0]["vars"])


def test_print_grad_hook_returns_the_cotangent_unchanged():
    """The hook only prints: the gradients with the flag set are those of
    the same program without it."""
    feed = {"x": np.array([[1.0, -1.0]], np.float32),
            "l": np.array([[1]], np.int64)}
    grads = []
    for flag in (True, False):
        fresh()
        cost_v, h_v = PORT.L.parse_network(*_grad_printer_net(PORT))
        h_v.desc.print_grad = flag
        PORT.fluid.optimizer.SGD(learning_rate=0.1).minimize(cost_v)
        exe = PORT.fluid.Executor(PORT.place)
        torch.manual_seed(0)
        exe.run(PORT.fluid.default_startup_program())
        params = [p.name for p in
                  PORT.fluid.default_main_program().all_parameters()]
        if flag:
            scope = PORT.fluid.global_scope()
            state = {n: scope.get(n).clone() for n in params}
        else:
            load_into_port(state)
        grads.append(exe.run(feed=feed,
                             fetch_list=[n + "@GRAD" for n in params]))
    for a, b in zip(*grads):
        assert np.array_equal(a, b)


def test_seqtext_printer_writes_file(tmp_path):
    dict_file = tmp_path / "dict.txt"
    dict_file.write_text("the\ncat\nsat\nmat\n")
    files = {pk.name: tmp_path / f"out_{pk.name}.txt" for pk in (JAX, PORT)}
    run_graph(lambda pk: [pk.E.seqtext_printer_evaluator(
        input=_ids(pk, "ids", 4, True), result_file=str(files[pk.name]),
        dict_file=str(dict_file))],
        {"ids": np.array([[0, 1, 2], [3, 2, 0]], np.int64),
         "ids@SEQ_LEN": np.array([3, 2], np.int32)}, same_json=False)
    text = files["port"].read_text()
    assert "the cat sat" in text
    assert text == files["jax"].read_text()


def test_classification_error_printer_runs():
    outs = run_graph(lambda pk: [pk.E.classification_error_printer_evaluator(
        _dense(pk, "p", 1), _dense(pk, "l", 1), threshold=0.5)],
        {"p": np.array([[0.9]], np.float32),
         "l": np.array([[0.0]], np.float32)})
    assert float(outs[1][0].reshape(-1)[0]) == 1.0
    assert_twins(outs)


def test_evaluator_base_passthrough():
    outs = run_graph(lambda pk: [pk.E.evaluator_base(
        input=_dense(pk, "x", 2), type="custom_metric", coeff=2.0)],
        {"x": np.array([[3.0, 4.0]], np.float32)})
    np.testing.assert_allclose(outs[1][0], [[3.0, 4.0]])
    assert_twins(outs)


def test_scale_sub_region_layer():
    def build(pk):
        img = pk.L.data_layer(name="img", size=2 * 4 * 4, height=4, width=4,
                              type=pk.v2.data_type.dense_vector(32))
        idx = _dense(pk, "idx", 6)
        return [pk.L.scale_sub_region_layer(input=img, indices=idx,
                                            value=2.0)]
    outs = run_graph(build, {"img": np.ones((1, 2, 4, 4), np.float32),
                             "idx": np.array([[1, 1, 2, 3, 2, 3]],
                                             np.float32)})
    r = outs[1][0].reshape(2, 4, 4)
    assert r[0, 1:3, 1:3].sum() == 8.0
    assert r.sum() == 32 + 4
    assert_twins(outs)


def test_v1_layer_name_diff_empty():
    """The port's v1 surface names what the JAX package's names, with the
    same parameters: every layer, projection, operator, network and
    evaluator (the JAX test checks the JAX package against a reference
    checkout)."""
    from paddle_tpu import trainer_config_helpers as jtch
    from paddle_tpu_torch import trainer_config_helpers as ptch
    for jmod, pmod in ((JAX.L, PORT.L), (JAX.N, PORT.N), (JAX.E, PORT.E),
                       (JAX.A, PORT.A), (jtch.poolings, ptch.poolings),
                       (jtch.attrs, ptch.attrs),
                       (jtch.optimizers, ptch.optimizers)):
        assert pmod.__all__ == jmod.__all__, pmod.__name__
        for name in jmod.__all__:
            j, p = getattr(jmod, name), getattr(pmod, name)
            if inspect.isfunction(j):
                assert (inspect.signature(p).parameters.keys()
                        == inspect.signature(j).parameters.keys()), name
    assert sorted(n for n in dir(PORT.v2.layer) if not n.startswith("_")) \
        == sorted(n for n in dir(JAX.v2.layer) if not n.startswith("_"))
    params = inspect.signature(PORT.L.sub_nested_seq_layer).parameters
    assert "selected_indices" in params
    params = inspect.signature(PORT.L.warp_ctc_layer).parameters
    assert {"blank", "norm_by_times"} <= set(params)


def test_maxframe_printer_topk_over_time(capfd):
    capfd.readouterr()
    outs = run_graph(lambda pk: [pk.E.maxframe_printer_evaluator(
        pk.L.data_layer(name="s", size=1,
                        type=pk.v2.data_type.dense_vector_sequence(1)),
        num_results=2)],
        {"s": np.array([[[0.1], [0.9], [0.5]]], np.float32),
         "s@SEQ_LEN": np.array([3], np.int32)})
    assert np.array_equal(outs[1][0], outs[0][0])
    assert np.array_equal(outs[1][0].reshape(-1), [1, 2])
    text = capfd.readouterr()
    assert _numbers(text.out + text.err, "[maxframe_printer] s:").tolist() \
        == [1, 2, 1, 2]


def test_classification_error_printer_multiclass():
    outs = run_graph(lambda pk: [pk.E.classification_error_printer_evaluator(
        _dense(pk, "p", 3), _ids(pk, "l", 3))],
        {"p": np.array([[0.1, 0.8, 0.1], [0.7, 0.2, 0.1]], np.float32),
         "l": np.array([[1], [2]], np.int64)})
    np.testing.assert_allclose(outs[1][0].reshape(-1), [0.0, 1.0])
    assert_twins(outs)


def test_detection_map_evaluator_runs():
    outs = run_graph(lambda pk: [pk.E.detection_map_evaluator(
        input=_dense(pk, "det", 6), label=_dense(pk, "gt", 6))],
        {"det": np.array([[[1, 0.9, 0.1, 0.1, 0.4, 0.4]]], np.float32),
         "gt": np.array([[[1, 0.1, 0.1, 0.4, 0.4, 0]]], np.float32)})
    assert 0.0 <= float(outs[1][0].reshape(-1)[0]) <= 1.0
    assert_twins(outs)


# ---------------------------------------------------------------------------
# tests/test_beam_search.py: the v1 generation adapter
# ---------------------------------------------------------------------------

def _v1_generator(pk, V, E, H, beam, max_len, per_sample=None):
    L = pk.L
    src = L.data_layer("src", size=V, type=_seq())
    enc = L.fc_layer(input=L.last_seq(input=src), size=H,
                     act=pk.A.TanhActivation())
    boot = L.fc_layer(input=enc, size=H, act=pk.A.TanhActivation())

    def gen_step(enc_s, cur_word):
        mem = L.memory(name="decoder", size=H, boot_layer=boot)
        hidden = L.fc_layer(input=[cur_word, mem, enc_s], size=H,
                            act=pk.A.TanhActivation(), name="decoder")
        return L.fc_layer(input=hidden, size=V,
                          act=pk.A.SoftmaxActivation())

    kw = ({} if per_sample is None
          else {"num_results_per_sample": per_sample})
    out = L.beam_search(
        step=gen_step,
        input=[L.StaticInput(enc, size=H),
               L.GeneratedInput(size=V, embedding_name="gen_emb",
                                embedding_size=E)],
        bos_id=0, eos_id=1, beam_size=beam, max_length=max_len, **kw)
    return [out, out.extra["aux"]["scores"]]


def test_v1_beam_search_adapter_generates_sequences():
    V, B, T, BEAM, MAXLEN = 20, 2, 4, 3, 5
    rng = np.random.RandomState(0)
    outs = run_graph(lambda pk: _v1_generator(pk, V, 8, 8, BEAM, MAXLEN), {
        "src": rng.rand(B, T, V).astype(np.float32),
        "src@SEQ_LEN": np.array([T, T - 1], np.int32)})
    ids = outs[1][0]
    assert ids.shape[0] == B * BEAM and ids.shape[1] <= MAXLEN + 1
    assert ids.min() >= 0 and ids.max() < V
    assert np.array_equal(ids, outs[0][0])
    assert_close(outs[1][1], outs[0][1], what="scores")


def test_v1_beam_search_num_results_per_sample():
    V, B = 12, 3
    rng = np.random.RandomState(1)
    outs = run_graph(lambda pk: _v1_generator(pk, V, 4, 4, 4, 3, 1), {
        "src": rng.rand(B, 4, V).astype(np.float32),
        "src@SEQ_LEN": np.full((B,), 4, np.int32)})
    assert outs[1][0].shape[0] == B and outs[1][1].shape[0] == B
    assert np.array_equal(outs[1][0], outs[0][0])
    assert_close(outs[1][1], outs[0][1], what="scores")


# ---------------------------------------------------------------------------
# tests/test_cross_entropy_over_beam.py
# ---------------------------------------------------------------------------

def _softmax(x):
    z = np.exp(x - np.max(x))
    return z / z.sum()


def _ceob_both(scores, lens, ids, golds):
    """The port's host core, held equal to the JAX package's."""
    got = _ceob_batch(scores, lens, ids, golds)
    want = _jceob_batch(scores, lens, ids, golds)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-7)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    return got


def test_single_expansion_gold_in_beam():
    costs, grads, _ = _ceob_both(
        [np.array([[0.1, 0.9, 0.3, 0.5]], np.float32)], [np.array([4])],
        [np.array([[1, 3]])], [np.array([1])])
    sm = _softmax(np.array([0.9, 0.5]))
    assert np.isclose(costs[0], -np.log(sm[0]), atol=1e-6)
    expect = np.zeros(4, np.float32)
    expect[1], expect[3] = sm[0] - 1, sm[1]
    np.testing.assert_allclose(grads[0][0], expect, atol=1e-6)


def test_single_expansion_gold_falls_off():
    costs, _, _ = _ceob_both(
        [np.array([[0.1, 0.9, 0.3, 0.5]], np.float32)], [np.array([4])],
        [np.array([[1, 3]])], [np.array([2])])
    want = -np.log(_softmax(np.array([0.9, 0.5, 0.3]))[2])
    assert np.isclose(costs[0], want, atol=1e-6)


def test_two_expansions_hand_computed():
    a = np.array([0.2, -0.4, 0.7])
    b = np.array([0.5, -0.1])
    c = np.array([0.3, 0.9])
    costs, grads, _ = _ceob_both(
        [a.reshape(1, 3).astype(np.float32),
         np.stack([b, c]).astype(np.float32)],
        [np.array([3]), np.array([2, 2])],
        [np.array([[2, 0]]), np.array([[1, -1], [0, 1]])],
        [np.array([2]), np.array([1])])
    totals = np.array([a[2] + b[1], a[0] + c[0], a[0] + c[1]])
    sm = _softmax(totals)
    assert np.isclose(costs[0], -np.log(sm[0]), atol=1e-6)
    g0 = np.zeros(3)
    g0[2], g0[0] = sm[0] - 1, sm[1] + sm[2]
    np.testing.assert_allclose(grads[0][0], g0, atol=1e-6)


def test_three_expansions_with_mid_chain_padding():
    a = np.array([0.2, -0.4, 0.7])
    b, c = np.array([0.5, -0.1]), np.array([0.3, 0.9])
    d, e, f = (np.array([0.1, 0.4]), np.array([-0.2, 0.6]),
               np.array([0.8, -0.3]))
    costs, grads, _ = _ceob_both(
        [a.reshape(1, 3).astype(np.float32),
         np.stack([b, c]).astype(np.float32),
         np.stack([d, e, f]).astype(np.float32)],
        [np.array([3]), np.array([2, 2]), np.array([2, 2, 2])],
        [np.array([[2, 0]]), np.array([[1, -1], [0, 1]]),
         np.array([[0, -1], [1, 0], [0, 1]])],
        [np.array([2]), np.array([1]), np.array([0])])
    totals = np.array([a[2] + b[1] + d[0], a[0] + c[0] + e[1],
                       a[0] + c[0] + e[0], a[0] + c[1] + f[0],
                       a[0] + c[1] + f[1]])
    sm = _softmax(totals)
    assert np.isclose(costs[0], -np.log(sm[0]), atol=1e-6)
    g1 = np.zeros((2, 2))
    g1[0, 1] = sm[0] - 1
    g1[1, 0] = sm[1] + sm[2]
    g1[1, 1] = sm[3] + sm[4]
    np.testing.assert_allclose(grads[1], g1, atol=1e-6)


def test_gold_falls_off_mid_chain_truncates():
    costs, grads, _ = _ceob_both(
        [np.array([[0.2, -0.4, 0.7]], np.float32),
         np.array([[9.0, 9.0], [9.0, 9.0]], np.float32)],
        [np.array([3]), np.array([2, 2])],
        [np.array([[2, 0]]), np.array([[1, -1], [0, 1]])],
        [np.array([1]), np.array([0])])
    want = -np.log(_softmax(np.array([0.7, 0.2, -0.4]))[2])
    assert np.isclose(costs[0], want, atol=1e-6)
    assert np.all(grads[1] == 0)


def test_batch_sequences_are_independent():
    rng = np.random.RandomState(3)
    s0 = rng.randn(1, 4).astype(np.float32)
    s1 = rng.randn(1, 4).astype(np.float32)
    ids0, ids1 = np.array([[0, 2]]), np.array([[3, 1]])
    g0, g1 = np.array([2]), np.array([0])
    both, _, _ = _ceob_both([np.vstack([s0, s1])], [np.array([4, 4])],
                            [np.vstack([ids0, ids1])],
                            [np.concatenate([g0, g1])])
    solo0, _, _ = _ceob_both([s0], [np.array([4])], [ids0], [g0])
    solo1, _, _ = _ceob_both([s1], [np.array([4])], [ids1], [g1])
    np.testing.assert_allclose(both, [solo0[0], solo1[0]], atol=1e-6)


def test_custom_vjp_matches_finite_differences():
    """The port's autograd Function against finite differences and
    against the JAX custom VJP's gradient."""
    import jax
    import jax.numpy as jnp
    rng = np.random.RandomState(0)
    s0 = rng.randn(1, 5).astype(np.float32)
    s1 = rng.randn(2, 3).astype(np.float32)
    lens = [np.array([5]), np.array([3, 3])]
    ids = [np.array([[4, 1]]), np.array([[0, 2], [1, -1]])]
    golds = [np.array([4]), np.array([2])]
    t = [torch.from_numpy(x) for x in lens + ids + golds]

    def f(a, b):
        return BeamTrainingCost.apply(2, a, b, *t).sum()

    a = torch.from_numpy(s0).requires_grad_(True)
    b = torch.from_numpy(s1).requires_grad_(True)
    ga, gb = torch.autograd.grad(f(a, b), (a, b))
    jga, jgb = jax.grad(lambda x, y: _beam_training_cost(
        2, [x, y], [jnp.asarray(v) for v in lens],
        [jnp.asarray(v) for v in ids],
        [jnp.asarray(v) for v in golds]).sum(), argnums=(0, 1))(
        jnp.asarray(s0), jnp.asarray(s1))
    np.testing.assert_allclose(ga.numpy(), np.asarray(jga), atol=1e-6)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgb), atol=1e-6)
    eps = 1e-3
    for arr, g in ((s0, ga.numpy()), (s1, gb.numpy())):
        it = np.nditer(arr, flags=["multi_index"])
        for _ in it:
            idx = it.multi_index
            p, m = arr.copy(), arr.copy()
            p[idx] += eps
            m[idx] -= eps
            args_p = (p, s1) if arr is s0 else (s0, p)
            args_m = (m, s1) if arr is s0 else (s0, m)
            fd = (float(f(*map(torch.from_numpy, args_p)))
                  - float(f(*map(torch.from_numpy, args_m)))) / (2 * eps)
            assert abs(fd - g[idx]) < 5e-3, (idx, fd, g[idx])


def test_v1_toy_beam_config_trains():
    T, N = 6, 4
    rng = np.random.RandomState(1)
    golds = rng.randint(0, T, (N, 1)).astype(np.int64)
    feats = 0.1 * rng.rand(N, T, 3).astype(np.float32)
    for s in range(N):
        feats[s, golds[s, 0], 0] += 1.0
    feeds = {"s": feats, "s@SEQ_LEN": np.full((N,), T, np.int32), "g": golds}
    losses = {}
    for pk in (JAX, PORT):
        L = pk.L
        seq = L.data_layer("s", size=3, type=_seq())
        gold = L.data_layer("g", size=1, type=_seq("int64", 0))
        cand_scores = L.fc_layer(seq, size=1, act=pk.A.LinearActivation())
        topk = L.kmax_seq_score_layer(cand_scores, beam_size=3)
        cost = L.cross_entropy_over_beam(L.BeamInput(
            candidate_scores=cand_scores, selected_candidates=topk,
            gold=gold))
        (cost_var,) = L.parse_network(cost)
        pk.fluid.optimizer.SGD(learning_rate=0.5).minimize(cost_var)
        exe = pk.fluid.Executor(pk.place)
        exe.run(pk.fluid.default_startup_program())
        if pk is JAX:
            state = jax_state()
        else:
            load_into_port(state)
        losses[pk.name] = [float(np.asarray(exe.run(
            feed=feeds, fetch_list=[cost_var])[0])) for _ in range(40)]
    same_program()
    assert losses["port"][-1] < losses["port"][0] * 0.3
    assert np.isfinite(losses["port"]).all()
    assert_close(losses["port"], losses["jax"], what="losses")
