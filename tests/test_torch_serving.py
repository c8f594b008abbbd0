"""The port's serving front door against the JAX package's: program
clone/prune, the inference artifact both ways, `Predictor` in f32, bf16
and int8, the dynamic batcher, the TCP endpoint and the ``serve`` verb.

Models are tiny (an fc net, a 2-layer d32 LM) and saved by one package,
served by both on the CPU (``device="cpu"``).  Tolerances: f32 fetches
1e-4 (the same f32 math summed in another order); bf16 2e-2 (bf16 keeps
~3 significant digits through every layer); int8 5e-2 against f32 on
softmax outputs, the JAX test's own bound, and the quantized matrices and
scales equal the JAX predictor's exactly.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import layers as jlayers
from paddle_tpu import serving as jserving
from paddle_tpu.checkpoint.manager import program_fingerprint
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer as JT

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.core.scope import Scope as TScope, scope_guard
from paddle_tpu_torch.inference_transpiler import InferenceTranspiler
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.serving.predictor import Predictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_SPEC = dict(vocab=64, max_len=16, n_layers=2, d_model=32, n_heads=4,
               d_ff=64)
F32_TOL, BF16_TOL, INT8_TOL = 1e-4, 2e-2, 5e-2


def _pred(model_dir, **kw):
    return Predictor.from_model_dir(model_dir, device="cpu", **kw)


def _scale_predictor(scale=10.0):
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        x = tlayers.data(name="x", shape=[2], dtype="float32")
        out = tlayers.scale(x=x, scale=scale)
    return Predictor(main, ["x"], [out], device="cpu")


def _jax_fc_model(d, seed=0):
    """A 16 -> 64 relu -> 8 softmax net saved by the JAX package."""
    main, startup = jfluid.Program(), jfluid.Program()
    scope = JScope()
    with jfluid.program_guard(main, startup), \
            jfluid.unique_name.guard(), jfluid.scope_guard(scope):
        x = jlayers.data(name="x", shape=[16], dtype="float32")
        h = jlayers.fc(input=x, size=64, act="relu")
        pred = jlayers.fc(input=h, size=8, act="softmax")
        startup.random_seed = seed
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        jfluid.io.save_inference_model(d, ["x"], [pred], exe,
                                       main_program=main)
    return d


@pytest.fixture(scope="module")
def fc_dir(tmp_path_factory):
    return _jax_fc_model(str(tmp_path_factory.mktemp("jax_fc")))


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    """The 2-layer d32 LM saved by the JAX package, its zero biases and
    unit LayerNorm affines replaced by seeded random values."""
    d = str(tmp_path_factory.mktemp("jax_lm"))
    scope = JScope()
    JT.save_generation_model(d, **LM_SPEC, seed=3, scope=scope)
    rng = np.random.RandomState(3)
    for f in sorted(os.listdir(d)):
        name = f[:-4]
        if f.endswith(".npy") and name.startswith(("fc", "layer_norm")) \
                and np.asarray(scope.get(name)).ndim == 1:
            base = 1.0 if name.startswith("layer_norm") and \
                name.endswith("w_0") else 0.0
            scope.set(name, (base + 0.1 * rng.randn(
                *np.shape(scope.get(name)))).astype(np.float32))
    JT.save_generation_model(d, **LM_SPEC, scope=scope, init=False)
    return d


def _feed(bs=4):
    return {"x": np.random.RandomState(0).rand(bs, 16).astype(np.float32)}


def _tokens(bs=2):
    return {"tokens": np.random.RandomState(1).randint(
        0, LM_SPEC["vocab"], (bs, LM_SPEC["max_len"])).astype(np.int64)}


# ---------------------------------------------------------------------------
# program transforms
# ---------------------------------------------------------------------------

def _build_train_net(fl, ly):
    """x -> fc relu -> dropout -> fc softmax, cross-entropy, SGD."""
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        x = ly.data(name="x", shape=[4], dtype="float32")
        label = ly.data(name="label", shape=[1], dtype="int64")
        h = ly.fc(input=x, size=8, act="relu")
        h = ly.dropout(h, dropout_prob=0.5)
        y = ly.fc(input=h, size=3, act="softmax")
        cost = ly.mean(ly.cross_entropy(input=y, label=label))
        fl.optimizer.SGD(learning_rate=0.1).minimize(cost)
    return main, y


def test_clone_for_test_and_prune_match_jax():
    jmain, jy = _build_train_net(jfluid, jlayers)
    tmain, ty = _build_train_net(tfluid, tlayers)

    jc, tc = jmain.clone(for_test=True), tmain.clone(for_test=True)
    assert [op.type for op in tc.global_block().ops] == \
        [op.type for op in jc.global_block().ops]
    assert not any(op.type in ("backward", "sgd")
                   for op in tc.global_block().ops)
    drop = [op for op in tc.global_block().ops if op.type == "dropout"]
    assert drop and all(op.desc.attrs["is_test"] for op in drop)
    # the training program itself is untouched
    assert any(op.type == "sgd" for op in tmain.global_block().ops)
    jp, tp = jc.prune([jy]), tc.prune([ty])
    assert [op.type for op in tp.global_block().ops] == \
        [op.type for op in jp.global_block().ops]
    assert sorted(tp.global_block().vars) == sorted(jp.global_block().vars)
    assert "label" not in tp.global_block().vars


# ---------------------------------------------------------------------------
# the artifact both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision,tol", [("f32", F32_TOL),
                                           ("bf16", BF16_TOL),
                                           ("int8", F32_TOL)])
def test_jax_fc_artifact_served_by_port_matches_jax(fc_dir, precision, tol):
    """Same precision, both packages: the port's Predictor gives the JAX
    Predictor's reply (int8 quantizes identically, so its replies agree
    at f32 accuracy too)."""
    want = np.asarray(jserving.Predictor.from_model_dir(
        fc_dir, precision=precision).run(_feed())[0], np.float32)
    got = _pred(fc_dir, precision=precision).run(_feed())[0]
    assert got.shape == want.shape == (4, 8)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("precision,tol", [("f32", F32_TOL),
                                           ("bf16", BF16_TOL)])
def test_jax_lm_artifact_served_by_port_matches_jax(lm_dir, precision, tol):
    want = np.asarray(jserving.Predictor.from_model_dir(
        lm_dir, precision=precision).run(_tokens())[0], np.float32)
    got = _pred(lm_dir, precision=precision).run(_tokens())[0]
    assert got.shape == want.shape == (2, 16, 64)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def test_port_artifact_loads_in_jax(tmp_path):
    """An fc model and an LM saved by the port: the JAX loader reads
    them and its Predictor gives the port Predictor's fetches; the
    manifests' program hash is the JAX package's recipe."""
    fc_d = str(tmp_path / "fc")
    main, startup = tfluid.Program(), tfluid.Program()
    scope = TScope()
    with tfluid.program_guard(main, startup), \
            tfluid.unique_name.guard(), scope_guard(scope):
        x = tlayers.data(name="x", shape=[16], dtype="float32")
        h = tlayers.fc(input=x, size=64, act="relu")
        y = tlayers.fc(input=h, size=8, act="softmax")
        startup.random_seed = 4
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        tio.save_inference_model(fc_d, ["x"], [y], exe, main_program=main)
    lm_d = str(tmp_path / "lm")
    lm_scope = TScope()
    for k, v in TT.random_params(TT.generation_spec(**LM_SPEC), 5).items():
        lm_scope.set(k, v)
    TT.save_generation_model(lm_d, **LM_SPEC, scope=lm_scope, init=False)
    for d, feed in ((fc_d, _feed()), (lm_d, _tokens())):
        jscope = JScope()
        with jfluid.scope_guard(jscope):
            prog, feeds, fetches = jfluid.io.load_inference_model(
                d, jfluid.Executor(jfluid.CPUPlace()))
        manifest = json.load(open(os.path.join(d, "__manifest__.json")))
        assert manifest["program_fingerprint"] == program_fingerprint(prog)
        want = np.asarray(jserving.Predictor(prog, feeds, fetches,
                                             scope=jscope).run(feed)[0])
        got = _pred(d).run(feed)[0]
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    assert TT.read_generation_spec(lm_d)["d_model"] == 32


# ---------------------------------------------------------------------------
# predictor (twins of test_serving.py and test_precision_serving.py)
# ---------------------------------------------------------------------------

def test_executable_cache_hit_miss_across_shape_buckets():
    pred = _scale_predictor()
    _, hit = pred.run_with_info({"x": np.ones((1, 2), np.float32)})
    assert not hit                      # first batch-1: cold
    _, hit = pred.run_with_info({"x": np.full((1, 2), 3.0, np.float32)})
    assert hit                          # same shape: warm
    outs, hit = pred.run_with_info({"x": np.ones((4, 2), np.float32)})
    assert not hit and outs[0].shape == (4, 2)
    _, hit = pred.run_with_info({"x": np.ones((4, 2), np.float32)})
    assert hit
    s = pred.stats()
    assert s["cache_hits"] == 2 and s["cache_misses"] == 2
    assert s["shapes_seen"] == 2
    # keys only XLA can give are left out, not reported as zero
    assert "disk_hits" not in s and "cached_executables" not in s


def test_predictor_feed_dtype_coercion_and_missing_feed():
    pred = _scale_predictor()
    (out,), _ = pred.run_with_info({"x": np.ones((1, 2), np.float64)})
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, 10.0)
    with pytest.raises(KeyError):
        pred.run({})


def test_predictor_from_model_dir_round_trip(tmp_path):
    main, startup = tfluid.Program(), tfluid.Program()
    scope = TScope()
    with tfluid.program_guard(main, startup), \
            tfluid.unique_name.guard(), scope_guard(scope):
        x = tlayers.data(name="x", shape=[4], dtype="float32")
        y = tlayers.fc(input=x, size=3, act="softmax")
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        tio.save_inference_model(str(tmp_path / "m"), ["x"], [y], exe,
                                 main_program=main)
        feed = np.random.RandomState(0).rand(2, 4).astype(np.float32)
        want = exe.run(main, feed={"x": feed}, fetch_list=[y])[0]
    got = _pred(str(tmp_path / "m")).run({"x": feed})[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_precision_validation():
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        x = tlayers.data(name="x", shape=[2], dtype="float32")
        out = tlayers.scale(x=x, scale=2.0)
    with pytest.raises(ValueError):
        Predictor(main, ["x"], [out], precision="fp8", device="cpu")


def test_bf16_and_int8_replies_within_atol_of_f32(fc_dir):
    want = _pred(fc_dir).run(_feed())[0]
    outs = {p: _pred(fc_dir, precision=p).run(_feed())[0]
            for p in ("bf16", "int8")}
    np.testing.assert_allclose(outs["bf16"], want, atol=BF16_TOL)
    np.testing.assert_allclose(outs["int8"], want, atol=INT8_TOL)


def test_int8_quantizes_eligible_matrices_like_jax(fc_dir):
    """Twin of test_int8_quantizes_eligible_matrices_only and
    test_int8_per_channel_scales_are_absmax, held to the JAX predictor's
    own int8 matrices and scales."""
    p = _pred(fc_dir, precision="int8")
    jp = jserving.Predictor.from_model_dir(fc_dir, precision="int8")
    f32 = _pred(fc_dir)
    st = p.stats()
    assert st["precision"] == "int8" and st["quantized_params"] == 2
    assert sorted(p._quantized) == sorted(jp._quantized)
    for name, skey in p._quantized.items():
        q, scales = p._params[name], p._params[skey]
        assert q.dtype == torch.int8 and scales.dtype == torch.float32
        assert tuple(scales.shape) == (q.shape[1],)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jp._params[name]))
        np.testing.assert_array_equal(scales.numpy(),
                                      np.asarray(jp._params[skey]))
        w = f32._params[name].numpy()
        np.testing.assert_allclose(scales.numpy(),
                                   np.abs(w).max(axis=0) / 127.0, rtol=1e-6)
        deq = q.numpy().astype(np.float32) * scales.numpy()[None, :]
        assert np.abs(deq - w).max() <= scales.max().item() * 0.5 + 1e-7
    others = [v for n, v in p._params.items()
              if n not in p._quantized and not n.endswith(p.QSCALE_SUFFIX)]
    assert others and all(v.dtype == torch.bfloat16 for v in others)


def test_int8_embedding_table_dequantizes_at_the_gather(tmp_path):
    """A lookup-only table stays int8 in the port's params, the rule
    dequantizes the gathered rows, and the reply matches the JAX int8
    predictor's (and f32 within the int8 bound)."""
    d = str(tmp_path / "emb")
    main, startup, scope = jfluid.Program(), jfluid.Program(), JScope()
    with jfluid.program_guard(main, startup), \
            jfluid.unique_name.guard(), jfluid.scope_guard(scope):
        ids = jlayers.data(name="ids", shape=[6], dtype="int64")
        emb = jlayers.embedding(input=ids, size=[512, 32])
        out = jlayers.fc(input=emb, size=4, act="softmax")
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        jfluid.io.save_inference_model(d, ["ids"], [out], exe,
                                       main_program=main)
    feed = {"ids": np.random.RandomState(1).randint(
        0, 512, (3, 6)).astype(np.int64)}
    q = _pred(d, precision="int8")
    assert sorted(q._gather_quantized) == ["embedding_0.w_0"]
    assert q._params["embedding_0.w_0"].dtype == torch.int8
    got = q.run(feed)[0]
    want = np.asarray(jserving.Predictor.from_model_dir(
        d, precision="int8").run(feed)[0], np.float32)
    np.testing.assert_allclose(got, want, atol=F32_TOL)
    np.testing.assert_allclose(got, _pred(d).run(feed)[0], atol=INT8_TOL)


def test_transpiler_matches_jax_on_nchw_and_folds_nhwc_relu():
    """NCHW conv + BatchNorm: the same ops as the JAX transpiler and the
    unfolded result.  NHWC conv + BatchNorm(relu), which the JAX
    transpiler folds onto the wrong axis and without its relu: the port
    keeps the unfolded result."""
    rng = np.random.RandomState(0)
    for fmt, act in (("NCHW", None), ("NHWC", "relu")):
        shape = [3, 8, 8] if fmt == "NCHW" else [8, 8, 3]
        progs = {}
        for name, fl, ly, sc in (("jax", jfluid, jlayers, JScope()),
                                 ("port", tfluid, tlayers, TScope())):
            main, startup = fl.Program(), fl.Program()
            guard = jfluid.scope_guard if name == "jax" else scope_guard
            with fl.program_guard(main, startup), \
                    fl.unique_name.guard(), guard(sc):
                img = ly.data(name="img", shape=shape, dtype="float32")
                conv = ly.conv2d(input=img, num_filters=4, filter_size=3,
                                 bias_attr=False, data_format=fmt)
                bn = ly.batch_norm(input=conv, act=act, is_test=True,
                                   data_layout=fmt)
            progs[name] = (main.clone(for_test=True), bn.name, sc, startup)
        main, out, scope, startup = progs["port"]
        with scope_guard(scope):
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup)
            bn_op = next(op for op in main.global_block().ops
                         if op.type == "batch_norm")
            # non-trivial running statistics
            for slot, val in (("Mean", rng.randn(4)),
                              ("Variance", rng.rand(4) + 0.5)):
                scope.set(bn_op.desc.inputs[slot][0],
                          torch.tensor(val, dtype=torch.float32))
            feed = {"img": rng.randn(2, *shape).astype(np.float32)}
            (want,) = exe.run(main, feed=feed, fetch_list=[out])
            InferenceTranspiler().transpile(main, scope=scope)
            assert not any(op.type == "batch_norm"
                           for op in main.global_block().ops)
            (got,) = exe.run(main, feed=feed, fetch_list=[out])
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        if fmt == "NCHW":
            jmain, _, jscope, jstartup = progs["jax"]
            with jfluid.scope_guard(jscope):
                jfluid.Executor(jfluid.CPUPlace()).run(jstartup)
                jfluid.InferenceTranspiler().transpile(jmain)
            assert [op.type for op in main.global_block().ops] == \
                [op.type for op in jmain.global_block().ops]


def test_xla_only_and_unported_options_refused(fc_dir, tmp_path):
    with pytest.raises(ValueError, match="ROADMAP"):
        _pred(fc_dir, compile_cache=str(tmp_path / "cc"))
    # the hot-row cache is ported: an fc net has no table, nothing cached
    assert _pred(fc_dir, embedding_cache_rows=8)._row_caches == {}
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        x = tlayers.data(name="x", shape=[2], dtype="float32")
        out = tlayers.scale(x=x, scale=2.0)
    with pytest.raises(ValueError, match="ROADMAP"):
        tio.save_inference_model(str(tmp_path / "m"), ["x"], [out], None,
                                 main_program=main, export_stablehlo=True)


def test_entry_points_default_to_the_card(lm_dir, tmp_path):
    """Without CUDA and without device='cpu' (or --device cpu), the
    serving entry points raise instead of falling back to the CPU."""
    from paddle_tpu_torch.__main__ import main as cli_main
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        x = tlayers.data(name="x", shape=[2], dtype="float32")
        out = tlayers.scale(x=x, scale=2.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(main, ["x"], [out])
    with pytest.raises(RuntimeError, match="CUDA"):
        tserving.ModelRegistry().load("m", lm_dir)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserving.DecodeEngine.from_model_dir(lm_dir)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main(["serve", lm_dir, "--port-file", str(tmp_path / "p")])
    assert not (tmp_path / "p").exists()


def test_kernel_launch_counts_survive_concurrent_launches():
    """The serving engines launch kernels from several threads: no
    launch count is lost (a lost update would show under a short switch
    interval)."""
    from paddle_tpu_torch.ops import kernels as K
    k = K.Kernel("probe", "probe", "probe", "none", [])
    k._fn = lambda *a: 0          # a launch that succeeds
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [k.launch() for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert k.launches == 16 * 2000


# ---------------------------------------------------------------------------
# dynamic batcher (twins of test_serving.py)
# ---------------------------------------------------------------------------

def test_batcher_coalesces_and_routes_results_correctly():
    pred = _scale_predictor()
    with tserving.ServingEngine(pred, max_batch_size=16,
                                max_queue_delay_ms=200) as eng:
        results, errors = {}, []

        def client(i):
            try:
                out, = eng.infer({"x": np.full((1, 2), float(i),
                                               np.float32)}, timeout=30)
                results[i] = out
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        for i in range(16):
            np.testing.assert_allclose(results[i], 10.0 * i)
        s = eng.stats()
        assert s["requests"] == 16
        assert s["dispatches"] < 16
        assert s["max_batch_observed"] > 1
        assert s["latency"]["p99_ms"] > 0


def test_queue_delay_timeout_flushes_partial_batch():
    pred = _scale_predictor()
    with tserving.ServingEngine(pred, max_batch_size=8,
                                max_queue_delay_ms=50) as eng:
        futs = [eng.submit({"x": np.full((1, 2), float(i), np.float32)})
                for i in range(3)]
        res = [f.result(timeout=10) for f in futs]
        for i, (out,) in enumerate(res):
            np.testing.assert_allclose(out, 10.0 * i)
        s = eng.stats()
        assert s["dispatches"] == 1
        assert s["max_batch_observed"] == 3
        assert s["buckets"]["4"]["misses"] == 1
        assert s["padded_rows"] == 1
        assert eng.buckets == [1, 2, 4, 8]


def test_batcher_multi_row_requests_and_oversize():
    pred = _scale_predictor()
    with tserving.ServingEngine(pred, max_batch_size=4,
                                max_queue_delay_ms=10) as eng:
        big, = eng.infer({"x": np.ones((6, 2), np.float32)}, timeout=30)
        assert big.shape == (6, 2)
        np.testing.assert_allclose(big, 10.0)
        two, = eng.infer({"x": np.full((2, 2), 2.0, np.float32)},
                         timeout=30)
        assert two.shape == (2, 2)
        np.testing.assert_allclose(two, 20.0)
        assert eng.stats()["buckets"]["oversize"]["dispatches"] == 1


def test_engine_close_rejects_new_and_drains_pending():
    pred = _scale_predictor()
    eng = tserving.ServingEngine(pred, max_batch_size=4,
                                 max_queue_delay_ms=20)
    futs = [eng.submit({"x": np.full((1, 2), float(i), np.float32)})
            for i in range(4)]
    eng.close()
    for i, f in enumerate(futs):
        np.testing.assert_allclose(f.result(timeout=10)[0], 10.0 * i)
    with pytest.raises(RuntimeError):
        eng.submit({"x": np.ones((1, 2), np.float32)})


def test_endpoint_round_trip_with_selected_port_discovery(tmp_path):
    """The JAX package's client helpers against the port's server."""
    port_file = str(tmp_path / "selected_port")
    pred = _scale_predictor()
    with tserving.ServingEngine(pred, max_batch_size=8,
                                max_queue_delay_ms=5) as eng:
        server = tserving.InferenceServer(eng, port=0,
                                          port_file=port_file).start()
        try:
            port = jserving.wait_for_port_file(port_file, timeout=30)
            assert port == server.port
            endpoint = f"127.0.0.1:{port}"
            out = jserving.infer_round_trip(
                endpoint, {"x": np.full((1, 2), 2.3, np.float32)},
                timeout=30)
            (name, val), = out.items()
            np.testing.assert_allclose(val, 23.0, rtol=1e-6)
            stats = jserving.serving_stats(endpoint, timeout=30)
            assert stats["requests"] == 1
            assert stats["predictor"]["cache_misses"] >= 1
            with jserving.ServingClient(endpoint, timeout=30) as c:
                for i in range(3):
                    got = c.infer({"x": np.full((1, 2), float(i),
                                                np.float32)})
                    np.testing.assert_allclose(next(iter(got.values())),
                                               10.0 * i)
            jserving.shutdown_serving(endpoint)
            assert server.shutting_down.wait(10)
        finally:
            server.stop()


# ---------------------------------------------------------------------------
# the serve verb
# ---------------------------------------------------------------------------

def test_cli_serve_infer_generate_sigterm(lm_dir, tmp_path):
    """``python -m paddle_tpu_torch serve --device cpu``: infer and a
    streamed generate over the wire, then SIGTERM drains and prints the
    stats JSON as the last line."""
    port_file = tmp_path / "port"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve", lm_dir,
         "--device", "cpu", "--port", "0", "--port-file", str(port_file),
         "--max-batch-size", "4", "--warmup", "", "--decode-slots", "2",
         "--decode-block-len", "4", "--decode-prefix-cache-blocks", "4"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)
    try:
        deadline = time.monotonic() + 60
        while not port_file.exists():
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() < deadline, "serve never wrote its port"
            time.sleep(0.1)
        endpoint = f"127.0.0.1:{jserving.wait_for_port_file(str(port_file), timeout=30)}"
        with jserving.ServingClient(endpoint, timeout=60) as c:
            logits = next(iter(c.infer(_tokens(1)).values()))
            assert logits.shape == (1, 16, 64)
            lines = list(c.generate_stream([3, 4, 5, 6, 7], max_new_tokens=4))
            assert [ln["index"] for ln in lines[:-1]] == [0, 1, 2, 3]
            assert lines[-1]["done"] and len(lines[-1]["tokens"]) == 4
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == 0, out
    stats = json.loads(out.strip().splitlines()[-1])
    assert stats["requests"] == 1
    assert stats["decode"]["requests"] == 1
    assert stats["predictor"]["device"] == "cpu"
