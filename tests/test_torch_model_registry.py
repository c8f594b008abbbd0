"""The port's `ModelRegistry` and `InferenceServer` driven by the JAX
package's `ServingClient`: routing, hot reload, the admin verbs, every
structured error code, and ``generate`` streamed and not (twins of
test_model_registry.py, on the CPU with ``device="cpu"``).

The fc models are saved by the port; the LM by the JAX package.  f32
replies are held to the port's own Predictor at 1e-6 (the same code),
and generated tokens to the port's in-process DecodeEngine exactly.
"""
import threading
import time

import numpy as np
import pytest

import paddle_tpu as jfluid  # noqa: F401  (the JAX client's package)
from paddle_tpu import serving as jserving
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer as JT

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.core.scope import Scope as TScope, scope_guard
from paddle_tpu_torch.observability import render_prometheus

LM_SPEC = dict(vocab=32, max_len=16, n_layers=2, d_model=16, n_heads=2,
               d_ff=32)


def _save_fc_model(tmp_path, name, scale=1.0, size=3, seed=0):
    """A 4 -> size softmax fc model saved by the port; ``scale`` varies
    the weights so two saves differ."""
    main, startup, scope = tfluid.Program(), tfluid.Program(), TScope()
    d = str(tmp_path / name)
    with tfluid.program_guard(main, startup), \
            tfluid.unique_name.guard(), scope_guard(scope):
        x = tlayers.data(name="x", shape=[4], dtype="float32")
        y = tlayers.fc(input=x, size=size, act="softmax")
        startup.random_seed = seed
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        if scale != 1.0:
            scope.set("fc_0.w_0", scope.get("fc_0.w_0") * scale)
        tio.save_inference_model(d, ["x"], [y], exe, main_program=main)
    return d


def _save_scale_model(d, scale):
    main, startup, scope = tfluid.Program(), tfluid.Program(), TScope()
    with tfluid.program_guard(main, startup), scope_guard(scope):
        x = tlayers.data(name="x", shape=[2], dtype="float32")
        y = tlayers.scale(x=x, scale=scale)
        tio.save_inference_model(d, ["x"], [y], None, main_program=main)


def _registry(**kw):
    return tserving.ModelRegistry(device="cpu", **kw)


def _registry_two_models(tmp_path, **opts):
    da = _save_fc_model(tmp_path, "ma", size=3)
    db = _save_fc_model(tmp_path, "mb", size=5)
    reg = _registry()
    reg.load("a", da, engine_opts=dict({"max_queue_delay_ms": 5}, **opts))
    reg.load("b", db, engine_opts=dict({"max_queue_delay_ms": 5}, **opts))
    return reg, da, db


def _serve(reg):
    server = tserving.InferenceServer(reg, port=0, port_file="").start()
    return server, f"127.0.0.1:{server.port}"


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_lm"))
    scope = JScope()
    JT.save_generation_model(d, **LM_SPEC, seed=11, scope=scope)
    rng = np.random.RandomState(11)
    for name in list(scope._vars):
        val = np.asarray(scope.get(name))
        if val.ndim == 1 and name.startswith(("fc", "layer_norm")):
            base = 1.0 if name.startswith("layer_norm") and \
                name.endswith("w_0") else 0.0
            scope.set(name, (base + 0.1 * rng.randn(*val.shape))
                      .astype(np.float32))
    JT.save_generation_model(d, **LM_SPEC, scope=scope, init=False)
    return d


# ---------------------------------------------------------------------------
# routing and defaults
# ---------------------------------------------------------------------------

def test_two_models_one_endpoint_and_default_routing(tmp_path):
    reg, _, _ = _registry_two_models(tmp_path)
    server, ep = _serve(reg)
    try:
        feed = {"x": np.ones((2, 4), np.float32)}
        with jserving.ServingClient(ep, timeout=30) as c:
            a = next(iter(c.infer(feed, model="a").values()))
            b = next(iter(c.infer(feed, model="b").values()))
            assert a.shape == (2, 3) and b.shape == (2, 5)
            d = next(iter(c.infer(feed).values()))
            assert d.shape == (2, 3)
            listing = c.models()
            assert sorted(listing["models"]) == ["a", "b"]
            assert listing["default"] == "a"
            assert listing["models"]["b"]["version"] == 1
            assert listing["models"]["b"]["device"] == "cpu"
            assert c.stats(model="a")["requests"] == 2
            assert c.stats(model="b")["requests"] == 1
        prom = jserving.serving_metrics(ep, timeout=30)
        assert 'engine_requests_total{model="a"} 2' in prom
        assert 'engine_requests_total{model="b"} 1' in prom
        np.testing.assert_allclose(
            a, reg.get("a").predictor.run(feed)[0], atol=1e-6)
    finally:
        server.stop()
        reg.close()


def test_oversize_feed_against_named_model(tmp_path):
    reg, _, _ = _registry_two_models(tmp_path, max_batch_size=4)
    server, ep = _serve(reg)
    try:
        out = jserving.infer_round_trip(
            ep, {"x": np.ones((10, 4), np.float32)}, model="b", timeout=30)
        assert next(iter(out.values())).shape == (10, 5)
        stats = jserving.serving_stats(ep, model="b", timeout=30)
        assert stats["requests"] == 1
        assert stats["buckets"]["oversize"]["dispatches"] == 1
    finally:
        server.stop()
        reg.close()


# ---------------------------------------------------------------------------
# the error codes, each through the JAX client
# ---------------------------------------------------------------------------

def test_every_wire_error_code_through_the_jax_client(tmp_path, lm_dir):
    reg, _, _ = _registry_two_models(tmp_path)
    reg.load("slow", _save_fc_model(tmp_path, "ms"),
             engine_opts={"max_queue_delay_ms": 1, "max_queue_depth": 1,
                          "workers": 1})
    server, ep = _serve(reg)
    one = {"x": np.ones((1, 4), np.float32)}
    try:
        with jserving.ServingClient(ep, timeout=30, retries=0) as c:
            with pytest.raises(jserving.ServingError) as ei:
                c.infer(one, model="ghost")
            assert ei.value.code == "unknown_model"
            with pytest.raises(jserving.ServingError) as ei:
                c.infer({"wrong": one["x"]}, model="a")
            assert ei.value.code == "bad_feed"
            assert isinstance(ei.value, RuntimeError)
            with pytest.raises(jserving.ServingError) as ei:
                c._call({"method": "frobnicate"})
            assert ei.value.code == "bad_request"
            with pytest.raises(jserving.ServingError) as ei:
                c.generate([1, 2, 3], model="a")   # no decode engine
            assert ei.value.code == "bad_request"
            with pytest.raises(jserving.ServingError) as ei:
                c.infer(one, model="a", deadline_ms=0)
            assert ei.value.code == "deadline_exceeded"
            for verb in ("inspect", "trace"):
                reply = c.raw_call({"method": verb, "model": "a", "id": "x"})
                assert reply["code"] == "bad_request", reply
                assert "not ported" in reply["error"]
                assert "ROADMAP" in reply["error"]
            # apply_deltas is ported: an unknown model is unknown_model,
            # a model with no delta chain a no-op
            reply = c.raw_call({"method": "apply_deltas", "model": "zz"})
            assert reply["code"] == "unknown_model", reply
            assert c.raw_call({"method": "apply_deltas", "model": "a"})[
                "delta"]["applied"] is False
            # a server-side fault is the server's: internal
            pred = reg.get("b").predictor
            real = pred.run_with_info

            def fault(*a, **k):
                raise RuntimeError("device fault")
            pred.run_with_info = fault
            try:
                with pytest.raises(jserving.ServingError) as ei:
                    c.infer(one, model="b")
                assert ei.value.code == "internal"
            finally:
                pred.run_with_info = real
            # admission bound: a slow forward holds one request while
            # one waits; the next is shed
            slow = reg.get("slow").predictor
            real_slow = slow.run_with_info
            entered, gate = threading.Event(), threading.Event()

            def held(*a, **k):
                entered.set()
                gate.wait(30)
                return real_slow(*a, **k)
            slow.run_with_info = held
            threads = [threading.Thread(target=jserving.infer_round_trip,
                                        args=(ep, one, 30, "slow"))
                       for _ in range(2)]
            try:
                threads[0].start()
                assert entered.wait(30)      # the one worker is held
                threads[1].start()
                deadline = time.monotonic() + 30
                while reg.get("slow").engine.stats()["queue_depth"] < 1:
                    assert time.monotonic() < deadline
                    time.sleep(0.005)
                with pytest.raises(jserving.ServingError) as ei:
                    c.infer(one, model="slow")
                assert ei.value.code == "overloaded" and ei.value.retriable
            finally:
                gate.set()
                for t in threads:
                    t.join(30)
                slow.run_with_info = real_slow
            assert not any(t.is_alive() for t in threads)
            assert reg.get("slow").engine.stats()["shed"] == 1
            # the socket survives every error
            out = c.infer(one, model="a")
            assert next(iter(out.values())).shape == (1, 3)
            # draining: a live connection gets the retriable code
            server.shutting_down.set()
            reply = c.raw_call({"method": "infer", "model": "a",
                                "feed": {"x": jserving.server._encode(
                                    one["x"])}})
            assert reply["code"] == "shutting_down"
    finally:
        server.stop()
        reg.close()


def test_jax_client_generates_streamed_and_not(lm_dir):
    """``generate`` over the wire from the JAX client: the streamed
    tokens, the final line and the non-streamed reply are the port's
    in-process DecodeEngine's tokens."""
    reg = _registry()
    reg.load("lm", lm_dir, decode={"slots": 2, "block_len": 4,
                                   "prefix_cache_blocks": 4})
    server, ep = _serve(reg)
    prompt = [3, 4, 5, 6, 7, 8, 9, 10, 11]
    try:
        with tserving.DecodeEngine.from_model_dir(
                lm_dir, device="cpu", slots=1, block_len=4) as ref:
            want = ref.generate(prompt, max_new_tokens=5,
                                timeout=60)["tokens"]
        with jserving.ServingClient(ep, timeout=60) as c:
            lines = list(c.generate_stream(prompt, model="lm",
                                           max_new_tokens=5))
            assert [ln["token"] for ln in lines[:-1]] == want
            assert [ln["index"] for ln in lines[:-1]] == list(range(5))
            final = lines[-1]
            assert final["done"] and final["tokens"] == want
            assert final["finish_reason"] == "length"
            assert final["count"] == 5 and final["model"] == "lm"
            again = c.generate(prompt, model="lm", max_new_tokens=5)
            assert again["tokens"] == want and again["count"] == 5
            st = c.stats(model="lm")["decode"]
            assert st["prefix"]["hits"] == 1 and st["requests"] == 2
            info = c.models()["models"]["lm"]["decode"]
            assert info["prefix_cache_blocks"] == 4 and info["slots"] == 2
        prom = jserving.serving_metrics(ep, timeout=30)
        assert 'decode_prefix_hits_total{model="lm"} 1' in prom
        snap = jserving.serving_metrics(ep, format="json", timeout=30)
        assert snap["decode_tokens_total"]["series"]["model=lm"] == 10
    finally:
        server.stop()
        reg.close()


# ---------------------------------------------------------------------------
# lifecycle: unload and reload
# ---------------------------------------------------------------------------

def test_unload_frees_engine_workers_and_unmounts_metrics(tmp_path):
    reg, _, _ = _registry_two_models(tmp_path)
    eng_a = reg.get("a").engine
    workers = list(eng_a._workers)
    assert all(t.is_alive() for t in workers)
    reg.unload("a")
    for t in workers:
        t.join(10)
    assert not any(t.is_alive() for t in workers)
    assert 'engine_requests_total{model="a"}' not in render_prometheus()
    with pytest.raises(tserving.UnknownModelError):
        reg.get("a")
    assert reg.get(None).name == "b"
    with pytest.raises(tserving.UnknownModelError):
        reg.unload("a")
    reg.close()


def test_reload_noop_on_unchanged_manifest_and_swap_on_change(tmp_path):
    d = _save_fc_model(tmp_path, "m", size=3)
    reg = _registry()
    reg.load("m", d, engine_opts={"max_queue_delay_ms": 5})
    v1_engine = reg.get("m").engine
    assert reg.reload("m") is False
    assert reg.get("m").engine is v1_engine
    assert reg.get("m").version == 1
    _save_fc_model(tmp_path, "m", scale=2.0, size=3)
    assert reg.reload("m") is True
    assert reg.get("m").engine is not v1_engine
    assert reg.get("m").version == 2
    deadline = time.monotonic() + 10
    while any(t.is_alive() for t in v1_engine._workers):
        assert time.monotonic() < deadline, "old engine never drained"
        time.sleep(0.05)
    reg.close()


def test_reload_while_in_flight_drops_and_misroutes_nothing(tmp_path):
    """Clients hammer model 'm' while it is reloaded from scale 10 to
    scale 20: every reply matches the old or the new model, none fails."""
    d = str(tmp_path / "m")
    _save_scale_model(d, 10.0)
    reg = _registry()
    reg.load("m", d, engine_opts={"max_queue_delay_ms": 1})
    server, ep = _serve(reg)
    stop = threading.Event()
    errors, replies = [], []

    def client(i):
        try:
            with jserving.ServingClient(ep, timeout=30) as c:
                while not stop.is_set():
                    out = c.infer({"x": np.full((1, 2), float(i + 1),
                                                np.float32)}, model="m")
                    replies.append(next(iter(out.values()))[0, 0] / (i + 1))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.3)
        _save_scale_model(d, 20.0)
        assert reg.reload("m") is True
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        server.stop()
        reg.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    ratios = set(float(round(r, 3)) for r in replies)
    assert ratios <= {10.0, 20.0}, ratios
    assert 20.0 in ratios
    assert len(replies) > 20


def test_wire_admin_load_unload_reload(tmp_path):
    da = _save_fc_model(tmp_path, "ma", size=3)
    db = _save_fc_model(tmp_path, "mb", size=5)
    reg = _registry()
    reg.load("a", da, engine_opts={"max_queue_delay_ms": 5})
    server, ep = _serve(reg)
    try:
        with jserving.ServingClient(ep, timeout=30) as c:
            info = c.load_model("b", db, options={"max_queue_delay_ms": 5})
            assert info["version"] == 1
            out = c.infer({"x": np.ones((1, 4), np.float32)}, model="b")
            assert next(iter(out.values())).shape == (1, 5)
            assert c.reload_model("b") is False
            c.unload_model("b")
            with pytest.raises(jserving.ServingError) as ei:
                c.infer({"x": np.ones((1, 4), np.float32)}, model="b")
            assert ei.value.code == "unknown_model"
            with pytest.raises(jserving.ServingError) as ei:
                c.load_model("a", da)
            assert ei.value.code == "bad_request"
            # sharded serving is refused, naming its ROADMAP item
            with pytest.raises(jserving.ServingError) as ei:
                c.load_model("c", db, mesh={"dp": 2})
            assert ei.value.code == "bad_request"
            assert "ROADMAP" in ei.value.message
    finally:
        server.stop()
        reg.close()


def test_client_reconnects_once_on_stale_socket(tmp_path):
    d = _save_fc_model(tmp_path, "m", size=3)
    reg = _registry()
    reg.load("m", d, engine_opts={"max_queue_delay_ms": 5})
    server, ep = _serve(reg)
    try:
        c = jserving.ServingClient(ep, timeout=30)
        feed = {"x": np.ones((1, 4), np.float32)}
        c.infer(feed)
        first_trace = c.last_trace
        c._sock.close()
        out = c.infer(feed)
        assert next(iter(out.values())).shape == (1, 3)
        assert c.last_trace and c.last_trace != first_trace
        c._sock.close()
        assert c.stats()["requests"] == 2
        c._sock.close()
        assert "engine_requests_total" in c.metrics()
        c.close()
    finally:
        server.stop()
        reg.close()


def test_registry_load_precision_and_refusals(tmp_path, lm_dir):
    d = _save_fc_model(tmp_path, "m", size=3)
    reg = _registry()
    try:
        reg.load("m8", d, precision="int8")
        assert reg.get("m8").predictor.precision == "int8"
        want = reg.get("m8").predictor.run({"x": np.ones((2, 4),
                                                         np.float32)})[0]
        got = reg.infer("m8", {"x": np.ones((2, 4), np.float32)})[0]
        np.testing.assert_allclose(got, want, atol=1e-6)
        for kw in ({"mesh": {"dp": 2}}, {"compile_cache": str(tmp_path)}):
            with pytest.raises(ValueError, match="ROADMAP"):
                reg.load("x", d, **kw)
        # no delta chain in the model dir: nothing to apply
        assert reg.apply_deltas("m8") == {"applied": False, "stale": False,
                                          "seq": None, "step": None,
                                          "rows": 0}
        # a decode engine at int8 and one at exact numerics load; a bad
        # exact geometry is refused and the refused load leaks no engine
        lm8 = reg.load("lm8", lm_dir, precision="int8", warmup=[])
        assert lm8.decode.model.precision == "int8"
        assert lm8.decode.kv_dtype == "float32"
        lmx = reg.load("lmx", lm_dir, warmup=[],
                       decode={"numerics": "exact", "block_len": 4})
        assert lmx.describe()["decode"]["numerics"] == "exact"
        with pytest.raises(ValueError, match="max_len"):
            reg.load("lmy", lm_dir, decode={"numerics": "exact",
                                            "block_len": 4,
                                            "pages_per_slot": 2})
        assert reg.names() == ["lm8", "lmx", "m8"]
        assert 'model="lmy"' not in render_prometheus()
    finally:
        reg.close()
