"""The port's serving plane seen from outside: a port server on the CPU
(a 2-layer d32 LM with its decode engine) answers the JAX package's
`ServingClient` through ``inspect`` and ``trace``, and the JAX
package's `stitch_processes` over the port's trace document gives the
port's own; both decode engines report ``pool_copy_bytes_per_token ==
0`` (the pools are written in place); the ``inspect`` verb reports a
model dir and a live endpoint; ``serve --timeline`` writes its Chrome
trace with the ``--metrics-jsonl`` counters, ``--xprof`` its window."""
import io
import json
import os
import signal
import subprocess
import sys
import time
from contextlib import redirect_stdout

import numpy as np
import pytest

from paddle_tpu import serving as jserving
from paddle_tpu.observability import timeline as jtl
from paddle_tpu.observability import trace as jtrace

from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.__main__ import main as cli_main
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.observability import introspect as tintro
from paddle_tpu_torch.observability import timeline as ttl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = dict(vocab=64, max_len=16, n_layers=2, d_model=32, n_heads=4, d_ff=64)
DECODE = {"slots": 2, "block_len": 4, "warmup": True}


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """(model dir, scope, spec) of a random LM saved by the port."""
    spec = TT.generation_spec(**LM)
    scope = Scope()
    for name, arr in TT.random_params(spec, 5).items():
        scope.set(name, arr)
    d = str(tmp_path_factory.mktemp("lm"))
    TT.save_generation_model(d, **LM, scope=scope, init=False)
    return d, scope, spec


@pytest.fixture
def served(lm):
    reg = tserving.ModelRegistry(device="cpu")
    reg.load("lm", lm[0], decode=dict(DECODE), warmup=[1])
    server = tserving.InferenceServer(reg, port=0, port_file="").start()
    tprof.start_profiler()
    try:
        yield reg, f"127.0.0.1:{server.port}"
    finally:
        tprof.stop_profiler(quiet=True)
        server.stop()
        reg.close()


def test_inspect_and_trace_through_the_jax_client(served):
    reg, ep = served
    tid = "00000000c0ffee01"
    tokens = {"tokens": np.arange(2 * LM["max_len"]).reshape(2, -1)
              % LM["vocab"]}
    with jserving.ServingClient(ep, timeout=60) as c:
        c.infer(tokens)
        with jtrace.scope(tid):
            lines = list(c.generate_stream([3, 4, 5], max_new_tokens=4))
        assert lines[-1]["done"] and lines[-1]["trace"] == tid
        summary = c.inspect()
        doc = c.trace(tid)
    layers = summary["layers"]
    assert layers["predictor"]["programs"] >= 3
    fetches = [r["feed_sig"] for r in summary["programs"]
               if r["layer"] == "predictor"]
    # the infer predictor at batch 2, the decode step, its prefill
    assert any("('tokens', (2, 16), 'int64')" in f for f in fetches)
    assert any("kv_index" in f for f in fetches)
    assert any("kv_len" in f for f in fetches)
    assert doc["id"] == tid and len(doc["processes"]) == 1
    proc = doc["processes"][0]
    assert proc["role"] == "serve" and proc["origin"] is not None
    names = {s["name"] for s in proc["spans"]}
    assert {"serving.request", "decode.prefill", "decode.step"} <= names
    assert all(tid in s["trace"] for s in proc["spans"])
    got = ttl.stitch_processes(doc["processes"])
    assert got == jtl.stitch_processes(doc["processes"])
    flows = [e for e in got["traceEvents"] if e["ph"] in "stf"]
    assert flows and {e["id"] for e in flows} == {tid}


def test_pool_copy_bytes_is_zero_for_both_engines(lm):
    d, scope, spec = lm
    makers = [
        lambda **kw: tserving.DecodeEngine.from_model_dir(
            d, device="cpu", slots=2, block_len=4, **kw),
        lambda **kw: tserving.DecodeEngine(scope, spec, device="cpu",
                                           slots=2, block_len=4, **kw)]
    for make in makers:
        with make() as eng:
            assert eng.stats()["pool_copy_bytes_per_token"] is None
            eng.generate([1, 2, 3], max_new_tokens=3, timeout=60)
            st = eng.stats()
            assert st["pool_copy_bytes_per_token"] == 0
            # measured on the card only: no device events here
            assert st["inter_token_attribution"] is None
            assert not eng._attr_wanted


def test_program_engine_counts_a_copied_pool(lm):
    """The Programs' engine counts a returned pool that is not the fed
    one (here: the decode program made to return copies)."""
    _, scope, spec = lm
    with tserving.DecodeEngine(scope, spec, device="cpu", slots=2,
                               block_len=4) as eng:
        pred = eng.model.decode_pred
        real = pred.run

        def copying(feed, return_numpy=True):
            outs = real(feed, return_numpy=return_numpy)
            return [outs[0]] + [o.clone() for o in outs[1:]]
        pred.run = copying
        eng.generate([1, 2, 3], max_new_tokens=2, timeout=60)
        per_layer = 2 * eng._pools[0][0].numel() * 4
        assert eng.stats()["pool_copy_bytes_per_token"] == \
            LM["n_layers"] * per_layer


def _cli(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = cli_main(argv)
    return rc, out.getvalue()


def test_inspect_verb_on_a_model_dir_and_an_endpoint(lm, served):
    before = tintro.count()
    rc, out = _cli(["inspect", lm[0], "--device", "cpu", "--batch-size",
                    "3", "--roofline"])
    assert rc == 0
    assert f"model {lm[0]}" in out and "batch size      3" in out
    assert "flops/step" in out and "bound by        unknown" in out
    rep = tintro.reports(layer="predictor", since_seq=before)[-1]
    m = 3 * LM["max_len"]
    dm, f, v, t = LM["d_model"], LM["d_ff"], LM["vocab"], LM["max_len"]
    assert rep["flops"] == LM["n_layers"] * (
        2 * m * dm * 3 * dm + 4 * m * dm * f + 4 * 3 * t * t * dm) \
        + 2 * m * dm * v
    rc, out = _cli(["inspect", lm[0], "--device", "cpu", "--json",
                    "--roofline"])
    info = json.loads(out)
    assert info["batch_size"] == 1 and info["roofline"]["bound_by"] == \
        "unknown"
    assert info["param_bytes"] > 0
    _, ep = served
    rc, out = _cli(["inspect", ep])
    assert rc == 0 and "layer predictor:" in out
    rc, out = _cli(["inspect", ep, "--json"])
    assert "programs" in json.loads(out)


def test_serve_timeline_xprof_and_metrics_counters(lm, tmp_path):
    port_file = tmp_path / "port"
    timeline = tmp_path / "serve_timeline.json"
    metrics = tmp_path / "m.jsonl"
    xprof = tmp_path / "xprof"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve", lm[0],
         "--device", "cpu", "--port-file", str(port_file), "--warmup", "",
         "--decode-slots", "2", "--decode-block-len", "4",
         "--timeline", str(timeline), "--metrics-jsonl", str(metrics),
         "--metrics-interval", "0.2", "--xprof", str(xprof),
         "--xprof-seconds", "1"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)
    try:
        deadline = time.monotonic() + 60
        while not port_file.exists():
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() < deadline, "serve wrote no port"
            time.sleep(0.1)
        ep = f"127.0.0.1:{jserving.wait_for_port_file(str(port_file))}"
        with jserving.ServingClient(ep, timeout=60) as c:
            c.generate([3, 4, 5], max_new_tokens=3)
        time.sleep(0.5)
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == 0, out
    assert f"wrote timeline {timeline}" in out
    xline = [json.loads(ln) for ln in out.splitlines()
             if ln.startswith('{"xprof"')]
    assert xline == [{"xprof": {"logdir": str(xprof), "split": None}}]
    assert (xprof / "trace.json").exists()
    doc = json.load(open(timeline))
    evs = doc["traceEvents"]
    names = {e["name"] for e in evs if e["ph"] == "X"}
    assert {"serving.request", "decode.prefill", "decode.step"} <= names
    assert any(e["ph"] == "C" and e["name"] == "decode_active_slots"
               for e in evs)


def test_profiled_decode_step_keeps_its_stream(lm):
    """The engine's profiled decode step (what the first ``stats()`` on
    the card asks for) emits what a plain step does; on the CPU its trace
    holds no device events, so the attribution stays None with a
    reason."""
    with tserving.DecodeEngine.from_model_dir(lm[0], device="cpu", slots=2,
                                              block_len=4) as eng:
        want = eng.generate([1, 2, 3], max_new_tokens=4, timeout=60)
        eng._attr_wanted = True
        got = eng.generate([1, 2, 3], max_new_tokens=4, timeout=60)
        assert got["tokens"] == want["tokens"]
        assert not eng._attr_wanted
        assert eng.stats()["inter_token_attribution"] is None
        assert eng._attr_error == "the profiled step held no device events"
