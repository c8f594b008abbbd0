"""The port's attribution plane and cost reports against the JAX
package's: `roofline` gives JAX's result once JAX's peaks are set to the
H100's; `device_step_split` reads a torch.profiler trace (None for a
CPU-only capture, as JAX's split is None without a device plane);
`XprofCapture` opens the same windows as JAX's for the same ticks;
`decode_attribution` splits a kernel list by class; the executor's
report counts a small LM's products exactly, and lies within [0.7, 1.0]
of XLA's ``cost_analysis`` flops for the same program on the CPU (XLA
also counts every elementwise flop; the f32 LM below measures 0.812);
`train_loop(timeline_path=..., xprof_every=...)` leaves the losses
bitwise unchanged and opens its windows at JAX's steps."""
import json
import math

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import transformer as JT
from paddle_tpu.observability import attribution as jattr
from paddle_tpu.observability import introspect as jintro

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.observability import attribution as tattr
from paddle_tpu_torch.observability import introspect as tintro

H100 = "NVIDIA H100 80GB HBM3"
LM = dict(vocab=64, max_len=16, n_layers=2, d_model=32, n_heads=4, d_ff=64)
XLA_RATIO = (0.7, 1.0)


def _rep(flops, bytes_accessed, comm=0, steps=1, flops_scale=1, ndev=1,
         dtype="f32", mesh=None):
    led = None
    if comm:
        led = {"kinds": {"all-reduce": {"count": 1, "bytes": comm,
                                        "replica_groups": []},
                         "all-to-all": {"count": 1, "bytes": comm // 2,
                                        "replica_groups": []}},
               "total_bytes": comm}
    return {"flops": flops, "bytes_accessed": bytes_accessed,
            "steps": steps, "flops_scale": flops_scale, "num_devices": ndev,
            "dtype": dtype, "collectives": led, "mesh_shape": mesh,
            "device_name": H100}


def _h100_peaks_on_jax(monkeypatch):
    roofs = tattr.H100_SXM_ROOFS
    monkeypatch.setattr(jattr, "PEAK_FLOPS", dict(roofs["flops"]))
    monkeypatch.setattr(jattr, "PEAK_HBM_BYTES_PER_S",
                        roofs["hbm_bytes_per_s"])
    monkeypatch.setattr(jattr, "PEAK_ICI_BYTES_PER_S",
                        roofs["link_bytes_per_s"])


@pytest.mark.parametrize("rep,kw", [
    (_rep(1e15, 1e9), {}),
    (_rep(1e9, 1e13), {}),
    (_rep(1e9, 1e9, comm=int(1e12)), {}),
    (_rep(1e12, 1e9, dtype="bf16"), {"measured_step_seconds": 0.01}),
    (_rep(8e12, 8e9, steps=4, flops_scale=2, ndev=2),
     {"measured_step_seconds": 1.0}),
    (_rep(1e15, 1e9), {"measured_split": {"compute_ps": 1e10,
                                          "collective_ps": 9e10,
                                          "idle_ps": 0}}),
    (_rep(1e9, 2e9, comm=4096, mesh={"tp": 2, "ep": 2}), {}),
    (_rep(0.0, 0.0), {}),
    (_rep(5e12, 4e10, dtype="int8"), {"measured_step_seconds": 0.2}),
])
def test_roofline_equals_jax_with_h100_peaks(monkeypatch, rep, kw):
    _h100_peaks_on_jax(monkeypatch)
    got = tattr.roofline(rep, **kw)
    want = jattr.roofline(rep, **kw)
    assert got.pop("device_name") == H100
    assert got == want


def test_roofline_unknown_device_borrows_no_peaks():
    rep = dict(_rep(1e12, 1e9), device_name="cpu")
    rl = tattr.roofline(rep)
    assert rl["bound_by"] == "unknown" and rl["model_times_s"] is None
    assert rl["attained_compute_frac"] is None
    assert tattr.roofs_for("NVIDIA H100 PCIe") is None
    # the H100's roofs are the datasheet's
    assert tattr.ROOFS[H100]["flops"]["bf16"] == 989e12
    assert tattr.ROOFS[H100]["hbm_bytes_per_s"] == 3.35e12


def test_psum_share_equals_jax():
    for rep in (_rep(1.0, 8000.0, comm=100, steps=4, flops_scale=2),
                _rep(1.0, 100.0)):
        assert tattr.psum_share(rep) == jattr.psum_share(rep)
    assert tattr.collective_ledger() is None


# ---------------------------------------------------------------------------
# torch.profiler traces
# ---------------------------------------------------------------------------

def _kernel(name, ts, dur, pid=0, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": 7}


SYNTH = {"traceEvents": [
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 50.0,
     "pid": 123, "tid": 1},
    _kernel("void flash_fwd_kernel<__nv_bfloat16, 64>(Params)", 10.0, 20.0),
    _kernel("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", 35.0, 10.0),
    _kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)", 50.0,
            5.0),
    _kernel("Memcpy DtoH (Device -> Pinned)", 60.0, 2.0, cat="gpu_memcpy"),
    _kernel("void other_device_kernel()", 5.0, 1.0, pid=1),
    {"ph": "X", "cat": "gpu_user_annotation", "name": "executor.run",
     "ts": 10.0, "dur": 52.0, "pid": 0, "tid": 7},
]}


def test_device_step_split_of_a_synthetic_trace(tmp_path):
    path = tmp_path / "w" / "trace.json"
    path.parent.mkdir()
    path.write_text(json.dumps(SYNTH))
    for source in (str(path), str(tmp_path), SYNTH):
        split = tattr.device_step_split(source)
        # device 0 only: busy 20 + 10 + 2 compute, 5 collective; the
        # span 10..62 us
        assert split == {"plane": "cuda:0", "compute_ps": 32_000_000,
                         "collective_ps": 5_000_000,
                         "idle_ps": 15_000_000, "events": 4}


def test_device_step_split_is_none_for_a_cpu_capture(tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = str(tmp_path / "cpu.json")
    prof.export_chrome_trace(path)
    assert tattr.device_step_split(path) is None
    assert tattr.device_step_split(str(tmp_path / "nothing")) is None
    assert tattr.decode_attribution(path) is None


def _ticks(cap, seq):
    for s in seq:
        cap.tick(s)
    cap.finish()
    return [w["step"] for w in cap.windows]


@pytest.mark.parametrize("every,steps,seq", [
    (3, 1, range(7)),
    (8, 2, range(0, 20, 4)),      # ticks once a fused window of 4
    (2, 3, [0, 1, 5, 6, 7, 12]),
])
def test_xprof_cadence_equals_jax(tmp_path, every, steps, seq):
    got = _ticks(tattr.XprofCapture(str(tmp_path / "t"), every, steps), seq)
    want = _ticks(jattr.XprofCapture(str(tmp_path / "j"), every, steps), seq)
    assert got == want
    cap = tattr.XprofCapture(str(tmp_path / "t2"), every, steps)
    _ticks(cap, seq)
    summ = cap.summary()
    assert summ == {"windows": len(got), "measured": 0}    # the CPU
    for w in cap.windows:
        assert w["split"] is None and w["overhead_s"] >= 0
        assert json.load(open(w["trace"]))["traceEvents"] is not None


def test_xprof_goes_dead_under_another_profiler(tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        cap = tattr.XprofCapture(str(tmp_path / "inner"), every=1, steps=1)
        for s in range(3):
            cap.tick(s)
        cap.finish()
    assert cap._dead and cap.windows == []
    assert cap.summary() == {"windows": 0, "measured": 0}


def test_xprof_summary_shares_from_measured_windows():
    cap = tattr.XprofCapture("unused", every=1)
    cap.windows = [{"split": {"compute_ps": 3, "collective_ps": 1,
                              "idle_ps": 4}},
                   {"split": None}]
    jcap = jattr.XprofCapture("unused", every=1)
    jcap.windows = cap.windows
    assert cap.summary() == jcap.summary() == {
        "windows": 2, "measured": 1, "compute_share": 0.375,
        "collective_share": 0.125, "idle_share": 0.5}


def test_every_port_kernel_classifies_as_kernel():
    names = tattr.port_kernel_names()
    # flash forward and backward, paged attention, LayerNorm forward and
    # backward, softmax cross-entropy, BatchNorm backward, LSTM, GRU (each
    # persistent and stepwise), the recurrent products and the row-stable
    # product
    assert len(names) == 33
    for n in names:
        assert tattr.classify_kernel(f"void {n}<float, 64>(int)") == \
            "kernel"


def test_decode_attribution_of_a_synthetic_step():
    events = [
        _kernel("void paged_split_kernel<__nv_bfloat16>(P)", 0.0, 30.0),
        _kernel("void paged_combine_kernel<__nv_bfloat16>(P)", 30.0, 5.0),
        _kernel("void ln_fwd_warp_kernel<__nv_bfloat16>(P)", 35.0, 5.0),
        _kernel("sm90_xmma_gemm_bf16bf16_bf16f32_f32_nt_n", 40.0, 20.0),
        _kernel("void at::native::indexSelectLargeIndex<float>(...)", 60.0,
                4.0),
        _kernel("void at::native::index_elementwise_kernel<128>(...)", 64.0,
                6.0),
        _kernel("void at::native::indexSelectSmallIndex<float>(...)", 70.0,
                2.0),
        _kernel("void at::native::elementwise_kernel<128, 4>(...)", 72.0,
                26.0),
        _kernel("Memcpy DtoH", 98.0, 2.0, cat="gpu_memcpy"),
        # the KV write: an index_select and an index_copy inside the range
        {"ph": "X", "cat": "gpu_user_annotation", "name": "kv_cache.write",
         "ts": 63.0, "dur": 10.0, "pid": 0, "tid": 7},
    ]
    attr = tattr.decode_attribution(events)
    assert attr == {"gather": 0.04, "write": 0.08, "attention": 0.2,
                    "kernel": 0.4, "other": 0.28, "top": "kernel",
                    "basis": "device-time", "device_us": 100.0,
                    "kernels_us": {"ln_fwd_warp_kernel": 5.0,
                                   "paged_combine_kernel": 5.0,
                                   "paged_split_kernel": 30.0}}
    assert sum(attr[k] for k in ("gather", "write", "attention", "kernel",
                                 "other")) == pytest.approx(1.0, abs=1e-3)


# ---------------------------------------------------------------------------
# the cost model and the executor's reports
# ---------------------------------------------------------------------------

def _feed(seed=0, batch=4):
    rng = np.random.RandomState(seed)
    return {n: rng.randint(0, LM["vocab"], (batch, LM["max_len"])
                           ).astype(np.int64) for n in ("tokens", "labels")}


def _hand_count(batch):
    """3 x (every product of the forward): forward, dX and dW."""
    m = batch * LM["max_len"]
    d, f, v, t = LM["d_model"], LM["d_ff"], LM["vocab"], LM["max_len"]
    per_layer = 2 * m * d * 3 * d + 2 * m * d * f + 2 * m * f * d \
        + 4 * batch * t * t * d
    return 3 * (LM["n_layers"] * per_layer + 2 * m * d * v)


def _port_report(amp=False, batch=4):
    tfluid.core.program.reset_default_programs()
    _, _, cost = TT.transformer_lm_train_program(**LM, amp=amp)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.core.scope.Scope()
    with tfluid.scope_guard(scope):
        exe.run(tfluid.default_startup_program())
        before = tintro.count()
        exe.run(feed=_feed(batch=batch), fetch_list=[cost])
        exe.run(feed=_feed(1, batch=batch), fetch_list=[cost])  # no new
    new = tintro.reports(layer="executor", since_seq=before)
    assert len(new) == 1
    return new[0]


@pytest.mark.parametrize("amp", [False, True])
def test_report_flops_equal_the_hand_count(amp):
    rep = _port_report(amp)
    assert rep["flops"] == _hand_count(4)
    assert rep["dtype"] == ("bf16" if amp else "f32")
    assert rep["steps"] == 1 and rep["device_name"] == "cpu"
    # the JAX report's terms: no temp rise on the CPU, and the state the
    # optimizer writes in place is the alias term
    assert rep["temp_bytes"] == 0 and rep["compile_seconds"] == 0.0
    assert rep["peak_bytes"] == (rep["argument_bytes"] + rep["output_bytes"]
                                 - rep["alias_bytes"]) > 0
    assert rep["bytes_accessed"] > 0
    assert set(jintro.CompiledReport.__slots__) <= set(rep)


def test_report_flops_against_xla_cost_analysis():
    jfluid.core.program.reset_default_programs()
    _, _, cost = JT.transformer_lm_train_program(**LM)
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(jfluid.default_startup_program())
    exe.run(feed=_feed(), fetch_list=[cost])
    xla = jintro.latest("executor")["flops"]
    ratio = _port_report()["flops"] / xla
    assert XLA_RATIO[0] <= ratio <= XLA_RATIO[1], ratio


def test_summary_and_format_report():
    _port_report()
    summ = tintro.summary()
    assert summ["layers"]["executor"]["programs"] >= 1
    json.dumps(summ)                              # the inspect RPC's body
    text = tintro.format_report(tintro.latest("executor"), roofline=True)
    assert "flops/step" in text and "bound by        unknown" in text
    rep = dict(tintro.latest("executor"), device_name=H100)
    assert "attained" in tintro.format_report(rep, roofline=True)
    assert tintro.sample_device_memory() in ({},)   # no card here


def test_decode_step_costs_agree_between_the_two_engines(tmp_path):
    """The decode step's report: the TransformerLM's analytic count and
    the generation Program's cost model give the same flops."""
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.serving import DecodeEngine
    spec = TT.generation_spec(**LM)
    scope = Scope()
    for name, arr in TT.random_params(spec, 0).items():
        scope.set(name, arr)
    d = str(tmp_path / "lm")
    TT.save_generation_model(d, **LM, scope=scope, init=False)
    flops = []
    for make in (lambda: DecodeEngine.from_model_dir(
                     d, device="cpu", slots=2, block_len=4, warmup=True),
                 lambda: DecodeEngine(scope, spec, device="cpu", slots=2,
                                      block_len=4, warmup=True)):
        before = tintro.count()
        eng = make()
        try:
            reps = tintro.reports(layer="predictor", since_seq=before)
            dec = [r for r in reps if "kv_len" not in r["feed_sig"]]
            assert len(dec) == 1
            flops.append(dec[0]["flops"])
        finally:
            eng.close()
    assert flops[0] == flops[1]
    m, span = 2, LM["max_len"]
    dm, f, v = LM["d_model"], LM["d_ff"], LM["vocab"]
    assert flops[0] == LM["n_layers"] * (
        2 * m * dm * 3 * dm + 4 * m * dm * f + 4 * m * span * dm) \
        + 2 * m * dm * v


# ---------------------------------------------------------------------------
# train_loop with the plane on
# ---------------------------------------------------------------------------

def _loop(tmp_path, **kw):
    tfluid.core.program.reset_default_programs()
    torch.manual_seed(0)
    _, _, cost = TT.transformer_lm_train_program(**LM, amp=True)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.core.scope.Scope()):
        exe.run(tfluid.default_startup_program())
        handles = exe.train_loop(feed=_feed(), fetch_list=[cost], steps=8,
                                 steps_per_launch=2, fetch_every=2, **kw)
    return [np.asarray(h.get()[0]).tobytes() for h in handles], exe


def test_train_loop_plane_on_is_bitwise_and_windows_match_jax(tmp_path):
    # one thread: multi-threaded CPU GEMMs need not repeat their bits
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain, exe0 = _loop(tmp_path)
        tl = str(tmp_path / "tl.json")
        xd = str(tmp_path / "xprof")
        observed, exe = _loop(tmp_path, timeline_path=tl, xprof_every=2,
                              xprof_steps=1, xprof_dir=xd)
    finally:
        torch.set_num_threads(threads)
    assert observed == plain
    assert exe0.last_xprof is None
    cap = exe.last_xprof
    # the JAX capture ticked at the same launches opens the same windows
    jcap = jattr.XprofCapture(str(tmp_path / "jx"), 2, 1)
    assert [w["step"] for w in cap.windows] == _ticks(jcap, range(0, 8, 2))
    assert cap.summary()["windows"] == 4 and cap.summary()["measured"] == 0
    doc = json.load(open(tl))
    runs = [e for e in doc["traceEvents"] if e["ph"] == "X"
            and e["name"] == "executor.run"]
    assert len(runs) == 8
    assert any(e["name"] == "flight:train" for e in doc["traceEvents"])
    assert not tfluid.profiler.is_enabled()
    rep = tintro.latest("executor")
    assert rep["steps"] == 2 and rep["flops"] == 2 * _hand_count(4)
    assert math.isclose(rep["flops"] / rep["steps"], _hand_count(4))
