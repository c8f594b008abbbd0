"""The port's Chrome-trace export (`paddle_tpu_torch.observability.
timeline`) against the JAX package's: for the same spans, flight records
and counters, `chrome_trace`, `stitch_processes`, `export_profile` and
`read_metrics_jsonl` give equal documents (exact: the functions are
the same arithmetic on the same floats)."""
import json
import os

import pytest

import paddle_tpu.profiler as jprof
from paddle_tpu.observability import flight as jflight
from paddle_tpu.observability import timeline as jtl

from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.observability import flight as tflight
from paddle_tpu_torch.observability import timeline as ttl

ORIGIN = (1_700_000_000.0, 50.0)
SPANS = [
    {"name": "client.request", "start": 50.10, "end": 50.30,
     "tid": "MainThread", "trace": ["t1"], "attrs": {}},
    {"name": "serving.request", "start": 50.12, "end": 50.29,
     "tid": "handler-1", "trace": ["t1"], "attrs": {"attempt": 1}},
    {"name": "engine.batch", "start": 50.15, "end": 50.25,
     "tid": "engine-0", "trace": ["t1", "t2"], "attrs": {}},
    {"name": "executor.run", "start": 50.16, "end": 50.24,
     "tid": "engine-0", "trace": ["t1", "t2"], "attrs": {}},
    {"name": "serving.request", "start": 50.13, "end": 50.28,
     "tid": "handler-2", "trace": ["t2"], "attrs": {}},
    {"name": "lonely", "start": 50.40, "end": 50.41, "tid": "x",
     "trace": [], "attrs": {}},
]
COUNTERS = [
    {"ts": ORIGIN[0] + 0.05, "metrics": {
        "engine_queue_depth": {"kind": "gauge",
                               "series": {"model=default": 3}},
        "engine_requests_total": {"kind": "counter", "series": {"": 7}},
        "engine_latency_seconds": {"kind": "summary",
                                   "series": {"quantile=0.5": 0.01}}}},
    {"ts": ORIGIN[0] + 0.25, "metrics": {
        "engine_queue_depth": {"kind": "gauge",
                               "series": {"model=default": 1}}}},
    {"metrics": {}},
]
FLIGHT = {"train": [
    {"ts": ORIGIN[0] + 0.11, "step": 0, "host_gap_s": 0.0,
     "dispatch_s": 0.02, "note": "", "nonfinite": False},
    {"ts": ORIGIN[0] + 0.21, "step": 1, "host_gap_s": 0.001,
     "dispatch_s": 0.021, "note": "fused[2]", "nonfinite": False}]}


@pytest.mark.parametrize("case", [
    dict(origin=ORIGIN, counters=COUNTERS, flight_records=FLIGHT),
    dict(origin=ORIGIN),
    dict(origin=None, counters=COUNTERS, flight_records=FLIGHT),
    dict(origin=ORIGIN, counters=COUNTERS, dropped_spans=4),
])
def test_chrome_trace_equals_jax(case):
    args = dict(case, pid=4242)
    want = jtl.chrome_trace(SPANS, **args)
    got = ttl.chrome_trace(SPANS, **args)
    assert got == want
    flows = [e for e in got["traceEvents"] if e["ph"] in "stf"]
    # t1 chains four spans, t2 three; the lonely span draws no flow
    assert len(flows) == 7
    assert {e["ph"] for e in flows} == {"s", "t", "f"}


def test_chrome_trace_without_spans_keeps_counters():
    got = ttl.chrome_trace([], counters=COUNTERS, flight_records=FLIGHT,
                           pid=1)
    assert got == jtl.chrome_trace([], counters=COUNTERS,
                                   flight_records=FLIGHT, pid=1)
    assert any(e["name"] == "flight:train" for e in got["traceEvents"])


def _proc(role, pid, host, origin, spans, flight=None):
    return {"role": role, "pid": pid, "host": host, "wall": origin[0],
            "origin": list(origin), "spans": spans, "flight": flight or {}}


def test_stitch_processes_equals_jax():
    skewed = (ORIGIN[0] + 0.002, 900.0)     # another process's clock
    procs = [
        _proc("client", 11, "h1", ORIGIN, SPANS[:1]),
        _proc("serve", 22, "h1", skewed,
              [dict(s, start=s["start"] + 849.9, end=s["end"] + 849.9)
               for s in SPANS[1:4]], flight=FLIGHT),
        # the same OS pid on another host stays a track of its own
        _proc("serve", 22, "h2", ORIGIN, SPANS[4:]),
        {"role": "anon", "pid": None, "origin": None, "spans": []},
    ]
    want = jtl.stitch_processes(procs)
    got = ttl.stitch_processes(procs)
    assert got == want
    pids = {e["pid"] for e in got["traceEvents"] if e["ph"] == "X"}
    assert len(pids) == 3
    arrows = [e for e in got["traceEvents"] if e["ph"] in "stf"
              and e["id"] == "t1"]
    assert len({e["pid"] for e in arrows}) == 2


def test_read_metrics_jsonl_equals_jax_and_skips_a_torn_line(tmp_path):
    path = tmp_path / "m.jsonl"
    with open(path, "w") as f:
        for line in COUNTERS:
            f.write(json.dumps(line) + "\n")
        f.write('{"ts": 1.0, "metr')               # a killed writer
    got = ttl.read_metrics_jsonl(str(path))
    assert got == jtl.read_metrics_jsonl(str(path)) == COUNTERS


def _session(prof, spans):
    """A profiler session holding exactly ``spans`` at ``ORIGIN``."""
    prof.start_profiler()
    prof._origin = ORIGIN
    for s in spans:
        prof._spans.append((s["name"], s["start"], s["end"], s["tid"],
                            tuple(s["trace"]), s["attrs"] or None))


@pytest.mark.parametrize("with_counters", [False, True])
def test_export_profile_equals_jax(tmp_path, with_counters):
    docs = []
    for prof, tl in ((jprof, jtl), (tprof, ttl)):
        _session(prof, SPANS)
        path = str(tmp_path / f"{prof.__name__}.json")
        tl.export_profile(path, counters=COUNTERS if with_counters
                          else None, include_flight=False)
        prof.stop_profiler(quiet=True)
        docs.append(json.load(open(path)))
    assert docs[0] == docs[1]


def test_export_profile_includes_live_flight_rings(tmp_path):
    recs = []
    for flight in (jflight, tflight):
        fr = flight.FlightRecorder("tl_test", ("ts", "step", "depth"))
        fr.record(ts=ORIGIN[0] + 0.2, step=3, depth=2)
        recs.append(fr)
    _session(tprof, SPANS)
    path = str(tmp_path / "tl.json")
    ttl.export_profile(path)
    tprof.stop_profiler(quiet=True)
    doc = json.load(open(path))
    track = [e for e in doc["traceEvents"]
             if e["name"] == "flight:tl_test"]
    assert track and track[0]["args"] == {"step": 3, "depth": 2}


def test_process_trace_doc_keys_and_window_like_jax():
    docs = []
    for prof, tl, flight in ((jprof, jtl, jflight), (tprof, ttl, tflight)):
        fr = flight.FlightRecorder("tl_window", ("ts", "step"))
        fr.record(ts=ORIGIN[0] + 0.2, step=1)      # inside t2's window
        fr.record(ts=ORIGIN[0] + 5.0, step=2)      # outside it
        _session(prof, SPANS)
        docs.append(tl.process_trace_doc("t2", role="serve"))
        prof.stop_profiler(quiet=True)
        del fr
    assert set(docs[0]) == set(docs[1])
    assert docs[0]["spans"] == docs[1]["spans"]
    assert docs[1]["role"] == "serve" and docs[1]["pid"] == os.getpid()
    assert docs[1]["origin"] == list(ORIGIN)
    assert docs[1]["flight"]["tl_window"] == [{"ts": ORIGIN[0] + 0.2,
                                               "step": 1}]
    assert docs[0]["flight"]["tl_window"] == docs[1]["flight"]["tl_window"]
