"""The port's profiler (`paddle_tpu_torch.profiler`) against the JAX
package's `paddle_tpu.profiler`: the same calls in both give the same
event table (names, calls), the same spans by trace id, the same ring
eviction under a small ``MAX_SPANS`` and the same ``profile_path`` JSON
keys; the disabled ``record_block`` is one shared null context.  Times
differ run to run, so the table is compared by its non-time columns."""
import json
import sys
import threading

import pytest
import torch

import paddle_tpu.profiler as jprof
from paddle_tpu.observability import trace as jtrace

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.observability import trace as ttrace

PACKAGES = [(jprof, jtrace), (tprof, ttrace)]


@pytest.fixture(autouse=True)
def _quiet_profilers():
    for prof, _ in PACKAGES:
        prof.stop_profiler(quiet=True)
        prof.reset_profiler()
    yield
    for prof, _ in PACKAGES:
        prof.stop_profiler(quiet=True)
        prof.reset_profiler()


def _drive(prof, trace):
    """One session: three spans of two names, two of them in trace
    scopes, one with attributes; -> the table."""
    prof.start_profiler()
    with trace.scope("aaaa"):
        with prof.record_block("alpha"):
            pass
    with trace.scope("bbbb", "aaaa"):
        prof.record_span("beta", 1.0, 1.5, attrs={"attempt": 2})
    with prof.record_block("alpha"):
        pass
    prof.record_event("gamma", 0.25)
    return prof.stop_profiler(sorted_key="calls", quiet=True)


def _rows(table):
    """(event, calls) of each row of the table."""
    lines = table.splitlines()
    return [tuple(ln.split()[:2]) for ln in lines]


def test_event_table_matches_jax():
    tables = [_drive(p, t) for p, t in PACKAGES]
    assert _rows(tables[0]) == _rows(tables[1])
    assert _rows(tables[1])[0] == ("Event", "Calls")
    assert ("alpha", "2") in _rows(tables[1])
    # the same header and column layout, letter for letter
    assert tables[0].splitlines()[0] == tables[1].splitlines()[0]


@pytest.mark.parametrize("key", ["total", "calls", "max", "min", None])
def test_table_sort_keys_order_like_jax(key):
    """Hand-made event tables sort the same way in both packages."""
    for prof, _ in PACKAGES:
        prof.start_profiler()
        for name, secs in (("a", 0.3), ("b", 0.1), ("b", 0.5), ("c", 0.2),
                           ("c", 0.2), ("c", 0.2)):
            prof.record_event(name, secs)
    tables = [p.stop_profiler(sorted_key=key, quiet=True)
              for p, _ in PACKAGES]
    assert tables[0] == tables[1]


def test_get_spans_by_trace_id_like_jax():
    for prof, trace in PACKAGES:
        _drive(prof, trace)
    for tid in (None, "aaaa", "bbbb", "zzzz"):
        got = [[(s["name"], s["trace"], s["attrs"]) for s in p.get_spans(tid)]
               for p, _ in PACKAGES]
        assert got[0] == got[1], tid
    spans = tprof.get_spans("aaaa")
    assert [s["name"] for s in spans] == ["alpha", "beta"]
    assert spans[1]["start"] == 1.0 and spans[1]["end"] == 1.5
    assert spans[0]["tid"] == threading.current_thread().name


def test_max_spans_ring_evicts_oldest_half_like_jax(monkeypatch):
    for prof, _ in PACKAGES:
        monkeypatch.setattr(prof, "MAX_SPANS", 6)
    for prof, _ in PACKAGES:
        prof.start_profiler()
        for i in range(15):
            prof.record_span(f"s{i}", float(i), float(i) + 0.5)
    got = [([s["name"] for s in p.get_spans()], p.dropped_spans())
           for p, _ in PACKAGES]
    assert got[0] == got[1]
    names, dropped = got[1]
    assert dropped == 9 and names == [f"s{i}" for i in range(9, 15)]
    # the event table keeps every record
    table = tprof.stop_profiler(quiet=True)
    assert len(table.splitlines()) == 16
    tprof.start_profiler()
    assert tprof.dropped_spans() == 0 and tprof.get_spans() == []


def test_profile_path_json_keys_like_jax(tmp_path):
    docs = []
    for i, (prof, trace) in enumerate(PACKAGES):
        prof.start_profiler()
        with prof.record_block("alpha"):
            pass
        path = str(tmp_path / f"p{i}.json")
        prof.stop_profiler(profile_path=path, quiet=True)
        docs.append(json.load(open(path)))
    assert set(docs[0]) == set(docs[1]) == {"spans", "origin",
                                            "dropped_spans"}
    assert set(docs[0]["spans"][0]) == set(docs[1]["spans"][0])
    wall, perf = docs[1]["origin"]
    assert wall > 1e9 and perf > 0


def test_disabled_record_block_is_the_shared_null_context():
    assert not tprof.is_enabled()
    c1 = tprof.record_block("x")
    assert c1 is tprof.record_block("y") is tprof._NULL_BLOCK
    assert tprof.device_range("z") is tprof._NULL_BLOCK
    with c1, c1:        # reentrant
        pass
    assert tprof.get_spans() == []
    # under a torch.profiler it is a record_function range instead
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(tprof.record_block("x"),
                          torch.profiler.record_function)


def test_profiler_context_writes_span_log_and_torch_trace(tmp_path):
    """``profiler(profile_path=...)`` around executor runs: the span log
    holds the ``executor.run`` spans, ``<path>.trace.json`` the
    torch.profiler trace; ``timeline_path`` the Chrome trace."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tlayers.data(name="x", shape=[4], dtype="float32")
        y = tlayers.fc(input=x, size=2)
    scope = tfluid.core.scope.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    path = str(tmp_path / "run.prof")
    with tfluid.scope_guard(scope):
        exe.run(startup)
        with tprof.profiler(profile_path=path,
                            timeline_path=str(tmp_path / "tl.json")):
            for _ in range(3):
                exe.run(main, feed={"x": torch.ones(2, 4)}, fetch_list=[y])
    spans = json.load(open(path))["spans"]
    assert [s["name"] for s in spans].count("executor.run") == 3
    trace_doc = json.load(open(path + ".trace.json"))
    assert any(e.get("name") == "executor.run"
               for e in trace_doc["traceEvents"])
    tl = json.load(open(str(tmp_path / "tl.json")))
    assert sum(e["ph"] == "X" for e in tl["traceEvents"]) == 3


def test_start_stop_trace_session(tmp_path):
    tprof.start_trace(str(tmp_path / "tr"))
    with pytest.raises(RuntimeError, match="already active"):
        tprof.start_trace(str(tmp_path / "tr2"))
    torch.ones(3).sum()
    path = tprof.stop_trace()
    assert json.load(open(path))["traceEvents"]
    with pytest.raises(RuntimeError, match="no profiler"):
        tprof.stop_trace()
    with tprof.cuda_profiler(str(tmp_path / "cp")):
        torch.ones(3).sum()
    assert (tmp_path / "cp" / "trace.json").exists()


def test_concurrent_spans_lose_nothing(monkeypatch):
    """Threads recording spans at once, more threads than cores, the log
    a small ring: every record is either in the log or counted as
    dropped, and the event table counts every one."""
    monkeypatch.setattr(tprof, "MAX_SPANS", 64)
    n_threads, per_thread = 16, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tprof.start_profiler()

        def body():
            for i in range(per_thread):
                tprof.record_span("s", float(i), float(i) + 1.0)
                with tprof.record_block("b"):
                    pass
        threads = [threading.Thread(target=body) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    total = 2 * n_threads * per_thread
    assert len(tprof.get_spans()) + tprof.dropped_spans() == total
    calls = {row[0]: int(row[1]) for row in
             _rows(tprof.stop_profiler(quiet=True))[1:]}
    assert calls == {"s": total // 2, "b": total // 2}
