"""Performance attribution (counterpart of
``paddle_tpu/observability/attribution.py``): where a step's time goes,
on the card's terms.

- **Roofs** (`ROOFS`): the H100 SXM5 80GB HBM3's datasheet peaks, keyed
  by the name ``torch.cuda.get_device_name()`` gives that card.  On any
  other device `roofline` says ``"bound_by": "unknown"``.
- **Roofline** (`roofline`, `psum_share`): the JAX functions' arithmetic
  and keys over a report of `observability.introspect`.
- **Device time** (`device_step_split`, `XprofCapture`): bounded
  ``torch.profiler`` windows (``train_loop(xprof_every=...)``,
  ``serve --xprof``) written as Chrome traces under a log directory and
  split into compute, collective (NCCL kernels) and idle time.  A trace
  with no device events (the CPU) gives ``None``, as the JAX split does
  for a capture with no device plane.
- **Decode attribution** (`decode_attribution`): one profiled decode
  step's device time in the JAX classes, measured by kernel name: the
  port's own CUDA kernels (``kernel``, named from the ``__global__``
  functions of ``ops/csrc``), the products (``attention``), the KV-cache
  write (``write``, the kernels inside ``kv_cache.write`` ranges),
  gathers (``gather``) and the rest (``other``).

The JAX package's HLO parsers (``shape_bytes``, ``hlo_write_traffic``)
have no counterpart: eager PyTorch compiles no module to parse.
`collective_ledger` returns ``None``, which the JAX consumers read as
"unknown".
"""
from __future__ import annotations

import glob
import json
import os
import re
import time
from typing import Any, Dict, Iterable, List, Optional, Union

import torch

# ---------------------------------------------------------------------------
# hardware roofs
# ---------------------------------------------------------------------------

#: NVIDIA H100 SXM5 80GB HBM3, dense peaks from NVIDIA's datasheet:
#: bf16 tensor cores 989 TFLOP/s; f32 products at a third of the TF32
#: tensor-core rate (495 TFLOP/s over the 3xTF32 split's three passes);
#: f32 on the CUDA cores 67 TFLOP/s; HBM3 3.35 TB/s; NVLink 4 450 GB/s
#: each way (the comms roof, unused until the port shards).  The port's
#: int8 weights are dequantized to bf16 before their products.
H100_SXM_ROOFS = {
    "flops": {"bf16": 989e12, "f32": 495e12 / 3, "int8": 989e12,
              "f32_cuda_cores": 67e12},
    "hbm_bytes_per_s": 3.35e12,
    "link_bytes_per_s": 450e9,
}
ROOFS = {"NVIDIA H100 80GB HBM3": H100_SXM_ROOFS}


def roofs_for(device_name: Optional[str]) -> Optional[Dict[str, Any]]:
    """The roof table of a card by its ``torch.cuda.get_device_name()``,
    or None for a device this module has no datasheet for."""
    return ROOFS.get(device_name) if device_name else None


def current_device_name() -> Optional[str]:
    """The name of the current CUDA device, None without one."""
    try:
        if torch.cuda.is_available():
            return torch.cuda.get_device_name()
    except Exception:  # noqa: BLE001 — a CUDA that fails to start is no card
        pass
    return None


def collective_ledger(report_source=None) -> None:
    """The JAX package parses a compiled module's HLO for collectives;
    the port runs eagerly and has no module: always None ("unknown")."""
    return None


# ---------------------------------------------------------------------------
# roofline classifier
# ---------------------------------------------------------------------------

def roofline(report: Dict[str, Any],
             measured_step_seconds: Optional[float] = None,
             measured_split: Optional[Dict[str, float]] = None,
             device_name: Optional[str] = None) -> Dict[str, Any]:
    """Classify one report compute-, memory- or comms-bound against the
    roofs of ``device_name`` (default: the report's ``device_name``, else
    the current card), as the JAX function does: model times per step,
    ``bound_by`` the largest, ``attained_compute_frac`` the achieved
    FLOP rate over peak (the MFU when ``measured_step_seconds`` is
    given).  A measured ``measured_split`` (`device_step_split`) decides
    compute against comms.  On a device with no roof table,
    ``bound_by`` is ``"unknown"`` and the fractions are None."""
    name = (device_name or report.get("device_name")
            or current_device_name())
    roofs = roofs_for(name)
    steps = max(1, int(report.get("steps", 1) or 1))
    scale = steps * max(1, int(report.get("flops_scale", 1) or 1))
    ndev = max(1, int(report.get("num_devices", 1) or 1))
    dtype = report.get("dtype", "f32") or "f32"
    flops = float(report.get("flops", 0.0) or 0.0) / steps
    bytes_ = float(report.get("bytes_accessed", 0.0) or 0.0) / steps
    led = report.get("collectives") or {}
    comm_bytes = float(led.get("total_bytes", 0) or 0)
    basis = ("measured" if measured_step_seconds or measured_split
             else "modeled")
    if roofs is None:
        return {"bound_by": "unknown", "attained_compute_frac": None,
                "attained_memory_frac": None,
                "comm_bytes_per_step": int(comm_bytes),
                "model_times_s": None, "basis": basis,
                "device_name": name}
    peaks = roofs["flops"]
    peak_c = peaks.get(dtype, peaks["f32"]) * ndev
    t_compute = flops / peak_c
    t_memory = bytes_ / (roofs["hbm_bytes_per_s"] * ndev)
    t_comms = comm_bytes / roofs["link_bytes_per_s"]
    times = {"compute": t_compute, "memory": t_memory, "comms": t_comms}
    if measured_split:
        c_ps = float(measured_split.get("compute_ps", 0) or 0)
        x_ps = float(measured_split.get("collective_ps", 0) or 0)
        if c_ps or x_ps:
            times = {"compute": c_ps / 1e12, "memory": t_memory,
                     "comms": x_ps / 1e12}
    dominant = max(times.values())
    bound = (max(times, key=times.get) if dominant > 0 else "unknown")
    denom = (float(measured_step_seconds)
             if measured_step_seconds else dominant)
    out = {
        "bound_by": bound,
        "attained_compute_frac": (round(t_compute / denom, 5)
                                  if denom > 0 else 0.0),
        "attained_memory_frac": (round(t_memory / denom, 5)
                                 if denom > 0 else 0.0),
        "comm_bytes_per_step": int(comm_bytes),
        "model_times_s": {k: round(v, 9) for k, v in times.items()},
        "basis": basis,
        "device_name": name,
    }
    if bytes_ > 0 and comm_bytes > 0:
        out["comm_share_of_bytes"] = round(comm_bytes * scale
                                           / float(report["bytes_accessed"])
                                           if report.get("bytes_accessed")
                                           else 0.0, 4)
    mesh_shape = report.get("mesh_shape") or {}
    if int(mesh_shape.get("tp", 1) or 1) > 1 and led:
        out["tp_collective_bytes_per_step"] = int(comm_bytes)
    a2a = (led.get("kinds") or {}).get("all-to-all")
    if int(mesh_shape.get("ep", 1) or 1) > 1 and a2a:
        out["lookup_a2a_bytes_per_step"] = int(a2a.get("bytes", 0) or 0)
    return out


def psum_share(report: Dict[str, Any]) -> Optional[float]:
    """The all-reduce payload's share of a report's bytes per step; None
    without a ledger (always, in the port) or an all-reduce."""
    led = report.get("collectives") or {}
    ar = (led.get("kinds") or {}).get("all-reduce")
    if not ar or not report.get("bytes_accessed"):
        return None
    scale = (max(1, int(report.get("steps", 1) or 1))
             * max(1, int(report.get("flops_scale", 1) or 1)))
    per_step = float(report["bytes_accessed"]) / scale
    if per_step <= 0:
        return None
    return ar["bytes"] / per_step


# ---------------------------------------------------------------------------
# torch.profiler traces
# ---------------------------------------------------------------------------

#: Chrome-trace categories of the events that run on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: a device event whose name holds one of these is a collective
COLLECTIVE_MARKS = ("nccl",)


def find_trace(logdir_or_path: str) -> Optional[str]:
    """The newest ``*.json`` trace under a log directory (or the path)."""
    if os.path.isfile(logdir_or_path):
        return logdir_or_path
    cands = sorted(glob.glob(os.path.join(logdir_or_path, "**", "*.json"),
                             recursive=True), key=os.path.getmtime)
    return cands[-1] if cands else None


def load_trace(trace: Union[str, Dict[str, Any], Iterable]) -> List[Dict]:
    """The events of a Chrome trace: a path (file or log directory), a
    parsed document, or an iterable of event dicts."""
    if isinstance(trace, str):
        path = find_trace(trace)
        if path is None:
            return []
        with open(path) as f:
            trace = json.load(f)
    if isinstance(trace, dict):
        trace = trace.get("traceEvents", [])
    return [e for e in trace if isinstance(e, dict)]


def device_events(trace) -> List[Dict[str, Any]]:
    """The trace's complete events that ran on the card."""
    return [e for e in load_trace(trace)
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
            and "dur" in e]


def device_step_split(logdir_or_path) -> Optional[Dict[str, Any]]:
    """Compute / collective / idle split of a trace's device events (the
    first device seen): NCCL kernels are collective time, every other
    kernel, copy and fill compute; idle is the events' span less busy
    time (clamped: streams overlap).  Times in picoseconds, as the JAX
    split's.  None when the trace has no device events (the CPU)."""
    try:
        evs = device_events(logdir_or_path)
    except (OSError, ValueError):
        return None
    if not evs:
        return None
    dev = evs[0].get("pid")
    evs = [e for e in evs if e.get("pid") == dev]
    compute_ps = collective_ps = 0
    t0, t1 = None, 0.0
    for e in evs:
        ts, dur = float(e["ts"]), float(e["dur"])
        t0 = ts if t0 is None else min(t0, ts)
        t1 = max(t1, ts + dur)
        ps = int(round(dur * 1e6))
        if any(m in e.get("name", "").lower() for m in COLLECTIVE_MARKS):
            collective_ps += ps
        else:
            compute_ps += ps
    span = int(round((t1 - t0) * 1e6))
    return {"plane": f"cuda:{dev}", "compute_ps": int(compute_ps),
            "collective_ps": int(collective_ps),
            "idle_ps": int(max(0, span - compute_ps - collective_ps)),
            "events": len(evs)}


def torch_profiling() -> bool:
    """Whether a ``torch.profiler`` session is running in this process
    (one at a time)."""
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False))


def window_activities():
    """A capture window's activities: the card's events where there is
    one (CUPTI), else the host's."""
    from torch.profiler import ProfilerActivity
    if torch.cuda.is_available():
        return [ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


class XprofCapture:
    """Bounded ``torch.profiler`` windows for ``train_loop(xprof_every=N,
    xprof_steps=M)`` and ``serve --xprof``, with the JAX capture's
    cadence: ``tick(step)`` is called once a dispatch (a launch of a
    fused window), closes a window that has covered its M steps and
    opens the next when the cadence comes due.  A closed window's trace
    is written to ``<logdir>/step<N>/trace.json`` and split
    (`device_step_split`); ``windows`` gets ``{"step", "logdir", "split",
    "trace", "start_s", "stop_s", "overhead_s"}``: the seconds spent
    starting the window (in the tick that opened it; CUPTI's first start
    costs seconds), stopping and writing it (in the tick that closed it)
    and their sum.  A window cannot start while another profiler runs: the
    capture then goes dead, and never raises into the loop."""

    def __init__(self, logdir: str, every: int, steps: int = 1):
        self.logdir = str(logdir)
        self.every = max(1, int(every))
        self.steps = max(1, int(steps))
        self.windows: List[Dict[str, Any]] = []
        self._active: Optional[int] = None
        self._next = 0
        self._dead = False
        self._prof = None
        self._dir = None
        self._start_s = 0.0

    def _start(self, step: int):
        t0 = time.perf_counter()
        d = os.path.join(self.logdir, f"step{step}")
        try:
            if torch_profiling():
                raise RuntimeError("another profiler is active")
            os.makedirs(d, exist_ok=True)
            prof = torch.profiler.profile(activities=window_activities())
            prof.start()
        except Exception:  # noqa: BLE001 — a capture never kills the loop
            self._dead = True
            return
        self._prof = prof
        self._active = step
        self._dir = d
        self._start_s = time.perf_counter() - t0

    def _stop(self):
        t0 = time.perf_counter()
        path = os.path.join(self._dir, "trace.json")
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.stop()
            self._prof.export_chrome_trace(path)
        except Exception:  # noqa: BLE001
            self._dead = True
            self._active = None
            self._prof = None
            return
        self._prof = None
        self.windows.append({"step": self._active, "logdir": self._dir,
                             "split": device_step_split(path),
                             "trace": path, "start_s": self._start_s,
                             "stop_s": time.perf_counter() - t0,
                             "overhead_s": self._start_s
                             + time.perf_counter() - t0})
        self._next = self._active + self.every
        self._active = None

    def tick(self, step: int):
        if self._dead:
            return
        if self._active is not None and step >= self._active + self.steps:
            self._stop()
        if self._active is None and not self._dead and step >= self._next:
            self._start(step)

    def finish(self):
        """Close an open window (the end of the loop or session)."""
        if self._active is not None and not self._dead:
            self._stop()

    def summary(self) -> Dict[str, Any]:
        """JSON-safe rollup over every closed window (the JAX keys)."""
        splits = [w["split"] for w in self.windows if w.get("split")]
        out: Dict[str, Any] = {"windows": len(self.windows),
                               "measured": len(splits)}
        if splits:
            tot = {k: sum(s[k] for s in splits)
                   for k in ("compute_ps", "collective_ps", "idle_ps")}
            busy = tot["compute_ps"] + tot["collective_ps"]
            whole = busy + tot["idle_ps"]
            if whole > 0:
                out.update(
                    compute_share=round(tot["compute_ps"] / whole, 4),
                    collective_share=round(
                        tot["collective_ps"] / whole, 4),
                    idle_share=round(tot["idle_ps"] / whole, 4))
        return out


# ---------------------------------------------------------------------------
# decode-step attribution
# ---------------------------------------------------------------------------

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ops", "csrc")
_GLOBAL_RE = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*"
                        r"\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")
_port_kernel_names: Optional[frozenset] = None


def port_kernel_names() -> frozenset:
    """The ``__global__`` function names of the port's CUDA sources."""
    global _port_kernel_names
    if _port_kernel_names is None:
        names = set()
        for path in sorted(glob.glob(os.path.join(_CSRC, "*.cu*"))):
            with open(path) as f:
                names.update(_GLOBAL_RE.findall(f.read()))
        _port_kernel_names = frozenset(names)
    return _port_kernel_names


#: the profiler range around the KV-cache write (ops/kv_cache_ops.py)
WRITE_RANGE = "kv_cache.write"
#: kernel-name marks of the library products (cuBLAS, CUTLASS)
PRODUCT_MARKS = ("gemm", "gemv", "xmma", "cutlass", "nvjet", "splitk",
                 "cublas")
#: kernel-name marks of gathers (embedding rows, index_select)
GATHER_MARKS = ("indexselect", "index_select", "gather", "embedding")
DECODE_CLASSES = ("gather", "write", "attention", "kernel")
_IDENT_RE = re.compile(r"[A-Za-z_]\w*")


def classify_kernel(name: str, in_write: bool = False) -> str:
    """The decode class of one device event by its kernel name."""
    if any(tok in port_kernel_names() for tok in _IDENT_RE.findall(name)):
        return "kernel"
    low = name.lower()
    if any(m in low for m in PRODUCT_MARKS):
        return "attention"
    if in_write:
        return "write"
    if any(m in low for m in GATHER_MARKS):
        return "gather"
    return "other"


def decode_attribution(trace) -> Optional[Dict[str, Any]]:
    """Shares of one profiled decode step's device time: ``gather``,
    ``write``, ``attention``, ``kernel`` and ``other`` (`classify_kernel`;
    a kernel inside a ``kv_cache.write`` range is the write), ``top``
    the largest of the first four, ``basis`` ``"device-time"``, the
    step's ``device_us`` and the port kernels' ``kernels_us`` by
    ``__global__`` name.  None when the trace has no device events."""
    events = load_trace(trace)
    devs = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in DEVICE_CATEGORIES and "dur" in e]
    if not devs:
        return None
    writes = [(e.get("pid"), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events if e.get("cat") == "gpu_user_annotation"
              and e.get("name") == WRITE_RANGE and "dur" in e]
    by_class = dict.fromkeys(DECODE_CLASSES + ("other",), 0.0)
    ours: Dict[str, float] = {}
    for e in devs:
        ts, dur = float(e["ts"]), float(e["dur"])
        inside = any(p == e.get("pid") and a <= ts and ts + dur <= b + 1e-3
                     for p, a, b in writes)
        name = e.get("name", "")
        cls = classify_kernel(name, inside)
        by_class[cls] += dur
        if cls == "kernel":
            g = next(t for t in _IDENT_RE.findall(name)
                     if t in port_kernel_names())
            ours[g] = ours.get(g, 0.0) + dur
    total = sum(by_class.values())
    if total <= 0:
        return None
    out: Dict[str, Any] = {k: round(v / total, 4)
                           for k, v in by_class.items()}
    out["top"] = max(DECODE_CLASSES, key=lambda k: by_class[k])
    out["basis"] = "device-time"
    out["device_us"] = round(total, 3)
    out["kernels_us"] = {k: round(v, 3) for k, v in sorted(ours.items())}
    return out
