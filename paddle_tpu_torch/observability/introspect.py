"""Per-program cost reports (counterpart of
``paddle_tpu/observability/introspect.py``).

The JAX package registers a report for every executable XLA compiles,
from ``cost_analysis()`` and ``memory_analysis()``.  Eager PyTorch
compiles nothing, so the port registers a report the first time the
`Executor`, a `Predictor` or a `DecodeEngine` runs a (program
fingerprint, feed signature), under the JAX keys and metric families:

- ``flops`` and ``bytes_accessed`` come from a cost model over the
  program's live ops at the shapes that first run gave (`program_cost`):
  ``mul``/``matmul``/``conv2d`` products at 2·M·N·K, attention at its QKᵀ
  and PV products (``fused_attention`` over its key span,
  ``paged_attention`` over the slot's whole page span), and a
  ``backward`` op at twice the products of the forward it differentiates.
  Bytes are each op's input and output bytes, except the paged KV pools,
  of which only the rows an op reads or writes count;
- ``peak_bytes`` is built from the JAX report's terms: argument +
  output + temp - alias bytes.  Arguments are the run's feeds and the
  parameters it reads, outputs its fetches and the state it writes, both
  counted from their tensors (`tensor_bytes`); the state an optimizer
  writes in place is the alias term, as the JAX step's donated state is.
  Temp is how far ``torch.cuda.max_memory_allocated`` rose above the
  memory allocated before the run (0 on the CPU, or when the run stayed
  under an earlier peak: the allocator's peak is never reset here);
- under a mesh every term is the rank's own: its shards and its slice of
  the feed.  ``mesh_shape``, ``num_devices`` and ``sharding_summary``
  (the resident placement of each feed and state tensor) come from the
  `parallel.Partitioner` (or from the caller, as `parallel.pipeline`'s
  reports give them), and ``collectives`` from the counts of
  `parallel.collectives` over the run;
- ``compile_seconds`` is 0.0 and ``steps`` the window's K.

The report also names its ``device_name`` (the card's
``torch.cuda.get_device_name()``, or ``"cpu"``), which
`attribution.roofline` looks its roofs up by.
"""
from __future__ import annotations

import contextlib
import math
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from . import attribution
from .registry import default_registry

# past the cap the oldest reports go
MAX_REPORTS = 512

_lock = threading.Lock()
_reports: List["CompiledReport"] = []
_seq = 0

_COMPILED_PROGRAMS = default_registry().gauge(
    "executor_compiled_programs",
    "programs currently tracked by the introspection registry",
    labelnames=("layer",))
_COMPILED_FLOPS = default_registry().counter(
    "executor_compiled_flops_total",
    "sum of the cost model's flops over all registered programs",
    labelnames=("layer",))
_COMPILED_PEAK_BYTES = default_registry().gauge(
    "executor_compiled_peak_bytes",
    "largest measured first-run peak memory of any registered program",
    labelnames=("layer",))
_DEVICE_MEM = default_registry().gauge(
    "executor_device_memory_bytes",
    "device memory in use, from torch.cuda.memory_allocated",
    labelnames=("device",))
_COLLECTIVE_BYTES = default_registry().counter(
    "executor_collective_bytes_total",
    "per-step collective payload bytes (parallel.collectives' counts)",
    labelnames=("layer", "kind"))


class CompiledReport:
    """One program's identity and cost at one feed signature."""

    __slots__ = ("seq", "layer", "fingerprint", "feed_sig", "fetch_names",
                 "flops", "bytes_accessed", "argument_bytes", "output_bytes",
                 "temp_bytes", "alias_bytes", "generated_code_bytes",
                 "peak_bytes",
                 "input_shardings", "output_shardings", "compile_seconds",
                 "steps", "dtype", "mesh_shape", "num_devices",
                 "sharding_summary", "collectives", "flops_scale",
                 "created_at", "device_name")

    def to_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self.__slots__}

    def __repr__(self):
        return (f"<CompiledReport layer={self.layer} fp={self.fingerprint} "
                f"flops={self.flops:.3g} peak_bytes={self.peak_bytes}>")


def feed_signature(feed: Dict[str, Any]) -> Tuple:
    """(name, shape, dtype) of every feed, sorted, with numpy's dtype
    names (the JAX executor's ``_feed_sig``)."""
    out = []
    for k, v in feed.items():
        dt = str(getattr(v, "dtype", type(v).__name__)).replace("torch.", "")
        out.append((k, tuple(getattr(v, "shape", ())), dt))
    return tuple(sorted(out))


def device_name_of(device) -> str:
    """The card's name for a CUDA device, else the device type."""
    import torch
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def tensor_bytes(values: Iterable[Any]) -> int:
    """The bytes of the distinct tensors among ``values`` (a tensor seen
    twice, or two views of one storage, count once); anything that is
    not a tensor counts 0."""
    import torch
    seen = set()
    total = 0
    for v in values:
        if not isinstance(v, torch.Tensor):
            continue
        try:
            key = (v.untyped_storage().data_ptr(), v.device)
        except RuntimeError:
            key = id(v)
        if key in seen:
            continue
        seen.add(key)
        total += _nbytes(v)
    return total


def record_run(*, layer: str, device, fingerprint: str = "",
               feed_sig: Any = None, fetch_names=(), flops: float = 0.0,
               bytes_accessed: float = 0.0, argument_bytes: int = 0,
               output_bytes: int = 0, temp_bytes: int = 0,
               alias_bytes: int = 0, steps: int = 1, dtype: str = "f32",
               partitioner=None, sharding_summary=None,
               collectives=None, mesh_shape=None,
               num_devices=None) -> CompiledReport:
    """Register the report of a first run on ``device`` and sample the
    device memory (a first run is when it moves); ``flops`` and
    ``bytes_accessed`` are one step's, and scale by ``steps`` as the JAX
    report's do.  ``peak_bytes`` is argument + output + temp - alias
    (module docstring); a ``partitioner`` names the run's mesh, else
    ``mesh_shape`` and ``num_devices`` do."""
    rep = CompiledReport()
    rep.layer = str(layer)
    rep.fingerprint = str(fingerprint)
    rep.feed_sig = None if feed_sig is None else str(feed_sig)
    rep.fetch_names = [str(n) for n in fetch_names]
    rep.steps = max(1, int(steps))
    rep.dtype = str(dtype or "f32")
    rep.mesh_shape = dict(mesh_shape) if mesh_shape else None
    rep.num_devices = int(num_devices or 1)
    rep.input_shardings = []
    rep.output_shardings = []
    rep.sharding_summary = dict(sharding_summary or {})
    if partitioner is not None:
        rep.mesh_shape = partitioner.mesh_shape()
        rep.num_devices = partitioner.num_devices
    rep.flops_scale = 1
    rep.flops = float(flops) * rep.steps
    rep.bytes_accessed = float(bytes_accessed) * rep.steps
    rep.collectives = (collectives if collectives
                       else attribution.collective_ledger())
    rep.argument_bytes = int(argument_bytes)
    rep.output_bytes = int(output_bytes)
    rep.temp_bytes = int(temp_bytes)
    rep.alias_bytes = int(alias_bytes)
    rep.generated_code_bytes = 0
    rep.peak_bytes = max(0, rep.argument_bytes + rep.output_bytes
                         + rep.temp_bytes - rep.alias_bytes)
    rep.compile_seconds = 0.0
    rep.created_at = time.time()
    rep.device_name = device_name_of(device)

    global _seq
    with _lock:
        _seq += 1
        rep.seq = _seq
        _reports.append(rep)
        if len(_reports) > MAX_REPORTS:
            del _reports[:len(_reports) - MAX_REPORTS]
        per_layer = sum(1 for r in _reports if r.layer == rep.layer)
    _COMPILED_PROGRAMS.labels(layer=rep.layer).set(per_layer)
    _COMPILED_FLOPS.labels(layer=rep.layer).inc(rep.flops)
    peak_g = _COMPILED_PEAK_BYTES.labels(layer=rep.layer)
    if rep.peak_bytes > peak_g.value:
        peak_g.set(rep.peak_bytes)
    if rep.collectives:
        for kind, ent in rep.collectives["kinds"].items():
            _COLLECTIVE_BYTES.labels(layer=rep.layer,
                                     kind=kind).inc(ent["bytes"])
    sample_device_memory()
    return rep


@contextlib.contextmanager
def first_run_memory(device):
    """Measure a first run's temp term: yields a one-element list that
    holds, after the block, how far ``max_memory_allocated`` rose above
    the memory allocated before it (0 on the CPU, or when the block
    stayed under an earlier peak; the peak is never reset)."""
    import torch
    out = [0]
    device = torch.device(device)
    if device.type != "cuda":
        yield out
        return
    a0 = torch.cuda.memory_allocated(device)
    m0 = torch.cuda.max_memory_allocated(device)
    yield out
    m1 = torch.cuda.max_memory_allocated(device)
    out[0] = int(m1 - a0) if m1 > m0 else 0


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

#: ops whose products the model counts
PRODUCT_OPS = ("mul", "matmul", "conv2d", "depthwise_conv2d",
               "conv2d_transpose", "fused_attention", "paged_attention")
#: the paged pools' slots: only the rows an op touches count as bytes
_POOL_SLOTS = ("PoolK", "PoolV", "PoolKOut", "PoolVOut")


def _nbytes(t) -> int:
    return int(t.numel()) * int(t.element_size())


def _shape(env, op, slot) -> Optional[Tuple[int, ...]]:
    names = op.desc.inputs.get(slot) or op.desc.outputs.get(slot) or ()
    v = env.get(names[0]) if names else None
    return tuple(v.shape) if hasattr(v, "shape") else None


def op_flops(op, env) -> int:
    """The products of one op at the shapes in ``env`` (0 for any op that
    is not in `PRODUCT_OPS`)."""
    t = op.type
    try:
        if t == "mul":
            y, out = _shape(env, op, "Y"), _shape(env, op, "Out")
            k = math.prod(y[:int(op.desc.attrs.get("y_num_col_dims", 1))])
            return 2 * math.prod(out) * k
        if t == "matmul":
            x, out = _shape(env, op, "X"), _shape(env, op, "Out")
            if len(x) == 1:
                k = x[0]
            else:
                k = x[-2] if op.desc.attrs.get("transpose_X") else x[-1]
            return 2 * math.prod(out) * k
        if t in ("conv2d", "depthwise_conv2d"):
            w, out = _shape(env, op, "Filter"), _shape(env, op, "Output")
            return 2 * math.prod(out) * math.prod(w[1:])
        if t == "conv2d_transpose":
            w, x = _shape(env, op, "Filter"), _shape(env, op, "Input")
            return 2 * math.prod(x) * math.prod(w[1:])
        if t == "fused_attention":
            q, k = _shape(env, op, "Q"), _shape(env, op, "K")
            b, h, tq, d = q
            return 4 * b * h * tq * k[2] * d
        if t == "paged_attention":
            q = _shape(env, op, "Q")
            pages, pool = _shape(env, op, "PageTable"), _shape(env, op,
                                                               "PoolK")
            s, h, tq, d = q
            return 4 * s * h * tq * pages[1] * pool[1] * d
    except (TypeError, IndexError, ValueError):
        return 0
    return 0


def op_bytes(op, env) -> int:
    """One op's input and output bytes at ``env``; of the paged pools
    only the rows it reads (``paged_attention``: every slot's page span)
    or writes (``kv_cache_write``: the new K and V rows)."""
    total = 0
    seen = set()
    for slots in (op.desc.inputs, op.desc.outputs):
        for slot, names in slots.items():
            if slot in _POOL_SLOTS:
                continue
            for n in names:
                v = env.get(n)
                if n not in seen and hasattr(v, "element_size"):
                    seen.add(n)
                    total += _nbytes(v)
    if op.type == "paged_attention":
        pool, pages = _shape(env, op, "PoolK"), _shape(env, op, "PageTable")
        v = env.get(op.desc.inputs["PoolK"][0])
        if pool and pages:
            total += (2 * pages[0] * pages[1] * math.prod(pool[1:])
                      * v.element_size())
    elif op.type == "kv_cache_write":
        pool = env.get(op.desc.inputs["PoolK"][0])
        k = env.get(op.desc.inputs["K"][0])
        if pool is not None and k is not None:
            total += 2 * 2 * int(k.numel()) * pool.element_size()
    return total


def program_cost(program, env: Dict[str, Any],
                 live: Optional[Iterable[bool]] = None) -> Tuple[int, int]:
    """(flops, bytes) of one run of ``program``'s global block, from the
    values its run left in ``env``; ``live`` marks the ops that ran (an
    op whose outputs are not in ``env`` did not).  A ``backward`` op
    costs twice the products of its forward (the JAX convention of three
    products a trained product: forward, dX, dW); ops inside sub-blocks
    are not counted."""
    block = program.global_block()
    live = list(live) if live is not None else [True] * len(block.ops)
    flops, nbytes = 0, 0
    fwd = []
    for i, op in enumerate(block.ops):
        if not live[i]:
            fwd.append(0)
            continue
        if op.type == "backward":
            end = int(op.desc.attrs.get("forward_op_end", i))
            f = 2 * sum(fwd[:end])
        else:
            f = op_flops(op, env)
        fwd.append(f if op.type != "backward" else 0)
        flops += f
        nbytes += op_bytes(op, env)
    return flops, nbytes


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------

def count() -> int:
    """Reports ever registered (monotonic, survives eviction)."""
    with _lock:
        return _seq


def reports(layer: Optional[str] = None,
            since_seq: int = 0) -> List[Dict[str, Any]]:
    """Registered reports as dicts, oldest first, optionally one layer's
    and/or those after ``since_seq`` (an earlier `count`)."""
    with _lock:
        out = list(_reports)
    return [r.to_dict() for r in out
            if (layer is None or r.layer == layer) and r.seq > since_seq]


def latest(layer: Optional[str] = None) -> Optional[Dict[str, Any]]:
    with _lock:
        out = list(_reports)
    for r in reversed(out):
        if layer is None or r.layer == layer:
            return r.to_dict()
    return None


def summary() -> Dict[str, Any]:
    """JSON-safe snapshot (the ``inspect`` RPC's reply): every report and
    per-layer aggregates."""
    reps = reports()
    layers: Dict[str, Dict[str, float]] = {}
    for r in reps:
        agg = layers.setdefault(r["layer"],
                                {"programs": 0, "flops": 0.0,
                                 "peak_bytes": 0, "compile_seconds": 0.0,
                                 "collective_bytes": 0})
        agg["programs"] += 1
        agg["flops"] += r["flops"]
        agg["peak_bytes"] = max(agg["peak_bytes"], r["peak_bytes"])
        agg["compile_seconds"] += r["compile_seconds"]
        led = r.get("collectives")
        if led:
            agg["collective_bytes"] += led.get("total_bytes", 0)
    return {"layers": layers, "programs": reps}


def clear():
    """Drop every report (test isolation only)."""
    global _seq
    with _lock:
        _reports.clear()
        _seq = 0


def sample_device_memory() -> Dict[str, int]:
    """Set ``executor_device_memory_bytes{device}`` from
    ``torch.cuda.memory_allocated`` for every card; nothing while the
    registry is disabled or without CUDA."""
    if not default_registry().enabled:
        return {}
    import torch
    out: Dict[str, int] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        used = int(torch.cuda.memory_allocated(i))
        name = f"cuda:{i}"
        out[name] = used
        _DEVICE_MEM.labels(device=name).set(float(used))
    return out


# ---------------------------------------------------------------------------
# offline model-dir inspection (the `inspect` CLI verb's engine)
# ---------------------------------------------------------------------------

def inspect_model_dir(model_dir: str, batch_size: int = 1,
                      params_filename: Optional[str] = None,
                      transpile: bool = True,
                      device=None) -> Dict[str, Any]:
    """Load a saved inference model on ``device`` (the card unless
    ``"cpu"``), run one zero batch of ``batch_size`` and return its
    report with the model's identity."""
    import torch
    from ..core.types import to_torch_dtype
    from ..serving.predictor import Predictor

    pred = Predictor.from_model_dir(model_dir,
                                    params_filename=params_filename,
                                    transpile=transpile, device=device)
    before = count()
    block = pred.program.global_block()
    feed = {}
    for name in pred.feed_names:
        var = block.vars[name]
        shape = list(var.shape)
        if shape and (shape[0] is None or shape[0] < 0):
            shape[0] = int(batch_size)
        bad = [d for d in shape[1:] if d is None or d < 0]
        if bad:
            raise ValueError(
                f"feed var {name!r} has non-batch dynamic dims "
                f"{var.shape}; inspect cannot synthesize a batch — run a "
                "real request through serving and use `inspect ENDPOINT`")
        feed[name] = torch.zeros([int(d) for d in shape],
                                 dtype=to_torch_dtype(var.dtype))
    pred.run(feed)
    new = reports(layer="predictor", since_seq=before)
    param_bytes = int(sum(_nbytes(v) for v in pred._params.values()))
    return {"model_dir": model_dir,
            "fingerprint": pred.fingerprint,
            "feed_names": list(pred.feed_names),
            "fetch_names": list(pred.fetch_names),
            "batch_size": int(batch_size),
            "param_bytes": param_bytes,
            "report": new[-1] if new else None}


def format_report(rep: Optional[Dict[str, Any]], indent: str = "  ",
                  roofline: bool = False) -> str:
    """Human-readable rendering of one report (the CLI's table body);
    ``roofline=True`` adds `attribution.roofline`'s verdict."""
    if not rep:
        return f"{indent}(no report)"
    lines = [
        f"{indent}flops/step      {rep['flops']:,.0f}"
        f"  ({rep['flops'] / 1e9:.3f} GFLOP)",
        f"{indent}bytes accessed  {rep['bytes_accessed']:,.0f}",
        f"{indent}peak memory     {rep['peak_bytes']:,} B"
        f"  (argument + output + temp - alias)",
        f"{indent}device          {rep.get('device_name')}",
    ]
    if rep.get("steps", 1) > 1:
        lines.insert(0, f"{indent}steps/launch    {rep['steps']}  "
                        "(a window of steps; costs cover all of them)")
    if roofline:
        rl = attribution.roofline(rep)
        times = rl["model_times_s"]
        if times is None:
            lines.append(f"{indent}bound by        unknown  (no roof "
                         f"table for {rl['device_name']!r})")
        else:
            lines.append(
                f"{indent}bound by        {rl['bound_by']}  "
                f"(model t: compute {times['compute']:.3g}s, "
                f"memory {times['memory']:.3g}s, "
                f"comms {times['comms']:.3g}s per step)")
            lines.append(
                f"{indent}attained        compute "
                f"{rl['attained_compute_frac']:.1%} / memory "
                f"{rl['attained_memory_frac']:.1%} of roof "
                f"({rl['basis']}); comm {rl['comm_bytes_per_step']:,} "
                "B/step")
        tp = rl.get("tp_collective_bytes_per_step")
        if tp is not None:
            lines.append(f"{indent}tp collectives  {tp:,} B/step over the "
                         "tp groups")
    return "\n".join(lines)
