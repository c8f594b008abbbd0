"""Executor (counterpart of ``paddle_tpu/core/executor.py``).

``Executor(place).run(program, feed, fetch_list)`` interprets the
program's global block on the place's device (`core.lowering`):

- a startup-like program (no feeds, no fetches, reads no data var)
  materialises its persistables into the scope;
- feeds are cast to each data var's declared dtype; a ragged feed's
  ``<name>@SEQ_LEN`` length vector stays int32;
- state lives in the scope as device tensors and is updated in place by
  the optimize ops: a step copies no state, and every scope tensor
  leaves the step as a plain leaf (no autograd history).  The scope is
  always current, so `sync_scope` has nothing to do;
- fetches come back detached, as numpy unless ``return_numpy=False``;
- ``check_nan_inf`` (default ``FLAGS.check_nan_inf``) poisons non-finite
  op outputs and raises `NonFiniteError` when a floating fetch is not
  finite, reduced on the device to one boolean a fetch; a step the loss
  scaler skipped (`optimizer.MixedPrecision`) is counted, not raised.

``train_loop`` is the steady-state loop with the JAX package's signature
and contract: a window of ``fetch_every`` steps pays one host sync, in
which the per-step NaN/Inf codes (reduced on the device) are checked;
the next batch is staged on the card (pinned, ``non_blocking``, a side
stream) while the current step runs; ``steps_per_launch=K`` runs windows
of K micro-steps from one stacked feed (a `reader.StackedBatch`, or K
batches stacked on the host and copied once).  Where the JAX package
launches one ``lax.scan`` for the K steps, the port runs K eager steps
in a row, the same function as per-step ``run`` on the same state, so
losses and final parameters are bitwise those of per-step ``run``.
Checkpoints (`checkpoint.CheckpointManager`), resume, the fault point
``train.step`` and the flight recorder (`observability.flight`, dumped
on an exception and on SIGUSR1) are the JAX package's.  The executor's
generator state rides each checkpoint as ``@TORCH_RNG_STATE@``, so a
resumed run draws the same dropout masks.

``Executor()`` with no place means the card and raises without CUDA.
A program bound to a reader-op pipeline (``layers.read_file``) needs no
feed: ``run`` pulls the next batch and raises `EOFException`
at the end of a pass, and ``train_loop(feed=None)`` takes the pipeline
as its feed until the pass ends.

Observability, as the JAX executor's: every step runs inside an
``executor.run`` profiler span; the first run of a (program, feed
signature, fetch list, window size) registers its cost report
(`observability.introspect`) and samples the device memory, which every
window sync samples again; ``train_loop(timeline_path=...)`` profiles
the loop and writes its Chrome trace, and ``xprof_every=N`` captures a
``torch.profiler`` window of ``xprof_steps`` steps every N
(`observability.attribution.XprofCapture`, read back as ``last_xprof``).

Meshes (`parallel`).  ``train_loop(mesh=, param_spec=, data_axis=,
numerics=)`` binds a `parallel.Partitioner` (kept on the executor, as
`set_partitioner` binds one; with no mesh the loop adopts the process
mesh of `parallel.set_mesh`).  Every rank runs the same loop on the same
global feeds (SPMD over ``torch.distributed``).  The state is placed
once by the rule: the scope keeps each rank's shard.  ``"exact"`` gathers
the batch and every shard at step entry, runs the single-device step and
keeps each rank's shard of the new state, bitwise the single-process
run; ``"fast"`` runs the step partitioned (`parallel.partitioner`).
Fetches are the global values on every rank.  A one-rank mesh runs the
plain path.  Checkpoints under a mesh are written shard-wise: each rank
writes the shards it is the first holder of, rank 0 the manifest (the
JAX package's format, with each var's spec).

Refused: ``train_loop``'s ``lookup_exchange``, ``a2a_capacity`` and
``tiered`` (the sharded embeddings; ROADMAP queue A item 4); and, in
``run`` and ``train_loop``, a program with an
``embedding(is_distributed=True)`` table, whose row-sharded lookup is not
ported either.
"""
from __future__ import annotations

import itertools
import os
import tempfile
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from . import lowering
from .place import CUDAPlace
from .program import Program, Variable, default_main_program
from .scope import Scope, global_scope
from .types import to_torch_dtype
from .. import fault as _fault
from .. import profiler
from ..flags import FLAGS
from ..observability import default_registry as _obs_registry
from ..observability import flight as _flight
from ..observability import introspect as _introspect
from ..parallel import collectives as _coll

#: the scope and checkpoint name of the executor's generator state
RNG_STATE_VAR = "@TORCH_RNG_STATE@"

# the JAX executor's families, letter for letter; guarded no-ops until
# the process registry is enabled
_EXEC_RUN_S = _obs_registry().histogram(
    "executor_run_seconds", "jitted step execution time",
    labelnames=("layer",)).labels(layer="executor")
_EXEC_NAN_INF = _obs_registry().counter(
    "executor_nan_inf_trips_total",
    "FLAGS_check_nan_inf aborts (non-finite fetch detected)")
_EXEC_AMP_SKIP = _obs_registry().counter(
    "executor_amp_overflow_skips_total",
    "train steps skipped by the dynamic loss scaler (grad overflow)")
_EXEC_HOST_GAP_S = _obs_registry().histogram(
    "executor_host_gap_seconds",
    "host time between consecutive step dispatches")
_EXEC_IN_FLIGHT = _obs_registry().gauge(
    "executor_steps_in_flight",
    "steps dispatched but not yet retired by a host sync")
_PREFETCH_DEPTH = _obs_registry().gauge(
    "reader_prefetch_depth",
    "batches staged on device ahead of dispatch",
    labelnames=("source",)).labels(source="train_loop")

#: one flight record per dispatched step and per window sync
_TRAIN_FLIGHT_FIELDS = ("ts", "step", "host_gap_s", "dispatch_s",
                        "fetch_sync_s", "in_flight", "prefetch_depth",
                        "nonfinite", "note")

#: per-step codes of the window sync: a genuine NaN/Inf, a clean step, a
#: step the loss scaler skipped
_STEP_BAD, _STEP_OK, _STEP_SKIP = 0, 1, 2

_SHARDED = "queue A item 4"


def _host(t: torch.Tensor) -> np.ndarray:
    """A fetched tensor as a numpy snapshot (a bf16 tensor as f32, every
    value exact: numpy has no bf16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


class FetchHandle:
    """The fetches of one ``train_loop`` step, still on the device.

    ``get()`` brings them to the host once (cached); until then they cost
    nothing.  The handles of a window are retired by its sync."""

    __slots__ = ("step", "fetch_names", "_device", "_host")

    def __init__(self, step: int, fetch_names: Sequence[str],
                 device_values):
        self.step = step
        self.fetch_names = list(fetch_names)
        self._device = tuple(device_values)
        self._host = None

    def get(self, return_numpy: bool = True):
        """The fetches, as numpy arrays (default) or device tensors."""
        if not return_numpy:
            return list(self._device)
        if self._host is None:
            self._host = [_host(v) for v in self._device]
        return list(self._host)

    def __repr__(self):
        state = "materialized" if self._host is not None else "in-flight"
        return (f"<FetchHandle step={self.step} "
                f"fetches={self.fetch_names} {state}>")


class _FusedLaunch:
    """A window's fetches stacked on the device, shared by its steps'
    handles: the host pulls each fetch once a window."""

    __slots__ = ("device", "_host")

    def __init__(self, device_values):
        self.device = tuple(device_values)
        self._host = None

    def host(self):
        if self._host is None:
            self._host = [_host(v) for v in self.device]
        return self._host


class _FusedFetchHandle(FetchHandle):
    """One step's view into its window's stacked fetches."""

    __slots__ = ("_launch", "_idx")

    def __init__(self, step: int, fetch_names: Sequence[str],
                 launch: _FusedLaunch, idx: int):
        self.step = step
        self.fetch_names = list(fetch_names)
        self._launch = launch
        self._idx = idx
        self._device = launch.device
        self._host = None

    def get(self, return_numpy: bool = True):
        if not return_numpy:
            return [v[self._idx] for v in self._launch.device]
        if self._host is None:
            self._host = [h[self._idx] for h in self._launch.host()]
        return list(self._host)


class EOFException(Exception):
    """Raised by ``Executor.run`` when the bound reader's pass ends."""


class NonFiniteError(RuntimeError):
    """``check_nan_inf`` tripped: a fetch holds NaN or Inf."""


def _finite_code(fetches, found_inf, device):
    """The step's code as an int8 device scalar: clean unless a floating
    fetch is non-finite, a skip when the loss scaler's found_inf is set;
    None when there is nothing to check."""
    flags = [torch.isfinite(v).all() for v in fetches
             if isinstance(v, torch.Tensor) and v.is_floating_point()]
    if not flags and found_inf is None:
        return None
    ok = (torch.stack(flags).all() if flags
          else torch.ones((), dtype=torch.bool, device=device))
    code = ok.to(torch.int8)
    if found_inf is not None:
        code = torch.where(found_inf.reshape(()).bool(),
                           torch.full_like(code, _STEP_SKIP), code)
    return code


def _reader_op_feed(reader):
    """A program-bound reader-op pipeline as a ``train_loop`` feed: the
    end of its pass ends the feed (where ``run`` raises EOFException)."""
    def gen():
        while True:
            try:
                yield reader.next_feed()
            except EOFException:
                return
    return gen


def _refuse_distributed(program: Program):
    """An ``is_distributed`` table is row-sharded over a mesh in the JAX
    package, which refuses to run it with no mesh bound; the port does
    not shard tables yet, so it always refuses (it would train the table
    replicated).
    The tables are the ``W`` of every ``lookup_table(is_distributed=True)``
    of the main block (the JAX ``parallel.embedding.distributed_tables``);
    the scan runs again only when the block's op count changes."""
    ops = program.global_block().ops
    if getattr(program, "_undistributed_at", None) == len(ops):
        return
    tables = sorted({name for op in ops if op.type == "lookup_table"
                     and op.desc.attrs.get("is_distributed")
                     for name in op.desc.inputs.get("W", [])})
    if tables:
        raise ValueError(
            "layers.embedding(is_distributed=True): program has "
            f"distributed table(s) {tables} but no mesh is bound "
            "- the table would train replicated and lie about capacity.  "
            f"Row-sharded tables are not ported (ROADMAP {_SHARDED}); "
            "single-device training wants is_sparse=True without "
            "is_distributed.")
    program._undistributed_at = len(ops)


def _refuse(what: str, label: str):
    raise NotImplementedError(f"train_loop({what}) is not ported "
                              f"(ROADMAP {label})")


class Executor:
    def __init__(self, place=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.torch_device()
        self._generator: Optional[torch.Generator] = None
        self.check_nan_inf = FLAGS.check_nan_inf
        #: step dispatches: one a ``run``, one a train_loop window
        self.launches = 0
        self._flight: Optional[_flight.FlightRecorder] = None
        self._in_flight = 0
        self._last_dispatch_t: Optional[float] = None
        self._stage_stream = None
        #: the last train_loop's XprofCapture (None without xprof_every)
        self.last_xprof = None
        #: (program, feed signature, fetches, steps) already reported
        self._reported: set = set()
        self._program_fps: Dict[Any, str] = {}
        #: the bound `parallel.Partitioner` (None: the single-device path)
        self._partitioner = None

    def set_partitioner(self, partitioner):
        """Bind (or clear, with None) the placement rules of every later
        step.  An equivalent partitioner (same rule object, same
        fingerprint) keeps the one bound; otherwise the state is placed
        again under the new rules at the next step (a sharded var is
        gathered under the old rules first)."""
        cur = self._partitioner
        if partitioner is cur:
            return
        if (partitioner is not None and cur is not None
                and partitioner.rule_token() is cur.rule_token()
                and partitioner.fingerprint() == cur.fingerprint()):
            return
        self._partitioner = partitioner

    def _sharded(self):
        """The bound partitioner when it shards (a one-rank mesh runs the
        plain path)."""
        p = self._partitioner
        return p if (p is not None and p.use_sharding) else None

    def _rng(self, program: Program) -> torch.Generator:
        """One generator per executor on its device, seeded from the
        first program it runs."""
        if self._generator is None:
            g = torch.Generator(device=self.device)
            g.manual_seed(int(program.random_seed or 0))
            self._generator = g
        return self._generator

    # -- run -----------------------------------------------------------------
    def run(self,
            program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence[Union[Variable, str]]] = None,
            scope: Optional[Scope] = None,
            return_numpy: bool = True,
            use_program_cache: bool = True):
        program = program or default_main_program()
        scope = scope or global_scope()
        feed = feed or {}
        reader = program._bound_reader
        if not feed and reader is not None:
            # raises EOFException at the end of a pass
            feed = reader.next_feed()
        fetch_names = [f.name if isinstance(f, Variable) else f
                       for f in (fetch_list or [])]
        if self._is_startup_like(program, feed, fetch_names):
            lowering.run_startup(program, scope, self.device,
                                 self._rng(program))
            return []
        _refuse_distributed(program)
        fi_name = self._found_inf_name(program)
        names = fetch_names + [fi_name] if fi_name else fetch_names
        t0 = time.perf_counter()
        fetches = self._dispatch(
            program, scope, self._prepare_feed(program.global_block(), feed),
            names)
        self._stamp_dispatch(t0)
        found_inf = fetches.pop() if fi_name else None
        if FLAGS.benchmark and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.check_nan_inf:
            self._raise_on_nonfinite(fetch_names, fetches, found_inf)
        if return_numpy:
            # a snapshot: a fetched scope tensor keeps training in place
            out = [_host(f) for f in fetches]
            if out:
                self._mark_synced()
            return out
        return fetches

    def _found_inf_name(self, program: Program) -> Optional[str]:
        """The loss scaler's found_inf, fetched beside the user's fetches
        when ``check_nan_inf`` is on, so that a handled overflow reads as
        a skip."""
        ls = getattr(program, "_loss_scaling", None)
        return ls["found_inf"] if (self.check_nan_inf and ls) else None

    def _dispatch(self, program: Program, scope: Scope,
                  feed: Dict[str, torch.Tensor],
                  fetch_names: Sequence[str],
                  report_steps: int = 1) -> List[torch.Tensor]:
        """One step: interpret the global block over the scope's state
        and ``feed`` (tensors on the device), write the persistables
        back, return the fetches (detached, on the device).  The first
        step of a (program, feed signature, fetches, ``report_steps``)
        registers its report; ``report_steps=0`` skips the check.  Under
        a partitioner the step runs on the mesh (module docstring)."""
        block = program.global_block()
        part = self._sharded()
        env, specs = self._state(block, scope)
        key = None
        if report_steps:
            key = (id(program), len(block.ops),
                   _introspect.feed_signature(feed), tuple(fetch_names),
                   report_steps)
            if key in self._reported:
                key = None
        since = _coll.counts() if key is not None else None
        step = None
        feed_specs = {}
        if part is not None:
            feed_specs = {n: str(part.feed_spec(tuple(v.shape)))
                          for n, v in feed.items()}
            if part.numerics == "exact":
                feed = self._exact_feed(part, feed)
                for name, spec in specs.items():
                    env[name] = part.gather(env[name], spec)
            else:
                step = part.step(program, specs)
                feed = step.slice_feed(feed)
                step.prepare(env)
        state_vals = None
        if key is not None:
            # the state as it rests in the scope, and the generator's
            # state (the JAX step's RNG key)
            state_vals = ([scope.get_local(n) for n in env if n not in feed]
                          + [self._rng(program).get_state()])
        env.update(feed)
        interp = lowering.Interpreter(program, self.device,
                                      self._rng(program), fetch_names,
                                      self.check_nan_inf, partitioner=step)
        with profiler.record_block("executor.run"):
            if key is None:
                interp.run_block(block, env)
            else:
                with _introspect.first_run_memory(self.device) as peak:
                    interp.run_block(block, env)
        for v in block.vars.values():
            if v.persistable and v.name in env:
                val = env[v.name]
                if isinstance(val, torch.Tensor):
                    val = val.detach()
                if v.name in specs:
                    self._write_shard(scope, part, v.name, specs[v.name],
                                      val)
                else:
                    scope.set(v.name, val)
        fetches = [env[n].detach() for n in fetch_names]
        if step is not None:
            fetches = [step.fetch(block, n, f)
                       for n, f in zip(fetch_names, fetches)]
        if key is not None:
            self._report(program, env, interp, key, peak[0], state_vals,
                         fetches, specs, feed, feed_specs, since)
        return fetches

    @staticmethod
    def _exact_feed(part, feed):
        """Exact numerics: each rank keeps its data-axis slice, and the
        step gathers the batch at entry (bit-exact)."""
        out = {}
        for name, v in feed.items():
            spec = part.feed_spec(tuple(v.shape))
            if part.is_sharded(spec):
                v = part.gather(part.shard(v, spec), spec)
            out[name] = v
        return out

    @staticmethod
    def _write_shard(scope, part, name, spec, val):
        """Keep this rank's shard of a sharded var's new value (a whole
        value is cut to the shard; the resident tensor keeps its
        storage)."""
        local = scope.get_local(name)
        if val is local or not isinstance(val, torch.Tensor):
            return
        with torch.no_grad():
            if tuple(val.shape) != tuple(local.shape):
                val = part.shard(val, spec)
            local.copy_(val)

    def _report(self, program, env, interp, key, temp_bytes, state_vals,
                fetches, specs, feed, feed_specs, since):
        """Register the cost report of a first run (`_dispatch`): peak
        from argument (state, feeds and the generator's state), output
        (fetches and the state the step returns), temp (the measured
        rise) and alias (the returned state, updated in place) bytes,
        each this rank's under a mesh."""
        self._reported.add(key)
        fp_key = (id(program), key[1])
        fp = self._program_fps.get(fp_key)
        if fp is None:
            from ..io import program_fingerprint
            fp = self._program_fps[fp_key] = program_fingerprint(program)
        block = program.global_block()
        flops, nbytes = _introspect.program_cost(
            program, env, interp.live_ops(block))
        part = self._partitioner
        summary = {}
        if part is not None:
            for s in feed_specs.values():
                summary[s] = summary.get(s, 0) + 1
            for name in env:
                if name in feed or not isinstance(env[name], torch.Tensor):
                    continue
                s = str(specs.get(name, "PartitionSpec()"))
                summary[s] = summary.get(s, 0) + 1
        _introspect.record_run(
            layer="executor", device=self.device, fingerprint=fp,
            feed_sig=key[2], fetch_names=key[3], flops=flops,
            bytes_accessed=nbytes,
            # the step returns its whole state, updated in place (the
            # JAX step's donated state): an output and the alias term
            argument_bytes=_introspect.tensor_bytes(
                state_vals + list(feed.values())),
            output_bytes=_introspect.tensor_bytes(list(fetches)
                                                  + state_vals),
            temp_bytes=temp_bytes,
            alias_bytes=_introspect.tensor_bytes(state_vals),
            steps=key[4],
            dtype="bf16" if getattr(program, "amp", False) else "f32",
            partitioner=part, sharding_summary=summary,
            collectives=_coll.ledger(since))

    def _stamp_dispatch(self, t0: float, steps: int = 1):
        now = time.perf_counter()
        _EXEC_RUN_S.observe(now - t0)
        last = self._last_dispatch_t
        if last is not None:
            # the gap and in-flight series count logical steps: a
            # window's gap is spread over its steps
            gap = (now - last) / steps
            for _ in range(steps):
                _EXEC_HOST_GAP_S.observe(gap)
        self._last_dispatch_t = now
        self.launches += 1
        self._in_flight += steps
        _EXEC_IN_FLIGHT.set(self._in_flight)

    def _mark_synced(self):
        """A host sync retired every step in flight; the next dispatch
        must not count the sync as a host gap."""
        self._in_flight = 0
        _EXEC_IN_FLIGHT.set(0)
        self._last_dispatch_t = None

    def _raise_on_nonfinite(self, fetch_names, fetches, found_inf=None):
        if found_inf is not None and bool(found_inf.reshape(-1)[0]):
            # the loss scaler skipped this step's update: survivable,
            # even when the (unscaled) loss fetch is non-finite
            _EXEC_AMP_SKIP.inc()
            return
        flagged = [(name, torch.isfinite(val).all())
                   for name, val in zip(fetch_names, fetches)
                   if isinstance(val, torch.Tensor)
                   and val.is_floating_point()]
        if not flagged:
            return
        ok = torch.stack([f for _, f in flagged]).cpu().numpy()
        if ok.all():
            return
        _EXEC_NAN_INF.inc()
        bad = ", ".join(repr(name)
                        for (name, _), good in zip(flagged, ok) if not good)
        raise NonFiniteError(f"Tensor(s) {bad} contain NaN/Inf "
                             "(FLAGS_check_nan_inf)")

    def sync_scope(self):
        """The JAX executor's write-back of bound state; the port's scope
        is always current."""

    def _state(self, block, scope: Scope):
        """The block's persistables from the scope, as tensors on this
        executor's device (a value that is not one yet is placed once and
        written back, so later steps update it in place) -> (env, specs).
        Under a partitioner a var its rule shards is stored as this
        rank's shard, and ``specs`` names each sharded var's spec; a var
        sharded under other rules is gathered first."""
        part = self._sharded()
        env, specs = {}, {}
        for v in block.vars.values():
            if not v.persistable:
                continue
            val = scope.get_local(v.name)
            if val is None:
                continue
            placed = scope.sharding(v.name)
            if placed is not None:
                if placed[0] is part:
                    env[v.name] = val
                    specs[v.name] = placed[1]
                    continue
                val = placed[0].gather(val, placed[1])
                scope.set(v.name, val)
            if not isinstance(val, torch.Tensor):
                # a copy: the optimizer updates scope tensors in place
                val = torch.tensor(np.asarray(val), device=self.device)
                scope.set(v.name, val)
            elif val.device != self.device:
                val = val.to(self.device)
                scope.set(v.name, val)
            if part is not None and val.dim() > 0:
                spec = part.param_spec(v.name, tuple(val.shape))
                if part.is_sharded(spec):
                    val = part.shard(val, spec).clone()
                    scope.set_local(v.name, val, part, spec)
                    specs[v.name] = spec
            env[v.name] = val
        if part is not None:
            part.warn_rule_misses()
        return env, specs

    @staticmethod
    def _feed_dtype(block, name: str, t: torch.Tensor) -> torch.dtype:
        if name.endswith(lowering.LEN_SUFFIX):
            return torch.int32
        var = block.vars.get(name)
        if var is not None and var.dtype is not None:
            return to_torch_dtype(var.dtype)
        return t.dtype

    def _prepare_feed(self, block, feed: Dict[str, Any]) -> Dict[str, Any]:
        """A feed dict on this executor's device, ready for the step."""
        return self._stage(block, feed).take()

    @staticmethod
    def _is_startup_like(program: Program, feed, fetch_names) -> bool:
        if feed or fetch_names:
            return False
        block = program.global_block()
        return all(not any(n in block.vars and block.vars[n].desc.is_data
                           for n in op.desc.input_names())
                   for op in block.ops)

    # -- train_loop ----------------------------------------------------------
    def train_loop(self,
                   program: Optional[Program] = None,
                   feed: Any = None,
                   fetch_list: Optional[Sequence[Union[Variable, str]]] = None,
                   steps: Optional[int] = None,
                   fetch_every: Optional[int] = None,
                   steps_per_launch: int = 1,
                   scope: Optional[Scope] = None,
                   checkpoint_dir: Optional[str] = None,
                   checkpoint_every: Optional[int] = None,
                   resume_from: Optional[str] = None,
                   keep_last_n: int = 3,
                   timeline_path: Optional[str] = None,
                   flight_path: Optional[str] = None,
                   mesh=None,
                   param_spec=None,
                   data_axis: str = "dp",
                   numerics: Optional[str] = None,
                   lookup_exchange: Optional[str] = None,
                   a2a_capacity: Optional[int] = None,
                   tiered: Optional[Dict[str, int]] = None,
                   xprof_every: Optional[int] = None,
                   xprof_steps: int = 1,
                   xprof_dir: Optional[str] = None) -> List[FetchHandle]:
        """The steady-state training loop; returns one `FetchHandle` a
        step.

        ``feed`` is a reader (a zero-arg callable returning an iterable
        of feed dicts), an iterable of feed dicts, or one feed dict
        (which needs ``steps``); a list or tuple cycles when ``steps``
        exceeds its length.  ``feed=None`` reads the program's bound
        reader-op pipeline (``layers.read_file``) to the end of its
        pass.  Each iteration dispatches step i, then
        stages batch i+1 on the device while step i runs.  The host
        syncs once every ``fetch_every`` steps (default: once, at the
        end): the window's handles retire and its per-step NaN/Inf codes
        (under ``check_nan_inf``) are checked, naming the first bad
        step; a step the loss scaler skipped counts as a skip.  Losses
        and final parameters are bitwise those of per-step ``run``.

        ``steps_per_launch=K`` runs windows of K micro-steps from one
        stacked feed; a feed of `reader.StackedBatch` windows
        (``reader.device_prefetch(..., stack=K)``) sets the window size
        by itself.  Window syncs and the checkpoint cadence round to
        window boundaries, and a ragged last window runs fewer steps.

        ``checkpoint_every=N`` snapshots the state every N steps into
        ``checkpoint_dir`` asynchronously (device clones on the caller's
        thread, everything else on the writer thread).  ``resume_from``
        restarts from that directory's latest committed checkpoint:
        parameters, accumulators, the loss scaler, the generator state
        and the reader position come back, ``steps`` is the global step
        target and the handles carry global step numbers.

        Every step is recorded in the executor's flight recorder, dumped
        to ``flight_path`` (default: ``flight_recorder.json`` in the
        checkpoint dir, else a pid-scoped temporary file) on an
        exception, a NaN trip or a fault point, and on SIGUSR1.

        ``timeline_path`` profiles the loop (unless an outer profiling
        session owns the profiler) and writes its Chrome trace on return.
        ``xprof_every=N`` captures a ``torch.profiler`` window every N
        logical steps, each covering ``xprof_steps`` steps (whole windows
        under ``steps_per_launch``), under ``xprof_dir`` (default:
        ``xprof/`` in the checkpoint dir, else a pid-scoped temporary
        directory); ``last_xprof.summary()`` reads them back.
        """
        program = program or default_main_program()
        scope = scope or global_scope()
        for what, given in (("lookup_exchange", lookup_exchange is not None),
                            ("a2a_capacity", a2a_capacity is not None),
                            ("tiered", bool(tiered))):
            if given:
                _refuse(what, _SHARDED)
        self._bind_mesh(mesh, param_spec, data_axis, numerics)
        _refuse_distributed(program)
        if feed is None:
            if program._bound_reader is None:
                raise ValueError("train_loop(feed=None) reads the program's "
                                 "bound reader op (layers.read_file); this "
                                 "program has none")
            feed = _reader_op_feed(program._bound_reader)
        fetch_names = tuple(f.name if isinstance(f, Variable) else f
                            for f in (fetch_list or []))
        if fetch_every is not None and fetch_every <= 0:
            fetch_every = None
        if checkpoint_every is not None and checkpoint_every <= 0:
            checkpoint_every = None

        manager = None
        start_step = 0
        if resume_from or checkpoint_every:
            from ..checkpoint import CheckpointManager
            ckpt_dir = checkpoint_dir or resume_from
            if ckpt_dir is None:
                raise ValueError(
                    "checkpoint_every needs checkpoint_dir (or resume_from)")
            manager = CheckpointManager(ckpt_dir, keep_last_n=keep_last_n)
            if resume_from:
                start_step = self._resume(manager, program, scope)
            if checkpoint_every is None:
                manager.close()
                manager = None
        if steps is not None and start_step >= steps:
            return []

        fr = self._ensure_flight(flight_path, checkpoint_dir or resume_from)
        from ..reader.decorator import StackedBatch
        it = self._feed_iter_resumed(feed, steps, start_step)
        first = next(it, None)
        if first is not None:
            it = itertools.chain([first], it)
        k = max(int(steps_per_launch or 1), 1)
        fused = k > 1 or isinstance(first, StackedBatch)
        block = program.global_block()
        fi_name = self._found_inf_name(program)
        disp_names = fetch_names + (fi_name,) if fi_name else fetch_names
        # a fetched persistable is the scope's own tensor, which later
        # steps update in place: such a fetch is copied at its step
        persistable = {v.name for v in block.vars.values() if v.persistable}
        alias = frozenset(j for j, n in enumerate(fetch_names)
                          if n in persistable)
        consumed = [start_step]

        def stage_next():
            """The next window on the device: (staged batch, its step
            count), or None when the feed or ``steps`` ends."""
            remaining = None if steps is None else steps - consumed[0]
            if remaining is not None and remaining <= 0:
                return None
            head = next(it, None)
            if head is None:
                return None
            if isinstance(head, StackedBatch):
                if not fused:
                    raise ValueError(
                        "stacked batch (device_prefetch stack=K) arrived "
                        "mid-stream in a per-step train_loop; a stacked "
                        "feed must be stacked from its first batch")
                n = head.k if remaining is None else min(head.k, remaining)
                staged = self._stage(block, {
                    name: (v if n == head.k else v[:n])
                    for name, v in head.items()})
                consumed[0] += n
                return staged, n
            if not fused:
                consumed[0] += 1
                return self._stage(block, head), 1
            want = k if remaining is None else min(k, remaining)
            raws = [head]
            while len(raws) < want:
                nxt = next(it, None)
                if nxt is None:
                    break
                if isinstance(nxt, StackedBatch):
                    raise ValueError("mixed stacked and per-step feeds in "
                                     "one train_loop window")
                raws.append(nxt)
            consumed[0] += len(raws)
            return self._stage(block, _stack_feeds(raws)), len(raws)

        xprof = None
        if xprof_every:
            from ..observability.attribution import XprofCapture
            base = xprof_dir or (
                os.path.join(checkpoint_dir, "xprof") if checkpoint_dir
                else os.path.join(tempfile.gettempdir(),
                                  f"paddle_tpu_torch_xprof_{os.getpid()}"))
            xprof = XprofCapture(base, xprof_every, xprof_steps)
        self.last_xprof = xprof
        own_profile = bool(timeline_path) and not profiler.is_enabled()
        if own_profile:
            profiler.start_profiler()
        handles: List[FetchHandle] = []
        window: List[FetchHandle] = []
        finite: List[Any] = []
        self._mark_synced()
        i = start_step
        fr_push = fr.push
        t_prev = None
        try:
            try:
                try:
                    staged = stage_next()
                    _PREFETCH_DEPTH.set(1 if staged is not None else 0)
                    while staged is not None:
                        cur, n = staged
                        if xprof is not None:
                            # before the dispatch: a window covers whole
                            # launches' device work
                            xprof.tick(i)
                        t_d0 = time.perf_counter()
                        for _ in range(n):
                            # count-based kill points count logical steps
                            _fault.maybe_fault("train.step")
                        batch = cur.take()
                        step_fetches, codes = [], []
                        for j in range(n):
                            feed_j = (batch if not fused else
                                      {name: v[j].clone()
                                       for name, v in batch.items()})
                            fetches = self._dispatch(
                                program, scope, feed_j, disp_names,
                                report_steps=n if j == 0 else 0)
                            fi = fetches.pop() if fi_name else None
                            if alias:
                                fetches = [v.clone() if idx in alias else v
                                           for idx, v in enumerate(fetches)]
                            step_fetches.append(fetches)
                            if self.check_nan_inf:
                                code = _finite_code(fetches, fi, self.device)
                                codes.append(code if code is not None else
                                             torch.full((), _STEP_OK,
                                                        dtype=torch.int8,
                                                        device=self.device))
                        self._stamp_dispatch(t_d0, steps=n)
                        staged = stage_next()
                        depth = 1 if staged is not None else 0
                        _PREFETCH_DEPTH.set(depth)
                        t_d1 = time.perf_counter()
                        gap = 0.0 if t_prev is None else t_d0 - t_prev
                        ts = time.time()
                        if fused:
                            launch = _FusedLaunch(
                                torch.stack([f[idx] for f in step_fetches])
                                for idx in range(len(fetch_names)))
                        for j in range(n):
                            fr_push((ts, i + j, gap / n, (t_d1 - t_d0) / n,
                                     0.0, self._in_flight, depth, 0,
                                     (f"fused[{n}]" if fused and j == 0
                                      else "")))
                            h = (_FusedFetchHandle(i + j, fetch_names,
                                                   launch, j) if fused
                                 else FetchHandle(i + j, fetch_names,
                                                  step_fetches[j]))
                            handles.append(h)
                            window.append(h)
                        t_prev = t_d1
                        if codes:
                            finite.append((i, torch.stack(codes), n))
                        prev_i, i = i, i + n
                        if (fetch_every is not None
                                and i // fetch_every > prev_i // fetch_every):
                            self._timed_window_sync(window, finite, fr, i - 1)
                        if (manager is not None
                                and (i - start_step) // checkpoint_every
                                > (prev_i - start_step) // checkpoint_every):
                            self._checkpoint(manager, program, scope, i)
                finally:
                    self._timed_window_sync(window, finite, fr, i - 1)
                    _PREFETCH_DEPTH.set(0)
            except BaseException as e:
                self._flight_abort(fr, i, e)
                raise
        finally:
            if xprof is not None:
                xprof.finish()
            if manager is not None:
                # the newest checkpoint is durable before control returns
                manager.close()
            self._finish_timeline(own_profile, timeline_path)
        return handles

    def _bind_mesh(self, mesh, param_spec, data_axis, numerics):
        """``train_loop``'s mesh arguments -> the bound partitioner (the
        JAX executor's rules: an explicit mesh or rule binds a new one;
        else the process mesh, when none is bound; else a changed
        ``numerics`` rebinds the bound one)."""
        from ..parallel import mesh as _mesh_lib
        from ..parallel.partitioner import Partitioner, resolve_mesh
        if mesh is not None or param_spec is not None:
            rmesh = resolve_mesh(mesh)
            axis = (data_axis if data_axis in rmesh.shape
                    else tuple(rmesh.shape)[0])
            self.set_partitioner(Partitioner(
                mesh=rmesh, data_axis=axis, param_spec=param_spec,
                numerics=numerics or "fast"))
        elif self._partitioner is None:
            pmesh = _mesh_lib.get_mesh()
            if pmesh is not None:
                axis = (data_axis if data_axis in pmesh.shape
                        else tuple(pmesh.shape)[0])
                self.set_partitioner(Partitioner(
                    mesh=pmesh, data_axis=axis,
                    numerics=numerics or "fast"))
        elif numerics and numerics != self._partitioner.numerics:
            old = self._partitioner
            self.set_partitioner(Partitioner(
                mesh=old.mesh, data_axis=old.data_axis,
                param_spec=old.rule, numerics=numerics,
                table_specs=old.table_specs))

    @staticmethod
    def _finish_timeline(own_profile, timeline_path):
        if not timeline_path:
            return
        from ..observability import timeline as _timeline
        try:
            if own_profile:
                profiler.stop_profiler(timeline_path=timeline_path,
                                       quiet=True)
            else:
                # an outer session owns start and stop: export what it
                # has recorded so far
                _timeline.export_profile(timeline_path)
        except OSError:
            pass

    def _stage(self, block, feed: Dict[str, Any]):
        """A feed dict on this executor's device, each value cast to its
        var's dtype on the host; on the card the copies are pinned and
        ``non_blocking`` on a side stream, and the returned
        `reader.decorator._Staged` makes the consumer wait for them."""
        from ..reader.decorator import _Staged, stage_to_device
        stream = None
        if self.device.type == "cuda":
            if self._stage_stream is None:
                self._stage_stream = torch.cuda.Stream(self.device)
            stream = self._stage_stream
        out = {}
        for name, value in feed.items():
            t = (value if isinstance(value, torch.Tensor)
                 else torch.as_tensor(np.asarray(value)))
            want = self._feed_dtype(block, name, t)
            if t.device.type == "cpu":
                out[name] = stage_to_device(t.to(want), self.device, stream)
            else:
                out[name] = t.to(self.device, want)
        event = None
        if stream is not None:
            event = torch.cuda.Event()
            event.record(stream)
        return _Staged(out, event, self.device)

    # -- flight recorder -----------------------------------------------------
    def _ensure_flight(self, flight_path=None, anchor_dir=None):
        fr = self._flight
        if fr is None:
            fr = self._flight = _flight.FlightRecorder(
                "train", _TRAIN_FLIGHT_FIELDS)
            _flight.install_signal_handler()
        if flight_path:
            fr.dump_path = flight_path
        elif anchor_dir:
            fr.dump_path = os.path.join(anchor_dir, "flight_recorder.json")
        return fr

    def _timed_window_sync(self, window, finite, fr, step):
        if not window and not finite:
            return
        t0 = time.perf_counter()
        self._window_sync(window, finite)
        fr.push((time.time(), step, 0.0, 0.0, time.perf_counter() - t0,
                 0, 0, 0, "window_sync"))

    def _flight_abort(self, fr, step, exc):
        """Record the failing step (unless the window sync already did,
        with the precise bad step) and dump the ring."""
        last = fr.last()
        if not (isinstance(exc, NonFiniteError) and last
                and last.get("nonfinite")):
            fr.push((time.time(), step, 0.0, 0.0, 0.0, self._in_flight, 0,
                     1 if isinstance(exc, NonFiniteError) else 0,
                     f"{type(exc).__name__}: {exc}"[:200]))
        try:
            fr.dump(reason=f"exception: {type(exc).__name__}")
        except OSError:  # an unwritable dump must not mask the error
            pass

    def _window_sync(self, window, finite):
        """One host sync for the window: the compute stream drains, and
        the window's per-step codes come back in one pull."""
        if not window and not finite:
            return
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        _introspect.sample_device_memory()
        if finite:
            flags = torch.cat([f.reshape(-1) for _, f, _ in finite]
                              ).cpu().numpy()
            skips = int((flags == _STEP_SKIP).sum())
            if skips:
                _EXEC_AMP_SKIP.inc(skips)
            if not (flags > _STEP_BAD).all():
                step_index = np.concatenate(
                    [np.arange(base, base + n) for base, _, n in finite])
                bad_step = int(step_index[int(np.argmin(flags))])
                bad = next((h for h in window if h.step == bad_step), None)
                names = "?"
                if bad is not None:
                    names = ", ".join(
                        repr(n) for n, v in zip(bad.fetch_names,
                                                bad.get(return_numpy=False))
                        if isinstance(v, torch.Tensor)
                        and v.is_floating_point()
                        and not bool(torch.isfinite(v).all()))
                _EXEC_NAN_INF.inc()
                finite.clear()
                window.clear()
                self._mark_synced()
                if self._flight is not None:
                    self._flight.push((time.time(), bad_step, 0.0, 0.0,
                                       0.0, 0, 0, 1, "nan_inf trip"))
                raise NonFiniteError(
                    f"Tensor(s) {names} contain NaN/Inf at step {bad_step} "
                    "(FLAGS_check_nan_inf)")
        finite.clear()
        window.clear()
        self._mark_synced()

    # -- feeds, checkpoints and resume ---------------------------------------
    @staticmethod
    def _feed_iter(feed, steps) -> Iterable[Dict[str, Any]]:
        if callable(feed):
            return iter(feed())
        if isinstance(feed, dict):
            if steps is None:
                raise ValueError(
                    "train_loop with a single feed dict needs `steps`")
            return itertools.repeat(feed, steps)
        if isinstance(feed, (list, tuple)):
            if steps is not None and steps > len(feed):
                return itertools.cycle(feed)
            return iter(feed)
        return iter(feed)

    def _feed_iter_resumed(self, feed, steps, start_step):
        """The feed fast-forwarded to the resume position: a resumable
        reader (``reader.resumable``) seeks; anything else is pulled and
        dropped for ``start_step`` logical steps (a stacked batch counts
        for its ``k``; a resume inside a stack re-yields its tail)."""
        if start_step > 0 and callable(feed) \
                and hasattr(feed, "set_position"):
            feed.set_position(start_step)
            return iter(feed())
        it = self._feed_iter(feed, steps)
        if start_step <= 0:
            return it
        from ..reader.decorator import StackedBatch
        skipped = 0
        while skipped < start_step:
            item = next(it, None)
            if item is None:
                break
            if isinstance(item, StackedBatch):
                if skipped + item.k > start_step:
                    off = start_step - skipped
                    tail = StackedBatch(
                        {name: v[off:] for name, v in item.items()},
                        item.k - off)
                    return itertools.chain([tail], it)
                skipped += item.k
            else:
                skipped += 1
        return it

    def _checkpoint(self, manager, program, scope, step):
        """Snapshot the program's persistables and the generator state as
        checkpoint ``step`` (device clones on this thread); under a mesh
        of several ranks shard-wise, each rank writing its shards."""
        state, specs = {}, {}
        for v in program.global_block().vars.values():
            if v.persistable:
                val = scope.get_local(v.name)
                if val is not None:
                    state[v.name] = val
                    placed = scope.sharding(v.name)
                    if placed is not None:
                        specs[v.name] = placed[1]
        state[RNG_STATE_VAR] = self._rng(program).get_state()
        manager.save(step, state, program=program, reader_position=step,
                     specs=specs, partitioner=self._partitioner)

    def _resume(self, manager, program, scope) -> int:
        """Restore the latest committed checkpoint into ``scope``; ->
        the global step to continue from (0 when none is committed)."""
        from ..checkpoint import program_fingerprint
        from ..checkpoint.manager import record_resume
        restored = manager.restore()
        if restored is None:
            return 0
        fp = restored.manifest.get("program_fingerprint")
        if fp is not None and fp != program_fingerprint(program):
            raise ValueError(
                f"checkpoint {restored.path} was written by a different "
                f"program (fingerprint {fp} != "
                f"{program_fingerprint(program)}); resume needs the same "
                "model build")
        arrays = dict(restored.arrays)
        rng = arrays.pop(RNG_STATE_VAR, None)
        block = program.global_block()
        for name, val in arrays.items():
            var = block.vars.get(name)
            if var is not None and var.dtype is not None:
                # the declared dtype (the JAX package saves int64 state
                # as int32)
                val = torch.from_numpy(np.ascontiguousarray(val)).to(
                    to_torch_dtype(var.dtype))
            scope.set(name, val)
        if rng is not None:
            self._rng(program).set_state(torch.from_numpy(rng))
        record_resume()
        pos = restored.reader_position
        return int(pos if pos is not None else restored.step)


def _stack_feeds(raws: List[Dict[str, Any]]) -> Dict[str, Any]:
    """K feed dicts -> one dict of [K, ...] values (on the device when
    every value already is a tensor there, else stacked on the host)."""
    out = {}
    for name in raws[0]:
        vals = [r[name] for r in raws]
        if all(isinstance(v, torch.Tensor) for v in vals):
            out[name] = torch.stack(vals)
        else:
            out[name] = np.stack([np.asarray(v) for v in vals])
    return out
