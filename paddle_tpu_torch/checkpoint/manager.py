"""Asynchronous, crash-consistent training checkpoints (counterpart of
``paddle_tpu/checkpoint/manager.py``; same on-disk layout, so a
checkpoint written by either package restores in the other).

- **No stall in the step loop.**  ``save()`` clones each device tensor on
  the compute stream and records one CUDA event after the clones; the
  caller's cost is those clone launches.  A background writer thread
  makes a side stream wait on the event, copies the clones into pinned
  host buffers on it and synchronizes it (so no clone is freed while its
  copy is in flight), then writes the files.  The next step may update the
  live tensors in place at once: it only ever touches the originals.
- **Atomic commit.**  Everything goes into ``ckpt-<step>.tmp-<pid>``,
  the manifest last, and one rename publishes ``ckpt-<step>``; a kill -9
  at any instruction leaves the previous checkpoint loadable, and the
  next manager sweeps the torn tmp dir.
- **Exact resume.**  The manifest records the program fingerprint (the
  JAX package's recipe), the step, the reader position and each var's
  dtype and shape; ``Executor.train_loop(resume_from=...)`` restarts
  with the uninterrupted run's losses.
- **Shard-wise under a mesh.**  ``save(..., partitioner=p)`` in a world
  of several ranks (`parallel.Partitioner`; the state holds this rank's
  shards of the vars ``specs`` names) writes each shard once, by its
  first holder, as ``<var>.shard-NNN.npy``, and every whole var once,
  by rank 0; the manifest records each var's spec and every shard
  file's global index, as the JAX package writes a sharded array.  It
  runs on the caller's thread on every rank: the files, then every
  rank's outcome gathered, rank 0's manifest and commit only when every
  rank wrote its files, and the commit's outcome broadcast (so a
  one-rank mesh's replicas on several ranks write one checkpoint, not
  one each, and a failed write on any rank leaves no checkpoint and
  raises on every rank).  `restore`
  reassembles the full arrays from the shard files and refuses files
  that do not cover an array; `RestoredCheckpoint.place` cuts this
  rank's shard for another mesh, an axis that mesh lacks degrading to
  replicated.

Layout::

    <directory>/
      ckpt-000020/
        manifest.json          # step, fingerprint, reader_position, vars
        <var>.npy              # one host array per state var
        <var>.shard-000.npy    # or its shards, under a mesh
      ckpt-000030/ ...         # the keep_last_n newest survive
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .. import fault
from ..io import program_fingerprint
from ..observability import default_registry as _obs_registry

MANIFEST = "manifest.json"
_CKPT_RE = re.compile(r"^ckpt-(\d+)$")

_CKPT_SAVE_S = _obs_registry().histogram(
    "checkpoint_save_seconds",
    "background serialize+write+commit time per checkpoint")
_CKPT_BYTES = _obs_registry().counter(
    "checkpoint_bytes_total", "bytes committed to checkpoint storage")
_CKPT_SAVES = _obs_registry().counter(
    "checkpoint_saves_total", "checkpoint commits by outcome",
    labelnames=("outcome",))
_CKPT_COMMITTED = _CKPT_SAVES.labels(outcome="committed")
_CKPT_SUPERSEDED = _CKPT_SAVES.labels(outcome="superseded")
_CKPT_FAILED = _CKPT_SAVES.labels(outcome="failed")
_TRAIN_RESUME = _obs_registry().counter(
    "train_resume_total", "train_loop restarts from a committed checkpoint")

__all__ = ["CheckpointManager", "RestoredCheckpoint", "latest_checkpoint",
           "describe", "program_fingerprint", "MANIFEST"]


def record_resume():
    """Count one train_loop resume."""
    _TRAIN_RESUME.inc()


def _spec_to_json(spec) -> List[Any]:
    """A partition spec as a JSON list (an axis name, a list of names, or
    None per dim)."""
    if spec is None:
        return []
    return [p if p is None or isinstance(p, str) else list(p)
            for p in tuple(spec)]


def _spec_on_mesh(spec_json, mesh):
    """A recorded spec valid on ``mesh``: axes the mesh does not have
    degrade to None (replicated along that dim), which is what makes a
    dp=4 checkpoint load on dp=1 or a tp-only mesh."""
    from ..parallel.logical_axes import PartitionSpec
    axes = set(mesh.axis_names)
    parts = []
    for part in spec_json or []:
        if isinstance(part, list):
            kept = [a for a in part if a in axes]
            parts.append(tuple(kept) if kept else None)
        else:
            parts.append(part if part in axes else None)
    return PartitionSpec(*parts)


def _dtype_name(val) -> str:
    import torch
    if isinstance(val, torch.Tensor):
        if val.dtype == torch.bfloat16:
            raise TypeError("a bf16 tensor has no numpy dtype to "
                            "checkpoint it as")
        return str(torch.empty((), dtype=val.dtype).numpy().dtype)
    return str(np.asarray(val).dtype)


class RestoredCheckpoint:
    """One committed checkpoint pulled back to host arrays."""

    __slots__ = ("path", "step", "reader_position", "manifest", "arrays")

    def __init__(self, path: str, manifest: Dict[str, Any],
                 arrays: Dict[str, np.ndarray]):
        self.path = path
        self.step = int(manifest["step"])
        self.reader_position = manifest.get("reader_position")
        self.manifest = manifest
        self.arrays = arrays

    def place(self, mesh=None) -> Dict[str, Any]:
        """The host arrays (the executor puts them on its device); with
        a ``mesh``, this rank's shard of each by its recorded spec on
        that mesh (`specs_on`)."""
        if mesh is None:
            return dict(self.arrays)
        from ..parallel.partitioner import Partitioner, resolve_mesh
        mesh = resolve_mesh(mesh)
        part = Partitioner(mesh=mesh, data_axis=mesh.axis_names[0])
        return {name: np.ascontiguousarray(part.shard(arr, spec))
                for (name, arr), spec in
                zip(self.arrays.items(), self.specs_on(mesh).values())}

    def specs_on(self, mesh) -> Dict[str, Any]:
        """Each var's recorded spec on ``mesh`` (`_spec_on_mesh`), or
        replicated where its shape does not divide."""
        from ..parallel.logical_axes import PartitionSpec
        from ..parallel.partitioner import resolve_mesh, spec_fits
        mesh = resolve_mesh(mesh)
        out = {}
        for name, arr in self.arrays.items():
            spec = _spec_on_mesh(
                self.manifest["vars"].get(name, {}).get("spec") or [], mesh)
            out[name] = (spec if spec_fits(spec, tuple(np.shape(arr)), mesh)
                         else PartitionSpec())
        return out

    def restore_to_scope(self, scope, mesh=None):
        """Write every restored var into ``scope``."""
        for name, val in self.place(mesh).items():
            scope.set(name, val)
        return self


class _SaveJob:
    __slots__ = ("step", "state", "manifest", "event")

    def __init__(self, step, state, manifest, event):
        self.step = step
        self.state = state            # name -> cloned tensor or array
        self.manifest = manifest
        self.event = event            # recorded after the clones, or None


class CheckpointManager:
    """Rolling asynchronous checkpoints under one directory.

    At most one snapshot waits in the queue: when saves outpace the
    writer, the queued (unstarted) snapshot is superseded by the newer
    one, so the writer commits the freshest state it can and the step
    loop never backs up."""

    def __init__(self, directory: str, keep_last_n: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep_last_n = max(1, int(keep_last_n))
        self.async_save = async_save
        # the directory is made at the first save, so read-only users
        # (restore, describe, the CLI verb) never create a typo'd path
        self._dir_ready = False
        self._clean_stale_tmp()
        self._queue: "queue.Queue[Optional[_SaveJob]]" = queue.Queue()
        self._pending: Optional[_SaveJob] = None   # queued but unstarted
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._idle = threading.Event()
        self._idle.set()
        self._thread: Optional[threading.Thread] = None
        self._stream = None           # the writer's copy stream
        self.writer_thread_ident: Optional[int] = None

    # -- discovery ---------------------------------------------------------
    def steps(self) -> List[int]:
        """Committed checkpoint steps, ascending (manifest present)."""
        out = []
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return out
        for name in entries:
            m = _CKPT_RE.match(name)
            if m and os.path.exists(
                    os.path.join(self.directory, name, MANIFEST)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def checkpoint_path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{step:06d}")

    # -- save --------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any], *,
             program=None, reader_position: Optional[int] = None,
             specs: Optional[Dict[str, Any]] = None,
             extra: Optional[Dict[str, Any]] = None,
             block: bool = False, partitioner=None) -> None:
        """Snapshot ``state`` (name -> tensor or array) as checkpoint
        ``step``.  Device tensors are cloned here, on the compute stream;
        the device-to-host copies, files, manifest, rename and retention
        run on the writer thread unless ``block=True`` (or
        ``async_save=False``).  With a sharding ``partitioner``, ``state``
        holds this rank's shards of the vars ``specs`` names and the save
        is shard-wise, on this thread, on every rank (module
        docstring)."""
        import torch
        self._raise_pending_error()
        if partitioner is not None and _world_size() > 1:
            self._save_sharded(step, state, program, reader_position,
                               dict(specs or {}), extra, partitioner)
            return
        snapshot, event = {}, None
        with torch.no_grad():
            for name, val in state.items():
                if isinstance(val, torch.Tensor):
                    snapshot[name] = val.detach().clone()
                    if val.device.type == "cuda" and event is None:
                        event = torch.cuda.Event()
                else:
                    snapshot[name] = np.asarray(val)
        if event is not None:
            event.record()
        specs = dict(specs or {})
        manifest = {
            "step": int(step),
            "reader_position": (int(reader_position)
                                if reader_position is not None else None),
            "program_fingerprint": (program_fingerprint(program)
                                    if program is not None else None),
            "saved_at": time.time(),
            "vars": {name: {"shape": list(val.shape),
                            "dtype": _dtype_name(val),
                            "spec": _spec_to_json(specs.get(name))}
                     for name, val in snapshot.items()},
        }
        if extra:
            manifest.update(extra)
        job = _SaveJob(int(step), snapshot, manifest, event)
        if not self._dir_ready:
            os.makedirs(self.directory, exist_ok=True)
            self._dir_ready = True
        if block or not self.async_save:
            try:
                self._write(job)
            except BaseException:
                _CKPT_FAILED.inc()
                raise
            self._raise_pending_error()
            return
        self._ensure_thread()
        with self._lock:
            if self._pending is not None:
                # the writer has not started the queued snapshot: the
                # newest state wins
                self._pending.state = None
                self._pending.manifest = None
                _CKPT_SUPERSEDED.inc()
            self._pending = job
            self._idle.clear()
        self._queue.put(job)

    def _save_sharded(self, step, state, program, reader_position, specs,
                      extra, part):
        import itertools
        import torch
        import torch.distributed as dist
        final = self.checkpoint_path(int(step))
        box = [os.getpid()]
        dist.broadcast_object_list(box, src=0)
        tmp = f"{final}.tmp-{box[0]}"
        leader = dist.get_rank() == 0
        if leader:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        dist.barrier()
        manifest = {
            "step": int(step),
            "reader_position": (int(reader_position)
                                if reader_position is not None else None),
            "program_fingerprint": (program_fingerprint(program)
                                    if program is not None else None),
            "saved_at": time.time(),
            "vars": {}}
        if extra:
            manifest.update(extra)
        total, err = 0, None
        try:
            for name, val in state.items():
                fault.maybe_fault("checkpoint.write")
                arr = (val.detach().cpu().numpy()
                       if isinstance(val, torch.Tensor) else np.asarray(val))
                spec = specs.get(name)
                shape = list(arr.shape)
                meta = {"dtype": _dtype_name(val),
                        "spec": _spec_to_json(spec)}
                manifest["vars"][name] = meta
                if spec is None or not (part.use_sharding
                                        and part.is_sharded(spec)):
                    meta["shape"] = shape
                    if leader:
                        with open(os.path.join(tmp, _fname(name)), "wb") as f:
                            np.save(f, np.ascontiguousarray(arr))
                        total += arr.nbytes
                    continue
                parts = [part._index(_axes_of(p))[1] for p in tuple(spec)]
                parts += [1] * (len(shape) - len(parts))
                full = [d * n for d, n in zip(shape, parts)]
                meta["shape"] = full
                mine = [i // d for (i, _), d in
                        zip(part.shard_index(spec, full), shape)]
                shards = []
                for i, combo in enumerate(itertools.product(
                        *[range(n) for n in parts])):
                    fname = _shard_fname(name, i)
                    shards.append({"file": fname, "index": [
                        [c * d, (c + 1) * d] for c, d in zip(combo, shape)]})
                    if list(combo) == mine and part.writes_shard(spec):
                        with open(os.path.join(tmp, fname), "wb") as f:
                            np.save(f, np.ascontiguousarray(arr))
                        total += arr.nbytes
                meta["shards"] = shards
        except Exception as e:  # noqa: BLE001 - agreed on below, re-raised
            err = e
        # every rank's outcome, before rank 0 commits: one failed write
        # leaves no checkpoint, and every rank raises
        outcomes = [None] * dist.get_world_size()
        dist.all_gather_object(
            outcomes, None if err is None else f"{type(err).__name__}: {err}")
        failed = {r: o for r, o in enumerate(outcomes) if o is not None}
        if leader and not failed:
            try:
                with open(os.path.join(tmp, MANIFEST), "w") as f:
                    json.dump(manifest, f, indent=1)
                    f.flush()
                    os.fsync(f.fileno())
                fault.maybe_fault("checkpoint.pre_commit")
                if os.path.exists(final):
                    doomed = f"{final}.old-{os.getpid()}"
                    shutil.rmtree(doomed, ignore_errors=True)
                    os.rename(final, doomed)
                    os.rename(tmp, final)
                    shutil.rmtree(doomed, ignore_errors=True)
                else:
                    os.rename(tmp, final)
            except Exception as e:  # noqa: BLE001 - broadcast, re-raised
                err = e
                failed = {0: f"{type(e).__name__}: {e}"}
        if leader and failed:
            shutil.rmtree(tmp, ignore_errors=True)
        # rank 0's commit, as every rank learns it
        box = [failed]
        dist.broadcast_object_list(box, src=0)
        failed = box[0]
        if failed:
            _CKPT_FAILED.inc()
            if err is not None:
                raise err
            raise RuntimeError(
                f"checkpoint {int(step)} was not committed: rank(s) "
                f"{sorted(failed)} failed ({failed})")
        if leader:
            _CKPT_COMMITTED.inc()
            self._retire_old()
        _CKPT_BYTES.inc(total)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued save committed; re-raises a writer
        failure.  Returns False on timeout."""
        done = self._idle.wait(timeout)
        self._raise_pending_error()
        return done

    def close(self):
        """Flush pending saves and stop the writer thread."""
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=60.0)
            self._thread = None
        self._raise_pending_error()

    # -- restore -----------------------------------------------------------
    def restore(self, step: Optional[int] = None
                ) -> Optional[RestoredCheckpoint]:
        """Load checkpoint ``step`` (default: latest committed) to host
        arrays; None when the directory has no committed checkpoint."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        path = self.checkpoint_path(step)
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        arrays = {}
        for name, meta in manifest["vars"].items():
            shards = meta.get("shards")
            if not shards:
                arrays[name] = np.load(os.path.join(path, _fname(name)),
                                       allow_pickle=False)
                continue
            # a shard-wise checkpoint (written under a mesh, by either
            # package): reassemble the full array from its files
            full = None
            covered = 0
            for sh in shards:
                data = np.load(os.path.join(path, sh["file"]),
                               allow_pickle=False)
                if full is None:
                    full = np.empty(tuple(meta["shape"]), dtype=data.dtype)
                full[tuple(slice(a, b) for a, b in sh["index"])] = data
                covered += data.size
            if covered < full.size:
                # shard files of one host of a multi-host run: fail
                # rather than hand back uninitialised memory
                raise ValueError(
                    f"checkpoint {path} var {name!r}: shard files cover "
                    f"{covered} of {full.size} elements — a multi-host "
                    "shard-wise checkpoint needs every host's shard "
                    "files (and manifests merged) in one directory")
            arrays[name] = full
        return RestoredCheckpoint(path, manifest, arrays)

    # -- internals ---------------------------------------------------------
    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._writer_loop,
                                            daemon=True,
                                            name="checkpoint-writer")
            self._thread.start()

    def _writer_loop(self):
        self.writer_thread_ident = threading.get_ident()
        while True:
            job = self._queue.get()
            if job is None:
                self._idle.set()
                return
            with self._lock:
                if self._pending is job:
                    self._pending = None
                superseded = job.state is None
            if not superseded:
                try:
                    self._write(job)
                except BaseException as e:   # noqa: BLE001 — surfaced on wait
                    _CKPT_FAILED.inc()
                    self._error = e
            with self._lock:
                if self._queue.empty() and self._pending is None:
                    self._idle.set()

    def _host_arrays(self, job: _SaveJob) -> Dict[str, np.ndarray]:
        """The snapshot on the host: the writer's own stream waits for
        the clones (their event) and copies them into pinned buffers,
        then that stream is synchronized, so no clone is freed while its
        copy is in flight."""
        import torch
        out, pending = {}, []
        for name, val in job.state.items():
            if not isinstance(val, torch.Tensor):
                out[name] = np.ascontiguousarray(val)
            elif val.device.type != "cuda":
                out[name] = np.ascontiguousarray(val.numpy())
            else:
                pending.append((name, val))
        if pending:
            if self._stream is None:
                self._stream = torch.cuda.Stream(pending[0][1].device)
            self._stream.wait_event(job.event)
            with torch.cuda.stream(self._stream):
                hosts = []
                for name, val in pending:
                    host = torch.empty(val.shape, dtype=val.dtype,
                                       pin_memory=True)
                    host.copy_(val, non_blocking=True)
                    hosts.append((name, host))
            self._stream.synchronize()
            out.update((name, host.numpy()) for name, host in hosts)
        return out

    def _write(self, job: _SaveJob):
        t0 = time.perf_counter()
        final = self.checkpoint_path(job.step)
        tmp = f"{final}.tmp-{os.getpid()}"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        total = 0
        try:
            arrays = self._host_arrays(job)
            for name, arr in arrays.items():
                fault.maybe_fault("checkpoint.write")
                with open(os.path.join(tmp, _fname(name)), "wb") as f:
                    np.save(f, arr)
                total += arr.nbytes
            # the manifest last: its presence marks the payload complete
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump(job.manifest, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            fault.maybe_fault("checkpoint.pre_commit")
            if os.path.exists(final):
                # a re-save of a step: move the old dir aside first, so
                # the step always has a committed checkpoint
                doomed = f"{final}.old-{os.getpid()}"
                shutil.rmtree(doomed, ignore_errors=True)
                os.rename(final, doomed)
                os.rename(tmp, final)      # the atomic commit
                shutil.rmtree(doomed, ignore_errors=True)
            else:
                os.rename(tmp, final)      # the atomic commit
            fault.maybe_fault("checkpoint.post_commit")
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        _CKPT_BYTES.inc(total)
        _CKPT_COMMITTED.inc()
        _CKPT_SAVE_S.observe(time.perf_counter() - t0)
        self._retire_old()

    def _retire_old(self):
        steps = self.steps()
        for step in steps[:-self.keep_last_n]:
            shutil.rmtree(self.checkpoint_path(step), ignore_errors=True)

    def _clean_stale_tmp(self):
        """A process killed mid-save leaves litter: a ``.tmp-<pid>`` dir
        was never committed (removed), while an ``.old-<pid>`` dir whose
        final name is missing is the committed checkpoint caught
        mid-re-save (put back).  Dirs of a pid that still runs belong to
        a live trainer and are left alone."""
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return
        for name in entries:
            for sep in (".tmp-", ".old-"):
                base, _, pid = name.partition(sep)
                if not pid or not _CKPT_RE.match(base):
                    continue
                if (pid.isdigit() and int(pid) != os.getpid()
                        and _pid_alive(int(pid))):
                    break             # a live trainer owns this dir
                path = os.path.join(self.directory, name)
                final = os.path.join(self.directory, base)
                if sep == ".old-" and not os.path.exists(final):
                    os.rename(path, final)   # resurrect torn re-save
                else:
                    shutil.rmtree(path, ignore_errors=True)
                break

    def _raise_pending_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint writer failed") from err


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        pass                      # EPERM etc.: it exists
    return True


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if (dist.is_available()
                                     and dist.is_initialized()) else 1


def _axes_of(part):
    if part is None:
        return ()
    return tuple(part) if isinstance(part, (tuple, list)) else (part,)


def _shard_fname(var_name: str, i: int) -> str:
    return var_name.replace(os.sep, "_") + f".shard-{i:03d}.npy"


def _fname(var_name: str) -> str:
    """Var name -> file name (path separators are replaced)."""
    return var_name.replace(os.sep, "_") + ".npy"


def latest_checkpoint(directory: str) -> Optional[str]:
    """Path of the newest committed checkpoint under ``directory``."""
    mgr = CheckpointManager(directory)
    step = mgr.latest_step()
    return mgr.checkpoint_path(step) if step is not None else None


def describe(directory: str) -> List[Dict[str, Any]]:
    """Manifest summaries of every committed checkpoint (CLI verb)."""
    mgr = CheckpointManager(directory)
    out = []
    for step in mgr.steps():
        path = mgr.checkpoint_path(step)
        with open(os.path.join(path, MANIFEST)) as f:
            m = json.load(f)
        out.append({
            "step": step,
            "path": path,
            "saved_at": m.get("saved_at"),
            "reader_position": m.get("reader_position"),
            "program_fingerprint": m.get("program_fingerprint"),
            "num_vars": len(m.get("vars", {})),
            "bytes": sum(
                os.path.getsize(os.path.join(path, f))
                for f in os.listdir(path)),
        })
    return out
