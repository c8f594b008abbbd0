"""Checkpoint -> serving-artifact publisher (counterpart of
``paddle_tpu/fleet_control/publisher.py``).

The bridge between the two artifact formats: `CheckpointManager` commits
raw train state (name -> array, manifest-last), the serving registry
loads `save_inference_model` directories (program + params + fingerprint
manifest, also manifest-last).  `ModelPublisher.publish` turns the
former into the latter:

1. restore the committed checkpoint's host arrays (read-only
   ``CheckpointManager`` — its constructor creates nothing);
2. load the serving *template* (the previously exported model dir, or
   an explicit ``template_dir``) into a **fresh** `Scope` under
   `scope_guard`, on an `Executor(CPUPlace())` (publishing is host
   work) — publishing must not clobber the process's `global_scope`,
   which may belong to a live trainer or server;
3. overwrite the template's persistable vars with the checkpoint's
   arrays (names must match — the template defines the inference graph,
   the checkpoint supplies the weights);
4. re-export with `save_inference_model` into the served directory —
   `__manifest__.json` is written last and atomically, so a polling
   `ModelRegistry.reload` / `CheckpointWatcher` can never observe a
   torn artifact, and the manifest fingerprint covers the param BYTES:
   republishing identical weights yields the identical fingerprint,
   which the registry turns into a fleet-wide no-op.

Provenance rides next to the model in ``__published__.json`` (atomic):
the checkpoint step + fingerprint just published and the previous
pair — exactly what the watcher needs to roll back a failed health
gate and to avoid re-offering a step that was already rolled back.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from ..checkpoint.manager import CheckpointManager
from ..core.executor import Executor
from ..core.place import CPUPlace
from ..core.scope import Scope, scope_guard
from ..io import (MANIFEST_FILENAME, _atomic_write, load_inference_model,
                  save_inference_model)
from ..serving.registry import DELTA_FILENAME

__all__ = ["ModelPublisher", "PUBLISHED_FILENAME", "DELTA_FILENAME"]

PUBLISHED_FILENAME = "__published__.json"


def _read_json(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class ModelPublisher:
    """Exports committed checkpoints from ``checkpoint_dir`` as serving
    artifacts in ``model_dir``.  ``template_dir`` (default: ``model_dir``
    itself) supplies the inference program; it must be a
    `save_inference_model` directory."""

    def __init__(self, checkpoint_dir: str, model_dir: str,
                 template_dir: Optional[str] = None,
                 params_filename: Optional[str] = None):
        self.checkpoint_dir = checkpoint_dir
        self.model_dir = model_dir
        self.template_dir = template_dir or model_dir
        self.params_filename = params_filename
        self.manager = CheckpointManager(checkpoint_dir)

    # -- discovery ---------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        """Newest COMMITTED checkpoint step (manifest present), or None."""
        return self.manager.latest_step()

    def published(self) -> Dict[str, Any]:
        """The ``__published__.json`` provenance record (``{}`` before the
        first publish — matching the store's empty-sentinel contract)."""
        return _read_json(
            os.path.join(self.model_dir, PUBLISHED_FILENAME)) or {}

    def published_fingerprint(self) -> Optional[str]:
        m = _read_json(os.path.join(self.model_dir, MANIFEST_FILENAME))
        return (m or {}).get("fingerprint")

    # -- publish -----------------------------------------------------------
    def publish(self, step: Optional[int] = None,
                rolled_back_from: Optional[int] = None) -> Dict[str, Any]:
        """Export checkpoint ``step`` (default latest) into ``model_dir``.

        Returns ``{"step", "fingerprint", "changed", "previous"}`` —
        ``changed`` is False when the new manifest fingerprint equals the
        one already served (identical bytes), which downstream becomes
        the registry's ``reload_noop``.  ``rolled_back_from`` marks the
        record as a rollback so `CheckpointWatcher.poll_once` will not
        re-offer the bad step."""
        restored = self.manager.restore(step)
        if restored is None:
            raise FileNotFoundError(
                f"no committed checkpoint in {self.checkpoint_dir!r}"
                + (f" at step {step}" if step is not None else ""))
        prev = {"step": self.published().get("step"),
                "fingerprint": self.published_fingerprint()}

        scope = Scope()
        exe = Executor(CPUPlace())
        with scope_guard(scope):
            program, feed_names, fetch_vars = load_inference_model(
                self.template_dir, exe,
                params_filename=self.params_filename)
            applied: List[str] = []
            for name, arr in restored.arrays.items():
                # only template vars are overwritten: a checkpoint also
                # carries optimizer accumulators the inference graph
                # never declared — silently dropping those is the point
                if scope.get(name) is not None:
                    scope.set(name, arr)
                    applied.append(name)
            if not applied:
                raise ValueError(
                    f"checkpoint step {restored.step} shares no var names "
                    f"with the serving template {self.template_dir!r} — "
                    "wrong checkpoint directory?")
            save_inference_model(self.model_dir, feed_names, fetch_vars,
                                 exe, main_program=program,
                                 params_filename=self.params_filename)
        fingerprint = self.published_fingerprint()
        record = {"step": int(restored.step),
                  "fingerprint": fingerprint,
                  "vars": applied,
                  "previous": prev}
        if rolled_back_from is not None:
            record["rolled_back_from"] = int(rolled_back_from)
        with _atomic_write(
                os.path.join(self.model_dir, PUBLISHED_FILENAME)) as f:
            json.dump(record, f, indent=1)
        return {"step": int(restored.step), "fingerprint": fingerprint,
                "changed": fingerprint != prev["fingerprint"],
                "previous": prev}

    # -- streaming embedding deltas ----------------------------------------
    def delta_record(self) -> Dict[str, Any]:
        """The ``__delta__.json`` chain head (``{}`` before the first
        delta publish)."""
        return _read_json(
            os.path.join(self.model_dir, DELTA_FILENAME)) or {}

    def publish_deltas(self, step: Optional[int] = None,
                       tables: Optional[List[str]] = None
                       ) -> Dict[str, Any]:
        """Publish the CHANGED embedding rows of checkpoint ``step``
        (default latest) against the previous point in the delta chain —
        instead of re-exporting the whole artifact.

        The chain is manifest-last like everything else here: per-table
        ``deltas/step_<N>/<table>.npz`` payloads (``rows`` int64 +
        ``values``) land first, then ``__delta__.json`` commits
        atomically with ``{seq, step, base_step, base_fingerprint,
        prev_seq, tables}``.  A replica applies a delta only when its
        own lineage matches (``base_fingerprint`` for the first link,
        ``prev_seq`` after) — a watcher restart or a missed link reads
        as stale and falls back to a full roll, never a torn table.

        The diff base is the chain head's step (or, for the first
        delta, the step last ``publish``ed as the full artifact), so
        both sides must still be committed checkpoints; eligible vars
        are 2-D float arrays (embedding tables), narrowed by
        ``tables``."""
        restored = self.manager.restore(step)
        if restored is None:
            raise FileNotFoundError(
                f"no committed checkpoint in {self.checkpoint_dir!r}")
        head = self.delta_record()
        base_step = head.get("step", self.published().get("step"))
        if base_step is None:
            raise ValueError(
                "publish_deltas needs a base: publish() a full artifact "
                "first so replicas share a known starting point")
        if int(restored.step) == int(base_step):
            return {"seq": head.get("seq"), "step": int(base_step),
                    "rows_total": 0, "changed": False}
        base = self.manager.restore(int(base_step))
        if base is None:
            raise FileNotFoundError(
                f"delta base step {base_step} is no longer a committed "
                "checkpoint (GC'd by keep_last_n); publish() a full "
                "artifact to restart the chain")
        seq = int(head.get("seq", 0)) + 1
        ddir = os.path.join(self.model_dir, "deltas",
                            f"step_{int(restored.step)}")
        os.makedirs(ddir, exist_ok=True)
        out_tables: Dict[str, Any] = {}
        rows_total = 0
        for name, arr in restored.arrays.items():
            if tables is not None and name not in tables:
                continue
            new = np.asarray(arr)
            old = base.arrays.get(name)
            if (old is None or new.ndim != 2
                    or not np.issubdtype(new.dtype, np.floating)
                    or np.shape(old) != new.shape):
                continue
            changed = np.flatnonzero(
                np.any(np.asarray(old) != new, axis=1))
            if changed.size == 0:
                continue
            fname = name.replace("/", "_") + ".npz"
            np.savez(os.path.join(ddir, fname),
                     rows=changed.astype(np.int64),
                     values=new[changed])
            out_tables[name] = {
                "rows": int(changed.size),
                "file": os.path.join("deltas",
                                     f"step_{int(restored.step)}", fname)}
            rows_total += int(changed.size)
        record = {"seq": seq, "step": int(restored.step),
                  "base_step": int(base_step),
                  "base_fingerprint": head.get(
                      "base_fingerprint", self.published_fingerprint()),
                  "prev_seq": head.get("seq"),
                  "tables": out_tables}
        with _atomic_write(
                os.path.join(self.model_dir, DELTA_FILENAME)) as f:
            json.dump(record, f, indent=1)
        return {"seq": seq, "step": int(restored.step),
                "base_step": int(base_step), "rows_total": rows_total,
                "tables": {n: t["rows"] for n, t in out_tables.items()},
                "changed": rows_total > 0}
