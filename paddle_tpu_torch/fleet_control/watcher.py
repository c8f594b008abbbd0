"""Checkpoint watcher + health-gated rolling reload (counterpart of
``paddle_tpu/fleet_control/watcher.py``).

`CheckpointWatcher` closes the train -> serve loop: a daemon that polls
a `CheckpointManager` directory for new committed steps (the manager
writes its manifest LAST, so a step that lists is a step that restores
— polling can never observe a torn checkpoint), publishes each through
`ModelPublisher` (manifest-last again on the serving side), and rolls
the fleet **replica by replica** through the registry's draining
``reload`` RPC.

The roll is stateless-by-design: it derives everything from the
replicas themselves.  Before touching a replica it asks for the model's
served ``manifest_fingerprint`` and skips it if it already serves the
target.  That one rule yields both hard guarantees the chaos tests
assert:

- an unchanged-fingerprint publish is a fleet-wide no-op — every
  replica already matches, so no ``reload`` RPC is sent and no replica
  drains;
- a watcher killed mid-roll and restarted resumes exactly where the
  old one died — already-rolled replicas match the target and are
  skipped, never double-rolled (no roll-state file to go stale).

Each reload is **health-gated**: the next replica is only touched after
the previous one re-admits traffic and reports the target fingerprint
within ``health_timeout``.  A failed gate triggers rollback: the
previous checkpoint step is republished (byte-identical params ->
identical fingerprint) and every replica already rolled is rolled
back, with the bad step recorded as ``rolled_back_from`` so the poll
loop never re-offers it.

Chaos hooks: ``fault.maybe_fault("watcher.roll")`` fires before each
replica (arm ``watcher.roll@2:raise`` to kill the watcher mid-roll) and
``"watcher.health_gate"`` inside the gate (an armed raise reads as a
gate failure -> rollback path, without needing a genuinely broken
artifact).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from .. import fault
from ..observability import default_registry
from ..observability import flight as _flight
from ..serving.server import ServingClient, ServingError
from .publisher import ModelPublisher

__all__ = ["CheckpointWatcher"]


class CheckpointWatcher:
    """Watches ``publisher.checkpoint_dir`` and rolls ``fleet``.

    ``poll_once`` is the deterministic unit (tests drive it directly);
    ``start``/``stop`` run it on a daemon thread every
    ``poll_interval`` seconds."""

    def __init__(self, fleet, publisher: ModelPublisher,
                 model: str = "default",
                 poll_interval: float = 1.0,
                 health_timeout: float = 30.0,
                 rpc_timeout: float = 10.0,
                 registry=None):
        self.fleet = fleet
        self.publisher = publisher
        self.model = model
        self.poll_interval = float(poll_interval)
        self.health_timeout = float(health_timeout)
        self.rpc_timeout = float(rpc_timeout)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.poll_errors = 0
        self.last_error: Optional[str] = None
        self.last_roll: Optional[Dict[str, Any]] = None

        reg = registry or getattr(fleet, "metrics", None) \
            or default_registry()
        self._m_commits = reg.counter(
            "watcher_commits_seen_total",
            "new committed checkpoint steps noticed")
        self._m_rolls = reg.counter(
            "watcher_rolls_total", "fleet rolls by outcome",
            labelnames=("outcome",))
        self._m_replicas = reg.counter(
            "watcher_replicas_rolled_total",
            "individual replica reloads performed by the watcher")
        self._m_delta_rolls = reg.counter(
            "watcher_delta_rolls_total",
            "delta-stream rolls by outcome",
            labelnames=("outcome",))
        self.last_delta_roll: Optional[Dict[str, Any]] = None
        self.flight = _flight.FlightRecorder(
            "fleet.watcher",
            ("ts", "step", "target", "outcome", "rolled", "skipped",
             "failed"),
            meta={"model": model,
                  "checkpoint_dir": publisher.checkpoint_dir})

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "CheckpointWatcher":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="checkpoint-watcher")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self.poll_interval + self.health_timeout
                              + 10.0)
            self._thread = None

    def _loop(self):
        while not self._stop.wait(self.poll_interval):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — the watcher daemon
                # must survive a flaky replica or a torn poll; the error
                # is surfaced on the stats page, not swallowed silently
                self.poll_errors += 1
                self.last_error = f"{type(e).__name__}: {e}"

    # -- one poll ----------------------------------------------------------
    def poll_once(self) -> Optional[Dict[str, Any]]:
        """Publish the newest committed step (if any) and roll the fleet
        to the published fingerprint.  Returns the roll result, or None
        when there is nothing to do."""
        latest = self.publisher.latest_step()
        if latest is None:
            return None
        pub = self.publisher.published()
        if pub.get("rolled_back_from") == latest:
            # this step already failed its health gate once: do not
            # re-offer it — the trainer must commit a NEWER step
            return None
        if pub.get("step") != latest:
            self._m_commits.inc()
            self.publisher.publish(latest)
        target = self.publisher.published_fingerprint()
        if target is None:
            return None
        return self.roll(target, step=latest)

    # -- streaming embedding deltas ----------------------------------------
    def _served_delta_seq(self, rep):
        info = self._client(rep).models()["models"].get(self.model)
        return (info or {}).get("delta_seq")

    def _delta_gate(self, rep, seq: int) -> bool:
        """True once ``rep`` reports delta seq ``seq`` — it is serving
        the patched rows and still answering the admin surface."""
        deadline = time.monotonic() + self.health_timeout
        while time.monotonic() < deadline and not self._stop.is_set():
            try:
                if self._served_delta_seq(rep) == seq:
                    return True
            except (ServingError, OSError, KeyError):
                pass
            time.sleep(0.1)
        return False

    def poll_deltas_once(self) -> Optional[Dict[str, Any]]:
        """Offer the delta-chain head (``__delta__.json``) to every
        healthy replica — the streaming counterpart of ``poll_once``.
        Replicas apply row deltas to their LIVE predictors (no drain,
        no rebuild); a replica whose lineage does not match (restarted,
        missed a link) falls back to one full health-gated reload and
        rejoins the chain at the next full publish.  Idempotent:
        replicas already at the head seq are skipped without an RPC
        beyond the describe."""
        record = self.publisher.delta_record()
        seq = record.get("seq")
        if seq is None:
            return None
        result: Dict[str, Any] = {"seq": int(seq),
                                  "step": record.get("step"),
                                  "applied": [], "skipped": [],
                                  "reloaded": [], "failed": None,
                                  "outcome": "noop"}
        reps = [r for r in self.fleet.replicas
                if r.state == "healthy" and r.endpoint]
        for rep in reps:
            try:
                if self._served_delta_seq(rep) == seq:
                    result["skipped"].append(rep.name)
                    continue
                d = self._client(rep).apply_deltas(self.model)
            except (ServingError, OSError, KeyError):
                result["skipped"].append(rep.name)
                continue        # unhealthy: the frontend health loop
                # owns it; the next poll re-offers the head
            if d.get("stale"):
                # lineage break: one full roll (drain + rebuild) brings
                # the replica to the latest FULL artifact; it cannot
                # rejoin mid-chain, so deltas stay stale for it until
                # the publisher restarts the chain with publish()
                target = self.publisher.published_fingerprint()
                try:
                    self._client(rep).reload_model(self.model)
                except (ServingError, OSError):
                    pass
                if target is not None and not self._health_gate(
                        rep, target):
                    result["failed"] = rep.name
                    result["outcome"] = "failed"
                    break
                result["reloaded"].append(rep.name)
                continue
            if not self._delta_gate(rep, int(seq)):
                result["failed"] = rep.name
                result["outcome"] = "failed"
                break
            result["applied"].append(rep.name)
        if result["outcome"] == "noop" and (result["applied"]
                                            or result["reloaded"]):
            result["outcome"] = "ok"
        self._m_delta_rolls.labels(outcome=result["outcome"]).inc()
        self.last_delta_roll = result
        return result

    # -- rolling reload ----------------------------------------------------
    def _client(self, rep) -> ServingClient:
        # retries=1 rides out a replica mid-drain; reload itself is
        # never retried by the client (non-idempotent by contract)
        return ServingClient(rep.endpoint, timeout=self.rpc_timeout,
                             retries=1)

    def _served_fingerprint(self, rep) -> Optional[str]:
        info = self._client(rep).models()["models"].get(self.model)
        return (info or {}).get("manifest_fingerprint")

    def _health_gate(self, rep, target: str) -> bool:
        """True once ``rep`` serves ``target`` and answers stats — i.e.
        it re-admitted traffic on the new weights."""
        try:
            fault.maybe_fault("watcher.health_gate")
        except fault.FaultInjected:
            return False        # chaos: an armed gate reads as unhealthy
        deadline = time.monotonic() + self.health_timeout
        while time.monotonic() < deadline and not self._stop.is_set():
            try:
                if self._served_fingerprint(rep) == target:
                    return True
            except (ServingError, OSError, KeyError):
                pass            # still draining/reloading — keep waiting
            time.sleep(0.1)
        return False

    def roll(self, target: str, step: Optional[int] = None
             ) -> Dict[str, Any]:
        """Roll every healthy replica to fingerprint ``target``, one at
        a time, health-gated.  Idempotent: replicas already serving
        ``target`` are skipped without a reload RPC (no drain)."""
        result: Dict[str, Any] = {"target": target, "step": step,
                                  "rolled": [], "skipped": [],
                                  "failed": None, "outcome": "noop"}
        reps = [r for r in self.fleet.replicas
                if r.state == "healthy" and r.endpoint]
        for rep in reps:
            # chaos hook: arm watcher.roll@N:raise to kill the watcher
            # between replicas and prove a restart does not double-roll
            fault.maybe_fault("watcher.roll")
            try:
                served = self._served_fingerprint(rep)
            except (ServingError, OSError, KeyError):
                result["skipped"].append(rep.name)
                continue        # unhealthy mid-roll: the frontend's
                # health loop owns it; skipping keeps the roll moving
            if served == target:
                result["skipped"].append(rep.name)
                continue
            try:
                self._client(rep).reload_model(self.model)
            except (ServingError, OSError):
                pass            # the gate below decides pass/fail
            if not self._health_gate(rep, target):
                result["failed"] = rep.name
                result["outcome"] = self._rollback(result, step)
                break
            result["rolled"].append(rep.name)
            self._m_replicas.inc()
        if result["outcome"] == "noop" and result["rolled"]:
            result["outcome"] = "ok"
        self._m_rolls.labels(outcome=result["outcome"]).inc()
        self.flight.push((time.time(), step, target, result["outcome"],
                          len(result["rolled"]), len(result["skipped"]),
                          result["failed"]))
        self.last_roll = result
        return result

    def _rollback(self, result: Dict[str, Any], step: Optional[int]
                  ) -> str:
        """Republish the previous step (identical bytes -> identical
        fingerprint) and roll the already-touched replicas back."""
        prev = (self.publisher.published() or {}).get("previous") or {}
        prev_step = prev.get("step")
        if prev_step is None:
            return "failed"     # first-ever publish: nothing to restore
        self.publisher.publish(prev_step, rolled_back_from=step)
        prev_target = self.publisher.published_fingerprint()
        by_name = {r.name: r for r in self.fleet.replicas}
        redo = list(result["rolled"])
        if result["failed"]:
            redo.append(result["failed"])
        for name in redo:
            rep = by_name.get(name)
            if rep is None or not rep.endpoint:
                continue
            try:
                self._client(rep).reload_model(self.model)
                self._health_gate(rep, prev_target)
            except (ServingError, OSError):
                pass            # frontend health machinery owns it now
        return "rollback"
