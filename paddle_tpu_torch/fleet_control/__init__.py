"""Fleet control plane of the port (counterpart of
``paddle_tpu/fleet_control``).

It composes the fleet's adoption/ejection and draining reload,
`TimeSeriesStore` rollups and `SLOMonitor` burn rates, and checkpoint
manifests with content fingerprints into closed loops.  Three
cooperating pieces:

- `policy.Autoscaler` — read-evaluate-act on the frontend's own
  time-series store: scale up on p99/shed/queue pressure, down on
  sustained idle, with SLOMonitor-style streak debounce, per-direction
  cooldowns, and min/max clamps (``fleet --autoscale min=N,max=M``).
- `publisher.ModelPublisher` + `watcher.CheckpointWatcher` — live
  train -> serve weight streaming: watch `CheckpointManager` commits
  (manifest-last = safe polling), re-export via `save_inference_model`,
  roll the fleet replica-by-replica through the draining ``reload``,
  health-gated with fingerprint-no-op skips and rollback on a failed
  gate (``fleet --watch-checkpoints DIR``).
- `loadgen.build_schedule` + `loadgen.LoadGenerator` — seeded
  trace-driven open-loop load (ramps, bursts, classify+generate mix)
  that makes the above measurable: one trace replays against a fixed
  and an autoscaled fleet alike.

End state: ``train -> checkpoint -> watch -> roll -> scale``,
continuously, on one command.
"""
from .policy import Autoscaler, parse_autoscale_spec  # noqa: F401
from .publisher import ModelPublisher, PUBLISHED_FILENAME  # noqa: F401
from .watcher import CheckpointWatcher  # noqa: F401
from .loadgen import LoadGenerator, build_schedule  # noqa: F401
