"""Observability of the port (counterpart of
``paddle_tpu/observability``):

- ``registry.py``    — the thread-safe `MetricsRegistry` of Counter, Gauge
  and Histogram families with labelled series; the process default
  registry starts disabled;
- ``exporters.py``   — Prometheus text (`render_prometheus`, read by the
  server's ``metrics`` verb), `snapshot` and its key grammar
  (`series_key`, `parse_series_key`), the merge of several processes'
  snapshots (`merge_labeled_snapshots`, `render_snapshot_prometheus`)
  and the periodic `JsonlExporter`;
- ``trace.py``       — request trace ids in a contextvar and on the wire;
- ``flight.py``      — the always-on `FlightRecorder` ring;
- ``introspect.py``  — a cost report for every (program, feed signature)
  the executor, a predictor or a decode engine runs (the server's
  ``inspect`` verb, the ``inspect`` CLI verb);
- ``timeline.py``    — Chrome Trace Event Format export of the profiler's
  span log, flight rings and metrics snapshots, and the cross-process
  stitching behind the ``trace`` verb;
- ``timeseries.py``  — `TimeSeriesStore`, bounded rings of every
  registry series with window queries and rollups;
- ``slo.py``         — `SLOMonitor`, latency and availability objectives
  over the store, exported as ``slo_*`` gauges;
- ``attribution.py`` — the H100's roofs, the roofline classifier,
  ``torch.profiler`` windows split into compute and idle device time,
  and the decode step's device time by class.

Family names, labels, JSON keys and text formats are the JAX package's
letter for letter.
"""
from .registry import (MetricsRegistry, Counter, Gauge,  # noqa: F401
                       Histogram, CardinalityError, default_registry)
from .exporters import (render_prometheus, snapshot,  # noqa: F401
                        JsonlExporter, series_key, parse_series_key,
                        render_snapshot_prometheus,
                        merge_labeled_snapshots)
from . import trace  # noqa: F401
from . import attribution  # noqa: F401
from . import introspect  # noqa: F401
from . import flight  # noqa: F401
from . import timeline  # noqa: F401
from . import timeseries  # noqa: F401
from . import slo  # noqa: F401
from .flight import FlightRecorder  # noqa: F401
from .timeseries import TimeSeriesStore  # noqa: F401
from .slo import SLOMonitor, parse_slo_spec  # noqa: F401
