"""Observability of the port's serving path (counterpart of
``paddle_tpu/observability``):

- ``registry.py``  — the thread-safe `MetricsRegistry` of Counter, Gauge
  and Histogram families with labelled series; the process default
  registry starts disabled;
- ``exporters.py`` — Prometheus text (`render_prometheus`, read by the
  server's ``metrics`` verb), `snapshot` and the periodic
  `JsonlExporter`;
- ``trace.py``     — request trace ids in a contextvar and on the wire;
- ``flight.py``    — the always-on `FlightRecorder` ring.

Family names and labels are the JAX package's letter for letter.  Not
ported yet: introspect, attribution, timeline, timeseries and slo.
"""
from .registry import (MetricsRegistry, Counter, Gauge,  # noqa: F401
                       Histogram, CardinalityError, default_registry)
from .exporters import (render_prometheus, snapshot,  # noqa: F401
                        JsonlExporter, series_key)
from . import flight, trace  # noqa: F401
from .flight import FlightRecorder  # noqa: F401
