"""Self-observability plane (pkg/query/tracer + pkg/meter analogs),
carried from the JAX package's ``obs``.

- ``tracer``:  hierarchical in-band query tracing — a ``Tracer`` owns a
  span tree threaded liaison -> data nodes and merged back into the
  response (``res.trace["span_tree"]``), with explicit device/host time
  attribution around kernel launches and cache-plane hit/miss tags.
- ``metrics``: the instrument registry (counters, gauges, exponential-
  bucket histograms with per-instrument handles) behind ``/metrics``
  and the ``_monitoring`` self-measure sink.
- ``recorder``: the slow-query flight recorder — a bounded ring buffer
  of span trees + plan text for queries over the slow threshold,
  served on the server's ``slowlog`` topic.
- ``prom``: the exposition parser and per-stage breakdown.
- ``selftrace``: slow/sampled span trees persisted as trace rows in
  ``_monitoring.self_query``.
"""

from banyandb_tpu_torch.obs.metrics import Histogram, Meter, global_meter
from banyandb_tpu_torch.obs.recorder import SlowQueryRecorder, default_recorder
from banyandb_tpu_torch.obs.tracer import NOOP_TRACER, Span, Tracer, find_span

__all__ = [
    "Histogram",
    "Meter",
    "NOOP_TRACER",
    "SlowQueryRecorder",
    "Span",
    "Tracer",
    "default_recorder",
    "find_span",
    "global_meter",
]
