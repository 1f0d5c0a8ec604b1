"""bigdl_tpu_torch.obs: the telemetry subsystem (the port of
``bigdl_tpu/obs``; stdlib only, a copy of the reference's, with the
reference's flags, metric families, label names, help strings and bucket
bounds):

- :mod:`~bigdl_tpu_torch.obs.metrics` — thread-safe registry of labelled
  Counter/Gauge/Histogram families, Prometheus text exposition + JSON
  snapshots, collectors and health probes, a process-global default
  registry.
- :mod:`~bigdl_tpu_torch.obs.spans` — host-side span tracer (nested,
  thread-aware, bounded ring buffer) exporting Chrome trace-event JSON
  loadable in Perfetto. Spans time the host, not the card.
- :mod:`~bigdl_tpu_torch.obs.reqtrace` — request-scoped timelines and the
  flight recorder (last-N scheduler iterations, dumped on anomaly /
  restart / SIGUSR2). Gated by ``BIGDL_TPU_REQ_TRACE``.
- :mod:`~bigdl_tpu_torch.obs.exporters` — background ``/metrics`` +
  ``/trace`` + ``/requests`` + ``/healthz`` + ``/profile`` HTTP
  endpoint, JSONL sink, summary bridge.
- :mod:`~bigdl_tpu_torch.obs.anomaly` — rolling-median step-time anomaly
  detector (fires the flight recorder).

Recording costs a clock read and a lock; ``BIGDL_TPU_OBS=0`` (or
:func:`set_enabled`) no-ops it entirely. The port's registry, tracer and
recorders are its own: a process that imports both packages holds two of
each.
"""

from bigdl_tpu_torch.obs import reqtrace
from bigdl_tpu_torch.obs.anomaly import StepTimeAnomalyDetector
from bigdl_tpu_torch.obs.exporters import (JsonlSink, MetricsServer,
                                           SummaryBridge)
from bigdl_tpu_torch.obs.metrics import (Counter, Gauge, Histogram,
                                         MetricsRegistry, counter,
                                         default_registry, enabled, gauge,
                                         histogram, set_enabled)
from bigdl_tpu_torch.obs.reqtrace import (FlightRecorder, ReqTraceRecorder,
                                          default_flight, default_recorder,
                                          flight_dump, mint)
from bigdl_tpu_torch.obs.spans import (Span, SpanTracer, default_tracer,
                                       record_span, span)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "counter",
    "gauge", "histogram", "default_registry", "enabled", "set_enabled",
    "Span", "SpanTracer", "span", "record_span", "default_tracer",
    "ReqTraceRecorder", "FlightRecorder", "default_recorder",
    "default_flight", "flight_dump", "mint", "reqtrace",
    "MetricsServer", "JsonlSink", "SummaryBridge",
    "StepTimeAnomalyDetector",
]
