"""Serving observability: span tracer with Chrome-trace/Perfetto export
(``trace``), metrics registry with Prometheus/JSONL exporters
(``metrics``), GPS decision audit log (``audit``) and predictor-accuracy
tracking (``accuracy``), and the trace schema check's command line
(``python -m repro_torch.obs.validate``) — the port's own copies of the
JAX package's jax-free ``obs`` modules."""

from repro_torch.obs.accuracy import (PredictorAccuracyTracker, WindowAccuracy,
                                      hist_hit_rate, hist_kl, hist_l1)
from repro_torch.obs.audit import GPSAuditLog, GPSAuditRecord
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import (NULL_TRACER, SpanTracer, merge_traces,
                                   span_names, validate_chrome_trace)

__all__ = [
    "Counter", "GPSAuditLog", "GPSAuditRecord", "Gauge", "Histogram",
    "MetricsRegistry", "NULL_TRACER", "PredictorAccuracyTracker",
    "SpanTracer", "WindowAccuracy", "hist_hit_rate", "hist_kl", "hist_l1",
    "merge_traces", "span_names", "validate_chrome_trace",
]
