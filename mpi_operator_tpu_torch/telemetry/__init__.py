"""Telemetry of the PyTorch port: the metrics core, the Prometheus
/metrics exporter, the event log, the per-request tracer, the worker's
instrument bundles, the operator's job-level collector and its scrape
fault injector (the port's own copies of the JAX package's
framework-free modules) and profiler/NVTX spans.

Only `span` needs torch, so it loads on first use (the module
`__getattr__` below): the operator's control plane imports the event
log, the metrics core and the exporter from here without pulling the
data plane into its process."""
from .collector import (ClockSync, JobObservatory, MetricsFederation,
                        TraceFederation, goodput_ledger, merge_timeline,
                        parse_prometheus, resize_ledger, resize_lines)
from .core import Counter, Gauge, Histogram, Registry
from .events import (BoundEventLog, EventLog, read_events,
                     REQUEST_TIMEOUT, SLOT_ADMIT, SLOT_RETIRE)
from .prometheus import (CONTENT_TYPE, TelemetryServer, escape_label_value,
                         format_value, histogram_lines, render_registry)
from .trace import (RequestTrace, SessionSpan, Tracer, build_trees,
                    hop_percentiles, hop_spans, orphan_spans,
                    read_trace_spans, render_tree, trace_sum_gap)
from .worker import (RouterTelemetry, ServeTelemetry, TrainTelemetry,
                     WorkerTelemetry)

__all__ = [
    "ClockSync", "JobObservatory", "MetricsFederation", "TraceFederation",
    "goodput_ledger", "merge_timeline", "parse_prometheus", "resize_ledger",
    "resize_lines",
    "Counter", "Gauge", "Histogram", "Registry",
    "BoundEventLog", "EventLog", "read_events",
    "REQUEST_TIMEOUT", "SLOT_ADMIT", "SLOT_RETIRE",
    "CONTENT_TYPE", "TelemetryServer", "escape_label_value", "format_value",
    "histogram_lines", "render_registry",
    "span",
    "RequestTrace", "SessionSpan", "Tracer", "build_trees",
    "hop_percentiles", "hop_spans", "orphan_spans", "read_trace_spans",
    "render_tree", "trace_sum_gap",
    "RouterTelemetry", "ServeTelemetry", "TrainTelemetry", "WorkerTelemetry",
]


def __getattr__(name):
    if name == "span":
        from .spans import span
        return span
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
