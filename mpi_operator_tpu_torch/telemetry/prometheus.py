"""Prometheus text-format exporter for the worker data plane.

The PyTorch port's own copy of mpi_operator_tpu/telemetry/prometheus.py:
the port imports nothing of the JAX package, not even its
framework-free modules. Its logic and names are the reference's,
held to it by tests/test_torch_telemetry.py.

Renders a `core.Registry` in exposition format 0.0.4 and serves it over
the same zero-dependency ThreadingHTTPServer pattern as the operator's
`controller/metrics.py`, so Kubernetes scrapes workers exactly like it
scrapes the operator: a `/metrics` GET plus a `/healthz` liveness probe.

The renderer is shared with the control plane: `escape_label_value` and
`histogram_lines` are imported by `controller/metrics.py` so both
endpoints speak identical text format (one bug surface, not two).
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional

from .core import Histogram, Registry
from .events import read_events

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def escape_label_value(v: str) -> str:
    """Exposition-format label escaping: backslash, double-quote, newline."""
    return (str(v).replace("\\", "\\\\")
                  .replace('"', '\\"')
                  .replace("\n", "\\n"))


def format_value(v) -> str:
    """Prometheus sample value: integers bare, floats via repr (full
    precision, no locale)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_str(labels: Dict[str, str], extra: Optional[Dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in merged.items())
    return "{" + inner + "}"


def histogram_lines(h: Histogram, help_type: bool = True) -> List[str]:
    """Render one histogram: cumulative ``_bucket{le=...}`` series (the
    +Inf bucket equal to ``_count`` by construction), then _sum/_count."""
    counts, total_sum, total = h.snapshot()
    lines: List[str] = []
    if help_type:
        lines += [f"# HELP {h.name} {h.help}", f"# TYPE {h.name} histogram"]
    cum = 0
    for edge, c in zip(h.edges, counts):
        cum += c
        le = format_value(edge)
        lines.append(f"{h.name}_bucket"
                     f"{_labels_str(h.labels, {'le': le})} {cum}")
    lines.append(f"{h.name}_bucket"
                 f"{_labels_str(h.labels, {'le': '+Inf'})} {total}")
    lines.append(f"{h.name}_sum{_labels_str(h.labels)} "
                 f"{format_value(total_sum)}")
    lines.append(f"{h.name}_count{_labels_str(h.labels)} {total}")
    return lines


def render_registry(registry: Registry) -> str:
    """Full scrape body. HELP/TYPE are emitted once per metric NAME even
    when several label-sets share it (the format forbids repeats)."""
    lines: List[str] = []
    seen_names = set()
    for m in registry.collect():
        first = m.name not in seen_names
        seen_names.add(m.name)
        if m.kind == "histogram":
            lines += histogram_lines(m, help_type=first)
        else:
            if first:
                lines += [f"# HELP {m.name} {m.help}",
                          f"# TYPE {m.name} {m.kind}"]
            lines.append(f"{m.name}{_labels_str(m.labels)} "
                         f"{format_value(m.value)}")
    return "\n".join(lines) + "\n"


class TelemetryServer:
    """Worker-side /metrics + /healthz in a daemon thread.

    Same contract as the operator's MetricsServer: port 0 picks a free
    port (tests), `.port` holds the bound value, close() is idempotent.
    `healthy` is an optional callable polled by /healthz — wire it to the
    training loop's liveness signal; default is always-ok.

    `events_path` additionally serves GET /events: the process's event
    log as JSON `{"now": <server unix time>, "records": [...]}`. The
    `now` stamp is what the controller-side collector anchors per-host
    clock-offset correction on (collector.py) — it is sampled in the
    same request that ships the records, so offset = local_now - now
    holds to within one round trip. read_events tolerates the live
    writer, so a scrape never races a torn record into an error.

    `traces_path` serves GET /traces the same way for the request-trace
    span log (telemetry/trace.py): same envelope, same clock anchor, so
    the collector corrects span wall-times with the offsets it already
    learned from the metrics scrape of the same pod.
    """

    def __init__(self, registry: Registry, port: int = 0, host: str = "",
                 healthy: Optional[Callable[[], bool]] = None,
                 events_path: Optional[str] = None,
                 traces_path: Optional[str] = None):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path == "/metrics":
                    body = render_registry(outer.registry).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", CONTENT_TYPE)
                elif self.path == "/events" and outer.events_path:
                    payload = {"now": time.time(),
                               "records": read_events(outer.events_path)}
                    body = (json.dumps(payload) + "\n").encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif self.path == "/traces" and outer.traces_path:
                    payload = {"now": time.time(),
                               "records": read_events(outer.traces_path)}
                    body = (json.dumps(payload) + "\n").encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                elif self.path == "/healthz":
                    ok = outer.healthy() if outer.healthy else True
                    body = b"ok\n" if ok else b"unhealthy\n"
                    self.send_response(200 if ok else 503)
                    self.send_header("Content-Type", "text/plain")
                else:
                    body = b"not found\n"
                    self.send_response(404)
                    self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):   # scrapes are not log events
                pass

        self.registry = registry
        self.healthy = healthy
        self.events_path = events_path
        self.traces_path = traces_path
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="tpu-worker-metrics",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass


__all__ = ["CONTENT_TYPE", "TelemetryServer", "escape_label_value",
           "format_value", "histogram_lines", "render_registry"]
