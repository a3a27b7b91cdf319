"""Operator observability: /metrics (Prometheus text format) + /healthz.

The reference's only observability is glog to stderr and Kubernetes Events
(SURVEY.md §5 — no pprof, no metrics server). This module is the TPU-native
extension every production operator grows: a zero-dependency HTTP endpoint
exposing the reconciler's vital signs, scrapeable by Prometheus and usable
as a liveness probe.

Exported series (all prefixed ``tpu_operator_``):
  syncs_total            counter — sync_handler completions
  sync_errors_total      counter — sync_handler raises (requeued with backoff)
  sync_duration_seconds  histogram — sync_handler wall time (success and
                                   failure alike; a slow failing sync is
                                   the one you most want to see)
  workqueue_retries_total counter — keys re-enqueued through the rate
                                   limiter (add_rate_limited calls)
  workqueue_depth        gauge   — keys queued + rate-limit-delayed
  jobs{phase=...}        gauge   — TPUJobs by condition-derived phase,
                                   computed from the informer cache at
                                   scrape; every phase emitted (zero
                                   included) so series never go stale
  job_restarts           gauge   — sum of status.restart_count over
                                   currently-cached jobs (drops when a job
                                   is deleted — hence gauge, no _total)
  slices_in_use          gauge   — physical slices claimed by live jobs,
                                   pack-aware: a packed gang counts its
                                   slices once (controller/packing.py)

The histogram machinery and text-format helpers come from the worker-side
telemetry package (telemetry/) — one implementation of buckets, label
escaping, and cumulative-bucket rendering for both planes.

/healthz returns 200 while every worker thread is alive, 503 otherwise —
wire it to the Deployment's livenessProbe so a wedged reconciler gets
restarted instead of silently idling.
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..api import types as api
from ..telemetry.core import Histogram
from ..telemetry.prometheus import escape_label_value, histogram_lines

#: phase precedence: terminal beats transitional beats initial
_PHASES = (api.COND_SUCCEEDED, api.COND_FAILED, api.COND_RESTARTING,
           api.COND_RUNNING, api.COND_CREATED)

#: requeue reasons the run loop classifies (controller.py
#: _classify_requeue_reason) — rendered zero-included so the series
#: exist before the first fault ever fires
_REQUEUE_REASONS = ("conflict", "transient", "api_error", "error")


class SyncCounters:
    """Thread-safe sync outcome counters + the sync-duration histogram
    (all fed by the run loop's process_next_work_item)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.syncs_total = 0
        self.sync_errors_total = 0
        self.workqueue_retries_total = 0
        # reason -> count of retries, both queue-level requeues
        # ("transient", "api_error", "error") and in-place conflict
        # re-read-retries ("conflict") — every retry visible, by cause
        self.requeues_by_reason: dict = {}
        # syncs are API-server round trips: µs buckets are dead weight,
        # but a wedged informer can stretch one past a minute
        self.sync_duration = Histogram(
            "tpu_operator_sync_duration_seconds",
            "sync_handler wall time (success and failure)",
            lo=1e-4, hi=1e2)

    def record(self, ok: bool) -> None:
        with self._lock:
            self.syncs_total += 1
            if not ok:
                self.sync_errors_total += 1

    def record_retry(self) -> None:
        with self._lock:
            self.workqueue_retries_total += 1

    def record_requeue(self, reason: str) -> None:
        with self._lock:
            self.requeues_by_reason[reason] = \
                self.requeues_by_reason.get(reason, 0) + 1

    def observe_sync(self, seconds: float) -> None:
        self.sync_duration.observe(seconds)

    def snapshot(self):
        with self._lock:
            return self.syncs_total, self.sync_errors_total

    def requeues_snapshot(self) -> dict:
        with self._lock:
            return dict(self.requeues_by_reason)


def job_phase(job) -> str:
    """Condition-derived phase: the highest-precedence condition currently
    True; "Pending" before the controller has written any."""
    status = {c.type: c.status for c in job.status.conditions}
    for phase in _PHASES:
        if status.get(phase) in (True, "True"):
            return phase
    return "Pending"


def render_metrics(controller) -> str:
    """One Prometheus-text scrape of the controller's state. Gauges are
    computed from the informer cache (deepcopy-free: read-only field
    access on lister copies)."""
    syncs, errors = controller.sync_counters.snapshot()
    by_phase: dict = {}
    restarts = 0
    for job in controller.job_lister.list():
        phase = job_phase(job)
        by_phase[phase] = by_phase.get(phase, 0) + 1
        restarts += job.status.restart_count
    lines = [
        "# HELP tpu_operator_syncs_total sync_handler completions",
        "# TYPE tpu_operator_syncs_total counter",
        f"tpu_operator_syncs_total {syncs}",
        "# HELP tpu_operator_sync_errors_total sync_handler errors (requeued)",
        "# TYPE tpu_operator_sync_errors_total counter",
        f"tpu_operator_sync_errors_total {errors}",
        "# HELP tpu_operator_workqueue_retries_total keys re-enqueued "
        "through the rate limiter",
        "# TYPE tpu_operator_workqueue_retries_total counter",
        f"tpu_operator_workqueue_retries_total "
        f"{controller.sync_counters.workqueue_retries_total}",
        "# HELP tpu_operator_requeues_total retries by cause: queue-level "
        "requeues and in-place conflict re-read-retries",
        "# TYPE tpu_operator_requeues_total counter",
    ]
    # same zero-included discipline as jobs{phase}: the known reasons are
    # always present so rate() never sees a series appear from nowhere;
    # unknown reasons (future classifications) still render
    by_reason = controller.sync_counters.requeues_snapshot()
    for reason in sorted({*_REQUEUE_REASONS, *by_reason}):
        lines.append(
            f'tpu_operator_requeues_total{{reason="'
            f'{escape_label_value(reason)}"}} {by_reason.get(reason, 0)}')
    lines += histogram_lines(controller.sync_counters.sync_duration)
    lines += [
        "# HELP tpu_operator_workqueue_depth queued + rate-limit-delayed keys",
        "# TYPE tpu_operator_workqueue_depth gauge",
        f"tpu_operator_workqueue_depth {len(controller.queue)}",
        "# HELP tpu_operator_jobs TPUJobs by phase",
        "# TYPE tpu_operator_jobs gauge",
    ]
    # every phase is emitted, zero included — a vanishing series reads as
    # "no data" in Prometheus, not as 0. Phases are fixed strings today,
    # but escape anyway: a condition type with a quote in it must corrupt
    # one label, not the whole scrape.
    for phase in (*_PHASES, "Pending"):
        lines.append(f'tpu_operator_jobs{{phase="{escape_label_value(phase)}"}} '
                     f"{by_phase.get(phase, 0)}")
    lines += [
        # gauge over currently-cached jobs (drops when a job is deleted),
        # hence no _total suffix — that would invite rate() over a
        # non-monotone series
        "# HELP tpu_operator_job_restarts sum of restart counts over live jobs",
        "# TYPE tpu_operator_job_restarts gauge",
        f"tpu_operator_job_restarts {restarts}",
        # pack-aware quota accounting (controller/packing.py slices_used):
        # each packed gang counts its slices once, via its leader
        "# HELP tpu_operator_slices_in_use physical slices claimed by live "
        "jobs (packed gangs counted once)",
        "# TYPE tpu_operator_slices_in_use gauge",
        f"tpu_operator_slices_in_use {controller.slices_in_use()}",
    ]
    # job-level federation (telemetry/collector.py): the observatory's
    # aggregated tpu_job_* series ride the SAME scrape as the operator's
    # own — one endpoint, both planes. Absent observatory → absent
    # section, not empty series.
    observatory = getattr(controller, "observatory", None)
    if observatory is not None:
        lines += observatory.render_lines()
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Serves /metrics and /healthz for a running TPUJobController in a
    daemon thread. Port 0 picks a free port (tests); `.port` has the bound
    value. close() is idempotent."""

    def __init__(self, controller, port: int = 8080, host: str = ""):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path == "/metrics":
                    body = render_metrics(outer.controller).encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                elif self.path == "/healthz":
                    healthy = outer.controller.workers_alive()
                    body = (b"ok\n" if healthy else b"unhealthy\n")
                    self.send_response(200 if healthy else 503)
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

        self.controller = controller
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="tpu-operator-metrics",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass


__all__ = ["MetricsServer", "SyncCounters", "job_phase", "render_metrics"]
