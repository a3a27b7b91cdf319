"""Per-worker instrument bundles: the named series the data plane exports.

The PyTorch port's own copy of mpi_operator_tpu/telemetry/worker.py:
the port imports nothing of the JAX package, not even its
framework-free modules. Its logic and names are the reference's,
held to it by tests/test_torch_telemetry.py.

This is the naming contract in one place — trainers and the serving
engine take a bundle and bump instruments; they never invent series
names. Everything is prefixed ``tpu_worker_`` (the operator owns
``tpu_operator_``), so one Prometheus config scrapes both planes without
collisions.

Train series (LMTrainer / Trainer / PipelineLMTrainer benchmark loops):
  step_seconds            histogram — per-step wall time (host-synced)
  tokens_per_sec          gauge     — last-window LM throughput
  examples_per_sec        gauge     — last-window image throughput
  mfu                     gauge     — model FLOPs utilization, 0-1
  goodput                 gauge     — productive / total steps, 0-1
  host_gap_seconds        histogram — host blocked-on-device time per
                                      window fetch (how much of the step
                                      the async dispatch did NOT hide)
  step                    gauge     — last observed global step (the
                                      controller's restart-aware
                                      goodput reads this frontier)
  last_checkpoint_step    gauge     — newest durable checkpoint step
  restore_step            gauge     — step this incarnation restored
                                      from (0 when fresh)
  restore_seconds         gauge     — wall seconds the restore took
                                      (parallel resharded reads included)
  resume_step_seconds     gauge     — restore-done → first post-resume
                                      step (the recompile phase of a
                                      gang resize; collector folds it
                                      into tpu_job_resize_seconds)
  steps_total             counter   — steps executed
  skipped_steps_total     counter   — divergence-guard skipped (lower
                                      bound: streaks are sampled at
                                      window fetches, resets between
                                      fetches are invisible)
  rollback_steps_total    counter   — steps rewound by rollbacks

Serve series (ServingEngine):
  ttft_seconds            histogram — request arrival → first token
  tpot_seconds            histogram — inter-token gap per slot
  prefill_seconds         histogram — prefill chunk dispatch (async: host
                                      wall time, not device time)
  decode_step_seconds     histogram — decode step dispatch → token sync
                                      (async: spans the loop iteration
                                      that hid under it)
  host_gap_seconds        histogram — host blocked on the device token
                                      read per step (≈0 when the decode
                                      fully hides under host scheduling)
  queue_depth             gauge     — requests waiting for a slot
  slot_occupancy          gauge     — slots currently bound
  slots                   gauge     — configured slot count
  step_compiles           gauge     — decode-step compile count
  prefill_compiles        gauge     — prefill compile count
  requests_total          counter   — requests retired
  tokens_total            counter   — new tokens emitted
  kv_pages_total          gauge     — usable KV pages (paged mode;
                                      pool minus the trash page)
  kv_pages_in_use         gauge     — pages referenced by live requests
  kv_pages_cached         gauge     — idle prefix-cache pages retained
                                      for future lookups (evictable)
  prefix_hit_pages_total  counter   — prompt pages served from the
                                      prefix cache at admission
  prefix_miss_pages_total counter   — prompt pages prefilled cold
  kv_handoff_seconds      histogram — disaggregated serving: one
                                      prefill→decode page handoff,
                                      install + copy dispatch (host
                                      wall time, async like prefill)
  kv_handoff_pages_total  counter   — KV pages moved between pools
                                      (decode-side prefix hits move
                                      nothing and are NOT counted)
  spec_proposed_total     counter   — draft tokens sent to a verify
                                      step (speculative decoding)
  spec_accepted_total     counter   — draft tokens that matched the
                                      model's argmax and were emitted
  spec_acceptance_ratio   histogram — accepted/proposed per row per
                                      verify step (0-1)
  spec_tokens_per_step    histogram — tokens emitted per row per verify
                                      step (accepted + the model's own
                                      bonus token; >1 is the speedup)

Disaggregated serving creates one ServeTelemetry per pool with
``labels={"pool": "prefill"|"decode"}`` on a shared registry — the same
bundle-per-label-set pattern as the fused trainer — so every serve
series above federates per pool (tpu_job_queue_depth{pool="decode"}).

Router series (serve/router.py front door, prefixed ``tpu_router_``;
the collector federates these into ``tpu_job_router_*``):
  dispatch_total            counter   — requests dispatched, one series
                                        per replica ({replica="N"})
  shed_total                counter   — requests rejected at the front
                                        door (every replica at its
                                        in-flight cap)
  requests_total            counter   — requests completed through the
                                        router (sheds excluded)
  resubmits_total           counter   — in-flight requests replayed to
                                        survivors after a replica death
  replica_deaths_total      counter   — replicas marked dead from
                                        failed dispatches
  affinity_hit_pages_total  counter   — prompt pages predicted warm on
                                        the chosen replica at dispatch
  affinity_miss_pages_total counter   — prompt pages predicted cold
  queue_wait_seconds        histogram — arrival → dispatch wait at the
                                        front door
"""
from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, Optional

from .core import Registry
from .events import EventLog, read_events
from .prometheus import TelemetryServer, render_registry


class TrainTelemetry:
    """Train-loop instruments over a shared registry.

    ``labels`` stamps every instrument in the bundle with the same label
    set, so several bundles can share one registry and render as distinct
    series under the same names — the HFTA fused trainer creates one
    bundle per packed replica (``labels={"replica": "3"}``) and the
    controller packing path one per job (``labels={"job": name}``).
    """

    def __init__(self, registry: Optional[Registry] = None,
                 labels: Optional[Dict[str, str]] = None):
        reg = registry if registry is not None else Registry()
        self.registry = reg
        self.labels = dict(labels) if labels else None
        labels = self.labels
        self.step_seconds = reg.histogram(
            "tpu_worker_step_seconds", "per-step wall time (seconds)",
            labels=labels)
        self.host_gap_seconds = reg.histogram(
            "tpu_worker_host_gap_seconds",
            "host blocked-on-device time at window fetches",
            lo=1e-5, hi=1e3, labels=labels)
        self.tokens_per_sec = reg.gauge(
            "tpu_worker_tokens_per_sec", "last-window LM tokens/sec",
            labels=labels)
        self.examples_per_sec = reg.gauge(
            "tpu_worker_examples_per_sec", "last-window examples/sec",
            labels=labels)
        self.mfu = reg.gauge(
            "tpu_worker_mfu", "model FLOPs utilization (0-1)",
            labels=labels)
        self.goodput = reg.gauge(
            "tpu_worker_goodput", "productive steps / total steps (0-1)",
            labels=labels)
        self.step = reg.gauge(
            "tpu_worker_step", "last observed global step",
            labels=labels)
        self.last_checkpoint_step = reg.gauge(
            "tpu_worker_last_checkpoint_step",
            "newest durable checkpoint's global step",
            labels=labels)
        self.restore_step = reg.gauge(
            "tpu_worker_restore_step",
            "global step this incarnation restored from (0 = fresh)",
            labels=labels)
        self.restore_seconds = reg.gauge(
            "tpu_worker_restore_seconds",
            "wall seconds this incarnation's checkpoint restore took",
            labels=labels)
        self.resume_step_seconds = reg.gauge(
            "tpu_worker_resume_step_seconds",
            "restore-done to first post-resume step wall seconds "
            "(compile included)",
            labels=labels)
        self.steps_total = reg.counter(
            "tpu_worker_steps_total", "train steps executed",
            labels=labels)
        self.skipped_steps_total = reg.counter(
            "tpu_worker_skipped_steps_total",
            "divergence-guard skipped steps (lower bound)",
            labels=labels)
        self.rollback_steps_total = reg.counter(
            "tpu_worker_rollback_steps_total",
            "steps rewound by divergence rollbacks",
            labels=labels)
        self._lock = threading.Lock()
        self._last_streak = 0
        self.goodput.set(1.0)

    def observe_step(self, seconds: float) -> None:
        self.step_seconds.observe(seconds)
        self.steps_total.inc()

    def observe_steps(self, avg_seconds: float, n: int) -> None:
        """Fold a window's worth of steps in as n observations of the
        window-average step time (the only per-step number an async
        dispatch loop can honestly report — see benchmark loops)."""
        self.step_seconds.observe_n(avg_seconds, n)
        self.steps_total.inc(n)

    def update_window(self, tokens_per_sec: Optional[float] = None,
                      examples_per_sec: Optional[float] = None,
                      mfu: Optional[float] = None,
                      step: Optional[int] = None) -> None:
        if tokens_per_sec is not None:
            self.tokens_per_sec.set(tokens_per_sec)
        if examples_per_sec is not None:
            self.examples_per_sec.set(examples_per_sec)
        if mfu is not None:
            self.mfu.set(mfu)
        if step is not None:
            self.step.set(int(step))

    def record_streak(self, streak: int) -> int:
        """Fold a window-fetch `nonfinite_streak` reading into the skipped
        counter. Streaks are only visible at fetches, so this is a lower
        bound: a streak that grew keeps its overlap with the previous
        reading; one that reset and regrew is all new skips."""
        streak = int(streak)
        with self._lock:
            if streak <= 0:
                new = 0
            elif streak > self._last_streak:
                new = streak - self._last_streak
            else:
                new = streak
            self._last_streak = streak
        if new:
            self.skipped_steps_total.inc(new)
            self._update_goodput()
        return new

    def record_rollback(self, steps_rewound: int) -> None:
        with self._lock:
            self._last_streak = 0
        if steps_rewound > 0:
            self.rollback_steps_total.inc(steps_rewound)
        self._update_goodput()

    def _update_goodput(self) -> None:
        total = self.steps_total.value
        if total <= 0:
            return
        lost = (self.skipped_steps_total.value
                + self.rollback_steps_total.value)
        self.goodput.set(max(0.0, 1.0 - lost / total))

    def step_percentiles_ms(self):
        """(p50, p99) step time in milliseconds, Nones when empty — the
        summary bench legs embed in their JSONL records."""
        p50 = self.step_seconds.percentile(50)
        p99 = self.step_seconds.percentile(99)
        to_ms = lambda v: None if v is None else v * 1e3  # noqa: E731
        return to_ms(p50), to_ms(p99)

    def host_gap_percentiles_ms(self):
        """(p50, p99) host blocked-on-device time in milliseconds, Nones
        when empty. One observation per window fetch: the wall time of
        the device read that closes the window — everything else in the
        loop body is async dispatch, so this is the only place the host
        actually waits and the honest measure of how much step time the
        dispatch pipeline failed to hide."""
        p50 = self.host_gap_seconds.percentile(50)
        p99 = self.host_gap_seconds.percentile(99)
        to_ms = lambda v: None if v is None else v * 1e3  # noqa: E731
        return to_ms(p50), to_ms(p99)


class ServeTelemetry:
    """Serving-engine instruments over a shared registry.

    ``labels`` stamps every instrument with the same label set (the
    TrainTelemetry pattern): the disaggregated facade creates one
    bundle per pool (``labels={"pool": "prefill"}`` / ``"decode"``) on
    a shared registry, so per-pool series federate side by side."""

    def __init__(self, registry: Optional[Registry] = None,
                 labels: Optional[Dict[str, str]] = None):
        reg = registry if registry is not None else Registry()
        self.registry = reg
        self.labels = dict(labels) if labels else None
        labels = self.labels
        # serving latencies reach sub-100µs on real accelerators; start
        # the buckets a decade lower than the train histogram
        hist = lambda n, h: reg.histogram(  # noqa: E731
            n, h, lo=1e-5, hi=1e3, labels=labels)
        self.ttft_seconds = hist(
            "tpu_worker_ttft_seconds", "request arrival to first token")
        self.tpot_seconds = hist(
            "tpu_worker_tpot_seconds", "inter-token gap per slot")
        self.prefill_seconds = hist(
            "tpu_worker_prefill_seconds",
            "prefill chunk host dispatch time (async)")
        self.decode_step_seconds = hist(
            "tpu_worker_decode_step_seconds",
            "decode step wall time, dispatch to token sync")
        self.host_gap_seconds = hist(
            "tpu_worker_host_gap_seconds",
            "host blocked on the device token read per step")
        self.kv_handoff_seconds = hist(
            "tpu_worker_kv_handoff_seconds",
            "prefill->decode KV page handoff, install + copy dispatch")
        self.queue_depth = reg.gauge(
            "tpu_worker_queue_depth", "requests waiting for a slot",
            labels=labels)
        self.slot_occupancy = reg.gauge(
            "tpu_worker_slot_occupancy", "slots currently bound",
            labels=labels)
        self.slots = reg.gauge(
            "tpu_worker_slots", "configured decode slots", labels=labels)
        self.step_compiles = reg.gauge(
            "tpu_worker_step_compiles", "decode-step compile count",
            labels=labels)
        self.prefill_compiles = reg.gauge(
            "tpu_worker_prefill_compiles", "prefill compile count",
            labels=labels)
        self.requests_total = reg.counter(
            "tpu_worker_requests_total", "requests retired",
            labels=labels)
        self.tokens_total = reg.counter(
            "tpu_worker_tokens_total", "new tokens emitted",
            labels=labels)
        self.kv_handoff_pages = reg.counter(
            "tpu_worker_kv_handoff_pages_total",
            "KV pages moved prefill->decode (prefix hits excluded)",
            labels=labels)
        self.pages_total = reg.gauge(
            "tpu_worker_kv_pages_total",
            "usable KV pages (paged mode; pool minus the trash page)",
            labels=labels)
        self.pages_in_use = reg.gauge(
            "tpu_worker_kv_pages_in_use",
            "KV pages referenced by live requests", labels=labels)
        self.pages_cached = reg.gauge(
            "tpu_worker_kv_pages_cached",
            "idle prefix-cache pages retained for future lookups",
            labels=labels)
        self.prefix_hit_pages = reg.counter(
            "tpu_worker_prefix_hit_pages_total",
            "prompt pages served from the prefix cache at admission",
            labels=labels)
        self.prefix_miss_pages = reg.counter(
            "tpu_worker_prefix_miss_pages_total",
            "prompt pages prefilled cold", labels=labels)
        self.spec_proposed_total = reg.counter(
            "tpu_worker_spec_proposed_total",
            "draft tokens sent to speculative verify steps",
            labels=labels)
        self.spec_accepted_total = reg.counter(
            "tpu_worker_spec_accepted_total",
            "draft tokens accepted (matched the model's argmax)",
            labels=labels)
        # ratio/count histograms, not latencies: buckets spanning
        # [0.01, 1] and [1, draft_k+1] at the default resolution — the
        # latency bundle's 1e-5 floor would waste 3 decades of edges
        self.spec_acceptance_ratio = reg.histogram(
            "tpu_worker_spec_acceptance_ratio",
            "accepted/proposed drafts per row per verify step",
            lo=1e-2, hi=1.0, labels=labels)
        self.spec_tokens_per_step = reg.histogram(
            "tpu_worker_spec_tokens_per_step",
            "tokens emitted per row per verify step (bonus included)",
            lo=1.0, hi=64.0, labels=labels)


class RouterTelemetry:
    """Serving-router (front door) instruments over a shared registry.

    Per-replica dispatch counters follow the bundle-per-label-set
    pattern lazily: ``dispatch_for(i)`` creates the ``{replica="i"}``
    series on first use, so the bundle needs no up-front fleet size
    (failover can retarget a shrunken fleet without dead series).

    Push-based load reports land here too: ``note_heartbeat(i, ...)``
    stores the newest report per replica (``heartbeat(i)`` reads it
    back — the router's dispatch scoring prefers a fresh report over
    probing engine state) and mirrors it into lazy
    ``tpu_router_replica_{queue_depth,free_slots,free_pages}{replica=}``
    gauges so a scrape sees the same picture the router routes on."""

    def __init__(self, registry: Optional[Registry] = None,
                 labels: Optional[Dict[str, str]] = None):
        reg = registry if registry is not None else Registry()
        self.registry = reg
        self.labels = dict(labels) if labels else None
        labels = self.labels
        self.shed_total = reg.counter(
            "tpu_router_shed_total",
            "requests rejected at the front door (fleet saturated)",
            labels=labels)
        self.requests_total = reg.counter(
            "tpu_router_requests_total",
            "requests completed through the router (sheds excluded)",
            labels=labels)
        self.resubmits_total = reg.counter(
            "tpu_router_resubmits_total",
            "in-flight requests replayed to survivors after a replica "
            "death", labels=labels)
        self.replica_deaths = reg.counter(
            "tpu_router_replica_deaths_total",
            "replicas marked dead from failed dispatches", labels=labels)
        self.affinity_hit_pages = reg.counter(
            "tpu_router_affinity_hit_pages_total",
            "prompt pages predicted warm on the chosen replica at "
            "dispatch", labels=labels)
        self.affinity_miss_pages = reg.counter(
            "tpu_router_affinity_miss_pages_total",
            "prompt pages predicted cold at dispatch", labels=labels)
        self.queue_wait_seconds = reg.histogram(
            "tpu_router_queue_wait_seconds",
            "arrival to dispatch wait at the front door",
            lo=1e-5, hi=1e3, labels=labels)
        self.attach_total = reg.counter(
            "tpu_router_attach_total",
            "replicas joined live (scale-up steps, no gang restart)",
            labels=labels)
        self.detach_total = reg.counter(
            "tpu_router_detach_total",
            "replicas drained and detached live (scale-down steps)",
            labels=labels)
        self._dispatch: Dict[int, object] = {}
        self._heartbeats: Dict[int, Dict[str, float]] = {}
        self._hb_gauges: Dict[int, tuple] = {}

    def dispatch_for(self, replica: int):
        """The ``tpu_router_dispatch_total{replica="N"}`` counter,
        created on first use."""
        c = self._dispatch.get(replica)
        if c is None:
            merged = dict(self.labels or {})
            merged["replica"] = str(replica)
            c = self.registry.counter(
                "tpu_router_dispatch_total",
                "requests dispatched to this replica", labels=merged)
            self._dispatch[replica] = c
        return c

    def note_heartbeat(self, replica: int, now: float, queue_depth: int,
                       free_slots: int, free_pages: int) -> None:
        """Record one replica load report (engine heartbeat). `now` is
        SESSION time — staleness is judged on the same clock the router
        runs on, so wall-clock skew can never mark a fresh report
        stale."""
        self._heartbeats[replica] = {
            "now": float(now), "queue_depth": float(queue_depth),
            "free_slots": float(free_slots),
            "free_pages": float(free_pages)}
        gauges = self._hb_gauges.get(replica)
        if gauges is None:
            merged = dict(self.labels or {})
            merged["replica"] = str(replica)
            gauges = (
                self.registry.gauge(
                    "tpu_router_replica_queue_depth",
                    "queue depth last reported by this replica's "
                    "heartbeat", labels=merged),
                self.registry.gauge(
                    "tpu_router_replica_free_slots",
                    "free slots last reported by this replica's "
                    "heartbeat", labels=merged),
                self.registry.gauge(
                    "tpu_router_replica_free_pages",
                    "free+evictable KV pages last reported by this "
                    "replica's heartbeat", labels=merged))
            self._hb_gauges[replica] = gauges
        gauges[0].set(queue_depth)
        gauges[1].set(free_slots)
        gauges[2].set(free_pages)

    def heartbeat(self, replica: int) -> Optional[Dict[str, float]]:
        """The newest load report for one replica (None before the
        first beat). The caller judges freshness against its own
        staleness threshold."""
        return self._heartbeats.get(replica)


class WorkerTelemetry:
    """One per worker process: shared registry + lazy train/serve bundles
    + optional /metrics server + optional event log. Both hot loops feed
    the SAME registry, so one scrape shows train and serve series side by
    side (a worker can do both — e.g. background eval during serving).

    Two transports, one payload shape. Pull: `serve()` exposes /metrics,
    /events and /traces for the collector to scrape. Push: `push_report()`
    bundles the same three bodies (text-format metrics, event records,
    trace-span records) plus a `now` clock anchor into one JSON dict, and
    `push(url)` POSTs it — call it on the heartbeat cadence from the same
    loop that beats the router, so a NAT'd or sidecar-less worker reports
    without being reachable. JobObservatory.ingest_push accepts the dict
    with scrape-identical bookkeeping: same staleness convention, same
    clock correction, same fault-injection surface."""

    def __init__(self, registry: Optional[Registry] = None,
                 events: Optional[EventLog] = None,
                 traces_path: Optional[str] = None):
        self.registry = registry if registry is not None else Registry()
        self.events = events
        self.traces_path = traces_path
        self._train: Optional[TrainTelemetry] = None
        self._serving: Optional[ServeTelemetry] = None
        self._server: Optional[TelemetryServer] = None

    @property
    def train(self) -> TrainTelemetry:
        if self._train is None:
            self._train = TrainTelemetry(self.registry)
        return self._train

    @property
    def serving(self) -> ServeTelemetry:
        if self._serving is None:
            self._serving = ServeTelemetry(self.registry)
        return self._serving

    def serve(self, port: int = 0, host: str = "",
              healthy=None) -> TelemetryServer:
        if self._server is None:
            # export the event log alongside /metrics: the controller's
            # collector pulls /events with the same scrape and merges
            # the records into the job timeline (clock-offset corrected)
            events_path = self.events.path if self.events else None
            self._server = TelemetryServer(
                self.registry, port=port, host=host, healthy=healthy,
                events_path=events_path, traces_path=self.traces_path)
        return self._server

    def push_report(self) -> Dict[str, object]:
        """One push payload: the exact bodies the three GET endpoints
        would serve, in one dict. `now` is sampled here — the collector
        anchors clock correction on it just as it does for a scrape."""
        report: Dict[str, object] = {
            "now": time.time(),
            "metrics": render_registry(self.registry)}
        if self.events is not None:
            self.events.flush()
            report["events"] = read_events(self.events.path)
        if self.traces_path:
            report["traces"] = read_events(self.traces_path)
        return report

    def push(self, url: str, timeout: float = 5.0) -> bool:
        """POST push_report() to a collector ingest endpoint. Returns
        False (never raises) on transport failure — push is best-effort
        like a missed scrape; the next heartbeat retries with fresher
        data, and the collector's staleness convention covers the gap."""
        body = json.dumps(self.push_report()).encode()
        req = urllib.request.Request(
            url, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return 200 <= resp.status < 300
        except (OSError, ValueError, urllib.error.URLError):
            return False

    @property
    def port(self) -> Optional[int]:
        return self._server.port if self._server else None

    def close(self, close_events: bool = True) -> None:
        """Shutdown order matters: the event log is flushed FIRST so the
        final records (e.g. a preemption drain) are durable even if the
        HTTP server teardown hangs or the process is about to exit(215).
        close_events=False flushes but leaves a BORROWED event log open
        (the caller that opened it closes it)."""
        if self.events is not None:
            self.events.flush()
        if self._server is not None:
            self._server.close()
            self._server = None
        if self.events is not None and close_events:
            self.events.close()


__all__ = ["RouterTelemetry", "ServeTelemetry", "TrainTelemetry",
           "WorkerTelemetry"]
