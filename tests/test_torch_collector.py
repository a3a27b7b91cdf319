"""The port's job-level collector (telemetry/collector.py) and the
observatory's fault injector (telemetry/chaos.py) against the JAX
package's.

Three parts, 41 cases:

- **Parity** (15 cases): the same inputs through the JAX collector and
  the port's, compared with exact equality, since both are pure Python:
  `parse_prometheus`, a `MetricsFederation` pass (ingest, a failed
  scrape, the render, the frontier and SLO readers), `ClockSync` with
  `merge_timeline`, `goodput_ledger`, `resize_ledger` with
  `resize_lines`, `ledger_lines`, a `TraceFederation` tree and its
  render, a `JobObservatory` over a fake fetch and clock (merged
  records, the federated render, the progress lease), and the collector
  CLI's merge.
- **The 15 cases of tests/test_observability.py** on the port's
  collector and postmortem: timeline merge under clock skew, the goodput
  ledger, federation (pure, and end to end through the port's
  controller over the wire-level fake kube API server with real worker
  /metrics listeners), the collector and postmortem CLIs, timeline
  rotation and drain latency.
- **The collector cases of tests/test_trace.py (6) and
  tests/test_elastic.py (5)**: TraceFederation's idempotent ingest,
  clock offsets, exemplars and histograms, pushed reports, the resize
  ledger and its Prometheus text.
"""
import json
import os
import sys
import threading
import time
import urllib.request

import pytest

from mpi_operator_tpu.telemetry import collector as jcol
from mpi_operator_tpu.telemetry import trace as jtrace
from mpi_operator_tpu_torch import postmortem
from mpi_operator_tpu_torch.telemetry import WorkerTelemetry
from mpi_operator_tpu_torch.telemetry import collector as tcol
from mpi_operator_tpu_torch.telemetry import events as ev
from mpi_operator_tpu_torch.telemetry.collector import (
    ClockSync,
    JobObservatory,
    MetricsFederation,
    goodput_ledger,
    merge_timeline,
    parse_prometheus,
    resize_ledger,
    resize_lines,
)
from mpi_operator_tpu_torch.telemetry.collector import main as collector_main
from mpi_operator_tpu_torch.telemetry.trace import (REQUEST_ROOT, SPAN,
                                                    TRACE_HOP_BUCKETS)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from fake_kube_apiserver import FakeKubeAPIServer  # noqa: E402


def _rec(ts, event, **f):
    return {"ts": ts, "event": event, **f}


def test_merge_timeline_corrects_five_second_skew(tmp_path):
    """Two synthetic hosts, one +5s fast and one -5s slow against the
    controller clock. The TRUE order is interleaved; raw timestamps
    would garble it; per-host offsets must restore it exactly."""
    # true controller-clock times: a@100 (fast host), c@101 (controller),
    # b@102 (slow host), r@103 (controller)
    controller = [_rec(101.0, "gang_restart", restart=1),
                  _rec(103.0, "pods_ready")]
    fast = [_rec(105.0, "preemption_drain", step=5)]    # clock reads +5
    slow = [_rec(97.0, "emergency_checkpoint", step=5)]  # clock reads -5
    out = str(tmp_path / "timeline.jsonl")
    merged = merge_timeline(
        [(None, controller), ("fast:9100", fast), ("slow:9100", slow)],
        offsets={"fast:9100": -5.0, "slow:9100": +5.0},
        out_path=out)
    assert [r["event"] for r in merged] == [
        "preemption_drain", "gang_restart", "emergency_checkpoint",
        "pods_ready"]
    ts = [r["ts"] for r in merged]
    assert ts == sorted(ts) == [100.0, 101.0, 102.0, 103.0]
    # corrected records keep the evidence: raw ts + applied offset + host
    drain = merged[0]
    assert drain["ts_raw"] == 105.0 and drain["clock_offset"] == -5.0
    assert drain["host"] == "fast:9100"
    assert merged[1]["host"] == "controller"
    # the on-disk timeline is the same records, one JSON object per line
    with open(out) as fh:
        on_disk = [json.loads(line) for line in fh]
    assert on_disk == merged


def test_clock_sync_pins_offset_per_boot():
    cs = ClockSync()
    cs.note("h:9100", local_now=100.0, remote_now=105.0, boot_id="b1")
    assert cs.offset("h:9100") == -5.0
    # later scrapes of the SAME boot must not re-pin (network jitter in
    # the later samples would smear the correction)
    cs.note("h:9100", local_now=200.0, remote_now=209.0, boot_id="b1")
    assert cs.offset("h:9100") == -5.0
    # a new boot (pod restart) re-anchors
    cs.note("h:9100", local_now=300.0, remote_now=298.0, boot_id="b2")
    assert cs.offset("h:9100") == 2.0
    assert cs.offset("unknown") == 0.0


# ---------------------------------------------------------------------------
# the goodput ledger
# ---------------------------------------------------------------------------

def test_ledger_clean_drain_loses_nothing():
    records = [
        _rec(1.0, "preemption_drain", step=5),
        _rec(1.1, "emergency_checkpoint", step=5),
        _rec(2.0, "gang_restart", exit_code=215, restart=1),
        _rec(3.0, "checkpoint_restore", step=5),     # restore == frontier
        _rec(4.0, "run_complete", step=8),
    ]
    led = goodput_ledger(records)
    assert led["lost_steps"] == 0
    assert led["useful_steps"] == 8
    assert led["goodput"] == 1.0
    assert led["restarts"] == 1


def test_ledger_hard_death_charges_reexecuted_steps():
    """The tier1 --resilience shape: drain at 5 (lossless), finish at 8,
    hard death at 11 with last checkpoint 8, finish at 12 →
    re-executed 9-11 = 3 lost, 12 useful, goodput 0.8."""
    records = [
        _rec(1.0, "preemption_drain", step=5),
        _rec(1.1, "emergency_checkpoint", step=5),
        _rec(2.0, "gang_restart", exit_code=215, restart=1),
        _rec(3.0, "checkpoint_restore", step=5),
        _rec(4.0, "run_complete", step=8),
        _rec(5.0, "checkpoint_restore", step=8),
        _rec(6.0, "fault_injected", fault="die", step=11),
        _rec(7.0, "gang_restart", exit_code=217, restart=2),
        _rec(8.0, "checkpoint_restore", step=8),     # 9-11 re-run
        _rec(9.0, "run_complete", step=12),
    ]
    led = goodput_ledger(records)
    assert led["lost_steps"] == 3
    assert led["useful_steps"] == 12
    assert led["goodput"] == pytest.approx(0.8)
    assert led["restarts"] == 2


def test_ledger_rollback_charges_rewound_steps():
    records = [
        _rec(1.0, "run_complete", step=4),
        _rec(2.0, "divergence_rollback", from_step=7, to_step=4),
        _rec(3.0, "run_complete", step=9),
    ]
    led = goodput_ledger(records)
    assert led["lost_steps"] == 3
    assert led["useful_steps"] == 9
    assert led["rollbacks"] == 1


def test_ledger_empty_is_perfect():
    led = goodput_ledger([])
    assert led["goodput"] == 1.0
    assert led["lost_steps"] == 0


# ---------------------------------------------------------------------------
# federation aggregation (pure)
# ---------------------------------------------------------------------------

POD0 = """\
# HELP tpu_worker_steps_total train steps executed
# TYPE tpu_worker_steps_total counter
tpu_worker_steps_total 100
# TYPE tpu_worker_step gauge
tpu_worker_step 7
# TYPE tpu_worker_tokens_per_sec gauge
tpu_worker_tokens_per_sec 1000.5
# TYPE tpu_worker_step_seconds histogram
tpu_worker_step_seconds_bucket{le="0.1"} 3
tpu_worker_step_seconds_bucket{le="+Inf"} 5
tpu_worker_step_seconds_sum 0.4
tpu_worker_step_seconds_count 5
tpu_operator_syncs_total 9
"""

POD1 = """\
# TYPE tpu_worker_steps_total counter
tpu_worker_steps_total 40
# TYPE tpu_worker_step gauge
tpu_worker_step 9
# TYPE tpu_worker_tokens_per_sec gauge
tpu_worker_tokens_per_sec 999.5
# TYPE tpu_worker_step_seconds histogram
tpu_worker_step_seconds_bucket{le="0.1"} 1
tpu_worker_step_seconds_bucket{le="+Inf"} 2
tpu_worker_step_seconds_sum 0.3
tpu_worker_step_seconds_count 2
"""


def test_parse_prometheus_labels_and_types():
    samples, types = parse_prometheus(
        '# TYPE m counter\nm{a="x\\"y",b="z"} 4\nnot a sample\n')
    assert samples == [("m", {"a": 'x"y', "b": "z"}, 4.0)]
    assert types["m"] == "counter"


def test_federation_sums_maxes_and_merges():
    fed = MetricsFederation("trainjob", clock=lambda: 50.0)
    fed.ingest(0, POD0)
    fed.ingest(1, POD1)
    text = "\n".join(fed.render_lines())
    # counters sum across the gang; level gauges take the max;
    # throughput (_per_sec) gauges sum; histograms merge bucket-wise
    assert 'tpu_job_steps_total{job="trainjob"} 140' in text
    assert 'tpu_job_step{job="trainjob"} 9' in text
    assert 'tpu_job_tokens_per_sec{job="trainjob"} 2000' in text
    assert 'tpu_job_step_seconds_bucket{job="trainjob",le="0.1"} 4' in text
    assert 'tpu_job_step_seconds_count{job="trainjob"} 7' in text
    # operator series do NOT re-federate
    assert "tpu_job_syncs_total" not in text
    # both pods healthy
    assert 'tpu_job_up{job="trainjob",replica_rank="0"} 1' in text
    assert 'tpu_job_up{job="trainjob",replica_rank="1"} 1' in text
    assert fed.observed_step() == 9


def test_federation_failed_scrape_is_visible():
    clock = [100.0]
    fed = MetricsFederation("trainjob", clock=lambda: clock[0])
    fed.ingest(0, POD0)
    clock[0] = 130.0
    fed.scrape_failed(0)
    text = "\n".join(fed.render_lines())
    assert 'tpu_job_up{job="trainjob",replica_rank="0"} 0' in text
    assert ('tpu_job_scrape_failures_total{job="trainjob",'
            'replica_rank="0"} 1' in text)
    assert ('tpu_job_scrape_staleness_seconds{job="trainjob",'
            'replica_rank="0"} 30' in text)


# ---------------------------------------------------------------------------
# federation end to end: controller over the wire-level fake kube API
# server, scraping real worker /metrics listeners
# ---------------------------------------------------------------------------

def _http(url: str) -> str:
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.read().decode()


def test_federation_over_fake_kube_apiserver(tmp_path):
    from mpi_operator_tpu_torch.api.types import new_tpu_job
    from mpi_operator_tpu_torch.cluster.kubeclient import KubeAPIServer, KubeConfig
    from mpi_operator_tpu_torch.controller import (ControllerConfig,
                                             TPUJobController)
    from mpi_operator_tpu_torch.controller.metrics import MetricsServer

    fake = FakeKubeAPIServer().start()
    kube = KubeAPIServer(KubeConfig(server=fake.url),
                         request_timeout=5.0, watch_timeout_seconds=2)
    stop = threading.Event()
    controller = None
    metrics_srv = None
    workers = []
    try:
        controller = TPUJobController(
            kube, config=ControllerConfig(worker_metrics_port=1,
                                          events_dir=str(tmp_path),
                                          scrape_interval=0.0))
        assert controller.observatory is not None   # config switched it on
        controller.run(threadiness=1, stop_event=stop)
        job = new_tpu_job("trainjob", tpus=8)
        job.spec.template.main_container().image = "tpu-bench:latest"
        kube.create(job)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if fake.get_object("statefulsets", "default", "trainjob-worker"):
                break
            time.sleep(0.02)
        else:
            raise TimeoutError("controller never reconciled the job")
        # the sync recorded job_created on the controller's own event log;
        # it does so at its end, after it created the worker set, so wait
        # for that sync to finish
        obs = controller.observatory
        deadline = time.monotonic() + 10
        while (not obs.jobs.get("trainjob", {}).get("created")
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert obs.view("trainjob")["created"]

        # two real worker /metrics listeners stand in for the pods (the
        # fake API server hosts no kubelet, so the pod DNS names the
        # controller would scrape in-cluster don't resolve here)
        targets = {}
        for rank, step in ((0, 7), (1, 9)):
            wt = WorkerTelemetry()
            wt.train.update_window(tokens_per_sec=1000.0, step=step)
            srv = wt.serve(port=0, host="127.0.0.1")
            workers.append((wt, srv))
            targets[rank] = f"http://127.0.0.1:{srv.port}"
        obs.observe("trainjob", targets, force=True)

        # the federated series ride the controller's OWN /metrics scrape
        metrics_srv = MetricsServer(controller, port=0, host="127.0.0.1")
        text = _http(f"http://127.0.0.1:{metrics_srv.port}/metrics")
        assert "tpu_operator_syncs_total" in text
        assert 'tpu_job_step{job="trainjob"} 9' in text
        assert 'tpu_job_tokens_per_sec{job="trainjob"} 2000' in text
        assert 'tpu_job_up{job="trainjob",replica_rank="0"} 1' in text
        assert 'tpu_job_up{job="trainjob",replica_rank="1"} 1' in text
        assert 'tpu_job_goodput{job="trainjob"} 1' in text

        # kill pod 0 and re-observe: the dead pod must be VISIBLE
        workers[0][1].close()
        obs.observe("trainjob", targets, force=True)
        text = _http(f"http://127.0.0.1:{metrics_srv.port}/metrics")
        assert 'tpu_job_up{job="trainjob",replica_rank="0"} 0' in text
        assert ('tpu_job_scrape_failures_total{job="trainjob",'
                'replica_rank="0"} 1' in text)
        assert 'tpu_job_up{job="trainjob",replica_rank="1"} 1' in text
    finally:
        stop.set()
        controller and controller.queue.shut_down()
        for wt, srv in workers:
            srv.close()
            wt.close()
        metrics_srv and metrics_srv.close()
        kube.stop()
        fake.stop()


# ---------------------------------------------------------------------------
# observatory: /events scrape -> clock anchor -> merged timeline
# ---------------------------------------------------------------------------

def test_observatory_scrapes_events_and_writes_timeline(tmp_path):
    from mpi_operator_tpu_torch.telemetry import EventLog

    worker_log = EventLog(str(tmp_path / "worker" / "events.jsonl"))
    worker_log.emit("clock_anchor", boot_id="boot1", process_id=0)
    worker_log.emit("preemption_drain", step=5)
    wt = WorkerTelemetry(events=worker_log)
    wt.train.update_window(step=5)
    srv = wt.serve(port=0, host="127.0.0.1")
    try:
        obs = JobObservatory(events_dir=str(tmp_path / "op"),
                             scrape_interval=0.0)
        obs.note_created("trainjob", namespace="default", tpus=8)
        obs.observe("trainjob", {0: f"http://127.0.0.1:{srv.port}"},
                    force=True)
        # the /events payload's server-side "now" + the clock_anchor's
        # boot_id pin this host's offset (≈0 here — same machine); every
        # merged worker record carries the correction evidence
        merged = obs.merged_records("trainjob")
        events = [r["event"] for r in merged]
        assert "preemption_drain" in events and "job_created" in events
        drain = merged[events.index("preemption_drain")]
        assert drain["host"].startswith("127.0.0.1:")
        assert drain["ts"] == pytest.approx(
            drain["ts_raw"] + drain["clock_offset"])
        assert abs(drain["clock_offset"]) < 5.0
        # scraping a live step also emits first_step_observed exactly once
        obs.observe("trainjob", {0: f"http://127.0.0.1:{srv.port}"},
                    force=True)
        firsts = [r for r in obs.view("trainjob")["controller_records"]
                  if r["event"] == "first_step_observed"]
        assert len(firsts) == 1
        # terminal note writes <events_dir>/<job>/timeline.jsonl
        obs.note_terminal("trainjob", succeeded=True)
        out = os.path.join(str(tmp_path / "op"), "trainjob",
                           "timeline.jsonl")
        with open(out) as fh:
            lines = [json.loads(line) for line in fh]
        ts = [r["ts"] for r in lines]
        assert ts == sorted(ts) and len(lines) >= 4
        obs.close()
    finally:
        srv.close()
        wt.close()


# ---------------------------------------------------------------------------
# collector CLI round-trip + postmortem CLI
# ---------------------------------------------------------------------------

def test_collector_cli_emit_merge_and_postmortem(tmp_path, capsys):
    ctl = str(tmp_path / "controller.jsonl")
    wrk = str(tmp_path / "events.jsonl")
    for argv in (
        ["emit", "--log", ctl, "--job", "j", "job_created", "tpus=8"],
        ["emit", "--log", wrk, "--job", "j", "emergency_checkpoint",
         "step=5"],
        ["emit", "--log", wrk, "--job", "j", "fault_injected", "step=11"],
        ["emit", "--log", ctl, "--job", "j", "gang_restart",
         "exit_code=217", "restart=1"],
        ["emit", "--log", wrk, "--job", "j", "checkpoint_restore",
         "step=8"],
        ["emit", "--log", wrk, "--job", "j", "run_complete", "step=12"],
    ):
        assert collector_main(argv) == 0
    out = str(tmp_path / "timeline.jsonl")
    prom = str(tmp_path / "federated.prom")
    assert collector_main(["merge", "--job", "j", "--controller", ctl,
                           "--worker", f"w0={wrk}", "--out", out,
                           "--metrics-out", prom]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["lost_steps"] == 3 and summary["useful_steps"] == 12
    with open(prom) as fh:
        text = fh.read()
    assert 'tpu_job_steps_lost_total{job="j"} 3' in text
    assert 'tpu_job_goodput{job="j"} 0.8' in text

    # postmortem renders it and the ledger numbers agree
    assert postmortem.main([out]) == 0
    report = capsys.readouterr().out
    assert "gang_restart" in report and "goodput" in report
    assert "0.8000" in report

    # empty and unparseable timelines are a nonzero exit
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert postmortem.main([str(empty)]) == 2
    garbage = tmp_path / "garbage.jsonl"
    garbage.write_text("not json\nstill not json\n")
    assert postmortem.main([str(garbage)]) == 2
    assert postmortem.main(["--json", out]) == 0
    js = json.loads(capsys.readouterr().out)
    assert js["ledger"]["lost_steps"] == 3


# ---------------------------------------------------------------------------
# timeline rotation (TPU_TIMELINE_MAX_BYTES) + drain latency
# ---------------------------------------------------------------------------

def test_timeline_rotation_spans_chain(tmp_path, monkeypatch):
    """With TPU_TIMELINE_MAX_BYTES set, write_timeline appends
    incrementally (no duplicates across calls) and rotates through the
    events.py .N chain; both read_events and postmortem.read_timeline
    see every record across the generations."""
    from mpi_operator_tpu_torch.telemetry.events import event_files, read_events

    monkeypatch.setenv("TPU_TIMELINE_MAX_BYTES", "600")
    monkeypatch.setenv("TPU_TIMELINE_KEEP", "10")
    obs = JobObservatory(events_dir=str(tmp_path), scrape_interval=0.0)
    obs.note_created("j", tpus=8)
    out = None
    for step in range(40):
        obs.record("j", "window_stats", step=step)
        out = obs.write_timeline("j")
    assert os.path.getsize(out) <= 600
    assert len(event_files(out)) >= 2        # the cap actually rotated
    for records in (read_events(out), postmortem.read_timeline(out)):
        steps = [r["step"] for r in records
                 if r.get("event") == "window_stats"]
        assert sorted(steps) == list(range(40))   # complete, no dupes
        assert any(r.get("event") == "job_created" for r in records)
    obs.close()


def test_timeline_uncapped_rewrite_unchanged(tmp_path, monkeypatch):
    """Without the env cap the historical behaviour holds: one atomic
    full rewrite per call, no .N files."""
    from mpi_operator_tpu_torch.telemetry.events import event_files

    monkeypatch.delenv("TPU_TIMELINE_MAX_BYTES", raising=False)
    obs = JobObservatory(events_dir=str(tmp_path), scrape_interval=0.0)
    obs.note_created("j", tpus=8)
    for step in range(10):
        obs.record("j", "window_stats", step=step)
        out = obs.write_timeline("j")
    assert event_files(out) == [out]
    assert len(postmortem.read_timeline(out)) == 11
    obs.close()


def test_postmortem_drain_latency(tmp_path, capsys):
    """preemption_drain -> same host's next emergency_checkpoint delta
    is computed per host and surfaced in both the summary and the
    rendered report; an unpaired checkpoint gets no latency."""
    path = tmp_path / "timeline.jsonl"
    recs = [
        _rec(0.0, "job_created", job="j", host="controller"),
        _rec(1.0, "preemption_drain", step=5, host="w0"),
        _rec(2.0, "emergency_checkpoint", step=7, host="w1"),  # unpaired
        _rec(3.5, "emergency_checkpoint", step=5, host="w0"),
        _rec(4.0, "job_failed", host="controller"),
    ]
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    summary = postmortem.summarize(postmortem.read_timeline(str(path)))
    assert summary["drain_latencies"] == [
        {"t": 3.5, "host": "w0", "seconds": 2.5}]
    paired = [i for i in summary["incidents"]
              if i.get("drain_seconds") is not None]
    assert len(paired) == 1 and paired[0]["host"] == "w0"

    assert postmortem.main([str(path)]) == 0
    report = capsys.readouterr().out
    assert "drain latency: 1 preemption drain(s)" in report
    assert "(drain->ckpt 2.5s)" in report


# ---------------------------------------------------------------------------
# the collector cases of tests/test_trace.py: trace federation and pushes
# ---------------------------------------------------------------------------

def _span_batch(trace, seconds, ts=1000.0):
    return [
        {"event": SPAN, "ts": ts, "trace": trace, "span": 2 * trace,
         "parent": None, "name": REQUEST_ROOT, "t0": 0.0,
         "seconds": seconds, "status": "ok"},
        {"event": SPAN, "ts": ts, "trace": trace, "span": 2 * trace + 1,
         "parent": 2 * trace, "name": "serve.decode", "t0": 0.0,
         "seconds": seconds, "status": "ok"},
    ]


def test_federation_ingest_is_idempotent():
    from mpi_operator_tpu_torch.telemetry.collector import TraceFederation
    fed = TraceFederation("j", clock=lambda: 1000.0)
    batch = _span_batch(1, 0.25)
    assert fed.ingest("pod-0", batch) == 2
    assert fed.ingest("pod-0", batch) == 0       # re-scrape: no-op
    assert fed.hops["decode"]["count"] == 1
    # the SAME span ids from another pod are distinct evidence (a
    # cross-pod tree's pieces arrive from different files)
    assert fed.ingest("pod-1", batch) == 2
    tree = fed.tree(1)
    assert tree["root"] is not None and len(tree["spans"]) == 2


def test_federation_offset_corrects_wall_ts_only():
    from mpi_operator_tpu_torch.telemetry.collector import TraceFederation
    fed = TraceFederation("j", clock=lambda: 1000.0)
    fed.ingest("pod-0", _span_batch(1, 0.25, ts=990.0), offset=10.0)
    span = fed.spans[1][0]
    assert span["ts"] == pytest.approx(1000.0)
    assert span["ts_raw"] == pytest.approx(990.0)
    assert span["seconds"] == pytest.approx(0.25)   # durations untouched


def test_federation_exemplars_slowest_first():
    from mpi_operator_tpu_torch.telemetry.collector import TraceFederation
    fed = TraceFederation("j", clock=lambda: 1000.0)
    for trace, secs in [(1, 0.1), (2, 0.9), (3, 0.4)]:
        fed.ingest("pod-0", _span_batch(trace, secs))
    assert fed.slowest_trace() == 2
    assert [t for _s, t in fed.exemplars()] == [2, 3, 1]
    # outside the window the pool drains
    late = TraceFederation("j", clock=lambda: 5000.0, window=600.0)
    late.ingest("pod-0", _span_batch(4, 1.0, ts=1000.0))
    assert late.slowest_trace() is None


def test_federation_histogram_lines():
    from mpi_operator_tpu_torch.telemetry.collector import TraceFederation
    fed = TraceFederation("j", clock=lambda: 1000.0)
    fed.ingest("pod-0", _span_batch(1, 0.003))
    lines = fed.render_lines()
    text = "\n".join(lines)
    assert '# TYPE tpu_job_trace_hop_seconds histogram' in text
    assert 'tpu_job_trace_hop_seconds_count{job="j",hop="decode"} 1' \
        in text
    # cumulative buckets: every edge >= 0.005 counts the 3ms decode
    assert 'le="0.005"} 1' in text and 'le="0.001"} 0' in text
    assert len([ln for ln in lines if "_bucket" in ln]) \
        == len(TRACE_HOP_BUCKETS) + 1


def test_observatory_push_ingests_like_a_scrape():
    from mpi_operator_tpu_torch.telemetry.collector import JobObservatory
    now = [100.0]
    obs = JobObservatory(clock=lambda: now[0])
    payload = {
        "now": 100.0,
        "metrics": ("# TYPE tpu_worker_tokens_total counter\n"
                    "tpu_worker_tokens_total 5\n"),
        "events": [{"ts": 99.0, "event": "serve_started"}],
        "traces": _span_batch(3, 0.7, ts=99.5),
    }
    assert obs.ingest_push("job", 0, payload, serving=True)
    view = obs.view("job")
    assert view["federation"].observed_tokens() == 5
    assert obs.slowest_trace("job") == 3
    assert view["worker_records"]["push-0"][0]["event"] == "serve_started"
    # the push advanced the serving progress lease exactly like a scrape
    assert view["progress_step"] == 5 and view["progress_ts"] == 100.0
    # federated render carries the trace histograms
    assert any("tpu_job_trace_hop_seconds" in ln
               for ln in view["traces"].render_lines())


def test_observatory_push_rides_the_fault_injector():
    from mpi_operator_tpu_torch.telemetry.chaos import ScrapeFaultInjector
    from mpi_operator_tpu_torch.telemetry.collector import JobObservatory
    obs = JobObservatory(clock=lambda: 100.0,
                         scrape_injector=ScrapeFaultInjector(["*/fail=1"]))
    ok = obs.ingest_push("job", 0, {"now": 100.0, "metrics": ""})
    assert not ok                            # the injected fault dropped it
    view = obs.view("job")
    assert view["federation"].pods[0]["failures"] == 1
    assert obs.scrape_injector.fault_count("fail") == 1


# ---------------------------------------------------------------------------
# the collector cases of tests/test_elastic.py: the resize ledger
# ---------------------------------------------------------------------------

def _erec(event, ts, **fields):
    return {"ts": ts, "event": event, **fields}


_RESIZE_RECORDS = [
    _erec(ev.JOB_CREATED, 9.0, job="j"),
    _erec(ev.PREEMPTION_DRAIN, 10.0, step=5, stop_check_every=8),
    _erec(ev.EMERGENCY_CHECKPOINT, 10.4, step=5),
    _erec(ev.GANG_RESIZE, 11.0, job="j", workers=2, tpus=4, replicas=2),
    _erec(ev.CHECKPOINT_RESTORE, 12.0, step=5, seconds=0.7,
         resharded=True),
    _erec(ev.FIRST_RESUME_STEP, 13.5, step=7, seconds=1.5),
]


def test_resize_ledger_phase_split():
    (resize,) = resize_ledger(_RESIZE_RECORDS)
    assert resize["drain_seconds"] == 0.4
    assert resize["restore_seconds"] == 0.7
    assert resize["recompile_seconds"] == 1.5
    assert resize["total_seconds"] == 3.5      # drain start -> resume step
    assert resize["workers"] == 2 and resize["tpus"] == 4


def test_resize_ledger_incomplete_entry_kept():
    """A gang that died mid-resize still shows up — with only the phases
    it reached and no total."""
    records = _RESIZE_RECORDS[:4]              # no restore, no resume
    (resize,) = resize_ledger(records)
    assert resize["drain_seconds"] == 0.4
    assert "restore_seconds" not in resize
    assert "total_seconds" not in resize


def test_resize_ledger_ignores_plain_restores():
    """checkpoint_restore outside a resize window (ordinary restart)
    never opens a ledger entry."""
    records = [
        _erec(ev.CHECKPOINT_RESTORE, 5.0, step=3, seconds=0.2),
        _erec(ev.FIRST_RESUME_STEP, 6.0, step=4, seconds=0.9),
    ]
    assert resize_ledger(records) == []


def test_resize_lines_prometheus_text():
    lines = resize_lines("j", resize_ledger(_RESIZE_RECORDS))
    text = "\n".join(lines)
    # total 3.5 lands in the le=5.0 bucket and above, not le=2.5
    assert 'tpu_job_resize_seconds_bucket{job="j",le="2.5"} 0' in text
    assert 'tpu_job_resize_seconds_bucket{job="j",le="5.0"} 1' in text
    assert 'tpu_job_resize_seconds_bucket{job="j",le="+Inf"} 1' in text
    assert 'tpu_job_resize_seconds_count{job="j"} 1' in text
    assert 'tpu_job_resizes_total{job="j"} 1' in text
    assert 'tpu_job_resize_drain_seconds{job="j"} 0.4' in text
    assert 'tpu_job_resize_restore_seconds{job="j"} 0.7' in text
    assert 'tpu_job_resize_recompile_seconds{job="j"} 1.5' in text


def test_note_resize_gang_flag_picks_event():
    obs = JobObservatory()
    obs.note_resize("j", gang=True, workers=2, tpus=4)
    obs.note_resize("j", replicas=4)           # elastic shrink/grow
    events = [r["event"] for r in obs.view("j")["controller_records"]]
    assert events == [ev.GANG_RESIZE, ev.JOB_RESIZED]


# ---------------------------------------------------------------------------
# parity: the same inputs through the JAX collector and the port's, equal
# ---------------------------------------------------------------------------

#: a serving pod: per-pool labels, a router series, an SLO histogram
POD_SERVE = """\
# TYPE tpu_worker_requests_total counter
tpu_worker_requests_total{pool="decode"} 12
tpu_worker_tokens_total{pool="decode"} 480
# TYPE tpu_worker_queue_depth gauge
tpu_worker_queue_depth 3
# TYPE tpu_worker_ttft_seconds histogram
tpu_worker_ttft_seconds_bucket{le="0.05"} 4
tpu_worker_ttft_seconds_bucket{le="0.25"} 9
tpu_worker_ttft_seconds_bucket{le="+Inf"} 10
tpu_worker_ttft_seconds_sum 1.7
tpu_worker_ttft_seconds_count 10
# TYPE tpu_router_shed_total counter
tpu_router_shed_total 2
"""

#: the goodput ledger's record shapes: a clean drain, a hard death, a
#: rollback, a resize, nothing at all
LEDGER_CASES = {
    "clean-drain": [
        {"ts": 1.0, "event": "preemption_drain", "step": 5},
        {"ts": 1.1, "event": "emergency_checkpoint", "step": 5},
        {"ts": 2.0, "event": "gang_restart", "exit_code": 215,
         "restart": 1},
        {"ts": 3.0, "event": "checkpoint_restore", "step": 5},
        {"ts": 4.0, "event": "run_complete", "step": 8}],
    "hard-death": [
        {"ts": 4.0, "event": "run_complete", "step": 8},
        {"ts": 5.0, "event": "checkpoint_restore", "step": 8},
        {"ts": 6.0, "event": "fault_injected", "fault": "die", "step": 11},
        {"ts": 7.0, "event": "gang_restart", "exit_code": 217,
         "restart": 2},
        {"ts": 8.0, "event": "checkpoint_restore", "step": 8},
        {"ts": 9.0, "event": "run_complete", "step": 12}],
    "rollback": [
        {"ts": 1.0, "event": "run_complete", "step": 4},
        {"ts": 2.0, "event": "divergence_rollback", "from_step": 7,
         "to_step": 4},
        {"ts": 3.0, "event": "run_complete", "step": 9}],
    "resize": None,          # _RESIZE_RECORDS, defined above
    "empty": [],
}


def _ledger_records(case):
    recs = LEDGER_CASES[case]
    return _RESIZE_RECORDS if recs is None else recs


@pytest.mark.parametrize("text", [POD0, POD1, POD_SERVE,
                                  '# TYPE m counter\nm{a="x\\"y",b="z"} 4\n'
                                  'not a sample\nm{} +Inf\n\n'],
                         ids=["pod0", "pod1", "serve", "escapes"])
def test_parse_prometheus_equals_the_reference(text):
    assert tcol.parse_prometheus(text) == jcol.parse_prometheus(text)


def _federation_pass(mod):
    clock = [50.0]
    fed = mod.MetricsFederation("trainjob", clock=lambda: clock[0])
    fed.ingest(0, POD0)
    fed.ingest(1, POD1)
    fed.ingest(2, POD_SERVE)
    clock[0] = 80.0
    fed.scrape_failed(1)
    return {"lines": fed.render_lines(), "step": fed.observed_step(),
            "tokens": fed.observed_tokens(),
            "dark": fed.unreachable_ranks(),
            "ttft_p99": fed.histogram_quantile("tpu_worker_ttft_seconds",
                                               0.99),
            "step_p50": fed.histogram_quantile("tpu_worker_step_seconds",
                                               0.5),
            "queue": fed.gauge_value("tpu_worker_queue_depth"),
            "tps": fed.gauge_value("tpu_worker_tokens_per_sec")}


def test_federation_pass_equals_the_reference():
    want = _federation_pass(jcol)
    assert _federation_pass(tcol) == want
    assert want["dark"] == [1] and want["step"] == 9


def _merge(mod, tmp_path, side):
    cs = mod.ClockSync()
    cs.note("fast:9100", local_now=100.0, remote_now=105.0, boot_id="b1")
    cs.note("slow:9100", local_now=100.0, remote_now=95.0, boot_id="b1")
    cs.note("fast:9100", local_now=200.0, remote_now=209.0, boot_id="b1")
    anchor = {"ts": 104.0, "event": "clock_anchor", "boot_id": "b7"}
    sources = [
        (None, [_rec(101.0, "gang_restart", restart=1),
                _rec(103.0, "pods_ready")]),
        ("fast:9100", [_rec(105.0, "preemption_drain", step=5), anchor]),
        ("slow:9100", [_rec(97.0, "emergency_checkpoint", step=5)])]
    out = str(tmp_path / f"{side}.jsonl")
    merged = mod.merge_timeline(sources, offsets=cs.offsets, out_path=out)
    with open(out) as fh:
        on_disk = fh.read()
    return merged, on_disk, cs.offsets, mod.latest_boot_id(sources[1][1])


def test_merge_timeline_equals_the_reference(tmp_path):
    assert _merge(tcol, tmp_path, "torch") == _merge(jcol, tmp_path, "jax")


@pytest.mark.parametrize("case", sorted(LEDGER_CASES))
def test_goodput_ledger_and_its_lines_equal_the_reference(case):
    recs = _ledger_records(case)
    got, want = tcol.goodput_ledger(recs), jcol.goodput_ledger(recs)
    assert got == want
    labels = {"namespace": "default"}
    assert (tcol.ledger_lines("j", got, extra_labels=labels)
            == jcol.ledger_lines("j", want, extra_labels=labels))


def test_resize_ledger_and_lines_equal_the_reference():
    live = [{"ts": 20.0, "event": "live_scale", "token": "t1",
             "action": "attach", "warmup_seconds": 0.3,
             "total_seconds": 0.9}]
    for recs in (_RESIZE_RECORDS, _RESIZE_RECORDS[:4],
                 _RESIZE_RECORDS + live):
        got, want = tcol.resize_ledger(recs), jcol.resize_ledger(recs)
        assert got == want
        if want:
            assert (tcol.resize_lines("j", got, extra_labels={"a": "b"})
                    == jcol.resize_lines("j", want, extra_labels={"a": "b"}))
    assert tcol.RESIZE_BUCKETS == jcol.RESIZE_BUCKETS


def _trace_batches(trace_mod):
    """Two pods' span files from real tracers: a request replayed across
    a failover, a shed one, a plain one."""
    out = []
    for pod in range(2):
        tracer = trace_mod.Tracer(sample=1.0)
        for rid, secs in ((1 + pod, 0.4), (3, 0.05)):
            rt = tracer.begin_request(rid, 0.0)
            rt.begin_hop("serve.queue", 0.0)
            rt.begin_hop("serve.prefill", 0.01)
            rt.begin_hop("serve.decode", 0.02)
            rt.finish("ok", secs)
        shed = tracer.begin_request(9 + pod, 0.0)
        shed.finish("shed", 0.001)
        # the span sink's record shape: the ring's spans, stamped
        out.append([dict(s, event=trace_mod.SPAN, ts=1000.0 + i)
                    for i, s in enumerate(tracer.ring)])
    return out


def _trace_federation(mod, trace_mod):
    fed = mod.TraceFederation("j", clock=lambda: 1100.0)
    counts = [fed.ingest(f"pod-{i}", batch, offset=2.5 * i)
              for i, batch in enumerate(_trace_batches(trace_mod))]
    counts.append(fed.ingest("pod-0", _trace_batches(trace_mod)[0]))
    return {"counts": counts, "trees": {t: fed.tree(t)
                                        for t in (1, 2, 3, 9, 10)},
            "lines": fed.render_lines(), "slowest": fed.slowest_trace(),
            "exemplars": fed.exemplars()}


def test_trace_federation_tree_equals_the_reference():
    from mpi_operator_tpu_torch.telemetry import trace as ttrace
    want = _trace_federation(jcol, jtrace)
    assert _trace_federation(tcol, ttrace) == want
    assert want["trees"][1]["root"] is not None


def _observatory_run(mod, tmp_path, side):
    """A JobObservatory over a fake fetch and clock: created, ready, a
    frontier that advances then stalls, one dark rank, a restart, a
    stuck verdict, a resize, a terminal write."""
    clock = [1000.0]
    step = {0: 5, 1: 5}
    dark = set()

    def fetch(url):
        rank = int(url.split("//w")[1].split(":")[0])
        if rank in dark:
            raise IOError(f"rank {rank} unreachable")
        if url.endswith("/metrics"):
            return (f"# TYPE tpu_worker_step gauge\n"
                    f"tpu_worker_step {step[rank]}\n"
                    f"tpu_worker_tokens_per_sec {100 * (rank + 1)}\n")
        if url.endswith("/events"):
            return json.dumps({"now": clock[0] + 3.0 * rank, "records": [
                {"ts": 990.0 + rank, "event": "clock_anchor",
                 "boot_id": f"b{rank}"},
                {"ts": 995.0 + rank, "event": "checkpoint_saved",
                 "step": step[rank]}]})
        raise IOError("no traces")

    obs = mod.JobObservatory(events_dir=str(tmp_path / side),
                             clock=lambda: clock[0], fetch=fetch,
                             scrape_interval=5.0)
    targets = {r: f"http://w{r}:9100" for r in (0, 1)}
    obs.note_created("j", namespace="default", tpus=8)
    obs.note_pods_ready("j", replicas=2)
    stalls = []
    for tick in range(8):
        clock[0] += 4.0
        if tick < 4:
            step[0] += 3
            step[1] += 3
        if tick == 5:
            dark.add(1)
        obs.observe("j", targets)
        stalls.append(obs.stall_seconds("j"))
    stalled_for = obs.stall_seconds("j")
    obs.note_stuck("j", stall_seconds=stalled_for, deadline=10)
    obs.note_restart("j", exit_code=None, restart=1)
    obs.note_resize("j", gang=True, workers=1, tpus=4)
    obs.note_terminal("j", succeeded=True)
    with open(os.path.join(str(tmp_path / side), "j",
                           "timeline.jsonl")) as fh:
        timeline = [json.loads(line) for line in fh]
    obs.close()
    for rec in timeline:          # the events log path differs per side
        rec.pop("path", None)
    return {"stalls": stalls, "merged": obs.merged_records("j"),
            "render": obs.render(), "partition": obs.partition_state("j"),
            "timeline": timeline}


def test_job_observatory_equals_the_reference(tmp_path):
    want = _observatory_run(jcol, tmp_path, "jax")
    got = _observatory_run(tcol, tmp_path, "torch")
    assert got == want
    assert list(want["partition"][0]) == [1]
    assert any(r["event"] == "gang_stuck" for r in want["merged"])


def test_collector_cli_merge_equals_the_reference(tmp_path, capsys):
    """`emit` then `merge` through each package's CLI: the same
    timeline, the same federated goodput text, the same summary."""
    outs = {}
    for side, main in (("jax", jcol.main), ("torch", tcol.main)):
        d = tmp_path / side
        d.mkdir()
        ctl, wrk = str(d / "controller.jsonl"), str(d / "events.jsonl")
        for log, event, fields in (
                (ctl, "job_created", ["tpus=8"]),
                (wrk, "emergency_checkpoint", ["step=5"]),
                (wrk, "fault_injected", ["step=11"]),
                (ctl, "gang_restart", ["exit_code=217", "restart=1"]),
                (wrk, "checkpoint_restore", ["step=8"]),
                (wrk, "run_complete", ["step=12"])):
            assert main(["emit", "--log", log, "--job", "j", event,
                         *fields]) == 0
        out, prom = str(d / "timeline.jsonl"), str(d / "federated.prom")
        assert main(["merge", "--job", "j", "--controller", ctl,
                     "--worker", f"w0={wrk}", "--offset", "w0=0.5",
                     "--out", out, "--metrics-out", prom]) == 0
        summary = json.loads(capsys.readouterr().out.strip()
                             .splitlines()[-1])
        summary.pop("timeline")
        with open(out) as fh:
            timeline = [json.loads(line) for line in fh]
        # the EventLog stamps wall time: compare the records' shape and
        # their order, not the clock
        for rec in timeline:
            rec.pop("ts"), rec.pop("ts_raw", None)
        with open(prom) as fh:
            outs[side] = (summary, timeline, fh.read())
    assert outs["torch"] == outs["jax"]
