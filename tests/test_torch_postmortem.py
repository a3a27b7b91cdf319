"""The port's postmortem CLI (postmortem.py) against the JAX package's.

17 cases:

- **Parity** (12): for each of nine timelines (a resilience run with a
  hard death, a stuck gang, a resize with its drain, the fleet
  scheduler's actions, healed and unhealed degraded windows, SLO
  breaches with exemplar traces, a live scale step, drain latency
  across hosts), the port's `summarize` equals the JAX package's and
  `render`'s text equals the JAX package's; the CLI's report and
  `--json` summary equal the JAX CLI's on a timeline and a trace file.
- **The CLI stands alone**: in a fresh interpreter where importing
  torch or jax raises (the operator's image), `python -m
  mpi_operator_tpu_torch.postmortem` renders a report and exits 2 on an
  empty timeline; `telemetry/drain.py` is where its cadence suggestion
  comes from, and train/resilience.py re-exports the same function.
- **The postmortem cases of tests/test_elastic.py (2) and
  tests/test_trace.py (2)** on the port.
"""
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest

from mpi_operator_tpu import postmortem as jpm
from mpi_operator_tpu.telemetry import trace as jtrace
from mpi_operator_tpu_torch import postmortem as tpm
from mpi_operator_tpu_torch.postmortem import render, summarize
from mpi_operator_tpu_torch.telemetry import events as ev
from mpi_operator_tpu_torch.telemetry import trace as ttrace
from mpi_operator_tpu_torch.telemetry.drain import suggest_stop_check_every
from mpi_operator_tpu_torch.telemetry.trace import Tracer, build_trees

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: a fresh interpreter in which importing torch or jax raises, as in the
#: operator's image (deploy/Dockerfile.operator)
NO_DATA_PLANE = ("import sys\n"
                 "for m in ('torch', 'jax', 'jaxlib', 'triton'):\n"
                 "    sys.modules[m] = None\n")


def _rec(event, ts, **fields):
    return {"ts": ts, "event": event, **fields}


#: one clean 4->2 resize: drain 0.4s, restore 0.7s, recompile 1.5s,
#: total 3.5s (drain start 10.0 -> first resume step 13.5)
_RESIZE_RECORDS = [
    _rec(ev.JOB_CREATED, 9.0, job="j"),
    _rec(ev.PREEMPTION_DRAIN, 10.0, step=5, stop_check_every=8),
    _rec(ev.EMERGENCY_CHECKPOINT, 10.4, step=5),
    _rec(ev.GANG_RESIZE, 11.0, job="j", workers=2, tpus=4, replicas=2),
    _rec(ev.CHECKPOINT_RESTORE, 12.0, step=5, seconds=0.7,
         resharded=True),
    _rec(ev.FIRST_RESUME_STEP, 13.5, step=7, seconds=1.5),
]

TIMELINES = {
    "resilience": [
        _rec(ev.JOB_CREATED, 0.0, job="j", host="controller", tpus=8),
        _rec(ev.PODS_READY, 4.0, host="controller", replicas=2),
        _rec(ev.CLOCK_ANCHOR, 4.5, host="w0:9100", boot_id="b0"),
        _rec(ev.FIRST_STEP_OBSERVED, 9.0, host="controller", step=1),
        _rec(ev.CHECKPOINT_SAVED, 20.0, host="w0:9100", step=8),
        _rec(ev.FAULT_INJECTED, 25.0, host="w0:9100", fault="die",
             step=11),
        _rec(ev.GANG_RESTART, 26.0, host="controller", exit_code=217,
             restart=1, last_observed_step=11),
        _rec(ev.CHECKPOINT_RESTORE, 40.0, host="w0:9100", step=8,
             seconds=1.2),
        _rec("window_stats", 45.0, host="w0:9100", step=12),
        _rec(ev.RUN_COMPLETE, 60.0, host="w0:9100", step=20),
        _rec(ev.JOB_SUCCEEDED, 61.0, host="controller")],
    "stuck": [
        _rec(ev.JOB_CREATED, 0.0, job="j", host="controller"),
        _rec(ev.PODS_READY, 3.0, host="controller"),
        _rec(ev.FIRST_STEP_OBSERVED, 8.0, host="controller", step=12),
        _rec(ev.GANG_STUCK, 30.0, host="controller", stall_seconds=11.2,
             progress_deadline_seconds=10, last_observed_step=40),
        _rec(ev.GANG_RESTART, 30.1, host="controller", exit_code=None,
             restart=1, last_observed_step=40),
        _rec(ev.PODS_READY, 50.0, host="controller"),
        _rec(ev.JOB_FAILED, 90.0, host="controller", reason="StuckGang")],
    "resize": _RESIZE_RECORDS,
    "scheduler": None,        # _sched_timeline(), below
    "degraded-healed": [
        _rec(ev.JOB_CREATED, 100.0, job="j"),
        _rec(ev.GANG_DEGRADED, 110.0, ranks=[0], partitioned_ranks=1,
             total_ranks=2),
        _rec(ev.GANG_DEGRADED, 120.0, ranks=[0, 3], partitioned_ranks=2,
             total_ranks=4),
        _rec(ev.GANG_DEGRADED, 150.0, healed=True, ranks=[],
             partitioned_ranks=0),
        _rec(ev.JOB_SUCCEEDED, 200.0)],
    "degraded-unhealed": [
        _rec(ev.JOB_CREATED, 0.0, job="j"),
        _rec(ev.GANG_DEGRADED, 10.0, ranks=[1], partitioned_ranks=1,
             total_ranks=2),
        _rec(ev.JOB_FAILED, 90.0)],
    "slo-breaches": [
        _rec(ev.JOB_CREATED, 0.0, job="j"),
        _rec(ev.AUTOSCALE_BREACH, 5.0, job="j", target=2,
             reason="ttft_p99 2 > 0.5", exemplar_trace=7),
        _rec(ev.AUTOSCALE_BREACH, 7.0, job="j", target=3,
             reason="queue_depth 9 > 4", exemplar_trace=8),
        _rec(ev.REQUEST_TIMEOUT, 9.0, job="j", request=3,
             deadline_seconds=2.0),
        _rec(ev.JOB_SUCCEEDED, 12.0)],
    "live-scale": [
        _rec(ev.JOB_CREATED, 0.0, job="j", host="controller"),
        _rec(ev.LIVE_SCALE, 30.0, host="controller", token="t1",
             action="attach", replicas=2, warmup_seconds=0.3,
             total_seconds=0.9),
        _rec(ev.LIVE_SCALE, 90.0, host="controller", token="t2",
             action="detach", replicas=1, total_seconds=0.4),
        _rec(ev.JOB_SUCCEEDED, 120.0, host="controller")],
    "drain-latency": [
        _rec("job_created", 0.0, job="j", host="controller"),
        _rec("preemption_drain", 1.0, step=5, host="w0",
             stop_check_every=16),
        _rec("emergency_checkpoint", 2.0, step=7, host="w1"),
        _rec("emergency_checkpoint", 9.5, step=5, host="w0"),
        _rec("job_failed", 10.0, host="controller")],
}


def _sched_timeline():
    return [
        {"ts": 100.0, "event": ev.JOB_CREATED, "host": "c", "job": "d/lo"},
        {"ts": 101.0, "event": ev.SCHED_QUEUE, "host": "c", "job": "d/hi",
         "reason": "waiting for 4 chips", "priority": 1},
        {"ts": 110.0, "event": ev.SCHED_PREEMPT, "host": "c",
         "job": "d/lo", "victim": "d/lo", "beneficiary": "d/hi",
         "from_tpus": 8, "to_tpus": 4, "predicted_cost_seconds": 60.0},
        {"ts": 112.0, "event": ev.GANG_RESIZE, "host": "c", "job": "d/lo",
         "tpus": 4},
        {"ts": 116.0, "event": ev.SCHED_ADMIT, "host": "c", "job": "d/hi",
         "via": "preempt", "waited_seconds": 15.0},
        {"ts": 154.0, "event": ev.FIRST_RESUME_STEP, "host": "w",
         "job": "d/lo", "seconds": 39.0, "step": 12},
        {"ts": 300.0, "event": ev.SCHED_SKIP, "host": "c", "job": "d/h2",
         "reason": "queued wait 4s has not yet paid for 42s",
         "predicted_cost_seconds": 42.0, "reclaim_seconds": 4.0},
        {"ts": 400.0, "event": ev.SCHED_GROW_BACK, "host": "c",
         "job": "d/lo", "from_tpus": 4, "to_tpus": 8},
        {"ts": 500.0, "event": ev.SCHED_MIGRATE, "host": "c",
         "job": "d/lo", "rank": 0, "pod": "lo-worker-0",
         "migration_count": 1, "window_age_seconds": 75.0},
        {"ts": 600.0, "event": ev.JOB_SUCCEEDED, "host": "c",
         "job": "d/lo"},
    ]


def _timeline(name):
    recs = TIMELINES[name]
    return _sched_timeline() if recs is None else recs


def _trees(trace_mod):
    """Trace 7's hop tree (trace 8 sampled out), from each package's
    tracer."""
    tracer = trace_mod.Tracer(sample=1.0)
    rt = tracer.begin_request(7, 0.0)
    rt.begin_hop("serve.queue", 0.0)
    rt.begin_hop("serve.decode", 0.2)
    rt.finish("ok", 1.5)
    return trace_mod.build_trees(tracer.ring)


def _report(pm, trace_mod, records, trees):
    summary = pm.summarize(records)
    out = io.StringIO()
    pm.render(summary, out,
              trees=_trees(trace_mod) if trees == "trees" else trees)
    return summary, out.getvalue()


@pytest.mark.parametrize("name", sorted(TIMELINES))
def test_summary_and_report_equal_the_reference(name):
    records = _timeline(name)
    want = _report(jpm, jtrace, records, None)
    assert _report(tpm, ttrace, records, None) == want
    assert want[1].startswith("postmortem: job ")


@pytest.mark.parametrize("trees", ["trees", {}], ids=["with-traces",
                                                      "no-trace-file"])
def test_exemplar_rendering_equals_the_reference(trees):
    records = _timeline("slo-breaches")
    want = _report(jpm, jtrace, records, trees)
    assert _report(tpm, ttrace, records, trees) == want
    assert "slow traces:" in want[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def _cli(module, argv, poison=False):
    code = ((NO_DATA_PLANE if poison else "import sys\n") +
            "import runpy\n"
            f"sys.argv = [{module!r}] + {list(argv)!r}\n"
            f"runpy.run_module({module!r}, run_name='__main__', "
            "alter_sys=True)\n")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)


def _timeline_files(tmp_path):
    timeline = tmp_path / "timeline.jsonl"
    timeline.write_text("".join(json.dumps(r) + "\n"
                                for r in _timeline("resilience")
                                + _timeline("slo-breaches")[1:4]))
    traces = tmp_path / "traces.jsonl"
    with Tracer(path=str(traces), sample=1.0) as t:
        rt = t.begin_request(7, 0.0)
        rt.begin_hop("serve.decode", 0.0)
        rt.finish("ok", 0.25)
    return str(timeline), str(traces)


def test_cli_runs_without_torch_or_jax_and_equals_the_reference(tmp_path):
    """The port's CLI in an interpreter where torch and jax cannot load
    prints the JAX CLI's report, byte for byte, with and without the
    trace file and as --json; an empty timeline exits 2."""
    timeline, traces = _timeline_files(tmp_path)
    for argv in ([timeline], [timeline, "--traces", traces],
                 ["--json", timeline]):
        got = _cli("mpi_operator_tpu_torch.postmortem", argv, poison=True)
        want = _cli("mpi_operator_tpu.postmortem", argv)
        assert got.returncode == 0, got.stderr
        assert want.returncode == 0, want.stderr
        assert got.stdout == want.stdout
    assert "goodput" in got.stdout
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    got = _cli("mpi_operator_tpu_torch.postmortem", [str(empty)],
               poison=True)
    assert got.returncode == 2 and "no parseable event records" in got.stderr


def test_cadence_suggestion_loads_without_torch():
    """The postmortem's cadence suggestion comes from telemetry/drain.py,
    which loads no torch; train/resilience.py re-exports the same
    function and budget, and both equal the reference's."""
    from mpi_operator_tpu.train import resilience as jres
    from mpi_operator_tpu_torch.telemetry import drain
    from mpi_operator_tpu_torch.train import resilience as tres
    assert tres.suggest_stop_check_every is drain.suggest_stop_check_every
    assert tpm.suggest_stop_check_every is drain.suggest_stop_check_every
    assert (tres.ENV_DRAIN_TARGET, tres.DRAIN_TARGET_SECONDS) == (
        jres.ENV_DRAIN_TARGET, jres.DRAIN_TARGET_SECONDS)
    for args in ((0.4, 8, None), (9.0, 16, 5.0), (0.0, 8, 5.0)):
        assert (drain.suggest_stop_check_every(*args)
                == jres.suggest_stop_check_every(*args))
    out = _cli("mpi_operator_tpu_torch.postmortem", ["--help"], poison=True)
    assert out.returncode == 0, out.stderr


# ---------------------------------------------------------------------------
# the postmortem cases of tests/test_elastic.py and tests/test_trace.py
# ---------------------------------------------------------------------------

def test_postmortem_summary_resizes_and_suggestion():
    summary = summarize(_RESIZE_RECORDS)
    (resize,) = summary["resizes"]
    assert resize["t"] == 2.0          # rebased to the first record
    assert resize["total_seconds"] == 3.5
    assert "drain_start_ts" not in resize
    assert summary["suggested_stop_check_every"] == \
        suggest_stop_check_every(0.4, 8)
    # gang_resize is a milestone, first_resume_step an incident marker
    assert any(m["event"] == ev.GANG_RESIZE for m in summary["milestones"])
    assert any(i["event"] == ev.FIRST_RESUME_STEP
               for i in summary["incidents"])


def test_postmortem_render_mentions_resize():
    import io

    from mpi_operator_tpu_torch.postmortem import render

    out = io.StringIO()
    render(summarize(_RESIZE_RECORDS), out)
    text = out.getvalue()
    assert "gang resizes:" in text
    assert "suggested --stop-check-every" in text


def test_postmortem_renders_exemplar_tree_or_pending(tmp_path):
    import io

    from mpi_operator_tpu_torch.postmortem import render, summarize
    records = [
        {"ts": 0.0, "event": "job_created", "job": "j"},
        {"ts": 5.0, "event": "autoscale_breach", "job": "j", "target": 2,
         "reason": "ttft_p99 2 > 0.5", "exemplar_trace": 7},
        # sampled out: the breach recorded no trace id
        {"ts": 9.0, "event": "request_timeout", "job": "j", "request": 3},
    ]
    summary = summarize(records)
    assert [b["trace"] for b in summary["slo_breaches"]] == [7, None]

    tracer = Tracer(sample=1.0)
    rt = tracer.begin_request(7, 0.0)
    rt.begin_hop("serve.decode", 0.0)
    rt.finish("ok", 1.5)
    trees = build_trees(tracer.ring)

    out = io.StringIO()
    render(summary, out, trees=trees)
    text = out.getvalue()
    assert "slow traces:" in text
    assert "serve.request 1500.0ms" in text        # exemplar hop tree
    assert "exemplar pending (no trace id attached" in text
    # with no trace file at all, the breach with an id degrades to the
    # other pending message instead of crashing
    out2 = io.StringIO()
    render(summary, out2, trees={})
    assert "exemplar pending (trace 7 not in the trace file" \
        in out2.getvalue()


def test_postmortem_cli_reads_trace_file(tmp_path):
    import subprocess
    import sys

    timeline = tmp_path / "timeline.jsonl"
    with open(timeline, "w") as f:
        for rec in [
            {"ts": 0.0, "event": "job_created", "job": "j"},
            {"ts": 5.0, "event": "autoscale_breach", "job": "j",
             "reason": "ttft", "exemplar_trace": 7},
            {"ts": 9.0, "event": "job_succeeded", "job": "j"},
        ]:
            f.write(json.dumps(rec) + "\n")
    traces = tmp_path / "traces.jsonl"
    with Tracer(path=str(traces), sample=1.0) as t:
        rt = t.begin_request(7, 0.0)
        rt.begin_hop("serve.decode", 0.0)
        rt.finish("ok", 0.25)
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_operator_tpu_torch.postmortem",
         str(timeline), "--traces", str(traces)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert "slow traces:" in proc.stdout
    assert "serve.decode" in proc.stdout
