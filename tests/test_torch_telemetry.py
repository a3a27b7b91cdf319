"""The port's telemetry (mpi_operator_tpu_torch/telemetry: its own copies
of the JAX package's framework-free metrics core, Prometheus exporter,
event log, tracer and worker bundles, plus profiler/NVTX spans) and the
serving engine's hooks, against the JAX originals on the CPU.

Each copied module gets the same inputs as its original and must give
the same outputs: histogram percentiles and snapshots, the rendered
Prometheus text, event-log records with torn tails and rotation, span
trees, hop percentiles and rendered trees. The port's ServeTelemetry
renders exactly the JAX bundle's `tpu_worker_*` series (the control
plane's collector federates them by name). Then the engines (gpt2-test,
f32, vocab 64, the weights of test_torch_serve.py's `_pair`): on the
same greedy trace the port's requests_total, tokens_total, page and
speculation counters and its event sequence (kind, request, slot)
equal the JAX engine's; tracing changes no token and no program count,
and each request's hops add up to its end-to-end time; /metrics of a
live engine scrapes over localhost; the heartbeat reports at its rate.
"""
import functools
import json
import urllib.request

import numpy as np
import pytest
import torch
from test_torch_serve import _pair

from mpi_operator_tpu import telemetry as jtel
from mpi_operator_tpu.serve import EngineConfig as JEngineConfig
from mpi_operator_tpu.serve import Request as JRequest
from mpi_operator_tpu.serve import ServingEngine as JServingEngine
from mpi_operator_tpu.telemetry import trace as jtrace
from mpi_operator_tpu_torch import telemetry as ttel
from mpi_operator_tpu_torch.serve import EngineConfig, Request, ServingEngine
from mpi_operator_tpu_torch.telemetry import trace as ttrace

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

V = 64


# ---------------------------------------------------------------------------
# the copied modules, input for input
# ---------------------------------------------------------------------------

def _fill(mod):
    """One registry of each kind of series, fed the same seeded values."""
    rs = np.random.RandomState(0)
    reg = mod.Registry()
    c = reg.counter("x_total", "a counter", labels={"pool": "decode"})
    g = reg.gauge("x_depth", "a gauge")
    h = reg.histogram("x_seconds", "a histogram", lo=1e-5, hi=1e3)
    h2 = reg.histogram("x_ratio", "ratios", lo=1e-2, hi=1.0,
                       labels={"replica": 'a"b\\c'})
    for x in rs.lognormal(-6, 2, 500):
        h.observe(float(x))
    for x in rs.uniform(0, 1, 50):
        h2.observe(float(x))
    h.observe_n(0.25, 7)
    c.inc(3)
    c.inc()
    g.set(7.5)
    g.dec(2)
    return reg, h


def test_registry_histograms_and_text_equal_the_originals():
    (ours, h), (theirs, jh) = _fill(ttel), _fill(jtel)
    for p in (0, 1, 50, 90, 99, 99.9, 100):
        assert h.percentile(p) == jh.percentile(p)
    assert h.snapshot() == jh.snapshot()
    assert h.count == jh.count and h.sum == jh.sum
    assert ttel.render_registry(ours) == jtel.render_registry(theirs)
    for v in (True, 3, 3.0, 2.5, 1e16, -0.1):
        assert ttel.format_value(v) == jtel.format_value(v)
    assert ttel.Histogram("e").percentile(50) is None


def _events(mod, path, torn=True, **kw):
    clock = iter(range(1000, 2000)).__next__
    log = mod.EventLog(str(path), clock=lambda: float(clock()), **kw)
    for i in range(12):
        log.emit(mod.SLOT_ADMIT, request=i, slot=i % 4, prompt_len=3 + i)
        log.bind(replica="1").emit(mod.SLOT_RETIRE, request=i,
                                   finish_reason="length")
    log.close()
    log.emit("late", request=99)                  # a no-op after close
    if torn:
        with open(path, "a") as f:
            f.write('{"ts": 1, "event": "torn')   # a writer killed mid-line
    return mod.read_events(str(path))


def test_event_log_records_torn_tails_and_rotation(tmp_path):
    ours = _events(ttel, tmp_path / "a" / "events.jsonl")
    theirs = _events(jtel, tmp_path / "b" / "events.jsonl")
    assert ours == theirs and len(ours) == 24
    assert ttel.read_events(str(tmp_path / "a" / "events.jsonl"),
                            kind="slot_retire") == \
        jtel.read_events(str(tmp_path / "b" / "events.jsonl"),
                         kind="slot_retire")
    ours = _events(ttel, tmp_path / "c" / "ev.jsonl", torn=False,
                   max_bytes=600, keep=2)
    theirs = _events(jtel, tmp_path / "d" / "ev.jsonl", torn=False,
                     max_bytes=600, keep=2)
    assert ours == theirs
    assert sorted(p.name for p in (tmp_path / "c").iterdir()) == \
        sorted(p.name for p in (tmp_path / "d").iterdir())
    from mpi_operator_tpu.telemetry import events as jev
    from mpi_operator_tpu_torch.telemetry import events as tev
    kinds = {k: v for k, v in vars(jev).items()
             if k.isupper() and isinstance(v, str)}
    assert {k: v for k, v in vars(tev).items()
            if k.isupper() and isinstance(v, str)} == kinds


def _spans(mod):
    """A fixed script of request traces (finished, timed out, failed
    over and replayed, sampled out) and session spans on a fake clock."""
    t = mod.Tracer(sample=0.5)
    for rid in range(20):
        rt = t.begin_request(rid, t0=float(rid), prompt_len=rid)
        if rt is None:
            continue
        rt.begin_hop("serve.admission", rid + 0.1)
        rt.begin_hop("serve.prefill", rid + 0.3, cached_tokens=rid % 3)
        if rid % 5 == 0:
            rt.abandon(rid + 0.4)
            rt = t.begin_request(rid, t0=float(rid))
            rt.event("failover", replica=1)
            rt.begin_hop("serve.prefill", rid + 0.5)
        rt.begin_hop("serve.decode", rid + 0.7)
        rt.attrs.update(new_tokens=rid)
        rt.finish("timeout" if rid % 7 == 0 else "ok", rid + 1.25)
    s = t.begin_session(0.0, slots=4)
    for i in range(6):
        s.child("serve.decode_step", 0.5 + i, 0.25, batch=i)
    s.child("serve.verify_step", 7.0, 0.5, batch=4, proposed=8,
            accepted=3)
    s.end(9.0)
    t.begin_session(10.0).abandon(11.0)
    return list(t.ring)


def test_tracer_span_trees_and_hop_percentiles_equal_the_originals():
    ours, theirs = _spans(ttrace), _spans(jtrace)
    assert ours == theirs and ours
    trees, jtrees = ttrace.build_trees(ours), jtrace.build_trees(theirs)
    assert trees == jtrees
    assert ttrace.hop_percentiles(ours) == jtrace.hop_percentiles(theirs)
    assert ttrace.hop_spans(ours) == jtrace.hop_spans(theirs)
    assert ttrace.orphan_spans(ours) == jtrace.orphan_spans(theirs) == []
    for tid, tree in trees.items():
        assert ttrace.trace_sum_gap(tree) == jtrace.trace_sum_gap(
            jtrees[tid])
        assert ttrace.render_tree(tree) == jtrace.render_tree(jtrees[tid])


def test_trace_sink_is_an_event_log(tmp_path):
    clock = lambda: 5.0   # noqa: E731
    for mod, name in ((ttrace, "a.jsonl"), (jtrace, "b.jsonl")):
        with mod.Tracer(str(tmp_path / name), clock=clock) as t:
            rt = t.begin_request(1, 0.0)
            rt.begin_hop("serve.admission", 0.0)
            rt.finish("ok", 1.0)
    assert ttrace.read_trace_spans(str(tmp_path / "a.jsonl")) == \
        jtrace.read_trace_spans(str(tmp_path / "b.jsonl"))


def test_serve_telemetry_renders_the_jax_series_names():
    """The naming contract: the port's ServeTelemetry renders the same
    tpu_worker_* series as the JAX bundle, labelled or not, and
    WorkerTelemetry's bundles share its registry."""
    def names(mod, labels=None):
        reg = mod.Registry()
        mod.ServeTelemetry(reg, labels=labels)
        mod.TrainTelemetry(reg)
        text = mod.render_registry(reg)
        return text, {line.split()[2] for line in text.splitlines()
                      if line.startswith("# TYPE")}
    for labels in (None, {"pool": "decode"}):
        (ours, ours_names), (theirs, theirs_names) = \
            names(ttel, labels), names(jtel, labels)
        assert ours == theirs
        assert ours_names == theirs_names
        assert all(n.startswith("tpu_worker_") for n in ours_names)
    w = ttel.WorkerTelemetry()
    assert w.serving.registry is w.train.registry is w.registry


def test_span_is_a_profiler_range_on_a_cpu_build():
    """span() nests, returns its context and shows in a profiler trace
    on a CPU-only torch (no NVTX there)."""
    with torch.profiler.profile() as prof:
        with ttel.span("serve.outer") as outer:
            with ttel.span("serve.inner"):
                torch.ones(2).sum()
    assert outer.name == "serve.outer"
    names = {e.name for e in prof.events()}
    assert {"serve.outer", "serve.inner"} <= names


# ---------------------------------------------------------------------------
# the engine's hooks against the JAX engine's
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models():
    return _pair("gpt2")


def _trace(seed=7, n=8, cls=Request, eos=None):
    rs = np.random.RandomState(seed)
    lens = [(1, 6), (3, 9), (9, 4), (14, 7), (5, 5), (7, 8), (12, 6),
            (2, 7)]
    return [cls(i, [int(t) for t in rs.randint(0, V, (p,))],
                max_new_tokens=m, eos_id=eos)
            for i, (p, m) in enumerate(lens[:n])]


def _hooked_pair(tmp_path, **kw):
    jm, params, tm = _models()
    cfg = dict(slots=4, chunk_buckets=(4, 8), **kw)
    hooks = {}
    for side, mod in (("ours", ttel), ("theirs", jtel)):
        hooks[side] = dict(
            telemetry=mod.ServeTelemetry(),
            events=mod.EventLog(str(tmp_path / f"{side}.jsonl")),
            tracer=mod.Tracer(sample=1.0))
    return (ServingEngine(tm, EngineConfig(**cfg), device="cpu",
                          **hooks["ours"]),
            JServingEngine(jm, params, JEngineConfig(**cfg),
                           **hooks["theirs"]),
            hooks)


def _counters(tel):
    return {name: getattr(tel, name).value for name in (
        "requests_total", "tokens_total", "prefix_hit_pages",
        "prefix_miss_pages", "spec_proposed_total", "spec_accepted_total",
        "slots", "pages_total", "step_compiles", "prefill_compiles")} | {
        name: getattr(tel, name).count for name in (
            "ttft_seconds", "tpot_seconds", "decode_step_seconds",
            "host_gap_seconds", "prefill_seconds", "spec_acceptance_ratio",
            "spec_tokens_per_step")}


@pytest.mark.parametrize("kw", [
    {}, dict(paged=True, page_size=8),
    dict(speculative="ngram", request_timeout=60.0)],
    ids=["contiguous", "paged", "spec"])
def test_engine_counters_and_events_equal_jax(kw, tmp_path):
    """One greedy trace with an EOS through both engines with every hook
    attached: the same counters and histogram counts, the same event
    sequence (kind, request, slot and the fields that are not times),
    the same span names in the same order a request, and complete
    traces."""
    ours, theirs, hooks = _hooked_pair(tmp_path, **kw)
    _, _, tm = _models()
    probe = _trace()[3]                      # its third token is the eos
    from mpi_operator_tpu_torch.models import generate
    eos = generate(tm, [probe.prompt], 8, device="cpu").tokens[
        0, len(probe.prompt) + 2].item()
    a = ours.run(_trace(eos=eos))
    b = theirs.run(_trace(cls=JRequest, eos=eos))
    assert any(r.finish_reason == "eos" for r in a.values())
    for rid in a:
        assert a[rid].tokens == b[rid].tokens
    got, want = _counters(hooks["ours"]["telemetry"]), \
        _counters(hooks["theirs"]["telemetry"])
    assert got == want
    if kw.get("paged"):
        assert got["prefix_hit_pages"] + got["prefix_miss_pages"] > 0
    if kw.get("speculative"):
        assert got["spec_proposed_total"] > 0
    for side in ("ours", "theirs"):
        hooks[side]["events"].close()
    drop = ("ts",)
    ev_ours = [{k: v for k, v in e.items() if k not in drop}
               for e in ttel.read_events(str(tmp_path / "ours.jsonl"))]
    ev_theirs = [{k: v for k, v in e.items() if k not in drop}
                 for e in jtel.read_events(str(tmp_path / "theirs.jsonl"))]
    assert ev_ours == ev_theirs and len(ev_ours) == 16
    spans = [hooks[s]["tracer"].ring for s in ("ours", "theirs")]
    for ring in spans:
        assert ttrace.orphan_spans(ring) == []
    trees = [ttrace.build_trees(ring) for ring in spans]
    for rid in a:
        names = [[s["name"] for s in t[rid]["spans"]] for t in trees]
        assert names[0] == names[1]
        assert trees[0][rid]["root"]["status"] == "ok"
    session = [sorted({s["name"] for s in ring if s["trace"] < 0})
               for ring in spans]
    assert session[0] == session[1]


def test_timeout_event_as_jax(tmp_path):
    """request_timeout=0 retires every request at its first sweep: the
    same request_timeout and slot_retire records as the JAX engine."""
    ours, theirs, hooks = _hooked_pair(tmp_path, request_timeout=0.0,
                                       paged=True, page_size=8)
    ours.run(_trace(n=3))
    theirs.run(_trace(n=3, cls=JRequest))
    for side in ("ours", "theirs"):
        hooks[side]["events"].close()
    recs = [[{k: v for k, v in e.items() if k != "ts"}
             for e in mod.read_events(str(tmp_path / f"{side}.jsonl"))]
            for side, mod in (("ours", ttel), ("theirs", jtel))]
    assert recs[0] == recs[1]
    assert {e["event"] for e in recs[0]} == {
        "slot_admit", "request_timeout", "slot_retire"}


@pytest.mark.parametrize("kw", [{}, dict(speculative="ngram")],
                         ids=["plain", "spec"])
def test_tracing_changes_no_token_and_hops_tile_e2e(kw):
    """tests/test_trace.py's engine pins on the port: tokens and program
    counts equal with the tracer on and off; each request's hops run
    admission .. decode and sum to its root's seconds; the session root
    parents the decode (and verify) step spans."""
    _, _, tm = _models()
    cfg = EngineConfig(slots=2, chunk_buckets=(4, 8), **kw)
    tracer = ttel.Tracer(sample=1.0)
    plain = ServingEngine(tm, cfg, device="cpu")
    traced = ServingEngine(tm, cfg, device="cpu", tracer=tracer)
    want = plain.run(_trace(n=4))
    got = traced.run(_trace(n=4))
    assert {r: got[r].tokens for r in got} == \
        {r: want[r].tokens for r in want}
    assert traced.compile_counts() == plain.compile_counts()
    assert tracer.open_requests() == []
    assert ttrace.orphan_spans(tracer.ring) == []
    trees = ttrace.build_trees(tracer.ring)
    for rid in got:
        tree = trees[rid]
        hops = [ttrace.hop_name(s) for s in tree["spans"]
                if s["parent"] is not None]
        assert hops[0] == "admission" and hops[-1] == "decode"
        assert ttrace.trace_sum_gap(tree) <= max(
            0.005, 0.02 * tree["root"]["seconds"])
    session = {s["name"] for s in tracer.ring if s["trace"] < 0}
    assert {"serve.session", "serve.decode_step"} <= session
    if kw:
        assert "serve.verify_step" in session


def test_metrics_scrape_of_a_live_engine():
    """WorkerTelemetry.serve on a free localhost port: /metrics while a
    session is open shows the live gauges, after it the totals;
    /healthz answers."""
    _, _, tm = _models()
    w = ttel.WorkerTelemetry()
    engine = ServingEngine(tm, EngineConfig(slots=2, chunk_buckets=(4, 8)),
                           device="cpu", telemetry=w.serving)
    server = w.serve(port=0, host="127.0.0.1")

    def get(path):
        url = f"http://127.0.0.1:{server.port}{path}"
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read().decode()
    try:
        engine.start()
        for r in _trace(n=4):
            engine.submit(r)
        engine.tick()
        _, live = get("/metrics")
        assert "tpu_worker_slot_occupancy 2" in live
        assert "tpu_worker_queue_depth 2" in live
        while engine.active:
            engine.tick()
        engine.finish()
        status, text = get("/metrics")
        assert status == 200
        assert "tpu_worker_requests_total 4" in text
        total = sum(r.max_new_tokens for r in _trace(n=4))
        assert f"tpu_worker_tokens_total {total}" in text
        assert "tpu_worker_slots 2" in text
        assert get("/healthz")[0] == 200
    finally:
        w.close()
    assert w.port is None


def test_heartbeat_reports_at_its_rate():
    """set_heartbeat: the hook gets the engine's load after admission,
    at most once per interval of session time; a bad interval raises,
    as the reference's."""
    _, _, tm = _models()
    engine = ServingEngine(tm, EngineConfig(
        slots=2, chunk_buckets=(4, 8), paged=True, page_size=8),
        device="cpu")
    with pytest.raises(ValueError, match="interval"):
        engine.set_heartbeat(lambda **kw: None, 0)
    beats = []
    clock = iter(np.arange(0.0, 100.0, 0.25)).__next__
    engine.set_heartbeat(lambda **kw: beats.append(kw), interval=1.0)
    engine.start(now_fn=lambda: float(clock()))
    for r in _trace(n=4):
        engine.submit(r)
    while engine.active:
        engine.tick()
    engine.finish()
    assert beats and set(beats[0]) == {"now", "queue_depth", "free_slots",
                                       "free_pages"}
    assert beats[0]["queue_depth"] == 2 and beats[0]["free_slots"] == 0
    gaps = np.diff([b["now"] for b in beats])
    assert (gaps >= 1.0).all()
    assert json.dumps(beats)              # plain numbers, serialisable
