"""The port's data-plane chaos (telemetry/chaos.py and the data-plane
legs of controller/chaos.py) against the JAX package's: the 33 cases of
tests/test_data_plane_chaos.py on the port's injector, collector,
controller and postmortem, the engine case on a port engine on the CPU
(tests/test_torch_soak_legs.py runs the soak's other legs).

The contracts under test, mirroring the control-plane chaos layer:

- **Scrape fault injection**: seeded ``<rank>/<kind>=<rate>`` rules are
  deterministic and replayable; each kind has load-bearing semantics
  (delay delivers one cycle late, stale-replay must NOT look like
  progress, a partition window keeps a rank dark for a stretch).
- **Federation vs. flakiness**: a failed scrape retains the rank's
  last-known samples, so neither the step nor the token frontier ever
  moves backward — and a stale replay never moves it forward.
- **Degraded, not stuck**: a partial partition (some ranks dark, the
  frontier still advancing through the rest) marks the gang
  DegradedGang and never restarts it; every rank dark IS a stall by
  design (an unobservable gang cannot prove liveness).
- **The serving progress lease**: serving gangs are watched through the
  retired-request/token frontier; a wedged engine is caught within
  progressDeadlineSeconds. Engine-side, expired requests retire with
  finish_reason "timeout" leaking no slots and no KV pages.
"""
import io

import pytest
import torch

from mpi_operator_tpu_torch.api import types as api
from mpi_operator_tpu_torch.controller import chaos as chaos_mod
from mpi_operator_tpu_torch.controller.chaos import (
    ConvergenceError,
    data_plane_degraded,
    data_plane_serving_lease,
    data_plane_tpot_slope,
)
from mpi_operator_tpu_torch.telemetry import events as ev
from mpi_operator_tpu_torch.telemetry.chaos import (
    DEFAULT_PARTITION_FETCHES,
    SCRAPE_FAULT_KINDS,
    ScrapeFaultInjector,
    ScrapeFaultRule,
)
from mpi_operator_tpu_torch.telemetry.collector import (
    JobObservatory,
    MetricsFederation,
)
from mpi_operator_tpu_torch import postmortem

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

pytestmark = pytest.mark.chaos


# ---------------------------------------------------------------------------
# scrape fault rules: parsing, matching, determinism
# ---------------------------------------------------------------------------

def test_scrape_rule_parses_the_documented_syntax():
    rule = ScrapeFaultRule.parse("3/partition-window=0.05")
    assert rule == ScrapeFaultRule(rank="3", kind="partition-window",
                                   rate=0.05)
    assert rule.matches(3) and not rule.matches(2)
    wildcard = ScrapeFaultRule.parse("*/fail=0.2")
    assert wildcard.matches(0) and wildcard.matches(17)
    assert set(SCRAPE_FAULT_KINDS) == {
        "fail", "delay", "stale-replay", "partition-window"}


@pytest.mark.parametrize("bad", [
    "nonsense", "0/fail", "fail=0.5", "0/explode=0.5", "x/fail=0.5",
    "-1/fail=0.5", "0/fail=0", "0/fail=1.5", "0/fail=abc"])
def test_scrape_rule_rejects_malformed_rules(bad):
    with pytest.raises(ValueError):
        ScrapeFaultRule.parse(bad)


def test_scrape_injection_is_deterministic_per_seed():
    def run(seed):
        inj = ScrapeFaultInjector(["*/fail=0.5"], seed=seed)
        outcomes = []
        for i in range(40):
            try:
                inj.fetch(i % 2, f"http://w{i % 2}/metrics",
                          lambda url: "ok")
                outcomes.append("ok")
            except IOError:
                outcomes.append("fail")
        return outcomes
    assert run(7) == run(7)
    assert run(7) != run(8)
    assert "ok" in run(7) and "fail" in run(7)


def test_first_matching_rule_wins_and_faults_are_attributed():
    inj = ScrapeFaultInjector(["0/fail=1", "0/stale-replay=1"], seed=1)
    for _ in range(5):
        with pytest.raises(IOError, match=r"seed=1"):
            inj.fetch(0, "http://w0/metrics", lambda url: "ok")
    # rank 1 matches no rule: pure pass-through
    assert inj.fetch(1, "http://w1/metrics", lambda url: "ok") == "ok"
    assert inj.faults_injected == {(0, "fail"): 5}
    assert inj.fault_count() == 5 and inj.fault_count("stale-replay") == 0


# ---------------------------------------------------------------------------
# fault kind semantics
# ---------------------------------------------------------------------------

def test_delay_delivers_one_cycle_late():
    inj = ScrapeFaultInjector(["0/delay=1"], seed=0)
    payloads = iter(["v1", "v2", "v3"])
    fetch = lambda url: next(payloads)       # noqa: E731
    # first delayed fetch has nothing lagged yet: injected timeout
    with pytest.raises(IOError, match="timed out"):
        inj.fetch(0, "u", fetch)
    # from then on the slow link delivers, one cycle behind
    assert inj.fetch(0, "u", fetch) == "v1"
    assert inj.fetch(0, "u", fetch) == "v2"
    assert inj.fault_count("delay") == 3


def test_stale_replay_serves_a_frozen_snapshot():
    inj = ScrapeFaultInjector(["0/stale-replay=1"], seed=0)
    payloads = iter(["v1", "v2", "v3"])
    fetch = lambda url: next(payloads)       # noqa: E731
    # nothing cached yet: the first fetch passes through (and caches)
    assert inj.fetch(0, "u", fetch) == "v1"
    # a stuck cache: the same snapshot forever, never refreshed
    assert inj.fetch(0, "u", fetch) == "v1"
    assert inj.fetch(0, "u", fetch) == "v1"
    assert inj.fault_count("stale-replay") == 2


def test_partition_window_keeps_the_rank_dark_then_heals():
    inj = ScrapeFaultInjector(["0/partition-window=1"], seed=0,
                              partition_fetches=2)
    with pytest.raises(IOError, match="window opened"):
        inj.fetch(0, "u", lambda url: "ok")
    assert inj.partitioned_ranks() == [0]
    # drop the rules: only the already-open window keeps it dark
    inj.rules = ()
    for _ in range(2):
        with pytest.raises(IOError, match="partitioned"):
            inj.fetch(0, "u", lambda url: "ok")
    assert inj.partitioned_ranks() == []
    assert inj.fetch(0, "u", lambda url: "ok") == "ok"
    assert inj.fault_count("partition-window") == 3
    assert DEFAULT_PARTITION_FETCHES >= 2    # default spans several passes


def test_open_partition_window_dominates_other_rules():
    # fail would fire every roll, but the open window wins (the rank is
    # dark, full stop) and its countdown is what decides the heal
    inj = ScrapeFaultInjector(["0/partition-window=1", "0/fail=1"],
                              seed=0, partition_fetches=1)
    with pytest.raises(IOError, match="window opened"):
        inj.fetch(0, "u", lambda url: "ok")
    with pytest.raises(IOError, match="partitioned"):
        inj.fetch(0, "u", lambda url: "ok")
    assert inj.faults_injected[(0, "partition-window")] == 2


# ---------------------------------------------------------------------------
# federation under flakiness: frontiers never move backward (satellite:
# scrape_failed <-> frontier interplay)
# ---------------------------------------------------------------------------

def test_scrape_failed_retains_last_known_samples():
    fed = MetricsFederation("j", clock=lambda: 0.0)
    fed.ingest(0, "tpu_worker_step 7\n")
    fed.ingest(1, "tpu_worker_step 5\n")
    assert fed.observed_step() == 7 and fed.unreachable_ranks() == []
    # rank 0 goes dark: its last-known step is RETAINED, so the frontier
    # cannot move backward under pure scrape flakiness
    fed.scrape_failed(0)
    assert fed.unreachable_ranks() == [0]
    assert fed.observed_step() == 7
    # the partition heals at a later step: per-rank frontier resumes
    fed.ingest(0, "tpu_worker_step 9\n")
    assert fed.unreachable_ranks() == [] and fed.observed_step() == 9


def test_never_scraped_rank_has_no_verdict():
    fed = MetricsFederation("j", clock=lambda: 0.0)
    assert fed.unreachable_ranks() == []
    fed.ingest(1, "tpu_worker_step 3\n")
    # rank 0 has never been attempted: no attempt, no verdict — it must
    # not show up as partition evidence
    assert fed.unreachable_ranks() == []


def test_observed_tokens_monotone_under_stale_and_failed_scrapes():
    fed = MetricsFederation("j", clock=lambda: 0.0)
    text = "tpu_worker_requests_total 3\ntpu_worker_tokens_total 50\n"
    fed.ingest(0, text)
    fed.ingest(1, "tpu_worker_requests_total 1\ntpu_worker_tokens_total 9\n")
    assert fed.observed_tokens() == 63
    # a stale replay re-ingests the identical snapshot: the latest scrape
    # REPLACES the rank's samples, so nothing double-counts and the
    # frontier reads the same value (stale must not look like progress)
    fed.ingest(0, text)
    assert fed.observed_tokens() == 63
    fed.scrape_failed(0)                     # dark: last counts retained
    assert fed.observed_tokens() == 63
    fed.ingest(0, "tpu_worker_requests_total 4\ntpu_worker_tokens_total 60\n")
    assert fed.observed_tokens() == 74       # resumption, no double count


def test_observatory_lease_slides_only_on_real_progress():
    clock = {"now": 1000.0}
    payload = {"text": "tpu_worker_step 5\n"}

    def fetch(url):
        if url.endswith("/metrics"):
            return payload["text"]
        raise IOError("no events endpoint")

    obs = JobObservatory(clock=lambda: clock["now"], fetch=fetch,
                         scrape_interval=0.0)
    assert obs.stall_seconds("j") is None    # lease disarmed before scrape
    obs.observe("j", {0: "http://w0:9100"}, force=True)
    assert obs.stall_seconds("j") == 0.0
    clock["now"] += 30
    obs.observe("j", {0: "http://w0:9100"}, force=True)
    assert obs.stall_seconds("j") == 30.0    # same step: lease frozen
    payload["text"] = "tpu_worker_step 6\n"
    clock["now"] += 10
    obs.observe("j", {0: "http://w0:9100"}, force=True)
    assert obs.stall_seconds("j") == 0.0     # frontier moved: lease slides


def test_never_scraped_rank_does_not_pin_the_lease():
    # rank 0 never scrapes successfully; rank 1's frontier advances.
    # The federated frontier is a MAX across ranks, so the dark rank
    # must not hold progress_ts back (no false stall from one straggler
    # that was never observable in the first place).
    clock = {"now": 1000.0}
    step = {"v": 5}

    def fetch(url):
        if "w0" in url:
            raise IOError("rank 0 dark from birth")
        if url.endswith("/metrics"):
            return f"tpu_worker_step {step['v']}\n"
        raise IOError("no events endpoint")

    obs = JobObservatory(clock=lambda: clock["now"], fetch=fetch,
                         scrape_interval=0.0)
    targets = {0: "http://w0:9100", 1: "http://w1:9100"}
    obs.observe("j", targets, force=True)
    for _ in range(4):
        clock["now"] += 30
        step["v"] += 1
        obs.observe("j", targets, force=True)
        assert obs.stall_seconds("j") == 0.0
    unreachable, total = obs.partition_state("j")
    assert unreachable == [0] and total == 2


def test_observatory_serving_lease_watches_the_token_frontier():
    clock = {"now": 1000.0}
    frontier = {"tokens": 0}

    def fetch(url):
        if url.endswith("/metrics"):
            return (f"tpu_worker_requests_total 2\n"
                    f"tpu_worker_tokens_total {frontier['tokens']}\n")
        raise IOError("no events endpoint")

    obs = JobObservatory(clock=lambda: clock["now"], fetch=fetch,
                         scrape_interval=0.0)
    obs.observe("s", {0: "http://w0:9100"}, force=True, serving=True)
    clock["now"] += 20
    frontier["tokens"] = 40                  # requests retiring
    obs.observe("s", {0: "http://w0:9100"}, force=True, serving=True)
    assert obs.stall_seconds("s") == 0.0
    clock["now"] += 45                       # the engine wedges
    obs.observe("s", {0: "http://w0:9100"}, force=True, serving=True)
    assert obs.stall_seconds("s") == 45.0


# ---------------------------------------------------------------------------
# degraded-gang discipline, end to end (the soak legs, in process)
# ---------------------------------------------------------------------------

def test_partial_partition_degrades_without_restart():
    report = data_plane_degraded(seed=0)
    assert report["false_positive_restarts"] == 0
    assert report["degraded_windows"] == 1
    assert report["scrape_faults_injected"] > 0


def test_all_ranks_dark_is_a_stall_not_a_degradation():
    # every rank dark: the frontier is unobservable, which IS a stall by
    # design — the degraded leg's zero-false-positive assertion trips
    with pytest.raises(ConvergenceError, match="restarted the gang"):
        data_plane_degraded(seed=0, scrape_faults=("*/fail=1",))


def test_serving_lease_catches_a_wedged_gang():
    report = data_plane_serving_lease(seed=0)
    assert report == {"serving_stalls_detected": 1,
                      "serving_false_positives": 0}


def test_observatory_tpot_slope_freezes_the_lease_below_floor():
    # the frontier ADVANCES every scrape, but below serving_rate_floor:
    # the lease must NOT renew — a creeping engine goes stuck by the
    # same wall-clock deadline as a frozen one
    clock = {"now": 1000.0}
    frontier = {"tokens": 0}

    def fetch(url):
        if url.endswith("/metrics"):
            return (f"tpu_worker_requests_total 2\n"
                    f"tpu_worker_tokens_total {frontier['tokens']}\n")
        raise IOError("no events endpoint")

    obs = JobObservatory(clock=lambda: clock["now"], fetch=fetch,
                         scrape_interval=0.0, serving_rate_floor=1.0)
    tgt = {0: "http://w0:9100"}
    # first advance of the incarnation always arms (no window yet)
    obs.observe("s", tgt, force=True, serving=True)
    # healthy: 40 tokens / 20 s = 2 tok/s >= floor -> lease renews
    clock["now"] += 20
    frontier["tokens"] = 40
    obs.observe("s", tgt, force=True, serving=True)
    assert obs.stall_seconds("s") == 0.0
    # creep: 2 tokens / 20 s = 0.1 tok/s < floor — progress_ts frozen
    # even though the frontier moves every scrape
    for _ in range(3):
        clock["now"] += 20
        frontier["tokens"] += 2
        obs.observe("s", tgt, force=True, serving=True)
    assert obs.stall_seconds("s") == 60.0
    # recovery: one healthy advance re-arms the lease
    clock["now"] += 20
    frontier["tokens"] += 100
    obs.observe("s", tgt, force=True, serving=True)
    assert obs.stall_seconds("s") == 0.0


def test_observatory_tpot_slope_off_by_default():
    # no floor configured: the same creeping trace renews the lease on
    # every advance (pre-existing behavior unchanged)
    clock = {"now": 1000.0}
    frontier = {"tokens": 0}

    def fetch(url):
        if url.endswith("/metrics"):
            return (f"tpu_worker_requests_total 2\n"
                    f"tpu_worker_tokens_total {frontier['tokens']}\n")
        raise IOError("no events endpoint")

    obs = JobObservatory(clock=lambda: clock["now"], fetch=fetch,
                         scrape_interval=0.0)
    tgt = {0: "http://w0:9100"}
    obs.observe("s", tgt, force=True, serving=True)
    for _ in range(3):
        clock["now"] += 20
        frontier["tokens"] += 2
        obs.observe("s", tgt, force=True, serving=True)
        assert obs.stall_seconds("s") == 0.0


def test_reset_progress_lease_clears_the_rate_window():
    # a gang restart must not measure its first post-restart advance
    # against the pre-restart frontier (that window spans the outage)
    clock = {"now": 1000.0}
    frontier = {"tokens": 0}

    def fetch(url):
        if url.endswith("/metrics"):
            return (f"tpu_worker_requests_total 2\n"
                    f"tpu_worker_tokens_total {frontier['tokens']}\n")
        raise IOError("no events endpoint")

    obs = JobObservatory(clock=lambda: clock["now"], fetch=fetch,
                         scrape_interval=0.0, serving_rate_floor=1.0)
    tgt = {0: "http://w0:9100"}
    obs.observe("s", tgt, force=True, serving=True)
    clock["now"] += 500                      # long outage, then restart
    obs.reset_progress_lease("s")
    assert obs.view("s")["rate_ts"] is None
    frontier["tokens"] = 10
    obs.observe("s", tgt, force=True, serving=True)
    # first advance after reset arms unconditionally — 10 tokens / 500 s
    # would read as creep if the stale window survived the reset
    assert obs.stall_seconds("s") == 0.0


def test_tpot_slope_lease_catches_a_creeping_gang():
    report = data_plane_tpot_slope(seed=0)
    assert report == {"tpot_slope_stalls_detected": 1,
                      "tpot_slope_false_positives": 0}


def test_degraded_condition_constants_exist():
    assert api.COND_DEGRADED_GANG == "DegradedGang"
    assert ev.GANG_DEGRADED == "gang_degraded"
    assert ev.REQUEST_TIMEOUT == "request_timeout"


# ---------------------------------------------------------------------------
# engine-side lease enforcement: request timeouts leak nothing
# ---------------------------------------------------------------------------

class _EventSink:
    def __init__(self):
        self.records = []

    def emit(self, event, **fields):
        rec = {"event": event, **fields}
        self.records.append(rec)
        return rec


def test_engine_request_timeouts_retire_and_reclaim():
    from mpi_operator_tpu_torch.serve import (EngineConfig, Request,
                                              ServingEngine)

    # the engine legs' model: gpt2-test, f32, vocab 64, from seed 0
    model = chaos_mod._test_lm(0, "cpu")
    sink = _EventSink()
    engine = ServingEngine(model, EngineConfig(
        slots=2, chunk_buckets=(4, 8), paged=True, page_size=8,
        rng_seed=0, request_timeout=0.0), device="cpu", events=sink)
    reqs = [Request(i, [1 + (i % 5)] * 6, 8) for i in range(3)]
    results = engine.run(reqs)
    assert len(results) == 3
    assert all(r.finish_reason == "timeout" for r in results.values())
    # the -1.0 ttft sentinel fires exactly when no token was emitted
    assert all((r.ttft == -1.0) == (not r.token_times)
               for r in results.values())
    timeouts = [r for r in sink.records
                if r["event"] == ev.REQUEST_TIMEOUT]
    assert {r["request"] for r in timeouts} == {0, 1, 2}
    assert all(r["deadline_seconds"] == 0.0 for r in timeouts)
    # zero leaks: every slot back in the pool, every KV page reclaimed
    engine.page_allocator.check()
    assert engine.page_allocator.in_use == 0
    assert len(engine.slots.free) == engine.config.slots
    # lift the timeout: the SAME engine must serve normally again
    engine.config.request_timeout = None
    after = engine.run([Request(9, [2, 3, 4], 4)])
    assert after[9].finish_reason in ("eos", "length")
    assert after[9].tokens


# ---------------------------------------------------------------------------
# postmortem: degraded windows land as first-class incidents
# ---------------------------------------------------------------------------

def test_postmortem_pairs_degraded_open_with_heal():
    records = [
        {"ts": 100.0, "event": ev.JOB_CREATED, "job": "j"},
        {"ts": 110.0, "event": ev.GANG_DEGRADED, "ranks": [0],
         "partitioned_ranks": 1, "total_ranks": 2},
        # the dark set changes shape mid-window: updates in place
        {"ts": 120.0, "event": ev.GANG_DEGRADED, "ranks": [0, 3],
         "partitioned_ranks": 2, "total_ranks": 4},
        {"ts": 150.0, "event": ev.GANG_DEGRADED, "healed": True,
         "ranks": [], "partitioned_ranks": 0},
        {"ts": 200.0, "event": ev.JOB_SUCCEEDED},
    ]
    summary = postmortem.summarize(records)
    (window,) = summary["degraded"]
    assert window["t"] == 10.0
    assert window["ranks"] == [0, 3]
    assert window["resolution"] == "healed"
    assert window["resolution_t"] == 50.0
    buf = io.StringIO()
    postmortem.render(summary, buf)
    text = buf.getvalue()
    assert "degraded gangs:" in text
    assert "no restart" in text
    assert "healed" in text


def test_postmortem_unhealed_window_resolved_by_terminal_event():
    records = [
        {"ts": 0.0, "event": ev.JOB_CREATED, "job": "j"},
        {"ts": 10.0, "event": ev.GANG_DEGRADED, "ranks": [1],
         "partitioned_ranks": 1, "total_ranks": 2},
        {"ts": 90.0, "event": ev.JOB_FAILED},
    ]
    summary = postmortem.summarize(records)
    (window,) = summary["degraded"]
    assert window["resolution"] == ev.JOB_FAILED
    buf = io.StringIO()
    postmortem.render(summary, buf)
    assert "degraded gangs:" in buf.getvalue()

