"""The decode autoscaler's policy and the serving SLO's admission rules,
against the PyTorch port's copies (mpi_operator_tpu_torch.controller.
autoscale, mpi_operator_tpu_torch.api.validation).

The scenarios of tests/test_router.py that go through those two modules,
copied with their imports changed, and its controller-integration
scenario (test_autoscale_scale_up_lands_in_status_and_pools), which
drives the port's job observatory and soak harness (controller/chaos.py
_observed_harness) on a fake clock.
"""
import pytest

from mpi_operator_tpu_torch.api.types import ServingSLO, ServingSpec, TPUJobSpec
from mpi_operator_tpu_torch.api.validation import ValidationError, validate_spec
from mpi_operator_tpu_torch.controller.autoscale import (
    DecodeAutoscaler,
    SLOObservation,
)


# ---------------------------------------------------------------------------
# DecodeAutoscaler policy (pure)
# ---------------------------------------------------------------------------

def _slo(**kw):
    base = dict(ttft_p99_seconds=1.0, min_decode_replicas=1,
                max_decode_replicas=8, breach_seconds=30.0,
                clear_seconds=60.0, cooldown_multiplier=4.0,
                cooldown_floor_seconds=10.0)
    base.update(kw)
    return ServingSLO(**base)


def test_breach_must_persist_before_scale_up():
    sc = DecodeAutoscaler(_slo())
    bad = SLOObservation(ttft_p99=2.0)
    d = sc.decide(100.0, bad, current=2, last_scaled_at=None,
                  last_resize_seconds=None)
    assert d.target is None and d.wake_after == pytest.approx(30.0)
    d = sc.decide(115.0, bad, current=2, last_scaled_at=None,
                  last_resize_seconds=None)
    assert d.target is None                      # held 15s < 30s
    d = sc.decide(130.0, bad, current=2, last_scaled_at=None,
                  last_resize_seconds=None)
    assert d.target == 3 and "ttft_p99" in d.reason


def test_one_good_scrape_resets_the_breach_timer():
    sc = DecodeAutoscaler(_slo())
    bad, good = SLOObservation(ttft_p99=2.0), SLOObservation(ttft_p99=0.5)
    sc.decide(0.0, bad, 2, None, None)
    sc.decide(20.0, good, 2, None, None)         # breach clears
    d = sc.decide(25.0, bad, 2, None, None)      # a NEW breach window
    assert d.target is None
    d = sc.decide(54.0, bad, 2, None, None)
    assert d.target is None                      # 29s into the new window
    assert sc.decide(55.0, bad, 2, None, None).target == 3


def test_cooldown_scales_with_measured_resize_cost():
    sc = DecodeAutoscaler(_slo())
    assert sc.cooldown_seconds(None) == 10.0     # floor until measured
    assert sc.cooldown_seconds(90.0) == 360.0    # 4 x the gang resize
    bad = SLOObservation(ttft_p99=2.0)
    sc.decide(0.0, bad, 2, None, 90.0)
    d = sc.decide(40.0, bad, 2, last_scaled_at=35.0,
                  last_resize_seconds=90.0)
    assert d.target is None and "cooling" in d.reason
    assert d.wake_after == pytest.approx(355.0)
    d = sc.decide(35.0 + 360.0, bad, 2, last_scaled_at=35.0,
                  last_resize_seconds=90.0)
    assert d.target == 3


def test_scale_up_clamped_at_max():
    sc = DecodeAutoscaler(_slo(max_decode_replicas=2))
    bad = SLOObservation(ttft_p99=2.0)
    sc.decide(0.0, bad, 2, None, None)
    d = sc.decide(31.0, bad, 2, None, None)
    assert d.target is None and "maxDecodeReplicas" in d.reason


def test_missing_observation_never_breaches_and_blocks_clear():
    sc = DecodeAutoscaler(_slo())
    dark = SLOObservation()                      # no data at all
    d = sc.decide(0.0, dark, 2, None, None)
    assert d.target is None and "insufficient" in d.reason
    # an hour of darkness still never scales in either direction
    d = sc.decide(3600.0, dark, 2, None, None)
    assert d.target is None


def test_partial_evidence_blocks_scale_down():
    sc = DecodeAutoscaler(_slo(tpot_p99_seconds=0.1))
    # ttft observed and clear, tpot configured but dark -> hold
    d = sc.decide(0.0, SLOObservation(ttft_p99=0.2), 3, None, None)
    assert d.target is None and "insufficient" in d.reason


def test_clear_must_persist_then_scales_down():
    sc = DecodeAutoscaler(_slo())
    good = SLOObservation(ttft_p99=0.2)
    d = sc.decide(0.0, good, 3, None, None)
    assert d.target is None and d.wake_after == pytest.approx(60.0)
    d = sc.decide(59.0, good, 3, None, None)
    assert d.target is None
    d = sc.decide(61.0, good, 3, None, None)
    assert d.target == 2


def test_scale_down_clamped_at_min():
    sc = DecodeAutoscaler(_slo())
    good = SLOObservation(ttft_p99=0.2)
    for t in (0.0, 61.0, 200.0):
        assert sc.decide(t, good, 1, None, None).target is None


def test_queue_depth_target_breaches():
    sc = DecodeAutoscaler(_slo(ttft_p99_seconds=None, queue_depth=4.0))
    deep = SLOObservation(queue_depth=9.0)
    sc.decide(0.0, deep, 2, None, None)
    d = sc.decide(30.0, deep, 2, None, None)
    assert d.target == 3 and "queue_depth" in d.reason


# ---------------------------------------------------------------------------
# spec.serving.slo validation
# ---------------------------------------------------------------------------

def _serving_spec(slo):
    return TPUJobSpec(tpus=8, serving=ServingSpec(
        prefill_replicas=1, decode_replicas=1, slo=slo))


def test_slo_validation():
    validate_spec(_serving_spec(ServingSLO(ttft_p99_seconds=0.5)))
    with pytest.raises(ValidationError, match="at least one target"):
        validate_spec(_serving_spec(ServingSLO()))
    with pytest.raises(ValidationError, match="must be > 0"):
        validate_spec(_serving_spec(ServingSLO(ttft_p99_seconds=-1.0)))
    with pytest.raises(ValidationError, match="maxDecodeReplicas"):
        validate_spec(_serving_spec(ServingSLO(
            ttft_p99_seconds=0.5, min_decode_replicas=4,
            max_decode_replicas=2)))
    with pytest.raises(ValidationError, match="inside the slo band"):
        validate_spec(_serving_spec(ServingSLO(
            ttft_p99_seconds=0.5, min_decode_replicas=2,
            max_decode_replicas=4)))
    with pytest.raises(ValidationError, match="breachSeconds"):
        validate_spec(_serving_spec(ServingSLO(
            ttft_p99_seconds=0.5, breach_seconds=-1.0)))


# ---------------------------------------------------------------------------
# controller integration: status-override scale-up
# ---------------------------------------------------------------------------

def test_autoscale_scale_up_lands_in_status_and_pools():
    from mpi_operator_tpu_torch.controller.chaos import _observed_harness

    qd = {"v": 0.0}

    def fetch(url):
        if url.endswith("/metrics"):
            return f"tpu_worker_queue_depth {qd['v']}\n"
        raise IOError("no events endpoint")

    h, obs, clock = _observed_harness(0, fetch)
    # the autoscaler's persistence windows read controller time; pin it
    # to the same fake clock the observatory scrapes on
    h.controller.now = lambda: clock["now"]
    name = "as-up"
    slo = ServingSLO(queue_depth=4.0, breach_seconds=30.0,
                     clear_seconds=600.0, cooldown_floor_seconds=0.0,
                     max_decode_replicas=4)
    h.create_job(name, tpus=8, serving=ServingSpec(
        prefill_replicas=1, decode_replicas=1, slo=slo))
    h.drive_until(lambda: len(h.worker_sets(name)) == 2,
                  f"{name}: prefill+decode pools")
    h.make_workers_ready(name)
    h.drive_until(lambda: h.launcher(name) is not None, f"{name}: launcher")
    h.set_launcher_active(name)
    h.drive_until(lambda: h.cond(name, "Running") == "True",
                  f"{name}: Running")
    sync = lambda: h.controller.sync_handler(f"{h.ns}/{name}")  # noqa: E731
    # healthy queue: no override appears no matter how long we watch
    for _ in range(4):
        clock["now"] += 15
        sync()
        h.resync()
    assert h.job(name).status.serving_decode_replicas is None
    # the queue blows past the target and STAYS there past breachSeconds
    qd["v"] = 9.0
    for _ in range(4):
        clock["now"] += 15
        sync()
        h.resync()
    job = h.job(name)
    assert job.status.serving_decode_replicas == 2
    assert job.status.serving_scaled_at is not None
    # the override flows into the decode pool via the ordinary resize
    # machinery: the user's spec is untouched, the StatefulSet grows
    assert job.spec.serving.decode_replicas == 1
    h.drive_until(lambda: any(
        s.metadata.name.endswith("-decode") and s.spec.replicas == 2
        for s in h.worker_sets(name)), f"{name}: decode pool resized")
