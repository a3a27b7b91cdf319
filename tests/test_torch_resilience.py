"""The port's preemption runtime (train/resilience.py), its benchmark
loop and CLI (examples/lm_benchmark.py) against the JAX package's, on
the CPU at gpt2-test size in f32.

Parity with the reference on the same inputs: the exit codes and the
retryable predicate, the fault-spec parser (its unknown-directive error
too), `suggest_stop_check_every`, `drain_latency_from_events` over one
events file, `ResilienceConfig.from_env`, and the event log of the
in-process drill (SIGTERM at step 4, resume to step 8): kinds and steps
equal the JAX drill's, in order. The resumed run ends bit-equal to the
uninterrupted one (params, both moments, the update count): the
synthetic stream is step-keyed and a checkpoint is a copy.

The CLI legs of the controller's resilience smoke run as subprocesses
with `--device cpu` (215 with step_5, resume 0 with step_8,
`die-at-step:11` 217 with no step_11, resume 0 with step_12), and the
port's collector CLI, playing the controller between them, merges the
port's event log into steps lost 3 and goodput 0.8 — the proof that
the port's worker speaks the controller's event contract — and the JAX
package's collector merges the same logs into the same timeline and the
same federated text. Two
gloo processes show that one rank's stop request stops both at the same
step.
"""
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mpi_operator_tpu.examples import lm_benchmark as jbench
from mpi_operator_tpu.telemetry import collector as jcollector
from mpi_operator_tpu_torch.telemetry import collector as tcollector
from mpi_operator_tpu.telemetry import events as jevents
from mpi_operator_tpu.train import resilience as jres
from mpi_operator_tpu_torch.examples import lm_benchmark as tbench
from mpi_operator_tpu_torch.telemetry import EventLog, TrainTelemetry
from mpi_operator_tpu_torch.telemetry import read_events
from mpi_operator_tpu_torch.train import checkpoint as ck
from mpi_operator_tpu_torch.train import resilience as tres
from mpi_operator_tpu_torch.train.lm_trainer import AdamWState, LMTrainState

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _fresh_saved_state(monkeypatch):
    monkeypatch.delenv(tres.ENV_FAULT_INJECT, raising=False)
    yield
    ck.reset_saved_state()


def _ckpt_state(step: int, value: float, n: int = 4) -> LMTrainState:
    opt = AdamWState(torch.tensor(step, dtype=torch.int32),
                     torch.full((n,), value / 2), torch.full((n,), value / 4))
    return LMTrainState(params=torch.full((n,), value), opt=opt, model=None,
                        step=step,
                        nonfinite_streak=torch.zeros((), dtype=torch.int32))


# ---------------------------------------------------------------------------
# parity of the framework-free pieces
# ---------------------------------------------------------------------------

def test_exit_codes_match_the_reference():
    for name in ("PREEMPTED_EXIT", "WATCHDOG_STALL_EXIT", "FAULT_DIE_EXIT",
                 "ENV_FAULT_INJECT", "ENV_STEP_DEADLINE",
                 "ENV_STOP_CHECK_EVERY", "ENV_DRAIN_TARGET",
                 "DRAIN_TARGET_SECONDS"):
        assert getattr(tres, name) == getattr(jres, name), name
    for code in [None, *range(0, 256)]:
        assert tres.is_retryable_exit(code) == jres.is_retryable_exit(code)
    p = tres.Preempted(41)
    assert p.step == 41 and p.exit_code == tres.PREEMPTED_EXIT == 215
    assert str(p) == str(jres.Preempted(41))


@pytest.mark.parametrize("spec", [
    "", "die-at-step:7; sigterm-at-step:3,corrupt-latest-checkpoint;"
    "delay-coordinator:2", "sigterm-at-step:5", "die-at-step:11",
    "nan-replica:3@9", " corrupt-latest-checkpoint ,, "])
def test_fault_spec_parsing_matches_the_reference(spec):
    t, j = tres.FaultInjector(spec), jres.FaultInjector(spec)
    for attr in ("die_at_step", "sigterm_at_step", "corrupt_latest",
                 "delay_coordinator", "nan_replica", "nan_replica_step"):
        assert getattr(t, attr) == getattr(j, attr), attr
    budget = [t.fail_init_attempt() for _ in range(4)]
    assert budget == [j.fail_init_attempt() for _ in range(4)]
    assert t.check_nan_replica(100) == j.check_nan_replica(100)
    assert t.check_nan_replica(100) is None


def test_unknown_fault_directive_raises_like_the_reference():
    spec = "die-at-step:7;tpyo-directive:1"
    with pytest.raises(ValueError) as te:
        tres.FaultInjector(spec)
    with pytest.raises(ValueError) as je:
        jres.FaultInjector(spec)
    assert str(te.value) == str(je.value)
    assert tres.FaultInjector.from_env({}) is None
    got = tres.FaultInjector.from_env({"TPU_FAULT_INJECT": "die-at-step:9"})
    assert got is not None and got.die_at_step == 9


@pytest.mark.parametrize("drain,cadence,target", [
    (10.0, 8, 5.0), (1.0, 8, 5.0), (0.3, 1, 5.0), (100.0, 256, 5.0),
    (0.0, 8, 5.0), (2.0, 0, 5.0), (2.0, 8, 0.0), (7.3, 13, None)])
def test_suggest_stop_check_every_matches_the_reference(drain, cadence,
                                                        target):
    assert (tres.suggest_stop_check_every(drain, cadence, target)
            == jres.suggest_stop_check_every(drain, cadence, target))


def test_drain_latency_and_auto_cadence_from_one_events_file(tmp_path):
    """One events file (two drains, one unpaired), read by both
    implementations; then the auto cadence both derive from it."""
    clock = iter([100.0, 101.0, 102.5, 200.0, 200.2, 300.0, 301.0])
    log = EventLog(str(tmp_path / "events.jsonl"), clock=lambda: next(clock))
    log.emit("preemption_drain", step=5, stop_check_every=8)
    log.emit("checkpoint_saved", step=5)
    log.emit("emergency_checkpoint", step=5)
    log.emit("preemption_drain", step=9, stop_check_every=4)
    log.emit("emergency_checkpoint", step=9)
    log.emit("preemption_drain", step=12, stop_check_every=2)
    log.close()
    path = str(tmp_path / "events.jsonl")
    got = tres.drain_latency_from_events(path)
    assert got == jres.drain_latency_from_events(path)
    assert got[1] == 8 and abs(got[0] - 2.5) < 1e-9
    assert tres.drain_latency_from_events(str(tmp_path / "none.jsonl")) \
        == jres.drain_latency_from_events(str(tmp_path / "none.jsonl"))
    quiet = lambda s: None  # noqa: E731
    assert (tres.auto_stop_check_every(str(tmp_path), log=quiet)
            == jres.auto_stop_check_every(str(tmp_path), log=quiet) == 16)
    env = {"TPU_STOP_CHECK_EVERY": "auto", "TPU_STEP_DEADLINE": "2.5"}
    tc = tres.ResilienceConfig.from_env(env, train_dir=str(tmp_path),
                                        divergence_k=None)
    jc = jres.ResilienceConfig.from_env(env, train_dir=str(tmp_path),
                                        divergence_k=None)
    assert vars(tc) == vars(jc)
    assert tc.stop_check_every == 16 and tc.step_deadline == 2.5


# ---------------------------------------------------------------------------
# listener, watchdog
# ---------------------------------------------------------------------------

def _wait_for(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def test_preemption_listener_flags_and_chains():
    chained = []
    prev = lambda signum, frame: chained.append(signum)  # noqa: E731
    old = signal.signal(signal.SIGUSR1, prev)
    try:
        listener = tres.PreemptionListener(log=lambda s: None).install()
        try:
            assert not listener.requested
            os.kill(os.getpid(), signal.SIGUSR1)
            assert _wait_for(lambda: listener.requested)
            assert chained == [signal.SIGUSR1]     # prev handler chained
        finally:
            listener.uninstall()
        assert signal.getsignal(signal.SIGUSR1) is prev   # restored
    finally:
        signal.signal(signal.SIGUSR1, old)


@pytest.mark.parametrize("petted", [False, True])
def test_watchdog_fires_on_stall_and_stays_quiet_while_petted(petted):
    fired = []
    dog = tres.Watchdog(deadline=0.3, log=lambda s: None,
                        abort=fired.append, poll=0.05).start()
    try:
        if petted:
            for _ in range(12):                # 0.6 s of healthy steps
                dog.pet()
                time.sleep(0.05)
        else:
            assert _wait_for(lambda: fired)
    finally:
        dog.stop()
    assert fired == ([] if petted else [tres.WATCHDOG_STALL_EXIT])


# ---------------------------------------------------------------------------
# ResilienceContext: the drill, emergency save, rollback budget
# ---------------------------------------------------------------------------

def test_context_sigterm_fault_drains_deterministically(tmp_path):
    events = EventLog(str(tmp_path / "events.jsonl"))
    cfg = tres.ResilienceConfig(train_dir=str(tmp_path))
    with tres.ResilienceContext(
            cfg, log=lambda s: None, events=events,
            faults=tres.FaultInjector("sigterm-at-step:3")) as ctx:
        assert not ctx.on_step(1) and not ctx.on_step(2)
        assert ctx.on_step(3)       # injected preemption, deterministic
        ctx.emergency_save(_ckpt_state(3, 3.0))
    events.close()
    assert ck.latest_checkpoint(str(tmp_path)).endswith("step_3")
    kinds = [(e["event"], e.get("step"))
             for e in read_events(str(tmp_path / "events.jsonl"))]
    # the drain record is durable BEFORE the save, the checkpoint record
    # after the commit, the fault record before the kill
    assert kinds == [("fault_injected", 3), ("preemption_drain", 3),
                     ("emergency_checkpoint", 3)]


def test_context_rollback_restores_in_place_and_budgets(tmp_path):
    ck.save_checkpoint(tmp_path, _ckpt_state(2, 2.0), step=2)
    logs = []
    tel = TrainTelemetry()
    tel.observe_steps(0.1, 10)
    ctx = tres.ResilienceContext(
        tres.ResilienceConfig(train_dir=str(tmp_path), max_rollbacks=2),
        log=logs.append, telemetry=tel)
    diverged = _ckpt_state(5, 999.0)
    diverged.nonfinite_streak.fill_(3)
    flat = diverged.params
    rolled = ctx.rollback(diverged)
    assert rolled is diverged and rolled.params is flat    # copied in
    assert rolled.step == 2 and int(rolled.nonfinite_streak) == 0
    assert torch.equal(rolled.params, torch.full((4,), 2.0))
    assert int(rolled.opt.count) == 2
    assert any("divergence rollback #1" in line for line in logs)
    assert tel.rollback_steps_total.value == 3 and tel.goodput.value == 0.7
    ctx.rollback(_ckpt_state(5, 999.0))         # budget: second is fine
    with pytest.raises(tres.DivergenceError, match="giving up"):
        ctx.rollback(_ckpt_state(5, 999.0))     # third exceeds the budget


def test_context_rollback_without_checkpoints_raises(tmp_path):
    ctx = tres.ResilienceContext(
        tres.ResilienceConfig(train_dir=str(tmp_path)), log=lambda s: None)
    with pytest.raises(tres.DivergenceError,
                       match="no restorable checkpoint"):
        ctx.rollback(_ckpt_state(5, 1.0))
    ctx2 = tres.ResilienceContext(tres.ResilienceConfig(train_dir=None),
                                  log=lambda s: None)
    with pytest.raises(tres.DivergenceError, match="no --train-dir"):
        ctx2.rollback(_ckpt_state(5, 1.0))


def test_context_enter_fires_corrupt_fault(tmp_path):
    ck.save_checkpoint(tmp_path, _ckpt_state(1, 1.0), step=1)
    ck.save_checkpoint(tmp_path, _ckpt_state(2, 2.0), step=2)
    logs = []
    with tres.ResilienceContext(
            tres.ResilienceConfig(train_dir=str(tmp_path)), log=logs.append,
            faults=tres.FaultInjector("corrupt-latest-checkpoint")):
        # __enter__ scribbled step_2 BEFORE any resume would run
        assert any("fault-inject: corrupted" in line for line in logs)
        _, path = ck.restore_with_fallback(str(tmp_path),
                                           _ckpt_state(0, 0.0), logs.append)
        assert path.endswith("step_1")


def test_benchmark_rolls_back_a_diverged_run(tmp_path):
    """The loop's rollback path: poisoned (NaN) parameters make every
    step non-finite; the window fetch sees the streak, rolls back to the
    checkpoint in place, re-bases the step, and training goes on clean."""
    from mpi_operator_tpu_torch.data import TokenStream
    from mpi_operator_tpu_torch.models.transformer import gpt2_config
    from mpi_operator_tpu_torch.train import LMTrainer, LMTrainerConfig

    cfg = gpt2_config("test", attention="dense", dtype=torch.float32,
                      vocab_size=64, max_len=32)
    tr = LMTrainer(cfg, LMTrainerConfig(global_batch_size=2, seq_len=16,
                                        warmup_steps=1, log_every=2),
                   device="cpu")
    state = tr.init_state(0)
    stream = TokenStream(2, 16, 64, device="cpu")
    state, _ = tr.train_step(state, *next(stream))
    ck.save_checkpoint(tmp_path, state)               # step 1, intact
    good = state.params.clone()
    state.params.fill_(float("nan"))
    logs = []
    ctx = tres.ResilienceContext(
        tres.ResilienceConfig(train_dir=str(tmp_path), divergence_k=1),
        log=logs.append)
    state, m = tr.benchmark(state, stream, num_steps=4, warmup_steps=1,
                            log=logs.append, resilience=ctx)
    assert any("divergence rollback #1" in line for line in logs)
    assert not any("rollback #2" in line for line in logs)
    # warmup (step 2) + 2 steps skipped; rolled back to 1; 2 clean steps
    assert state.step == 3 and int(state.opt.count) == 3
    assert np.isfinite(m["final_loss"]) and m["goodput"] < 1.0
    assert torch.isfinite(state.params).all()
    assert not torch.equal(state.params, good)


# ---------------------------------------------------------------------------
# the in-process drill, against the JAX drill
# ---------------------------------------------------------------------------

def _tiny(mod, train_dir, log, **kw):
    extra = {"device": "cpu"} if mod is tbench else {}
    return mod.run_lm_benchmark(
        workload="gpt2", size="test", batch_per_device=1, seq_len=16,
        dtype_name="float32", warmup_steps=1, train_dir=train_dir,
        log=log, num_steps=7, **extra, **kw)


def _drill(mod, root, monkeypatch):
    """SIGTERM at step 4 and a resume to step 8 in one train dir; returns
    (final state, its events as (kind, step) in file order)."""
    monkeypatch.setenv("TPU_FAULT_INJECT", "sigterm-at-step:4")
    exc_type = tres.Preempted if mod is tbench else jres.Preempted
    logs = []
    with pytest.raises(exc_type) as exc:
        _tiny(mod, str(root / "b"), logs.append)
    assert exc.value.step == 4 and exc.value.exit_code == 215
    assert any("preemption drain" in line for line in logs)
    monkeypatch.delenv("TPU_FAULT_INJECT")
    ck.reset_saved_state()
    logs = []
    state_b, _ = _tiny(mod, str(root / "b"), logs.append, stop_at_step=8)
    assert any("resumed from" in line and "step_4" in line for line in logs)

    return state_b, [(e["event"], e.get("step")) for e in
                     jevents.read_events(str(root / "b" / "events.jsonl"))]


def test_sigterm_resume_bit_equal_with_the_reference_event_log(
        tmp_path, monkeypatch):
    """The port's drill ends bit-equal to its uninterrupted run (a) and
    logs the JAX drill's events. The JAX drill's own uninterrupted run is
    not needed: tests/test_resilience.py holds its bit-equality."""
    a, _ = _tiny(tbench, str(tmp_path / "a"), lambda s: None)
    assert [e["event"] for e in read_events(
        str(tmp_path / "a" / "events.jsonl"))] == ["run_complete"]
    b, ev_b = _drill(tbench, tmp_path / "port", monkeypatch)
    assert a.step == b.step == 8
    assert torch.equal(a.params, b.params)
    assert torch.equal(a.opt.mu, b.opt.mu)
    assert torch.equal(a.opt.nu, b.opt.nu)
    assert int(a.opt.count) == int(b.opt.count) == 8
    jb, jev_b = _drill(jbench, tmp_path / "jax", monkeypatch)
    assert int(jb.step) == 8
    assert ev_b == jev_b
    assert [k for k, _ in ev_b] == [
        "fault_injected", "preemption_drain", "emergency_checkpoint",
        "checkpoint_restore", "first_resume_step", "run_complete"]


# ---------------------------------------------------------------------------
# the CLI legs, with the port's collector playing the controller
# ---------------------------------------------------------------------------

def _cli(train_dir, *extra, fault=None, timeout=120):
    env = dict(os.environ)
    env.pop("TPU_FAULT_INJECT", None)
    if fault:
        env["TPU_FAULT_INJECT"] = fault
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    cmd = [sys.executable, "-m", "mpi_operator_tpu_torch.examples.lm_benchmark",
           "--workload", "gpt2", "--size", "test", "--batch-per-device", "1",
           "--seq-len", "16", "--dtype", "float32", "--warmup-steps", "1",
           "--num-steps", "20", "--train-dir", str(train_dir),
           "--device", "cpu", *extra]
    return subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_cli_legs_speak_the_controllers_event_contract(tmp_path):
    ckpt, ctl = tmp_path / "ckpt", str(tmp_path / "controller.jsonl")

    def emit(*args):
        assert tcollector.main(["emit", "--log", ctl, "--job", "smoke",
                                *args]) == 0

    emit("job_created", "tpus=8")
    out = _cli(ckpt, fault="sigterm-at-step:5")
    assert out.returncode == 215, out.stdout[-2000:] + out.stderr[-2000:]
    assert (ckpt / "step_5").is_dir()
    emit("gang_restart", "exit_code=215", "restart=1")
    out = _cli(ckpt, "--stop-at-step", "8")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "resumed from" in out.stdout and "step_5" in out.stdout
    headline = json.loads(out.stdout.strip().splitlines()[-1])
    assert headline["metric"] == "gpt2_tokens_per_sec"
    assert np.isfinite(headline["final_loss"])
    assert (ckpt / "step_8").is_dir()
    out = _cli(ckpt, fault="die-at-step:11")
    assert out.returncode == 217, out.stderr[-2000:]
    assert not (ckpt / "step_11").exists()
    emit("gang_restart", "exit_code=217", "restart=2")
    out = _cli(ckpt, "--stop-at-step", "12")
    assert out.returncode == 0, out.stderr[-2000:]
    assert (ckpt / "step_12").is_dir()
    emit("job_succeeded")

    kinds = [e["event"] for e in read_events(str(ckpt / "events.jsonl"))]
    for kind in ("preemption_drain", "emergency_checkpoint",
                 "fault_injected", "checkpoint_restore", "run_complete"):
        assert kind in kinds, kinds
    merged = {}
    for side, collector in (("torch", tcollector), ("jax", jcollector)):
        prom = tmp_path / f"federated-{side}.prom"
        timeline = tmp_path / f"timeline-{side}.jsonl"
        assert collector.main([
            "merge", "--job", "smoke", "--controller", ctl,
            "--worker", f"worker-0={ckpt / 'events.jsonl'}",
            "--out", str(timeline), "--metrics-out", str(prom)]) == 0
        merged[side] = (timeline.read_text(), prom.read_text())
    text = merged["torch"][1]
    assert 'tpu_job_steps_lost_total{job="smoke"} 3\n' in text, text
    assert 'tpu_job_goodput{job="smoke"} 0.8\n' in text, text
    assert merged["torch"] == merged["jax"]


def test_cli_exits_1_on_divergence_and_refuses_more_processes(
        tmp_path, monkeypatch, capsys):
    """A learning rate of 1e30 makes the second update overflow the
    parameters; with no checkpoint to roll back to the CLI exits 1 (a
    workload bug, not retryable). A controller asking for two processes
    sends the LM workload through the bootstrap (the trainer is
    data-parallel), which refuses a process started without the
    controller's env contract."""
    rc = tbench.main(["--size", "test", "--batch-per-device", "2",
                      "--seq-len", "16", "--dtype", "float32",
                      "--warmup-steps", "1", "--num-steps", "4",
                      "--lr", "1e30", "--lr-warmup-steps", "1",
                      "--device", "cpu"])
    assert rc == 1
    assert "diverged" in capsys.readouterr().err
    monkeypatch.setenv("TPU_NUM_PROCESSES", "2")
    monkeypatch.delenv("TPU_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setenv("TPU_CONFIG_PATH", str(tmp_path / "no-configmap"))
    with pytest.raises(RuntimeError, match="TPU_COORDINATOR_ADDRESS"):
        tbench.main(["--size", "test", "--device", "cpu"])


# ---------------------------------------------------------------------------
# the gang stop bit over two gloo processes
# ---------------------------------------------------------------------------

_GANG_WORKER = """
import sys
import torch.distributed as dist
from mpi_operator_tpu_torch.train.resilience import (
    ResilienceConfig, ResilienceContext, gang_should_stop)

rank, port = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=2)


class Flag:                       # a listener whose signal we script
    requested = False

    def install(self):
        return self

    def uninstall(self):
        pass


flag = Flag()
any_rank = gang_should_stop(rank == 1)
ctx = ResilienceContext(ResilienceConfig(stop_check_every=4),
                        log=lambda s: None, listener=flag)
stopped = None
with ctx:
    for step in range(1, 13):
        if rank == 0 and step == 3:
            flag.requested = True
        if ctx.on_step(step):
            stopped = step
            break
print("RESULT", any_rank, stopped, flush=True)
dist.destroy_process_group()
"""


def test_gang_should_stop_over_two_gloo_processes():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.pop("TPU_FAULT_INJECT", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    procs = [subprocess.Popen([sys.executable, "-c", _GANG_WORKER, str(r),
                               str(port)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            results.append(out.split("RESULT")[-1].split())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    # rank 1's flag reaches rank 0; rank 0's request (after step 3)
    # stops BOTH ranks at the next cadence boundary, step 4
    assert results == [["True", "4"], ["True", "4"]]
    # one process: the local flag, no collective
    assert tres.gang_should_stop(True) and not tres.gang_should_stop(False)
