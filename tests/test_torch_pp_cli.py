"""The LM CLI's pipeline flags on the CPU (--pp, --pp-schedule,
--pp-interleave): the reference's refusals, a --pp 2 run as a gang of
two processes joined through the bootstrap, and the preemption drill
(TPU_FAULT_INJECT) resumed under the other schedule."""
import json
import os
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_mp_worker as worker  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*args, world=1, timeout=300, env=None):
    """The LM CLI at the test size on the CPU: one process, or `world`
    processes under the controller's env contract (TPU_WORKER_ID a
    process, the coordinator at 127.0.0.1) joining through the
    bootstrap. Returns each process's CompletedProcess-like (rc, out,
    err)."""
    extra, env = env or {}, dict(os.environ, OMP_NUM_THREADS="1",
                                 PYTHONPATH=ROOT)
    for k in ("TPU_WORKER_ID", "TPU_LOCAL_RANK", "TPU_FAULT_INJECT",
              "TPU_NUM_SLICES", "TPU_SLICE_ID", "TPU_NUM_PROCESSES",
              "TPU_COORDINATOR_ADDRESS", "TPU_LAUNCHER", "TPU_STATUS_PORT",
              "TPU_SLOTS_PER_WORKER"):
        env.pop(k, None)
    env.update(extra)
    cmd = [sys.executable, "-m",
           "mpi_operator_tpu_torch.examples.lm_benchmark", "--size", "test",
           "--seq-len", "16", "--dtype", "float32", "--num-steps", "2",
           "--warmup-steps", "1", "--device", "cpu", *args]
    if world == 1:
        p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=timeout)
        return [(p.returncode, p.stdout, p.stderr)]
    ports = {worker.free_port()}
    while len(ports) < 2:
        ports.add(worker.free_port())
    coordinator, status = sorted(ports)
    env.update(TPU_NUM_PROCESSES=str(world),
               TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{coordinator}",
               TPU_STATUS_PORT=str(status))
    procs = [subprocess.Popen(cmd, cwd=ROOT,
                              env={**env, "TPU_WORKER_ID": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    outs = [p.communicate(timeout=timeout) for p in procs]
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


@pytest.mark.parametrize("args,message", [
    (("--pp", "2", "--accum-steps", "2"), "redundant with --pp"),
    (("--pp", "2", "--moe-experts", "4", "--pp-schedule", "1f1b",
      "--num-layers", "4"), "gpipe only"),
    (("--pp", "2", "--tp", "2", "--tp-overlap"), "flat trainer only"),
    (("--pp", "3",), "not divisible by pp=3"),
])
def test_cli_refusals(args, message):
    """The reference's refusals, each before any training (in this
    process: one process without a gang)."""
    from mpi_operator_tpu_torch.examples import lm_benchmark as bench
    with pytest.raises(ValueError, match=re.escape(message)):
        bench.main(["--size", "test", "--seq-len", "16", "--dtype",
                    "float32", "--device", "cpu", *args])


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """The preemption drill: TPU_FAULT_INJECT=sigterm-at-step:3 drains a
    GPipe gang of two at step 3; the gang restarted under 1F1B x 2 (4
    layers, 2 x 4 rows) resumes from the emergency checkpoint and runs to
    the global step --stop-at-step names. Returns (the first gang's runs,
    the second's, the train dir)."""
    train_dir = tmp_path_factory.mktemp("drill")
    common = ("--pp", "2", "--num-layers", "4", "--batch-per-device", "4",
              "--train-dir", str(train_dir), "--stop-check-every", "1")
    first = _cli(*common, "--num-steps", "5", world=2,
                 env={"TPU_FAULT_INJECT": "sigterm-at-step:3"})
    second = _cli(*common, "--pp-schedule", "1f1b", "--pp-interleave", "2",
                  "--stop-at-step", "6", world=2)
    return first, second, train_dir


def test_cli_pp2_as_a_gang(drill):
    """--pp 2 as a gang of two processes joined through the bootstrap
    (the drill's second gang: 1F1B x 2 at 4 layers, 2 x 4 rows): rank 0's
    pipeline line and headline, every process exiting 0."""
    runs = drill[1]
    assert [rc for rc, _, _ in runs] == [0, 0], [e[-2000:] for *_, e in runs]
    out = runs[0][1]
    assert "pp=2 M=8 schedule=1f1b×2" in out, out[-2000:]
    head = json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])
    assert head["metric"] == "gpt2_tokens_per_sec" and head["value"] > 0
    assert not runs[1][1].strip()                   # rank 0 prints


def test_cli_preemption_drill_resumes_under_the_other_schedule(drill):
    """TPU_FAULT_INJECT=sigterm-at-step:3 drains a GPipe gang of two at
    step 3 (exit 215, the emergency checkpoint committed); the gang
    restarted under 1F1B x 2 resumes from it and ends at the global step
    --stop-at-step names."""
    first, second, train_dir = drill
    assert [rc for rc, _, _ in first] == [215, 215], \
        [e[-2000:] for *_, e in first]
    assert "stopping the gang at step 3" in first[0][1]
    assert os.path.isdir(train_dir / "step_3")
    assert [rc for rc, _, _ in second] == [0, 0], \
        [e[-2000:] for *_, e in second]
    assert "resumed from" in second[0][1] and "(step 3)" in second[0][1]
    assert os.path.isdir(train_dir / "step_6")
