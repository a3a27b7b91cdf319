"""The port's bootstrap (mpi_operator_tpu_torch/bootstrap/) against the JAX
package's, on the CPU: `process_info` resolves every env case of
tests/test_bootstrap.py to the same ProcessInfo (or the same error);
the torch rendezvous classifies failures and backs off as the reference
does; the status channel and `launcher_wait`; `launch.py` with 2 slots;
and the image benchmark's CLI as two gloo workers plus a launcher, the
launcher mirroring rank 0's exit code.
"""
import dataclasses
import os
import pathlib
import socket
import subprocess
import sys
import threading
from datetime import timedelta

import pytest
import torch
import torch.distributed as dist

from mpi_operator_tpu.bootstrap import bootstrap as jbs
from mpi_operator_tpu_torch.bootstrap import bootstrap as tbs
from mpi_operator_tpu_torch.bootstrap.launch import launch
from mpi_operator_tpu_torch.telemetry import events as tev

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

ROOT = pathlib.Path(__file__).resolve().parent.parent
COORD = "job-worker-0.job-worker.default.svc:8476"

# (env, hostname): the env cases of tests/test_bootstrap.py
CASES = [
    ({"TPU_COORDINATOR_ADDRESS": COORD, "TPU_NUM_PROCESSES": "4"},
     "job-worker-2"),
    ({"TPU_COORDINATOR_ADDRESS": COORD, "TPU_NUM_PROCESSES": "4"},
     "job-worker-0"),
    ({"TPU_COORDINATOR_ADDRESS": COORD, "TPU_NUM_PROCESSES": "4",
      "TPU_WORKER_ID": "1"}, "anything"),
    ({"TPU_COORDINATOR_ADDRESS": COORD, "TPU_NUM_PROCESSES": "4",
      "TPU_LAUNCHER": "1"}, "job-launcher-xyz12"),
    ({}, "job-worker-0"),
    ({"TPU_COORDINATOR_ADDRESS": COORD, "TPU_NUM_PROCESSES": "4"},
     "job-worker-9"),
    ({"TPU_COORDINATOR_ADDRESS": COORD, "TPU_NUM_PROCESSES": "4",
      "TPU_SLOTS_PER_WORKER": "2", "TPU_LOCAL_RANK": "1"}, "job-worker-1"),
    ({"TPU_COORDINATOR_ADDRESS": COORD, "TPU_NUM_PROCESSES": "4",
      "TPU_SLOTS_PER_WORKER": "2", "TPU_LOCAL_RANK": "2"}, "job-worker-1"),
    ({"TPU_COORDINATOR_ADDRESS": "ms-worker-s0-0:8476",
      "TPU_NUM_PROCESSES": "4", "TPU_NUM_SLICES": "2", "TPU_SLICE_ID": "1",
      "TPU_WORKERS_PER_SLICE": "2"}, "ms-worker-s1-0"),
    ({"TPU_COORDINATOR_ADDRESS": "c:1", "TPU_NUM_PROCESSES": "8",
      "TPU_NUM_SLICES": "2", "TPU_SLICE_ID": "1"}, "j-worker-s1-3"),
    ({"TPU_COORDINATOR_ADDRESS": "c:1", "TPU_NUM_PROCESSES": "8",
      "TPU_NUM_SLICES": "2", "TPU_SLICE_ID": "1",
      "TPU_WORKERS_PER_SLICE": "2", "TPU_SLOTS_PER_WORKER": "2",
      "TPU_LOCAL_RANK": "1"}, "j-worker-s1-1"),
    ({"TPU_COORDINATOR_ADDRESS": "c:1", "TPU_NUM_PROCESSES": "4",
      "TPU_NUM_SLICES": "2", "TPU_SLICE_ID": "3"}, "j-worker-s3-0"),
    ({"TPU_COORDINATOR_ADDRESS": "c:1", "TPU_NUM_PROCESSES": "4",
      "TPU_NUM_SLICES": "2", "TPU_WORKERS_PER_SLICE": "2"},
     "job-worker-s1-0"),
    ({"TPU_COORDINATOR_ADDRESS": "c:1", "TPU_NUM_PROCESSES": "4",
      "TPU_NUM_SLICES": "2", "TPU_WORKERS_PER_SLICE": "2"}, "job-worker-0"),
    ({"TPU_COORDINATOR_ADDRESS": "c:1", "TPU_NUM_PROCESSES": "4",
      "TPU_NUM_SLICES": "2", "TPU_WORKERS_PER_SLICE": "2",
      "TPU_SLICE_ID": ""}, "job-worker-s1-1"),
]


def _resolve(mod, env, host):
    try:
        return dataclasses.asdict(mod.process_info(env=env, hostname=host))
    except mod.BootstrapError as exc:
        return ("BootstrapError", str(exc))


@pytest.mark.parametrize("env,host", CASES)
def test_process_info_equals_the_reference(env, host, tmp_path):
    env = {"TPU_CONFIG_PATH": str(tmp_path / "none"), **env}
    assert _resolve(tbs, env, host) == _resolve(jbs, env, host)


def test_config_dir_fallback_equals_the_reference(tmp_path):
    (tmp_path / "coordinator-address").write_text("cm-host:8476\n")
    (tmp_path / "num-processes").write_text("2\n")
    env = {"TPU_CONFIG_PATH": str(tmp_path)}
    got = _resolve(tbs, env, "job-worker-1")
    assert got == _resolve(jbs, env, "job-worker-1")
    assert got["num_processes"] == 2 and got["process_id"] == 1


def _info(n=2, rank=1):
    return tbs.ProcessInfo(coordinator_address="127.0.0.1:1",
                           num_processes=n, process_id=rank)


def test_retry_classification():
    """The reference's fatal markers and ValueError stay fatal; torch's
    DistNetworkError / DistStoreError and a refused connection retry."""
    retry = tbs._retryable_init_error
    assert retry(dist.DistNetworkError("client socket has timed out"))
    assert retry(dist.DistStoreError("timed out waiting for key"))
    assert retry(ConnectionRefusedError("connection refused"))
    assert retry(RuntimeError("failed to connect to coordinator"))
    assert not retry(ValueError("rank 3 is outside the gang of 2"))
    for msg in ("process id 3 does not match num_processes 2",
                "already initialized", "duplicate rank"):
        assert not retry(RuntimeError(msg)) and \
            not jbs._retryable_init_error(RuntimeError(msg))


def test_backoff_events_and_exhaustion():
    """TPU_INIT_RETRIES attempts, delays doubling from TPU_INIT_BACKOFF,
    an init_retry event a failed attempt; then BootstrapError. A fatal
    error raises at once."""
    class Events:
        records = []

        def emit(self, kind, **kw):
            self.records.append((kind, kw))
    calls, sleeps, ev = [], [], Events()

    def down():
        calls.append(1)
        raise dist.DistNetworkError("client socket has timed out")
    with pytest.raises(tbs.BootstrapError, match="after 3 attempt"):
        tbs._initialize_distributed(
            _info(), {"TPU_INIT_RETRIES": "3", "TPU_INIT_BACKOFF": "0.5"},
            log=lambda s: None, init_fn=down, sleep=sleeps.append,
            events=ev)
    assert len(calls) == 3 and sleeps == [0.5, 1.0]
    assert [k for k, _ in ev.records] == [tev.INIT_RETRY] * 2
    assert ev.records[0][1]["attempt"] == 1

    def fatal():
        raise ValueError("bad rank")
    with pytest.raises(ValueError):
        tbs._initialize_distributed(_info(), {}, log=lambda s: None,
                                    init_fn=fatal, sleep=sleeps.append)
    assert len(sleeps) == 2


def test_delay_coordinator_fault_then_success():
    """TPU_FAULT_INJECT=delay-coordinator:2 fails the first two attempts
    before the rendezvous runs; the third joins."""
    calls, sleeps = [], []
    tbs._initialize_distributed(
        _info(), {"TPU_FAULT_INJECT": "delay-coordinator:2"},
        log=lambda s: None, init_fn=lambda: calls.append(1),
        sleep=sleeps.append)
    assert calls == [1] and sleeps == [1.0, 2.0]


def test_a_rank_outside_the_gang_is_refused_before_connecting():
    with pytest.raises(ValueError, match="outside the gang"):
        tbs._join_group(_info(n=2, rank=3), {}, "gloo")


def test_a_late_coordinator_costs_a_short_attempt(monkeypatch):
    """No coordinator listening: one rendezvous attempt of a non-zero
    rank fails within its per-attempt timeout with a retryable torch
    error (not after the group's 30 minutes)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    info = tbs.ProcessInfo(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=1)
    monkeypatch.setattr(tbs, "ATTEMPT_TIMEOUT", timedelta(seconds=0.5))
    with pytest.raises(Exception) as err:
        tbs._join_group(info, {}, "gloo")
    assert tbs._retryable_init_error(err.value)
    assert not dist.is_initialized()


def test_status_channel_and_launcher_wait():
    """rank-0 StatusServer <-poll- launcher: running -> done <code>; a
    wrong token is denied."""
    server = tbs.StatusServer(port=0, token="tok")
    try:
        assert tbs.poll_status("localhost", server.port,
                               token="tok") == "running"
        assert tbs.poll_status("localhost", server.port,
                               token="bad") == "denied"
        info = tbs.ProcessInfo(coordinator_address="localhost:8476",
                               num_processes=2, process_id=0,
                               is_launcher=True)
        result = {}
        t = threading.Thread(target=lambda: result.update(
            code=tbs.launcher_wait(info, port=server.port,
                                   poll_interval=0.05, token="tok")))
        t.start()
        server.set_done(3, linger=5.0)
        t.join(timeout=5)
        assert result["code"] == 3
    finally:
        server.close()
    with pytest.raises(tbs.BootstrapError, match="unreachable"):
        tbs.launcher_wait(info, port=1, poll_interval=0.05,
                          startup_timeout=0.3)


def test_launch_forks_two_slots_and_propagates_failure(tmp_path):
    out = tmp_path / "ranks"
    out.mkdir()
    code = launch([sys.executable, "-c",
                   "import os, pathlib; pathlib.Path("
                   f"'{out}', os.environ['TPU_LOCAL_RANK']).write_text('x')"],
                  slots=2)
    assert code == 0
    assert sorted(p.name for p in out.iterdir()) == ["0", "1"]
    code = launch([sys.executable, "-c",
                   "import os, sys; sys.exit(5 if "
                   "os.environ['TPU_LOCAL_RANK']=='1' else 0)"], slots=2)
    assert code == 5


def test_initialize_refuses_slices_and_a_missing_card(monkeypatch):
    """More than one slice joins (the slices go on the mesh's dcn dim),
    but a mesh of 2 slices needs at least 2 ranks: one process's
    hybrid_mesh refuses them; without a card and without device="cpu"
    initialize refuses."""
    env = {"TPU_COORDINATOR_ADDRESS": "c:1", "TPU_NUM_PROCESSES": "1"}
    info = tbs.initialize({**env, "TPU_NUM_SLICES": "2", "TPU_SLICE_ID": "0"},
                          hostname="j-worker-s0-0", device="cpu")
    assert info.num_slices == 2 and not dist.is_initialized()
    with pytest.raises(ValueError, match="2 slices"):
        tbs.hybrid_mesh(info)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(tbs.BootstrapError, match="device='cpu'"):
        tbs.initialize(env, hostname="j-worker-0")
    info = tbs.initialize(env, hostname="j-worker-0", device="cpu")
    assert info.process_id == 0 and not dist.is_initialized()


def test_hybrid_mesh_lays_the_job_topology():
    """hybrid_mesh from the env contract: pure data parallelism by
    default (a process alone is a mesh of one), named axes checked
    against the job's device count as the reference checks them."""
    info = tbs.process_info({"TPU_COORDINATOR_ADDRESS": "c:1",
                             "TPU_NUM_PROCESSES": "1"}, "j-worker-0")
    mesh = tbs.hybrid_mesh(info)
    assert mesh.size == 1 and mesh.shape["dcn"] == 1
    assert mesh.device_mesh is None and not dist.is_initialized()
    assert tbs.hybrid_mesh(info, dp=1).size == 1
    with pytest.raises(tbs.BootstrapError, match="the job sees 1"):
        tbs.hybrid_mesh(info, dp=2)


@pytest.mark.parametrize("cpu,slots,cards,want", [
    (True, 1, 0, "gloo"), (True, 2, 8, "gloo"), (False, 1, 1, "nccl"),
    (False, 2, 1, "gloo"), (False, 2, 2, "nccl"), (False, 4, 8, "nccl")])
def test_backend_is_gloo_where_ranks_share_a_card(cpu, slots, cards, want,
                                                  monkeypatch):
    """NCCL on the card; gloo on the CPU and where a worker's slots
    outnumber its cards (NCCL refuses two ranks on one card)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    info = tbs.ProcessInfo("c:1", num_processes=slots, process_id=0,
                           slots_per_worker=slots)
    assert tbs.dist_backend(info, cpu) == want


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_gang_of_two_workers_and_a_launcher(tmp_path):
    """`python -m mpi_operator_tpu_torch.examples.benchmark --device cpu`
    as two gloo workers and the launcher, on the env contract: every
    process exits 0 and rank 0 logs the reference's lines. Then a gang
    whose rank 0 dies (an unknown model) makes the launcher mirror its
    non-zero exit code."""
    def gang(*extra):
        # one thread a process: the suite runs beside other test
        # processes
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   TPU_COORDINATOR_ADDRESS=f"127.0.0.1:"
                   f"{_free_port()}", TPU_NUM_PROCESSES="2",
                   TPU_STATUS_PORT=str(_free_port()),
                   PYTHONPATH=os.pathsep.join([str(ROOT)] + [
                       p for p in os.environ.get("PYTHONPATH", "").split(
                           os.pathsep) if p]))
        for k in ("TPU_WORKER_ID", "TPU_LOCAL_RANK", "TPU_LAUNCHER",
                  "TPU_FAULT_INJECT"):
            env.pop(k, None)
        cmd = [sys.executable, "-m", "mpi_operator_tpu_torch.examples."
               "benchmark", "--device", "cpu", "--model", "resnet18",
               "--image-size", "32", "--batch-per-device", "2",
               "--num-steps", "2", "--warmup-steps", "1", *extra]
        procs = [subprocess.Popen(cmd, cwd=ROOT, env={**env, **role},
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for role in ({"TPU_WORKER_ID": "0"}, {"TPU_WORKER_ID": "1"},
                              {"TPU_LAUNCHER": "1"})]
        try:
            return [(p.wait(timeout=240), p.stdout.read()) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
    (r0, out0), (r1, out1), (rl, outl) = gang()
    assert (r0, r1, rl) == (0, 0, 0), (out0[-2000:], out1[-2000:])
    assert "Devices:     ['cpu:0', 'cpu:1']" in out0
    assert "total images/sec:" in out0 and "total images/sec:" not in out1
    assert "launcher: waiting on rank-0 status channel" in outl
    (r0, _), (r1, _), (rl, outl) = gang("--model", "resnet0")
    assert r0 != 0 and rl == r0, outl[-2000:]
