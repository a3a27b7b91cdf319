"""Data-parallel image training on the CPU: two gloo processes, started by
the port's `launch.py` (TPU_SLOTS_PER_WORKER=2) and joined through its
bootstrap, against one process at the global batch (the counterpart of
tests/test_data_plane.py::test_trainer_dp_matches_single_device, which
pins a DP-8 step equal to one device at rtol 2e-4 / atol 2e-5).

After one SGD step of a bottleneck ResNet (s2d stem, one block a stage)
and of a 2-layer ViT, both at 32 px on a global batch of 16, params,
momentum and BN running statistics equal the single process's at the
JAX test's tolerances. H12: the reference's batch mean is global (the
batch is sharded over a mesh), so the port's BN all-reduces its
statistics and its backward sums; the planted fault (per-rank BN, the
all-reduce taken out; what plain DDP over torch BN gives) must fail the
same comparison.
"""
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import torch

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))

import torch_ddp_worker as worker  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gang(tmp_path, *extra):
    """Two ranks through launch.py; rank 0's results."""
    out = tmp_path / "rank0.pt"
    # one thread a rank: the suite runs beside other test processes
    env = dict(os.environ, TPU_SLOTS_PER_WORKER="2", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    for k in ("TPU_WORKER_ID", "TPU_LOCAL_RANK", "TPU_FAULT_INJECT"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "mpi_operator_tpu_torch.bootstrap.launch",
           "--", sys.executable, str(ROOT / "tests" / "torch_ddp_worker.py"),
           "2", str(_free_port()), str(out), "--device", "cpu", *extra]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    saved = torch.load(out)
    assert saved["backend"] == "gloo"
    return saved["results"]


def _close(got, want):
    return all(np.allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)
               for a, b in zip(got[1:], want[1:]))


def test_two_gloo_processes_equal_one_at_the_global_batch(tmp_path):
    """ResNet and ViT: one step on 2 ranks x 8 rows = one step on 16."""
    want = worker.train(0, 1, torch.device("cpu"), steps=1)
    got = _gang(tmp_path)
    assert set(got) == {"resnet", "vit"}
    for name in got:
        for label, a, b in zip(("start", "params", "momentum",
                                "batch_stats"), got[name], want[name]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{name} {label}")
    assert got["resnet"][3].numel() > 0 and got["vit"][3].numel() == 0


def test_per_rank_batch_norm_fails_the_comparison(tmp_path):
    """H12's planted fault: with the BN all-reduce taken out each rank
    normalises over its own 8 rows, and the ResNet's step no longer
    equals the single process's (params and statistics)."""
    want = worker.train(0, 1, torch.device("cpu"), steps=1,
                        only=["resnet"])["resnet"]
    got = _gang(tmp_path, "--fault", "per-rank-bn", "--only",
                "resnet")["resnet"]
    assert not _close(got, want)
    assert not np.allclose(got[3].numpy(), want[3].numpy(), rtol=RTOL,
                           atol=ATOL)
