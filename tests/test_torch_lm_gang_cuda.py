"""Data-parallel LM training on the card: gangs of the port's LMTrainer
(tests/torch_lm_gang_worker.py, through launch.py and the bootstrap)
against one process on the same card.

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_lm_gang_cuda.py

Without a card every test here skips: the gangs' K1-K3 have no CPU mode
(tests/test_torch_lm_gang.py holds the same gangs on the CPU).

- A gang of one over NCCL (the all-reduce of one rank, the division by
  one) trains gpt2-medium's width at 2 layers in bf16 through K1-K3 to
  the single process's parameters bit for bit.
- Two gloo ranks on the one card: bert-large's width (MLM over padded
  rows) and gpt2-small's with 8 experts (accum_steps 2), f32, against
  one process within chip_smoke.py's LM_DDP_REL; the planted faults
  (per-rank mask count, per-rank routing, rows cut after the split)
  exceed it.
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_lm_gang_worker as worker  # noqa: E402

LM_DDP_REL = 1e-3            # chip_smoke.py's


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1-K3 have no CPU mode (the CPU "
                    "gangs are tests/test_torch_lm_gang.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_gang_of_one_over_nccl_equals_one_process(cuda_device, tmp_path):
    got, _ = worker.gang(1, str(tmp_path / "r"), "--size", "chip-bf16",
                         "--only", "gpt2", device="cuda")
    want = worker.run(0, 1, cuda_device, 3, "chip-bf16", only=["gpt2"])
    assert got[0]["backend"] == "nccl"
    for key in ("params", "mu", "nu"):
        assert torch.equal(got[0]["gpt2"][key], want["gpt2"][key]), key
    assert got[0]["gpt2"]["losses"] == want["gpt2"]["losses"]


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card_and_the_planted_faults(cuda_device,
                                                           tmp_path):
    got, _ = worker.gang(2, str(tmp_path / "r"), "--size", "chip",
                         "--only", "bert,moe", "--faults", device="cuda")
    want = worker.run(0, 1, cuda_device, 3, "chip", only=["bert", "moe"])
    assert got[0]["backend"] == "gloo"
    for name in ("bert", "moe"):
        for rank in got:
            err = worker.compare(rank[name], want[name])
            assert max(err["update"], err["mu"], err["nu"]) < LM_DDP_REL, err
    for name, fault in worker.FAULTS:
        err = worker.compare(got[0][f"{name}/{fault}"], want[name])
        assert err["update"] > LM_DDP_REL, (fault, err)
