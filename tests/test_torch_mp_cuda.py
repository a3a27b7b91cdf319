"""Model-parallel LM training on the card: ring attention through K1-K3
and the LMTrainer over sp, as gangs of gloo ranks sharing the card
(tests/torch_mp_worker.py through launch.py and the bootstrap).

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_mp_cuda.py

Without a card every test here skips: K1-K3 have no CPU mode
(tests/test_torch_ring_attention.py holds the ring on the CPU through
the plain versions).

- The ring at sp = 2, B 4, S 2048, 16 heads, D 64, bf16, causal and
  not, against K1-K3 over the whole sequence: out within F3's K1 limit,
  dq, dk and dv within chip_smoke.py's RING_REL (each block's partials
  leave the kernels rounded to bf16); H28's plan: the rank at sp index
  i launches each kernel i + 1 times under the causal mask, sp times
  without it; the diagonal block run non-causal fails the limits.
- The trainer at (dp, sp, tp) = (1, 2, 2), gpt2-medium's width at 2
  layers, bf16: each rank's K1-K3 launches are H28's plan, and its
  losses those of one process's K1-K3 run.
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_mp_worker as worker  # noqa: E402

FLASH_REL_K1 = 4e-3          # chip_smoke.py's FLASH_REL["flash_fwd"]
RING_REL = {"out": FLASH_REL_K1, "dq": 1e-2, "dk": 1e-2, "dv": 1e-2}
LM_DDP_BF16_REL = 3e-2       # chip_smoke.py's


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1-K3 have no CPU mode (the CPU "
                    "ring is tests/test_torch_ring_attention.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _ring_errors(name, res, dev):
    from mpi_operator_tpu_torch.ops import attention as ops
    q, k, v, do = worker.ring_inputs(*worker.LEGS[name]["ring"]["shape"],
                                     torch.bfloat16, device=dev)
    out = {}
    for causal in (True, False):
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        o = ops.flash_attention(qs, ks, vs, causal=causal)
        o.backward(do)
        got = res[causal]
        out[causal] = {
            n: float((got[n].to(dev).float() - t.float()).norm()
                     / t.float().norm())
            for n, t in (("out", o), ("dq", qs.grad), ("dk", ks.grad),
                         ("dv", vs.grad))}
    return out


@pytest.mark.cuda
def test_ring_through_k1_k3_against_the_whole_sequence(cuda_device,
                                                       tmp_path):
    names = ["chip/ring-sp2", "chip/ring-sp2/ring-diagonal-noncausal"]
    got = worker.gang(2, str(tmp_path / "r"), names, device="cuda")
    assert got[0]["backend"] == "gloo"
    for causal, errs in _ring_errors(names[0], got[0][names[0]],
                                     cuda_device).items():
        for key, err in errs.items():
            assert err <= RING_REL[key], (causal, key, err)
    for r in got:
        for causal in (True, False):
            res = r[names[0]][causal]
            want = res["sp_index"] + 1 if causal else 2
            assert res["launches"] == {k: want for k in worker.FLASH}
    fault = _ring_errors(names[1], got[0][names[1]], cuda_device)[True]
    assert fault["out"] > RING_REL["out"] and fault["dq"] > RING_REL["dq"]


@pytest.mark.cuda
def test_ring_trainer_follows_the_launch_plan(cuda_device, tmp_path):
    name = "chip/sp2-tp2"
    got = worker.gang(4, str(tmp_path / "r"), [name], device="cuda")
    spec = dict(worker.LEGS[name])
    spec["cfg"] = {}
    want = worker.train_leg(spec, cuda_device)
    layers = worker.config_of(spec).num_layers
    for rank, r in enumerate(got):
        res = r[name]
        plan = layers * spec["steps"] * (rank // 2 + 1)
        assert res["launches"] == {k: plan for k in worker.FLASH}, rank
        for a, b in zip(res["losses"], want["losses"]):
            assert abs(a - b) / abs(b) <= LM_DDP_BF16_REL
