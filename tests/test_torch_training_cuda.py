"""Remat, BERT and MoE training on the card, through K1-K3.

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_training_cuda.py

Without a card every test here skips: K1-K3 have no CPU mode (the CPU
tests test_torch_remat.py, test_torch_bert.py and test_torch_moe.py
hold the same paths through the kernels' plain versions).

- Remat recomputes the forward with the same kernels on the same
  inputs, and K1-K3 use no atomics, so the parameters after a few steps
  with remat "none" and "dots" equal those without remat bit for bit;
  K1 launches 2 x layers a step under remat, K2 and K3 layers a step.
- BERT's gradients through flash (non-causal, a [B, S] key mask with
  two padded rows) against the dense path, both bf16: the
  same cosine bound as chip_smoke.py's gradient check, 0.999 per
  parameter tensor.
- A MoE step is finite and its drop rate a fraction.
"""
import math

import numpy as np
import pytest
import torch

from mpi_operator_tpu_torch.models.transformer import (MaskedLM,
                                                       bert_config,
                                                       gpt2_config,
                                                       param_shapes)
from mpi_operator_tpu_torch.ops import attention as ops
from mpi_operator_tpu_torch.train.lm_trainer import (LMTrainer,
                                                     LMTrainerConfig,
                                                     lm_loss)

V, S, B = 512, 256, 4
GRAD_COSINE = 0.999
FLASH = ("flash_fwd", "flash_dq", "flash_dkv")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1-K3 have no CPU mode (the CPU "
                    "tests hold their plain versions)")
    return torch.device("cuda")


def _batches(dev, n, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = torch.from_numpy(rs.randint(0, V, (B, S + 1))).to(dev)
        out.append((t[:, :-1], t[:, 1:]))
    return out


def _train(cfg, dev, batches):
    trainer = LMTrainer(cfg, LMTrainerConfig(global_batch_size=B,
                                             seq_len=S, warmup_steps=1),
                        device=dev)
    state = trainer.init_state(0)
    ops.reset_launch_counts()
    for batch in batches:
        state, m = trainer.train_step(state, *batch)
    torch.cuda.synchronize()
    return state, dict(ops.launch_counts)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["none", "dots"])
def test_remat_params_equal_no_remat_bit_for_bit(cuda_device, policy):
    """gpt2 width 128 (H=2, D=64), 3 layers with MoE on block 1, bf16
    over f32 masters, 3 steps: params, mu and nu equal with remat and
    without; launch counts as stated."""
    cfg = gpt2_config("test", vocab_size=V, max_len=S, num_layers=3,
                      num_heads=2, attention="flash", num_experts=4)
    batches = _batches(cuda_device, 3)
    want, base = _train(cfg, cuda_device, batches)
    got, counts = _train(gpt2_config(
        "test", vocab_size=V, max_len=S, num_layers=3, num_heads=2,
        attention="flash", num_experts=4, remat=True,
        remat_policy=policy), cuda_device, batches)
    assert torch.equal(got.params, want.params)
    assert torch.equal(got.opt.mu, want.opt.mu)
    assert torch.equal(got.opt.nu, want.opt.nu)
    layers, steps = cfg.num_layers, len(batches)
    assert all(base[k] == layers * steps for k in FLASH)
    assert counts["flash_fwd"] == 2 * layers * steps
    assert counts["flash_dq"] == counts["flash_dkv"] == layers * steps


@pytest.mark.cuda
def test_bert_flash_grads_agree_with_dense_on_a_padded_batch(cuda_device):
    """bert width 256 (H=4, D=64), 2 layers, bf16: the MLM loss's
    gradients through flash and through the dense path, from the same
    weights and a batch whose key mask pads two rows (after 3/4 and
    after 1/4 of the sequence). A row with no valid key is left out:
    there the two paths differ by design (the dense softmax passes a
    gradient through its uniform row, flash none)."""
    grads, losses = {}, {}
    rs = np.random.RandomState(1)
    toks = torch.from_numpy(rs.randint(0, V, (B, S))).to(cuda_device)
    mlm = torch.from_numpy((rs.random_sample((B, S)) < 0.15)
                           .astype(np.float32)).to(cuda_device)
    pad = torch.ones((B, S), dtype=torch.bool, device=cuda_device)
    pad[0, (3 * S) // 4:] = False
    pad[1, S // 4:] = False
    for impl in ("dense", "flash"):
        cfg = bert_config("test", vocab_size=V, max_len=S, embed_dim=256,
                          mlp_dim=1024, attention=impl)
        trainer = LMTrainer(cfg, LMTrainerConfig(global_batch_size=B,
                                                 seq_len=S, masked_lm=True),
                            device=cuda_device)
        state = trainer.init_state(0)
        model = state.model
        assert isinstance(model, MaskedLM)
        ops.reset_launch_counts()
        logits = model(toks, attention_mask=pad)
        loss = lm_loss(logits, toks, mlm)
        loss.backward()
        torch.cuda.synchronize()
        if impl == "flash":
            assert all(ops.launch_counts[k] == cfg.num_layers for k in FLASH)
        grads[impl] = {n: p.grad.detach().float().reshape(-1)
                       for n, p in model.named_parameters()}
        losses[impl] = float(loss)
    assert math.isfinite(losses["flash"])
    assert abs(losses["flash"] - losses["dense"]) < 1e-2
    for name in param_shapes(cfg):
        a, b = grads["flash"][name], grads["dense"][name]
        if name.endswith("attn.key.bias"):
            continue            # exact gradient 0: rounding noise only
        cos = float(torch.dot(a, b) / (a.norm() * b.norm()).clamp(min=1e-30))
        assert cos >= GRAD_COSINE, (name, cos)


@pytest.mark.cuda
def test_moe_step_is_finite(cuda_device):
    cfg = gpt2_config("test", vocab_size=V, max_len=S, num_heads=2,
                      attention="flash", num_experts=4)
    state, counts = _train(cfg, cuda_device, _batches(cuda_device, 2))
    assert torch.isfinite(state.params).all()
    assert counts["flash_fwd"] == cfg.num_layers * 2
    rate = float(state.model.moe_drop_rates()[0])
    assert 0.0 <= rate < 1.0
