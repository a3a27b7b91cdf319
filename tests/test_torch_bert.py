"""The port's BERT masked LM (`MaskedLM`, `bert_config`, the MLM objective
in the trainer and the data) against the JAX package, on the CPU in f32.

Same weights on both sides (the flax params, biases, norm scales and
`mlm_bias` moved off their init, through `params_from_flax`) and the
same numpy tokens. Attention dense and flash (the reference's Pallas
kernels in interpret mode; the port's plain K1-K3 behind its autograd
Function), non-causal, with token types and a key-padding mask holding
a padded row, a short row and a row with no valid key (the mean of v
from either flash, zero gradient through it; the dense paths agree with
each other). Tolerances as in test_torch_lm_trainer.py (f32, summation
order only): logits atol 1e-4, losses 1e-5, gradients 2e-5, parameters
after AdamW steps 5e-6. The MLM batches, integer and mask data, are
compared bit for bit.
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (assert_params_match, jax_trainer, perturbed_params,
                          port_trainer, to_port)

jt = importlib.import_module("mpi_operator_tpu.models.transformer")
jtr = importlib.import_module("mpi_operator_tpu.train.lm_trainer")
jts = importlib.import_module("mpi_operator_tpu.data.tokenstream")
jbench = importlib.import_module("mpi_operator_tpu.examples.lm_benchmark")
tt = importlib.import_module("mpi_operator_tpu_torch.models.transformer")
ttr = importlib.import_module("mpi_operator_tpu_torch.train.lm_trainer")
tdata = importlib.import_module("mpi_operator_tpu_torch.data")
port_ops = importlib.import_module("mpi_operator_tpu_torch.ops.attention")
bench = importlib.import_module("mpi_operator_tpu_torch.examples.lm_benchmark")

V, L, B, S = 96, 64, 4, 32
LOGIT_ATOL, LOSS_ATOL, GRAD_ATOL, PARAM_ATOL = 1e-4, 1e-5, 2e-5, 5e-6


def _configs(attention="dense"):
    jcfg = jt.bert_config("test", attention=attention, dtype=jnp.float32,
                          vocab_size=V, max_len=L)
    tcfg = tt.bert_config("test", attention=attention, dtype=torch.float32,
                          vocab_size=V, max_len=L)
    return jcfg, tcfg


def _mlm_batch(seed):
    """(corrupted tokens, original tokens, f32 mask of scored slots)."""
    rs = np.random.RandomState(seed)
    toks = rs.randint(0, V - 1, (B, S)).astype(np.int32)
    mask = rs.random_sample((B, S)) < 0.15
    mask[:, 0] = True
    return (np.where(mask, V - 1, toks).astype(np.int32), toks,
            mask.astype(np.float32))


def _padding():
    """[B, S] key mask: row 0 padded after 3/4, row 1 after 5 tokens,
    row 2 whole, row 3 with no valid key."""
    m = np.ones((B, S), bool)
    m[0, (3 * S) // 4:] = False
    m[1, 5:] = False
    m[3] = False
    return m


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_masked_lm_logits_and_grads_match_flax(attention):
    """MaskedLM(tokens, token_types, attention_mask) logits, the MLM loss
    over the masked slots and its gradients against flax MaskedLM."""
    jcfg, tcfg = _configs(attention)
    jm = jt.MaskedLM(jcfg)
    tree = perturbed_params(jm)
    toks, tgts, mlm = _mlm_batch(0)
    types = (np.arange(S)[None] >= S // 2).repeat(B, 0).astype(np.int32)
    pad = _padding()

    def jloss(params):
        logits = jm.apply({"params": params}, jnp.asarray(toks),
                          token_types=jnp.asarray(types),
                          attention_mask=jnp.asarray(pad))
        return jtr.lm_loss(logits, jnp.asarray(tgts), jnp.asarray(mlm)), \
            logits
    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))

    model = tt.MaskedLM(tcfg)
    model.load_state_dict(to_port(tcfg, tree))
    logits = model(torch.from_numpy(toks).long(),
                   torch.from_numpy(types).long(), torch.from_numpy(pad))
    loss = ttr.lm_loss(logits, torch.from_numpy(tgts),
                       torch.from_numpy(mlm))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(loss.item(), float(jl), atol=LOSS_ATOL)
    want = to_port(tcfg, jgrads)
    assert {"wtte.weight", "ln_emb.weight", "mlm_dense.weight",
            "mlm_ln.bias", "mlm_bias"} <= set(want)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_bert_is_bidirectional():
    """tests/test_models.py:46's counterpart: an early logit sees a late
    token."""
    _, tcfg = _configs()
    model = tt.create_lm("bert-test", device="cpu", dtype=torch.float32,
                         attention="dense", vocab_size=64, max_len=32)
    assert isinstance(model, tt.MaskedLM) and not tcfg.causal
    t1 = torch.randint(0, 64, (1, 16), generator=torch.Generator()
                       .manual_seed(0))
    t2 = t1.clone()
    t2[0, -1] = (t1[0, -1] + 1) % 64
    assert not torch.allclose(model(t1)[0, 0], model(t2)[0, 0], atol=1e-6)


def test_bert_attention_mask_gives_finite_logits():
    """tests/test_models.py:60's counterpart: the key mask on zero tokens,
    shape and finiteness."""
    model = tt.create_lm("bert-test", device="cpu", dtype=torch.float32,
                         attention="dense", vocab_size=64, max_len=32)
    toks = torch.zeros((2, 8), dtype=torch.int64)
    mask = torch.ones((2, 8), dtype=torch.bool)
    mask[:, 4:] = False
    out = model(toks, attention_mask=mask)
    assert out.shape == (2, 8, 64) and bool(torch.isfinite(out).all())


def test_bert_keeps_flash_with_a_mask(monkeypatch):
    """tests/test_ops.py:126's counterpart: attention="flash" with a key
    mask runs the flash autograd Function with that mask and never the
    dense path."""
    _, tcfg = _configs("flash")
    model = tt.MaskedLM(tcfg)
    monkeypatch.setattr(tt, "dense_attention", lambda *a, **k: (_ for _ in (
        )).throw(AssertionError("fell back to dense")))
    masks = []
    orig = port_ops.FlashAttention.forward

    def spy(ctx, q, k, v, mask, causal):
        masks.append((mask, causal))
        return orig(ctx, q, k, v, mask, causal)
    monkeypatch.setattr(port_ops.FlashAttention, "forward",
                        staticmethod(spy))
    pad = torch.from_numpy(_padding())
    out = model(torch.zeros((B, S), dtype=torch.int64), attention_mask=pad)
    assert out.shape == (B, S, V) and len(masks) == tcfg.num_layers
    assert all(m is pad and c is False for m, c in masks)


def test_three_adamw_steps_match_lm_trainer():
    """Three MLM steps of the port's trainer against LMTrainer(MaskedLM,
    masked_lm=True) on a one-device mesh: losses and accuracies over the
    masked slots per step, and every parameter after step 3."""
    jcfg, tcfg = _configs()
    tree = perturbed_params(jt.MaskedLM(jcfg))
    jtrainer, jstate = jax_trainer(jt.MaskedLM(jcfg), tree, B, S,
                                   masked_lm=True)
    trainer, state = port_trainer(tcfg, tree, B, S, masked_lm=True)
    assert isinstance(state.model, tt.MaskedLM)
    for step in range(3):
        batch = _mlm_batch(10 + step)
        jstate, jm = jtrainer.train_step(jstate, *map(jnp.asarray, batch))
        state, m = trainer.train_step(state, *batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=LOSS_ATOL)
        np.testing.assert_allclose(float(m["accuracy"]),
                                   float(jm["accuracy"]), atol=1e-6)
    assert_params_match(tcfg, state, jstate, PARAM_ATOL)
    assert trainer._step_flops(state) == jtrainer._step_flops(jstate, None)


def test_masked_accumulation_equals_one_step():
    """tests/test_lm_trainer.py:254's counterpart: microbatches with
    unequal mask counts, each normalised by the full batch's count, give
    the one-step loss and update (two AdamW steps: warmup 2)."""
    _, tcfg = _configs()
    tree = perturbed_params(jt.MaskedLM(_configs()[0]))
    toks = np.random.RandomState(3).randint(0, V, (B, S)).astype(np.int32)
    mask = np.zeros((B, S), np.float32)
    mask[:B // 2, ::3] = 1.0
    mask[B // 2:, ::8] = 1.0
    results = []
    for accum in (1, 2):
        trainer, state = port_trainer(tcfg, tree, B, S, masked_lm=True,
                                      accum_steps=accum)
        for _ in range(2):
            state, m = trainer.train_step(state, toks, toks, mask)
        results.append((float(m["loss"]), state.params.clone()))
    np.testing.assert_allclose(results[1][0], results[0][0], atol=LOSS_ATOL)
    np.testing.assert_allclose(results[1][1].numpy(), results[0][1].numpy(),
                               atol=PARAM_ATOL, rtol=0)


def test_fused_xent_with_bert_raises():
    _, tcfg = _configs()
    with pytest.raises(ValueError, match="causal LM only"):
        ttr.LMTrainer(tcfg, ttr.LMTrainerConfig(fused_xent=True,
                                                masked_lm=True),
                      device="cpu")
    with pytest.raises(ValueError, match="causal LM only"):
        bench.run_lm_benchmark("bert", "test", batch_per_device=2,
                               seq_len=16, num_steps=1, fused_xent=True,
                               device="cpu", log=lambda s: None)


def test_mlm_shard_batches_equal_the_reference_bit_for_bit(tmp_path):
    """--data-dir with bert: the port's NpyTokenDataset with
    mlm_host_transform yields the batches the reference's NpyTokenDataset
    yields with its MLM host_transform (lm_benchmark.py:455-468,
    RandomState(3)), over three shards and past an epoch."""
    rs = np.random.RandomState(0)
    for i in range(3):
        tdata.write_token_shard(str(tmp_path), f"s{i}",
                                rs.randint(0, V, 5 * (S + 1) + 3))
    mlm_rng = np.random.RandomState(3)

    def ref_transform(win):
        toks = win[:, :-1]
        mask = mlm_rng.random_sample(toks.shape) < jbench.MLM_MASK_RATE
        return (np.where(mask, V - 1, toks).astype(np.int32), toks,
                mask.astype(np.float32))
    want_ds = jts.NpyTokenDataset(str(tmp_path), 2, S, vocab_size=V,
                                  host_transform=ref_transform)
    got_ds = tdata.NpyTokenDataset(str(tmp_path), 2, S, device="cpu",
                                   vocab_size=V,
                                   host_transform=tdata.mlm_host_transform(V))
    try:
        for _ in range(8):
            want, got = next(want_ds), next(got_ds)
            assert len(got) == len(want) == 3
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert got[2].dtype == torch.float32 and got[2].any()
    finally:
        want_ds.close()
        got_ds.close()
    assert tdata.MLM_MASK_RATE == jbench.MLM_MASK_RATE


def test_mlm_token_stream_is_step_keyed():
    """The MLM branch of the synthetic stream: batch i depends only on
    (seed, i); inputs are the mask id where masked and the targets
    elsewhere; targets are the uncorrupted tokens; about MLM_MASK_RATE
    of the slots are scored."""
    full = tdata.TokenStream(4, 64, 50, seed=1, device="cpu", masked_lm=True)
    batches = [next(full) for _ in range(4)]
    resumed = tdata.TokenStream(4, 64, 50, seed=1, start=2, device="cpu",
                                masked_lm=True)
    for want in batches[2:]:
        assert all(torch.equal(a, b) for a, b in zip(next(resumed), want))
    toks, tgts, mask = batches[0]
    plain = tdata.TokenStream(4, 64, 50, seed=1, device="cpu").batch(0)
    assert torch.equal(tgts, plain[0])         # the same token draw
    m = mask.bool()
    assert mask.dtype == torch.float32
    assert bool((toks[m] == 49).all()) and torch.equal(toks[~m], tgts[~m])
    assert 0.05 < float(mask.mean()) < 0.3


def test_run_lm_benchmark_trains_bert():
    """workload="bert" through the entry point: the MaskedLM on the MLM
    stream, every loss finite, non-causal attention FLOPs (not halved)."""
    state, m = bench.run_lm_benchmark(
        "bert", "test", batch_per_device=2, seq_len=16, num_steps=2,
        warmup_steps=1, dtype_name="float32", device="cpu",
        log=lambda s: None)
    assert isinstance(state.model, tt.MaskedLM)
    assert all(math.isfinite(x) for x in m["step_losses"])
    cfg = state.model.config
    n = state.params.numel()
    assert m["flops_per_step"] == (6.0 * n + 12.0 * cfg.num_layers
                                   * cfg.embed_dim * 16) * 2 * 16
