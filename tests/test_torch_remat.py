"""Remat in the port's training forward (`TransformerConfig.remat`,
`remat_policy`): the recomputed forward changes no value, on the CPU in
f32 — the loss and every gradient bit for bit against remat off, for
gpt2-test (dense and flash attention), the MoE LM (aux loss included)
and BERT; the "dots" policy saves exactly the 2-D GEMMs; under remat the
flash forward runs twice a layer a step and its backward once; an
unknown policy raises, as the reference's does.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

jt = importlib.import_module("mpi_operator_tpu.models.transformer")
tt = importlib.import_module("mpi_operator_tpu_torch.models.transformer")
ttr = importlib.import_module("mpi_operator_tpu_torch.train.lm_trainer")
port_ops = importlib.import_module("mpi_operator_tpu_torch.ops.attention")

V, L, B, S = 96, 64, 4, 32


def _config(model, attention="dense", **kw):
    base = dict(attention=attention, dtype=torch.float32, vocab_size=V,
                max_len=L, **kw)
    if model == "bert":
        return tt.bert_config("test", **base)
    if model == "moe":
        return tt.gpt2_config("test", num_experts=4, moe_top_k=2, **base)
    return tt.gpt2_config("test", **base)


def _batch(model):
    rs = np.random.RandomState(7)
    toks = torch.from_numpy(rs.randint(0, V, (B, S + 1)))
    if model == "bert":
        mask = torch.from_numpy((rs.random_sample((B, S)) < 0.3)
                                .astype(np.float32))
        return toks[:, :-1], toks[:, 1:], mask
    return toks[:, :-1], toks[:, 1:], None


def _loss_and_grads(cfg, batch):
    trainer = ttr.LMTrainer(cfg, ttr.LMTrainerConfig(
        global_batch_size=B, seq_len=S, masked_lm=not cfg.causal),
        device="cpu")
    state = trainer.init_state(0)
    loss, grads, _ = trainer.loss_and_grads(state, *batch)
    return loss, grads


@pytest.mark.parametrize("model,attention", [
    ("gpt2", "dense"), ("gpt2", "flash"), ("moe", "dense"),
    ("bert", "flash")])
@pytest.mark.parametrize("policy", ["none", "dots"])
def test_remat_grads_equal_no_remat_bit_for_bit(model, attention, policy,
                                                monkeypatch):
    """The same seed-0 weights and batch with remat off and on: equal
    loss (MoE aux term included) and equal flat gradients, bit for bit.
    With flash attention the forward (plain K1 on the CPU) runs once a
    layer without remat and twice with it; dq and dk/dv once a layer."""
    calls = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    for name in calls:
        def counted(*a, _f=getattr(port_ops, name), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(port_ops, name, counted)
    batch = _batch(model)
    base = _config(model, attention)
    want_loss, want = _loss_and_grads(base, batch)
    plain = dict(calls)
    got_loss, got = _loss_and_grads(
        _config(model, attention, remat=True, remat_policy=policy), batch)
    assert torch.equal(got_loss, want_loss)
    assert torch.equal(got, want)
    assert bool(got.abs().sum() > 0)
    layers = base.num_layers
    if attention == "flash":
        assert plain == {n: layers for n in calls}
        assert calls["flash_fwd"] == 3 * layers      # + 2 x layers remat
        assert calls["flash_dq"] == calls["flash_dkv"] == 2 * layers


def test_dots_policy_saves_the_gemms_and_nothing_batched(monkeypatch):
    """A census of the "dots" policy's decisions over one forward and
    backward of the MoE LM: what it saves are the projections' `mm`
    outputs (the head, the router and every Linear fold [B, S, E] @ W^T
    into one 2-D mm); every batched product (`bmm`: dense attention,
    the experts) and every allocation is recomputed."""
    seen = []
    policy = tt._dots_policy

    def census(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            seen.append((op, decision))
        return decision
    monkeypatch.setattr(tt, "_dots_policy", census)
    cfg = _config("moe", remat=True, remat_policy="dots")
    _loss_and_grads(cfg, _batch("moe"))
    saved = {op for op, d in seen if d == CheckpointPolicy.MUST_SAVE}
    recomputed = {op for op, d in seen
                  if d == CheckpointPolicy.PREFER_RECOMPUTE}
    assert saved == {torch.ops.aten.mm.default}
    assert torch.ops.aten.bmm.default in recomputed
    n_mm = sum(op == torch.ops.aten.mm.default for op, _ in seen)
    # per block: q, k, v, out and two FFN (or router) GEMMs
    assert n_mm >= 5 * cfg.num_layers
    assert not any("empty" in str(op) or "zeros" in str(op)
                   for op in saved)


def test_unknown_remat_policy_raises_like_the_reference():
    with pytest.raises(ValueError, match="remat_policy='some'"):
        tt.CausalLM(_config("gpt2", remat=True, remat_policy="some"))
    jcfg = jt.gpt2_config("test", remat=True, remat_policy="some",
                          dtype=jnp.float32, vocab_size=V, max_len=L)
    with pytest.raises(ValueError, match="remat_policy='some'"):
        jax.eval_shape(jt.CausalLM(jcfg).init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 4), jnp.int32))
    # without remat the policy is never read, on both sides
    tt.CausalLM(_config("gpt2", remat_policy="some"))
