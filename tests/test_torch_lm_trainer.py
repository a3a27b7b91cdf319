"""The port's training path (training forward, tied head, losses, the
hand-written AdamW, the guard, accumulation, the trainer and the
benchmark entry point) against the JAX reference, on the CPU in f32.

Same weights on both sides: the flax params, every bias and norm scale
moved off its init, go through `params_from_flax`; gradients come back
through the same conversion (it only reshapes and transposes). Same
numpy tokens on both sides. gpt2-test (learned positions, LayerNorm,
gelu, MHA) and llama-test (RoPE, RMSNorm, SwiGLU, GQA through the K/V
repeat), with attention dense and flash (the reference's Pallas kernels
in interpret mode; the port's plain K1-K3 behind its autograd Function).

Tolerances (f32, summation order only): logits atol 1e-4 (|logit| ~ 1,
as in test_torch_transformer.py), losses atol 1e-5, gradients atol 2e-5
on entries up to ~1; parameters after AdamW steps atol 5e-6 (a step
moves an entry by at most ~lr = 2.5e-4, so this is a 2% bound on the
update: Adam divides by sqrt(nu) + 1e-8, so an entry whose true gradient
is ~0 — the key bias only shifts a row's scores uniformly — turns f32
rounding noise into update differences of ~1e-6); optax's schedule and
update step by step atol 1e-7 relative to values ~1.
"""
import importlib
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import meta

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

jt = importlib.import_module("mpi_operator_tpu.models.transformer")
jtr = importlib.import_module("mpi_operator_tpu.train.lm_trainer")
jpar = importlib.import_module("mpi_operator_tpu.parallel")
tt = importlib.import_module("mpi_operator_tpu_torch.models.transformer")
convert = importlib.import_module("mpi_operator_tpu_torch.models.convert")
ttr = importlib.import_module("mpi_operator_tpu_torch.train.lm_trainer")
bench = importlib.import_module("mpi_operator_tpu_torch.examples.lm_benchmark")
port_ops = importlib.import_module("mpi_operator_tpu_torch.ops.attention")

V, L, B, S = 96, 64, 4, 32
LOGIT_ATOL, LOSS_ATOL, GRAD_ATOL, PARAM_ATOL = 1e-4, 1e-5, 2e-5, 5e-6


def _configs(family, attention="dense"):
    jcfg = (jt.gpt2_config if family == "gpt2" else jt.llama_config)(
        "test", attention=attention, dtype=jnp.float32, vocab_size=V,
        max_len=L)
    tcfg = (tt.gpt2_config if family == "gpt2" else tt.llama_config)(
        "test", attention=attention, dtype=torch.float32, vocab_size=V,
        max_len=L)
    return jcfg, tcfg


def _perturbed_params(jm, seed=0):
    """flax params as nested numpy dicts, biases and norm scales moved
    off their zeros/ones init."""
    params = meta.unbox(jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                         jnp.zeros((1, 4), jnp.int32)))
    rs = np.random.RandomState(seed + 1)

    def walk(node):
        out = {}
        for k, val in node.items():
            if isinstance(val, dict):
                out[k] = walk(val)
            else:
                a = np.array(val, np.float32)
                if k in ("bias", "scale"):
                    a = a + 0.1 * rs.randn(*a.shape).astype(np.float32)
                out[k] = a
        return out
    return walk(jax.tree.map(np.asarray, params["params"]))


def _batch(seed=0, b=B):
    toks = np.random.RandomState(seed).randint(0, V, (b, S + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _to_port(tcfg, tree):
    return {k: v for k, v in convert.params_from_flax(
        tcfg, jax.tree.map(np.asarray, tree)).items()}


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_training_forward_and_grads_match_flax(family, attention):
    """Logits of the training forward, lm_loss and d(loss)/d(params)
    against flax apply and jax.value_and_grad."""
    jcfg, tcfg = _configs(family, attention)
    jm = jt.CausalLM(jcfg)
    tree = _perturbed_params(jm)
    toks, tgts = _batch(1)

    def jloss(params):
        logits = jm.apply({"params": params}, jnp.asarray(toks))
        return jtr.lm_loss(logits, jnp.asarray(tgts)), logits
    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))

    sd = _to_port(tcfg, tree)
    model = tt.CausalLM(tcfg)
    model.load_state_dict(sd)
    logits = model(torch.from_numpy(toks).long())
    loss = ttr.lm_loss(logits, torch.from_numpy(tgts))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(loss.item(), float(jl), atol=LOSS_ATOL)
    want = _to_port(tcfg, jgrads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_training_forward_runs_the_flash_autograd_function():
    """attention="flash" goes through FlashAttention (the plain K1-K3 on
    the CPU); "auto" on the CPU is the dense path; no cache is made."""
    _, tcfg = _configs("llama", "flash")
    model = tt.CausalLM(tcfg)
    toks = torch.from_numpy(_batch(2)[0]).long()
    calls = []
    orig = port_ops.FlashAttention.forward

    def spy(*args):
        calls.append(args[0].shape)
        return orig(*args)
    port_ops.FlashAttention.forward = staticmethod(spy)
    try:
        out = model(toks)
        assert out.grad_fn is not None and len(calls) == tcfg.num_layers
        assert calls[0] == (B, S, tcfg.num_heads, tcfg.head_dim)  # repeated
        _, auto = _configs("llama", "auto")
        calls.clear()
        tt.CausalLM(auto)(toks)
        assert not calls
    finally:
        port_ops.FlashAttention.forward = staticmethod(orig)


def test_tied_head_backward_rounds_like_the_reference():
    """bf16 operands: TiedHead's gradients equal `_head_matmul_bwd`'s
    rounding (the f32 cotangent rounded to bf16 before both products,
    f32 accumulation, dh and dtable returned in bf16)."""
    rs = np.random.RandomState(0)
    h = rs.randn(2, 8, 32).astype(np.float32)
    table = rs.randn(V, 32).astype(np.float32)
    g = rs.randn(2, 8, V).astype(np.float32)
    jh, jtab = (jnp.asarray(x, jnp.bfloat16) for x in (h, table))
    _, vjp = jax.vjp(jt._head_matmul, jh, jtab)
    jdh, jdt = vjp(jnp.asarray(g))
    th, ttab = (torch.from_numpy(x).bfloat16().requires_grad_()
                for x in (h, table))
    out = tt.TiedHead.apply(th, ttab)
    assert out.dtype == torch.float32
    out.backward(torch.from_numpy(g))
    assert th.grad.dtype == ttab.grad.dtype == torch.bfloat16
    # one bf16 ulp of the rounded products at |x| up to ~30
    np.testing.assert_allclose(th.grad.float().numpy(),
                               np.asarray(jdh, np.float32), rtol=8e-3,
                               atol=1e-2)
    np.testing.assert_allclose(ttab.grad.float().numpy(),
                               np.asarray(jdt, np.float32), rtol=8e-3,
                               atol=1e-2)


_JAX_TRAINERS = {}


def _jax_trainer(jcfg, tree):
    """LMTrainer on a one-device mesh (one per config, so its compiled
    step is shared by the tests) and a fresh state holding `tree`."""
    tr = _JAX_TRAINERS.get(jcfg)
    if tr is None:
        mesh = jpar.make_mesh(jpar.MeshConfig(dp=1),
                              devices=jax.devices()[:1])
        tcfg = jtr.LMTrainerConfig(global_batch_size=B, seq_len=S,
                                   warmup_steps=2)
        tr = _JAX_TRAINERS[jcfg] = jtr.LMTrainer(jt.CausalLM(jcfg), mesh,
                                                 tcfg)
    state = tr.init_state(jax.random.PRNGKey(0))
    params = jax.tree.map(lambda ref, x: jax.device_put(jnp.asarray(x),
                                                        ref.sharding),
                          state.params, tree)
    return tr, state.replace(params=params)


def _port_trainer(tcfg, tree, **kw):
    tr = ttr.LMTrainer(tcfg, ttr.LMTrainerConfig(
        global_batch_size=B, seq_len=S, warmup_steps=2, **kw), device="cpu")
    return tr, tr.init_state(state_dict=_to_port(tcfg, tree))


def _assert_params_match(tcfg, state, jstate, atol=PARAM_ATOL):
    want = _to_port(tcfg, jstate.params)
    for name, p in state.named_params().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=atol,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_three_adamw_steps_match_lm_trainer(family):
    """Three steps of the port's trainer against LMTrainer on a one-device
    mesh (warmup 2: lr 0, lr/2, lr): per-step losses and accuracies, and
    every parameter after step 3. Every batch's gradient norm is above
    the clip (1.0), so each update goes through the clip."""
    jcfg, tcfg = _configs(family)
    tree = _perturbed_params(jt.CausalLM(jcfg))
    jtrainer, jstate = _jax_trainer(jcfg, tree)
    trainer, state = _port_trainer(tcfg, tree)
    before = state.params.clone()
    for step in range(3):
        toks, tgts = _batch(10 + step)
        _, grads, _ = trainer.loss_and_grads(state, toks, tgts)
        assert float(grads.norm()) > trainer.config.grad_clip
        jstate, jm = jtrainer.train_step(jstate, jnp.asarray(toks),
                                         jnp.asarray(tgts))
        state, m = trainer.train_step(state, toks, tgts)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=LOSS_ATOL)
        np.testing.assert_allclose(float(m["accuracy"]),
                                   float(jm["accuracy"]), atol=1e-6)
        if step == 0:       # lr(0) = 0: the first update moves nothing
            assert torch.equal(state.params, before)
    assert state.step == int(jstate.step) == 3
    assert int(state.opt.count) == 3
    _assert_params_match(tcfg, state, jstate)


def test_nonfinite_step_is_skipped_like_the_reference():
    """A NaN in the mask makes the loss and every gradient NaN: both
    trainers skip that update (params, moments and the optimizer count
    keep their values, the step advances, the streak counts 1), then a
    finite step lands identically."""
    jcfg, tcfg = _configs("gpt2")
    tree = _perturbed_params(jt.CausalLM(jcfg))
    jtrainer, jstate = _jax_trainer(jcfg, tree)
    trainer, state = _port_trainer(tcfg, tree)
    toks, tgts = _batch(3)
    bad = np.ones((B, S), np.float32)
    bad[1, 5] = np.nan
    before = state.params.clone()
    jstate, jm = jtrainer.train_step(jstate, jnp.asarray(toks),
                                     jnp.asarray(tgts), jnp.asarray(bad))
    state, m = trainer.train_step(state, toks, tgts, bad)
    assert math.isnan(float(m["loss"])) and math.isnan(float(jm["loss"]))
    assert int(m["nonfinite_streak"]) == int(jm["nonfinite_streak"]) == 1
    assert torch.equal(state.params, before) and state.step == 1
    assert int(state.opt.count) == 0 and not state.opt.mu.any()
    for _ in range(2):           # lr(0) = 0, then lr/2: a real update
        jstate, jm = jtrainer.train_step(jstate, jnp.asarray(toks),
                                         jnp.asarray(tgts))
        state, m = trainer.train_step(state, toks, tgts)
    assert int(m["nonfinite_streak"]) == int(jm["nonfinite_streak"]) == 0
    assert state.step == int(jstate.step) == 3
    assert not torch.equal(state.params, before)
    _assert_params_match(tcfg, state, jstate)


def test_schedules_match_optax():
    """make_lr_schedule against the reference's (optax) at every count of
    interest, linear and cosine; the warmup's first value is 0."""
    for kw in (dict(lr_schedule="linear", warmup_steps=100),
               dict(lr_schedule="linear", warmup_steps=0),
               dict(lr_schedule="cosine", warmup_steps=10, decay_steps=50)):
        jf = jtr.make_lr_schedule(jtr.LMTrainerConfig(**kw))
        tf = ttr.make_lr_schedule(ttr.LMTrainerConfig(**kw))
        for c in (0, 1, 2, 9, 10, 11, 30, 49, 50, 99, 100, 101, 5000):
            np.testing.assert_allclose(float(tf(torch.tensor(c))),
                                       float(jf(c)), rtol=1e-6, atol=1e-12)
    assert float(tf(torch.tensor(0))) == 0.0


def test_adamw_update_matches_optax_step_by_step():
    """adamw_update + the count against `make_adamw` (clip, adamw, no
    mask) for five steps over a flat vector, with gradients whose global
    norm is 0.5 (no clip) and 5 (clipped), schedule included: the first
    update moves nothing."""
    cfg = ttr.LMTrainerConfig(warmup_steps=3, learning_rate=1e-2)
    tx = jtr.make_adamw(jtr.LMTrainerConfig(warmup_steps=3,
                                            learning_rate=1e-2))
    schedule = ttr.make_lr_schedule(cfg)
    rs = np.random.RandomState(0)
    p = rs.randn(257).astype(np.float32)
    jp = jnp.asarray(p)
    jopt = tx.init(jp)
    tp = torch.from_numpy(p.copy())
    opt = ttr.AdamWState.zeros_like(tp)
    for step, norm in enumerate((0.5, 5.0, 0.5, 5.0, 3.0)):
        g = rs.randn(257).astype(np.float32)
        g *= norm / np.linalg.norm(g)
        upd, jopt = tx.update(jnp.asarray(g), jopt, jp)
        jp = optax.apply_updates(jp, upd)
        tg = torch.from_numpy(g)
        new_p, mu, nu = ttr.adamw_update(tp, tg, torch.linalg.vector_norm(tg),
                                         opt, schedule(opt.count), cfg)
        if step == 0:
            assert torch.equal(new_p, tp)
        tp, opt = new_p, ttr.AdamWState(opt.count + 1, mu, nu)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-7,
                                   rtol=1e-6)
        np.testing.assert_allclose(mu.numpy(), np.asarray(jopt[1][0].mu),
                                   atol=1e-7, rtol=1e-6)
        np.testing.assert_allclose(nu.numpy(), np.asarray(jopt[1][0].nu),
                                   atol=1e-9, rtol=1e-6)


def test_accumulation_equals_one_step():
    """accum_steps=2 (microbatch losses normalised by the full batch's
    mask count) gives the one-step loss and update, with a mask that
    weighs the two microbatches unevenly."""
    _, tcfg = _configs("gpt2")
    tree = _perturbed_params(jt.CausalLM(_configs("gpt2")[0]))
    toks, tgts = _batch(4)
    mask = np.ones((B, S), np.float32)
    mask[:2, S // 2:] = 0.0
    results = []
    for accum in (1, 2):
        trainer, state = _port_trainer(tcfg, tree, accum_steps=accum)
        for _ in range(2):
            state, m = trainer.train_step(state, toks, tgts, mask)
        results.append((float(m["loss"]), state.params.clone()))
    np.testing.assert_allclose(results[1][0], results[0][0], atol=LOSS_ATOL)
    np.testing.assert_allclose(results[1][1].numpy(), results[0][1].numpy(),
                               atol=PARAM_ATOL, rtol=0)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_fused_xent_equals_unfused(family):
    """fused_lm_loss (chunked, recomputed per chunk) against lm_loss over
    the tied logits: loss and every gradient; and against the
    reference's fused_lm_loss."""
    jcfg, tcfg = _configs(family)
    tree = _perturbed_params(jt.CausalLM(jcfg))
    toks, tgts = _batch(5)
    mask = np.ones((B, S), np.float32)
    mask[0, :7] = 0.0
    tmask = torch.from_numpy(mask)
    losses, grads = [], []
    for fused in (False, True):
        trainer, state = _port_trainer(tcfg, tree, fused_xent=fused)
        loss, g, _ = trainer.loss_and_grads(state, toks, tgts, tmask)
        losses.append(float(loss))
        grads.append(g)
    np.testing.assert_allclose(losses[1], losses[0], atol=LOSS_ATOL)
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(),
                               atol=GRAD_ATOL, rtol=0)
    jm = jt.CausalLM(jcfg)
    h = jm.apply({"params": jax.tree.map(jnp.asarray, tree)},
                 jnp.asarray(toks), with_head=False)
    jl = jtr.fused_lm_loss(h, jnp.asarray(tree["wte"]["embedding"]),
                           jnp.asarray(tgts), jnp.asarray(mask))
    np.testing.assert_allclose(losses[1], float(jl), atol=LOSS_ATOL)


def test_eval_step_and_evaluate_match_the_reference():
    jcfg, tcfg = _configs("llama")
    tree = _perturbed_params(jt.CausalLM(jcfg))
    jtrainer, jstate = _jax_trainer(jcfg, tree)
    trainer, state = _port_trainer(tcfg, tree)
    batches = [_batch(20), _batch(21)]
    want = [float(jtrainer.eval_step(jstate, jnp.asarray(t), jnp.asarray(g)))
            for t, g in batches]
    got = [float(trainer.eval_step(state, t, g)) for t, g in batches]
    np.testing.assert_allclose(got, want, atol=LOSS_ATOL)
    ev = trainer.evaluate(state, iter(batches), num_batches=2)
    np.testing.assert_allclose(ev["val_loss"], np.mean(want), atol=LOSS_ATOL)
    np.testing.assert_allclose(ev["perplexity"], math.exp(np.mean(want)),
                               rtol=1e-5)
    assert state.step == 0 and int(state.opt.count) == 0


def test_run_lm_benchmark_on_the_cpu(monkeypatch, tmp_path):
    """The entry point at test size: the reference's metric keys, every
    step's loss finite, warmup + timed steps taken, eval continuing the
    stream; remat, MoE and BERT run at test size; ViT (the image
    trainer: step 7) raises instead of being ignored, and so do 2
    slices, tp, pp or sp meshes in one process (the reference's
    divisibility check) and ep without experts; TPU_RESHARD_RESTORE=1
    resumes through the resharding restore (its checkpoint_restore
    record says resharded)."""
    logs = []
    state, m = bench.run_lm_benchmark(
        "gpt2", "test", batch_per_device=2, seq_len=16, num_steps=4,
        warmup_steps=2, eval_steps=1, device="cpu", log=logs.append)
    for key in ("tokens_per_sec", "step_time_p50_ms", "step_time_p99_ms",
                "final_loss", "flops_per_step", "tflops_per_sec_per_device",
                "mfu", "val_loss", "perplexity", "host_gap_p50_ms"):
        assert key in m, key
    assert m["mfu"] is None                 # no peak is known for a CPU
    assert len(m["step_losses"]) == 4
    assert all(math.isfinite(x) for x in m["step_losses"])
    assert state.step == 6 and state.model.config.max_len == 32
    assert any("tokens/sec" in line for line in logs)
    kw = dict(workload="gpt2", size="test", batch_per_device=2,
              seq_len=16, num_steps=1, device="cpu", log=logs.append)
    for bad, why in ((dict(tp=2), "not divisible by tp=2"),
                     (dict(pp=2), "1 devices not divisible by pp=2"),
                     (dict(sp=2), "not divisible by tp=1 × ep=1 × sp=2"),
                     (dict(ep=2), "--ep needs --moe-experts")):
        with pytest.raises(ValueError, match=why):
            bench.run_lm_benchmark(**{**kw, **bad})
    with pytest.raises(ValueError, match="2 slices"):
        bench.run_lm_benchmark(**{**kw, "num_slices": 2})
    with pytest.raises(ValueError, match="step 7"):
        bench.run_lm_benchmark(**{**kw, "workload": "vit"})
    for good in (dict(remat=True), dict(remat=True, remat_policy="dots"),
                 dict(moe_experts=4), dict(workload="bert")):
        st, gm = bench.run_lm_benchmark(**{**kw, **good})
        assert st.step == 6 and math.isfinite(gm["final_loss"])
    monkeypatch.setenv("TPU_RESHARD_RESTORE", "1")
    d = str(tmp_path / "ckpt")
    assert bench.run_lm_benchmark(**kw, train_dir=d)[0].step == 6
    assert bench.run_lm_benchmark(**kw, train_dir=d)[0].step == 12
    with open(os.path.join(d, "events.jsonl")) as f:
        restores = [json.loads(line) for line in f
                    if '"checkpoint_restore"' in line]
    assert [r["resharded"] for r in restores] == [True]


def test_benchmark_reports_the_reference_keys_and_goodput():
    """The same run shape through LMTrainer.benchmark on both sides (one
    warmup step, four timed steps in windows of two, the second timed
    step's mask NaN so the guard skips it): the port returns the JAX
    benchmark's keys (plus `step_losses`), and goodput from
    TrainTelemetry equals the reference's. Both refresh goodput only
    when a skip or a rollback is recorded, so it reads 1 - 1 skipped / 2
    steps observed at that fetch, not / 4 (ROADMAP.md Queue 3, G1)."""
    jcfg, tcfg = _configs("gpt2")
    tree = _perturbed_params(jt.CausalLM(jcfg))
    mesh = jpar.make_mesh(jpar.MeshConfig(dp=1), devices=jax.devices()[:1])
    jtrainer = jtr.LMTrainer(jt.CausalLM(jcfg), mesh, jtr.LMTrainerConfig(
        global_batch_size=B, seq_len=S, warmup_steps=2, log_every=2))
    jstate = jtrainer.init_state(jax.random.PRNGKey(0))
    jstate = jstate.replace(params=jax.tree.map(
        lambda ref, x: jax.device_put(jnp.asarray(x), ref.sharding),
        jstate.params, tree))
    trainer, state = _port_trainer(tcfg, tree, log_every=2)
    batches = []
    for i in range(5):
        toks, tgts = _batch(40 + i)
        mask = np.ones(tgts.shape, np.float32)
        if i == 2:
            mask[0, 0] = np.nan
        batches.append((toks, tgts, mask))
    quiet = lambda s: None  # noqa: E731
    _, jm = jtrainer.benchmark(
        jstate, [tuple(jnp.asarray(x) for x in b) for b in batches],
        num_steps=4, warmup_steps=1, log=quiet)
    state, m = trainer.benchmark(
        state, [tuple(torch.from_numpy(x) for x in b) for b in batches],
        num_steps=4, warmup_steps=1, log=quiet)
    assert set(m) == set(jm) | {"step_losses"}
    assert m["goodput"] == jm["goodput"] == 0.5
    assert math.isnan(m["step_losses"][1])
    for key in ("step_time_p50_ms", "step_time_p99_ms", "host_gap_p50_ms",
                "host_gap_p99_ms"):
        assert m[key] > 0 and jm[key] > 0, key
    assert state.step == 5 and int(state.opt.count) == 4


def test_token_stream_is_step_keyed():
    """Batch i of the synthetic stream depends only on (seed, i): a stream
    started at step 3 yields what an uninterrupted one yields there;
    targets are the tokens shifted by one, ids inside the vocabulary."""
    data = importlib.import_module("mpi_operator_tpu_torch.data")
    full = data.TokenStream(2, 16, 50, seed=1, device="cpu")
    batches = [next(full) for _ in range(5)]
    resumed = data.TokenStream(2, 16, 50, seed=1, start=3, device="cpu")
    for want in batches[3:]:
        got = next(resumed)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    toks, tgts = batches[0]
    assert toks.shape == tgts.shape == (2, 16) and toks.dtype == torch.int64
    assert torch.equal(toks[:, 1:], tgts[:, :-1])
    assert int(toks.min()) >= 0 and int(toks.max()) < 50
    assert not torch.equal(batches[0][0], batches[1][0])
    other = data.TokenStream(2, 16, 50, seed=2, device="cpu")
    assert not torch.equal(next(other)[0], batches[0][0])


def test_training_entry_points_refuse_to_run_without_a_card(monkeypatch):
    """With no CUDA device and no explicit device="cpu", the trainer, the
    stream and run_lm_benchmark raise; they never fall back to the CPU."""
    data = importlib.import_module("mpi_operator_tpu_torch.data")
    _, tcfg = _configs("gpt2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.LMTrainer(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        data.TokenStream(2, 16, 50)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.run_lm_benchmark("gpt2", "test", batch_per_device=2,
                               seq_len=16, num_steps=1)
    ttr.LMTrainer(tcfg, device="cpu")          # the explicit opt-in works
