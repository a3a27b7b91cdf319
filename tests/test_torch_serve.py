"""The PyTorch port's continuous-batching engine against the JAX one.

Same weights on both sides (params_from_flax). A greedy trace of mixed
prompt lengths, more requests than slots, served by the port's engine
must be TOKEN-EXACT against the JAX ServingEngine on the same trace and
against the port's own generate() per request — through the dense path
and through the decode kernel's plain version, gpt2-test (MHA) and
llama-test (GQA, int8 cache), in f32 and bf16. Then the lifecycle: EOS retirement and
slot reuse, async vs sync identity, request timeouts. `sample_slots` is
held to the JAX sampler token for token by feeding both the same Gumbel
noise; the engine's sampled requests to their top-k support and to
reproducibility under one seed.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from mpi_operator_tpu.serve import EngineConfig as JEngineConfig
from mpi_operator_tpu.serve import ServingEngine as JServingEngine
from mpi_operator_tpu.serve import sample_slots as jax_sample_slots
from mpi_operator_tpu_torch.serve import (
    EngineConfig, Request, ServingEngine, sample_slots,
)

jt = importlib.import_module("mpi_operator_tpu.models.transformer")
tt = importlib.import_module("mpi_operator_tpu_torch.models.transformer")
tg = importlib.import_module("mpi_operator_tpu_torch.models.generate")
convert = importlib.import_module("mpi_operator_tpu_torch.models.convert")

V, L = 64, 64


def _pair(family="gpt2", kv=None, decode_kernel=False, bf16=False):
    jcfg = (jt.gpt2_config if family == "gpt2" else jt.llama_config)(
        "test", attention="dense",
        dtype=jnp.bfloat16 if bf16 else jnp.float32, vocab_size=V,
        max_len=L, kv_cache_dtype=kv, decode_kernel=decode_kernel)
    tcfg = (tt.gpt2_config if family == "gpt2" else tt.llama_config)(
        "test", dtype=torch.bfloat16 if bf16 else torch.float32,
        vocab_size=V, max_len=L, kv_cache_dtype=kv,
        decode_kernel=decode_kernel)
    jm = jt.CausalLM(jcfg)
    params = meta.unbox(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 4), jnp.int32)))
    params = params["params"]
    tm = tt.build_lm(tcfg, convert.params_from_flax(
        tcfg, jax.tree.map(np.asarray, params)), device="cpu")
    return jm, params, tm


def _engine(tm, **kw):
    return ServingEngine(tm, EngineConfig(slots=4, chunk_buckets=(4, 8),
                                          **kw), device="cpu")


def _oracle(tm, req):
    out = tg.generate(tm, [list(req.prompt)], req.max_new_tokens,
                      eos_id=req.eos_id, device="cpu")
    toks = out.tokens[0, len(req.prompt):].tolist()
    if req.eos_id is not None and req.eos_id in toks:
        toks = toks[:toks.index(req.eos_id) + 1]   # the engine stops at eos
    return toks


def _trace(seed=7, eos_id=None):
    rs = np.random.RandomState(seed)
    return [Request(i, [int(t) for t in rs.randint(0, V, (p,))],
                    max_new_tokens=n, eos_id=eos_id)
            for i, (p, n) in enumerate([(1, 6), (3, 9), (9, 4), (14, 7),
                                        (5, 5), (7, 8)])]


@pytest.mark.parametrize("family,kv,kernel,bf16", [
    ("gpt2", None, False, False), ("llama", "int8", True, False),
    ("gpt2", None, True, True), ("llama", "int8", False, True)])
def test_engine_token_exact_vs_jax_engine_and_generate(family, kv, kernel,
                                                       bf16):
    """Six greedy requests, six prompt lengths, four slots: chunked
    prefill (right-padded short prompts, right-aligned ragged tails),
    slot reuse, per-slot cursors — every request's tokens equal the JAX
    engine's and the port's batch-1 generate(), in f32 and bf16, with
    the cache in the model dtype and in int8. Logprobs: f32 atol 1e-4,
    bf16 atol 2e-2 (as test_torch_generate.py)."""
    jm, params, tm = _pair(family, kv, kernel, bf16)
    reqs = _trace()
    ours = _engine(tm).run(reqs)
    theirs = JServingEngine(jm, params, JEngineConfig(
        slots=4, chunk_buckets=(4, 8), decode_kernel=kernel)).run(reqs)
    assert set(ours) == set(range(6))
    for r in reqs:
        assert ours[r.id].tokens == theirs[r.id].tokens, f"request {r.id}"
        assert ours[r.id].tokens == _oracle(tm, r), f"request {r.id}"
        assert ours[r.id].finish_reason == "length"
        np.testing.assert_allclose(ours[r.id].logprobs,
                                   theirs[r.id].logprobs,
                                   atol=2e-2 if bf16 else 1e-4)
        assert ours[r.id].ttft >= 0
        assert len(ours[r.id].token_times) == r.max_new_tokens


def test_engine_eos_retirement_and_slot_reuse():
    """More requests than slots and an eos_id that fires: finished rows
    retire, their slots serve later arrivals, every result matches the
    oracle including the eos cut."""
    _, _, tm = _pair()
    probe = Request(99, _trace(11)[3].prompt, max_new_tokens=8)
    eos = _oracle(tm, probe)[2]               # a token greedy WILL emit
    reqs = [Request(i, _trace(11 + i)[i].prompt, max_new_tokens=8,
                    eos_id=eos) for i in range(6)]
    reqs.append(Request(6, probe.prompt, max_new_tokens=8, eos_id=eos))
    engine = _engine(tm)
    results = engine.run(reqs)
    assert len(results) == 7
    assert results[6].finish_reason == "eos"
    assert results[6].tokens[-1] == eos and len(results[6].tokens) == 3
    for r in reqs:
        assert results[r.id].tokens == _oracle(tm, r), f"request {r.id}"
    assert engine.occupancy_peak == 4
    assert engine.slots.occupied == 0 and engine.scheduler.idle


def test_engine_async_matches_sync():
    """The double-buffered loop vs the drain-every-step loop: identical
    tokens (EOS cuts mid-flight included) and finish reasons."""
    _, _, tm = _pair()
    eos = _oracle(tm, Request(0, _trace(3)[4].prompt, 8))[2]
    reqs = [Request(r.id, r.prompt, 8, eos_id=eos) for r in _trace(3)]
    engine = _engine(tm)
    assert engine.config.async_decode
    a = engine.run(reqs)
    steps_async = engine.steps_dispatched
    engine.config.async_decode = False
    engine.reset()
    b = engine.run(reqs)
    assert any(r.finish_reason == "eos" for r in a.values())
    for r in reqs:
        assert a[r.id].tokens == b[r.id].tokens == _oracle(tm, r)
        assert a[r.id].finish_reason == b[r.id].finish_reason
    # async pays at most one junk step per EOS retirement
    assert steps_async >= engine.steps_dispatched


def test_engine_streams_in_order_and_times_out():
    _, _, tm = _pair()
    engine = _engine(tm)
    req = Request(0, [5, 9, 2], max_new_tokens=6)
    seen = []
    engine.run([req], on_token=lambda r, t: seen.append((r.id, t)))
    assert seen == [(0, t) for t in _oracle(tm, req)]
    engine = _engine(tm, request_timeout=0.0)
    res = engine.run([Request(1, [1, 2, 3, 4, 5, 6], max_new_tokens=20)])
    assert res[1].finish_reason == "timeout"
    assert len(res[1].tokens) < 20
    assert engine.slots.occupied == 0


def test_sample_slots_matches_jax_with_shared_noise():
    """Same logits, same per-row params, same Gumbel noise: the port's
    sampler picks the JAX sampler's token in every mode (greedy, the
    bounded top-128 pool, the full sort), with the same logprobs."""
    logits = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                          (6, 200))) * 3.0
    temps = np.array([0.0, 0.7, 1.3, 0.5, 1.0, 0.9], np.float32)
    top_ks = np.array([0, 7, 3, 64, 1, 128], np.int32)
    top_ps = np.array([1.0, 0.9, 1.0, 0.85, 1.0, 0.6], np.float32)
    for mode in ("bounded", "full"):
        rng = jax.random.PRNGKey(5)
        ref_tok, ref_lp = jax_sample_slots(
            jnp.asarray(logits), rng, jnp.asarray(temps),
            jnp.asarray(top_ks), jnp.asarray(top_ps), mode=mode)
        noise = np.asarray(jax.random.gumbel(rng, logits.shape, jnp.float32))
        tok, lp = sample_slots(torch.from_numpy(logits), None,
                               torch.from_numpy(temps),
                               torch.from_numpy(top_ks),
                               torch.from_numpy(top_ps), mode=mode,
                               gumbel=torch.from_numpy(noise.copy()))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
        np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), atol=1e-5)
    zeros = np.zeros(6, np.float32)
    ref_tok, ref_lp = jax_sample_slots(
        jnp.asarray(logits), jax.random.PRNGKey(0), jnp.asarray(zeros),
        jnp.zeros(6, jnp.int32), jnp.ones(6), mode="greedy")
    tok, lp = sample_slots(torch.from_numpy(logits), None,
                           torch.from_numpy(zeros),
                           torch.zeros(6, dtype=torch.int32), torch.ones(6),
                           mode="greedy")
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), atol=1e-5)


def test_engine_sampling_in_support_and_reproducible():
    """Sampled requests: one seed replays its draws after reset(); every
    sampled token is among the top_k of its teacher-forced step; the
    greedy rows riding in the same steps stay token-exact."""
    _, _, tm = _pair()
    prompt = [3, 1, 4, 1, 5]
    reqs = [Request(0, prompt, 6, temperature=1.2, top_k=3),
            Request(1, prompt, 6),
            Request(2, prompt, 6, temperature=0.8, top_k=0, top_p=0.9)]
    engine = _engine(tm)
    a = engine.run(reqs)
    engine.reset()
    b = engine.run(reqs)
    for r in reqs:
        assert a[r.id].tokens == b[r.id].tokens
        assert all(np.isfinite(a[r.id].logprobs))
    assert a[1].tokens == _oracle(tm, reqs[1])
    ctx = list(prompt)
    with torch.inference_mode():
        for t in a[0].tokens:
            logits = tm(torch.tensor([ctx]), positions=np.arange(len(ctx)))
            assert t in torch.topk(logits[0, -1], 3).indices.tolist()
            ctx.append(t)


def test_engine_refuses_what_is_not_ported():
    _, _, tm = _pair()
    # the paged cache is ported: one request runs, token-exact
    req = Request(0, [5, 9, 2, 7], max_new_tokens=4)
    paged = _engine(tm, paged=True, page_size=8)
    assert paged.run([req])[0].tokens == _oracle(tm, req)
    assert paged.page_allocator.in_use == 0
    with pytest.raises(NotImplementedError, match="speculative"):
        _engine(tm, speculative="ngram")
    with pytest.raises(NotImplementedError, match="telemetry"):
        ServingEngine(tm, EngineConfig(), device="cpu", telemetry=object())
    with pytest.raises(ValueError, match="max_len"):
        _engine(tm).run([Request(0, [1] * 60, max_new_tokens=10)])
