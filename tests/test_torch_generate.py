"""The PyTorch port's generate() against the JAX reference's.

Greedy output must be TOKEN-EXACT: the same flax weights (converted by
params_from_flax), the same prompt, identical tokens — for gpt2-test
(MHA) and llama-test (GQA), with the KV cache in the model dtype (f32
and bf16) and in int8, through the dense path and through the decode
kernel's plain version. Sampled output cannot match draw for draw (JAX
keys vs torch generators), so sampling is held to its support, to
greedy at top_k=1, and to reproducibility under one seed.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

jt = importlib.import_module("mpi_operator_tpu.models.transformer")
jg = importlib.import_module("mpi_operator_tpu.models.generate")
tt = importlib.import_module("mpi_operator_tpu_torch.models.transformer")
tg = importlib.import_module("mpi_operator_tpu_torch.models.generate")
convert = importlib.import_module("mpi_operator_tpu_torch.models.convert")

V, L = 96, 64
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(family, dtype="f32", kv=None):
    jd, td = DTYPES[dtype]
    jcfg = (jt.gpt2_config if family == "gpt2" else jt.llama_config)(
        "test", attention="dense", dtype=jd, vocab_size=V, max_len=L,
        kv_cache_dtype=kv)
    tcfg = (tt.gpt2_config if family == "gpt2" else tt.llama_config)(
        "test", dtype=td, vocab_size=V, max_len=L, kv_cache_dtype=kv)
    jm = jt.CausalLM(jcfg)
    params = meta.unbox(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 4), jnp.int32)))
    params = params["params"]
    tm = tt.build_lm(tcfg, convert.params_from_flax(
        tcfg, jax.tree.map(np.asarray, params)), device="cpu")
    return jm, params, tm


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("dtype,kv", [("f32", None), ("bf16", None),
                                      ("bf16", "int8"), ("f32", "int8")])
def test_greedy_tokens_match_reference(family, dtype, kv):
    jm, params, tm = _pair(family, dtype, kv)
    prompt = np.random.RandomState(0).randint(0, V, (3, 11))
    ref = jg.generate(jm, params, jnp.asarray(prompt, jnp.int32), 16)
    dense = tg.generate(tm, prompt, 16, device="cpu")
    kernel = tg.generate(tm, prompt, 16, decode_kernel=True, device="cpu")
    np.testing.assert_array_equal(dense.tokens.numpy(),
                                  np.asarray(ref.tokens))
    np.testing.assert_array_equal(kernel.tokens.numpy(),
                                  np.asarray(ref.tokens))
    # logprobs of the chosen tokens: f32 1e-4; bf16 inputs 2e-2
    tol = 1e-4 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(dense.logprobs.numpy(),
                               np.asarray(ref.logprobs), atol=tol)


def test_eos_freezes_rows_like_reference():
    jm, params, tm = _pair("gpt2")
    prompt = np.random.RandomState(4).randint(0, V, (2, 6))
    probe = tg.generate(tm, prompt, 8, device="cpu").tokens.numpy()
    eos = int(probe[0, 6 + 2])            # a token row 0 WILL emit
    ref = jg.generate(jm, params, jnp.asarray(prompt, jnp.int32), 8,
                      eos_id=eos)
    out = tg.generate(tm, prompt, 8, eos_id=eos, device="cpu")
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    row = out.tokens[0, 6:].tolist()
    assert row[row.index(eos):] == [eos] * (8 - row.index(eos))
    assert (out.logprobs[0, row.index(eos) + 1:] == 0).all()


def test_sampling_support_seed_and_top_k_one():
    _, _, tm = _pair("llama")
    prompt = np.random.RandomState(1).randint(0, V, (2, 5))
    greedy = tg.generate(tm, prompt, 6, device="cpu").tokens

    def sample(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return tg.generate(tm, prompt, 6, temperature=0.9, generator=g,
                           device="cpu", **kw)
    assert torch.equal(sample(0, top_k=1).tokens, greedy)
    a, b = sample(3, top_k=4), sample(3, top_k=4)
    assert torch.equal(a.tokens, b.tokens)
    assert bool(torch.isfinite(a.logprobs).all())
    assert not torch.equal(sample(3).tokens, sample(4).tokens)
    # every sampled token is inside the top-4 of its teacher-forced step
    with torch.inference_mode():
        logits = tm(a.tokens[:, :-1], positions=np.arange(10)[None])
    top4 = torch.topk(logits[:, 4:], 4, dim=-1).indices
    assert (top4 == a.tokens[:, 5:, None]).any(-1).all()


def test_generate_validation():
    _, _, tm = _pair("gpt2")
    p = np.zeros((1, 4), np.int64)
    with pytest.raises(ValueError, match="max_len"):
        tg.generate(tm, p, L, device="cpu")
    with pytest.raises(ValueError, match="Generator"):
        tg.generate(tm, p, 2, temperature=0.5, device="cpu")
    with pytest.raises(ValueError, match="temperature > 0"):
        tg.generate(tm, p, 2, top_k=3, device="cpu")
    with pytest.raises(ValueError, match="top_p"):
        tg.generate(tm, p, 2, temperature=1.0, top_p=0.0,
                    generator=torch.Generator(), device="cpu")


@pytest.mark.parametrize("top_k,top_p", [(None, None), (5, None),
                                         (None, 0.8), (7, 0.9)])
def test_sample_matches_jax_with_shared_noise(top_k, top_p):
    """generate()'s sampler against the reference's `_sample` on the
    same logits and the same Gumbel noise (jax.random.categorical is the
    Gumbel-max trick): identical tokens through the top-k and nucleus
    filters, and identical logprobs of the choices (f32 atol 1e-5)."""
    rng = jax.random.PRNGKey(3)
    logits = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                          (5, 300))) * 2.5
    ref_tok, ref_lp = jg._sample(jnp.asarray(logits), False, 0.7, rng,
                                 top_k, top_p is not None,
                                 jnp.float32(top_p or 1.0))
    noise = np.array(jax.random.gumbel(rng, logits.shape, jnp.float32))
    tok, lp = tg._sample(torch.from_numpy(logits), False, 0.7, None, top_k,
                         top_p, gumbel=torch.from_numpy(noise))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), atol=1e-5)
