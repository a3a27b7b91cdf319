"""The PyTorch port's decode-mode CausalLM against the JAX reference.

Same weights on both sides: the flax params (with every bias and norm
scale perturbed off its init, so each converted tensor matters) go
through `params_from_flax` into the port. Then the same per-row
positions drive both: a zero-token cache init, a prefill chunk, a
second chunk at DIFFERENT per-row starts (the serving engine's slot
cursors), and a single-token step — and the final hidden states must
agree, for gpt2-test (learned positions, LayerNorm, gelu, MHA) and
llama-test (RoPE, RMSNorm, SwiGLU, GQA), with the cache in the model
dtype and in int8.

Tolerances: f32 atol 1e-4 on hidden states of |h| ~ 1 (summation order
only); f32 with the int8 cache atol 2e-3 (an element whose x/scale sits
within f32 rounding of a .5 boundary may quantize one step apart: one
int8 quantum ~ max|k|/127 of one cached element); bf16 atol 0.1 (the
frameworks round bf16 intermediates at different points — XLA keeps
some elementwise chains in f32 — a few bf16 ulps at |h| up to ~4).
Token-level exactness under bf16 is pinned in test_torch_generate.py.
"""
import dataclasses
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
convert = importlib.import_module("mpi_operator_tpu_torch.models.convert")

V, L = 96, 64
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _perturbed_params(jm, seed=0):
    """flax params as nested numpy dicts, biases and norm scales moved
    off their zeros/ones init."""
    params = meta.unbox(jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                         jnp.zeros((1, 4), jnp.int32)))
    params = params["params"]
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
    return walk(jax.tree.map(np.asarray, params))


def _pair(family, dtype="f32", kv=None, decode_kernel=False):
    jd, td = DTYPES[dtype]
    jcfg = (jt.gpt2_config if family == "gpt2" else jt.llama_config)(
        "test", attention="dense", dtype=jd, vocab_size=V, max_len=L,
        kv_cache_dtype=kv, decode_kernel=decode_kernel)
    tcfg = (tt.gpt2_config if family == "gpt2" else tt.llama_config)(
        "test", dtype=td, vocab_size=V, max_len=L, kv_cache_dtype=kv,
        decode_kernel=decode_kernel)
    jm = jt.CausalLM(jcfg)
    tree = _perturbed_params(jm)
    tm = tt.build_lm(tcfg, convert.params_from_flax(tcfg, tree),
                     device="cpu")
    return jm, jax.tree.map(jnp.asarray, tree), tm


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_params_from_flax_layouts():
    """Every state-dict entry exists with the port's shape, and each
    projection reproduces its flax counterpart (DenseGeneral [E,H,D],
    [H,D,E] and nn.Dense [in,out])."""
    jm, params, tm = _pair("llama")
    cfg = tm.config
    assert set(tm.state_dict()) == set(tt.param_shapes(cfg))
    blk = params["backbone"]["block_0"]
    x = np.random.RandomState(0).randn(3, cfg.embed_dim).astype(np.float32)
    attn = tm.backbone.blocks[0].attn
    q_j = np.einsum("be,ehd->bhd", x, np.asarray(blk["attn"]["query"]["kernel"]))
    q_j = q_j + np.asarray(blk["attn"]["query"]["bias"])
    q_t = attn.query(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(q_t, q_j.reshape(3, -1), atol=1e-5)
    hd = np.random.RandomState(1).randn(3, cfg.num_heads, cfg.head_dim)
    o_j = np.einsum("bhd,hde->be", hd, np.asarray(blk["attn"]["out"]["kernel"]))
    o_t = attn.out(torch.from_numpy(hd.reshape(3, -1)).float()).numpy()
    np.testing.assert_allclose(o_t, o_j + np.asarray(blk["attn"]["out"]["bias"]),
                               atol=1e-5)
    g_j = x @ np.asarray(blk["mlp"]["fc_gate"]["kernel"]) \
        + np.asarray(blk["mlp"]["fc_gate"]["bias"])
    g_t = tm.backbone.blocks[0].mlp.fc_gate(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(g_t, g_j, atol=1e-5)
    np.testing.assert_array_equal(tm.backbone.ln_f.weight.numpy(),
                                  np.asarray(params["backbone"]["ln_f"]["scale"]))
    assert tm.backbone.ln_f.bias is None          # RMSNorm: scale only


def test_rope_matches_reference():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 5, 3, 16).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 9, 11, 30, 63]])
    ref = jt.rope(jnp.asarray(x), jnp.asarray(pos))
    out = tt.rope(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def _jax_steps(jm, params, toks1, toks2, starts2, tok3, pos3, C, kernel):
    dm = jg.decode_model(jm, decode_kernel=kernel, slots=True)
    apply = jax.jit(dm.apply, static_argnames=("with_head", "mutable"))
    B = toks1.shape[0]
    z = jnp.zeros((B, 1), jnp.int32)
    _, v = apply({"params": params}, z, positions=z, with_head=False,
                 mutable="cache")
    outs = []
    for toks, pos in ((toks1, np.arange(C)[None].repeat(B, 0)),
                      (toks2, starts2[:, None] + np.arange(C)[None]),
                      (tok3[:, None], pos3[:, None])):
        h, v = apply({"params": params, "cache": v["cache"]},
                     jnp.asarray(toks, jnp.int32),
                     positions=jnp.asarray(pos, jnp.int32),
                     with_head=False, mutable="cache")
        outs.append(_f32(h))
    return outs


def _port_steps(tm, toks1, toks2, starts2, tok3, pos3, C):
    B = toks1.shape[0]
    cache = tm.new_cache(B)
    z = torch.zeros(B, 1, dtype=torch.int64)
    outs = []
    with torch.inference_mode():
        tm(z, positions=z.numpy(), cache=cache, with_head=False)
        for toks, pos in ((toks1, np.arange(C)[None].repeat(B, 0)),
                          (toks2, starts2[:, None] + np.arange(C)[None]),
                          (tok3[:, None], pos3[:, None])):
            h = tm(torch.from_numpy(toks).long(), positions=pos, cache=cache,
                   with_head=False)
            outs.append(_f32(h))
    return outs


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("dtype,kv,kernel", [
    ("f32", None, False), ("f32", "int8", True), ("bf16", None, True),
    ("bf16", "int8", False)])
def test_decode_hidden_states_match_reference(family, dtype, kv, kernel):
    """Prefill chunk, per-row second chunk, single-token step: the final
    hidden states of each call agree with the reference's decode mode
    (the single-token step through the decode kernel when `kernel`:
    JAX's Pallas kernel in interpret mode vs the port's plain version)."""
    jm, params, tm = _pair(family, dtype, kv, decode_kernel=kernel)
    rs = np.random.RandomState(5)
    B, C = 3, 8
    toks1 = rs.randint(0, V, (B, C))
    toks2 = rs.randint(0, V, (B, C))
    starts2 = np.array([8, 5, 8])        # row 1 re-covers a suffix
    tok3 = rs.randint(0, V, (B,))
    pos3 = starts2 + C
    ref = _jax_steps(jm, params, toks1, toks2, starts2, tok3, pos3, C,
                     kernel)
    out = _port_steps(tm, toks1, toks2, starts2, tok3, pos3, C)
    atol = 0.1 if dtype == "bf16" else 2e-3 if kv == "int8" else 1e-4
    for r, o in zip(ref, out):
        assert np.isfinite(o).all()
        np.testing.assert_allclose(o, r, atol=atol)


def test_multi_token_write_drops_positions_past_the_cache():
    """A window crossing max_len drops its out-of-range writes (the
    reference's scatter mode="drop"); a single-token write past the end
    clamps to the last row (dynamic_update_slice)."""
    cfg = tt.gpt2_config("test", dtype=torch.float32, vocab_size=V,
                         max_len=8)
    c = torch.zeros(1, 1, 8)
    u = torch.arange(1.0, 5.0).reshape(1, 1, 4)
    pos_host = torch.tensor([[6, 7, 8, 9]])
    tt._write(c, u, pos_host, pos_host)
    assert c[0, 0].tolist() == [0, 0, 0, 0, 0, 0, 1, 2]
    tt._write(c, torch.full((1, 1, 1), 9.0), torch.tensor([[12]]),
              torch.tensor([[12]]))
    assert c[0, 0, 7] == 9.0
    assert dataclasses.replace(cfg).max_len == 8
