"""The PyTorch port's decode attention (K4) against the JAX reference.

`decode_attention_ref` — the plain version the port runs on the CPU and
holds its CUDA kernel against on the card — must match the reference's
Pallas kernel (`decode_attention(..., interpret=True)`) and the dense
oracle, for MHA, GQA and MQA, f32 and int8 caches, scalar and per-row
cursors, with the cache past each cursor POISONed so a read past the
cursor shows up as a huge error. Inputs come from numpy with a seed and
go to both frameworks.

Tolerances: f32 atol 2e-5 (the reference's own kernel-vs-dense bound:
summation order only); bf16 atol 2e-2 (a few ulps of bf16 at |out| ~ 1,
from the rounding of p before the p.v product at other offsets). The
CUDA kernel itself is held against this plain version on the card in
test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels_cuda import poisoned_inputs as _inputs

from mpi_operator_tpu.ops.attention import decode_attention as jax_decode
from mpi_operator_tpu_torch.ops import attention as port

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)


def _dense_oracle(q, k, v, curs, ks=None, vs=None):
    """The dense decode oracle in float64 numpy: dequant, GQA repeat,
    masked softmax over [0, cur]."""
    if ks is not None:
        k = k.astype(np.float64) * ks[..., None]
        v = v.astype(np.float64) * vs[..., None]
    B, KV, L, D = k.shape
    H = q.shape[1]
    k = np.repeat(k, H // KV, axis=1).astype(np.float64)
    v = np.repeat(v, H // KV, axis=1).astype(np.float64)
    s = np.einsum("bhd,bhld->bhl", q.astype(np.float64), k) / np.sqrt(D)
    curs = np.broadcast_to(np.asarray(curs), (B,))
    s = np.where(np.arange(L)[None, None] <= curs[:, None, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhl,bhld->bhd", p, v)


def _both(q, k, v, cur, ks, vs, dtype=np.float32):
    """(port ref, JAX interpret kernel) outputs as float32 numpy."""
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    quant = ks is not None
    jk = jnp.asarray(k) if quant else jnp.asarray(k, jd)
    jv = jnp.asarray(v) if quant else jnp.asarray(v, jd)
    ref_j = jax_decode(jnp.asarray(q, jd), jk, jv, jnp.asarray(cur),
                       k_scale=None if ks is None else jnp.asarray(ks),
                       v_scale=None if vs is None else jnp.asarray(vs),
                       block_k=16, interpret=True)
    tk = torch.from_numpy(k) if quant else torch.from_numpy(k).to(td)
    tv = torch.from_numpy(v) if quant else torch.from_numpy(v).to(td)
    out_t = port.decode_attention_ref(
        torch.from_numpy(q).to(td), tk, tv, torch.from_numpy(np.asarray(cur)),
        None if ks is None else torch.from_numpy(ks),
        None if vs is None else torch.from_numpy(vs))
    return (out_t.float().numpy(),
            np.asarray(ref_j.astype(jnp.float32)))


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("quantized", [False, True])
def test_ref_matches_jax_kernel_and_dense(H, KV, quantized):
    """MHA, GQA and MQA, each with and without the int8 cache, cursor
    mid-tile so both the skipped tail and the in-tile mask matter."""
    B, L, D, cur = 2, 64, 16, 37
    q, k, v, ks, vs = _inputs(B, H, KV, L, D, cur, quantized, seed=H + KV)
    out_t, out_j = _both(q, k, v, np.int32(cur), ks, vs)
    np.testing.assert_allclose(out_t, out_j, atol=2e-5)
    np.testing.assert_allclose(out_t, _dense_oracle(q, k, v, cur, ks, vs),
                               atol=2e-5)


@pytest.mark.parametrize("quantized", [False, True])
def test_ref_per_row_cursors(quantized):
    """[B] cursors (the serving engine's slots): each row reads exactly
    its own prefix; poison past every cursor makes a cross-row or
    beyond-cursor read loud."""
    B, H, KV, L, D = 4, 4, 2, 64, 16
    curs = np.array([0, 17, 31, 63], np.int32)
    q, k, v, ks, vs = _inputs(B, H, KV, L, D, curs, quantized, seed=3)
    out_t, out_j = _both(q, k, v, curs, ks, vs)
    np.testing.assert_allclose(out_t, out_j, atol=2e-5)
    np.testing.assert_allclose(out_t, _dense_oracle(q, k, v, curs, ks, vs),
                               atol=2e-5)
    # the CPU wrapper is the plain version
    t = port.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(curs), None if ks is None else torch.from_numpy(ks),
        None if vs is None else torch.from_numpy(vs))
    np.testing.assert_array_equal(t.numpy(), out_t)


@pytest.mark.parametrize("cur", [0, 15, 16, 63])
def test_ref_cursor_positions(cur):
    """The first position, both sides of a tile boundary, the full
    cache."""
    q, k, v, _, _ = _inputs(2, 4, 2, 64, 16, cur, False, seed=cur + 1)
    out_t, out_j = _both(q, k, v, np.int32(cur), None, None)
    np.testing.assert_allclose(out_t, out_j, atol=2e-5)


@pytest.mark.parametrize("quantized", [False, True])
def test_ref_bf16_matches_jax_kernel(quantized):
    """bf16 compute: cast-then-scale dequant and the rounding of p to
    bf16 before the p.v product, as in the reference kernel."""
    B, H, KV, L, D = 3, 8, 2, 64, 32
    curs = np.array([5, 40, 63], np.int32)
    q, k, v, ks, vs = _inputs(B, H, KV, L, D, curs, quantized, seed=11)
    out_t, out_j = _both(q, k, v, curs, ks, vs, dtype="bf16")
    np.testing.assert_allclose(out_t, out_j, atol=2e-2)


def test_vector_cursor_matches_scalar_and_rejects_bad_shapes():
    q, k, v, _, _ = _inputs(2, 4, 2, 64, 16, 29, False, seed=9)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    scalar = port.decode_attention(tq, tk, tv, 29)
    vector = port.decode_attention(tq, tk, tv,
                                   torch.full((2,), 29, dtype=torch.int32))
    torch.testing.assert_close(scalar, vector, rtol=0, atol=0)
    with pytest.raises(ValueError, match="cache_index"):
        port.decode_attention(tq, tk, tv, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of KV"):
        port.decode_attention(tq[:, :3], tk, tv, 10)
    with pytest.raises(ValueError, match="int8 cache needs"):
        port.decode_attention(tq, tk.to(torch.int8), tv.to(torch.int8), 10)


def test_wrapper_counts_only_kernel_launches():
    """The CPU path runs the plain version and counts nothing; a tensor
    on neither the CPU nor a card is refused, never silently computed."""
    port.reset_launch_counts()
    q, k, v, _, _ = _inputs(1, 4, 2, 32, 16, 7, False)
    port.decode_attention(*map(torch.from_numpy, (q, k, v)), 7)
    assert port.launch_counts["decode_attention"] == 0
    meta = torch.empty(1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.decode_attention(meta, meta.new_empty(1, 2, 32, 16),
                              meta.new_empty(1, 2, 32, 16), 7)


def test_decode_block_k_matches_reference_policy():
    from mpi_operator_tpu.ops.attention import decode_block_k as jax_bk
    for args in [(1024,), (32,), (1024, 256)]:
        assert port.decode_block_k(*args) == jax_bk(*args)

