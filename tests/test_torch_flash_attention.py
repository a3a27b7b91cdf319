"""The port's flash attention (the plain versions of K1-K3 behind a
torch.autograd.Function) against the JAX reference's `flash_attention`,
whose Pallas kernels run in interpret mode on the CPU.

Same numpy inputs on both sides, f32, where the point is the algorithm:
forward outputs and q/k/v gradients (through `torch.autograd` on one
side, `jax.grad` on the other) for causal and non-causal attention, a
key mask with a fully masked row, a ragged S (the reference goes dense
there; the function is the same) and several reference block sizes.
Then each plain backward version against the one Pallas kernel it stands
for (`_dq_call`, `_dkv_call`), given the same lse and delta.

Tolerances, as tests/test_ops.py holds the reference's own kernels
against its dense path: outputs atol 2e-5, gradients atol 1e-4 (f32
summation order only).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

ja = importlib.import_module("mpi_operator_tpu.ops.attention")
jt = importlib.import_module("mpi_operator_tpu.models.transformer")
port = importlib.import_module("mpi_operator_tpu_torch.ops.attention")

OUT_ATOL, GRAD_ATOL = 2e-5, 1e-4


def _inputs(B, S, H, D, seed=0):
    rs = np.random.RandomState(seed)
    q, k, v, w = (rs.randn(B, S, H, D).astype(np.float32) for _ in range(4))
    return q, k, v, w


def _mask(B, S, kind):
    """[B, S] bool key masks: row 0 padded after 3/4 of S; with "empty",
    row 1 has no valid key at all."""
    if kind is None:
        return None
    m = np.ones((B, S), bool)
    m[0, (3 * S) // 4:] = False
    if kind == "empty":
        m[1] = False
    return m


def _jax_side(q, k, v, w, causal, mask, block):
    """Output and d(sum(out * w))/d(q, k, v) of the reference."""
    jm = None if mask is None else jnp.asarray(mask)

    def f(q, k, v):
        out = ja.flash_attention(q, k, v, causal=causal, mask=jm,
                                 block_q=block[0], block_k=block[1],
                                 interpret=True)
        return (out * jnp.asarray(w)).sum(), out
    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_side(q, k, v, w, causal, mask):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    out = port.flash_attention(tq, tk, tv, causal=causal, mask=tm)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("causal,mask,S,block", [
    (True, None, 48, (16, 16)),
    (True, None, 32, (8, 16)),           # q and k tiles of unequal size
    (True, None, 32, (16, 8)),
    (False, None, 32, (16, 16)),
    (True, "pad", 32, (8, 16)),
    (False, "pad", 32, (16, 8)),
    (False, "empty", 32, (8, 8)),        # one row attends nothing
    (True, None, 40, (16, 16)),          # ragged S: the reference is dense
    (False, "pad", 40, (16, 16)),
])
def test_flash_attention_matches_jax(causal, mask, S, block):
    B, H, D = 2, 2, 16
    q, k, v, w = _inputs(B, S, H, D, seed=S + block[0])
    m = _mask(B, S, mask)
    ref_out, ref_grads = _jax_side(q, k, v, w, causal, m, block)
    out, grads = _port_side(q, k, v, w, causal, m)
    np.testing.assert_allclose(out, ref_out, atol=OUT_ATOL, rtol=0)
    for name, g, rg in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(g, rg, atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"d{name}")


def test_fully_masked_row_gives_mean_of_v_and_no_gradient():
    """A row whose keys are all masked: the forward gives the mean of v
    (the online softmax over uniform -1e30 scores, as the reference's
    kernel and its dense path give it); the backward re-masks p, so no
    gradient flows from that row, and nothing is NaN."""
    B, S, H, D = 2, 32, 2, 16
    q, k, v, w = _inputs(B, S, H, D, seed=3)
    m = _mask(B, S, "empty")
    out, (dq, dk, dv) = _port_side(q, k, v, w, False, m)
    np.testing.assert_allclose(out[1], np.broadcast_to(v[1].mean(0), (S, H, D)),
                               atol=1e-5)
    for g in (dq, dk, dv):
        assert np.isfinite(g).all()
        assert not g[1].any()


def _lanes(x):
    """[B, H, S] -> the reference's [B*H, S, 128] lane broadcast."""
    B, H, S = x.shape
    return jnp.broadcast_to(jnp.asarray(x).reshape(B * H, S)[..., None],
                            (B * H, S, ja.LANES))


def _bh(x):
    B, S, H, D = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, D))


def _from_bh(x, B, H):
    BH, S, D = x.shape
    return np.asarray(x).reshape(B, H, S, D).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("causal,mask", [(True, None), (False, "pad"),
                                         (True, "pad")])
def test_each_plain_version_matches_its_pallas_kernel(causal, mask):
    """flash_fwd_ref against `_flash_fwd` (out and lse), flash_dq_ref
    against `_dq_call`, flash_dkv_ref against `_dkv_call`, each given
    the same inputs, lse and delta; unequal reference tiles."""
    B, S, H, D = 2, 32, 2, 16
    q, k, v, do = _inputs(B, S, H, D, seed=7)
    m = _mask(B, S, mask)
    kv_mask = None if m is None else jnp.broadcast_to(
        jnp.asarray(m, jnp.float32)[:, None, :], (B, 8, S))
    scale = 1.0 / np.sqrt(D)
    bq, bk = 8, 16
    j_out, j_lse = ja._flash_fwd(_bh(q), _bh(k), _bh(v), kv_mask, scale,
                                 causal, bq, bk, H, True)
    tm = None if m is None else torch.from_numpy(m)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = port.flash_fwd_ref(tq, tk, tv, causal, tm)
    np.testing.assert_allclose(out.numpy(), _from_bh(j_out, B, H),
                               atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(j_lse)[..., 0].reshape(B, H, S),
                               atol=OUT_ATOL, rtol=0)

    delta = port.flash_delta(out, tdo)
    lse_l, delta_l = _lanes(lse.numpy()), _lanes(delta.numpy())
    j_dq = ja._dq_call(_bh(q), _bh(k), _bh(v), _bh(do), lse_l, delta_l,
                       kv_mask, scale, causal, bq, bk, H, True)
    j_dk, j_dv = ja._dkv_call(_bh(q), _bh(k), _bh(v), _bh(do), lse_l,
                              delta_l, kv_mask, scale, causal, bq, bk, H,
                              True)
    dq = port.flash_dq_ref(tq, tk, tv, tdo, lse, delta, causal, tm)
    dk, dv = port.flash_dkv_ref(tq, tk, tv, tdo, lse, delta, causal, tm)
    for name, got, want in (("dq", dq, j_dq), ("dk", dk, j_dk),
                            ("dv", dv, j_dv)):
        np.testing.assert_allclose(got.numpy(), _from_bh(want, B, H),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_wrappers_run_the_plain_version_on_the_cpu():
    """A CPU tensor runs the plain version and counts no launch; the
    shapes the kernels do not take are refused before any launch."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 24, 2, 16))
    before = dict(port.launch_counts)
    out, lse = port.flash_fwd(q, k, v)
    ref_out, ref_lse = port.flash_fwd_ref(q, k, v)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert port.launch_counts == before
    with pytest.raises(ValueError, match="one shape"):
        port.flash_attention(q, k[:, :, :1], v)
    with pytest.raises(ValueError, match=r"mask must be \[B, S\]"):
        port.flash_attention(q, k, v, mask=torch.ones(1, 23, dtype=bool))

