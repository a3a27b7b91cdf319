"""The PyTorch port's paged decode attention (K5) against the JAX reference.

`paged_decode_attention_ref` — the plain version the port runs on the
CPU and holds its CUDA kernel against on the card — must match the
reference's Pallas kernel (`paged_decode_attention(..., interpret=True)`)
over a shuffled page table, with POISON in the trash page, in a page no
table entry maps and past every row's cursor, so a wrong page or a read
past the cursor shows up as a huge error; and two rows aliasing one
page (a prefix hit) must read the same K/V through it. Inputs come from
numpy with a seed and go to both frameworks.

Tolerance: atol 2e-5 in f32 (the reference's own paged-kernel-vs-dense
bound: summation order only). The plain version gathers the pool into
the contiguous layout and runs K4's plain version, so against that on
the logical cache it is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels_cuda import paged_inputs

from mpi_operator_tpu.ops.attention import \
    paged_decode_attention as jax_paged
from mpi_operator_tpu_torch.ops import attention as port

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2)])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("share", [False, True])
def test_ref_matches_jax_paged_kernel(H, KV, quantized, share):
    """Per-row cursors at block starts, interiors and ends over a
    shuffled table; with `share`, two rows alias their first two pages
    (those below both their cursors)."""
    B, D, ps, nblk = 4, 16, 16, 4
    curs = np.array([0, 17, 31, 63], np.int32)
    q, kp, vp, ksp, vsp, pt, logical = paged_inputs(
        B, H, KV, D, ps, nblk, curs, quantized, seed=H + KV, share=share)
    if share:
        assert (pt[2, :2] == pt[3, :2]).all() and pt[2, 2] != pt[3, 2]
    out_j = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                      jnp.asarray(curs), jnp.asarray(pt),
                      k_scale=None if ksp is None else jnp.asarray(ksp),
                      v_scale=None if vsp is None else jnp.asarray(vsp),
                      interpret=True)
    out_t = port.paged_decode_attention_ref(
        _t(q), _t(kp), _t(vp), _t(curs), _t(pt), _t(ksp), _t(vsp))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-5)
    # the same function as K4's plain version on the logical cache
    k, v, ks, vs = logical
    want = port.decode_attention_ref(_t(q), _t(k), _t(v), _t(curs), _t(ks),
                                     _t(vs))
    assert torch.equal(out_t, want)
    # the CPU wrapper is the plain version
    got = port.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(curs),
                                      _t(pt), _t(ksp), _t(vsp))
    assert torch.equal(got, out_t)


def test_ref_rows_aliasing_one_page():
    """Two rows whose tables alias the SAME physical prefix page read
    identical K/V through it (the reference's shared-page case)."""
    B, H, KV, D, ps = 2, 4, 2, 16, 16
    pt = np.array([[1, 2], [1, 3]], np.int32)      # page 1 shared
    curs = np.array([ps + 3, ps + 7], np.int32)
    rs = np.random.RandomState(9)
    kp = rs.randn(4, KV, ps, D).astype(np.float32)
    vp = rs.randn(4, KV, ps, D).astype(np.float32)
    q = rs.randn(B, H, D).astype(np.float32)
    out_j = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                      jnp.asarray(curs), jnp.asarray(pt), interpret=True)
    out_t = port.paged_decode_attention_ref(_t(q), _t(kp), _t(vp),
                                            _t(curs), _t(pt))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-5)


def test_wrapper_rejects_bad_tables_and_counts_no_cpu_launch():
    """A table of the wrong shape or dtype is refused; the CPU path runs
    the plain version and counts no kernel launch; a tensor on neither
    the CPU nor a card is refused."""
    q, kp, vp, _, _, pt, _ = paged_inputs(2, 4, 2, 16, 8, 4, [5, 30], False)
    args = (_t(q), _t(kp), _t(vp), _t(np.array([5, 30], np.int32)))
    port.reset_launch_counts()
    port.paged_decode_attention(*args, _t(pt))
    assert {"decode_attention", "paged_decode_attention"} <= set(
        port.launch_counts)
    assert not any(port.launch_counts.values())
    with pytest.raises(TypeError, match="int32"):
        port.paged_decode_attention(*args, _t(pt).long())
    with pytest.raises(ValueError, match="page_table"):
        port.paged_decode_attention(*args, _t(pt[:1]))
    with pytest.raises(ValueError, match="page_table"):
        port.paged_decode_attention(*args, _t(pt[0]))
    with pytest.raises(ValueError, match="int8 pool needs"):
        port.paged_decode_attention(args[0], args[1].to(torch.int8),
                                    args[2].to(torch.int8), args[3], _t(pt))
    meta = torch.empty(2, 4, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.paged_decode_attention(meta, meta.new_empty(10, 2, 8, 16),
                                    meta.new_empty(10, 2, 8, 16), 7,
                                    torch.zeros(2, 4, dtype=torch.int32))
