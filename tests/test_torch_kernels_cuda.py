"""The port's CUDA decode-attention kernels (K4 contiguous, K5 paged)
against their plain versions, on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Without a card every test here skips (the kernel has no CPU mode; its
plain version is held against the JAX reference in
test_torch_decode_attention.py and test_torch_paged_attention.py).
`poisoned_inputs` and `paged_inputs` are shared with those files: the
cache past each row's cursor holds POISON, and so does every page no
table entry maps (the trash page 0 among them), so a read past the
cursor or through a wrong page shows up as a huge error, not a lucky
zero.

Tolerances: bf16 atol 2e-2 + rtol 2e-2 (the kernel's online softmax
rounds p to bf16 against a running max, the plain version against the
row max: a few bf16 ulps at |out| ~ 1); f32 atol 1e-4 (summation order
only). K5 against K4 on the same logical cache: bit for bit (one kernel
body and one tile walk; only the row addresses differ).
"""
import numpy as np
import pytest
import torch

from mpi_operator_tpu_torch.ops import attention as port

POISON = 1e4          # beyond-cursor cache contents: loud if ever read


def poisoned_inputs(B, H, KV, L, D, curs, quantized, seed=0):
    """numpy q/k/v (int8 + f32 scales when `quantized`), poisoned past
    each row's cursor; the scales are None for an unquantized cache."""
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, D).astype(np.float32)
    k = rs.randn(B, KV, L, D).astype(np.float32)
    v = rs.randn(B, KV, L, D).astype(np.float32)
    curs = np.broadcast_to(np.asarray(curs, np.int32), (B,))
    dead = np.arange(L)[None, None, :, None] > curs[:, None, None, None]
    if not quantized:
        return q, np.where(dead, POISON, k).astype(np.float32), \
            np.where(dead, POISON, v).astype(np.float32), None, None
    out = [q]
    scales = []
    for x in (k, v):
        s = np.maximum(np.abs(x).max(-1) / 127.0, 1e-8).astype(np.float32)
        x8 = np.clip(np.round(x / s[..., None]), -127, 127)
        out.append(np.where(dead, 127, x8).astype(np.int8))
        scales.append(np.where(dead[..., 0], POISON, s).astype(np.float32))
    return (*out, *scales)


def paged_inputs(B, H, KV, D, ps, nblk, curs, quantized, seed=0,
                 share=True):
    """numpy q, a page pool and its table: the logical cache of
    `poisoned_inputs` (L = nblk * ps) scattered into a pool of
    NP = B * nblk + 2 pages through a seeded permutation of pages
    1..NP-2. Page 0 (trash) and page NP-1 (never mapped) hold POISON.
    With `share`, the two rows with the largest cursors share their first
    pages (up to 2, all below both cursors), as a prefix hit does.
    Returns (q, k_pages, v_pages, k_scale, v_scale, table int32 [B, nblk],
    the logical (k, v, ks, vs))."""
    L = ps * nblk
    curs = np.broadcast_to(np.asarray(curs, np.int32), (B,))
    q, k, v, ks, vs = poisoned_inputs(B, H, KV, L, D, curs, quantized, seed)
    NP = B * nblk + 2
    rs = np.random.RandomState(seed + 1)
    table = rs.permutation(np.arange(1, NP - 1)).reshape(B, nblk)
    if share and B >= 2:
        i, j = np.argsort(curs, kind="stable")[-2:]
        n = min(2, (int(curs[i]) + 1) // ps, nblk)
        table[j, :n] = table[i, :n]
        for x in (k, v) + ((ks, vs) if quantized else ()):
            x[j, :, :n * ps] = x[i, :, :n * ps]
    table = table.astype(np.int32)

    def pool(x, fill):
        out = np.full((NP, KV, ps) + x.shape[3:], fill, x.dtype)
        for b in range(B):
            for blk in range(nblk):
                out[table[b, blk]] = x[b, :, blk * ps:(blk + 1) * ps]
        return out
    dead = 127 if quantized else POISON
    kp, vp = pool(k, dead), pool(v, dead)
    ksp = vsp = None
    if quantized:
        ksp, vsp = pool(ks, POISON), pool(vs, POISON)
    return q, kp, vp, ksp, vsp, table, (k, v, ks, vs)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no "
                    "CPU mode (its plain version is tested against JAX in "
                    "test_torch_decode_attention.py)")
    return torch.device("cuda")


def _on_card(dev, dtype, q, k, v, curs, ks, vs):
    quantized = ks is not None

    def cache(x):
        t = torch.from_numpy(x).to(dev)
        return t if quantized else t.to(dtype)
    return (torch.from_numpy(q).to(dev, dtype), cache(k), cache(v),
            torch.from_numpy(np.asarray(curs)).to(dev),
            None if ks is None else torch.from_numpy(ks).to(dev),
            None if vs is None else torch.from_numpy(vs).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,D,L,curs", [
    (4, 16, 16, 64, 200, [0, 63, 64, 199]),        # tile edges, full cache
    (4, 32, 8, 64, 200, [1, 65, 127, 150]),
    (4, 32, 8, 128, 200, [0, 63, 64, 199]),        # llama-7b head size
    (4, 8, 1, 64, 200, [5, 0, 199, 64]),           # MQA, G = 8
    (8, 16, 16, 64, 1024, [0, 31, 64, 100, 128, 160, 191, 1023]),
])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_ref_on_card(cuda_device, B, H, KV, D, L, curs,
                                    quantized, dtype):
    """The CUDA kernel against its plain version on the card: ragged
    per-row cursors, poisoned tails, every dtype the kernel takes."""
    q, k, v, ks, vs = poisoned_inputs(B, H, KV, L, D, curs, quantized,
                                      seed=B + H + D)
    args = _on_card(cuda_device, dtype, q, k, v, np.asarray(curs, np.int32),
                    ks, vs)
    before = port.launch_counts["decode_attention"]
    out = port.decode_attention(*args)
    torch.cuda.synchronize()
    assert port.launch_counts["decode_attention"] == before + 1
    ref = port.decode_attention_ref(*args)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)
    else:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_scalar_cursor_and_refusals_on_card(cuda_device):
    """A scalar cursor equals the same cursor per row; what the kernel
    does not take raises instead of running some other path."""
    q, k, v, _, _ = poisoned_inputs(2, 8, 2, 96, 64, 40, False, seed=1)
    tq, tk, tv, _, _, _ = _on_card(cuda_device, torch.bfloat16, q, k, v,
                                   np.int32(40), None, None)
    a = port.decode_attention(tq, tk, tv, 40)
    b = port.decode_attention(tq, tk, tv,
                              torch.full((2,), 40, dtype=torch.int32,
                                         device=cuda_device))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="contiguous"):
        port.decode_attention(tq, tk.transpose(2, 3).contiguous()
                              .transpose(2, 3), tv, 40)
    with pytest.raises(TypeError, match="must match q"):
        port.decode_attention(tq, tk.float(), tv.float(), 40)
    with pytest.raises(ValueError, match="head dim"):
        port.decode_attention(tq[..., :24].contiguous(),
                              tk[..., :24].contiguous(),
                              tv[..., :24].contiguous(), 40)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,D,ps,nblk,curs", [
    (4, 16, 16, 64, 64, 4, [0, 63, 64, 255]),       # page = tile
    (4, 32, 8, 64, 16, 8, [1, 15, 17, 127]),        # tiles span pages
    (4, 32, 8, 128, 8, 25, [0, 7, 64, 199]),
    (4, 8, 1, 64, 1, 96, [5, 0, 95, 64]),           # one position a page
    (10, 16, 16, 64, 16, 64,
     [0, 1, 15, 16, 17, 63, 64, 65, 1022, 1023]),
])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_kernel_matches_ref_and_contiguous_on_card(
        cuda_device, B, H, KV, D, ps, nblk, curs, quantized, dtype):
    """K5 against its plain version over a shuffled, partly shared,
    poisoned pool; then against K4 on the same logical cache, bit for
    bit."""
    q, kp, vp, ksp, vsp, table, (k, v, ks, vs) = paged_inputs(
        B, H, KV, D, ps, nblk, curs, quantized, seed=B + ps, share=True)
    args = _on_card(cuda_device, dtype, q, kp, vp, np.asarray(curs, np.int32),
                    ksp, vsp)
    pt = torch.from_numpy(table).to(cuda_device)
    before = port.launch_counts["paged_decode_attention"]
    out = port.paged_decode_attention(*args[:4], pt, *args[4:])
    torch.cuda.synchronize()
    assert port.launch_counts["paged_decode_attention"] == before + 1
    ref = port.paged_decode_attention_ref(*args[:4], pt, *args[4:])
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)
    else:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    contiguous = _on_card(cuda_device, dtype, q, k, v,
                          np.asarray(curs, np.int32), ks, vs)
    assert torch.equal(out, port.decode_attention(*contiguous))


@pytest.mark.cuda
def test_paged_refusals_on_card(cuda_device):
    """What K5 does not take raises instead of running some other path;
    a table entry outside the pool gives NaN, not a read outside it."""
    q, kp, vp, _, _, table, _ = paged_inputs(2, 8, 2, 64, 16, 4, [40, 63],
                                             False, seed=2, share=False)
    tq, tk, tv, cur, _, _ = _on_card(cuda_device, torch.bfloat16, q, kp, vp,
                                     np.asarray([40, 63], np.int32), None,
                                     None)
    pt = torch.from_numpy(table).to(cuda_device)
    with pytest.raises(TypeError, match="int32"):
        port.paged_decode_attention(tq, tk, tv, cur, pt.long())
    with pytest.raises(ValueError, match="page_table"):
        port.paged_decode_attention(tq, tk, tv, cur, pt[:1])
    with pytest.raises(ValueError, match="contiguous"):
        port.paged_decode_attention(tq, tk, tv, cur, pt.t().contiguous().t())
    bad = pt.clone()
    bad[1, 0] = tk.shape[0]
    out = port.paged_decode_attention(tq, tk, tv, cur, bad)
    torch.cuda.synchronize()
    assert torch.isfinite(out[0]).all() and torch.isnan(out[1]).all()
