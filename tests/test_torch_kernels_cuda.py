"""The port's CUDA attention kernels against their plain versions, on
the card: the decode kernels (K4 contiguous, K5 paged) and the flash
kernels of the training path (K1 forward, K2 dq, K3 dk/dv).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Without a card every test here skips (the kernel has no CPU mode; its
plain version is held against the JAX reference in
test_torch_decode_attention.py, test_torch_paged_attention.py and
test_torch_flash_attention.py), except the check that the K1-K3 limits
fail planted faults, which needs only the plain versions.
`poisoned_inputs` and `paged_inputs` are shared with those files: the
cache past each row's cursor holds POISON, and so does every page no
table entry maps (the trash page 0 among them), so a read past the
cursor or through a wrong page shows up as a huge error, not a lucky
zero.

Tolerances: bf16 atol 2e-2 + rtol 2e-2 (the kernel's online softmax
rounds p to bf16 against a running max, the plain version against the
row max: a few bf16 ulps at |out| ~ 1); f32 atol 1e-4 (summation order
only). K5 against K4 on the same logical cache: bit for bit (one kernel
body and one tile walk; only the row addresses differ). K1-K3 in bf16:
the relative error ||kernel - plain|| / ||plain|| of out, dq, dk and dv
(it scales with the outputs: |dq| is ~0.05 at the training shape) within
FLASH_REL. K1's online softmax rounds p to bf16 against a running max,
the plain version against the row max, so most p differ by up to half a
bf16 ulp; K2/K3 round ds as the plain version does after f32 sums in
another order, so they differ only where a sum crosses a bf16 rounding
boundary. Each limit lies below every planted fault's reading (a
skipped tile; ds left unrounded), which a test here checks; chip_smoke.py
prints both readings on the card. lse atol 1e-3 (f32 sums in another
order over up to 512 terms).
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


def _split_len(dev, B, KV, L, cache_dtype):
    """The split length the wrappers pass the decode kernel."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return port.decode_split_len(L, B * KV, sms,
                                 port.decode_tile(cache_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_split_edges_on_card(cuda_device, G, quantized, dtype):
    """K4 and K5 at cursors on the split boundaries (split length - 1,
    + 0 and + 1, twice that), at 1022 and 1023, and short rows whose
    later splits lie wholly past their cursor, for every G the kernel is
    built for: each against its plain version, K5 bit for bit against
    K4 (pages of 16), and each bit for bit across two launches."""
    B, KV, L, D = 8, 2, 1024, 64
    H = KV * G
    cache_dtype = torch.int8 if quantized else dtype
    c = _split_len(cuda_device, B, KV, L, cache_dtype)
    assert c < L, "the split policy should split this cache"
    curs = [c - 1, c, c + 1, 2 * c - 1, 2 * c, 1022, 1023, 5]
    q, kp, vp, ksp, vsp, table, (k, v, ks, vs) = paged_inputs(
        B, H, KV, D, 16, L // 16, curs, quantized, seed=G, share=True)
    args = _on_card(cuda_device, dtype, q, k, v, np.asarray(curs, np.int32),
                    ks, vs)
    out = port.decode_attention(*args)
    torch.cuda.synchronize()
    ref = port.decode_attention_ref(*args)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)
    else:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    assert torch.equal(out, port.decode_attention(*args))
    pargs = _on_card(cuda_device, dtype, q, kp, vp,
                     np.asarray(curs, np.int32), ksp, vsp)
    pt = torch.from_numpy(table).to(cuda_device)
    paged = port.paged_decode_attention(*pargs[:4], pt, *pargs[4:])
    assert torch.equal(paged, out)
    assert torch.equal(paged, port.paged_decode_attention(*pargs[:4], pt,
                                                          *pargs[4:]))


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [64, 16])
@pytest.mark.parametrize("quantized", [False, True])
def test_paged_equals_contiguous_long_cursors_on_card(cuda_device, ps,
                                                      quantized):
    """K5 bit for bit against K4 on the gathered cache at long cursors
    (896..1023, every split of every row live), gpt2-medium's head
    layout, and both against the plain version."""
    B, H, KV, D, L = 8, 16, 16, 64, 1024
    curs = np.random.RandomState(ps).randint(896, 1024, B).tolist()
    q, kp, vp, ksp, vsp, table, (k, v, ks, vs) = paged_inputs(
        B, H, KV, D, ps, L // ps, curs, quantized, seed=ps, share=True)
    args = _on_card(cuda_device, torch.bfloat16, q, k, v,
                    np.asarray(curs, np.int32), ks, vs)
    out = port.decode_attention(*args)
    torch.testing.assert_close(out.float(),
                               port.decode_attention_ref(*args).float(),
                               atol=2e-2, rtol=2e-2)
    pargs = _on_card(cuda_device, torch.bfloat16, q, kp, vp,
                     np.asarray(curs, np.int32), ksp, vsp)
    pt = torch.from_numpy(table).to(cuda_device)
    assert torch.equal(port.paged_decode_attention(*pargs[:4], pt,
                                                   *pargs[4:]), out)


@pytest.mark.cuda
def test_decode_workspace_regrows_on_card(cuda_device):
    """The cached workspace gives the same bits for one call before and
    after a smaller and then a larger shape (which grows it); its
    tickets are left at 0 after every launch."""
    def run(B, KV, L, seed):
        curs = np.random.RandomState(seed).randint(0, L, B).tolist()
        q, k, v, _, _ = poisoned_inputs(B, KV * 2, KV, L, 64, curs, False,
                                        seed=seed)
        return port.decode_attention(*_on_card(
            cuda_device, torch.bfloat16, q, k, v,
            np.asarray(curs, np.int32), None, None))
    first = run(4, 4, 1024, 0)
    run(2, 2, 256, 1)
    run(16, 8, 2048, 2)
    again = run(4, 4, 1024, 0)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    _, tickets = port.decode_workspace(cuda_device, 1, 1, 1, 1, 16)
    assert not tickets.any()


@pytest.mark.parametrize("L,bkv,sms,tile,chunk", [
    (1024, 128, 132, 64, 512),   # gpt2-medium heads, B=8: contiguous serving
    (1024, 64, 132, 64, 256),    # llama-1b heads, B=8
    (384, 128, 132, 64, 384),    # the paged serving phase's max_len: no split
    (1024, 16, 132, 32, 64),     # f32 cache tiles
    (4096, 8, 132, 64, 128),     # one llama-1b row, a long cache
    (64, 2048, 132, 64, 64),     # more rows than the card has SMs
    (1, 1, 132, 64, 64),
    (100, 3, 7, 32, 128),
])
def test_decode_split_len_policy(L, bkv, sms, tile, chunk):
    """The split policy: whole tiles that cover [0, L) with no empty
    split; when it splits, no split under `decode_min_split_tiles`;
    splits x B*KV reaching the SM count whenever the cache has enough
    tiles for that; no cursor among its inputs (it is computed on the
    host, where the cursors of an async decode step are not); and the
    lengths the H100 sweep chose at the shapes the serving phases run."""
    import inspect
    assert list(inspect.signature(port.decode_split_len).parameters) == \
        ["L", "bkv", "sms", "tile"]
    got = port.decode_split_len(L, bkv, sms, tile)
    assert got == chunk
    splits = -(-L // got)
    assert got % tile == 0 and got >= tile
    assert (splits - 1) * got < L <= splits * got
    n_tiles = -(-L // tile)
    min_tiles = port.decode_min_split_tiles(bkv, sms)
    assert splits == 1 or got >= min_tiles * tile
    if n_tiles >= min_tiles * -(-sms // bkv):
        assert splits * bkv >= sms
    assert splits <= n_tiles
    with pytest.raises(ValueError):
        port.decode_split_len(0, bkv, sms, tile)


FLASH_CASES = {
    # the training shape: gpt2-medium heads, B=16 x 512 tokens, causal
    "gpt2-medium": dict(B=16, S=512, H=16, D=64, causal=True, mask=None),
    # llama-1b's head layout after the K/V repeat
    "llama-1b": dict(B=4, S=512, H=32, D=64, causal=True, mask=None),
    # key padding, one batch row with no valid key at all
    "masked": dict(B=4, S=256, H=4, D=64, causal=False, mask="empty"),
    "masked-causal": dict(B=4, S=256, H=4, D=64, causal=True, mask="pad"),
    # a ragged S: the kernels mask the tail tile themselves
    "ragged": dict(B=2, S=500, H=4, D=64, causal=True, mask=None),
    "ragged-masked": dict(B=2, S=77, H=2, D=64, causal=False, mask="pad"),
    # D=128: two 64-column boxes a tile; K1 and K2 walk 64-key tiles
    # under 128-query CTAs, K3 32-query tiles under 128 keys
    "unequal-tiles": dict(B=2, S=320, H=4, D=128, causal=True, mask=None),
    "unequal-tiles-ragged": dict(B=2, S=200, H=2, D=128, causal=False,
                                 mask="empty"),
    "small-head": dict(B=2, S=96, H=2, D=32, causal=True, mask=None),
}


def flash_inputs(B, S, H, D, mask, seed=0, device="cpu"):
    """bf16 q, k, v, do [B, S, H, D] and an optional [B, S] bool key mask
    (row 0 padded after 3/4 of S; "empty": row 1 masked everywhere)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen, device=device)
                   .bfloat16() for _ in range(4))
    m = None
    if mask is not None:
        m = torch.ones(B, S, dtype=torch.bool, device=device)
        m[0, (3 * S) // 4:] = False
        if mask == "empty":
            m[1] = False
    return q, k, v, do, m


# the relative error limits of K1-K3 in bf16 (the same as chip_smoke.py's)
FLASH_REL = {"flash_fwd": 4e-3, "flash_dq": 4e-4, "flash_dkv": 4e-4}
# the tile each kernel walks at D <= 64, the unit a skipped-tile fault
# drops: K1's and K2's k-tiles of 128 keys, K3's q-tiles of 64
FLASH_TILE = {"flash_fwd": 128, "flash_dq": 128, "flash_dkv": 64}


def rel_err(got, want) -> float:
    """||got - want|| / ||want|| over the whole tensor, in f32."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def flash_against_plain(q, k, v, do, m, causal):
    """Each kernel against its plain version on the same inputs (K2/K3
    given the plain forward's lse and delta); returns {name: relative
    error} after asserting the limits above. With one key (S=1) the
    softmax has no gradient with respect to the score: dq and dk are
    f32 rounding noise of dp - delta on both sides, so they are held to
    an absolute bound instead."""
    errs = {}
    out, lse = port.flash_fwd(q, k, v, causal, m)
    torch.cuda.synchronize()
    ref_out, ref_lse = port.flash_fwd_ref(q, k, v, causal, m)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    delta = port.flash_delta(ref_out, do)
    dq = port.flash_dq(q, k, v, do, ref_lse, delta, causal, m)
    dk, dv = port.flash_dkv(q, k, v, do, ref_lse, delta, causal, m)
    torch.cuda.synchronize()
    ref_dq = port.flash_dq_ref(q, k, v, do, ref_lse, delta, causal, m)
    ref_dk, ref_dv = port.flash_dkv_ref(q, k, v, do, ref_lse, delta,
                                        causal, m)
    for name, got, want in (("flash_fwd", out, ref_out),
                            ("flash_dq", dq, ref_dq), ("flash_dkv", dk, ref_dk),
                            ("flash_dkv", dv, ref_dv)):
        assert torch.isfinite(got).all(), name
        if q.shape[1] == 1 and got is not out and got is not dv:
            assert float(got.abs().max()) <= 1e-4, name
            assert float(want.abs().max()) <= 1e-4, name
            continue
        rel = rel_err(got, want)
        assert rel <= FLASH_REL[name], (name, rel)
        errs[name] = max(errs.get(name, 0.0), rel)
    return errs


@pytest.mark.parametrize("causal", [True, False])
def test_flash_limits_fail_planted_faults(causal):
    """Each relative error limit fails a kernel with a planted fault,
    made from the plain versions on the CPU: one tile skipped (the
    smallest reading over every tile: a k-tile's keys masked for K1/K2,
    a q-tile's do and delta zeroed for K3) and, for K2/K3, ds left
    unrounded (the plain versions on f32 copies, outputs rounded to
    bf16)."""
    B, S, H, D = 2, 256, 4, 64
    q, k, v, do, _ = flash_inputs(B, S, H, D, None, seed=9)
    out, lse = port.flash_fwd_ref(q, k, v, causal)
    delta = port.flash_delta(out, do)
    dq = port.flash_dq_ref(q, k, v, do, lse, delta, causal)
    dk, dv = port.flash_dkv_ref(q, k, v, do, lse, delta, causal)
    readings = {"flash_fwd": [], "flash_dq": [], "flash_dkv": []}

    def keys_off(j, tile):
        keys = torch.ones(B, S, dtype=torch.bool)
        keys[:, j:j + tile] = False
        return keys
    for j in range(0, S, FLASH_TILE["flash_fwd"]):
        readings["flash_fwd"].append(rel_err(port.flash_fwd_ref(
            q, k, v, causal, keys_off(j, FLASH_TILE["flash_fwd"]))[0], out))
    for j in range(0, S, FLASH_TILE["flash_dq"]):
        readings["flash_dq"].append(rel_err(port.flash_dq_ref(
            q, k, v, do, lse, delta, causal,
            keys_off(j, FLASH_TILE["flash_dq"])), dq))
    tile = FLASH_TILE["flash_dkv"]
    for j in range(0, S, tile):
        d, dl = do.clone(), delta.clone()
        d[:, j:j + tile], dl[:, :, j:j + tile] = 0, 0
        a, b = port.flash_dkv_ref(q, k, v, d, lse, dl, causal)
        readings["flash_dkv"].append(max(rel_err(a, dk), rel_err(b, dv)))
    f32 = [x.float() for x in (q, k, v, do)]
    readings["flash_dq"].append(rel_err(
        port.flash_dq_ref(*f32, lse, delta, causal).bfloat16(), dq))
    readings["flash_dkv"].append(rel_err(
        port.flash_dkv_ref(*f32, lse, delta, causal)[0].bfloat16(), dk))
    for name, rs in readings.items():
        assert min(rs) > FLASH_REL[name], (name, rs)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_kernels_match_plain_on_card(cuda_device, case):
    """K1, K2 and K3 against their plain versions, one launch each."""
    c = dict(FLASH_CASES[case])
    causal, mask = c.pop("causal"), c.pop("mask")
    q, k, v, do, m = flash_inputs(**c, mask=mask, seed=len(case),
                                  device=cuda_device)
    before = {n: port.launch_counts[n]
              for n in ("flash_fwd", "flash_dq", "flash_dkv")}
    flash_against_plain(q, k, v, do, m, causal)
    assert {n: port.launch_counts[n] - before[n] for n in before} == \
        {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    if mask == "empty":
        out, _ = port.flash_fwd(q, k, v, causal, m)
        assert torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["k-major", "mn-major"])
@pytest.mark.parametrize("D", [16, 64, 80, 128])
def test_wgmma_layouts_on_card(cuda_device, layout, D):
    """The two wgmma operand layouts K1 and K3 are built on, through the
    layout probe (K1's TMA maps, descriptors and wgmma wrappers) against
    torch.matmul: K-major for q.k^T (the score products), MN-major for
    bf16(s).v (p.v; K3's p^T.do and ds^T.q read the same way). Both sides
    sum exact bf16 products in f32, in another order."""
    gen = torch.Generator(device=cuda_device).manual_seed(D)
    bk = 128 if D <= 64 else 64
    q = torch.randn(1, 64, 1, D, generator=gen,
                    device=cuda_device).bfloat16()
    k, v = (torch.randn(1, bk, 1, D, generator=gen, device=cuda_device)
            .bfloat16() for _ in range(2))
    s, o = port.wgmma_probe(q, k, v)
    torch.cuda.synchronize()
    if layout == "k-major":
        got, want = s, q[0, :, 0].float() @ k[0, :, 0].float().T
    else:
        got, want = o, s.bfloat16().float() @ v[0, :, 0].float()
    assert rel_err(got, want) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 48, 64, 80, 96, 112, 128])
def test_flash_every_head_dim_on_card(cuda_device, D):
    """Every head dim the wrapper takes, causal and with the pad mask:
    K1-K3 read D <= 64 through one 64-column box and D > 64 through two,
    the columns past D arriving as zeros. S=200 ends inside a tile at
    every D."""
    for causal, mask in ((True, None), (False, "pad")):
        q, k, v, do, m = flash_inputs(2, 200, 3, D, mask, seed=D,
                                      device=cuda_device)
        flash_against_plain(q, k, v, do, m, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 63, 65, 127, 129, 500, 512])
def test_flash_tile_edges_on_card(cuda_device, S, causal):
    """S at the tiles' edges: K1's and K2's 128-query CTAs and 128-key
    tiles, K3's 128-key CTAs and 64-query tiles. Rows past S arrive as
    zeros and are masked in the kernels."""
    q, k, v, do, m = flash_inputs(2, S, 4, 64, None, seed=S,
                                  device=cuda_device)
    flash_against_plain(q, k, v, do, m, causal)


@pytest.mark.cuda
def test_flash_fully_masked_row_on_card(cuda_device):
    """A row whose keys are all masked: K1 gives the mean of v over the
    keys (the reference's online softmax over uniform -1e30 scores,
    p = 1 exactly), and K2/K3 give it no gradient (they re-mask p)."""
    q, k, v, do, m = flash_inputs(4, 256, 4, 64, "empty", seed=11,
                                  device=cuda_device)
    out, lse = port.flash_fwd(q, k, v, False, m)
    mean = v[1].float().mean(0, keepdim=True).expand_as(out[1])
    torch.testing.assert_close(out[1].float(), mean, atol=1e-3, rtol=0)
    delta = port.flash_delta(out, do)
    dq = port.flash_dq(q, k, v, do, lse, delta, False, m)
    dk, dv = port.flash_dkv(q, k, v, do, lse, delta, False, m)
    torch.cuda.synchronize()
    assert not dq[1].any() and not dk[1].any() and not dv[1].any()
    assert dq[0].any() and dk[0].any() and dv[0].any()


@pytest.mark.cuda
def test_flash_fwd_and_dkv_repeat_bitwise_on_card(cuda_device):
    """Two launches of K1, of K2 and of K3 at the training shape give
    the same bits: every output tile has one owner and sums in one
    order."""
    q, k, v, do, _ = flash_inputs(16, 512, 16, 64, None, seed=4,
                                  device=cuda_device)
    out, lse = port.flash_fwd(q, k, v, True)
    out2, lse2 = port.flash_fwd(q, k, v, True)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    delta = port.flash_delta(out, do)
    assert torch.equal(port.flash_dq(q, k, v, do, lse, delta, True),
                       port.flash_dq(q, k, v, do, lse, delta, True))
    first = port.flash_dkv(q, k, v, do, lse, delta, True)
    second = port.flash_dkv(q, k, v, do, lse, delta, True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_flash_autograd_and_repeatability_on_card(cuda_device):
    """flash_attention's autograd gradients equal the kernels called
    directly, bit for bit, and two runs give the same bits (every output
    tile has one owner: no atomics)."""
    q, k, v, do, _ = flash_inputs(2, 192, 4, 64, None, seed=5,
                                  device=cuda_device)
    grads = []
    for _ in range(2):
        tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
        out = port.flash_attention(tq, tk, tv, causal=True)
        out.backward(do)
        grads.append((out.detach(), tq.grad, tk.grad, tv.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    out, lse = port.flash_fwd(q, k, v, True)
    delta = port.flash_delta(out, do)
    assert torch.equal(grads[0][1], port.flash_dq(q, k, v, do, lse, delta))
    dk, dv = port.flash_dkv(q, k, v, do, lse, delta)
    assert torch.equal(grads[0][2], dk) and torch.equal(grads[0][3], dv)


@pytest.mark.cuda
def test_flash_refusals_on_card(cuda_device):
    """What the flash kernels do not take raises instead of running some
    other path."""
    q, k, v, do, _ = flash_inputs(1, 64, 2, 64, None, device=cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        port.flash_fwd(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="contiguous"):
        port.flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="head dim"):
        port.flash_fwd(q[..., :24].contiguous(), k[..., :24].contiguous(),
                       v[..., :24].contiguous())
    with pytest.raises(ValueError, match="one shape"):
        port.flash_fwd(q, k[:, :, :1].contiguous(), v)


@pytest.mark.cuda
def test_f32_training_on_card_raises(cuda_device):
    """attention="auto" is flash on a CUDA tensor whatever its dtype: an
    f32 run on the card reaches K1's launch check and raises, instead of
    training through the plain dense path."""
    from mpi_operator_tpu_torch.examples.lm_benchmark import run_lm_benchmark
    before = dict(port.launch_counts)
    with pytest.raises(TypeError, match="bf16"):
        run_lm_benchmark(workload="gpt2", size="test", batch_per_device=2,
                         seq_len=64, num_steps=1, warmup_steps=1,
                         dtype_name="float32", log=lambda line: None)
    assert port.launch_counts == before
