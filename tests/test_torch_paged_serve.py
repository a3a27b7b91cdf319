"""The port's paged serving engine against the JAX paged engine and the
port's contiguous engine.

Same weights on every side (params_from_flax, the model `_pair` of
test_torch_serve.py: gpt2-test, f32, vocab 64, max_len 64). Four slots,
chunk buckets (4, 8), pages of 8 positions. Greedy traces must be
TOKEN-EXACT against the JAX paged engine (dense attention, the path the
JAX suite pins its kernel to) and against the port's contiguous engine,
with the port on its dense path and through its paged-kernel dispatch
(whose CPU form is K5's plain version), with the cache in f32 and int8:
a mixed trace with slot and page reuse, EOS retirement, a prefix hit
that skips prefill, a divergence inside a page (copy-on-write), and more
concurrency than the contiguous engine at equal cache bytes. Logprobs
against the JAX engine: atol 1e-4 (f32; summation order only). After
every run the allocator holds no page and passes its audit.
"""
import functools

import numpy as np
import pytest
import torch
from test_torch_serve import _pair

from mpi_operator_tpu.serve import EngineConfig as JEngineConfig
from mpi_operator_tpu.serve import ServingEngine as JServingEngine
from mpi_operator_tpu_torch.models import transformer as tt
from mpi_operator_tpu_torch.serve import EngineConfig, Request, ServingEngine

V = 64
PS = 8


@functools.lru_cache(maxsize=None)
def _models(kv=None):
    return _pair("gpt2", kv)


def _engine(tm, kernel, paged=True, slots=4, **kw):
    if paged:
        kw = dict(paged=True, page_size=PS, **kw)
    return ServingEngine(tm, EngineConfig(
        slots=slots, chunk_buckets=(4, 8), decode_kernel=kernel, **kw),
        device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_paged(kv=None):
    jm, params, _ = _models(kv)
    return JServingEngine(jm, params, JEngineConfig(
        slots=4, chunk_buckets=(4, 8), decode_kernel=False, paged=True,
        page_size=PS))


def _run(engine, trace):
    """Run `trace` and audit the page allocator afterwards."""
    results = engine.run(trace)
    if engine.page_allocator is not None:
        engine.page_allocator.check()
        assert engine.page_allocator.in_use == 0
    return results


def _mixed_trace(seed=7, eos=None):
    rs = np.random.RandomState(seed)
    lens = [(1, 6), (3, 9), (9, 4), (14, 7), (5, 5), (7, 8), (12, 6),
            (2, 7)]
    return [Request(i, [int(t) for t in rs.randint(0, V, (p,))],
                    max_new_tokens=m, eos_id=eos)
            for i, (p, m) in enumerate(lens)]


def _same_tokens(got, *wants):
    for want in wants:
        assert set(got) == set(want)
        for rid in want:
            assert got[rid].tokens == want[rid].tokens, f"request {rid}"
            assert got[rid].finish_reason == want[rid].finish_reason


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("kernel", [False, True])
def test_paged_token_exact_vs_jax_paged_and_contiguous(kernel, kv):
    """Eight requests over four slots: batched paged prefill (members
    and non-members of a bucket in one call), slot and page reuse, free
    rows writing into the trash page."""
    _, _, tm = _models(kv)
    trace = _mixed_trace()
    got = _run(_engine(tm, kernel), trace)
    jeng = _jax_paged(kv)
    jeng.reset()
    theirs = jeng.run(trace)
    _same_tokens(got, theirs, _run(_engine(tm, kernel, paged=False), trace))
    for r in trace:
        np.testing.assert_allclose(got[r.id].logprobs, theirs[r.id].logprobs,
                                   atol=1e-4)


@pytest.mark.parametrize("kernel", [False, True])
def test_paged_eos_retirement_reuses_pages(kernel):
    """EOS mid-flight under async decode: retired requests release pages
    that later arrivals take, while the retired row's junk step is still
    in flight; tokens match the JAX paged engine and the contiguous
    engine."""
    _, _, tm = _models()
    contiguous = _engine(tm, kernel, paged=False)
    eos = _run(contiguous, _mixed_trace()[:1])[0].tokens[2]
    contiguous.reset()
    trace = _mixed_trace(eos=eos)
    got = _run(_engine(tm, kernel), trace)
    assert any(r.finish_reason == "eos" for r in got.values())
    jeng = _jax_paged()
    jeng.reset()
    _same_tokens(got, jeng.run(trace), _run(contiguous, trace))


def _count_prefills(engine):
    calls = []
    inner = engine._prefill_batched
    engine._prefill_batched = lambda *a: (calls.append(1), inner(*a))[1]
    return calls


@pytest.mark.parametrize("kernel", [False, True])
def test_prefix_hit_skips_prefill_token_exact(kernel):
    """A request sharing a cached 40-token prefix (5 full pages) admits
    with cached_tokens == 40, pins 5 pages and runs fewer prefill calls
    than the cold one; both match the JAX paged engine and the
    contiguous engine. With prefix_cache=False nothing is published:
    the second request prefills cold, with the same tokens."""
    _, _, tm = _models()
    rs = np.random.RandomState(3)
    shared = [int(t) for t in rs.randint(0, V, (40,))]
    cold = Request(0, shared + [int(t) for t in rs.randint(0, V, (3,))], 6)
    hot = Request(1, shared + [int(t) for t in rs.randint(0, V, (3,))], 6)
    paged = _engine(tm, kernel)
    calls = _count_prefills(paged)
    got0 = _run(paged, [cold])
    n_cold = len(calls)
    got1 = _run(paged, [hot])
    n_hot = len(calls) - n_cold
    assert got0[0].cached_tokens == 0 and got1[1].cached_tokens == 40
    assert paged.page_allocator.hits == 5
    assert paged.page_allocator.cached_pages == 5     # parked, matchable
    assert 0 < n_hot < n_cold
    jeng = _jax_paged()
    jeng.reset()
    contiguous = _engine(tm, kernel, paged=False)
    for req, got in ((cold, got0), (hot, got1)):
        _same_tokens(got, jeng.run([req]), _run(contiguous, [req]))
    pure = _engine(tm, kernel, prefix_cache=False)
    calls = _count_prefills(pure)
    _run(pure, [cold])
    again = _run(pure, [hot])
    assert again[1].cached_tokens == 0 and pure.page_allocator.hits == 0
    assert pure.page_allocator.cached_pages == 0
    assert len(calls) == 2 * n_cold
    _same_tokens(again, got1)


def test_prefix_divergence_inside_a_page_is_copy_on_write():
    """Two prompts equal through page 2, diverging INSIDE page 3: the
    hit stops at the divergence page, which stays private; replaying the
    first prompt still hits its own untouched chain. All three runs match
    the JAX paged engine's and the contiguous engine's."""
    _, _, tm = _models()
    rs = np.random.RandomState(13)
    head = [int(t) for t in rs.randint(0, V, (16,))]
    a = Request(0, head + [int(t) for t in rs.randint(0, V, (7,))], 5)
    b = Request(1, head + [int(t) for t in rs.randint(0, V, (7,))], 5)
    paged = _engine(tm, True)
    contiguous = _engine(tm, True, paged=False)
    got_a, got_b = _run(paged, [a]), _run(paged, [b])
    assert got_b[1].cached_tokens == 16
    replay = _run(paged, [a])
    assert replay[0].cached_tokens == 16
    jeng = _jax_paged()
    jeng.reset()
    theirs = [jeng.run([a]), jeng.run([b]), jeng.run([a])]
    _same_tokens(got_a, _run(contiguous, [a]), replay, theirs[0], theirs[2])
    _same_tokens(got_b, _run(contiguous, [b]), theirs[1])


def test_paged_capacity_beats_contiguous_at_equal_bytes():
    """Two contiguous rows of max_len 64 against 16 (+1 trash) pages of
    8: six short requests (2 pages each) run six at a time in the pool,
    two at a time in the rows, with the same tokens."""
    _, _, tm = _models()
    reqs = [Request(i, [int(t) for t in
                        np.random.RandomState(i).randint(0, V, (6,))],
                    max_new_tokens=6) for i in range(6)]
    contiguous = _engine(tm, False, paged=False, slots=2)
    want = _run(contiguous, reqs)
    assert contiguous.occupancy_peak == 2
    wide = _engine(tm, True, slots=6, num_pages=2 * (64 // PS) + 1)
    _same_tokens(_run(wide, reqs), want)
    assert wide.occupancy_peak > 2
    assert wide.pages_in_use_peak <= 2 * (64 // PS)


def test_unservable_request_raises():
    """A worst-case span larger than the whole pool can never admit:
    submit refuses it up front instead of livelocking the queue."""
    _, _, tm = _models()
    paged = _engine(tm, False, num_pages=4)           # 3 usable pages
    with pytest.raises(ValueError, match="KV pages"):
        paged.run([Request(0, [1] * 20, max_new_tokens=20)])


def test_no_real_page_written_by_two_rows_in_one_call(monkeypatch):
    """Every call's scatter targets, over a trace with prefix hits and
    batched prefill: a page other than the trash page 0 is written by at
    most one row of the call, so no two rows race on a real page."""
    _, _, tm = _models()
    seen = []

    def recording(table, pos, page_size, max_len):
        index = tt_page_index(table, pos, page_size, max_len)
        rows = np.broadcast_to(np.arange(pos.shape[0])[:, None], pos.shape)
        seen.append((np.asarray(index.page).ravel(), rows.ravel()))
        return index
    tt_page_index = tt.page_index_device
    monkeypatch.setattr(tt, "page_index_device", recording)
    rs = np.random.RandomState(5)
    shared = [int(t) for t in rs.randint(0, V, (24,))]
    trace = _mixed_trace() + [
        Request(10 + i, shared + [int(t) for t in rs.randint(0, V, (n,))],
                max_new_tokens=m) for i, (n, m) in enumerate(
                    [(5, 6), (9, 4), (2, 20), (7, 8), (30, 3)])]
    _run(_engine(tm, True), trace)
    assert len(seen) > 20
    for page, rows in seen:
        for p in np.unique(page[page != 0]):
            assert len(np.unique(rows[page == p])) == 1, f"page {p}"


def test_prefill_beside_a_row_near_max_len(monkeypatch):
    """A batched prefill while another row decodes near max_len: that
    row runs the chunk at its own cursor, past max_len, where its writes
    go to the trash page and its position lookups stay in the table;
    every request still matches the contiguous engine."""
    _, _, tm = _models()
    dropped = []

    def recording(table, pos, page_size, max_len):
        index = tt_page_index(table, pos, page_size, max_len)
        past = pos >= max_len
        dropped.append(int(past.sum()))
        assert not index.page[past].any()          # all to the trash page
        return index
    tt_page_index = tt.page_index_device
    monkeypatch.setattr(tt, "page_index_device", recording)
    rs = np.random.RandomState(4)
    trace = [Request(i, [int(t) for t in rs.randint(0, V, (p,))], m)
             for i, (p, m) in enumerate([(2, 61), (2, 55), (20, 6)])]
    got = _run(_engine(tm, True, slots=2), trace)
    assert sum(dropped) > 0
    _same_tokens(got, _run(_engine(tm, True, paged=False, slots=2), trace))


def test_page_index_drops_positions_past_max_len():
    """A write at a position >= max_len is dropped, never clamped (a
    clamped write could land in a shared prefix page): the kept
    positions resolve through the table to (page, slot), in order."""
    table = np.array([[3, 5], [7, 0]], np.int32)           # max_len 16
    pos = torch.tensor([[6, 7, 8, 9], [13, 14, 15, 16]])
    index = tt.page_index(table, pos, 8, 16, "cpu")
    assert index.table.dtype == torch.int32
    assert index.src.tolist() == [[0, 0, 0, 0, 1, 1, 1], [0, 1, 2, 3, 0,
                                                          1, 2]]
    assert index.page.tolist() == [3, 3, 5, 5, 0, 0, 0]
    assert index.slot.tolist() == [6, 7, 0, 1, 5, 6, 7]
    full = tt.page_index(table, pos[:, :1], 8, 16, "cpu")
    assert full.src is None and full.page.tolist() == [[3], [0]]
