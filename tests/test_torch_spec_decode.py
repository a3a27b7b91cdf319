"""The port's speculative decoding (serve/engine.py: propose_ngram, the
verify program, greedy acceptance) against the JAX engine's, on the CPU.

The cases of tests/test_spec_decode.py, each run through both engines
over the same weights (`_pair` of test_torch_serve.py: gpt2-test, f32,
vocab 64, max_len 64), four slots, chunk buckets (4, 8), ngram drafting
unless a drafter is named. The contract: speculation changes WHEN
tokens are computed, never WHICH — greedy tokens equal the JAX
speculative engine's and the port's own no-spec rerun, through the
dense path, the decode kernel's plain version (K4) and the paged
kernel's (K5), with f32 and int8 caches. On the same trace the port's
spec_stats() and program counts (verify included) equal the JAX
engine's. Sampled rows ride the verify steps in column 0: they are held
to their top-k support and to replay after reset(). Hazard H9: a row
whose verify window crosses max_len sends its padded columns to the
trash row (contiguous) or trash page (paged), with every host read of a
tensor inside a program made to raise.
"""
import functools

import numpy as np
import pytest
import torch
from test_torch_serve import _oracle, _pair
from test_torch_serve_programs import _no_host_reads

from mpi_operator_tpu.serve import EngineConfig as JEngineConfig
from mpi_operator_tpu.serve import ServingEngine as JServingEngine
from mpi_operator_tpu.serve import propose_ngram as jax_propose_ngram
from mpi_operator_tpu_torch.examples.serve_benchmark import _latency_fields
from mpi_operator_tpu_torch.serve import (
    EngineConfig, Request, Scheduler, ServingEngine, SlotManager,
    propose_ngram,
)
from mpi_operator_tpu_torch.serve import programs

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

V, L = 64, 64
PAGED = dict(paged=True, page_size=8)


@functools.lru_cache(maxsize=None)
def _models(kernel=False, kv=None):
    return _pair("gpt2", kv, kernel)


def _engines(kernel=False, kv=None, drafter=None, **kw):
    """(port engine, JAX engine) over the same weights and settings; the
    JAX engine runs its dense path (the programs it builds are the same
    with its Pallas kernel, which interpret mode would only slow)."""
    jm, params, tm = _models(kernel, kv)
    cfg = {"slots": 4, "chunk_buckets": (4, 8), "speculative": "ngram", **kw}
    return (ServingEngine(tm, EngineConfig(decode_kernel=kernel, **cfg),
                          device="cpu", drafter=drafter),
            JServingEngine(jm, params, JEngineConfig(decode_kernel=False,
                                                     **cfg),
                           drafter=drafter))


def _trace(seed=11, n=8, sampled=False):
    """tests/test_spec_decode.py::_trace: 8 requests over 4 slots, so
    the second wave reuses retired rows."""
    rs = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        temp = 0.9 if (sampled and i % 2) else 0.0
        p = int(rs.choice([2, 5, 9, 13]))
        reqs.append(Request(i, [int(t) for t in rs.randint(0, V, (p,))],
                            max_new_tokens=int(rs.choice([5, 8, 12])),
                            temperature=temp, top_k=4 if temp else 0))
    return reqs


def _nospec_rerun(engine, reqs):
    """Replay `reqs` through the same engine with speculation off."""
    mode = engine.config.speculative
    engine.config.speculative = None
    engine.reset()
    try:
        return engine.run(reqs)
    finally:
        engine.config.speculative = mode


def _same(got, *wants, ids=None):
    for want in wants:
        for rid in (ids if ids is not None else want):
            assert got[rid].tokens == want[rid].tokens, f"request {rid}"
            assert got[rid].finish_reason == want[rid].finish_reason


# ---------------------------------------------------------------------------
# propose_ngram and rewind (host code)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("history,k,want", [
    ([1, 2, 3, 4, 1, 2, 3], 3, [4, 1, 2]),
    ([7, 5, 6, 9, 5, 6, 8, 5, 6], 2, [8, 5]),
    ([1, 2, 1, 2], 5, [1, 2]),
    ([1, 2, 3, 4], 4, []), ([1], 4, []), ([1, 1, 1], 0, [])],
    ids=["after-match", "most-recent", "history-end", "novel", "short",
         "k0"])
def test_propose_ngram_cases(history, k, want):
    """tests/test_spec_decode.py's four propose_ngram tests."""
    assert propose_ngram(history, k) == want
    assert jax_propose_ngram(history, k) == want


def test_propose_ngram_equals_jax_on_seeded_histories():
    """500 seeded histories over small alphabets (so suffixes repeat),
    every k and n-gram cap: the same proposal as the JAX function."""
    rs = np.random.RandomState(0)
    for _ in range(500):
        hist = rs.randint(0, int(rs.randint(2, 6)),
                          int(rs.randint(0, 40))).tolist()
        k, n = int(rs.randint(0, 6)), int(rs.randint(1, 5))
        assert propose_ngram(hist, k, n) == jax_propose_ngram(hist, k, n)


def _bound_state():
    m = SlotManager(2)
    s = Scheduler((4,), max_len=64)
    s.submit(Request(0, list(range(1, 7)), 8))
    st, = s.admit(m.free, now=0.0)
    m.bind(st)
    return m, st


def test_rewind_moves_validates_and_guards_published_pages():
    """tests/test_spec_decode.py's rewind tests on the port's copy."""
    m, st = _bound_state()
    st.pos = 10
    m.rewind(st.slot, 3)
    assert st.pos == 7
    m.rewind(st.slot, 0)
    assert st.pos == 7
    with pytest.raises(ValueError, match="negative"):
        m.rewind(st.slot, -1)
    with pytest.raises(ValueError, match="< 0"):
        m.rewind(st.slot, 8)
    with pytest.raises(ValueError, match="free slot"):
        m.rewind(1 - st.slot, 1)
    st.pos, st.published_pages = 20, 1
    m.rewind(st.slot, 11, page_size=8)           # 20 -> 9, across 16
    assert st.pos == 9
    st.pos, st.published_pages = 20, 2
    m.rewind(st.slot, 4, page_size=8)
    assert st.pos == 16
    with pytest.raises(ValueError, match="un-publish"):
        m.rewind(st.slot, 1, page_size=8)


# ---------------------------------------------------------------------------
# greedy exactness and the counters, against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,kw", [
    (False, {}), (True, {}), (False, PAGED), (True, PAGED)],
    ids=["dense", "kernel", "paged", "paged-kernel"])
def test_spec_greedy_token_exact_vs_jax_and_nospec(kernel, kw):
    """Greedy tokens equal the JAX speculative engine's and the port's
    no-spec rerun (logprobs atol 1e-5 against it: f32, the verify and
    the plain step sum in other orders); spec_stats() and every program
    count equal the JAX engine's."""
    ours, theirs = _engines(kernel, **kw)
    reqs = _trace()
    spec = ours.run(reqs)
    want = theirs.run(reqs)
    assert ours.spec_stats()["proposed"] > 0
    assert ours.spec_stats() == theirs.spec_stats()
    assert ours.compile_counts() == theirs.compile_counts()
    base = _nospec_rerun(ours, reqs)
    _same(spec, want, base)
    for r in reqs:
        np.testing.assert_allclose(spec[r.id].logprobs, base[r.id].logprobs,
                                   atol=1e-5)
        np.testing.assert_allclose(spec[r.id].logprobs, want[r.id].logprobs,
                                   atol=1e-4)


@pytest.mark.parametrize("kw", [{}, PAGED], ids=["contiguous", "paged"])
def test_spec_int8_cache_token_exact(kw):
    ours, theirs = _engines(kv="int8", **kw)
    reqs = _trace(seed=17)
    spec = ours.run(reqs)
    want = theirs.run(reqs)
    assert ours.spec_stats()["proposed"] > 0
    assert ours.spec_stats() == theirs.spec_stats()
    _same(spec, want, _nospec_rerun(ours, reqs))


def test_spec_single_request_matches_generate():
    ours, _ = _engines()
    prompt = [int(t) for t in np.random.RandomState(3).randint(0, V, (13,))]
    req = Request(0, prompt, max_new_tokens=10)
    res = ours.run([req])[0]
    assert res.tokens == _oracle(ours.dmodel, req)
    assert len(res.logprobs) == 10 and all(lp <= 0 for lp in res.logprobs)
    assert res.ttft >= 0 and len(res.token_times) == 10


def test_spec_mixed_sampling_rows_ride_along():
    """Every other request samples: sampled rows never draft but share
    the verify steps (column 0 through sample_slots). Greedy rows equal
    the JAX engine's and the no-spec rerun's; sampled tokens lie in
    their top_k support under the teacher-forced logits; the whole mixed
    trace replays token for token after reset() with the same program
    counts, which equal the JAX engine's."""
    ours, theirs = _engines()
    reqs = _trace(seed=31, sampled=True)
    a = ours.run(reqs)
    theirs.run(reqs)
    assert ours.spec_stats()["proposed"] > 0
    first = ours.compile_counts()
    assert first == theirs.compile_counts()
    ours.reset()
    b = ours.run(reqs)
    assert ours.compile_counts() == first
    _same(a, b)
    greedy = [r.id for r in reqs if r.temperature == 0.0]
    _same(a, _nospec_rerun(ours, reqs), ids=greedy)
    theirs.reset()
    _same(a, theirs.run(reqs), ids=greedy)
    with torch.inference_mode():
        for r in reqs:
            if r.temperature == 0.0:
                continue
            seq = list(r.prompt) + a[r.id].tokens[:-1]
            logits = ours.dmodel(torch.tensor([seq]),
                                 positions=np.arange(len(seq))[None],
                                 cache=ours.dmodel.new_cache(1))
            rows = logits[0, len(r.prompt) - 1:]
            topk = torch.topk(rows, r.top_k, -1).indices
            for j, t in enumerate(a[r.id].tokens):
                assert t in topk[j].tolist(), f"request {r.id} token {j}"


def test_spec_reset_replay_holds_the_verify_program_pins():
    ours, theirs = _engines(**PAGED)
    assert ours._verify_buckets == theirs._verify_buckets == (2, 5)
    reqs = _trace(seed=23)
    a = ours.run(reqs)
    theirs.run(reqs)
    first = ours.compile_counts()
    assert 1 <= first["verify"] <= len(ours._verify_buckets)
    assert first == theirs.compile_counts()
    ours.reset()
    b = ours.run(reqs)
    assert ours.compile_counts() == first
    _same(a, b)


def test_spec_verify_widths_bucket_a_mixed_budget_trace():
    """Wave 1 (max_new 2, budget 1) drafts one token: the width-2
    program; wave 2 the full draft_k: width 5. Exactly two verify
    programs, as the JAX engine builds, and token-exact."""
    drafter = lambda hist, k: [int(hist[-1])] * k   # noqa: E731
    ours, theirs = _engines(speculative="draft", drafter=drafter)
    rs = np.random.RandomState(5)
    reqs = [Request(i, [1 + i, 2, 3], max_new_tokens=2) for i in range(4)]
    reqs += [Request(4 + i, [int(t) for t in rs.randint(0, V, (6,))],
                     max_new_tokens=12) for i in range(4)]
    spec = ours.run(reqs)
    want = theirs.run(reqs)
    assert ours.compile_counts()["verify"] == 2
    assert ours.compile_counts() == theirs.compile_counts()
    assert ours.spec_stats() == theirs.spec_stats()
    _same(spec, want, _nospec_rerun(ours, reqs))


# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------

def test_spec_draft_mode_shares_the_verify_path():
    drafter = lambda hist, k: propose_ngram(hist, k)   # noqa: E731
    ours, theirs = _engines(speculative="draft", drafter=drafter)
    reqs = _trace(seed=47)
    spec = ours.run(reqs)
    want = theirs.run(reqs)
    stats = ours.spec_stats()
    assert stats["proposed"] > 0 and stats["acceptance_rate"] > 0
    assert stats == theirs.spec_stats()
    _same(spec, want, _nospec_rerun(ours, reqs))


def test_spec_adversarial_drafter_exact_and_never_more_steps():
    """A drafter proposing one constant token wastes proposals, never
    tokens: exact against the JAX engine and the plain sync engine, the
    same counters as the JAX engine, and no more steps than plain sync
    decode (every verify step banks its bonus token)."""
    drafter = lambda hist, k: [63] * k   # noqa: E731
    ours, theirs = _engines(speculative="draft", drafter=drafter)
    reqs = _trace(seed=41)
    adv = ours.run(reqs)
    want = theirs.run(reqs)
    assert ours.spec_stats()["proposed"] > 0
    assert ours.spec_stats() == theirs.spec_stats()
    adv_steps = ours.steps_dispatched
    assert adv_steps == theirs._steps_dispatched
    ours.config.speculative = None
    ours.config.async_decode = False
    ours.reset()
    base = ours.run(reqs)
    _same(adv, want, base)
    assert adv_steps <= ours.steps_dispatched


def test_spec_out_of_vocab_draft_ids_are_cut():
    drafter = lambda hist, k: [10 ** 9, -1, 3]   # noqa: E731
    ours, theirs = _engines(speculative="draft", drafter=drafter)
    reqs = _trace(seed=43, n=4)
    res = ours.run(reqs)
    want = theirs.run(reqs)
    assert ours.spec_stats() == theirs.spec_stats()
    _same(res, want, _nospec_rerun(ours, reqs))


@pytest.mark.parametrize("kw,match", [
    (dict(speculative="turbo"), "speculative"),
    (dict(speculative="ngram", draft_k=0), "draft_k"),
    (dict(speculative="draft"), "drafter")])
def test_spec_config_validation_as_jax(kw, match):
    """The same ValueError, word for word, as the JAX engine's."""
    jm, params, tm = _models()
    cfg = dict(slots=4, chunk_buckets=(4, 8), **kw)
    with pytest.raises(ValueError, match=match) as ours:
        ServingEngine(tm, EngineConfig(**cfg), device="cpu")
    with pytest.raises(ValueError, match=match) as theirs:
        JServingEngine(jm, params, JEngineConfig(**cfg))
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# H9: a verify window across max_len
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, PAGED], ids=["contiguous", "paged"])
def test_verify_window_across_max_len_token_exact(kw, monkeypatch):
    """A request whose span ends at max_len (prompt 56 + 8 new) decodes
    beside one with a long budget, every row drafting its whole budget,
    so its late verify steps run 5 columns from a cursor within 5 of
    max_len: real writes up to max_len - 2, padded columns at max_len.
    Those go to the trash row (contiguous) or trash page (paged) inside
    programs that read nothing on the host; every request equals the JAX
    engine's and the no-spec rerun's tokens, with the same counters.
    Contiguously the trash row holds the padded writes and the slot rows
    none past a cursor."""
    crossed = []
    call = programs.Program.__call__

    def guarded(self):
        if self.key[0] == "verify":
            W = self.inputs["toks"].shape[1]
            start = self.inputs["pos"][:, 0].long()
            real = start < L
            crossed.append(bool(((start + W > L) & real).any()))
        with _no_host_reads():
            call(self)
    monkeypatch.setattr(programs.Program, "__call__", guarded)
    drafter = lambda hist, k: [int(hist[-1])] * k   # noqa: E731
    ours, theirs = _engines(speculative="draft", drafter=drafter, **kw)
    rs = np.random.RandomState(9)
    reqs = [Request(0, [int(t) for t in rs.randint(0, V, (56,))], 8),
            Request(1, [int(t) for t in rs.randint(0, V, (4,))], 40)]
    spec = ours.run(reqs)
    want = theirs.run(reqs)
    assert any(crossed)
    assert ours.spec_stats() == theirs.spec_stats()
    assert ours.compile_counts() == theirs.compile_counts()
    _same(spec, want)
    if not kw:
        k = ours.cache.layers[0].k
        assert k.shape[0] == ours.config.slots + 1     # the trash row
        assert k[-1].abs().sum() > 0                   # it took writes
    monkeypatch.setattr(programs.Program, "__call__", call)
    _same(spec, _nospec_rerun(ours, reqs))


# ---------------------------------------------------------------------------
# the benchmark's latency fields with timed-out requests
# ---------------------------------------------------------------------------

class _FakeResult:
    def __init__(self, ttft, token_times):
        self.ttft = ttft
        self.token_times = token_times


def test_ttft_sentinel_never_pollutes_latency_percentiles():
    pure = _latency_fields([_FakeResult(-1.0, [])] * 4)
    assert pure == dict.fromkeys(
        ["serving_ttft_p50_ms", "serving_ttft_p99_ms",
         "serving_tpot_p50_ms", "serving_tpot_p99_ms"])
    mixed = _latency_fields(
        [_FakeResult(-1.0, []), _FakeResult(0.5, [0.5, 0.6])])
    assert mixed["serving_ttft_p50_ms"] == mixed["serving_ttft_p99_ms"] \
        == 500.0
    assert mixed["serving_tpot_p50_ms"] == pytest.approx(100.0)


def test_all_timeout_trace_reports_without_crashing():
    ours, _ = _engines(speculative=None, request_timeout=0.0, **PAGED)
    reqs = [Request(i, [1 + i, 2, 3, 4, 5, 6], 8) for i in range(3)]
    results = ours.run(reqs)
    assert all(r.finish_reason == "timeout" for r in results.values())
    assert all((r.ttft == -1.0) == (not r.token_times)
               for r in results.values())
    for key, val in _latency_fields(results.values()).items():
        assert val is None or val >= 0.0, (key, val)
