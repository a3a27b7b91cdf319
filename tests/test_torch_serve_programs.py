"""The serving engine's programs (serve/programs.py) against the JAX
engine's jitted programs, on the CPU.

The reference pins its no-recompile contract with `compile_counts()`
(tests/test_serve.py and tests/test_paged_kv.py); these are those pins
ported to the port's engine, whose programs run eagerly here (the card
captures them as CUDA graphs: tests/test_torch_graphs_cuda.py). Same
weights on both sides (params_from_flax, `_pair` of test_torch_serve.py:
gpt2-test, f32, vocab 64, max_len 64), four slots, chunk buckets (4, 8).
The port's `step` and `prefill` counts must EQUAL the JAX engine's on
the same trace. The programs' forward (`CausalLM.forward_device`) must
match the host-data form bit for bit where both apply, send paged
writes past max_len to the trash page, and read nothing back to the
host: a guard makes every host read of a tensor inside a program raise.
"""
import contextlib

import numpy as np
import pytest
import torch
from test_torch_serve import _oracle, _pair

from mpi_operator_tpu.serve import EngineConfig as JEngineConfig
from mpi_operator_tpu.serve import ServingEngine as JServingEngine
from mpi_operator_tpu_torch.models import transformer as tt
from mpi_operator_tpu_torch.serve import EngineConfig, Request, ServingEngine
from mpi_operator_tpu_torch.serve import programs

V, L = 64, 64
PINNED = ("step", "prefill")


def _engines(kernel=False, **kw):
    """(port engine, JAX engine) over the same weights and settings; the
    JAX engine runs dense (its Pallas kernel in interpret mode would only
    slow the test: the programs it compiles are the same)."""
    jm, params, tm = _pair(decode_kernel=kernel)
    cfg = {"slots": 4, "chunk_buckets": (4, 8), **kw}
    return (ServingEngine(tm, EngineConfig(decode_kernel=kernel, **cfg),
                          device="cpu"),
            JServingEngine(jm, params, JEngineConfig(decode_kernel=False,
                                                     **cfg)))


def _counts(engine):
    return {k: engine.compile_counts()[k] for k in PINNED}


@contextlib.contextmanager
def _no_host_reads():
    """Every way a tensor's value reaches Python raises: bool(), item(),
    tolist(), numpy(), int()/float()/index, nonzero()."""
    def refuse(*_, **__):
        raise AssertionError("a program read a tensor on the host")
    names = ("__bool__", "item", "tolist", "numpy", "__int__", "__float__",
             "__index__", "nonzero")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    try:
        for n in names:
            setattr(torch.Tensor, n, refuse)
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


@pytest.fixture
def guarded_programs(monkeypatch):
    """Run every program call under _no_host_reads."""
    call = programs.Program.__call__

    def guarded(self):
        with _no_host_reads():
            call(self)
    monkeypatch.setattr(programs.Program, "__call__", guarded)


def _mixed_sampling(rs, base):
    return [Request(base + i, [int(t) for t in rs.randint(0, V, (p,))],
                    max_new_tokens=4, temperature=0.9 if i % 2 else 0.0,
                    top_k=5 if i % 2 else 0)
            for i, p in enumerate([2, 6, 9, 13, 4])]


@pytest.mark.parametrize("paged", [False, True])
def test_compile_counts_stay_fixed_and_equal_jax(paged, guarded_programs):
    """tests/test_serve.py::test_engine_compile_counts_stay_fixed on the
    port: a mixed greedy + sampling trace, reset, a second trace of other
    shapes, reset, the first again — at most one step program a sampling
    mode, one prefill program a bucket, the cache and the cast params
    built once, no count growing across reset() and a second trace, and
    the step and prefill counts equal to the JAX engine's on the same
    traces. A reset engine replays its sampled draws token for token."""
    kw = {"paged": True, "page_size": 8} if paged else {}
    ours, theirs = _engines(**kw)
    rs = np.random.RandomState(13)
    t0, t1 = _mixed_sampling(rs, 0), _mixed_sampling(rs, 100)
    a = ours.run(t0)
    theirs.run(t0)
    first = ours.compile_counts()
    assert _counts(ours) == {k: theirs.compile_counts()[k] for k in PINNED}
    ours.reset()
    theirs.reset()
    if paged:
        alloc = ours.page_allocator
        assert alloc.in_use == 0 and alloc.cached_pages == 0
        assert alloc.available == alloc.usable
        alloc.check()
    ours.run(t1)
    theirs.run(t1)
    second = ours.compile_counts()
    assert first == second                    # reset must not recompile
    assert second["step"] <= 3
    assert second["prefill"] <= len(ours.config.chunk_buckets)
    assert second["init_cache"] == 1 and second["cast"] == 1
    assert second["verify"] == 0
    assert _counts(ours) == {k: theirs.compile_counts()[k] for k in PINNED}
    assert ours.capture_counts() == {"step": 0, "prefill": 0}   # CPU
    ours.reset()
    b = ours.run(t0)
    assert ours.compile_counts() == second
    for r in t0:
        assert b[r.id].tokens == a[r.id].tokens


@pytest.mark.parametrize("kernel", [False, True])
def test_async_and_sync_share_programs(kernel):
    """tests/test_serve.py::test_engine_async_matches_sync_token_exact:
    the double-buffered loop and the drain-every-step loop give the same
    greedy tokens (EOS cuts mid-flight included) and finish reasons, and
    run the same programs: the counts do not move between them, and
    equal the JAX engine's after its async run."""
    ours, theirs = _engines(kernel)
    rs = np.random.RandomState(11)
    probe = Request(99, [int(t) for t in rs.randint(0, V, (6,))],
                    max_new_tokens=8)
    eos = _oracle(ours.dmodel, probe)[2]
    reqs = [Request(i, [int(t) for t in rs.randint(0, V, (3 + i,))],
                    max_new_tokens=8, eos_id=eos) for i in range(6)]
    assert ours.config.async_decode
    a = ours.run(reqs)
    counts_async = ours.compile_counts()
    want = theirs.run(reqs)
    assert _counts(ours) == {k: theirs.compile_counts()[k] for k in PINNED}
    ours.config.async_decode = False
    ours.reset()
    b = ours.run(reqs)
    assert ours.compile_counts() == counts_async
    assert any(r.finish_reason == "eos" for r in a.values())
    for r in reqs:
        assert a[r.id].tokens == b[r.id].tokens == want[r.id].tokens
        assert a[r.id].finish_reason == b[r.id].finish_reason


def test_async_compile_pins_and_sampled_replay():
    """tests/test_serve.py::test_engine_async_compile_pins_and_sampled_
    replay: async mode holds the same contract across run -> reset -> run
    with mixed greedy and sampled traffic, and a reset engine replays its
    sampled draws exactly (the generator rewinds with it)."""
    ours, theirs = _engines()
    rs = np.random.RandomState(29)
    reqs = [Request(i, [int(t) for t in rs.randint(0, V, (p,))],
                    max_new_tokens=5, temperature=1.1 if i % 2 else 0.0,
                    top_k=4 if i % 2 else 0)
            for i, p in enumerate([2, 7, 10, 3, 12])]
    a = ours.run(reqs)
    first = ours.compile_counts()
    theirs.run(reqs)
    assert _counts(ours) == {k: theirs.compile_counts()[k] for k in PINNED}
    ours.reset()
    b = ours.run(reqs)
    second = ours.compile_counts()
    assert first == second
    assert second["step"] <= 3
    assert second["prefill"] <= len(ours.config.chunk_buckets)
    for r in reqs:
        assert a[r.id].tokens == b[r.id].tokens


def _mixed_trace(seed=7):
    rs = np.random.RandomState(seed)
    lens = [(1, 6), (3, 9), (9, 4), (14, 7), (5, 5), (7, 8), (12, 6),
            (2, 7)]
    return [Request(i, [int(t) for t in rs.randint(0, V, (p,))],
                    max_new_tokens=m) for i, (p, m) in enumerate(lens)]


@pytest.mark.parametrize("kernel", [False, True])
def test_paged_token_exact_vs_contiguous_one_step_program(kernel):
    """tests/test_paged_kv.py::test_paged_engine_token_exact_vs_contiguous
    on the port: greedy decode through the paged cache equals the
    contiguous engine on a trace with slot and page reuse, every page is
    released, and the paged engine built ONE step program and at most
    two prefill programs — as many as the JAX paged engine."""
    _, _, tm = _pair(decode_kernel=kernel)
    contiguous = ServingEngine(tm, EngineConfig(
        slots=4, chunk_buckets=(4, 8)), device="cpu")
    paged, jpaged = _engines(kernel, paged=True, page_size=8)
    trace = _mixed_trace()
    want = contiguous.run(trace)
    got = paged.run(trace)
    jpaged.run(trace)
    for r in trace:
        assert got[r.id].tokens == want[r.id].tokens, f"request {r.id}"
        assert got[r.id].finish_reason == want[r.id].finish_reason
    alloc = paged.page_allocator
    alloc.check()
    assert alloc.in_use == 0
    counts = paged.compile_counts()
    assert counts["step"] == 1 and counts["prefill"] <= 2
    assert _counts(paged) == {k: jpaged.compile_counts()[k] for k in PINNED}


def test_paged_row_past_max_len_token_exact_vs_jax(guarded_programs,
                                                   monkeypatch):
    """The F1 shape (test_torch_paged_serve.py::test_prefill_beside_a_
    row_near_max_len) through the programs: a batched prefill runs a row
    that decodes near max_len at its own cursor, past max_len. Its writes
    go to the trash page through the device-side page index, its
    position lookups are clamped on the device, no program reads a
    tensor on the host, and every request is token-exact against the JAX
    paged engine, with equal program counts."""
    counts = []
    original = programs.Program.__call__

    def counting(self):
        if self.key[0] == "prefill":
            pos = (self.inputs["starts"].long()[:, None]
                   + torch.arange(self.inputs["tokens"].shape[1]))
            counts.append(int((pos >= L).sum()))
        original(self)
    monkeypatch.setattr(programs.Program, "__call__", counting)
    ours, theirs = _engines(True, paged=True, page_size=8, slots=2)
    rs = np.random.RandomState(4)
    trace = [Request(i, [int(t) for t in rs.randint(0, V, (p,))], m)
             for i, (p, m) in enumerate([(2, 61), (2, 55), (20, 6)])]
    got = ours.run(trace)
    want = theirs.run(trace)
    assert sum(counts) > 0                    # a row really ran past L
    for r in trace:
        assert got[r.id].tokens == want[r.id].tokens, f"request {r.id}"
        assert got[r.id].finish_reason == want[r.id].finish_reason
    assert _counts(ours) == {k: theirs.compile_counts()[k] for k in PINNED}


def test_device_form_matches_host_form_bit_for_bit():
    """On random positions that include >= max_len: the device page
    index resolves every kept position to the host page index's (page,
    slot) and every other to the trash page; the learned-position lookup
    clamps. Then whole forwards: forward_device over device operands
    gives forward's hidden states and cache bit for bit, paged with rows
    past max_len and contiguous inside the cache, multi-token and
    single-token."""
    rs = np.random.RandomState(0)
    ps, maxl, B, S = 8, 64, 5, 7
    nblk = maxl // ps
    table = rs.randint(1, 40, (B, nblk)).astype(np.int32)
    pos = rs.randint(0, maxl + 20, (B, S))
    host = tt.page_index(table, torch.from_numpy(pos), ps, maxl, "cpu")
    dev = tt.page_index_device(torch.from_numpy(table),
                               torch.from_numpy(pos), ps, maxl)
    keep = pos < maxl
    assert (~keep).any() and keep.any()
    np.testing.assert_array_equal(dev.page.numpy()[keep], host.page.numpy())
    np.testing.assert_array_equal(dev.slot.numpy()[keep], host.slot.numpy())
    assert (dev.page.numpy()[~keep] == 0).all()
    assert dev.page.shape == dev.slot.shape == (B, S)

    _, _, tm = _pair("gpt2")
    toks = torch.from_numpy(rs.randint(0, V, (B, S)))
    with torch.inference_mode():
        for paged in (True, False):
            p = pos if paged else rs.randint(0, maxl - S, (B, 1)) + \
                np.arange(S)
            caches = [tm.new_paged_cache(41, ps) if paged
                      else tm.new_cache(B) for _ in range(2)]
            kw = {"pages": table} if paged else {}
            want = tm(toks, positions=p, cache=caches[0], with_head=False,
                      **kw)
            got = tm.forward_device(
                toks, torch.from_numpy(p), caches[1],
                torch.from_numpy(table) if paged else None)
            assert torch.equal(got, want)
            step = [torch.from_numpy(rs.randint(0, V, (B, 1))),
                    p[:, -1:] + 1]
            want = tm(step[0], positions=step[1], cache=caches[0],
                      with_head=False, **kw)
            got = tm.forward_device(step[0], torch.from_numpy(step[1]),
                                    caches[1],
                                    torch.from_numpy(table) if paged
                                    else None)
            assert torch.equal(got, want)
            for c0, c1 in zip(caches[0].layers, caches[1].layers):
                k0, k1 = c0.k.clone(), c1.k.clone()
                if paged:                   # the trash page may differ
                    k0[0], k1[0] = 0, 0
                assert torch.equal(k0, k1)


def test_program_inputs_pack_and_stage():
    """A program's inputs are 16-byte-aligned views of one int32 buffer;
    floats travel by their bits; one staged upload fills every input;
    a wrong-sized input raises."""
    seen = []
    prog = programs.Program(
        ("step", False, "greedy"), lambda x: seen.append(
            {k: v.clone() for k, v in x.items()}),
        [("a", (3,), np.int32), ("f", (2, 2), np.float32),
         ("t", (2, 5), np.int32)], torch.device("cpu"), capture=False)
    offsets = {name: off for name, off, _, _ in prog.fields}
    assert offsets == {"a": 0, "f": 4, "t": 8} and prog.size == 18
    staging = programs.Staging(torch.device("cpu"))
    vals = {"a": np.array([1, -2, 3]),
            "f": np.array([[0.5, -1.25], [3e-8, 7.0]], np.float32),
            "t": np.arange(10).reshape(2, 5)}
    staging.upload(prog, vals)
    prog()
    assert seen[0]["a"].tolist() == [1, -2, 3]
    assert seen[0]["f"].dtype == torch.float32
    np.testing.assert_array_equal(seen[0]["f"].numpy(), vals["f"])
    assert seen[0]["t"].tolist() == vals["t"].tolist()
    with pytest.raises(ValueError, match="input a"):
        staging.upload(prog, dict(vals, a=np.zeros(4)))
