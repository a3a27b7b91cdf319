"""The port's disaggregated serving (serve/engine.py DisaggEngine,
serve/transfer.py PageTransfer) against the JAX package's.

Same weights on every side (the `_pair` of test_torch_serve.py:
gpt2-test, f32, vocab 64, max_len 64), four slots, chunk buckets (4, 8),
pages of 8 positions, on the CPU (K5's plain version where the port's
decode kernel dispatch is on). Held:

- PageTransfer moves pages bit for bit as the JAX PageTransfer does on
  the same pool contents and page lists, int8 pools with their scale
  planes included, within the same padded widths (<= log2(pool) + 1);
- a greedy trace through the port's DisaggEngine gives the JAX
  DisaggEngine's tokens and the port's colocated paged engine's, with the
  same handoffs (pages moved, pages found in the decode pool's prefix
  cache) and the pool pins (prefill pool: no step program; decode pool:
  no prefill program), across EOS, reset() and int8 KV;
- a decode-side prefix hit moves only the missing pages; backpressure
  keeps admission within the decode pool's pages; per-pool telemetry and
  events as the JAX engine's;
- planted faults fail: a handoff that skips one page, and a released
  prefill page rewritten before the copy read it (H18's early reuse) —
  while the same rewrite after the copy changes nothing.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serve import _pair

from mpi_operator_tpu.serve import DisaggEngine as JDisaggEngine
from mpi_operator_tpu.serve import EngineConfig as JEngineConfig
from mpi_operator_tpu.serve import PageTransfer as JPageTransfer
from mpi_operator_tpu.serve import Request as JRequest
from mpi_operator_tpu.telemetry import events as jev
from mpi_operator_tpu.telemetry.core import Registry as JRegistry
from mpi_operator_tpu.telemetry.events import EventLog as JEventLog
from mpi_operator_tpu.telemetry.events import read_events as j_read_events
from mpi_operator_tpu_torch.models import transformer as tt
from mpi_operator_tpu_torch.serve import (DisaggEngine, EngineConfig,
                                          PageTransfer, Request, Scheduler,
                                          ServingEngine)
from mpi_operator_tpu_torch.serve.engine import disagg_devices
from mpi_operator_tpu_torch.serve.transfer import _bucket
from mpi_operator_tpu_torch.telemetry import EventLog, Registry, read_events
from mpi_operator_tpu_torch.telemetry import events as ev

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

V, PS = 64, 8
ECFG = dict(slots=4, chunk_buckets=(4, 8), paged=True, page_size=PS)


@functools.lru_cache(maxsize=None)
def _models(kv=None):
    return _pair("gpt2", kv)


def _port(kv=None, kernel=False, **kw):
    """(colocated, disagg) port engines over the same model."""
    _, _, tm = _models(kv)
    cfg = EngineConfig(decode_kernel=kernel, **{**ECFG, **kw})
    return (ServingEngine(tm, cfg, device="cpu"),
            DisaggEngine(tm, cfg, devices=("cpu", "cpu")))


@functools.lru_cache(maxsize=None)
def _jax_disagg(kv=None, num_pages=None):
    jm, params, _ = _models(kv)
    return JDisaggEngine(jm, params, JEngineConfig(
        decode_kernel=False, num_pages=num_pages, **ECFG))


def _trace(n=8, seed=7, eos=None, cls=Request):
    rs = np.random.RandomState(seed)
    lens = [(1, 6), (3, 9), (9, 4), (14, 7), (5, 5), (7, 8), (12, 6),
            (2, 7)]
    return [cls(i, [int(t) for t in rs.randint(0, V, (p,))],
                max_new_tokens=m, eos_id=eos)
            for i, (p, m) in enumerate(lens[:n])]


def _jax_run(trace, kv=None, num_pages=None):
    eng = _jax_disagg(kv, num_pages)
    eng.reset()
    out = eng.run([JRequest(r.id, list(r.prompt), r.max_new_tokens,
                            eos_id=r.eos_id) for r in trace])
    return eng, out


def _same_tokens(got, *wants):
    for want in wants:
        assert set(got) == set(want)
        for rid in want:
            assert got[rid].tokens == want[rid].tokens, f"request {rid}"
            assert got[rid].finish_reason == want[rid].finish_reason


def _audit(disagg):
    for alloc in (disagg.prefill.page_allocator,
                  disagg.decode.page_allocator):
        alloc.check()
        assert alloc.in_use == 0


def _pool_pins(disagg):
    counts = disagg.compile_counts()
    assert counts["prefill_pool"]["step"] == 0
    assert counts["prefill_pool"]["prefill"] <= 2
    assert counts["decode_pool"]["prefill"] == 0
    assert counts["decode_pool"]["step"] <= 3
    cap = int(math.log2(disagg.decode.page_allocator.num_pages)) + 1
    assert counts["transfer"]["gather"] <= cap
    assert counts["transfer"]["scatter"] <= cap
    return counts


# ---------------------------------------------------------------------------
# PageTransfer
# ---------------------------------------------------------------------------

def _pools(kv, num_pages, seed):
    """A port PagedKVCache filled from a seed and the same contents as
    the JAX transfer's pytree (one leaf a pool tensor, in layer order)."""
    _, _, tm = _models(kv)
    cache = tt.PagedKVCache.zeros(tm.config, num_pages, PS, "cpu")
    rs = np.random.RandomState(seed)
    tree = {}
    for i, layer in enumerate(cache.layers):
        for j, t in enumerate(layer.tensors()):
            if t.dtype == torch.int8:
                a = rs.randint(-127, 128, tuple(t.shape)).astype(np.int8)
            else:
                a = rs.randn(*t.shape).astype(np.float32)
            t.copy_(torch.from_numpy(a))
            tree[f"l{i}_{j}"] = jnp.asarray(a)
    return cache, tree


@pytest.mark.parametrize("kv", [None, "int8"])
def test_page_transfer_bit_exact_vs_jax_within_widths(kv):
    """Moves of 1..12 pages between pools of 17 and 13 pages, the same
    ids on both sides: every destination tensor equal to the JAX
    transfer's bit for bit (int8 pages with their f32 scale planes), the
    padding only ever touching trash page 0, and the distinct widths the
    JAX transfer's compile counts: one a power of two up to the largest
    move, so <= ceil(log2(12)) + 1."""
    src, jsrc = _pools(kv, 17, 0)
    dst, jdst = _pools(kv, 13, 1)
    mine, theirs = PageTransfer(17, 13), JPageTransfer(17, 13)
    rs = np.random.RandomState(2)
    for n in (1, 2, 3, 5, 7, 8, 12):
        sids = [int(p) for p in rs.choice(np.arange(1, 17), n, False)]
        dids = [int(p) for p in rs.choice(np.arange(1, 13), n, False)]
        assert mine.move(src, dst, sids, dids) == n
        jdst, moved = theirs.move(jsrc, jdst, sids, dids)
        assert moved == n
        flat = [t for layer in dst.layers for t in layer.tensors()]
        for k, t in enumerate(flat):
            want = np.asarray(jdst[f"l{k // len(dst.layers[0].tensors())}_"
                                   f"{k % len(dst.layers[0].tensors())}"])
            np.testing.assert_array_equal(t.numpy(), want)
        # the moved pages hold the source pages
        for s, d in zip(sids, dids):
            for ts, td in zip(src.layers[0].tensors(),
                              dst.layers[0].tensors()):
                assert torch.equal(ts[s], td[d])
    assert mine.pages_moved == theirs.pages_moved
    assert mine.compile_counts() == theirs.compile_counts()
    assert mine.compile_counts()["gather"] <= math.ceil(math.log2(12)) + 1
    assert [_bucket(n) for n in (1, 2, 3, 4, 5, 8, 9)] == \
        [1, 2, 4, 4, 8, 8, 16]
    with pytest.raises(ValueError, match="disagree"):
        mine.move(src, dst, [1, 2], [1])
    assert mine.move(src, dst, [], []) == 0


def test_page_bytes_counts_every_pool_tensor():
    _, _, tm = _models("int8")
    cache = tt.PagedKVCache.zeros(tm.config, 5, PS, "cpu")
    c = tm.config
    per_layer = 2 * c.kv_heads * PS * (c.head_dim * 1 + 4)
    assert PageTransfer.page_bytes(cache, 5) == c.num_layers * per_layer


# ---------------------------------------------------------------------------
# DisaggEngine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,kv", [(False, None), (True, None),
                                       (True, "int8")])
def test_disagg_token_exact_vs_jax_and_colocated(kernel, kv):
    """Eight mixed requests over four slots (slot and page reuse in both
    pools, pages crossing pools mid-trace): tokens equal the JAX
    DisaggEngine's and the colocated paged engine's, handoff by handoff
    the same pages moved and found cached, logprobs within 1e-4 of the
    JAX engine's, every page back, and the pool pins held."""
    colocated, disagg = _port(kv, kernel)
    trace = _trace()
    got = disagg.run(trace)
    jeng, theirs = _jax_run(trace, kv)
    _same_tokens(got, theirs, colocated.run(trace))
    for r in trace:
        np.testing.assert_allclose(got[r.id].logprobs,
                                   theirs[r.id].logprobs, atol=1e-4)
    assert [(m, c) for _, m, c in disagg.handoff_log] == \
        [(m, c) for _, m, c in jeng.handoff_log]
    assert disagg.transfer.pages_moved == jeng.transfer.pages_moved > 0
    _audit(disagg)
    counts = _pool_pins(disagg)
    assert counts["decode_pool"]["step"] == 1          # all greedy
    assert counts["transfer"] == jeng.compile_counts()["transfer"]


def test_disagg_eos_and_pins_across_reset():
    """EOS retires through the decode pool; reset() replays the trace
    with the same tokens and no new program or width."""
    colocated, disagg = _port()
    eos = colocated.run(_trace(n=1))[0].tokens[2]
    colocated.reset()
    trace = _trace(eos=eos)
    want = colocated.run(trace)
    got = disagg.run(trace)
    assert any(r.finish_reason == "eos" for r in got.values())
    _same_tokens(got, want, _jax_run(trace)[1])
    before = _pool_pins(disagg)
    disagg.reset()
    _same_tokens(disagg.run(trace), want)
    assert disagg.compile_counts() == before
    _audit(disagg)


def test_prefix_hit_handoff_moves_only_missing_pages():
    """A repeat prompt's full pages are resident in the decode pool's
    prefix cache: its handoff moves none, and a prompt diverging in its
    last full page moves that page only; the JAX engine moves the same."""
    _, disagg = _port()
    jeng = _jax_disagg()
    jeng.reset()
    shared = [int(t) for t in np.random.RandomState(3).randint(0, V, (33,))]
    fork = list(shared)
    fork[30] = (fork[30] + 1) % V
    moved = []
    for i, prompt in enumerate((shared, shared, fork)):
        out = disagg.run([Request(i, prompt, max_new_tokens=4)])
        jout = jeng.run([JRequest(i, prompt, max_new_tokens=4)])
        assert out[i].tokens == jout[i].tokens
        assert out[i].cached_tokens == jout[i].cached_tokens
        moved.append(disagg.transfer.pages_moved)
        assert disagg.transfer.pages_moved == jeng.transfer.pages_moved
    assert moved[0] >= 4 and moved[1] == moved[0]      # full hit: no bytes
    assert moved[2] == moved[0] + 1                    # the divergent page
    assert disagg.decode.page_allocator.hits >= 7
    assert [c for _, _, c in disagg.handoff_log] == [0, 4, 3]


def test_backpressure_and_unservable():
    """A decode pool of 3 usable pages serves three 3-page requests one
    at a time (the admission gate), tokens as colocated; a request whose
    span exceeds the decode pool is refused."""
    reqs = [Request(i, [int(t) for t in
                        np.random.RandomState(i).randint(0, V, (14,))],
                    max_new_tokens=7) for i in range(3)]
    colocated, disagg = _port(num_pages=4)
    _same_tokens(disagg.run(reqs), colocated.run(reqs))
    assert disagg.prefill.occupancy_peak == 1
    assert disagg.decode.occupancy_peak == 1
    assert not disagg._handoff_q
    with pytest.raises(ValueError, match="decode pool"):
        disagg.run([Request(9, [1] * 20, max_new_tokens=30)])


def test_per_pool_telemetry_and_events_as_jax(tmp_path):
    """One registry, two pool-labelled bundles; the handoff counters and
    the events (kv_handoff records, pool-stamped admissions) equal the
    JAX DisaggEngine's on the same trace."""
    _, _, tm = _models()
    jm, params, _ = _models()
    trace = _trace(n=4)
    reg, log = Registry(), EventLog(str(tmp_path / "t.jsonl"))
    disagg = DisaggEngine(tm, EngineConfig(**ECFG), registry=reg,
                          events=log, devices=("cpu", "cpu"))
    disagg.run(trace)
    log.close()
    jreg, jlog = JRegistry(), JEventLog(str(tmp_path / "j.jsonl"))
    jeng = JDisaggEngine(jm, params, JEngineConfig(**ECFG), registry=jreg,
                         events=jlog)
    jeng.run([JRequest(r.id, list(r.prompt), r.max_new_tokens)
              for r in trace])
    jlog.close()
    pre, dec = disagg.prefill.telemetry, disagg.decode.telemetry
    jpre, jdec = jeng.prefill.telemetry, jeng.decode.telemetry
    assert pre.labels == {"pool": "prefill"} and dec.labels == {
        "pool": "decode"}
    for name in ("kv_handoff_pages", "requests_total", "tokens_total",
                 "prefix_hit_pages", "prefix_miss_pages"):
        for mine, theirs in ((pre, jpre), (dec, jdec)):
            assert getattr(mine, name).value == getattr(theirs, name).value
    assert dec.kv_handoff_seconds.count == len(disagg.handoff_log) == 4
    for kind, jkind in ((ev.KV_HANDOFF, jev.KV_HANDOFF),
                        (ev.SLOT_ADMIT, jev.SLOT_ADMIT),
                        (ev.SLOT_RETIRE, jev.SLOT_RETIRE)):
        mine = read_events(log.path, kind=kind)
        theirs = j_read_events(jlog.path, kind=jkind)
        keep = ("request", "pool", "pages", "cached_pages", "slot",
                "prompt_len", "cached_tokens", "finish_reason", "new_tokens")
        assert ([{k: e[k] for k in keep if k in e} for e in mine]
                == [{k: e[k] for k in keep if k in e} for e in theirs])


def test_devices_default_to_the_card_and_cpu_only_when_asked():
    assert disagg_devices(("cpu", "cpu")) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="expected"):
        disagg_devices(("cpu",))
    _, _, tm = _models()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DisaggEngine(tm, EngineConfig(**ECFG))
    with pytest.raises(ValueError, match="paged=True"):
        DisaggEngine(tm, EngineConfig(slots=4), devices=("cpu", "cpu"))
    with pytest.raises(ValueError, match="page_size"):
        DisaggEngine(tm, EngineConfig(**ECFG), devices=("cpu", "cpu"),
                     prefill_config=EngineConfig(**{**ECFG, "page_size": 16}))


# ---------------------------------------------------------------------------
# planted faults
# ---------------------------------------------------------------------------

def _wrapped_move(disagg, before=None, after=None, drop_last=False):
    """Wrap the engine's transfer: `before`/`after` get the source ids of
    each handoff around the real move; `drop_last` skips its last page."""
    real = disagg.transfer.move

    def move(src_cache, dst_cache, src_ids, dst_ids):
        src_ids, dst_ids = list(src_ids), list(dst_ids)
        if drop_last and src_ids:
            src_ids, dst_ids = src_ids[:-1], dst_ids[:-1]
        if before is not None:
            before(src_cache, src_ids)
        n = real(src_cache, dst_cache, src_ids, dst_ids)
        if after is not None:
            after(src_cache, src_ids)
        return n
    disagg.transfer.move = move


def _rewrite(cache, ids):
    """What the next prefill does to a released page it takes: new
    contents (here a constant, in every layer)."""
    for layer in cache.layers:
        for t in layer.tensors():
            t[ids] = 3


def _diverged(got, want):
    return [rid for rid in want if got[rid].tokens != want[rid].tokens]


def test_planted_handoff_skipping_a_page_breaks_tokens():
    colocated, disagg = _port()
    trace = _trace()
    want = colocated.run(trace)
    _wrapped_move(disagg, drop_last=True)
    assert _diverged(disagg.run(trace), want)


def test_planted_early_reuse_breaks_tokens_and_ordered_reuse_does_not():
    """H18 on the CPU, where every call runs in program order: a
    released prefill page rewritten (as the next prefill that takes it
    would) BEFORE the copy reads it breaks token identity; the same
    rewrite AFTER the copy — the order the engine enqueues on the
    card's stream — changes no token."""
    colocated, disagg = _port()
    trace = _trace()
    want = colocated.run(trace)
    _wrapped_move(disagg, before=_rewrite)
    assert _diverged(disagg.run(trace), want)
    _, ordered = _port()
    _wrapped_move(ordered, after=_rewrite)
    _same_tokens(ordered.run(trace), want)


def test_scheduler_reserves_the_prompt_span_in_the_prefill_pool():
    """The prefill pool reserves prompt pages only; the decode pool the
    whole span."""
    _, disagg = _port()
    assert disagg.prefill.scheduler.reserve == "prompt"
    assert disagg.decode.scheduler.reserve == "full"
    r = Request(0, [1] * 17, 30)
    assert Scheduler.prompt_pages_needed(r, PS) == 2
    assert Scheduler.pages_needed(r, PS) == 6
