"""The serving fleet on the card: two engines on one device, the paged-KV
handoff's ordering, and disaggregated and routed serving through K5 with
CUDA graphs on.

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_fleet_cuda.py

Without a card every test here skips: K5 and the CUDA graphs have no CPU
mode (tests/test_torch_disagg.py and tests/test_torch_router.py hold the
same engines against the JAX package on the CPU). Held here:

- H17: two engines over one model on one card share the weights and
  nothing else (cache, graphs and their pool, capture stream, staging
  buffers, generator), and ticked in turn — one capturing while the
  other's step is in flight — each gives the tokens it gives alone;
- H18: a handoff enqueued behind a long kernel, its source pages
  rewritten right after without a host sync (as the next prefill would
  rewrite a released page), still lands the pages as they were: the
  device orders the copy before the rewrite;
- disaggregated serving and the router at gpt2-medium's width, two
  layers, bf16, decode_kernel=True: greedy tokens equal the colocated
  paged engine's (one engine's, for the router), the pool pins and
  graph captures held, K5 launched once a layer a decode step, no page
  left in use;
- with two cards, the decode pool on the second card holds its own copy
  of the weights and gives the same tokens.
"""
import numpy as np
import pytest
import torch

from mpi_operator_tpu_torch.models import create_lm
from mpi_operator_tpu_torch.models.generate import cast_params
from mpi_operator_tpu_torch.models import transformer as tt
from mpi_operator_tpu_torch.ops import attention as ops
from mpi_operator_tpu_torch.serve import (DisaggEngine, EngineConfig,
                                          PageTransfer, Request, Router,
                                          RouterConfig, ServingEngine)

PS = 16
# one prefill width: a request whose prompt prefix was cached prefills
# its tail in a window of the same shape as a cold request's, so bf16
# GEMMs round its K/V alike and greedy tokens compare bit for bit
CFG = dict(slots=4, chunk_buckets=(64,), paged=True, page_size=PS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: K5 and the engines' CUDA "
                    "graphs have no CPU mode (the fleet is held against the "
                    "JAX package on the CPU in test_torch_disagg.py and "
                    "test_torch_router.py)")
    return torch.device("cuda", 0)


def _model(max_len=128):
    """gpt2-medium's width at 2 layers, its weights cast to bf16 once (as
    the benchmark's fleet legs do), so every engine over it shares them."""
    return cast_params(create_lm("gpt2-medium", seed=0, dtype=torch.bfloat16,
                                 num_layers=2, max_len=max_len,
                                 decode_kernel=True), torch.bfloat16)


def _trace(vocab, n=10, seed=0, gap=0.0, prefix=32):
    rs = np.random.RandomState(seed)
    heads = [rs.randint(0, vocab, (prefix,)).tolist() for _ in range(3)]
    return [Request(i, heads[i % 3] + rs.randint(
        0, vocab, (int(rs.choice((8, 24, 40))),)).tolist(),
        max_new_tokens=int(rs.choice((6, 12))), arrival=i * gap)
        for i in range(n)]


def _tokens(results):
    return {rid: r.tokens for rid, r in results.items()}


def _weights(engine):
    """Where each of an engine's parameters lives."""
    return [p.data_ptr() for p in engine.dmodel.parameters()]


def _audit(*engines):
    for e in engines:
        e.page_allocator.check()
        assert e.page_allocator.in_use == 0


@pytest.mark.cuda
def test_two_engines_on_one_card_share_only_the_weights(cuda_device):
    model = _model()
    trace = _trace(model.config.vocab_size)
    alone = _tokens(ServingEngine(model, EngineConfig(**CFG)).run(trace))
    a, b = (ServingEngine(model, EngineConfig(**CFG)) for _ in range(2))
    assert _weights(a) == _weights(b)             # the weights, read-only
    for attr in ("_pool", "_stream", "_generator", "_staging", "_prev_tok"):
        assert getattr(a, attr) is not getattr(b, attr), attr
    assert a.cache.layers[0].k.data_ptr() != b.cache.layers[0].k.data_ptr()
    for e in (a, b):
        e.start()
        for r in trace:
            e.submit(r)
    # a's first step is dispatched (and left in flight) before b's first
    # tick captures b's programs, and so on in turn
    while a.active or b.active:
        for e in (a, b):
            if e.active:
                e.tick()
    got_a, got_b = _tokens(a.finish()), _tokens(b.finish())
    assert got_a == alone and got_b == alone
    for e in (a, b):
        built = e.compile_counts()
        assert e.capture_counts() == {k: built[k] for k in
                                      ("step", "prefill", "verify")}
    for e in (a, b):
        assert {p.graph for p in e._programs.values()}.isdisjoint(
            {p.graph for p in (b if e is a else a)._programs.values()})
    _audit(a, b)


@pytest.mark.cuda
def test_handoff_is_ordered_on_the_device(cuda_device):
    cfg = tt.lm_config("gpt2-medium", dtype=torch.bfloat16, max_len=256)
    src = tt.PagedKVCache.zeros(cfg, 33, PS, cuda_device)
    dst = tt.PagedKVCache.zeros(cfg, 33, PS, cuda_device)
    for i, layer in enumerate(src.layers):
        for t in layer.tensors():
            t.normal_(generator=torch.Generator(cuda_device).manual_seed(i))
    ids = [3, 7, 8, 20, 31]
    want = [[t[ids].clone() for t in layer.tensors()] for layer in src.layers]
    torch.cuda.synchronize()
    transfer = PageTransfer(33, 33)
    torch.cuda._sleep(200_000_000)            # ~0.1 s of device time first
    assert transfer.move(src, dst, ids, [1, 2, 4, 5, 6]) == len(ids)
    for layer in src.layers:                  # the next prefill's writes
        for t in layer.tensors():
            t[ids] = 0
    torch.cuda.synchronize()
    for layer, pages in zip(dst.layers, want):
        for t, w in zip(layer.tensors(), pages):
            assert torch.equal(t[[1, 2, 4, 5, 6]], w)
    assert transfer.last_ops == 2 * 2 * cfg.num_layers


def _disagg_vs_colocated(model, devices=None):
    trace = _trace(model.config.vocab_size)
    colocated = ServingEngine(model, EngineConfig(**CFG))
    disagg = DisaggEngine(model, EngineConfig(**CFG), devices=devices)
    for eng in (colocated, disagg):
        eng.run(trace[:2])
        eng.reset()
    want = _tokens(colocated.run(trace))
    ops.reset_launch_counts()
    got = _tokens(disagg.run(trace))
    launches = dict(ops.launch_counts)
    return disagg, trace, want, got, launches


@pytest.mark.cuda
def test_disagg_token_identical_through_k5(cuda_device):
    model = _model()
    disagg, trace, want, got, launches = _disagg_vs_colocated(
        model, devices=(cuda_device, cuda_device))
    assert got == want
    counts, captures = disagg.compile_counts(), disagg.capture_counts()
    assert counts["prefill_pool"]["step"] == 0
    assert counts["decode_pool"]["prefill"] == 0
    assert captures["prefill_pool"]["prefill"] == \
        counts["prefill_pool"]["prefill"] > 0
    assert captures["decode_pool"]["step"] == counts["decode_pool"]["step"]
    assert counts["transfer"]["gather"] <= 6          # widths 1..32
    steps = disagg.steps_dispatched
    assert steps > 0
    assert launches["paged_decode_attention"] == 2 * steps
    assert sum(launches.values()) == launches["paged_decode_attention"]
    assert _weights(disagg.prefill) == _weights(disagg.decode)
    assert disagg.transfer.pages_moved > 0
    _audit(disagg.prefill, disagg.decode)


@pytest.mark.cuda
def test_disagg_across_two_cards(cuda_device):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the decode pool on the second")
    model = _model()
    disagg, _, want, got, _ = _disagg_vs_colocated(
        model, devices=("cuda:0", "cuda:1"))
    assert got == want
    assert disagg.decode.dmodel.wte.weight.device == torch.device("cuda", 1)
    assert disagg.prefill.dmodel.wte.weight.device == torch.device("cuda", 0)
    _audit(disagg.prefill, disagg.decode)


@pytest.mark.cuda
def test_router_token_identical_through_k5(cuda_device):
    model = _model()
    trace = _trace(model.config.vocab_size, n=12, gap=0.02)

    def warm():
        e = ServingEngine(model, EngineConfig(**CFG))
        e.run(_trace(model.config.vocab_size, n=2, seed=9))
        e.reset()
        return e
    one = warm()
    want = _tokens(one.run([Request(r.id, list(r.prompt), r.max_new_tokens)
                            for r in trace]))
    router = Router([warm() for _ in range(2)], RouterConfig())
    newcomer = warm()
    router.schedule_attach(0.05, newcomer)
    router.schedule_detach(0.12, 0)
    ops.reset_launch_counts()
    got = router.run(trace)
    launches = dict(ops.launch_counts)
    assert _tokens(got) == want
    assert router.shed_count() == 0 and router.detached_replicas() == [0]
    # a replica whose tick raised would have been failed over silently
    assert router.dead_replicas() == []
    steps = sum(rep.engine.steps_dispatched for rep in router.replicas)
    assert launches["paged_decode_attention"] == 2 * steps > 0
    assert all(rep.engine.capture_counts()["step"]
               == rep.engine.compile_counts()["step"]
               for rep in router.replicas)
    _audit(*(rep.engine for rep in router.replicas))
