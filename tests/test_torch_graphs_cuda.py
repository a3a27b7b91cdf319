"""The serving engine's CUDA graphs on the card (serve/programs.py).

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs_cuda.py

Without a card every test here skips: a CUDA graph has no CPU mode, and
on the CPU the same programs run eagerly (tests/test_torch_serve_
programs.py holds them against the JAX engine there).

What a graph must keep, each checked here with the decode kernel on:
a replayed step equals the same program run eagerly
(`EngineConfig.cuda_graphs=False`) bit for bit — tokens and logprobs,
greedy and sampled rows, contiguous and paged, gpt2-test and llama-test
with an int8 cache (same kernels, same shapes, same generator state:
nothing may differ); the engine stays token-exact against generate()
(f32, where no near-tie can flip an argmax between two batch shapes);
the capture counts stay fixed over two traces and a reset(); a replay
draws new noise and a rewound generator replays the same draws; kernel
launches inside replays are counted; a graph survives a later, larger
launch that regrows the decode workspace; and an EOS costs the async
loop one junk step under replay, as it does eagerly.
"""
import numpy as np
import pytest
import torch

from mpi_operator_tpu_torch.models import create_lm, generate
from mpi_operator_tpu_torch.ops import attention as ops
from mpi_operator_tpu_torch.serve import EngineConfig, Request, ServingEngine
from mpi_operator_tpu_torch.serve.programs import Program

V = 256


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: a CUDA graph has no CPU "
                    "mode (the programs run eagerly on the CPU, tested in "
                    "test_torch_serve_programs.py)")
    return torch.device("cuda")


def _model(family, dtype=torch.bfloat16, kv=None, max_len=128):
    return create_lm(f"{family}-test", seed=0, dtype=dtype, vocab_size=V,
                     max_len=max_len, kv_cache_dtype=kv, decode_kernel=True)


def _trace(seed, n=10, sampled=True, eos=None):
    """Mixed prompt lengths and budgets; with `sampled`, every third
    request samples from the bounded pool and every third from the full
    vocab, so the steps run all three sampling modes."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        kind = i % 3 if sampled else 0
        out.append(Request(
            i, [int(t) for t in rs.randint(0, V, (int(rs.randint(3, 40)),))],
            max_new_tokens=int(rs.randint(5, 13)),
            temperature=(0.0, 0.8, 1.1)[kind], top_k=(0, 20, 0)[kind],
            top_p=(1.0, 1.0, 0.9)[kind], eos_id=eos))
    return out


def _engine(model, graphs=True, paged=False, **kw):
    extra = dict(paged=True, page_size=16) if paged else {}
    return ServingEngine(model, EngineConfig(
        slots=4, chunk_buckets=(8, 32), cuda_graphs=graphs, **extra, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("family,kv", [("gpt2", None), ("llama", "int8")])
@pytest.mark.parametrize("paged", [False, True])
def test_replay_is_bit_equal_to_eager(cuda_device, family, kv, paged):
    """The same trace through the engine with graphs and without: every
    token and every logprob equal, greedy and sampled rows; every
    program captured once, the eager engine capturing none."""
    model = _model(family, kv=kv)
    trace = _trace(1)
    on, off = _engine(model, True, paged), _engine(model, False, paged)
    a, b = on.run(trace), off.run(trace)
    for r in trace:
        assert a[r.id].tokens == b[r.id].tokens, f"request {r.id}"
        assert a[r.id].logprobs == b[r.id].logprobs, f"request {r.id}"
    assert on.compile_counts() == off.compile_counts()
    counts = on.compile_counts()
    assert on.capture_counts() == {"step": counts["step"],
                                   "prefill": counts["prefill"]}
    assert counts["step"] == 3                 # the trace ran every mode
    assert off.capture_counts() == {"step": 0, "prefill": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_token_exact_vs_generate_with_graphs(cuda_device, paged):
    """Greedy requests through the captured programs give generate()'s
    tokens, request by request (f32)."""
    model = _model("gpt2", dtype=torch.float32)
    trace = _trace(2, n=7, sampled=False)
    got = _engine(model, True, paged).run(trace)
    for r in trace:
        want = generate(model, [r.prompt], r.max_new_tokens)
        assert got[r.id].tokens == \
            want.tokens[0, len(r.prompt):].tolist(), f"request {r.id}"


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_capture_counts_fixed_over_traces_and_reset(cuda_device, paged):
    model = _model("gpt2")
    engine = _engine(model, True, paged)
    a = engine.run(_trace(4))
    first = (engine.compile_counts(), engine.capture_counts())
    engine.reset()
    engine.run(_trace(6, n=6))
    engine.reset()
    b = engine.run(_trace(4))
    assert (engine.compile_counts(), engine.capture_counts()) == first
    assert first[1]["step"] <= 3
    assert first[1]["prefill"] <= len(engine.config.chunk_buckets)
    for rid in a:                       # a reset engine replays its draws
        assert a[rid].tokens == b[rid].tokens


def _program(dev, fn, key=("step", False, "full"), generator=None):
    return Program(key, fn, [("x", (1,), np.int32)], dev, capture=True,
                   pool=torch.cuda.graph_pool_handle(),
                   stream=torch.cuda.Stream(dev), generator=generator)


@pytest.mark.cuda
def test_replays_draw_new_noise_and_a_rewound_generator_replays_them(
        cuda_device):
    """A sampled program registered with its generator: the first call
    (eager) and each replay draw what eager calls draw from the same
    generator, so two replays differ; manual_seed rewinds the replays."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    out = torch.zeros(4, 1000, device=cuda_device)

    def fn(_):
        out.copy_(torch.rand(out.shape, generator=gen, device=cuda_device))
    prog = _program(cuda_device, fn, generator=gen)
    draws = []
    for _ in range(3):
        prog()
        draws.append(out.clone())
    assert prog.graph is not None
    gen.manual_seed(3)
    eager = [torch.rand(out.shape, generator=gen, device=cuda_device)
             for _ in range(3)]
    for got, want in zip(draws, eager):
        assert torch.equal(got, want)
    assert not torch.equal(draws[1], draws[2])
    gen.manual_seed(3)
    prog()
    assert torch.equal(out, eager[0])


def _decode_inputs(dev, B, H, KV, L, D, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, D, generator=g, device=dev).bfloat16()
    k = torch.randn(B, KV, L, D, generator=g, device=dev).bfloat16()
    v = torch.randn(B, KV, L, D, generator=g, device=dev).bfloat16()
    cur = torch.randint(L // 2, L, (B,), generator=g, device=dev)
    return q, k, v, cur


@pytest.mark.cuda
def test_launch_counts_count_replays_not_captures(cuda_device):
    """A program holding one K4 launch: three calls (one eager, then the
    capture, two replays) count three launches."""
    q, k, v, cur = _decode_inputs(cuda_device, 2, 4, 2, 512, 64, 0)
    out = torch.empty_like(q)
    prog = _program(cuda_device, lambda _: out.copy_(
        ops.decode_attention(q, k, v, cur)), ("step", False, "greedy"))
    ops.reset_launch_counts()
    for _ in range(3):
        prog()
    torch.cuda.synchronize()
    assert ops.launch_counts["decode_attention"] == 3
    assert prog.launches == {"decode_attention": 1}
    assert torch.equal(out, ops.decode_attention(q, k, v, cur))


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_engine_launch_counts_are_layers_times_steps(cuda_device, paged):
    model = _model("gpt2")
    engine = _engine(model, True, paged)
    ops.reset_launch_counts()
    engine.run(_trace(5))
    torch.cuda.synchronize()
    name = "paged_decode_attention" if paged else "decode_attention"
    assert ops.launch_counts[name] == \
        model.config.num_layers * engine.steps_dispatched
    assert all(n == 0 for k, n in ops.launch_counts.items() if k != name)


@pytest.mark.cuda
def test_live_graph_survives_a_workspace_regrow(cuda_device):
    """A graph captured over the decode workspace, then an eager launch
    at a larger shape that regrows the per-device workspace, then the
    freed sizes allocated again and filled with junk: the replay still
    equals the eager launch, because the program holds the pair it
    captured. A launch that would regrow the workspace inside a capture
    raises instead."""
    q, k, v, cur = _decode_inputs(cuda_device, 1, 4, 2, 1024, 64, 1)
    out = torch.empty_like(q)
    prog = _program(cuda_device, lambda _: out.copy_(
        ops.decode_attention(q, k, v, cur)), ("step", False, "greedy"))
    ops._workspaces.clear()
    prog()                                   # runs eagerly, then captures
    held = [t.data_ptr() for t in prog.workspace]
    sizes = [(t.numel(), t.dtype) for t in prog.workspace]
    big = _decode_inputs(cuda_device, 8, 32, 16, 4096, 64, 2)
    ops.decode_attention(*big)
    assert [t.data_ptr() for t in ops.current_workspace(cuda_device)] != held
    del big
    junk = [torch.full((n,), -7, dtype=dt, device=cuda_device)
            for n, dt in sizes for _ in range(4)]
    out.zero_()
    prog()
    torch.cuda.synchronize()
    assert torch.equal(out, ops.decode_attention(q, k, v, cur))
    assert [t.data_ptr() for t in prog.workspace] == held
    del junk
    capturing = torch.cuda.is_current_stream_capturing
    try:
        torch.cuda.is_current_stream_capturing = lambda: True
        with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
            ops.decode_workspace(cuda_device, 16, 16, 8, 8, 128)
    finally:
        torch.cuda.is_current_stream_capturing = capturing


@pytest.mark.cuda
def test_eos_costs_one_junk_step_under_replay(cuda_device):
    """EOS retirements under replay: the async engine with graphs runs
    exactly the steps the eager async engine runs, at most one junk step
    per EOS over the sync engine, with the same tokens and reasons."""
    model = _model("gpt2", dtype=torch.float32)
    probe = _trace(6, n=1, sampled=False)[0]
    eos = generate(model, [probe.prompt], 8).tokens[0, len(probe.prompt)
                                                    + 2].item()
    trace = _trace(6, n=8, sampled=False, eos=eos)
    on, off = _engine(model, True), _engine(model, False)
    sync = _engine(model, True, async_decode=False)
    a, b, c = on.run(trace), off.run(trace), sync.run(trace)
    n_eos = sum(r.finish_reason == "eos" for r in a.values())
    assert n_eos > 0
    assert on.steps_dispatched == off.steps_dispatched
    assert 0 <= on.steps_dispatched - sync.steps_dispatched <= n_eos
    for r in trace:
        assert a[r.id].tokens == b[r.id].tokens == c[r.id].tokens
        assert a[r.id].finish_reason == c[r.id].finish_reason
