"""The port's input pipeline (data/prefetch.py, data/tokenstream.py) and
profiler window (utils/profiling.py) against the JAX package's, on the
CPU.

PrefetchDataset keeps tests/test_prefetch.py's contract: FIFO order
through the feeder thread, bounded read-ahead, a sticky StopIteration,
feeder errors re-raised in the consumer, and a close() that unblocks
the feeder. NpyTokenDataset gives the JAX dataset's batches token for
token over the same numpy-written shards (shuffled shard order per
epoch from one seed, windows in order within a shard, across several
epochs), as int64 tensors on the asked device; it refuses out-of-vocab
ids, shards shorter than one batch, shards that are not 1-D integer
streams and a directory with no shards; its host_transform hook runs on
the feeder. run_lm_benchmark trains on shards with `data_dir`. The
profiler window writes a chrome trace of the benchmark's first window
and is stopped when the window raises.
"""
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from mpi_operator_tpu.data import tokenstream as jts
from mpi_operator_tpu_torch.data import tokenstream as tts
from mpi_operator_tpu_torch.data.prefetch import PrefetchDataset
from mpi_operator_tpu_torch.examples.lm_benchmark import run_lm_benchmark
from mpi_operator_tpu_torch.utils.profiling import WindowProfiler


# ---------------------------------------------------------------------------
# PrefetchDataset (tests/test_prefetch.py, on the port's copy)
# ---------------------------------------------------------------------------

class _ListDataset(PrefetchDataset):
    """Finite producer over `items`; optionally gates each yield on an
    event so tests can control how far ahead the feeder runs."""

    def __init__(self, items, prefetch=2, gate=None, fail_at=None):
        self.items = list(items)
        self.gate = gate
        self.fail_at = fail_at
        self.produced = 0
        self._start_feeder(prefetch)

    def _produce(self):
        for it in self.items:
            if self.gate is not None:
                self.gate.wait()
            if self.fail_at is not None and self.produced == self.fail_at:
                raise ValueError("injected producer failure")
            self.produced += 1
            yield it


def test_prefetch_preserves_order():
    ds = _ListDataset(range(50), prefetch=3)
    try:
        assert list(ds) == list(range(50))
    finally:
        ds.close()


def test_prefetch_depth_is_bounded():
    # an unconsumed iterator may run at most `prefetch` items ahead into
    # the queue plus one more blocked in put() — never the whole stream
    ds = _ListDataset(range(100), prefetch=2)
    try:
        deadline = time.monotonic() + 5.0
        while ds.produced < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)                      # would overrun here if unbounded
        assert ds.produced <= 3              # prefetch + 1 in-flight
        assert next(ds) == 0                 # consuming frees one slot
        deadline = time.monotonic() + 5.0
        while ds.produced < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ds.produced == 4
    finally:
        ds.close()


def test_prefetch_exhaustion_raises_stopiteration_repeatably():
    ds = _ListDataset([1, 2], prefetch=2)
    try:
        assert next(ds) == 1
        assert next(ds) == 2
        with pytest.raises(StopIteration):
            next(ds)
        with pytest.raises(StopIteration):   # sticky, never blocks
            next(ds)
        ds2 = _ListDataset("ab", prefetch=1)
        assert list(ds2) == ["a", "b"]
        ds2.close()
    finally:
        ds.close()


def test_prefetch_feeder_error_surfaces_in_consumer():
    ds = _ListDataset(range(10), prefetch=2, fail_at=1)
    try:
        assert next(ds) == 0
        with pytest.raises(RuntimeError, match="feeder thread failed"):
            for _ in range(10):
                next(ds)
    finally:
        ds.close()


def test_prefetch_close_unblocks_feeder():
    gate = threading.Event()
    gate.set()
    ds = _ListDataset(range(10_000), prefetch=1, gate=gate)
    try:
        assert next(ds) == 0
    finally:
        ds.close()
    assert not ds._thread.is_alive()


# ---------------------------------------------------------------------------
# NpyTokenDataset against the JAX one
# ---------------------------------------------------------------------------

VOCAB = 97


def _shards(tmp_path, lengths=(300, 171, 520, 95), seed=0):
    rs = np.random.RandomState(seed)
    for i, n in enumerate(lengths):
        dtype = np.uint16 if i % 2 else np.int32
        tts.write_token_shard(str(tmp_path), f"part{i:02d}",
                              rs.randint(0, VOCAB, n).astype(dtype))
    return str(tmp_path)


@pytest.mark.parametrize("batch,seq,seed", [(2, 16, 0), (3, 7, 5)])
def test_batches_equal_the_reference_token_for_token(tmp_path, batch, seq,
                                                     seed):
    """Over several epochs of four shards (two shorter than some batch
    counts, mixed dtypes), the port yields the JAX dataset's batches in
    the same order, as int64 CPU tensors."""
    data = _shards(tmp_path)
    assert tts.discover_token_shards(data) == jts.discover_token_shards(data)
    dev = jax.devices("cpu")[0]
    want = jts.NpyTokenDataset(data, batch, seq, sharding=dev, seed=seed,
                               vocab_size=VOCAB)
    got = tts.NpyTokenDataset(data, batch, seq, device="cpu", seed=seed,
                              vocab_size=VOCAB)
    try:
        for _ in range(60):
            (jt, jg), (t, g) = next(want), next(got)
            assert t.dtype == g.dtype == torch.int64
            assert t.shape == g.shape == (batch, seq)
            np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
            np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    finally:
        want.close()
        got.close()


def test_host_transform_runs_on_the_feeder(tmp_path):
    data = _shards(tmp_path)
    threads = set()

    def transform(win):
        threads.add(threading.current_thread().name)
        toks = win[:, :-1]
        return toks, win[:, 1:], (toks % 2).astype(np.float32)

    ds = tts.NpyTokenDataset(data, 2, 8, device="cpu",
                             host_transform=transform)
    try:
        toks, tgts, mask = next(ds)
        assert toks.dtype == tgts.dtype == torch.int64
        assert mask.dtype == torch.float32
        assert torch.equal(mask, (toks % 2).float())
        assert threading.current_thread().name not in threads
    finally:
        ds.close()


def test_dataset_refuses_bad_shards(tmp_path):
    with pytest.raises(FileNotFoundError, match="no <stem>_tokens.npy"):
        tts.NpyTokenDataset(str(tmp_path), 2, 8, device="cpu")
    tts.write_token_shard(str(tmp_path / "short"), "a",
                          np.arange(20, dtype=np.int32))
    with pytest.raises(ValueError, match="shorter than one batch"):
        tts.NpyTokenDataset(str(tmp_path / "short"), 4, 8, device="cpu")
    tts.write_token_shard(str(tmp_path / "flat"), "a",
                          np.zeros((4, 30), np.int32))
    with pytest.raises(ValueError, match="1-D integer"):
        tts.NpyTokenDataset(str(tmp_path / "flat"), 2, 8, device="cpu")
    tts.write_token_shard(str(tmp_path / "vocab"), "a",
                          np.full(200, VOCAB + 3, np.int32))
    ds = tts.NpyTokenDataset(str(tmp_path / "vocab"), 2, 8, device="cpu",
                             vocab_size=VOCAB)
    try:
        with pytest.raises(RuntimeError, match="feeder") as exc:
            next(ds)
        assert "out of range for vocab_size" in str(exc.value.__cause__)
    finally:
        ds.close()


def test_run_lm_benchmark_trains_on_shards(tmp_path):
    rs = np.random.RandomState(3)
    for i in range(2):
        tts.write_token_shard(str(tmp_path / "data"), f"s{i}",
                              rs.randint(0, 256, 2000).astype(np.int32))
    logs = []
    state, m = run_lm_benchmark(
        "gpt2", "test", batch_per_device=2, seq_len=16, num_steps=4,
        warmup_steps=1, dtype_name="float32", data_dir=str(tmp_path / "data"),
        device="cpu", log=logs.append)
    assert state.step == 5 and len(m["step_losses"]) == 4
    assert all(np.isfinite(x) for x in m["step_losses"])
    # the gpt2 vocabulary is 50257+: ids < 256 pass its check
    with pytest.raises(RuntimeError, match="feeder"):
        tts.write_token_shard(str(tmp_path / "bad"), "s",
                              np.full(400, 60_000, np.int32))
        run_lm_benchmark("gpt2", "test", batch_per_device=2, seq_len=16,
                         num_steps=1, dtype_name="float32",
                         data_dir=str(tmp_path / "bad"), device="cpu",
                         log=logs.append)


# ---------------------------------------------------------------------------
# the profiler window
# ---------------------------------------------------------------------------

def test_profile_dir_writes_the_first_window(tmp_path):
    logs = []
    _, m = run_lm_benchmark(
        "gpt2", "test", batch_per_device=2, seq_len=16, num_steps=4,
        warmup_steps=1, dtype_name="float32", profile_dir=str(tmp_path),
        device="cpu", log=logs.append)
    traces = list(tmp_path.glob("trace_*.json"))
    assert len(traces) == 1                   # the first window only
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "train.step" in names              # the loop's span
    assert any("profiler trace written" in line for line in logs)
    assert np.isfinite(m["final_loss"])


def test_profiler_stops_when_the_window_raises(tmp_path):
    class Boom(Exception):
        pass

    prof = WindowProfiler(str(tmp_path), lambda s: None)
    with pytest.raises(Boom):
        prof.start()
        try:
            assert prof.active
            raise Boom
        finally:
            prof.stop_if_active()
    assert not prof.active and prof.trace_path is not None
    # no session leaked: a second window starts and stops cleanly
    again = WindowProfiler(str(tmp_path), lambda s: None)
    again.start()
    again.stop_if_active()
    assert len(list(tmp_path.glob("trace_*.json"))) == 2
    WindowProfiler(None).start()              # disabled: a no-op


def test_benchmark_stops_the_profiler_when_a_step_raises(tmp_path):
    """An exception inside the profiled window (here the stream fails on
    the second timed step) leaves no profiler running."""
    from mpi_operator_tpu_torch.data import TokenStream
    from mpi_operator_tpu_torch.models.transformer import gpt2_config
    from mpi_operator_tpu_torch.train import LMTrainer, LMTrainerConfig

    cfg = gpt2_config("test", attention="dense", dtype=torch.float32,
                      vocab_size=64, max_len=32)
    tr = LMTrainer(cfg, LMTrainerConfig(global_batch_size=2, seq_len=16),
                   device="cpu")
    stream = TokenStream(2, 16, 64, device="cpu")

    def failing():
        for i in range(3):
            yield next(stream)
        raise RuntimeError("stream died")

    with pytest.raises(RuntimeError, match="stream died"):
        tr.benchmark(tr.init_state(0), failing(), num_steps=8,
                     warmup_steps=1, log=lambda s: None,
                     profile_dir=str(tmp_path))
    assert len(list(tmp_path.glob("trace_*.json"))) == 1
    assert torch.autograd.profiler._is_profiler_enabled is False
