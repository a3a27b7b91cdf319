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

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)


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


# ---------------------------------------------------------------------------
# NpyImageDataset and the native loader (data/imagefolder.py, native/)
# ---------------------------------------------------------------------------

def _image_shards(tmp_path, shards=1, n=16, size=8):
    from mpi_operator_tpu_torch.data.imagefolder import write_npy_shard
    rs = np.random.RandomState(0)
    for i in range(shards):
        write_npy_shard(str(tmp_path), f"s{i}",
                        rs.randint(0, 256, (n, size, size, 3)).astype(
                            np.uint8),
                        rs.randint(0, 1000, (n,)).astype(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_native_image_batches_byte_equal_python_and_the_reference(
        tmp_path, dtype):
    """One shard (the native loader orders several shards with its own
    generator, as the reference's does): the port's C++ loader, the
    port's Python path and the JAX NpyImageDataset (Python path) give
    the same bytes, batch after batch, labels as integers."""
    import jax.numpy as jnp
    from mpi_operator_tpu.data.imagefolder import NpyImageDataset as JDS
    from mpi_operator_tpu_torch.data.imagefolder import NpyImageDataset
    from mpi_operator_tpu_torch.native import native_available
    assert native_available(), "g++ is part of the port's toolchain"
    _image_shards(tmp_path)
    tdt = getattr(torch, dtype)
    native = NpyImageDataset(str(tmp_path), 4, image_size=8, dtype=tdt,
                             device="cpu", use_native="always")
    python = NpyImageDataset(str(tmp_path), 4, image_size=8, dtype=tdt,
                             device="cpu", use_native="never")
    ref = JDS(str(tmp_path), 4, image_size=8, dtype=getattr(jnp, dtype),
              use_native="never")
    try:
        assert native._native is not None and python._native is None
        for _ in range(6):                      # past one epoch
            (xn, yn), (xp, yp), (xr, yr) = next(native), next(python), \
                next(ref)
            assert xn.dtype == xp.dtype == tdt
            bits = torch.int16 if dtype == "bfloat16" else torch.int32
            want = torch.from_numpy(np.asarray(xr).view(
                np.int16 if dtype == "bfloat16" else np.int32))
            assert torch.equal(xn.view(bits), xp.view(bits))
            assert torch.equal(xp.view(bits), want)
            assert yn.dtype == torch.int64
            assert torch.equal(yn, yp) and yp.tolist() == np.asarray(
                yr).tolist()
    finally:
        native.close()
        python.close()
        ref.close()


def test_image_dataset_keeps_this_ranks_rows_and_refuses_bad_shards(
        tmp_path, monkeypatch):
    """Rank r of w gets rows [r b, (r+1) b) of the global batch (rank 1
    of 2 stood in for the process group); a shard at another resolution
    and one shorter than a batch are refused."""
    from mpi_operator_tpu_torch.data import imagefolder
    from mpi_operator_tpu_torch.data.imagefolder import NpyImageDataset
    _image_shards(tmp_path)
    whole = NpyImageDataset(str(tmp_path), 8, image_size=8, device="cpu",
                            dtype=torch.float32, use_native="never")
    monkeypatch.setattr(imagefolder, "rank_and_world", lambda: (1, 2))
    half = NpyImageDataset(str(tmp_path), 8, image_size=8, device="cpu",
                           dtype=torch.float32, use_native="never")
    try:
        (xw, yw), (xh, yh) = next(whole), next(half)
        assert torch.equal(xh, xw[4:]) and torch.equal(yh, yw[4:])
    finally:
        whole.close()
        half.close()
    with pytest.raises(ValueError, match="image-size"):
        NpyImageDataset(str(tmp_path), 4, image_size=16, device="cpu")
    with pytest.raises(ValueError, match="smaller"):
        NpyImageDataset(str(tmp_path), 32, image_size=8, device="cpu")


def test_synthetic_images_draw_only_this_ranks_rows(monkeypatch):
    """Each rank draws only its b = batch / world rows, from a generator
    keyed by (seed, step, rank): ranks differ, and a rank's batch i is
    the same whenever it is drawn (a resumed stream); one process draws
    the whole batch."""
    from mpi_operator_tpu_torch.data import synthetic

    def stream(rank, world, start=0):
        monkeypatch.setattr(synthetic, "rank_and_world",
                            lambda: (rank, world))
        return synthetic.SyntheticImageDataset(
            8, image_size=8, num_classes=10, dtype=torch.float32, seed=3,
            start=start, device="cpu")
    r0, r1 = stream(0, 2), stream(1, 2)
    (x0, y0), (x1, y1) = next(r0), next(r1)
    assert x0.shape == (4, 8, 8, 3) and y0.shape == (4,)
    assert not torch.equal(x0, x1)
    next(r1)
    x12, y12 = next(r1)
    assert torch.equal(x12, stream(1, 2, start=2).batch(2)[0])
    assert torch.equal(y12, stream(1, 2, start=2).batch(2)[1])
    solo = stream(0, 1).batch(0)
    assert solo[0].shape == (8, 8, 8, 3)
    assert torch.equal(solo[0], stream(0, 1, start=5).batch(0)[0])
