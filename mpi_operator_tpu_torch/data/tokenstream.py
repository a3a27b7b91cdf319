"""Real-data token pipeline for the LM workloads — the `data_dir` path.

The counterpart of `mpi_operator_tpu/data/tokenstream.py`, with its
semantics: flat pre-tokenized corpora as `<stem>_tokens.npy` (a 1-D
integer array per shard, one long token stream per file); a shuffled
shard order per epoch from one `RandomState(seed)`; contiguous
`[B, seq_len + 1]` windows cut in order within a shard, then
`tokens = window[:, :-1]`, `targets = window[:, 1:]`; every batch
checked against the vocabulary; a feeder thread (data/prefetch.py) so
the feed overlaps the train step.

The host-to-device copy is the consumer's, not the feeder's. A copy
issued on the feeder thread would run on that thread's stream, and the
train step on the default stream could read the batch before it lands.
So the feeder yields CPU tensors (pinned when the target is the card)
and `__next__` issues the `non_blocking` copy on the consumer's current
stream: stream order alone makes the step wait for its batch, and the
pinned block is not reused before its copy completes (the caching host
allocator records the copy's stream). Batches arrive as int64 on the
dataset's device, the trainer's dtype for token ids.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from .prefetch import PrefetchDataset
from .synthetic import MLM_MASK_RATE


def discover_token_shards(data_dir: str):
    """Sorted `<stem>_tokens.npy` shard paths under data_dir."""
    shards = [os.path.join(data_dir, f) for f in sorted(os.listdir(data_dir))
              if f.endswith("_tokens.npy")]
    if not shards:
        raise FileNotFoundError(
            f"no <stem>_tokens.npy shards in {data_dir!r}")
    return shards


class NpyTokenDataset(PrefetchDataset):
    """Infinite (tokens [B, S], targets [B, S]) iterator over packed token
    shards, on the CUDA card unless `device="cpu"`. Deterministic
    shuffled shard order per epoch; windows within a shard are cut
    sequentially. `vocab_size` (when given) validates every batch — an
    out-of-range id means the shards were tokenized for a different
    vocabulary, which would otherwise surface as a garbage gather.

    `host_transform(window [B, S+1] np.int32) -> tuple of np arrays`
    runs on the feeder thread (objectives that rewrite tokens stay off
    the timed path); each array it returns arrives as a tensor on the
    device, integer arrays as int64. Default: the next-token split."""

    def __init__(self, data_dir: str, batch_size: int, seq_len: int,
                 device: DeviceLike = None, seed: int = 0, prefetch: int = 2,
                 vocab_size: Optional[int] = None,
                 host_transform: Optional[Callable] = None):
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.device = resolve_device(device)
        self._host_transform = host_transform or (
            lambda win: (win[:, :-1], win[:, 1:]))
        self._shards = discover_token_shards(data_dir)
        self._seed = seed
        window = seq_len + 1
        max_rows = 0
        for path in self._shards:
            arr = np.load(path, mmap_mode="r")      # header read only
            if arr.ndim != 1 or not np.issubdtype(arr.dtype, np.integer):
                raise ValueError(
                    f"shard {path!r} must be a 1-D integer token stream, "
                    f"got shape {arr.shape} dtype {arr.dtype}")
            max_rows = max(max_rows, arr.shape[0] // window)
        if max_rows < batch_size:
            raise ValueError(
                f"every shard is shorter than one batch "
                f"({max_rows} windows of {window} tokens < batch "
                f"{batch_size}); no batch can ever be produced")
        self._start_feeder(prefetch)

    def _host_batches(self):
        rng = np.random.RandomState(self._seed)
        order = np.arange(len(self._shards))
        window = self.seq_len + 1
        while True:
            rng.shuffle(order)
            for si in order:
                stream = np.load(self._shards[si], mmap_mode="r")
                rows = stream.shape[0] // window
                rows -= rows % self.batch_size
                for lo in range(0, rows, self.batch_size):
                    flat = np.asarray(
                        stream[lo * window:(lo + self.batch_size) * window])
                    yield flat.reshape(self.batch_size, window)

    def _host_tensor(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if not t.is_floating_point():
            t = t.long()
        return t.pin_memory() if self.device.type == "cuda" else t

    def _produce(self):
        for win in self._host_batches():
            if self.vocab_size is not None:
                lo, hi = int(win.min()), int(win.max())
                if lo < 0 or hi >= self.vocab_size:
                    bad = lo if lo < 0 else hi
                    raise ValueError(
                        f"token id {bad} out of range for vocab_size="
                        f"{self.vocab_size}; the shards were tokenized "
                        f"for a different vocabulary")
            win = win.astype(np.int32)
            yield tuple(self._host_tensor(a)
                        for a in self._host_transform(win))

    def __next__(self):
        host = super().__next__()
        return tuple(t.to(self.device, non_blocking=True) for t in host)


def mlm_host_transform(vocab_size: int) -> Callable:
    """The BERT objective over shard windows, the reference's
    `host_transform` for `--data-dir` with bert: one RandomState(3) (the
    reference's seed) draws each batch's mask (rate MLM_MASK_RATE) in
    feed order; returns (inputs with the mask id vocab - 1 at the masked
    slots, the original tokens, the f32 mask)."""
    rng = np.random.RandomState(3)

    def transform(win):
        toks = win[:, :-1]
        mask = rng.random_sample(toks.shape) < MLM_MASK_RATE
        return (np.where(mask, vocab_size - 1, toks).astype(np.int32),
                toks, mask.astype(np.float32))
    return transform


def write_token_shard(data_dir: str, stem: str, tokens: np.ndarray) -> None:
    """Helper for producing the shard format (tests, dataset prep)."""
    os.makedirs(data_dir, exist_ok=True)
    np.save(os.path.join(data_dir, f"{stem}_tokens.npy"), tokens)


__all__ = ["NpyTokenDataset", "discover_token_shards", "mlm_host_transform",
           "write_token_shard"]
