"""Real-data image pipeline — the `data_dir` path of the image benchmark.

The counterpart of `mpi_operator_tpu/data/imagefolder.py`, with its
format and semantics: `.npy` shard pairs (`<stem>_images.npy` uint8 (or
f32) [N, H, W, 3] + `<stem>_labels.npy` int [N]); a shuffled shard order
per epoch from one `RandomState(seed)`; batches cut in order within a
shard; pixels normalised with the ImageNet channel statistics in f32,
then cast; a feeder thread (data/prefetch.py) so the feed overlaps the
train step; `use_native` "auto" (the C++ loader of native/ when it
builds, else Python), "always" or "never". The native loader orders its
shards with its own generator, so the two paths give the same batches
for one shard and differ in shard order across several, as in the
reference.

`batch_size` is the GLOBAL batch, as the reference's: each rank reads
the global batch and keeps its own rows (data/synthetic.py `rank_rows`),
which is what the reference's sharded device_put gives each device. The
host-to-device copy is the consumer's: the feeder yields CPU tensors
(pinned when the target is the card) and `__next__` issues the
non-blocking copy on the consumer's current stream (see
data/tokenstream.py). Images arrive in `dtype`, labels as int64.
"""
from __future__ import annotations

import os
import numpy as np
import torch

from ..utils.device import DeviceLike, rank_and_world, resolve_device
from .prefetch import PrefetchDataset
from .synthetic import rank_rows

# ImageNet channel stats, matching tf_cnn_benchmarks preprocessing
_MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255.0
_STD = np.array([0.229, 0.224, 0.225], np.float32) * 255.0


def discover_shards(data_dir: str):
    """Sorted (images.npy, labels.npy) shard pairs under data_dir."""
    pairs = []
    for fname in sorted(os.listdir(data_dir)):
        if fname.endswith("_images.npy"):
            stem = fname[: -len("_images.npy")]
            lbl = os.path.join(data_dir, stem + "_labels.npy")
            if os.path.exists(lbl):
                pairs.append((os.path.join(data_dir, fname), lbl))
    if not pairs:
        raise FileNotFoundError(
            f"no <stem>_images.npy / <stem>_labels.npy shard pairs in "
            f"{data_dir!r}")
    return pairs


class NpyImageDataset(PrefetchDataset):
    """Infinite (images [b, H, W, 3], labels [b]) iterator over on-disk
    npy shards, b = this rank's share of `batch_size`, on the CUDA card
    unless `device="cpu"`."""

    def __init__(self, data_dir: str, batch_size: int,
                 image_size: int = 224,
                 dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None, seed: int = 0,
                 prefetch: int = 2, use_native: str = "auto"):
        self.batch_size = batch_size
        self.image_size = image_size
        self.dtype = dtype
        self.device = resolve_device(device)
        self.rows = rank_rows(batch_size, *rank_and_world())
        self._shards = discover_shards(data_dir)
        if use_native not in ("auto", "never", "always"):
            raise ValueError(f"use_native={use_native!r}")
        # fail fast instead of a silent empty-queue hang: at least one shard
        # must be able to cut a full batch (mmap header read only)
        max_rows = 0
        for img, _ in self._shards:
            arr = np.load(img, mmap_mode="r")   # header read only
            max_rows = max(max_rows, arr.shape[0])
            # every shard must match the requested resolution, or throughput
            # numbers would be silently mislabeled
            if arr.ndim != 4 or arr.shape[1:3] != (image_size, image_size):
                raise ValueError(
                    f"shard {img!r} has image shape {arr.shape[1:]} but "
                    f"--image-size is {image_size}; re-export the shards "
                    f"or pass the matching --image-size")
        if max_rows < batch_size:
            raise ValueError(
                f"every shard is smaller ({max_rows} rows) than the batch "
                f"size ({batch_size}); no batch can ever be produced")
        self._seed = seed
        self._pin = self.device.type == "cuda"
        self._native = None
        if use_native != "never":
            try:
                from ..native import NativeShardLoader, native_available
                if use_native == "always" or native_available():
                    self._native = NativeShardLoader(
                        self._shards, batch_size,
                        (image_size, image_size, 3), dtype=dtype,
                        mean=_MEAN.tolist(), std=_STD.tolist(), seed=seed)
            except Exception:  # noqa: BLE001 — fall back to Python
                if use_native == "always":
                    raise
                self._native = None
        self._start_feeder(prefetch)

    # -- host side ---------------------------------------------------------

    def _host_batches(self):
        rng = np.random.RandomState(self._seed)
        order = np.arange(len(self._shards))
        while True:
            rng.shuffle(order)
            for si in order:
                img_path, lbl_path = self._shards[si]
                images = np.load(img_path, mmap_mode="r")
                labels = np.load(lbl_path, mmap_mode="r")
                n = images.shape[0] - images.shape[0] % self.batch_size
                for lo in range(0, n, self.batch_size):
                    yield (np.asarray(images[lo:lo + self.batch_size]),
                           np.asarray(labels[lo:lo + self.batch_size]))

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        t = t[self.rows].contiguous()
        return t.pin_memory() if self._pin else t

    def _produce(self):
        if self._native is not None:
            for images, labels in self._native:
                yield self._host(images), self._host(labels.long())
            return
        for raw_images, raw_labels in self._host_batches():
            x = (raw_images.astype(np.float32) - _MEAN) / _STD
            yield (self._host(torch.from_numpy(x).to(self.dtype)),
                   self._host(torch.from_numpy(
                       raw_labels.astype(np.int64))))

    def __next__(self):
        images, labels = super().__next__()
        return (images.to(self.device, non_blocking=True),
                labels.to(self.device, non_blocking=True))

    def close(self):
        super().close()
        if self._native is not None:
            self._native.close()


def write_npy_shard(data_dir: str, stem: str, images: np.ndarray,
                    labels: np.ndarray) -> None:
    """Helper for producing the shard format (tests, dataset prep)."""
    os.makedirs(data_dir, exist_ok=True)
    np.save(os.path.join(data_dir, f"{stem}_images.npy"), images)
    np.save(os.path.join(data_dir, f"{stem}_labels.npy"), labels)


__all__ = ["NpyImageDataset", "discover_shards", "write_npy_shard"]
