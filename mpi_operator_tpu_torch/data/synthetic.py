"""Synthetic data for training, made on the device: tokens for the LMs,
images for the image trainer.

The counterpart of `mpi_operator_tpu/data/synthetic.py`
(`synthetic_image_batch`, `SyntheticImageDataset`,
`synthetic_token_batch`) and of the step-keyed `TokenStream` of the
reference's LM benchmark (`examples/lm_benchmark.py`). Batches are drawn
on the device, so the input pipeline adds no host-to-device traffic.
Torch generators cannot give JAX's random bits: the tests feed both
sides the same numpy batches instead.

`TokenStream` is global, as the reference's is: batch i is drawn whole,
`batch_size` rows, from the generator seeded by (seed, i) on every rank,
and each rank keeps its rows (`rank_share`). A token batch is cheap to
draw, so an N-rank gang trains on exactly the batch one process trains
on. Under gradient accumulation a rank's rows are its share of each
microbatch (H16): the reference cuts the global batch into
`accum_steps` microbatches of consecutive rows and shards each over the
ranks, so rank r holds rows [m B/A + r b, m B/A + (r + 1) b) of each
microbatch m, b = B / (A W). The MLM mask is drawn over the global batch
and follows the tokens.

Over a model-parallel mesh (`mesh=`) a rank's rows are those of its
place on the batch axes (dcn, dp, fsdp): tp and ep ranks take the same
rows, and sp ranks the same rows and each its own sequence shard
(`mesh_share`).

`SyntheticImageDataset` is step-keyed too but yields this rank's b =
batch_size / world rows of the global batch, drawn from a generator
keyed by (seed, step, rank): each rank makes only its own rows, as the
reference's jit with sharded outputs makes only each device's shard (an
image batch is not cheap to draw whole). So the global batch of N ranks
is not the batch one rank would draw (the data-parallel parity tests
feed numpy batches).

The MLM stream (`TokenStream(..., masked_lm=True)`) is the reference's
BERT branch: a mask drawn from the same per-step generator with rate
MLM_MASK_RATE, targets the UNcorrupted tokens, inputs replaced by the
mask id `vocab - 1` where masked, and the mask as the third element of
the batch (the positions the loss scores).
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from ..parallel.mesh import BATCH_AXES
from ..utils.device import DeviceLike, rank_and_world, resolve_device

#: the BERT objective's corruption rate; the mask id is vocab - 1
MLM_MASK_RATE = 0.15


def synthetic_token_batch(generator: torch.Generator, batch_size: int,
                          seq_len: int, vocab_size: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One (tokens, targets) batch of int64 [batch_size, seq_len] on the
    generator's device: a row of seq_len + 1 uniform ids, targets the
    tokens shifted by one."""
    toks = torch.randint(0, vocab_size, (batch_size, seq_len + 1),
                         generator=generator, device=generator.device)
    return toks[:, :-1].contiguous(), toks[:, 1:].contiguous()


def synthetic_image_batch(generator: torch.Generator, batch_size: int,
                          image_size: int = 224, num_classes: int = 1000,
                          dtype: torch.dtype = torch.bfloat16
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One (images [B, H, W, 3] in `dtype`, labels int64 [B]) batch on
    the generator's device: standard-normal f32 pixels cast to dtype,
    uniform labels."""
    dev = generator.device
    images = torch.randn(batch_size, image_size, image_size, 3,
                         generator=generator, device=dev).to(dtype)
    labels = torch.randint(0, num_classes, (batch_size,),
                           generator=generator, device=dev)
    return images, labels


def rank_rows(batch_size: int, rank: int, world: int) -> slice:
    """The rows of a global batch of `batch_size` that `rank` owns."""
    if batch_size % world:
        raise ValueError(f"global batch {batch_size} does not split over "
                         f"{world} ranks")
    per = batch_size // world
    return slice(rank * per, (rank + 1) * per)


def rank_share(x, rank: int, world: int, accum_steps: int = 1):
    """This rank's rows of a global batch `x` ([B, ...], a tensor or a
    numpy array): its share of each of the `accum_steps` microbatches of
    consecutive rows, in microbatch order, so that splitting the share
    into `accum_steps` chunks gives the rank's part of each microbatch
    (H16)."""
    B, A = x.shape[0], accum_steps
    if B % (A * world):
        raise ValueError(f"global batch {B} does not split into "
                         f"{A} microbatch(es) over {world} ranks")
    if world == 1:
        return x
    rest = tuple(x.shape[1:])
    b = B // (A * world)
    return x.reshape((A, world, b) + rest)[:, rank].reshape((A * b,) + rest)


def seq_share(x, index: int, n: int):
    """Sequence shard `index` of `n` of a [B, S, ...] batch."""
    if n == 1:
        return x
    S = x.shape[1]
    if S % n:
        raise ValueError(f"sequence of {S} does not split over sp={n}")
    return x[:, index * (S // n):(index + 1) * (S // n)]


def placement(mesh=None):
    """(rank, world, sp index, sp) of this process's share of a global
    batch: its place on the mesh's batch axes and sequence axis, or with
    no mesh its rank and world in the process group."""
    if mesh is None:
        rank, world = rank_and_world()
        return rank, world, 0, 1
    return (mesh.position(), mesh.dim_size(BATCH_AXES),
            mesh.coords()["sp"], mesh.shape["sp"])


def mesh_share(x, mesh=None, accum_steps: int = 1):
    """This rank's part of a global [B, S, ...] batch: its rows
    (`rank_share` at its place on the batch axes) and, under sp, its
    sequence shard of them."""
    rank, world, i, n = placement(mesh)
    return seq_share(rank_share(x, rank, world, accum_steps), i, n)


def _step_seed(seed: int, step: int, *more: int) -> int:
    """The 64-bit seed of batch `step` of a stream seeded `seed` (and of
    the part of it that `more`, e.g. a rank, names)."""
    return int(np.random.SeedSequence([seed, step, *more]).generate_state(
        1, np.uint64)[0])


class TokenStream:
    """Step-keyed synthetic batches: global batch i (`batch_size` rows)
    comes from its own torch.Generator seeded by (seed, i), so a stream
    started at step N yields exactly the batches an uninterrupted stream
    yields from N on; this rank keeps its rows of it (`rank_share`, with
    the rank and world of the process group, or its place on `mesh`'s
    batch axes and its sequence shard under sp: `mesh_share`).
    (tokens, targets), or with `masked_lm` (corrupted tokens, original
    tokens, f32 mask). Runs on the CUDA card unless `device="cpu"`."""

    def __init__(self, batch_size: int, seq_len: int, vocab_size: int,
                 seed: int = 1, start: int = 0, device: DeviceLike = None,
                 masked_lm: bool = False, accum_steps: int = 1, mesh=None):
        self.rank, self.world, self.sp_index, self.sp = placement(mesh)
        if batch_size % (accum_steps * self.world):
            raise ValueError(f"global batch {batch_size} does not split "
                             f"into {accum_steps} microbatch(es) over "
                             f"{self.world} ranks")
        self.accum_steps = accum_steps
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.seed = seed
        self.step = start
        self.device = resolve_device(device)
        self.masked_lm = masked_lm

    def batch(self, step: int) -> Tuple[torch.Tensor, ...]:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_step_seed(self.seed, step))
        toks, tgts = synthetic_token_batch(gen, self.batch_size,
                                           self.seq_len, self.vocab_size)
        out = (toks, tgts)
        if self.masked_lm:
            mask = torch.rand(toks.shape, generator=gen,
                              device=self.device) < MLM_MASK_RATE
            out = (torch.where(mask, self.vocab_size - 1, toks), toks,
                   mask.float())
        return tuple(seq_share(rank_share(t, self.rank, self.world,
                                          self.accum_steps),
                               self.sp_index, self.sp) for t in out)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, ...]]:
        return self

    def __next__(self) -> Tuple[torch.Tensor, ...]:
        out = self.batch(self.step)
        self.step += 1
        return out


class SyntheticImageDataset:
    """Step-keyed synthetic image batches (see the module docstring):
    this rank's rows of global batch i come from their own generator
    seeded by (seed, i, rank), with the rank and world of the process
    group. Runs on the CUDA card unless `device="cpu"`."""

    def __init__(self, batch_size: int, image_size: int = 224,
                 num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 start: int = 0, device: DeviceLike = None):
        self.rank, world = rank_and_world()
        self.rows = rank_rows(batch_size, self.rank, world)
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_classes = num_classes
        self.dtype = dtype
        self.seed = seed
        self.step = start
        self.device = resolve_device(device)

    def batch(self, step: int) -> Tuple[torch.Tensor, torch.Tensor]:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_step_seed(self.seed, step, self.rank))
        return synthetic_image_batch(
            gen, self.rows.stop - self.rows.start, self.image_size,
            self.num_classes, self.dtype)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        return self

    def __next__(self) -> Tuple[torch.Tensor, torch.Tensor]:
        out = self.batch(self.step)
        self.step += 1
        return out


__all__ = ["MLM_MASK_RATE", "SyntheticImageDataset", "TokenStream",
           "mesh_share", "placement", "rank_rows", "rank_share",
           "seq_share", "synthetic_image_batch", "synthetic_token_batch"]
