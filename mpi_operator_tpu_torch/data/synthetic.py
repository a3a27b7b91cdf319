"""Synthetic token data for LM training, made on the device.

The counterpart of `mpi_operator_tpu/data/synthetic.py::
synthetic_token_batch` and of the step-keyed `TokenStream` of the
reference's LM benchmark (`examples/lm_benchmark.py`). Batches are drawn
on the device, so the input pipeline adds no host-to-device traffic.
Torch generators cannot give JAX's random bits: the tests feed both
sides the same numpy tokens instead.

The MLM stream (`TokenStream(..., masked_lm=True)`) is the reference's
BERT branch: a mask drawn from the same per-step generator with rate
MLM_MASK_RATE, targets the UNcorrupted tokens, inputs replaced by the
mask id `vocab - 1` where masked, and the mask as the third element of
the batch (the positions the loss scores).
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

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


def _step_seed(seed: int, step: int) -> int:
    """The 64-bit seed of batch `step` of a stream seeded `seed`."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


class TokenStream:
    """Step-keyed synthetic batches: batch i comes from its own
    torch.Generator seeded by (seed, i), so a stream started at step N
    yields exactly the batches an uninterrupted stream yields from N on.
    (tokens, targets), or with `masked_lm` (corrupted tokens, original
    tokens, f32 mask). Runs on the CUDA card unless `device="cpu"`."""

    def __init__(self, batch_size: int, seq_len: int, vocab_size: int,
                 seed: int = 1, start: int = 0, device: DeviceLike = None,
                 masked_lm: bool = False):
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
        if not self.masked_lm:
            return toks, tgts
        mask = torch.rand(toks.shape, generator=gen,
                          device=self.device) < MLM_MASK_RATE
        return (torch.where(mask, self.vocab_size - 1, toks), toks,
                mask.float())

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, ...]]:
        return self

    def __next__(self) -> Tuple[torch.Tensor, ...]:
        out = self.batch(self.step)
        self.step += 1
        return out


__all__ = ["MLM_MASK_RATE", "TokenStream", "synthetic_token_batch"]
