"""Where the port runs.

Every entry point of the port (`create_lm`, `generate`, `ServingEngine`)
runs on the CUDA card unless its caller asks for the CPU by name. There
is no quiet fallback: with no card and no explicit `device="cpu"` the
entry point raises, so a run that was meant for the card can never turn
into a CPU run that reports numbers under the card's name.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means the CUDA card (and raises without one); `"cpu"` (or a
    CPU `torch.device`) is the explicit opt-in the CPU tests use; any
    other CUDA spelling (`"cuda:1"`) is checked against the cards
    present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card "
                "by default — pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={device!r} asked for CUDA, but no "
                               f"CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise ValueError(f"device={device!r}: only "
                             f"{torch.cuda.device_count()} CUDA device(s)")
    elif dev.type != "cpu":
        raise ValueError(f"device={device!r}: expected 'cuda' or 'cpu'")
    return dev


def rank_and_world():
    """(rank, world size) of the torch.distributed group this process
    joined; (0, 1) when it joined none."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


__all__ = ["rank_and_world", "resolve_device"]
