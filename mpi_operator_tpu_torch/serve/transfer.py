"""Paged-KV handoff between serving pools (PyTorch).

The counterpart of `mpi_operator_tpu/serve/transfer.py`. The
disaggregated engine (serve/engine.py DisaggEngine) runs prefill and
decode in separate pools; when a prompt finishes prefilling, its KV lives
in the prefill pool's page pools and must move into the decode pool's.
Every paged cache tensor puts the page axis first — k/v [NP, KV, ps, D],
the int8 scale planes [NP, KV, ps] — so one gather along axis 0 and one
scatter along axis 0 move a page list for every dtype alike: int8 pages
travel with their scale rows, nothing is dequantized on the way.

A handoff is, per cache tensor of every layer:

    payload = src.index_select(0, src_ids)     # on the source device
    payload = payload.to(dst_device)           # across cards only
    dst.index_copy_(0, dst_ids, payload)       # in place on the dest

Only occupied pages move: the caller passes the physical ids of the
pages holding written prompt positions, minus those the destination
resolved from its own prefix cache (they need no bytes). The scatter
writes in place, so the decode pool's CUDA graphs, which captured the
pool's addresses, read the new pages.

Ordering is the device's, not the host's. Every call is enqueued on the
current stream of its device, the stream both engines' programs run on:
on one card the prefill that wrote the pages, the gather, the scatter,
the next decode step and the next prefill (which may rewrite the
released prefill pages) run in that order, so the caller may drop the
source page references as soon as `move` returns. Across cards, the
copy runs on the source card's stream behind the gather, with PyTorch's
two-way barrier between the two cards' current streams: the copy waits
for the destination's earlier work, and the destination's later work
(the scatter, then the decode step) waits for the copy.

Width discipline: a per-request page count would give the kernels (and
any capture of them) one shape per count. Id lists are padded to the
next power of two instead — source padding re-reads page 0 (the
allocator's reserved trash page), destination padding re-writes it, and
nothing ever reads the trash page — so at most log2(pool size) + 1
widths occur in each direction (`compile_counts`, the reference's
compile pin; tests/test_torch_disagg.py holds it).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Set

import torch

from ..telemetry import span


def _bucket(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    w = 1
    while w < n:
        w <<= 1
    return w


def _ids(ids: Sequence[int], device: torch.device) -> torch.Tensor:
    """An int64 id vector on `device`, copied from pinned memory without
    a host sync on the card (a synchronous copy would wait for the decode
    step in flight)."""
    host = torch.tensor(list(ids), dtype=torch.int64)
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def _pool_tensors(cache, num_pages: int) -> List[torch.Tensor]:
    """Every tensor of a paged cache whose axis 0 is the page axis, in
    layer order (k, v, then the scale planes when int8)."""
    return [t for layer in cache.layers for t in layer.tensors()
            if t.shape[0] == num_pages]


class PageTransfer:
    """Moves occupied KV pages from a source pool's cache into a
    destination pool's. Stateless apart from the widths seen and a
    moved-pages odometer; one instance serves every handoff of a
    DisaggEngine, so its widths are the transfer pins."""

    TRASH = 0     # PageAllocator's reserved junk page, the padding sink

    def __init__(self, src_num_pages: int, dst_num_pages: int):
        self.src_num_pages = src_num_pages
        self.dst_num_pages = dst_num_pages
        self.pages_moved = 0
        #: tensor operations the last move enqueued (gathers, copies
        #: across cards, scatters)
        self.last_ops = 0
        self._widths: Dict[str, Set[int]] = {"gather": set(),
                                             "scatter": set()}

    def move(self, src_cache, dst_cache, src_ids: Sequence[int],
             dst_ids: Sequence[int]) -> int:
        """Copy src_cache pages src_ids[i] into dst_cache pages
        dst_ids[i], in place, and return the pages moved. Enqueued on the
        devices' current streams, like every engine program (see the
        module docstring): the caller may release the source page
        references as soon as this returns."""
        if len(src_ids) != len(dst_ids):
            raise ValueError(f"src/dst page lists disagree: "
                             f"{len(src_ids)} vs {len(dst_ids)}")
        n = len(src_ids)
        self.last_ops = 0
        if n == 0:
            return 0
        src = _pool_tensors(src_cache, self.src_num_pages)
        dst = _pool_tensors(dst_cache, self.dst_num_pages)
        if len(src) != len(dst):
            raise ValueError(f"the pools hold {len(src)} and {len(dst)} "
                             f"page tensors: not the same model")
        width = _bucket(n)
        pad = [self.TRASH] * (width - n)
        src_dev, dst_dev = src[0].device, dst[0].device
        sids = _ids(list(src_ids) + pad, src_dev)
        dids = _ids(list(dst_ids) + pad, dst_dev)
        with span("serve.kv_handoff.move"):
            for s, d in zip(src, dst):
                payload = s.index_select(0, sids)
                if src_dev != dst_dev:
                    payload = payload.to(dst_dev, non_blocking=True)
                    self.last_ops += 1
                d.index_copy_(0, dids, payload)
            self.last_ops += 2 * len(src)
        self._widths["gather"].add(width)
        self._widths["scatter"].add(width)
        self.pages_moved += n
        return n

    @staticmethod
    def page_bytes(cache, num_pages: int) -> int:
        """Bytes of one page across every layer's pool tensors (k, v and
        the int8 scale planes): a move of n pages reads n times this and
        writes n times this."""
        return sum(t[0].numel() * t.element_size()
                   for t in _pool_tensors(cache, num_pages))

    def compile_counts(self) -> Dict[str, int]:
        """Distinct padded widths moved, a direction: at most log2(pool
        size) + 1 each, whatever the trace (the reference's compile
        pin)."""
        return {k: len(v) for k, v in self._widths.items()}


__all__ = ["PageTransfer"]
