"""Interleaved 1F1B pipeline schedule (Megatron-style) over the pp axis:
the counterpart of `mpi_operator_tpu/parallel/pipeline_1f1b.py`.

GPipe (parallel/pipeline.py) runs every forward, then every backward, so
each stage holds the graphs of all M microbatches. 1F1B interleaves one
forward with one backward per stage, so at most O(P) microbatches are in
flight, and interleaving (each rank holds `interleave` non-contiguous
chunks of layers, Megatron's virtual stages) divides the fill and drain
bubble by the chunk count.

The host half is the reference's, copied: `simulate_1f1b` builds the
schedule on the host (numpy) into dense [T, P] tables (who computes what
at each tick, which buffer slot every value lives in) with the
reference's greedy policy and in-flight cap, so the tables and the
buffer depths equal the reference's for the same (P, M, v).
`_layer_order` and `interleave_order` / `deinterleave_order` are the
reference's `interleave_blocks` permutation, as orders of layer indices:
rank d's chunks, virtual stages d, P + d, 2P + d, ..., are its layers in
that order.

The device half (`run_1f1b`) walks the tables tick by tick. In the
reference the schedule is one `lax.scan` inside `shard_map`, and each
backward tick recomputes its stage's forward under `jax.vjp` from the
saved stage input. Here a stage is a process: a forward tick runs the
chunk's layers with autograd recording and KEEPS the microbatch's graph
(the reference recomputes it; PyTorch keeps it, option A of the port's
launch plan), and the backward tick runs `torch.autograd.backward` on it.
Each kernel of a layer then launches once a microbatch in the forward
(K1) and once in the backward (K2, K3): (L / P) x M a step on each rank.
The in-flight cap of the simulated schedule bounds the graphs a rank
keeps, so activation memory stays O(P v) microbatches.

Every tick makes two hops over the pp ring, activations forward and
cotangents back (`parallel/collectives.py ring_hop`): every rank joins
both, idle or not (over gloo on CUDA tensors a hop is an all-to-all, and
a rank that skipped one would hang the gang), sending zeros where it has
nothing to send. No graph runs through a hop: what arrives is a leaf,
and its gradient is sent on by hand. Virtual stage k runs on rank k % P
as chunk k // P, so the hop from rank P - 1 to rank 0 carries real
activations when v > 1. Gradients come out of the schedule itself; the
trainer (train/pp_trainer.py) reduces and applies them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

# dir codes in the schedule tables
IDLE, FWD, BWD = 0, 1, 2
# role codes (what a virtual stage's compute includes)
ROLE_FIRST, ROLE_MID, ROLE_LAST = 0, 1, 2
#: the tables a Schedule holds, [T, P] each
TABLES = ("dir", "role", "chunk", "mb", "h_slot", "g_slot",
          "recv_fwd_slot", "recv_bwd_slot")


@dataclass(frozen=True)
class Schedule:
    """Host-built 1F1B schedule: dense per-tick tables (all [T, P] int32)
    plus buffer depths. Everything the device half needs to index."""
    num_stages: int            # P — pipeline ranks
    num_microbatches: int      # M
    interleave: int            # v — virtual stages per rank
    ticks: int                 # T
    dir: np.ndarray            # IDLE | FWD | BWD
    role: np.ndarray           # ROLE_* for the work item (0 when idle)
    chunk: np.ndarray          # local chunk index of the work item
    mb: np.ndarray             # microbatch index of the work item
    h_slot: np.ndarray         # input-activation slot (-1: none, embed path)
    g_slot: np.ndarray         # cotangent slot for BWD (-1: loss-seeded)
    recv_fwd_slot: np.ndarray  # where an arriving activation lands (-1 none)
    recv_bwd_slot: np.ndarray  # where an arriving cotangent lands (-1 none)
    h_depth: int               # activation pool depth (max in flight)
    g_depth: int               # cotangent pool depth
    idle_slots: int            # sum of dir == IDLE (the bubble, stage-ticks)

    @property
    def total_slots(self) -> int:
        return self.ticks * self.num_stages

    @property
    def bubble_fraction(self) -> float:
        return self.idle_slots / self.total_slots


class _SlotPool:
    """Interval allocator: slots live from alloc to free; depth = peak."""

    def __init__(self):
        self.free: list = []
        self.next = 0
        self.depth = 0

    def alloc(self) -> int:
        if self.free:
            return self.free.pop()
        s = self.next
        self.next += 1
        self.depth = max(self.depth, self.next)
        return s

    def release(self, slot: int) -> None:
        self.free.append(slot)


def simulate_1f1b(num_stages: int, num_microbatches: int,
                  interleave: int = 1) -> Schedule:
    """Greedy dependency-driven 1F1B simulation (the reference's).

    Virtual stage k (0..v*P-1) runs on rank k % P as local chunk k // P
    (Megatron round-robin placement: every virtual-stage hop is one
    forward ring hop). Policy per rank per tick: run a ready BACKWARD if
    one exists (backwards drain in-flight memory and unblock upstream),
    else a ready FORWARD whose in-flight budget allows. fwd(k, m) is
    ready once fwd(k-1, m) finished a previous tick; bwd(k, m) once
    bwd(k+1, m) did (bwd of the last virtual stage is seeded by its own
    loss at the fwd tick). The in-flight cap (the classic 1F1B warmup
    depth plus one) turns greedy scheduling into the 1F1B pattern."""
    Pn, M, v = num_stages, num_microbatches, interleave
    VP = v * Pn
    if M % Pn:
        raise ValueError(f"num_microbatches={M} must divide over "
                         f"pp={Pn} for the interleaved schedule")
    fwd_done = -np.ones((VP, M), dtype=np.int64)   # tick of completion
    bwd_done = -np.ones((VP, M), dtype=np.int64)

    # Megatron interleaved order per rank: microbatches in groups of P,
    # chunk-major inside a group, then the next group; backwards mirror
    # it. Warmup depth (P - d - 1) * 2 + (v - 1) * P forwards, then strict
    # 1F1B alternation.
    def fseq(d):
        return [(c * Pn + d, g * Pn + i)
                for g in range(M // Pn)
                for c in range(v)
                for i in range(Pn)]

    def bseq(d):
        return [(c * Pn + d, g * Pn + i)
                for g in range(M // Pn)
                for c in reversed(range(v))
                for i in range(Pn)]

    F = [fseq(d) for d in range(Pn)]
    B = [bseq(d) for d in range(Pn)]
    fi = [0] * Pn
    bi = [0] * Pn
    warmup = [min((Pn - d - 1) * 2 + (v - 1) * Pn if v > 1
                  else Pn - d - 1, len(F[d]))
              for d in range(Pn)]
    prefer_bwd = [False] * Pn      # steady-state alternation state
    in_flight = [0] * Pn           # forwards minus backwards, per rank
    cap = [w + 1 for w in warmup]  # the O(P v) in-flight memory bound

    rows: Dict[str, list] = {k: [] for k in TABLES}
    h_pools = [_SlotPool() for _ in range(Pn)]
    g_pools = [_SlotPool() for _ in range(Pn)]
    # (k, m) -> assigned slot on its rank
    h_slot_of: Dict[tuple, int] = {}
    g_slot_of: Dict[tuple, int] = {}

    def role_of(k: int) -> int:
        if k == 0:
            return ROLE_FIRST
        if k == VP - 1:
            return ROLE_LAST
        return ROLE_MID

    def fwd_ready(k, m, t):
        return k == 0 or (0 <= fwd_done[k - 1, m] < t)

    def bwd_ready(k, m, t):
        if k == VP - 1:
            return 0 <= fwd_done[k, m] < t
        return 0 <= bwd_done[k + 1, m] < t

    t = 0
    while any(bi[d] < len(B[d]) for d in range(Pn)):
        if t > 8 * v * (M + VP):    # pragma: no cover — schedule bug guard
            raise RuntimeError("1F1B simulation failed to converge")
        row = {k: [0] * Pn for k in rows}
        for key in ("h_slot", "g_slot", "recv_fwd_slot", "recv_bwd_slot"):
            row[key] = [-1] * Pn
        chosen = []                    # (rank, dir, k, m) this tick
        for d in range(Pn):
            pick = None
            f_item = F[d][fi[d]] if fi[d] < len(F[d]) else None
            b_item = B[d][bi[d]] if bi[d] < len(B[d]) else None
            in_warmup = fi[d] < warmup[d]
            # warmup runs forwards; steady state alternates F/B, falling
            # back to the other direction when the preferred one is not
            # ready, but forwards never exceed the in-flight cap
            if in_warmup:
                want = [(FWD, f_item), (BWD, b_item)]
            elif prefer_bwd[d] or f_item is None:
                want = [(BWD, b_item), (FWD, f_item)]
            else:
                want = [(FWD, f_item), (BWD, b_item)]
            for direction, item in want:
                if item is None:
                    continue
                if direction == FWD and in_flight[d] >= cap[d]:
                    continue
                k, m = item
                ok = (fwd_ready(k, m, t) if direction == FWD
                      else bwd_ready(k, m, t))
                if ok:
                    pick = (direction, k, m)
                    break
            if pick is None:
                row["dir"][d] = IDLE
                continue
            direction, k, m = pick
            chosen.append((d, direction, k, m))
            row["dir"][d] = direction
            row["role"][d] = role_of(k)
            row["chunk"][d] = k // Pn
            row["mb"][d] = m
            if direction == FWD:
                fi[d] += 1
                fwd_done[k, m] = t
                in_flight[d] += 1
                # the first post-warmup op must be a FORWARD (Megatron's
                # F-then-B pairing), so warmup forwards leave the toggle
                if fi[d] > warmup[d]:
                    prefer_bwd[d] = True
                row["h_slot"][d] = h_slot_of.get((k, m), -1)
            else:
                bi[d] += 1
                bwd_done[k, m] = t
                in_flight[d] -= 1
                prefer_bwd[d] = False
                row["h_slot"][d] = h_slot_of.get((k, m), -1)
                row["g_slot"][d] = g_slot_of.get((k, m), -1)
        # deliveries land the SAME tick (the hops happen inside the tick)
        for d, direction, k, m in chosen:
            if direction == FWD and k < VP - 1:
                rd = (d + 1) % Pn                 # rank of k+1
                slot = h_pools[rd].alloc()
                h_slot_of[(k + 1, m)] = slot
                row["recv_fwd_slot"][rd] = slot
            if direction == BWD and k > 0:
                rd = (d - 1) % Pn                 # rank of k-1
                slot = g_pools[rd].alloc()
                g_slot_of[(k - 1, m)] = slot
                row["recv_bwd_slot"][rd] = slot
        for d, direction, k, m in chosen:
            if direction == BWD:                  # slots die with the bwd
                s = h_slot_of.pop((k, m), None)
                if s is not None:
                    h_pools[d].release(s)
                s = g_slot_of.pop((k, m), None)
                if s is not None:
                    g_pools[d].release(s)
        for key in rows:
            rows[key].append(row[key])
        t += 1

    tables = {k: np.asarray(vv, dtype=np.int32) for k, vv in rows.items()}
    idle = int((tables["dir"] == IDLE).sum())
    return Schedule(
        num_stages=Pn, num_microbatches=M, interleave=v, ticks=t,
        h_depth=max(1, max(p.depth for p in h_pools)),
        g_depth=max(1, max(p.depth for p in g_pools)),
        idle_slots=idle, **tables)


def _layer_order(num_layers: int, num_stages: int, interleave: int):
    """The reference's device-major layer order: rank d's chunks (virtual
    stages d, P + d, 2P + d, ...) made contiguous, rank after rank."""
    lc = num_layers // (num_stages * interleave)
    return np.concatenate([
        np.arange(lc) + (c * num_stages + d) * lc
        for d in range(num_stages) for c in range(interleave)])


def interleave_order(num_layers: int, num_stages: int,
                     interleave: int) -> list:
    """The reference's `interleave_blocks` as a permutation: position i of
    the 1F1B device-major layout holds canonical layer `order[i]` (v = 1
    is the identity)."""
    return [int(i) for i in _layer_order(num_layers, num_stages, interleave)]


def deinterleave_order(num_layers: int, num_stages: int,
                       interleave: int) -> list:
    """The reference's `deinterleave_blocks` as a permutation: canonical
    layer i sits at position `order[i]` of the device-major layout (the
    inverse of `interleave_order`)."""
    return [int(i) for i in np.argsort(
        _layer_order(num_layers, num_stages, interleave))]


def rank_layers(num_layers: int, num_stages: int, interleave: int,
                rank: int) -> list:
    """The canonical layers rank `rank` holds, chunk by chunk: its slice
    of `interleave_order` (GPipe's contiguous L / P at v = 1)."""
    per = num_layers // num_stages
    return interleave_order(num_layers, num_stages,
                            interleave)[rank * per:(rank + 1) * per]


def run_1f1b(sched: Schedule, rank: int, forward: Callable,
             backward: Callable, hop: Callable,
             zeros: Callable[[], torch.Tensor]) -> None:
    """The device half: walk `sched`'s tables on pp rank `rank`.

    forward(k, m, x) runs virtual stage k on microbatch m from the input
    activation x (None for k = 0, which embeds) and returns the
    activation to send on (None at the last virtual stage, which keeps
    its loss); backward(k, m, g) runs the backward of the graph forward
    kept, from the cotangent g (None at the last virtual stage: its loss
    seeds it), and returns the input's cotangent to send back (None at
    k = 0). hop([x], shift) is one hop of the pp ring, returning what
    arrived (every rank calls it at every tick); zeros() is what an idle
    rank sends."""
    P = sched.num_stages
    h_buf: list = [None] * sched.h_depth
    g_buf: list = [None] * sched.g_depth
    for t in range(sched.ticks):
        direction = int(sched.dir[t, rank])
        k = int(sched.chunk[t, rank]) * P + rank
        m = int(sched.mb[t, rank])
        send_f = send_b = None
        if direction == FWD:
            hs = int(sched.h_slot[t, rank])
            send_f = forward(k, m, h_buf[hs] if hs >= 0 else None)
        elif direction == BWD:
            gs = int(sched.g_slot[t, rank])
            send_b = backward(k, m, g_buf[gs] if gs >= 0 else None)
        got, = hop([zeros() if send_f is None else send_f], 1)
        rf = int(sched.recv_fwd_slot[t, rank])
        if rf >= 0:
            h_buf[rf] = got
        got, = hop([zeros() if send_b is None else send_b], -1)
        rb = int(sched.recv_bwd_slot[t, rank])
        if rb >= 0:
            g_buf[rb] = got


__all__ = ["BWD", "FWD", "IDLE", "ROLE_FIRST", "ROLE_LAST", "ROLE_MID",
           "Schedule", "TABLES", "deinterleave_order", "interleave_order",
           "rank_layers", "run_1f1b", "simulate_1f1b"]
