"""Allreduce scaling-efficiency harness over the gang: the counterpart of
`mpi_operator_tpu/examples/allreduce_bench.py`.

BASELINE.md's north star for the reference's data plane is the
allreduce's scaling efficiency, >= 90% going 4 -> 32 devices. The op is
the data-parallel mean all-reduce (parallel/collectives.py
`sharded_allreduce_fn`) over the first n ranks of the process group,
one rank a card (NCCL between cards, gloo on the CPU); this harness
times it across growing n and payload sizes and returns the curve.

Metrics per (devices n, payload):
  time_ms    - mean wall time of one allreduce over `iters` chained
               calls, between two points where every rank of the ring
               has synchronised its card (torch.cuda.synchronize) and
               passed a barrier; the slowest rank's time
  algbw_gbs  - payload_bytes / time (the application-visible rate)
  busbw_gbs  - algbw x 2(n - 1)/n, the link-level rate of a ring
               allreduce; flat over n = perfect scaling
  efficiency - busbw(n) / busbw(n0) at the largest payload, n0 the
               smallest multi-device count

With one card the curve is empty: the n = 1 point is a ring of one,
and `main` says so instead of making up a score.

    python -m mpi_operator_tpu_torch.examples.allreduce_bench \\
        --payload-mb 1 16 64

runs as every rank of a gang (the controller's env contract, one
process a card: TPU_COORDINATOR_ADDRESS, TPU_NUM_PROCESSES and each
rank's TPU_WORKER_ID / TPU_LOCAL_RANK); alone it joins a group of one.
Rank 0 prints the result as one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..parallel.collectives import sharded_allreduce_fn
from ..parallel.mesh import MeshConfig, make_mesh
from ..utils.device import DeviceLike, resolve_device


def _sync(dev: torch.device, group) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier(group=group)


def run_allreduce_benchmark(
    payload_mb: Sequence[float] = (1.0, 16.0, 64.0),
    device_counts: Optional[Sequence[int]] = None,
    iters: int = 10,
    device: DeviceLike = None,
    log: Callable[[str], None] = print,
) -> Dict[str, object]:
    """Time the mean allreduce over the first n ranks of the process
    group for each n of `device_counts` (default the powers of two up to
    the group's size) and each payload; every rank of the group calls
    it. Returns {"points": [{devices, payload_mb, time_ms, algbw_gbs,
    busbw_gbs, efficiency}...], "efficiency_curve": {n: efficiency}},
    the efficiency relative to the smallest multi-device count at the
    LARGEST payload (the bandwidth-bound regime the BASELINE number is
    about)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("run_allreduce_benchmark runs inside a process "
                           "group (a gang of one included): start it "
                           "through main()")
    dev = resolve_device(device)
    rank, world = dist.get_rank(), dist.get_world_size()
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32, 64, 128)
                         if n <= world]
    points: List[Dict[str, float]] = []
    for n in device_counts:
        mesh = make_mesh(MeshConfig(dp=n), ranks=range(n))
        fn = sharded_allreduce_fn(mesh, ("dp",))
        group = mesh.group(("dp",)) if rank in mesh else None
        for mb in payload_mb:
            nelem = int(mb * (1 << 20) / 4)
            nelem -= nelem % n
            if group is not None:
                x = torch.arange(nelem, dtype=torch.float32,
                                 device=dev) / nelem
                fn(x)                               # warm: NCCL's setup
                _sync(dev, group)
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn(x)
                _sync(dev, group)
                dt = torch.tensor([(time.perf_counter() - t0) / iters],
                                  device=dev)
                # the slowest rank's time
                dist.all_reduce(dt, op=dist.ReduceOp.MAX, group=group)
                dt = float(dt)
                nbytes = nelem * 4
                algbw = nbytes / dt / 1e9
                busbw = algbw * (2 * (n - 1) / n if n > 1 else 1.0)
                points.append({"devices": n, "payload_mb": round(mb, 3),
                               "time_ms": round(dt * 1e3, 4),
                               "algbw_gbs": round(algbw, 3),
                               "busbw_gbs": round(busbw, 3)})
                if rank == 0:
                    log(f"allreduce n={n:<3d} {mb:6.1f} MB: "
                        f"{dt * 1e3:8.3f} ms  algbw {algbw:7.2f} GB/s  "
                        f"busbw {busbw:7.2f} GB/s")
            dist.barrier()                          # the ranks outside too
    # efficiency at the largest payload, relative to the smallest ring
    big = max(payload_mb)
    multi = [p for p in points
             if p["payload_mb"] == round(big, 3) and p["devices"] > 1]
    curve: Dict[str, float] = {}
    if multi:
        base = multi[0]["busbw_gbs"] or 1e-9
        for p in multi:
            eff = p["busbw_gbs"] / base
            curve[str(p["devices"])] = round(eff, 4)
            p["efficiency"] = round(eff, 4)
    return {"points": points, "efficiency_curve": curve}


def main(argv=None) -> int:
    """Every rank of the gang (or one process alone, in a group of its
    own) runs the benchmark; rank 0 prints the curve with the worst
    efficiency as `value` (None with fewer than two devices) and the
    card's name."""
    parser = argparse.ArgumentParser(prog="allreduce-bench")
    parser.add_argument("--payload-mb", type=float, nargs="+",
                        default=[1.0, 16.0, 64.0])
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--devices", type=int, nargs="+", default=None)
    parser.add_argument("--device", default=None,
                        help="'cpu' to run on the CPU (default: the card)")
    args = parser.parse_args(argv)

    from ..bootstrap import bootstrap, initialize
    info = initialize(device=args.device)
    if info.is_launcher:
        raise SystemExit("allreduce-bench runs on the workers; the "
                         "launcher role has nothing to time")
    if not dist.is_initialized():
        # a gang of one: its own group, so the n = 1 point runs the op
        bootstrap._initialize_distributed(
            info, os.environ,
            backend=bootstrap.dist_backend(info, args.device == "cpu"))
    dev = (torch.device("cpu") if args.device == "cpu"
           else torch.device("cuda", torch.cuda.current_device()))
    try:
        result = run_allreduce_benchmark(
            payload_mb=args.payload_mb, device_counts=args.devices,
            iters=args.iters, device=dev,
            log=lambda s: print(s, file=sys.stderr))
        curve = result["efficiency_curve"]
        # one device measures no ring at all: say so, make up no score
        worst = min(curve.values()) if curve else None
        if info.is_coordinator:
            print(json.dumps({
                "metric": "allreduce_scaling_efficiency",
                "value": worst,
                "unit": "fraction_of_smallest_ring_busbw",
                "efficiency_curve": curve or "insufficient devices "
                                             "(need >1)",
                "points": result["points"],
                "device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                "world": dist.get_world_size(),
                "backend": dist.get_backend()}))
        return 0
    finally:
        dist.destroy_process_group()


__all__ = ["main", "run_allreduce_benchmark"]


if __name__ == "__main__":
    sys.exit(main())
