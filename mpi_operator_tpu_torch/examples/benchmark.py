"""The in-container image benchmark — what worker pods run: the port's
counterpart of `mpi_operator_tpu/examples/benchmark.py` (`run_benchmark`,
`print_banner`, `main`).

Every worker runs this module. `bootstrap.initialize()` reads the
controller's env, picks the rank's card (`cuda:{TPU_LOCAL_RANK %
cards}`) and, for a gang of more than one process, joins the
torch.distributed group (NCCL on the card, gloo with `--device cpu`);
the gradient all-reduce is DistributedDataParallel's.

Role split: the LAUNCHER never joins the group; it polls rank 0's
status channel and exits with the job's code (the reference's batch-Job
completion semantics). Rank 0 serves that channel next to training. A
preemption drain exits with its retryable code (215).

    python -m mpi_operator_tpu_torch.examples.benchmark --device cpu \\
        --model resnet18 --image-size 32 --batch-per-device 4

The output format is the reference's launcher log (tf_cnn_benchmarks'
`images/sec:` lines and the `total images/sec:` summary).
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, Dict, Optional, Tuple

import torch

from ..utils.device import DeviceLike, rank_and_world, resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def image_dataset(data_dir: Optional[str], global_batch: int,
                  image_size: int, dtype: torch.dtype, device,
                  start: int = 0):
    """npy shards under `data_dir` (data/imagefolder.py), or the
    step-keyed synthetic stream from `start` (seed 1); this rank's rows
    of the global batch."""
    if data_dir is not None:
        from ..data.imagefolder import NpyImageDataset
        return NpyImageDataset(data_dir, global_batch, image_size=image_size,
                               dtype=dtype, device=device)
    from ..data.synthetic import SyntheticImageDataset
    return SyntheticImageDataset(global_batch, image_size=image_size,
                                 num_classes=1000, dtype=dtype, seed=1,
                                 start=start, device=device)


def run_benchmark(
    model_name: str = "resnet101",
    batch_per_device: int = 64,
    num_steps: int = 100,
    warmup_steps: int = 10,
    image_size: int = 224,
    dtype_name: str = "bfloat16",
    num_slices: int = 1,
    learning_rate: float = 0.1,
    stem: str = "conv7",
    data_dir: Optional[str] = None,
    profile_dir: Optional[str] = None,
    train_dir: Optional[str] = None,
    ckpt_every: int = 0,
    device: DeviceLike = None,
    log: Callable[[str], None] = print,
) -> Tuple[object, Dict[str, float]]:
    """The shared wiring of every image benchmark surface (chip_smoke,
    the container entry point, tests): a ResNet from seed 0, the image
    Trainer over the data-parallel mesh of the process group's ranks,
    `num_slices` of them on dcn (one process when no group was joined;
    what `bootstrap.hybrid_mesh` builds for the job), synthetic or
    on-disk data, the resume and periodic
    checkpoints of `train_dir`. Runs on the CUDA card unless
    `device="cpu"`. Returns (final_state, metrics)."""
    from ..models.resnet import create_model
    from ..parallel.mesh import data_parallel_mesh
    from ..train.checkpoint import maybe_resume, periodic_saver
    from ..train.trainer import Trainer, TrainerConfig

    if dtype_name not in DTYPES:
        raise ValueError(f"dtype_name={dtype_name!r}; expected one of "
                         f"{sorted(DTYPES)}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        # cuDNN times its conv algorithms for each shape on first use, as
        # XLA autotunes the reference's convs
        torch.backends.cudnn.benchmark = True
    dtype = DTYPES[dtype_name]
    mesh = data_parallel_mesh(num_slices)
    global_batch = batch_per_device * mesh.size
    model = create_model(model_name, num_classes=1000, dtype=dtype,
                         stem=stem, device=dev)
    cfg = TrainerConfig(global_batch_size=global_batch,
                        image_size=image_size, num_classes=1000,
                        learning_rate=learning_rate)
    trainer = Trainer(model, cfg, device=dev, mesh=mesh)
    state = trainer.init_state(0)
    state = maybe_resume(train_dir, state, log)
    dataset = image_dataset(data_dir, global_batch, image_size, dtype, dev,
                            start=state.step)
    try:
        return trainer.benchmark(
            state, dataset, num_steps=num_steps,
            warmup_steps=warmup_steps, log=log, profile_dir=profile_dir,
            step_hook=periodic_saver(train_dir, ckpt_every, log))
    finally:
        if hasattr(dataset, "close"):
            dataset.close()


def print_banner(model: str, global_batch: int, per_device: int, n: int,
                 data_dir: Optional[str], device) -> None:
    """The reference's launcher log banner."""
    kind = "cpu" if torch.device(device).type == "cpu" else "cuda"
    print("Model:       %s" % model)
    print("Batch size:  %d global / %d per device"
          % (global_batch, per_device))
    print("Devices:     %s" % [f"{kind}:{i}" for i in range(n)])
    print("Data format: NHWC")
    print("Data:        %s" % (data_dir or "synthetic"))
    print("Optimizer:   sgd+momentum", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="image-benchmarks")
    parser.add_argument("--model", default="resnet101")
    parser.add_argument("--batch-per-device", type=int, default=64)
    parser.add_argument("--num-steps", type=int, default=100)
    parser.add_argument("--warmup-steps", type=int, default=10)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--data-dir", default=None,
                        help="real-data directory of npy shards; synthetic "
                             "when absent (the reference benchmark's "
                             "default too)")
    parser.add_argument("--train-dir", default=None,
                        help="checkpoint directory; resumes from the "
                             "latest checkpoint when one exists")
    parser.add_argument("--ckpt-every", type=int, default=0,
                        help="async checkpoint every N steps into "
                             "--train-dir (0 = final only)")
    parser.add_argument("--learning-rate", type=float, default=0.1)
    parser.add_argument("--stem", default="s2d", choices=["s2d", "conv7"],
                        help="s2d (default): 4x4 space-to-depth, then a "
                             "2x2 conv over 48 channels; conv7: the "
                             "reference 7x7/2 conv + max-pool")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler chrome trace of the "
                             "first measurement window here")
    parser.add_argument("--device", default=None,
                        help="'cpu' to run on the CPU (default: the card)")
    args = parser.parse_args(argv)

    from ..bootstrap import initialize
    from ..bootstrap.bootstrap import (StatusServer, launcher_wait,
                                       status_port)

    info = initialize(device=args.device)
    print(f"TPUJob process {info.process_id}/{info.num_processes} "
          f"(launcher={info.is_launcher}) coordinator="
          f"{info.coordinator_address}", flush=True)

    if info.is_launcher:
        # thin coordinator: observe rank-0, mirror its exit code
        print("launcher: waiting on rank-0 status channel", flush=True)
        return launcher_wait(info, port=status_port())

    status = StatusServer(status_port()) if info.is_coordinator else None
    exit_code = 1
    try:
        device = args.device or torch.device(
            "cuda", torch.cuda.current_device())
        n = rank_and_world()[1]
        if info.is_coordinator:
            print_banner(args.model, args.batch_per_device * n,
                         args.batch_per_device, n, args.data_dir, device)
        if args.data_dir is not None and not os.path.isdir(args.data_dir):
            print(f"warning: --data-dir {args.data_dir} not found; "
                  f"falling back to synthetic data", file=sys.stderr)
            args.data_dir = None
        quiet = (lambda s: None)           # noqa: E731
        state, _metrics = run_benchmark(
            model_name=args.model,
            batch_per_device=args.batch_per_device,
            num_steps=args.num_steps,
            warmup_steps=args.warmup_steps,
            image_size=args.image_size,
            dtype_name=args.dtype,
            num_slices=info.num_slices,
            learning_rate=args.learning_rate,
            stem=args.stem,
            data_dir=args.data_dir,
            profile_dir=args.profile_dir,
            train_dir=args.train_dir,
            ckpt_every=args.ckpt_every,
            device=device,
            log=print if info.is_coordinator else quiet)
        # every rank enters the final save (rank 0 writes it); it skips a
        # step the periodic hook already committed
        from ..train.checkpoint import maybe_save
        maybe_save(args.train_dir, state,
                   log=print if info.is_coordinator else quiet)
        exit_code = 0
        return 0
    except Exception as exc:
        # a preemption drain exits with its RETRYABLE code (128-255) so
        # the controller restarts the gang; everything else exits 1
        from ..train.resilience import Preempted
        if isinstance(exc, Preempted):
            print(f"preempted: drained at step {exc.step}, exiting "
                  f"{exc.exit_code} (retryable)", flush=True)
            exit_code = exc.exit_code
            return exit_code
        raise
    finally:
        if status is not None:
            status.set_done(exit_code)
            status.close()
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


__all__ = ["main", "print_banner", "run_benchmark"]


if __name__ == "__main__":
    sys.exit(main())
