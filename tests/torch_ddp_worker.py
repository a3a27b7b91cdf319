"""One rank of the port's data-parallel parity runs (tests/test_torch_ddp.py;
chip_smoke.py's [train-ddp] phase runs the same function on the card).

    TPU_SLOTS_PER_WORKER=2 python -m mpi_operator_tpu_torch.bootstrap.launch \\
        -- python tests/torch_ddp_worker.py <world> <port> <out.pt> \\
        [--device cpu|cuda] [--fault per-rank-bn] [--steps N] \\
        [--size test|chip] [--image-size PX]

The rank joins the gang through the port's bootstrap (the controller's
env contract: coordinator and gang size; the rank from the pod's
ordinal, `ddp-worker-0`, and TPU_LOCAL_RANK, which launch.py sets for
each slot) and trains the models of
`parity_models()` from seeded weights on its rows of the same seeded
global batches; rank 0 saves every model's flat params before and after,
momentum and batch statistics, and the group's backend. A gang of one
(`<world>` 1) joins a group of its own through the bootstrap's
rendezvous and backend choice (NCCL on the card), so its step runs
under DDP too. `--fault per-rank-bn` plants the
fault the BN all-reduce exists to prevent: each rank normalises with its
own statistics.
"""
import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from mpi_operator_tpu_torch.models import resnet as tres  # noqa: E402
from mpi_operator_tpu_torch.models import transformer as ttf  # noqa: E402
from mpi_operator_tpu_torch.train.trainer import (  # noqa: E402
    Trainer, TrainerConfig)

GLOBAL_BATCH, CLASSES = 16, 10


def parity_models(image_size=32, size="test"):
    """{name: model on the meta device}. "test": a bottleneck ResNet
    with one block a stage and the s2d stem, and a 2-layer ViT-test with
    patch 4, both f32 (the CPU tests). "chip": ResNet-50 with the s2d
    stem in f32, and ViT-B/16's width at 2 layers in bf16 (flash
    attention on the card), patch 16."""
    with torch.device("meta"):
        if size == "chip":
            return {
                "resnet": tres.ResNet([3, 4, 6, 3],
                                      tres.BottleneckResNetBlock,
                                      num_classes=CLASSES,
                                      dtype=torch.float32, stem="s2d"),
                "vit": ttf.ViT(ttf.vit_config("b16", num_layers=2),
                               num_classes=CLASSES, patch_size=16,
                               image_size=image_size),
            }
        return {
            "resnet": tres.ResNet([1, 1, 1, 1], tres.BottleneckResNetBlock,
                                  num_classes=CLASSES, dtype=torch.float32,
                                  stem="s2d"),
            "vit": ttf.ViT(ttf.vit_config("test", dtype=torch.float32),
                           num_classes=CLASSES, patch_size=4,
                           image_size=image_size),
        }


def batches(steps, image_size=32, seed=0):
    """`steps` seeded global batches (numpy f32 images, int labels)."""
    rs = np.random.RandomState(seed)
    return [(rs.randn(GLOBAL_BATCH, image_size, image_size, 3)
             .astype(np.float32),
             rs.randint(0, CLASSES, GLOBAL_BATCH)) for _ in range(steps)]


def train(rank, world, device, steps, image_size=32, size="test",
          only=None, mesh=None):
    """Each parity model trained `steps` steps on this rank's rows from
    seed 0 over `mesh` (default: every rank on dp); {name: (initial
    params, params, momentum, batch_stats)} on the CPU."""
    out = {}
    data = batches(steps, image_size)
    per = GLOBAL_BATCH // world
    rows = slice(rank * per, (rank + 1) * per)
    for name, model in parity_models(image_size, size).items():
        if only and name not in only:
            continue
        trainer = Trainer(model, TrainerConfig(
            global_batch_size=GLOBAL_BATCH, image_size=image_size,
            num_classes=CLASSES), device=device, mesh=mesh)
        state = trainer.init_state(0)
        start = state.params.detach().cpu().clone()
        for x, y in data:
            trainer.train_step(state, torch.from_numpy(x[rows]).to(device),
                               torch.from_numpy(y[rows]).to(device))
        out[name] = (start,) + tuple(t.detach().cpu().clone() for t in (
            state.params, state.momentum, state.batch_stats))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("world", type=int)
    parser.add_argument("port", type=int)
    parser.add_argument("out")
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--fault", default=None, choices=["per-rank-bn"])
    parser.add_argument("--steps", type=int, default=1)
    parser.add_argument("--image-size", type=int, default=32)
    parser.add_argument("--only", default=None)
    parser.add_argument("--size", default="test", choices=["test", "chip"])
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from mpi_operator_tpu_torch.bootstrap import bootstrap, initialize
    # f32 convs and GEMMs in f32, as the run they are compared with
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    env = dict(os.environ, TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{args.port}",
               TPU_NUM_PROCESSES=str(args.world))
    cpu = args.device == "cpu"
    info = initialize(env, hostname="ddp-worker-0",
                      device="cpu" if cpu else None)
    if args.world == 1:
        # initialize() joins no group for one process; its rendezvous
        # joins one here, so the step runs under DDP over the backend
        # the bootstrap picks (NCCL on the card)
        bootstrap._initialize_distributed(
            info, env, backend=bootstrap.dist_backend(info, cpu))
    if args.fault == "per-rank-bn":
        tres.all_reduce_sum = lambda t: t
    device = (torch.device("cpu") if cpu
              else torch.device("cuda", torch.cuda.current_device()))
    out = train(info.process_id, args.world, device, args.steps,
                args.image_size, args.size,
                only=args.only.split(",") if args.only else None)
    if info.process_id == 0:
        torch.save({"results": out, "backend": dist.get_backend()},
                   args.out)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
