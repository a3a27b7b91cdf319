"""Image trainer: data-parallel SGD for ResNet and ViT, the counterpart of
`mpi_operator_tpu/train/trainer.py` (`TrainerConfig`, `TrainState`,
`Trainer`, `make_sgd`, `cross_entropy_loss`).

The step, as the reference's jitted `_step_fn`: a train-mode forward
(BN with batch statistics, which it leaves pending), the mean softmax
cross-entropy over f32 logits, the backward, then optax's SGD with
momentum 0.9 — `m = g + 0.9 m`, `p = p + (-lr) m` — on every parameter
(BN scales and biases included; no weight decay, no dampening), and the
new running statistics; the divergence guard (train/resilience.py)
keeps params, momentum and statistics when the loss or the gradient
norm is non-finite. The step returns loss and accuracy.

The state is PyTorch's, updated IN PLACE as in the LM trainer: the f32
parameters are views of one flat buffer (`TrainState.params`), the BN
running statistics views of another (`batch_stats`, empty for ViT), the
momentum a third; a step changes them with a few whole-buffer
operations and no host sync.

Data parallelism: the reference shards one global batch over a dcn x
dp mesh and XLA all-reduces the gradients. Here each rank runs its rows
of the global batch (data/synthetic.py `rank_rows`) and, when the
process has joined a torch.distributed group (the bootstrap joins one
when the gang has more than one process), the model runs under
DistributedDataParallel, which averages the gradients over both dims of
the mesh (parallel/mesh.py; NCCL on the card, gloo on the CPU); across
slices its buckets go through `hierarchical_allreduce_mean` (a DDP comm
hook), the reference's two-phase schedule. The BN layers all-reduce
their statistics over every rank (models/resnet.py), so the forward,
the gradients and the running statistics equal one process's over the
global batch. The loss and accuracy are averaged over the ranks before
the guard reads the loss, so every rank takes the same decision (H15).

`benchmark` is the reference's windowed protocol: images/sec over
windows of `log_every` steps (one host read a window, the first window
dropped from the mean), the `images/sec:` log lines, step time and host
gap percentiles and goodput from TrainTelemetry, MFU from the analytic
FLOP count (utils/flops.py: the ResNet table, or the ViT count; the
reference reads XLA's compiled count, which the port cannot have), the
profiler window, the periodic checkpoint hook and the resilience
context.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.resnet import ResNet, init_resnet
from ..parallel.collectives import hierarchical_allreduce_mean
from ..parallel.mesh import Mesh, data_parallel_mesh
from ..telemetry import TrainTelemetry, span
from ..utils import flops
from ..utils.device import DeviceLike, rank_and_world, resolve_device
from ..utils.profiling import WindowProfiler
from .resilience import guard_nonfinite_update


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       num_classes: int = 0) -> torch.Tensor:
    """optax.softmax_cross_entropy_with_integer_labels(...).mean() over
    f32 logits."""
    del num_classes
    return F.cross_entropy(logits.float(), labels.long())


def make_sgd(lr: float = 0.1, momentum: float = 0.9):
    """optax.sgd(lr, momentum) as an update of flat f32 buffers:
    `update(params, momentum_buffer, grads) -> (params, momentum)`, new
    tensors, m = g + momentum * m, p = p + (-lr) * m."""
    def update(p: torch.Tensor, m: torch.Tensor, g: torch.Tensor):
        m = torch.add(g, m, alpha=momentum)
        return p + m * (-lr), m
    return update


@dataclasses.dataclass
class TrainerConfig:
    global_batch_size: int = 128
    image_size: int = 224
    num_classes: int = 1000
    learning_rate: float = 0.1
    momentum: float = 0.9
    log_every: int = 10
    # a step whose loss or gradient norm is non-finite applies NO update
    guard_nonfinite: bool = True


@dataclasses.dataclass
class TrainState:
    """Everything a step updates, in place: the flat f32 parameters
    (`model`'s parameters are views of it), the flat f32 BN running
    statistics (its buffers are views; empty for ViT), the SGD momentum,
    the step counter (host int: it always advances) and the device-side
    count of skipped steps in a row. `net` is what the step calls: the
    model, or the model under DistributedDataParallel."""
    params: torch.Tensor
    batch_stats: torch.Tensor
    momentum: torch.Tensor
    model: torch.nn.Module
    net: torch.nn.Module
    step: int = 0
    nonfinite_streak: Optional[torch.Tensor] = None

    def checkpoint_payload(self) -> Dict[str, torch.Tensor]:
        """The tensors a checkpoint holds (train/checkpoint.py): params,
        batch statistics (when the model has any) and momentum; the
        streak is not saved, as in the reference."""
        out = {"params": self.params, "opt.momentum": self.momentum}
        if self.batch_stats.numel():
            out["batch_stats"] = self.batch_stats
        return out

    def named_params(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in self.model.named_parameters()}


def _hierarchical_hook(mesh: Mesh, bucket):
    """DDP comm hook: the bucket's mean over a multi-slice mesh through
    the two-phase schedule (parallel/collectives.py)."""
    buf = bucket.buffer()
    buf.copy_(hierarchical_allreduce_mean(buf, mesh))
    fut = torch.futures.Future()
    fut.set_result(buf)
    return fut


def _ddp(model: torch.nn.Module, dev: torch.device,
         mesh: Mesh) -> torch.nn.Module:
    """`model` under DistributedDataParallel over every rank, the
    hierarchical all-reduce across slices. The BN statistics are
    already global (models/resnet.py), so no buffer is synced in the
    forward (the keyword's name differs between torch versions)."""
    import inspect

    from torch.nn.parallel import DistributedDataParallel as DDP
    quiet = ({"forward_sync_buffers": False}
             if "forward_sync_buffers" in inspect.signature(DDP).parameters
             else {"broadcast_buffers": False})
    net = DDP(model, device_ids=[dev.index] if dev.type == "cuda" else None,
              **quiet)
    if mesh.shape["dcn"] > 1:
        net.register_comm_hook(mesh, _hierarchical_hook)
    return net


class Trainer:
    """Data-parallel trainer for the port's image models (`ResNet`,
    `ViT`) over `mesh` (default: every rank of the process group on dp).
    `model` gives the architecture (its tensors are replaced by views of
    the state's flat buffers in `init_state`); runs on the CUDA card
    unless `device="cpu"`."""

    def __init__(self, model: torch.nn.Module,
                 config: Optional[TrainerConfig] = None,
                 device: DeviceLike = None, mesh: Optional[Mesh] = None):
        self.model = model
        self.config = config or TrainerConfig()
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else data_parallel_mesh()
        self.sgd = make_sgd(self.config.learning_rate, self.config.momentum)

    # -- initialization ---------------------------------------------------

    def init_state(self, seed: int = 0,
                   state_dict: Optional[Dict[str, torch.Tensor]] = None
                   ) -> TrainState:
        """A fresh state: parameters and statistics from `state_dict`
        (e.g. converted from the reference, models/convert.py) or drawn
        from `seed` as the reference initialises them, zero momentum,
        step 0. In a process group the model is wrapped in
        DistributedDataParallel (rank 0's values broadcast)."""
        from ..models.convert import init_vit
        dev, model = self.device, self.model
        if state_dict is None:
            init = init_resnet if isinstance(model, ResNet) else init_vit
            state_dict = init(model, torch.Generator(device=dev)
                              .manual_seed(seed), device=dev)

        def lay_flat(named):
            named = list(named)
            flat = torch.empty(sum(t.numel() for _, t in named),
                               dtype=torch.float32, device=dev)
            views, off = {}, 0
            for name, t in named:
                n = t.numel()
                view = flat[off:off + n].view(t.shape)
                view.copy_(torch.as_tensor(state_dict[name]).reshape(
                    t.shape))
                views[name] = view
                off += n
            return flat, views
        params, pviews = lay_flat(model.named_parameters())
        stats, sviews = lay_flat(model.named_buffers())
        model.load_state_dict({**pviews, **sviews}, strict=True,
                              assign=True)
        model.train()
        net = model
        if dist.is_available() and dist.is_initialized():
            net = _ddp(model, dev, self.mesh)
        return TrainState(
            params=params, batch_stats=stats,
            momentum=torch.zeros_like(params), model=model, net=net,
            nonfinite_streak=torch.zeros((), dtype=torch.int32,
                                         device=dev))

    # -- the step ----------------------------------------------------------

    def _batch(self, images, labels):
        images = torch.as_tensor(images, device=self.device)
        labels = torch.as_tensor(labels, device=self.device).long()
        return images, labels

    def loss_and_grads(self, state: TrainState, images, labels):
        """(loss, flat f32 gradients, accuracy) of one batch at the
        current parameters, gradients averaged over the ranks; the BN
        layers' new statistics are left pending."""
        images, labels = self._batch(images, labels)
        logits = state.net(images, train=True)
        loss = cross_entropy_loss(logits, labels)
        loss.backward()
        params = list(state.model.parameters())
        grads = torch.cat([torch.zeros_like(p).reshape(-1) if p.grad is None
                           else p.grad.reshape(-1) for p in params])
        for p in params:
            p.grad = None
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return loss.detach(), grads, acc

    def apply_update(self, state: TrainState, grads: torch.Tensor,
                     loss: torch.Tensor) -> None:
        """The SGD update of `state` and its new running statistics (the
        BN layers' pending ones), in place; with the guard, a step whose
        loss or gradient norm is non-finite changes none of them and the
        streak counts it."""
        stats = (state.model.new_batch_stats()
                 if isinstance(state.model, ResNet) else state.batch_stats)
        g_norm = torch.linalg.vector_norm(grads)
        p, m = self.sgd(state.params, state.momentum, grads)
        updates = [(state.params, p), (state.momentum, m),
                   (state.batch_stats, stats)]
        if self.config.guard_nonfinite:
            state.nonfinite_streak = guard_nonfinite_update(
                updates, loss, g_norm, state.nonfinite_streak)
        else:
            for old, new in updates:
                old.copy_(new)

    def train_step(self, state: TrainState, images, labels
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One step: forward, backward, guarded SGD and statistics
        update. Returns the (same, updated) state and device-side
        metrics (loss and accuracy averaged over the ranks)."""
        loss, grads, acc = self.loss_and_grads(state, images, labels)
        world = rank_and_world()[1]
        if world > 1:
            both = torch.stack([loss, acc])
            dist.all_reduce(both)
            loss, acc = both / world
        self.apply_update(state, grads, loss)
        del grads
        state.step += 1
        return state, {"loss": loss, "accuracy": acc,
                       "nonfinite_streak": state.nonfinite_streak}

    # -- the benchmark ----------------------------------------------------

    def flops_per_step(self) -> Optional[float]:
        """GLOBAL model FLOPs of one step (the analytic count): the
        ResNet table (utils/flops.py resnet_train_flops_per_image) or
        the ViT count, times the global batch."""
        cfg, model = self.config, self.model
        if isinstance(model, ResNet):
            per_image = flops.resnet_train_flops_per_image(
                model.arch, cfg.image_size, stem=model.stem)
        else:
            mcfg = model.config
            per_image = flops.vit_train_flops_per_image(
                flops.param_count(model.backbone), mcfg.num_layers,
                mcfg.embed_dim, model.pos.num_embeddings - 1,
                model.patch_embed.in_features, model.head.out_features)
        return per_image * cfg.global_batch_size if per_image else None

    def benchmark(self, state: TrainState, dataset: Iterable,
                  num_steps: int = 100, warmup_steps: int = 10,
                  log: Callable[[str], None] = print,
                  profile_dir: Optional[str] = None,
                  step_hook: Optional[Callable] = None,
                  resilience=None,
                  telemetry: Optional[TrainTelemetry] = None,
                  ) -> Tuple[TrainState, Dict[str, object]]:
        """images/sec over windows of `log_every` steps, the reference's
        protocol (tf_cnn_benchmarks' log lines): the loop dispatches
        steps without waiting for the device; each window ends with one
        host read of the loss. `warmup_steps` (at least one) run first
        and are not timed; the first window is dropped from the mean
        when there are several.

        step_hook(state, step) fires after every timed step (periodic
        checkpoints); resilience: an entered ResilienceContext (stop
        check with an emergency checkpoint and Preempted, divergence
        rollback at window fetches); telemetry: a TrainTelemetry to feed
        (a private one otherwise); profile_dir: a torch.profiler chrome
        trace of the first window.

        Returns the reference's keys (images_per_sec,
        images_per_sec_per_device, steps, wall_seconds, final_loss,
        step_time_p50_ms / p99, host_gap_*, goodput, flops_per_step,
        tflops_per_sec_per_device, mfu) and `step_losses`, every timed
        step's loss."""
        from .resilience import Preempted

        cfg, n = self.config, self.mesh.size     # the gang's devices
        tel = telemetry if telemetry is not None else TrainTelemetry()
        if resilience is not None and resilience.telemetry is None:
            resilience.telemetry = tel    # rollback accounting -> goodput
        it = iter(dataset)
        log_every = max(1, min(cfg.log_every, num_steps))
        flops_per_step = self.flops_per_step()
        state, metrics = self.train_step(state, *next(it))
        for _ in range(max(0, warmup_steps - 1)):
            state, metrics = self.train_step(state, *next(it))
        float(metrics["loss"])            # the barrier before the clock
        base_step = state.step
        windows, losses = [], []
        profiler = WindowProfiler(profile_dir, log, self.device)
        profiler.start()
        wall0 = time.perf_counter()
        t0 = wall0
        try:
            for i in range(1, num_steps + 1):
                images, labels = next(it)
                with span("train.step"):
                    state, metrics = self.train_step(state, images, labels)
                losses.append(metrics["loss"])
                if step_hook is not None:
                    step_hook(state, base_step + i)
                if resilience is not None \
                        and resilience.on_step(base_step + i):
                    log(f"preemption drain: stopping the gang at step "
                        f"{base_step + i}")
                    resilience.emergency_save(state)
                    raise Preempted(base_step + i)
                if i % log_every == 0:
                    g0 = time.perf_counter()
                    loss = float(metrics["loss"])  # the window's one sync
                    t1 = time.perf_counter()       # BEFORE the trace write
                    tel.host_gap_seconds.observe(t1 - g0)
                    profiler.stop_if_active()
                    ips = cfg.global_batch_size * log_every / (t1 - t0)
                    windows.append(ips)
                    tel.observe_steps((t1 - t0) / log_every, log_every)
                    tel.update_window(
                        examples_per_sec=ips,
                        mfu=flops.throughput_stats(
                            flops_per_step, ips / cfg.global_batch_size, n,
                            self.device)["mfu"],
                        step=base_step + i)
                    streak = int(metrics["nonfinite_streak"])
                    if streak:
                        tel.record_streak(streak)
                    # tf_cnn_benchmarks log format
                    log(f"{i}\timages/sec: {ips:.1f}\tloss: {loss:.3f}")
                    if resilience is not None \
                            and streak >= resilience.config.divergence_k:
                        state = resilience.rollback(state)
                        base_step = state.step - i
                    t0 = time.perf_counter()       # fetch/log excluded
        finally:
            profiler.stop_if_active()
        final_loss = float(metrics["loss"])
        wall = time.perf_counter() - wall0
        steady = windows[1:] if len(windows) > 1 else windows
        total_ips = sum(steady) / len(steady)
        stats = flops.throughput_stats(
            flops_per_step, total_ips / cfg.global_batch_size, n,
            self.device)
        p50_ms, p99_ms = tel.step_percentiles_ms()
        gap50_ms, gap99_ms = tel.host_gap_percentiles_ms()
        log("-" * 40)
        log(f"total images/sec: {total_ips:.2f}")
        if p50_ms is not None:
            log(f"step time: p50 {p50_ms:.1f} ms, p99 {p99_ms:.1f} ms, "
                f"goodput {tel.goodput.value:.1%}")
        if stats["mfu"] is not None:
            log(f"per-device: {stats['tflops_per_sec_per_device']:.1f} "
                f"TFLOP/s, MFU {stats['mfu']:.1%}")
        log("-" * 40)
        return state, {
            "images_per_sec": total_ips,
            "images_per_sec_per_device": total_ips / n,
            "steps": num_steps,
            "wall_seconds": wall,
            "final_loss": final_loss,
            "step_losses": torch.stack(losses).tolist(),
            "step_time_p50_ms": p50_ms,
            "step_time_p99_ms": p99_ms,
            "host_gap_p50_ms": gap50_ms,
            "host_gap_p99_ms": gap99_ms,
            "goodput": tel.goodput.value,
            **stats,
        }


__all__ = ["TrainState", "Trainer", "TrainerConfig", "cross_entropy_loss",
           "make_sgd"]
