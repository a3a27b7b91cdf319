"""Horizontally fused training arrays (HFTA): K sweep replicas of one LM
trained by ONE step. The counterpart of `mpi_operator_tpu/train/hfta.py`.

Small jobs leave most of a big card idle. Instead of running K
same-architecture sweep members one after another, this trainer stacks
them along a leading replica axis — the flat f32 masters, both Adam
moments and the step's batch all carry it — and runs one forward and one
backward over all of them: `torch.func.functional_call` of the port's
`LMTrainer` objective under `torch.func.vmap`, so every matmul is one
batched GEMM over the K replicas and flash attention folds the replicas
into its batch (`ops/attention.py FlashAttention.vmap`: K1 launches once
a layer for the K replicas, K2 and K3 once each in the backward).

Per-replica hyperparameters (learning rate, weight decay, warmup, init
seed) ride along as [K] vectors, so a fused run IS a hyperparameter
sweep. What replica k computes, step for step:

- init: the solo `LMTrainer.init_state(seed_k)` (or a converted state
  dict), stacked: replica k starts bit-equal to the solo run.
- loss and gradients: `LMTrainer._loss` itself, vmapped; one
  `.backward()` of the replicas' summed losses gives the [K, N] gradient
  (d sum / d loss_k = 1, so each row is replica k's own gradient).
- optimizer: the reference's order clip -> adam -> + wd p -> - lr_t u,
  with the [K] learning rates, weight decays and warmups, the schedule
  `_lr_at` term for term the reference's; the global norm is each row's,
  summed in f64 (H25).
- guard: per replica. A replica whose loss or gradient norm is not
  finite has its update dropped (its rows of the masters, moments and
  count keep their values) while its siblings apply theirs; after
  `freeze_after` bad steps in a row it freezes for the rest of the run.
  The fused step never waits on the host for it.
- K = 1 squeezes instead of vmapping (the reference's `_map_replicas`):
  the step is then the solo `LMTrainer.train_step`, bit for bit.

Over a gang of W data ranks (dcn x dp): when W divides K, each rank
holds K / W whole replicas, trains them on their whole batches and runs
no collective in the step (the reference's slice sharing: the replica
axis sharded over the devices). Otherwise every rank holds all K
replicas, takes its share of each replica's rows, and the [K, N]
gradient (with each replica's loss and hit count appended) is averaged
over the ranks in one all-reduce, each rank's objective scaled to W
times its share, as LMTrainer does (H13).

Checkpoints go through the ordinary train/checkpoint.py path (the
payload: params, opt.mu, opt.nu, opt.count, each with the replica axis;
a state sliced over ranks is saved shard by shard). `extract_replica`
and `export_replica_checkpoint` give one member back as a plain
`LMTrainState` that a solo LMTrainer restores.

Refused, as in the reference: the masked-LM objective, gradient
accumulation and tp_overlap; and every model-parallel axis (fsdp, tp,
sp, ep, pp): the reference's fused mesh is data-parallel only. Refused
here and not there (ROADMAP.md, Queue 1): MoE blocks, whose routing
(stable sort, index_copy dispatch, parallel/moe.py) does not batch under
vmap, and `fused_xent` and `remat`, which recompute through
`torch.utils.checkpoint`, which vmap does not take.
"""
from __future__ import annotations

import dataclasses
import math
import time
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.transformer import TransformerConfig, model_class, param_shapes
from ..parallel.collectives import allgather, allreduce_mean, allreduce_sum
from ..parallel.mesh import BATCH_AXES, Mesh, MeshConfig, data_parallel_mesh
from ..telemetry import TrainTelemetry
from ..telemetry import events as tev
from ..telemetry.core import Registry
from ..utils import flops
from ..utils.device import DeviceLike, resolve_device
from .lm_trainer import (AdamWState, LMTrainer, LMTrainerConfig, LMTrainState,
                         adamw_update, flat_slots, flat_views,
                         make_lr_schedule, model_on_views, step_flops)
from .resilience import FaultInjector


@dataclasses.dataclass(frozen=True)
class HFTAHyperparams:
    """Per-replica sweep axes, each a K-tuple; what is not swept is the
    base LMTrainerConfig's."""
    learning_rates: Tuple[float, ...]
    seeds: Tuple[int, ...]
    weight_decays: Tuple[float, ...]
    warmup_steps: Tuple[int, ...]

    @property
    def k(self) -> int:
        return len(self.learning_rates)

    @classmethod
    def sweep(cls, k: int, config: LMTrainerConfig,
              learning_rates: Optional[Sequence[float]] = None,
              seeds: Optional[Sequence[int]] = None,
              weight_decays: Optional[Sequence[float]] = None,
              warmup_steps: Optional[Sequence[int]] = None
              ) -> "HFTAHyperparams":
        def axis(given, default):
            if given is None:
                return (default,) * k
            if len(given) != k:
                raise ValueError(f"sweep axis has {len(given)} values, "
                                 f"expected K={k}")
            return tuple(given)
        return cls(learning_rates=axis(learning_rates, config.learning_rate),
                   seeds=axis(seeds, 0),
                   weight_decays=axis(weight_decays, config.weight_decay),
                   warmup_steps=axis(warmup_steps, config.warmup_steps))

    def replica_config(self, base: LMTrainerConfig,
                       k: int) -> LMTrainerConfig:
        """The solo LMTrainerConfig replica k is equivalent to."""
        return dataclasses.replace(base, learning_rate=self.learning_rates[k],
                                   weight_decay=self.weight_decays[k],
                                   warmup_steps=self.warmup_steps[k])


@dataclasses.dataclass
class HFTATrainState:
    """The stacked state of this rank's replicas, updated in place: the
    flat f32 masters [k, N] (row r is replica `replicas[r]`, laid out as
    the solo LMTrainState's flat buffer), the AdamW state over it (count
    [k]), the lockstep host step, and the [k] non-finite streaks and
    frozen flags."""
    params: torch.Tensor
    opt: AdamWState
    replicas: Tuple[int, ...]
    step: int = 0
    nonfinite_streak: Optional[torch.Tensor] = None
    frozen: Optional[torch.Tensor] = None
    # (this rank's slice, the slice count, whether it writes) when the
    # replicas are split over the ranks; None when every rank holds all
    shard: Optional[Tuple[int, int, bool]] = None
    layout_key: Optional[dict] = None
    group: object = None

    @property
    def k(self) -> int:
        return int(self.params.shape[0])

    def checkpoint_payload(self) -> Dict[str, torch.Tensor]:
        opt = self.opt
        return {"params": self.params, "opt.mu": opt.mu, "opt.nu": opt.nu,
                "opt.count": opt.count}


def select_replicas(ok: torch.Tensor, pairs) -> None:
    """For each (old [k, ...], new [k, ...]) pair: row r of old <- row r
    of new where ok[r], in place; the other rows keep their values."""
    for old, new in pairs:
        mask = ok.reshape(ok.shape + (1,) * (old.ndim - 1))
        torch.where(mask, new, old, out=old)


def poison_replica(state: HFTATrainState, k: int) -> HFTATrainState:
    """Multiply replica k's masters by NaN (the nan-replica:K@N drill);
    the other rows are multiplied by 1.0, bit for bit unchanged. A no-op
    on a rank that does not hold replica k."""
    if k in state.replicas:
        bad = torch.ones(state.k, dtype=state.params.dtype,
                         device=state.params.device)
        bad[state.replicas.index(k)] = float("nan")
        state.params.mul_(bad[:, None])
    return state


class _Objective(torch.nn.Module):
    """The solo trainer's objective as a module, so `functional_call`
    can run it on one replica's parameters: (loss, the hit count of the
    argmax, NaN where the loss makes no logits)."""

    def __init__(self, lm: LMTrainer, model: torch.nn.Module):
        super().__init__()
        self.model = model
        self._lm = lm

    def forward(self, tokens, targets, mask, denom, scale):
        shim = SimpleNamespace(model=self.model)
        loss, logits = self._lm._loss(shim, tokens, targets, mask,
                                      denom=denom, aux_scale=scale)
        if logits is None:
            hits = torch.full((), float("nan"), device=loss.device)
        else:
            hits = ((logits.detach().argmax(-1) == targets).float()
                    * mask).sum()
        return loss, hits


class HFTATrainer:
    """K-replica horizontally fused LM trainer (see the module
    docstring). Builds its own model from a TransformerConfig; runs on
    the CUDA card unless `device="cpu"`; `mesh` defaults to every rank of
    the process group on dp."""

    def __init__(self, model_config: TransformerConfig,
                 config: Optional[LMTrainerConfig] = None,
                 hparams: Optional[HFTAHyperparams] = None, k: int = 2,
                 freeze_after: int = 3, device: DeviceLike = None,
                 mesh: Optional[Mesh] = None):
        self.model_config = model_config
        self.config = cfg = config or LMTrainerConfig()
        self.hparams = hparams or HFTAHyperparams.sweep(k, cfg)
        self.freeze_after = int(freeze_after)
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else data_parallel_mesh()
        if cfg.masked_lm or not model_config.causal:
            raise ValueError("HFTA fusion supports causal LM only "
                             "(masked_lm=False)")
        if cfg.accum_steps != 1:
            raise ValueError("HFTA fusion does not compose with gradient "
                             "accumulation (accum_steps must be 1)")
        if model_config.tp_overlap:
            raise ValueError("HFTA fusion does not compose with tp_overlap")
        if cfg.fused_xent or model_config.remat:
            raise ValueError("HFTA fusion does not take fused_xent or remat: "
                             "both recompute through torch.utils.checkpoint, "
                             "which torch.func.vmap does not take (ROADMAP.md "
                             "Queue 1, HFTA over recomputation)")
        split = {a: n for a, n in self.mesh.shape.items()
                 if a not in ("dcn", "dp") and n > 1}
        if split:
            raise ValueError(f"HFTA fusion runs over a data-parallel mesh "
                             f"only (the reference's fused mesh is dp); "
                             f"got {split}")
        if model_config.num_experts:
            raise ValueError("HFTA fusion does not take MoE blocks: their "
                             "routing (stable sort, index_copy dispatch) "
                             "does not batch under torch.func.vmap "
                             "(ROADMAP.md Queue 1, HFTA over MoE)")
        K, W = self.k, self.mesh.dim_size(BATCH_AXES)
        self.world = W
        pos = self.mesh.position()
        # slice sharing: whole replicas a rank, no collective in the step
        self.slice_sharing = W > 1 and K % W == 0
        if self.slice_sharing:
            per = K // W
            self.replicas = tuple(range(pos * per, (pos + 1) * per))
        else:
            if W > 1 and cfg.global_batch_size % W:
                raise ValueError(
                    f"K={K} replicas do not split over {W} ranks and the "
                    f"per-replica batch {cfg.global_batch_size} does not "
                    f"either")
            self.replicas = tuple(range(K))
        # the solo trainer whose objective is vmapped (one process: its
        # own reductions are the identity; this trainer reduces)
        self._lm = LMTrainer(model_config, cfg, device=self.device,
                             mesh=Mesh(MeshConfig(), [0]))
        self._order = [(n, tuple(s)) for n, s in
                       param_shapes(model_config).items()]
        self._slots = flat_slots(self._order)
        self._n = sum(math.prod(s) for _, s in self._order)
        self._solo_schedule = make_lr_schedule(   # K = 1's, bit for bit
            self.hparams.replica_config(cfg, self.replicas[0]))
        self._objective = None

    @property
    def k(self) -> int:
        return self.hparams.k

    # -- the state --------------------------------------------------------

    def init_state(self, state_dicts: Optional[Sequence[Dict]] = None
                   ) -> HFTATrainState:
        """This rank's replicas, each the solo `LMTrainer.init_state` of
        its seed (or of `state_dicts[k]`, the whole model's, e.g.
        converted from the reference's stacked state), stacked; zeroed
        moments and counts, step 0."""
        dev, kl = self.device, len(self.replicas)
        params = torch.empty((kl, self._n), dtype=torch.float32, device=dev)
        for r, k in enumerate(self.replicas):
            solo = self._lm.init_state(
                self.hparams.seeds[k],
                state_dict=None if state_dicts is None else state_dicts[k])
            params[r].copy_(solo.params)
            del solo
        opt = AdamWState(torch.zeros(kl, dtype=torch.int32, device=dev),
                         torch.zeros_like(params), torch.zeros_like(params))
        shard = None
        if self.slice_sharing:
            shard = (self.mesh.position(), self.world, True)
        return HFTATrainState(
            params=params, opt=opt, replicas=self.replicas,
            nonfinite_streak=torch.zeros(kl, dtype=torch.int32, device=dev),
            frozen=torch.zeros(kl, dtype=torch.bool, device=dev),
            shard=shard, layout_key=self.layout_key(),
            group=self.mesh.group(self.mesh.shape))

    def layout_key(self) -> dict:
        """What a checkpoint of this trainer's states depends on: how
        the replicas split over the data ranks, K and the model's
        parameters."""
        return {"mesh": {"dp": self.world if self.slice_sharing else 1},
                "k": self.k,
                "params": [[n, list(s)] for n, s in self._order]}

    def share(self, x):
        """This rank's part of a fused global batch [K, B, ...] (a tensor
        or a numpy array): its replicas' rows under slice sharing, else
        its share of every replica's rows."""
        if self.world == 1:
            return x
        if self.slice_sharing:
            return x[self.replicas[0]:self.replicas[-1] + 1]
        b = x.shape[1] // self.world
        pos = self.mesh.position()
        return x[:, pos * b:(pos + 1) * b]

    def global_flat(self, state: HFTATrainState,
                    which: str = "params") -> torch.Tensor:
        """Every replica's flat buffer of `which` ("params", "mu" or
        "nu"), [K, N]. Collective over the mesh under slice sharing."""
        t = {"params": state.params, "mu": state.opt.mu,
             "nu": state.opt.nu}[which]
        if not self.slice_sharing:
            return t.clone()
        return allgather(t.contiguous(), self.mesh, BATCH_AXES)

    # -- the fused step ---------------------------------------------------

    def _objective_module(self) -> _Objective:
        if self._objective is None:
            cfg = self.model_config
            # a template on the meta device: functional_call swaps in
            # each replica's parameters
            views = flat_views(torch.empty(self._n, device="meta"),
                               self._slots)
            model = model_on_views(lambda: model_class(cfg)(cfg, None),
                                   views, None)
            self._objective = _Objective(self._lm, model)
        return self._objective

    def _batch(self, tokens, targets, mask):
        dev = self.device
        tokens = torch.as_tensor(tokens, device=dev).long()
        targets = torch.as_tensor(targets, device=dev).long()
        mask = (torch.ones(targets.shape, dtype=torch.float32, device=dev)
                if mask is None
                else torch.as_tensor(mask, device=dev).float())
        return tokens, targets, mask

    def loss_and_grads(self, state: HFTATrainState, tokens, targets,
                       mask=None):
        """([k] losses, [k, N] gradients, [k] accuracies) of this rank's
        replicas on their rows of one fused global batch ([k, B, S] under
        slice sharing, [K, B / W, S] otherwise): one forward and one
        backward over every replica; averaged over the ranks when they
        share each replica's rows."""
        tokens, targets, mask = self._batch(tokens, targets, mask)
        kl, W = state.k, self.world
        shared_rows = W > 1 and not self.slice_sharing
        total = mask.sum(dim=(1, 2))
        if shared_rows:
            total = allreduce_sum(total, self.mesh, BATCH_AXES)
        total = torch.clamp(total, min=1.0)
        scale = W if shared_rows else 1
        denom = total / scale
        leaves = {"model." + n: state.params[:, o:o + math.prod(s)].view(
            kl, *s).detach().requires_grad_() for n, (o, s) in
            self._slots.items()}
        objective = self._objective_module()

        def one(params, t, y, m, d):
            return torch.func.functional_call(objective, params,
                                              (t, y, m, d, scale))
        if kl == 1:
            # squeeze, not vmap: the solo program bit for bit
            loss, hits = one({n: p[0] for n, p in leaves.items()},
                             tokens[0], targets[0], mask[0], denom[0])
            loss, hits = loss[None], hits[None]
        else:
            loss, hits = torch.func.vmap(one)(leaves, tokens, targets, mask,
                                              denom)
        loss.sum().backward()
        grads = torch.cat([leaves["model." + n].grad.reshape(kl, -1)
                           for n, _ in self._order]
                          + [loss.detach()[:, None], hits[:, None] * scale],
                          dim=1)
        if shared_rows:
            grads = allreduce_mean(grads, self.mesh, BATCH_AXES,
                                   inplace=True)
        return (grads[:, -2].clone(), grads[:, :-2],
                grads[:, -1] / total)

    def _lr_at(self, count: torch.Tensor) -> torch.Tensor:
        """[k] learning rates at the [k] update counts: the schedule
        optax's make_lr_schedule(cfg_k) gives, with lr and warmup as [k]
        vectors (the reference's `_lr_at`, term for term)."""
        cfg, dev = self.config, count.device
        hp = self.hparams
        lr = torch.tensor([hp.learning_rates[k] for k in self.replicas],
                          dtype=torch.float32, device=dev)
        warmup = torch.tensor([hp.warmup_steps[k] for k in self.replicas],
                              dtype=torch.int32, device=dev)
        w = torch.clamp(warmup, min=1)
        c = torch.minimum(torch.clamp(count, min=0), w)
        frac = 1 - c / w
        warm = (0.0 - lr) * frac + lr                 # polynomial, power 1
        if cfg.lr_schedule == "linear":
            return warm
        if cfg.lr_schedule != "cosine":
            raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
        alpha = cfg.end_lr_fraction
        total = torch.clamp(w + 1, min=cfg.decay_steps)
        ds = total - w
        c2 = torch.minimum(torch.clamp(count - w, min=0), ds)
        cosine = 0.5 * (1 + torch.cos(math.pi * (c2 / ds)))
        decayed = (1 - alpha) * cosine + alpha
        return torch.where(count < w, warm, lr * decayed)

    def _apply(self, state: HFTATrainState, grads: torch.Tensor,
               loss: torch.Tensor) -> None:
        """The guarded update of every row, in place: a row whose loss or
        gradient norm is not finite, or which is frozen, keeps its
        masters, moments and count; the streaks and frozen flags move."""
        opt = state.opt
        if state.k == 1:
            # squeeze: the solo trainer's own norm, schedule and decay
            g_norm = torch.linalg.vector_norm(grads[0], dtype=torch.float64
                                              ).float()[None]
            cfg = self.hparams.replica_config(self.config, self.replicas[0])
            lr, wd = self._solo_schedule(opt.count[0]), None
        else:
            g_norm = torch.linalg.vector_norm(grads, dim=1,
                                              dtype=torch.float64).float()
            cfg, lr = self.config, self._lr_at(opt.count)[:, None]
            wd = torch.tensor([self.hparams.weight_decays[k]
                               for k in self.replicas], dtype=torch.float32,
                              device=grads.device)[:, None]
        p, mu, nu = adamw_update(state.params, grads, g_norm[:, None],
                                 AdamWState(opt.count[:, None], opt.mu,
                                            opt.nu), lr, cfg, wd)
        finite = torch.isfinite(loss) & torch.isfinite(g_norm)
        ok = finite & ~state.frozen
        select_replicas(ok, [(state.params, p), (opt.mu, mu), (opt.nu, nu),
                             (opt.count, opt.count + 1)])
        streak = torch.where(ok, 0, torch.where(
            state.frozen, state.nonfinite_streak,
            state.nonfinite_streak + 1)).to(torch.int32)
        state.nonfinite_streak = streak
        state.frozen = state.frozen | (streak >= self.freeze_after)

    def train_step(self, state: HFTATrainState, tokens, targets, mask=None
                   ) -> Tuple[HFTATrainState, Dict[str, torch.Tensor]]:
        """One fused step over this rank's share of a [K, B, S] batch
        (`share`); metrics come back as [k] vectors on the device."""
        loss, grads, acc = self.loss_and_grads(state, tokens, targets, mask)
        self._apply(state, grads, loss)
        state.step += 1
        return state, {"loss": loss, "accuracy": acc,
                       "nonfinite_streak": state.nonfinite_streak,
                       "frozen": state.frozen}

    # -- per-replica extraction and checkpoints ---------------------------

    def _replica_rows(self, state: HFTATrainState, k: int):
        """(params, mu, nu, count) of replica k on every rank: under
        slice sharing its holder contributes the rows to one all-reduce
        (every rank calls it); else this rank's own rows."""
        rows = (state.params, state.opt.mu, state.opt.nu)
        if not self.slice_sharing:
            r = state.replicas.index(k)
            return tuple(t[r].clone() for t in rows) + (
                state.opt.count[r].clone(),)
        mine = k in state.replicas
        out = []
        for t in rows + (state.opt.count,):
            x = (t[state.replicas.index(k)].clone() if mine
                 else torch.zeros_like(t[0]))
            out.append(allreduce_sum(x, self.mesh, BATCH_AXES, inplace=True))
        return tuple(out)

    def extract_replica(self, state: HFTATrainState, k: int,
                        mesh: Optional[Mesh] = None) -> LMTrainState:
        """Replica k as a plain LMTrainState of a solo LMTrainer with its
        config (`hparams.replica_config`), over `mesh` (default: every
        rank of the group on dp): its masters, moments, count and step.
        Collective under slice sharing."""
        params, mu, nu, count = self._replica_rows(state, k)
        solo = LMTrainer(self.model_config,
                         self.hparams.replica_config(self.config, k),
                         device=self.device, mesh=mesh)
        out = solo.init_state(self.hparams.seeds[k])
        with torch.no_grad():
            out.params.copy_(params)
            out.opt.mu.copy_(mu)
            out.opt.nu.copy_(nu)
            out.opt.count.copy_(count)
        out.step = state.step
        return out

    def export_replica_checkpoint(self, directory: str,
                                  state: HFTATrainState, k: int,
                                  block: bool = True) -> str:
        """Write replica k as a NORMAL single-model checkpoint a plain
        LMTrainer restores (the finished sweep member's export)."""
        from .checkpoint import save_checkpoint
        return save_checkpoint(directory, self.extract_replica(state, k),
                               block=block)

    # -- the benchmark ----------------------------------------------------

    def _all(self, x: torch.Tensor) -> torch.Tensor:
        """Every replica's value of a [k] vector (collective under slice
        sharing; used at window ends only)."""
        if not self.slice_sharing:
            return x
        return allgather(x.contiguous(), self.mesh, BATCH_AXES)

    def benchmark(self, state: HFTATrainState, dataset, num_steps: int = 50,
                  warmup_steps: int = 5, log: Callable[[str], None] = print,
                  registry: Optional[Registry] = None,
                  faults: Optional[FaultInjector] = None,
                  step_hook: Optional[Callable] = None, events=None
                  ) -> Tuple[HFTATrainState, Dict[str, Any]]:
        """The timed fused loop (the reference's `HFTATrainer.benchmark`):
        `dataset` yields this rank's share of ([K, B, S] tokens, targets).
        Per-replica tokens/s, MFU and goodput land as labeled
        tpu_worker_* series (labels={"replica": k}) on one registry;
        `events` gets each replica's records through a view bound to its
        replica label, one `replica_frozen` record per transition. A
        `faults` nan-replica:K@N directive poisons replica K before step
        N. Returns (state, the reference's result keys)."""
        cfg, kk = self.config, self.k
        reg = registry if registry is not None else Registry()
        tels = [TrainTelemetry(reg, labels={"replica": str(k)})
                for k in range(kk)]
        evs = ([events.bind(replica=str(k)) for k in range(kk)]
               if events is not None else None)
        if faults is None:
            faults = FaultInjector.from_env()
        if faults is not None and faults.events is None:
            faults.events = events
        it = iter(dataset)
        replica_flops = step_flops(cfg, self.model_config)
        replica_tokens = cfg.global_batch_size * cfg.seq_len
        n_devices = self.mesh.size
        state, metrics = self.train_step(state, *next(it))
        for _ in range(max(0, warmup_steps - 1)):
            state, metrics = self.train_step(state, *next(it))
        self._all(metrics["loss"]).cpu()               # sync before timing
        base = state.step
        log_every = max(1, min(cfg.log_every, num_steps))
        prev_frozen = self._all(state.frozen).cpu().numpy().copy()
        windows: List[Dict[str, Any]] = []
        t0 = g0 = start = time.perf_counter()
        for i in range(1, num_steps + 1):
            if faults is not None:
                k_poison = faults.check_nan_replica(base + i - 1)
                if k_poison is not None:
                    log(f"fault-inject: NaN into replica {k_poison} at step "
                        f"{base + i - 1}")
                    state = poison_replica(state, k_poison)
            state, metrics = self.train_step(state, *next(it))
            if step_hook is not None:
                step_hook(state, base + i)
            if i % log_every == 0:
                loss = self._all(metrics["loss"]).cpu().numpy()  # host sync
                t1 = time.perf_counter()
                dt = max(t1 - t0, 1e-9)
                streaks = self._all(metrics["nonfinite_streak"]).cpu().numpy()
                frozen = self._all(metrics["frozen"]).cpu().numpy()
                tps_replica = replica_tokens * log_every / dt
                mfu = flops.throughput_stats(replica_flops, log_every / dt, 1,
                                             self.device).get("mfu")
                for k in range(kk):
                    tels[k].host_gap_seconds.observe(max(t1 - g0, 0.0))
                    tels[k].observe_steps(dt / log_every, log_every)
                    tels[k].update_window(tokens_per_sec=tps_replica,
                                          mfu=mfu, step=base + i)
                    tels[k].record_streak(int(streaks[k]))
                    if evs is not None and frozen[k] and not prev_frozen[k]:
                        evs[k].emit(tev.REPLICA_FROZEN, step=base + i,
                                    streak=int(streaks[k]))
                prev_frozen = frozen.copy()
                windows.append({"steps": log_every, "seconds": dt,
                                "loss": loss.tolist(),
                                "frozen": frozen.tolist()})
                log(f"hfta step {base + i} "
                    f"loss[K]={np.round(loss, 4).tolist()} "
                    f"agg_tokens/s={tps_replica * kk:,.0f} "
                    f"frozen={int(frozen.sum())}/{kk}")
                t0 = g0 = time.perf_counter()
        wall = time.perf_counter() - start
        steady = windows[1:] if len(windows) > 1 else windows
        steady_steps = sum(w["steps"] for w in steady)
        steady_secs = max(sum(w["seconds"] for w in steady), 1e-9)
        steps_per_sec = steady_steps / steady_secs
        agg = replica_tokens * kk * steps_per_sec
        agg_stats = flops.throughput_stats(replica_flops * kk, steps_per_sec,
                                           n_devices, self.device)
        final_loss = windows[-1]["loss"] if windows else [float("nan")] * kk
        frozen_now = self._all(state.frozen).cpu().numpy()
        per_replica = {
            "tokens_per_sec": [replica_tokens * steps_per_sec] * kk,
            "mfu": [flops.throughput_stats(replica_flops, steps_per_sec, 1,
                                           self.device).get("mfu")] * kk,
            "goodput": [float(t.goodput.value) for t in tels],
            "loss": [float(x) for x in final_loss],
            "frozen": frozen_now.tolist(),
            "nonfinite_streak": self._all(
                state.nonfinite_streak).cpu().numpy().tolist(),
        }
        result = {"k": kk, "tokens_per_sec": agg,
                  "tokens_per_sec_per_device": agg / n_devices,
                  "wall_seconds": wall, "final_loss": per_replica["loss"],
                  "frozen_replicas": int(frozen_now.sum()),
                  "per_replica": per_replica}
        result.update(agg_stats)
        return state, result


class FusedTokenStream:
    """Step-keyed synthetic batches for K fused replicas: replica k's
    batch at global step i comes from the generator seeded by (seed, i,
    k) (the reference's fold_in(fold_in(PRNGKey(seed), i), k), with the
    port's generators, H6), `batch_size` rows of `seq_len` tokens. Yields
    this rank's share ([k, B, S] of its replicas, or its rows of every
    replica: `HFTATrainer.share`), so a restarted fused run replays the
    same tokens."""

    def __init__(self, trainer: HFTATrainer, batch_size: int, seq_len: int,
                 vocab_size: int, seed: int = 1, start: int = 0):
        self.trainer = trainer
        self.batch_size, self.seq_len = batch_size, seq_len
        self.vocab_size, self.seed, self.step = vocab_size, seed, start

    def batch(self, step: int):
        from ..data.synthetic import _step_seed, synthetic_token_batch
        tr, dev = self.trainer, self.trainer.device
        ks = (tr.replicas if tr.slice_sharing else range(tr.k))
        toks, tgts = [], []
        for k in ks:
            gen = torch.Generator(device=dev)
            gen.manual_seed(_step_seed(self.seed, step, k))
            t, y = synthetic_token_batch(gen, self.batch_size, self.seq_len,
                                         self.vocab_size)
            toks.append(t)
            tgts.append(y)
        toks, tgts = torch.stack(toks), torch.stack(tgts)
        if not tr.slice_sharing:
            toks, tgts = tr.share(toks), tr.share(tgts)
        return toks, tgts

    def __iter__(self):
        return self

    def __next__(self):
        out = self.batch(self.step)
        self.step += 1
        return out


__all__ = ["FusedTokenStream", "HFTAHyperparams", "HFTATrainState",
           "HFTATrainer", "poison_replica", "select_replicas"]
