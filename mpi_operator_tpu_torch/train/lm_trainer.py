"""Language-model trainer over the gang's mesh: the counterpart of
`mpi_operator_tpu/train/lm_trainer.py::LMTrainer` over the axes dcn,
dp, fsdp, ep, sp and tp (pipelines over pp train through
train/pp_trainer.py).

What it keeps of the reference, step for step:

- the objective: `lm_loss` (token-level softmax cross-entropy over f32
  logits, masked, normalised by the mask count or a given `denom`), or
  with `fused_xent` the chunked `fused_lm_loss`, whose [C, vocab] logits
  tiles are recomputed in the backward (`torch.utils.checkpoint` per
  chunk, as `jax.checkpoint` in the reference's scan); plus
  `moe_aux_weight` times the sum of the MoE blocks' mean aux losses
  (scaled by 1/accum_steps under accumulation; left out of eval);
- the model the config names: `MaskedLM` for a bidirectional (BERT)
  config, trained on the masked slots (`masked_lm`: the batch's third
  element is the mask of scored positions), else `CausalLM`;
- the optimizer `make_adamw`: optax's `chain(clip_by_global_norm,
  adamw)` written out by hand (`adamw_update`), because torch's AdamW
  differs: optax clips with `where(norm < max, g, g / norm * max)` (no
  epsilon in the divisor), adds the weight decay to the Adam direction
  before the learning rate scales it, decays EVERY parameter (biases,
  norm scales and embeddings too), and reads the schedule at the
  update's count before the count advances — so the first update of a
  warmup schedule uses lr(0) = 0 and moves nothing. eps 1e-8, eps_root
  0, bias correction on count + 1;
- gradient accumulation (`accum_steps`): each microbatch's loss is
  normalised by the FULL batch's mask count, so the summed gradients
  equal the full batch's;
- the divergence guard (train/resilience.py) on the loss and the norm of
  the unclipped gradients;
- `benchmark`: the windowed tokens/s protocol (one host sync a window),
  step time and host gap p50/p99 from TrainTelemetry's histograms,
  goodput, MFU against the card's peak (utils/flops.py), the profiler
  window, the periodic checkpoint hook and the resilience context
  (train/checkpoint.py, train/resilience.py).

The state is PyTorch's, updated IN PLACE: every f32 master parameter is
a view of one flat buffer (`LMTrainState.params`), which the optimizer
and the guard update with a few whole-buffer operations and no host
sync; the model the trainer builds reads its parameters through those
views, in the model dtype (bf16 casts per use, like flax's `dtype`).

Data parallelism. The reference jits the step over the global batch,
sharded over the mesh's data axes, so its loss, its masked-loss
denominator (H13), its MoE routing (H14) and its guard see the global
batch. Here each rank runs its rows of the global batch (the streams of
data/ give each rank its share of every microbatch, H16) and:

- normalises by the GLOBAL mask count, one all-reduce of a scalar
  before the forward (`_mask_total`);
- routes every MoE layer over the global batch (parallel/moe.py, the
  mesh set on each MoeMlp);
- scales its objective by the data-parallel degree W, so that it is W
  times this rank's share of the global loss, and after the backward
  (after the last microbatch under accumulation) averages ONE flat f32
  buffer over the mesh: the gradients with the loss and the accuracy's
  hit count appended (`_reduce`; across slices through
  `hierarchical_allreduce_mean`). The mean of W shares times W is the
  global gradient and loss (H13, H14);
- guards, reports and feeds TrainTelemetry with the global loss,
  accuracy and gradient norm, so every rank takes the same skip and
  rollback decisions (H15).

The all-reduce runs after the backward, not overlapped with it (the
parameters are views of one flat buffer, which DDP's bucket hooks and
its construction-time broadcast would not keep). Over a mesh without a
process group (one process) it is skipped and the step is the
single-device one, bit for bit.

Model parallelism. The reference lays its parameters out by the
logical sharding rules (parallel/sharding.py) and XLA inserts every
collective; here they are explicit:

- tp, ep: the model is built over the mesh (`ModelLayout`), each rank
  holding its blocks of the parameters (Megatron tensor parallelism in
  models/transformer.py, experts in parallel/moe.py); the flat buffer
  holds those blocks. The loss is vocab-parallel under tp
  (`vocab_parallel_xent`; with `fused_xent` chunked, and with the
  config's `tp_overlap` the ring form, `tp_overlap_lm_loss`). tp and ep
  ranks hold the same rows and compute the same loss, so their
  gradients need no reduction.
- sp: each rank holds a sequence shard of its rows (attention "ring"),
  so every gradient and the loss are summed over sp before the data
  axes' mean; the mask count sums over sp too.
- fsdp: a data axis whose ranks keep 1/fsdp of the flat buffer's
  masters, mu and nu between steps: the gradients are reduce-scattered
  over fsdp, the optimizer updates the rank's slice, and the slices are
  all-gathered into the flat buffer for the next forward (the whole
  buffer is gathered at once; a gather per Block is a later speed item).
- The global norm (the clip and the guard) sums each parameter's
  squares once over fsdp x ep x tp: the flat buffer is laid out by
  class (split over neither tp nor ep, over tp, over ep, over both)
  and each class is weighted by 1 over the ranks that hold the same
  values, so every rank takes the same skip and rollback decision (H15,
  H25).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..models.transformer import (TiedHead, TransformerConfig, model_class,
                                  param_shapes)
from ..ops.attention import NEG_INF
from ..parallel.collectives import (_all_gather, allgather,
                                    allgather_matmul, allreduce_max,
                                    allreduce_mean, allreduce_sum, copy_to,
                                    hierarchical_allreduce_mean, reduce_from,
                                    reduce_scatter, scatter_to)
from ..parallel.mesh import (BATCH_AXES, TOKEN_AXES, Mesh,
                             data_parallel_mesh)
from ..parallel.moe import MoeMlp
from ..parallel.sharding import (COMPUTE_AXES, ModelLayout, gather_block,
                                 shard_init)
from ..telemetry import TrainTelemetry, span
from ..utils import flops
from ..utils.device import DeviceLike, resolve_device
from ..utils.profiling import WindowProfiler
from .resilience import guard_nonfinite_update

ADAM_EPS = 1e-8          # optax.adamw's eps (eps_root 0)


@dataclasses.dataclass
class LMTrainerConfig:
    global_batch_size: int = 32
    seq_len: int = 1024
    learning_rate: float = 2.5e-4
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # "linear": warmup then constant; "cosine": warmup then cosine decay
    # over decay_steps down to end_lr_fraction of the peak
    lr_schedule: str = "linear"
    decay_steps: int = 10_000
    end_lr_fraction: float = 0.1
    moe_aux_weight: float = 0.01
    masked_lm: bool = False        # BERT-style objective over masked slots
    # chunked tied-head xent (fused_lm_loss); causal models only
    fused_xent: bool = False
    # split each batch into accum_steps microbatches, one update on the
    # summed gradient
    accum_steps: int = 1
    log_every: int = 10


# ---------------------------------------------------------------------------
# learning-rate schedules (optax's, on a count tensor)
# ---------------------------------------------------------------------------

def _linear_schedule(init: float, end: float, steps: int):
    """optax.linear_schedule: init -> end over `steps` counts, then end."""
    def schedule(count):
        c = torch.as_tensor(count).clamp(0, steps)
        frac = 1 - c.float() / steps
        return (init - end) * frac + end
    return schedule


def _cosine_schedule(init: float, decay_steps: int, alpha: float):
    """optax.cosine_decay_schedule (exponent 1)."""
    def schedule(count):
        c = torch.clamp(torch.as_tensor(count).float(), max=float(decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return init * ((1 - alpha) * cosine + alpha)
    return schedule


def make_lr_schedule(cfg: LMTrainerConfig) -> Callable:
    """The LR curve make_adamw drives, as a function of the update count
    (an int or an int tensor; returns an f32 tensor on its device):
    warmup-linear (constant after warmup) or warmup-cosine decaying to
    end_lr_fraction of the peak."""
    warmup = max(1, cfg.warmup_steps)
    if cfg.lr_schedule == "linear":
        return _linear_schedule(0.0, cfg.learning_rate, warmup)
    if cfg.lr_schedule == "cosine":
        peak = cfg.learning_rate
        decay = max(cfg.decay_steps, cfg.warmup_steps + 1)
        end = peak * cfg.end_lr_fraction
        warm = _linear_schedule(0.0, peak, warmup)
        cos = _cosine_schedule(peak, decay - warmup,
                               0.0 if peak == 0.0 else end / peak)

        def schedule(count):
            c = torch.as_tensor(count)
            return torch.where(c < warmup, warm(c), cos(c - warmup))
        return schedule
    raise ValueError(f"lr_schedule={cfg.lr_schedule!r}; expected 'linear' "
                     f"or 'cosine'")


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdamWState:
    """optax's adamw state over the flat parameter buffer: the update
    count (int32 on the device) and the two moments."""
    count: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor

    @classmethod
    def zeros_like(cls, params: torch.Tensor) -> "AdamWState":
        return cls(torch.zeros((), dtype=torch.int32, device=params.device),
                   torch.zeros_like(params), torch.zeros_like(params))


def adamw_update(p: torch.Tensor, g: torch.Tensor, g_norm: torch.Tensor,
                 opt: AdamWState, lr: torch.Tensor, cfg: LMTrainerConfig,
                 wd: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`make_adamw`'s update of flat f32 parameters `p` from gradients
    `g` whose global norm is `g_norm`, at learning rate `lr` (the
    schedule at opt.count). Returns new (params, mu, nu); the caller
    stores them and advances the count. Stacked [K, N] rows take g_norm,
    lr, opt.count and `wd` (in place of cfg.weight_decay) as [K, 1]
    columns. The operations follow optax's:

      g   = g if |g| < clip else g / |g| * clip
      mu  = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu
      u   = (mu / (1 - b1^(c+1))) / (sqrt(nu / (1 - b2^(c+1))) + eps)
      p   = p + (-lr) (u + wd p)
    """
    one = torch.ones((), dtype=torch.float32, device=g.device)
    trigger = g_norm < cfg.grad_clip
    g = g / torch.where(trigger, one, g_norm)
    g.mul_(torch.where(trigger, one, one * cfg.grad_clip))
    mu = g.mul(1 - cfg.b1).add_(opt.mu, alpha=cfg.b1)
    nu = torch.addcmul(opt.nu * cfg.b2, g, g, value=1 - cfg.b2)
    del g
    count = (opt.count + 1).float()
    bc1 = 1 - torch.pow(one * cfg.b1, count)
    bc2 = 1 - torch.pow(one * cfg.b2, count)
    den = (nu / bc2).sqrt_().add_(ADAM_EPS)
    u = (mu / bc1).div_(den)
    del den
    if wd is None:
        u.add_(p, alpha=cfg.weight_decay)
    else:
        u.add_(p * wd)
    u.mul_(-lr)
    return u.add_(p), mu, nu


# ---------------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------------

def vocab_parallel_xent(logits: torch.Tensor, targets: torch.Tensor,
                        layout) -> torch.Tensor:
    """Per-token softmax cross-entropy over f32 logits split over tp by
    vocab (this rank's [.., V/tp] tile, its rows from tp_rank x V/tp):
    the max, the sum of exponentials and the target's logit each
    completed over tp (Megatron's vocab-parallel cross-entropy, as the
    reference's `tp_overlap_lm_loss` spells it out)."""
    mesh, V = layout.mesh, logits.shape[-1]
    lmax = allreduce_max(logits.detach().amax(-1), mesh, "tp")
    sumexp = reduce_from(torch.exp(logits - lmax[..., None]).sum(-1),
                         mesh, "tp")
    local = targets.long() - layout.tp_rank * V
    inside = (local >= 0) & (local < V)
    picked = logits.gather(-1, local.clamp(0, V - 1)[..., None])[..., 0]
    tgt = reduce_from(torch.where(inside, picked, 0.0), mesh, "tp")
    return torch.log(sumexp) + lmax - tgt


def vocab_parallel_argmax(logits: torch.Tensor, layout) -> torch.Tensor:
    """The global argmax over vocab-parallel logits (the first of equal
    maxima, as argmax over the whole row)."""
    V = logits.shape[-1]
    val, idx = logits.detach().max(-1)
    vals = allgather(val, layout.mesh, "tp", axis=-1, tiled=False)
    idxs = allgather(idx + layout.tp_rank * V, layout.mesh, "tp", axis=-1,
                     tiled=False)
    return idxs.gather(-1, vals.argmax(-1, keepdim=True))[..., 0]


def _vocab_tp(layout) -> bool:
    return layout is not None and layout.tp_split("wte.weight")


def lm_loss(logits: torch.Tensor, targets: torch.Tensor, mask=None,
            denom=None, layout=None) -> torch.Tensor:
    """Token-level softmax cross-entropy over f32 logits; mask selects
    scored positions; `denom` overrides the normaliser (gradient
    accumulation passes the FULL batch's mask count). Over a layout
    whose head is vocab-parallel the logits are this rank's tile
    (`vocab_parallel_xent`)."""
    V = logits.shape[-1]
    if _vocab_tp(layout):
        losses = vocab_parallel_xent(logits.float(), targets, layout)
    else:
        losses = F.cross_entropy(logits.float().reshape(-1, V),
                                 targets.reshape(-1).long(),
                                 reduction="none").reshape(targets.shape)
    if mask is None and denom is None:
        return losses.mean()
    if mask is None:
        mask = torch.ones_like(losses)
    d = denom if denom is not None else torch.clamp(mask.sum(), min=1)
    return (losses * mask).sum() / d


def _chunk_loss(h_c, table, t_c, m_c, layout):
    logits = TiedHead.apply(h_c, table)             # [B, C, V] transient
    if _vocab_tp(layout):
        losses = vocab_parallel_xent(logits, t_c, layout)
    else:
        losses = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 t_c.reshape(-1).long(),
                                 reduction="none").reshape(t_c.shape)
    return (losses * m_c).sum()


def fused_lm_loss(h: torch.Tensor, table: torch.Tensor,
                  targets: torch.Tensor, mask=None, num_chunks: int = 8,
                  denom=None, layout=None) -> torch.Tensor:
    """Tied-head projection + softmax-xent chunked along the SEQUENCE, so
    the full [B*S, vocab] logits never exist: each chunk's [B, C, V]
    tile is made, reduced to its loss and dropped, and the backward
    recomputes it (`torch.utils.checkpoint`). h: [B, S, E] backbone
    output (`CausalLM(tokens, with_head=False)`); table: the [V, E] tied
    embedding, cast once to h's dtype (with a vocab-parallel head, this
    rank's rows: each tile is then [B, C, V/tp]). num_chunks degrades
    to gcd(num_chunks, S). Equals lm_loss over the tied logits."""
    B, S, _ = h.shape
    nc = math.gcd(num_chunks, S)
    C = S // nc
    m = (torch.ones((B, S), dtype=torch.float32, device=h.device)
         if mask is None else mask.float())
    if _vocab_tp(layout):
        h = copy_to(h, layout.mesh, "tp")
    table = table.to(h.dtype)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nc):
        sl = slice(i * C, (i + 1) * C)
        total = total + checkpoint(_chunk_loss, h[:, sl], table,
                                   targets[:, sl], m[:, sl], layout,
                                   use_reentrant=False)
    d = denom if denom is not None else torch.clamp(m.sum(), min=1)
    return total / d


def _overlap_chunk(h_c, wt, t_g, m_g, layout, ring, V, first):
    """One chunk of `tp_overlap_lm_loss`: this rank's chunk rows
    [B, Cl, E] against every rank's through the ring, [B, tp Cl, V/tp]
    logits, the vocab-parallel xent and its masked sum over the rows of
    every rank (each rank's vocab columns take part in every row's
    loss, so each rank's objective holds them all, the same value on
    every tp rank)."""
    logits = allgather_matmul(h_c, wt, layout.mesh, "tp", ring).float()
    cols = first + torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(cols < V, logits, NEG_INF)
    return (vocab_parallel_xent(logits, t_g, layout) * m_g).sum()


def tp_overlap_lm_loss(h: torch.Tensor, table: torch.Tensor,
                       targets: torch.Tensor, mask, layout,
                       num_chunks: int = 8, denom=None,
                       ring: str = "uni") -> torch.Tensor:
    """`fused_lm_loss` with the logits matmul vocab-parallel and
    overlapped (the reference's `tp_overlap_lm_loss`): h enters
    sequence-sharded over tp, and each chunk's logits tile is a ring
    `allgather_matmul(h_chunk, table_local^T)`, [B, tp Cl, V/tp] on a
    rank; the max, the normaliser and the target logit are completed
    over tp. A sequence or vocab that tp does not divide is zero-padded
    (pad rows masked out, pad vocab columns forced to -1e30 before the
    normaliser), so the loss is the unpadded one. `table` is this rank's
    vocab rows where the head is vocab-parallel, else the whole table
    (then each rank takes its block of it, the gradient summed over tp).
    Returns this tp group's rows' loss over `denom`, the same on every
    tp rank (the reference psums each rank's own rows instead, with
    JAX's transpose of psum; here every tp rank sums every row, which
    gives each rank the whole gradient of its vocab columns)."""
    mesh, tp = layout.mesh, layout.tp
    B, S, E = h.shape
    m = (torch.ones((B, S), dtype=torch.float32, device=h.device)
         if mask is None else mask.float())
    pad_s = (-S) % tp
    if pad_s:
        h = F.pad(h, (0, 0, 0, pad_s))
        targets = F.pad(targets, (0, pad_s))
        m = F.pad(m, (0, pad_s))
        S += pad_s
    if _vocab_tp(layout):
        V = table.shape[0] * tp
        first = layout.tp_rank * table.shape[0]
    else:
        V = table.shape[0]
        Vl = -(-V // tp)
        first = layout.tp_rank * Vl
        table = F.pad(copy_to(table, mesh, "tp"), (0, 0, 0, Vl * tp - V))
        table = table[first:first + Vl]
    Sl = S // tp
    nc = math.gcd(num_chunks, Sl)
    Cl = Sl // nc
    h_l = scatter_to(h, mesh, "tp", 1)
    wt = table.to(h.dtype).t()
    # chunk c's rows of every rank, in the ring's row order
    t_all = targets.long().view(B, tp, nc, Cl)
    m_all = m.view(B, tp, nc, Cl)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(nc):
        sl = slice(c * Cl, (c + 1) * Cl)
        total = total + checkpoint(
            _overlap_chunk, h_l[:, sl], wt, t_all[:, :, c].reshape(B, -1),
            m_all[:, :, c].reshape(B, -1), layout, ring, V, first,
            use_reentrant=False)
    d = denom if denom is not None else torch.clamp(
        allreduce_sum(m.sum(), mesh, BATCH_AXES), min=1)
    return total / d


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LMTrainState:
    """Everything a step updates, in place: the flat f32 master
    parameters (`model`'s parameters are views of it), the optimizer
    state, the step counter (host int: it always advances) and the
    device-side count of skipped steps in a row."""
    params: torch.Tensor
    opt: AdamWState
    model: torch.nn.Module         # CausalLM or MaskedLM
    step: int = 0
    nonfinite_streak: Optional[torch.Tensor] = None
    # under fsdp: this rank's 1/fsdp slice of the masters (`params` is
    # then their all-gathered working copy); None without fsdp
    master: Optional[torch.Tensor] = None
    # (this rank's shard, the shard count, whether it writes the shard)
    # of a state split over fsdp x ep x tp; None for a replica
    shard: Optional[Tuple[int, int, bool]] = None
    # what a sharded checkpoint must match to restore (train/checkpoint.py)
    layout_key: Optional[dict] = None
    fsdp_group: object = None
    # the mesh's whole group, over which a sharded save agrees on its name
    group: object = None

    @property
    def masters(self) -> torch.Tensor:
        """The f32 masters this rank keeps between steps: the fsdp slice,
        or the whole flat buffer."""
        return self.params if self.master is None else self.master

    def checkpoint_payload(self) -> Dict[str, torch.Tensor]:
        """The tensors a checkpoint holds (train/checkpoint.py), by DCP
        key: this rank's masters and the AdamW state."""
        opt = self.opt
        return {"params": self.masters, "opt.mu": opt.mu, "opt.nu": opt.nu,
                "opt.count": opt.count}

    def sync_params(self) -> None:
        """Refresh the working parameters from the masters: the fsdp
        slices all-gathered into the flat buffer, in place (no-op
        without fsdp)."""
        if self.master is not None:
            _all_gather(self.params, self.master, group=self.fsdp_group)

    def after_restore(self) -> None:
        self.sync_params()

    def named_params(self) -> Dict[str, torch.Tensor]:
        """{state-dict name: the f32 view of the flat buffer}."""
        return {n: p.detach() for n, p in self.model.named_parameters()}


#: the axes whose ranks hold other parts of the state
_SHARD_AXES = ("fsdp", "ep", "tp")
#: the flat buffer's classes of parameters, in order: replicated over
#: tp and ep, split over tp, over ep, over both (`_global_norm`)
_CLASSES = ((), ("tp",), ("ep",), ("tp", "ep"))


# -- the flat state, shared with train/pp_trainer.py ------------------------

def split_class(placement, mesh: Mesh) -> tuple:
    """A parameter's class in a flat buffer: the compute axes of size > 1
    its placement splits it over."""
    return tuple(a for a in placement.sharded_over() if mesh.shape[a] > 1)


def flat_layout(entries, classes=_CLASSES):
    """A flat buffer's layout from `entries`, (name, class, shape):
    [(name, shape)] grouped by class in the order of `classes` (each
    group in the entries' order), and the (class, start, end) segment of
    each class."""
    entries = list(entries)
    order, segments, off = [], [], 0
    for cls in classes:
        start = off
        for name, c, shape in entries:
            if c == cls:
                order.append((name, shape))
                off += math.prod(shape)
        segments.append((cls, start, off))
    return order, segments


def flat_slots(order) -> Dict[str, Tuple[int, tuple]]:
    """{name: (offset, shape)} of a flat buffer laid out in `order`."""
    slots, off = {}, 0
    for name, shape in order:
        slots[name] = (off, shape)
        off += math.prod(shape)
    return slots


def flat_views(buf: torch.Tensor, slots) -> Dict[str, torch.Tensor]:
    """{name: the view of `buf` at its slot}."""
    return {n: buf[o:o + math.prod(s)].view(s) for n, (o, s) in slots.items()}


def model_on_views(build: Callable[[], torch.nn.Module], views,
                   moe_mesh) -> torch.nn.Module:
    """`build()`'s module made on the meta device with the views as its
    parameters (the trainer's state IS the flat buffer), each MoE block
    routing over `moe_mesh` (None: its own rows alone)."""
    with torch.device("meta"):
        model = build()
    model.load_state_dict(views, strict=True, assign=True)
    for m in model.modules():
        if isinstance(m, MoeMlp):
            m.mesh = moe_mesh
    return model


def class_weight(mesh: Mesh, cls) -> float:
    """A class's weight in a global norm's sum over the compute axes: 1
    over the ranks that hold the same values, so each parameter counts
    once (H25)."""
    return 1.0 / math.prod(mesh.shape[a] for a in COMPUTE_AXES
                           if a not in cls)


def weighted_sq_norm(grads: torch.Tensor, segments,
                     weight: Callable[[tuple], float], lo: int = 0
                     ) -> torch.Tensor:
    """The f64 sum over the segments of weight(class) x the squares of
    `grads`, a slice of the flat buffer starting at `lo`. The squares
    sum in f64 (optax's per-leaf sums are exact to f32; an f32 reduction
    over a gpt2-size buffer drifts by ~1e-5)."""
    n = grads.numel()
    sq = grads.new_zeros((), dtype=torch.float64)
    for cls, start, end in segments:
        a, b = max(start, lo), min(end, lo + n)
        if a < b:
            sq = sq + torch.linalg.vector_norm(
                grads[a - lo:b - lo], dtype=torch.float64).square() \
                * weight(cls)
    return sq


def step_flops(config: LMTrainerConfig, model_config: TransformerConfig
               ) -> float:
    """GLOBAL model FLOPs of one train step: 6N + attention per token
    (utils/flops.py), times the tokens of a step. N counts every
    parameter of the whole model, each expert of a MoE block included
    though a token runs only top_k of them (the reference's count, kept
    for parity: ROADMAP.md Queue 3, G2); attention is halved for causal
    models only."""
    per_token = flops.transformer_train_flops_per_token(
        sum(math.prod(s) for s in param_shapes(model_config).values()),
        model_config.num_layers, model_config.embed_dim, config.seq_len,
        causal=model_config.causal)
    return per_token * config.global_batch_size * config.seq_len


def bench_report(tel: TrainTelemetry, tps: float, n: int, stats: dict,
                 losses) -> Dict[str, object]:
    """The keys both trainers' benchmarks return: tokens/s (and a
    device's share of the gang's `n`), the step time and host gap
    percentiles of `tel`, every timed step's loss and the FLOP stats."""
    p50_ms, p99_ms = tel.step_percentiles_ms()
    gap50_ms, gap99_ms = tel.host_gap_percentiles_ms()
    return {"tokens_per_sec": tps, "tokens_per_sec_per_device": tps / n,
            "step_time_p50_ms": p50_ms, "step_time_p99_ms": p99_ms,
            "host_gap_p50_ms": gap50_ms, "host_gap_p99_ms": gap99_ms,
            "step_losses": torch.stack(losses).tolist(), **stats}


class LMTrainer:
    """Trainer for the port's LMs (CausalLM, or MaskedLM for a BERT
    config) over `mesh` (default: every rank of the process group on dp,
    one process without one): data parallelism over dcn x dp x fsdp,
    fsdp over the optimizer state, tensor (tp), sequence (sp) and expert
    (ep) parallelism in the model. It builds its own model (trainable,
    this rank's blocks of the f32 master parameters laid flat) from a
    TransformerConfig; runs on the CUDA card unless `device="cpu"`. A
    step takes this rank's rows of the global batch (and under sp its
    sequence shard of them)."""

    def __init__(self, model_config: TransformerConfig,
                 config: Optional[LMTrainerConfig] = None,
                 device: DeviceLike = None, mesh: Optional[Mesh] = None):
        self.model_config = model_config
        self.config = config or LMTrainerConfig()
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else data_parallel_mesh()
        self.schedule = make_lr_schedule(self.config)
        A, W = self.config.accum_steps, self.mesh.dim_size(BATCH_AXES)
        sp = self.mesh.shape["sp"]
        if A < 1:
            raise ValueError(f"accum_steps={A} must be >= 1")
        if self.config.global_batch_size % (A * W):
            raise ValueError(
                f"global_batch_size={self.config.global_batch_size} must "
                f"split into accum_steps={A} microbatches of whole "
                f"per-rank shards (data-parallel degree {W})")
        if self.config.seq_len % sp:
            raise ValueError(
                f"seq_len={self.config.seq_len} not divisible by the mesh's "
                f"sp={sp}; context parallelism shards the sequence axis")
        if self.config.fused_xent and (self.config.masked_lm
                                       or not model_config.causal):
            raise ValueError("fused_xent supports the causal LM only "
                             "(BERT's MLM head has extra layers before "
                             "the tied decoder)")
        self.layout = ModelLayout.of(self.mesh, model_config)

    # -- the state --------------------------------------------------------

    def _flat_order(self):
        """[(name, local shape)] in the flat buffer's order, and the
        [start, end) of each class of `_CLASSES` in it: parameters split
        over neither tp nor ep first, in `param_shapes` order (the whole
        buffer without a layout), then each split class."""
        if self.layout is None:
            return flat_layout((n, (), s) for n, s in
                               param_shapes(self.model_config).items())
        return flat_layout((n, split_class(p, self.mesh), p.local_shape)
                           for n, p in self.layout.placements.items())

    def init_state(self, seed: int = 0,
                   state_dict: Optional[Dict[str, torch.Tensor]] = None
                   ) -> LMTrainState:
        """A fresh state: parameters from `state_dict` (e.g. converted
        from the reference with params_from_flax; the whole model's) or
        drawn from `seed` (models/convert.py init_params: the same values
        on every mesh), this rank's blocks of them laid flat; zeroed
        moments, step 0. Under fsdp the masters and moments are this
        rank's 1/fsdp slice of the flat buffer (zero-padded to split)."""
        from ..models.convert import init_params
        cfg, dev = self.model_config, self.device
        if self.layout is not None:
            state_dict = shard_init(cfg, self.mesh, seed, state_dict, dev)
        elif state_dict is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            state_dict = init_params(cfg, gen, device=dev)
        order, self._segments = self._flat_order()
        fsdp = self.mesh.shape["fsdp"]
        n = sum(math.prod(s) for _, s in order)
        flat = torch.zeros(n + (-n) % fsdp, dtype=torch.float32, device=dev)
        views = flat_views(flat, flat_slots(order))
        for name, view in views.items():
            view.copy_(torch.as_tensor(state_dict[name]).reshape(view.shape))
        model = model_on_views(lambda: model_class(cfg)(cfg, self.layout),
                               views, self.mesh)   # global routing (H14)
        master = None
        if fsdp > 1:
            per = flat.numel() // fsdp
            i = self.mesh.index(("fsdp",))
            master = flat[i * per:(i + 1) * per].clone()
        shards, shard = self.mesh.dim_size(_SHARD_AXES), None
        if shards > 1:
            c = self.mesh.coords()
            shard = (self.mesh.index(_SHARD_AXES), shards,
                     all(c[a] == 0 for a in TOKEN_AXES
                         if a not in _SHARD_AXES))
        return LMTrainState(
            params=flat, opt=AdamWState.zeros_like(
                flat if master is None else master), model=model,
            nonfinite_streak=torch.zeros((), dtype=torch.int32, device=dev),
            master=master, shard=shard, layout_key=self.layout_key(),
            fsdp_group=self.mesh.group(("fsdp",)),
            group=self.mesh.group(self.mesh.shape))

    def layout_key(self) -> dict:
        """What a sharded checkpoint of this trainer's state depends on:
        the sizes of the axes that split the state (fsdp, ep, tp) and
        the model's parameters."""
        return {"mesh": {a: self.mesh.shape[a] for a in _SHARD_AXES},
                "params": [[n, list(s)] for n, s in
                           param_shapes(self.model_config).items()]}

    def global_flat(self, state: LMTrainState,
                    which: str = "params") -> torch.Tensor:
        """The whole model's flat f32 buffer of `which` ("params", "mu"
        or "nu") in `param_shapes` order: what one process's state holds.
        Collective: every rank of the mesh calls it."""
        t = {"params": state.masters, "mu": state.opt.mu,
             "nu": state.opt.nu}[which]
        if state.master is not None:
            t = allgather(t, self.mesh, "fsdp")
        if self.layout is None:
            return t[:sum(math.prod(s) for s in
                          param_shapes(self.model_config).values())].clone()
        local = flat_views(t, flat_slots(self._flat_order()[0]))
        return torch.cat([gather_block(local[name], p, self.mesh).reshape(-1)
                          for name, p in self.layout.placements.items()])

    # -- the objective and its gradients ---------------------------------

    def _loss(self, state: LMTrainState, tokens, targets, mask,
              denom=None, aux_scale=1.0, include_aux=True):
        """(loss, logits or None). `denom` and `aux_scale` make the sum of
        microbatch gradients the full batch's: the FULL batch's mask
        count, and 1 / accum_steps on the aux term."""
        model, lay = state.model, self.layout
        if self.config.fused_xent:
            h, aux = model.forward_train(tokens, with_head=False)
            if self.model_config.tp_overlap and lay is not None \
                    and lay.tp > 1:
                loss = tp_overlap_lm_loss(h, model.wte.weight, targets,
                                          mask, lay, denom=denom,
                                          ring=self.model_config.tp_ring)
            else:
                loss = fused_lm_loss(h, model.wte.weight, targets, mask,
                                     denom=denom, layout=lay)
            logits = None
        else:
            logits, aux = model.forward_train(tokens)
            loss = lm_loss(logits, targets, mask, denom=denom, layout=lay)
        if aux and include_aux:
            loss = loss + aux_scale * self.config.moe_aux_weight * sum(
                a.mean() for a in aux)
        return loss, logits

    def _batch(self, tokens, targets, mask):
        tokens = torch.as_tensor(tokens, device=self.device).long()
        targets = torch.as_tensor(targets, device=self.device).long()
        mask = (torch.ones(targets.shape, dtype=torch.float32,
                           device=self.device) if mask is None
                else torch.as_tensor(mask, device=self.device).float())
        return tokens, targets, mask

    def _mask_total(self, mask: torch.Tensor) -> torch.Tensor:
        """The GLOBAL batch's mask count (at least 1), the reference's
        normaliser (H13): this rank's count summed over the ranks that
        hold other tokens (the data axes and sp)."""
        return torch.clamp(allreduce_sum(mask.sum(), self.mesh, TOKEN_AXES),
                           min=1.0)

    def _reduce(self, flat: torch.Tensor) -> torch.Tensor:
        """The mean of `flat` over dcn x dp (in place where it can be):
        one all-reduce, or across slices the hierarchical one."""
        if self.mesh.shape["dcn"] > 1:
            return hierarchical_allreduce_mean(flat, self.mesh)
        return allreduce_mean(flat, self.mesh, ("dcn", "dp"), inplace=True)

    def _reduce_scalars(self, x: torch.Tensor) -> torch.Tensor:
        """Per-rank shares of a global sum (the loss, the hit count)
        made whole: summed over sp, averaged over the data axes."""
        x = allreduce_sum(x, self.mesh, "sp")
        return allreduce_mean(x, self.mesh, BATCH_AXES)

    def loss_and_grads(self, state: LMTrainState, tokens, targets,
                       mask=None):
        """(loss, f32 gradients of this rank's masters, accuracy) of one
        global batch at the current parameters, this rank holding its
        rows (its sequence shard under sp); with accum_steps > 1 the
        microbatches' losses and gradients summed (accuracy NaN, as in
        the reference). The loss and accuracy are the global batch's,
        the same on every rank; under fsdp the gradients are this rank's
        slice, reduce-scattered."""
        tokens, targets, mask = self._batch(tokens, targets, mask)
        A, W = self.config.accum_steps, self.mesh.dim_size(BATCH_AXES)
        total = self._mask_total(mask)
        # W x this rank's share of the global objective: the sum over sp
        # and the mean over the data axes of these gradients is the
        # global batch's
        denom = total / W
        hits = torch.full((), float("nan"), device=self.device)
        if A > 1:
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            for t, g, m in zip(tokens.chunk(A), targets.chunk(A),
                               mask.chunk(A)):
                micro, _ = self._loss(state, t, g, m, denom=denom,
                                      aux_scale=W / A)
                micro.backward()
                loss = loss + micro.detach()
        else:
            loss, logits = self._loss(state, tokens, targets, mask,
                                      denom=denom, aux_scale=W)
            if logits is not None:
                pick = (vocab_parallel_argmax(logits, self.layout)
                        if _vocab_tp(self.layout)
                        else logits.detach().argmax(-1))
                hits = ((pick == targets).float() * mask).sum() * W
            loss.backward()
            loss = loss.detach()
        params = [state.model.get_parameter(n)
                  for n, _ in self._flat_order()[0]]           # flat order
        pad = state.params.numel() - sum(p.numel() for p in params)
        grads = [torch.zeros_like(p).reshape(-1) if p.grad is None
                 else p.grad.reshape(-1) for p in params]
        for p in params:
            p.grad = None
        if pad:
            grads.append(state.params.new_zeros(pad))
        fsdp, sp = self.mesh.shape["fsdp"], self.mesh.shape["sp"]
        if fsdp == 1:
            flat = torch.cat(grads + [loss.reshape(1), hits.reshape(1)])
            if sp > 1:
                flat = allreduce_sum(flat, self.mesh, "sp", inplace=True)
            flat = self._reduce(flat)
            # the loss is cloned out: a view would keep the whole buffer
            return flat[-2].clone(), flat[:-2], flat[-1] / total
        flat = torch.cat(grads)
        if sp > 1:
            flat = allreduce_sum(flat, self.mesh, "sp", inplace=True)
        shard = self._reduce(reduce_scatter(flat, self.mesh, "fsdp"))
        shard.div_(fsdp)
        scalars = self._reduce_scalars(torch.stack([loss, hits]))
        return scalars[0], shard, scalars[1] / total

    def _norm_weight(self, cls) -> float:
        """A class's weight in the norm's sum over the fsdp x ep x tp
        group (`class_weight`)."""
        return class_weight(self.mesh, cls)

    def _global_norm(self, grads: torch.Tensor) -> torch.Tensor:
        """The L2 norm (f32) of the whole model's gradient from this
        rank's slice of its blocks: each class's sum of squares weighted
        by `_norm_weight` and summed over fsdp x ep x tp, in f64
        (`weighted_sq_norm`)."""
        if self.layout is None and self.mesh.shape["fsdp"] == 1:
            return torch.linalg.vector_norm(grads, dtype=torch.float64
                                            ).float()
        sq = weighted_sq_norm(grads, self._segments, self._norm_weight,
                              lo=self.mesh.index(("fsdp",)) * grads.numel())
        return allreduce_sum(sq, self.mesh, ("fsdp",) + COMPUTE_AXES
                             ).sqrt().float()

    def _apply(self, state: LMTrainState, grads: torch.Tensor,
               loss: torch.Tensor) -> None:
        """One optimizer update of `state`, in place, guarded: a step
        with a non-finite loss or gradient norm applies no update. Under
        fsdp the updated slices are then gathered for the next forward."""
        g_norm = self._global_norm(grads)
        opt = state.opt
        lr = self.schedule(opt.count)
        p, mu, nu = adamw_update(state.masters, grads, g_norm, opt, lr,
                                 self.config)
        updates = [(state.masters, p), (opt.mu, mu), (opt.nu, nu),
                   (opt.count, opt.count + 1)]
        state.nonfinite_streak = guard_nonfinite_update(
            updates, loss, g_norm, state.nonfinite_streak)
        state.sync_params()

    def train_step(self, state: LMTrainState, tokens, targets, mask=None
                   ) -> Tuple[LMTrainState, Dict[str, torch.Tensor]]:
        """One step: forward, backward, guarded AdamW update. Returns the
        (same, updated) state and device-side metrics."""
        loss, grads, acc = self.loss_and_grads(state, tokens, targets, mask)
        self._apply(state, grads, loss)
        state.step += 1
        return state, {"loss": loss, "accuracy": acc,
                       "nonfinite_streak": state.nonfinite_streak}

    @torch.no_grad()
    def eval_step(self, state: LMTrainState, tokens, targets, mask=None
                  ) -> torch.Tensor:
        """Loss-only forward at the current params (no grads, no
        update). The MoE aux term is left out: it only shapes gradients,
        and would inflate exp(val_loss) past the perplexity."""
        tokens, targets, mask = self._batch(tokens, targets, mask)
        W = self.mesh.dim_size(BATCH_AXES)
        loss = self._loss(state, tokens, targets, mask,
                          denom=self._mask_total(mask) / W,
                          include_aux=False)[0]
        return self._reduce_scalars(loss)

    def evaluate(self, state: LMTrainState, dataset: Iterable,
                 num_batches: int = 10) -> Dict[str, float]:
        """Mean held-out loss + perplexity over `num_batches` batches of
        `dataset` (same batch contract as the training stream)."""
        total = 0.0
        it = iter(dataset)
        for _ in range(num_batches):
            total += float(self.eval_step(state, *next(it)))
        mean = total / max(1, num_batches)
        return {"val_loss": mean, "perplexity": math.exp(min(mean, 30.0))}

    # -- the benchmark ----------------------------------------------------

    def _step_flops(self, state: LMTrainState) -> float:
        """GLOBAL model FLOPs of one train step (`step_flops`)."""
        return step_flops(self.config, self.model_config)

    def benchmark(self, state: LMTrainState, dataset: Iterable,
                  num_steps: int = 50, warmup_steps: int = 5,
                  log: Callable[[str], None] = print,
                  profile_dir: Optional[str] = None,
                  step_hook: Optional[Callable] = None,
                  resilience=None,
                  telemetry: Optional[TrainTelemetry] = None,
                  ) -> Tuple[LMTrainState, Dict[str, object]]:
        """tokens/sec over windows of `log_every` steps, the reference's
        protocol: the loop dispatches steps without waiting for the
        device; each window ends with one host read of the loss, so the
        window's wall time is its steps' device time plus what the host
        could not hide. `warmup_steps` (at least one) run first and are
        not timed; the first window is dropped from the mean when there
        are several.

        step_hook(state, step) fires after every timed step (periodic
        checkpoints: train/checkpoint.periodic_saver). resilience: an
        entered train.resilience.ResilienceContext — per-step stop check
        (emergency checkpoint + Preempted on a drain) and divergence
        rollback at window fetches. telemetry: a TrainTelemetry to feed;
        when None a private one still runs, so step time p50/p99, the
        host gap and goodput always come from its histograms. The step
        counter is a host int, so none of this syncs the device between
        window fetches. profile_dir: a torch.profiler chrome trace of the
        first window.

        Returns the reference's keys (tokens_per_sec, step_time_p50_ms /
        p99, host_gap_*, goodput, final_loss, flops_per_step,
        tflops_per_sec_per_device, mfu, ...) and `step_losses`, every
        timed step's loss."""
        from .resilience import Preempted

        cfg, n = self.config, self.mesh.size     # the gang's devices
        tel = telemetry if telemetry is not None else TrainTelemetry()
        if resilience is not None and resilience.telemetry is None:
            resilience.telemetry = tel    # rollback accounting -> goodput
        it = iter(dataset)
        state, metrics = self.train_step(state, *next(it))
        flops_per_step = self._step_flops(state)
        for _ in range(max(0, warmup_steps - 1)):
            state, metrics = self.train_step(state, *next(it))
        float(metrics["loss"])
        base_step = state.step
        tokens_per_step = cfg.global_batch_size * cfg.seq_len
        log_every = max(1, min(cfg.log_every, num_steps))
        windows, losses = [], []
        profiler = WindowProfiler(profile_dir, log, self.device)
        profiler.start()
        t0 = time.perf_counter()
        wall0 = t0
        try:
            for i in range(1, num_steps + 1):
                batch = next(it)
                with span("train.step"):
                    state, metrics = self.train_step(state, *batch)
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
                    loss = float(metrics["loss"])   # the window's one sync
                    t1 = time.perf_counter()        # BEFORE the trace write
                    tel.host_gap_seconds.observe(t1 - g0)
                    profiler.stop_if_active()
                    tps = tokens_per_step * log_every / (t1 - t0)
                    windows.append(tps)
                    tel.observe_steps((t1 - t0) / log_every, log_every)
                    tel.update_window(
                        tokens_per_sec=tps,
                        mfu=flops.throughput_stats(
                            flops_per_step, tps / tokens_per_step, n,
                            self.device)["mfu"],
                        step=base_step + i)
                    streak = int(metrics["nonfinite_streak"])
                    if streak:
                        tel.record_streak(streak)
                    log(f"{i}\ttokens/sec: {tps:.0f}\tloss: {loss:.3f}"
                        + (f"\tnon-finite streak: {streak}" if streak
                           else ""))
                    if resilience is not None \
                            and streak >= resilience.config.divergence_k:
                        state = resilience.rollback(state)
                        base_step = state.step - i
                    t0 = time.perf_counter()
        finally:
            profiler.stop_if_active()
        steady = windows[1:] if len(windows) > 1 else windows
        tps = sum(steady) / len(steady)
        stats = flops.throughput_stats(flops_per_step, tps / tokens_per_step,
                                       n, self.device)
        out = bench_report(tel, tps, n, stats, losses)
        log("-" * 40)
        log(f"total tokens/sec: {tps:.0f}")
        if out["step_time_p50_ms"] is not None:
            log(f"step time: p50 {out['step_time_p50_ms']:.1f} ms, p99 "
                f"{out['step_time_p99_ms']:.1f} ms, goodput "
                f"{tel.goodput.value:.1%}")
        if stats["mfu"] is not None:
            log(f"per-device: {stats['tflops_per_sec_per_device']:.1f} "
                f"TFLOP/s, MFU {stats['mfu']:.1%}")
        log("-" * 40)
        return state, dict(out, wall_seconds=time.perf_counter() - wall0,
                           final_loss=float(metrics["loss"]),
                           goodput=tel.goodput.value)


__all__ = ["ADAM_EPS", "AdamWState", "LMTrainState", "LMTrainer",
           "LMTrainerConfig", "adamw_update", "fused_lm_loss", "lm_loss",
           "make_lr_schedule", "tp_overlap_lm_loss", "vocab_parallel_argmax",
           "vocab_parallel_xent"]
