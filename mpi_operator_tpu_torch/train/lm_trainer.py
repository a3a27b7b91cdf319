"""Language-model trainer on one device: the flat single-device path of
the reference's `mpi_operator_tpu/train/lm_trainer.py::LMTrainer`.

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

Not here yet (later slices): the mesh and its shardings (tp/sp/pp/ep)
and `tp_overlap_lm_loss`.
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
                 opt: AdamWState, lr: torch.Tensor, cfg: LMTrainerConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`make_adamw`'s update of flat f32 parameters `p` from gradients
    `g` whose global norm is `g_norm`, at learning rate `lr` (the
    schedule at opt.count). Returns new (params, mu, nu); the caller
    stores them and advances the count. The operations follow optax's:

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
    u.add_(p, alpha=cfg.weight_decay)
    u.mul_(-lr)
    return u.add_(p), mu, nu


# ---------------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------------

def lm_loss(logits: torch.Tensor, targets: torch.Tensor, mask=None,
            denom=None) -> torch.Tensor:
    """Token-level softmax cross-entropy over f32 logits; mask selects
    scored positions; `denom` overrides the normaliser (gradient
    accumulation passes the FULL batch's mask count)."""
    V = logits.shape[-1]
    losses = F.cross_entropy(logits.float().reshape(-1, V),
                             targets.reshape(-1).long(),
                             reduction="none").reshape(targets.shape)
    if mask is None and denom is None:
        return losses.mean()
    if mask is None:
        mask = torch.ones_like(losses)
    d = denom if denom is not None else torch.clamp(mask.sum(), min=1)
    return (losses * mask).sum() / d


def _chunk_loss(h_c, table, t_c, m_c):
    logits = TiedHead.apply(h_c, table)             # [B, C, V] transient
    losses = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             t_c.reshape(-1).long(),
                             reduction="none").reshape(t_c.shape)
    return (losses * m_c).sum()


def fused_lm_loss(h: torch.Tensor, table: torch.Tensor,
                  targets: torch.Tensor, mask=None, num_chunks: int = 8,
                  denom=None) -> torch.Tensor:
    """Tied-head projection + softmax-xent chunked along the SEQUENCE, so
    the full [B*S, vocab] logits never exist: each chunk's [B, C, V]
    tile is made, reduced to its loss and dropped, and the backward
    recomputes it (`torch.utils.checkpoint`). h: [B, S, E] backbone
    output (`CausalLM(tokens, with_head=False)`); table: the [V, E] tied
    embedding, cast once to h's dtype. num_chunks degrades to
    gcd(num_chunks, S). Equals lm_loss over the tied logits."""
    B, S, _ = h.shape
    nc = math.gcd(num_chunks, S)
    C = S // nc
    m = (torch.ones((B, S), dtype=torch.float32, device=h.device)
         if mask is None else mask.float())
    table = table.to(h.dtype)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nc):
        sl = slice(i * C, (i + 1) * C)
        total = total + checkpoint(_chunk_loss, h[:, sl], table,
                                   targets[:, sl], m[:, sl],
                                   use_reentrant=False)
    d = denom if denom is not None else torch.clamp(m.sum(), min=1)
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

    def named_params(self) -> Dict[str, torch.Tensor]:
        """{state-dict name: the f32 view of the flat buffer}."""
        return {n: p.detach() for n, p in self.model.named_parameters()}


class LMTrainer:
    """Single-device trainer for the port's LMs (CausalLM, or MaskedLM
    for a BERT config). It builds its own model (trainable, f32 master
    parameters laid flat) from a TransformerConfig; runs on the CUDA
    card unless `device="cpu"`."""

    def __init__(self, model_config: TransformerConfig,
                 config: Optional[LMTrainerConfig] = None,
                 device: DeviceLike = None):
        self.model_config = model_config
        self.config = config or LMTrainerConfig()
        self.device = resolve_device(device)
        self.schedule = make_lr_schedule(self.config)
        A = self.config.accum_steps
        if A < 1:
            raise ValueError(f"accum_steps={A} must be >= 1")
        if self.config.global_batch_size % A:
            raise ValueError(
                f"global_batch_size={self.config.global_batch_size} must "
                f"split into accum_steps={A} equal microbatches")
        if self.config.fused_xent and (self.config.masked_lm
                                       or not model_config.causal):
            raise ValueError("fused_xent supports the causal LM only "
                             "(BERT's MLM head has extra layers before "
                             "the tied decoder)")

    def init_state(self, seed: int = 0,
                   state_dict: Optional[Dict[str, torch.Tensor]] = None
                   ) -> LMTrainState:
        """A fresh state: parameters from `state_dict` (e.g. converted
        from the reference with params_from_flax) or drawn from `seed`
        (models/convert.py init_params), zeroed moments, step 0."""
        from ..models.convert import init_params
        cfg, dev = self.model_config, self.device
        if state_dict is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            state_dict = init_params(cfg, gen, device=dev)
        shapes = param_shapes(cfg)
        sizes = [math.prod(s) for s in shapes.values()]
        flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
        views, off = {}, 0
        for (name, shape), n in zip(shapes.items(), sizes):
            view = flat[off:off + n]
            view.copy_(torch.as_tensor(state_dict[name]).reshape(-1))
            views[name] = view.view(shape)
            off += n
        with torch.device("meta"):
            model = model_class(cfg)(cfg)
        model.load_state_dict(views, strict=True, assign=True)
        return LMTrainState(
            params=flat, opt=AdamWState.zeros_like(flat), model=model,
            nonfinite_streak=torch.zeros((), dtype=torch.int32, device=dev))

    # -- the objective and its gradients ---------------------------------

    def _loss(self, state: LMTrainState, tokens, targets, mask,
              denom=None, aux_scale=1.0, include_aux=True):
        """(loss, logits or None). `denom` and `aux_scale` make the sum of
        microbatch gradients the full batch's: the FULL batch's mask
        count, and 1 / accum_steps on the aux term."""
        model = state.model
        if self.config.fused_xent:
            h, aux = model.forward_train(tokens, with_head=False)
            loss = fused_lm_loss(h, model.wte.weight, targets, mask,
                                 denom=denom)
            logits = None
        else:
            logits, aux = model.forward_train(tokens)
            loss = lm_loss(logits, targets, mask, denom=denom)
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

    def loss_and_grads(self, state: LMTrainState, tokens, targets,
                       mask=None):
        """(loss, flat f32 gradients, accuracy) of one batch at the
        current parameters; with accum_steps > 1 the microbatches' losses
        and gradients summed (accuracy NaN, as in the reference)."""
        tokens, targets, mask = self._batch(tokens, targets, mask)
        A = self.config.accum_steps
        nan = torch.full((), float("nan"), device=self.device)
        if A > 1:
            total = torch.clamp(mask.sum(), min=1.0)
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            for t, g, m in zip(tokens.chunk(A), targets.chunk(A),
                               mask.chunk(A)):
                micro, _ = self._loss(state, t, g, m, denom=total,
                                      aux_scale=1.0 / A)
                micro.backward()
                loss = loss + micro.detach()
            acc = nan
        else:
            loss, logits = self._loss(state, tokens, targets, mask)
            acc = nan
            if logits is not None:
                hit = (logits.detach().argmax(-1) == targets).float()
                acc = (hit * mask).sum() / torch.clamp(mask.sum(), min=1.0)
            loss.backward()
            loss = loss.detach()
        params = [state.model.get_parameter(n)
                  for n in param_shapes(self.model_config)]   # flat order
        grads = torch.cat([torch.zeros_like(p).reshape(-1) if p.grad is None
                           else p.grad.reshape(-1) for p in params])
        for p in params:
            p.grad = None
        return loss, grads, acc

    def _apply(self, state: LMTrainState, grads: torch.Tensor,
               loss: torch.Tensor) -> None:
        """One optimizer update of `state`, in place, guarded: a step
        with a non-finite loss or gradient norm applies no update."""
        g_norm = torch.linalg.vector_norm(grads)
        opt = state.opt
        lr = self.schedule(opt.count)
        p, mu, nu = adamw_update(state.params, grads, g_norm, opt, lr,
                                 self.config)
        updates = [(state.params, p), (opt.mu, mu), (opt.nu, nu),
                   (opt.count, opt.count + 1)]
        state.nonfinite_streak = guard_nonfinite_update(
            updates, loss, g_norm, state.nonfinite_streak)

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
        return self._loss(state, tokens, targets, mask,
                          include_aux=False)[0]

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
        """GLOBAL model FLOPs of one train step: 6N + attention per token
        (utils/flops.py), times the tokens of a step. N counts every
        parameter, each expert of a MoE block included though a token
        runs only top_k of them (the reference's count, kept for
        parity: ROADMAP.md Queue 3, G2); attention is halved for causal
        models only."""
        cfg, mcfg = self.config, self.model_config
        per_token = flops.transformer_train_flops_per_token(
            state.params.numel(), mcfg.num_layers, mcfg.embed_dim,
            cfg.seq_len, causal=mcfg.causal)
        return per_token * cfg.global_batch_size * cfg.seq_len

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

        cfg = self.config
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
                            flops_per_step, tps / tokens_per_step, 1,
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
                                       1, self.device)
        p50_ms, p99_ms = tel.step_percentiles_ms()
        gap50_ms, gap99_ms = tel.host_gap_percentiles_ms()
        log("-" * 40)
        log(f"total tokens/sec: {tps:.0f}")
        if p50_ms is not None:
            log(f"step time: p50 {p50_ms:.1f} ms, p99 {p99_ms:.1f} ms, "
                f"goodput {tel.goodput.value:.1%}")
        if stats["mfu"] is not None:
            log(f"per-device: {stats['tflops_per_sec_per_device']:.1f} "
                f"TFLOP/s, MFU {stats['mfu']:.1%}")
        log("-" * 40)
        return state, {
            "tokens_per_sec": tps,
            "tokens_per_sec_per_device": tps,
            "wall_seconds": time.perf_counter() - wall0,
            "final_loss": float(metrics["loss"]),
            "step_losses": torch.stack(losses).tolist(),
            "step_time_p50_ms": p50_ms,
            "step_time_p99_ms": p99_ms,
            "host_gap_p50_ms": gap50_ms,
            "host_gap_p99_ms": gap99_ms,
            "goodput": tel.goodput.value,
            **stats,
        }


__all__ = ["ADAM_EPS", "AdamWState", "LMTrainState", "LMTrainer",
           "LMTrainerConfig", "adamw_update", "fused_lm_loss", "lm_loss",
           "make_lr_schedule"]
