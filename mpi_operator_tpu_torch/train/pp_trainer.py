"""Pipeline-parallel LM trainer: the counterpart of
`mpi_operator_tpu/train/pp_trainer.py::PipelineLMTrainer` over a gang's
mesh with a pp axis, under GPipe or interleaved 1F1B.

The reference keeps the blocks stacked [L, ...] and sharded over pp
(each stage's optimizer update touches only its layers), the embeddings
and norms replicated, and jits one step around the pipeline's loss (or
around the 1F1B schedule's in-schedule gradients). Here each pp rank is a
process holding a `StageLM` (parallel/pipeline.py): its layers under
their global names and every replicated leaf, all f32 masters laid flat
in one buffer (the replicated leaves first, then its blocks, grouped by
how tp and ep split them) that the model reads through views, as the
LMTrainer's state does.

A step (`loss_and_grads`, then `_apply`):

- the schedule runs this rank's virtual stages over the M microbatches
  of its rows (`run_forward` + `gpipe_backward`, or `run_1f1b` over the
  simulated tables) and leaves each parameter's gradient of this rank's
  share of the objective in `.grad`. Each in-flight microbatch keeps its
  autograd graph until its backward tick (the port's launch plan, option
  A: K1 launches once a layer a microbatch in the forward, K2 and K3 once
  in the backward, (L / P) x M a step on each rank; the reference
  recomputes the forward in its 1F1B backward ticks instead). Under
  1F1B the schedule's in-flight cap bounds the graphs kept;
- the objective of a rank is its rows' summed cross-entropy over the
  GLOBAL denominator (H33): B x S for the causal LM, max(the global mask
  count, 1) for the masked LM (the count summed over the data axes and
  sp before the step), plus moe_aux_weight x the MoE blocks' aux losses
  over M x (data degree x sp), each routed over this rank's microbatch
  rows alone (the reference's per (microbatch, data shard) routing);
- the replicated leaves' gradients are summed over pp (H30: wte's is its
  embedding's on stage 0 plus its tied head's on the last stage), then
  every gradient over the data axes and sp;
- the global norm counts each block once (its stage's) and each
  replicated leaf once, not pp times (H34), over pp x ep x tp as the
  LMTrainer's does over fsdp x ep x tp (H25), the squares summed in f64;
- the optimizer is `adamw_update` with the global-norm clip, optax's
  `make_adamw` written out, on the flat buffer. There is no in-step
  non-finite guard, as in the reference: `benchmark` reads the loss on
  the host every `divergence_k` steps and rolls back when it is not
  finite, and a preemption writes an emergency checkpoint and raises
  `Preempted`.

Every rank reports the same loss (summed over pp, the data axes and sp).
fsdp is a data axis only under pp, as in the reference (its pp trainer
shards the stream over (dcn, dp, fsdp) and never a parameter over fsdp):
each fsdp rank keeps a whole replica of its stage. tp and ep split the
blocks (the Megatron layout of models/transformer.py, the experts of
parallel/moe.py), the embedding and head stay whole on every rank, as
the reference places them; sp rings each stage body's attention
(attention "ring") from positions sp_rank x S/sp.

Checkpoints are keyed by the canonical parameter names, so a checkpoint
resumes under either schedule and any interleave at the same pp, tp and
ep (train/checkpoint.py); another split raises `ReshardRequired`.
remat is not applied to the stage bodies, as in the reference, whose
pipeline applies its blocks outside the Backbone's remat.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..data.synthetic import mesh_share
from ..models.transformer import TransformerConfig, param_shapes
from ..parallel.collectives import allreduce_sum
from ..parallel.mesh import BATCH_AXES, TOKEN_AXES, Mesh, data_parallel_mesh
from ..parallel.pipeline import (StageLM, _moe_layer_split, block_of,
                                 bubble_fraction, gpipe_backward, pp_hop,
                                 run_forward, stage_param_names)
from ..parallel.pipeline_1f1b import rank_layers, run_1f1b, simulate_1f1b
from ..parallel.sharding import ModelLayout, gather_block, local_block
from ..telemetry import TrainTelemetry, span
from ..utils import flops
from ..utils.device import DeviceLike, resolve_device
from .lm_trainer import (_CLASSES, AdamWState, LMTrainerConfig,
                         adamw_update, bench_report, class_weight,
                         flat_layout, flat_slots, flat_views,
                         make_lr_schedule, model_on_views, split_class,
                         step_flops, weighted_sq_norm)

#: the axes whose ranks hold other parts of a pp state
STATE_AXES = ("pp", "ep", "tp")
#: the class of the replicated leaves (replicated over pp, tp and ep),
#: first in the flat buffer, before the block classes of `_CLASSES`
SHARED = "shared"


@dataclasses.dataclass
class PPTrainState:
    """A pp rank's state, updated in place: the flat f32 masters of its
    StageLM (the model's parameters are views of it), the AdamW state
    over the same buffer and the host step counter. `slots` maps each
    parameter name to its (offset, shape) in the buffer, `keys` to its
    checkpoint key (a block's carries the rank's tp and ep coordinates;
    a replicated leaf's is its name), `writes` holds the names this rank
    writes into a checkpoint."""
    params: torch.Tensor
    opt: AdamWState
    model: StageLM
    slots: Dict[str, Tuple[int, tuple]]
    keys: Dict[str, str]
    writes: Tuple[str, ...] = ()
    step: int = 0
    # (this rank's shard over pp x ep x tp, the shard count, whether it
    # writes); a pp state is always saved by shard (train/checkpoint.py)
    shard: Optional[Tuple[int, int, bool]] = None
    layout_key: Optional[dict] = None
    # the mesh's whole group, over which a save agrees on its name
    group: object = None

    def view(self, buf: torch.Tensor, name: str) -> torch.Tensor:
        off, shape = self.slots[name]
        return buf[off:off + math.prod(shape)].view(shape)

    def _named(self, names) -> Dict[str, torch.Tensor]:
        out = {}
        for n in names:
            k = self.keys[n]
            out["params/" + k] = self.view(self.params, n)
            out["mu/" + k] = self.view(self.opt.mu, n)
            out["nu/" + k] = self.view(self.opt.nu, n)
        out["opt.count"] = self.opt.count
        return out

    def checkpoint_payload(self) -> Dict[str, torch.Tensor]:
        """What this rank writes, by DCP key: its parameters' masters,
        mu and nu under their canonical keys (the replicated leaves once
        in the gang, by the rank at pp, tp and ep 0) and the count."""
        return self._named(self.writes)

    def restore_payload(self) -> Dict[str, torch.Tensor]:
        """Every tensor this rank holds, by DCP key: what a restore
        reads, from whichever shard wrote it."""
        return self._named(self.slots)


class PipelineLMTrainer:
    """GPipe or interleaved 1F1B training over the mesh's pp axis, with
    the data axes (dcn, dp, fsdp), tp, sp and ep (module docstring). It
    builds this rank's StageLM from a TransformerConfig and runs on the
    CUDA card unless `device="cpu"`. A step takes this rank's rows of the
    global batch, [M, microbatch / data degree, S / sp] (or the same rows
    flat: `microbatch`), which are its share of EACH microbatch (H32):
    `share` cuts them from a global batch, and the streams of data/
    (TokenStream(..., accum_steps=M, mesh=)) yield them.

    num_microbatches M must divide over pp; pick M >= 4 x pp to keep the
    bubble (P - 1) / (M + P - 1) small."""

    def __init__(self, model_config: TransformerConfig,
                 mesh: Optional[Mesh] = None,
                 config: Optional[LMTrainerConfig] = None,
                 num_microbatches: Optional[int] = None,
                 schedule: str = "gpipe", interleave: int = 1,
                 device: DeviceLike = None):
        cfg = model_config
        self.model_config = cfg
        self.mesh = mesh if mesh is not None else data_parallel_mesh()
        self.config = config or LMTrainerConfig()
        self.device = resolve_device(device)
        if schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"schedule={schedule!r}; expected gpipe|1f1b")
        if interleave < 1:
            raise ValueError(f"interleave={interleave} must be >= 1")
        if interleave > 1 and schedule != "1f1b":
            raise ValueError("interleave>1 requires schedule='1f1b' "
                             "(virtual stages are a 1F1B concept)")
        self.schedule = schedule
        self.interleave = interleave
        self.masked = bool(self.config.masked_lm)
        if self.masked and cfg.causal:
            raise ValueError("masked_lm needs a causal=False (MaskedLM) "
                             "config")
        self.fused_xent = bool(self.config.fused_xent)
        if self.fused_xent and self.masked:
            raise ValueError("fused_xent supports the causal LM only "
                             "(BERT's MLM head has extra layers before "
                             "the tied decoder)")
        if not self.masked and not cfg.causal:
            raise ValueError("a causal=False (bert) config needs "
                             "LMTrainerConfig(masked_lm=True)")
        if cfg.pos_embedding != "learned":
            raise ValueError(
                f"the pipeline trainer supports learned-position models "
                f"only (the stage embed reads the wpe table); got "
                f"pos_embedding={cfg.pos_embedding!r}")
        if cfg.tp_overlap:
            raise ValueError("tp_overlap composes with the flat trainer "
                             "only (the pipeline's stage bodies run tp "
                             "through the all-reduce layout)")
        self.pp = self.mesh.shape["pp"]
        self.num_microbatches = num_microbatches or max(4 * self.pp, self.pp)
        M = self.num_microbatches
        if M % self.pp:
            raise ValueError(f"num_microbatches={M} must divide over "
                             f"pp={self.pp}")
        if cfg.num_layers % (self.pp * self.interleave):
            raise ValueError(
                f"num_layers={cfg.num_layers} must divide over "
                f"pp×interleave={self.pp}×{self.interleave}")
        self.moe = cfg.num_experts > 0
        if self.moe:
            if schedule != "gpipe":
                raise ValueError("MoE composes with schedule='gpipe' only "
                                 "(the 1F1B in-schedule vjp applies dense "
                                 "stage bodies)")
            if cfg.moe_every < 2:
                raise ValueError(
                    f"pp needs moe_every >= 2 (got {cfg.moe_every}); an "
                    f"all-MoE stack has no dense blocks to period over")
            if cfg.num_layers % (cfg.moe_every * self.pp):
                raise ValueError(
                    f"num_layers={cfg.num_layers} must divide over "
                    f"moe_every×pp = {cfg.moe_every}×{self.pp} so every "
                    f"stage owns whole dense+MoE periods")
        B = self.config.global_batch_size
        if B % M:
            raise ValueError(f"global_batch_size={B} must divide into "
                             f"{M} microbatches")
        data_deg = self.mesh.dim_size(BATCH_AXES)
        if (B // M) % data_deg:
            raise ValueError(
                f"microbatch size {B // M} (global {B} / M={M}) must "
                f"divide over the data axes (dcn×dp×fsdp = {data_deg})")
        self.sp = self.mesh.shape["sp"]
        if self.sp > 1:
            if cfg.attention != "ring":
                raise ValueError(
                    'pp×sp needs attention="ring" (build the model with '
                    "create_lm(..., attention=\"ring\") so stage bodies "
                    "ring their K/V shards)")
            if self.config.seq_len % self.sp:
                raise ValueError(f"seq_len={self.config.seq_len} must "
                                 f"divide over sp={self.sp}")
        self.lr_schedule = make_lr_schedule(self.config)
        self.layout = ModelLayout.of(self.mesh, cfg)
        self.rank = self.mesh.index(("pp",))
        self.layers = rank_layers(cfg.num_layers, self.pp, interleave,
                                  self.rank)
        lc = len(self.layers) // interleave
        #: this rank's layers by chunk (virtual stage c P + rank)
        self.chunks = [self.layers[c * lc:(c + 1) * lc]
                       for c in range(interleave)]
        self._sched = (simulate_1f1b(self.pp, M, interleave)
                       if schedule == "1f1b" else None)
        #: (start event, [(tick start, tick end) events], end event) of
        #: the last step when `time_ticks` is set (a card's idle share)
        self.time_ticks = False
        self.last_ticks = None

    @property
    def bubble(self) -> float:
        if self.schedule == "1f1b":
            return self._sched.bubble_fraction
        return bubble_fraction(self.pp, self.num_microbatches)

    # -- the state --------------------------------------------------------

    def _cls(self, name: str):
        """A parameter's class in the flat buffer: SHARED for a replicated
        leaf, else the compute axes (tp, ep) of size > 1 it is split over."""
        if block_of(name) is None:
            return SHARED
        if self.layout is None:
            return ()
        return split_class(self.layout.placements[name], self.mesh)

    def _local_shape(self, name: str) -> tuple:
        if block_of(name) is None or self.layout is None:
            return tuple(param_shapes(self.model_config)[name])
        return tuple(self.layout.placements[name].local_shape)

    def _flat_order(self):
        """[(name, local shape)] in the flat buffer's order and the
        (class, start, end) segments (`flat_layout`): the replicated
        leaves, then the blocks by `_CLASSES`."""
        return flat_layout(
            ((n, self._cls(n), self._local_shape(n))
             for n in stage_param_names(self.model_config, self.layers)),
            (SHARED,) + _CLASSES)

    def init_state(self, seed: int = 0,
                   state_dict: Optional[Dict[str, torch.Tensor]] = None
                   ) -> PPTrainState:
        """A fresh state: parameters from `state_dict` (the whole model's,
        e.g. converted from the reference with params_from_flax or
        params_from_stacked) or drawn from `seed` exactly as init_params
        draws the whole model (the same values on every mesh and under
        either schedule; H6), this rank's layers and its tp and ep blocks
        of them laid flat; zeroed moments, step 0."""
        from ..models.convert import draw_params
        cfg, dev, mesh = self.model_config, self.device, self.mesh
        order, self._segments = self._flat_order()
        self._order = order
        want = dict(order)
        flat = torch.zeros(sum(math.prod(s) for _, s in order),
                           dtype=torch.float32, device=dev)
        slots = flat_slots(order)
        views = flat_views(flat, slots)
        if state_dict is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            items = draw_params(cfg, gen, dev)
        else:
            items = ((k, torch.as_tensor(state_dict[k])) for k in want)
        coords, sizes = mesh.coords(), mesh.shape
        for name, t in items:
            if name not in want:
                continue
            if block_of(name) is not None and self.layout is not None:
                t = local_block(t.to(dev), self.layout.placements[name],
                                coords, sizes)
            views[name].copy_(t.reshape(want[name]))
        model = model_on_views(lambda: StageLM(cfg, self.layers, self.layout),
                               views, None)   # its microbatch rows alone
        keys = {}
        for name, _ in order:
            keys[name] = (name if block_of(name) is None else
                          f"{name}@tp{coords['tp']}.ep{coords['ep']}")
        writes = ()
        if all(coords[a] == 0 for a in TOKEN_AXES):
            first = all(coords[a] == 0 for a in STATE_AXES)
            writes = tuple(nm for nm, _ in order
                           if block_of(nm) is not None or first)
        return PPTrainState(
            params=flat, opt=AdamWState.zeros_like(flat), model=model,
            slots=slots, keys=keys, writes=writes,
            shard=(mesh.index(STATE_AXES), mesh.dim_size(STATE_AXES),
                   bool(writes)),
            layout_key=self.layout_key(), group=mesh.group(mesh.shape))

    def layout_key(self) -> dict:
        """What a pp checkpoint depends on: the pp, tp and ep sizes and
        the model's parameters (not the schedule: a checkpoint is keyed
        by the canonical names)."""
        return {"mesh": {a: self.mesh.shape[a] for a in STATE_AXES},
                "params": [[n, list(s)] for n, s in
                           param_shapes(self.model_config).items()]}

    def canonical_state(self, state: PPTrainState) -> dict:
        """This rank's state in canonical terms: {"step", "count",
        "params", "mu", "nu"}, the last three {name: tensor} in canonical
        (`param_shapes`) layer order, whatever the schedule's layout."""
        names = [n for n in param_shapes(self.model_config)
                 if n in state.slots]
        out = {"step": state.step, "count": int(state.opt.count)}
        for which, buf in (("params", state.params), ("mu", state.opt.mu),
                           ("nu", state.opt.nu)):
            out[which] = {n: state.view(buf, n).clone() for n in names}
        return out

    def from_canonical_state(self, state: PPTrainState,
                             canonical: dict) -> PPTrainState:
        """Copy a canonical state (canonical_state's form, this rank's or
        one holding more names) into this trainer's live state."""
        with torch.no_grad():
            for which, buf in (("params", state.params),
                               ("mu", state.opt.mu), ("nu", state.opt.nu)):
                for n in state.slots:
                    state.view(buf, n).copy_(canonical[which][n])
            state.opt.count.fill_(int(canonical["count"]))
        state.step = int(canonical["step"])
        return state

    def global_flat(self, state: PPTrainState,
                    which: str = "params") -> torch.Tensor:
        """The whole model's flat f32 buffer of `which` ("params", "mu"
        or "nu") in `param_shapes` order: what one process's state holds.
        Collective over the mesh: each block comes from its stage,
        gathered over tp and ep, each replicated leaf from stage 0."""
        buf = {"params": state.params, "mu": state.opt.mu,
               "nu": state.opt.nu}[which]
        out = []
        for name, shape in param_shapes(self.model_config).items():
            if name not in state.slots or (block_of(name) is None
                                           and self.rank != 0):
                out.append(buf.new_zeros(math.prod(shape)))
                continue
            x = state.view(buf, name)
            if block_of(name) is not None and self.layout is not None:
                x = gather_block(x, self.layout.placements[name], self.mesh)
            out.append(x.reshape(-1))
        return allreduce_sum(torch.cat(out), self.mesh, "pp")

    def replicated_digest(self, state: PPTrainState) -> str:
        """A digest of this rank's replicated leaves (masters, mu, nu):
        after every update it is the same on every rank (H30)."""
        cls, a, b = self._segments[0]
        h = hashlib.sha1()
        for buf in (state.params, state.opt.mu, state.opt.nu):
            h.update(buf[a:b].detach().cpu().numpy().tobytes())
        return h.hexdigest()

    # -- the streams ------------------------------------------------------

    def share(self, x):
        """This rank's rows of a global [B, S, ...] batch (a tensor or a
        numpy array): its share of each of the M microbatches of
        consecutive rows, microbatch-major (H32: data rank i of
        microbatch m holds rows m B/M + i B/(M D) onward), and under sp
        its sequence shard."""
        return mesh_share(x, self.mesh, self.num_microbatches)

    def microbatch(self, tokens, targets, mask=None):
        """This rank's flat rows [b, S] as the [M, b / M, S] stream."""
        M = self.num_microbatches
        out = tuple(None if x is None else x.reshape(
            (M, x.shape[0] // M) + tuple(x.shape[1:]))
            for x in (tokens, targets, mask))
        return out if mask is not None else out[:2]

    def _streams(self, tokens, targets, mask):
        if self.masked and mask is None:
            raise ValueError("masked_lm train_step needs the mask stream")
        dev, M = self.device, self.num_microbatches
        out = []
        for x, kind in ((tokens, torch.long), (targets, torch.long),
                        (mask, torch.float32)):
            if x is None:
                out.append(None)
                continue
            x = torch.as_tensor(x, device=dev).to(kind)
            if x.ndim == 2:
                x = x.reshape(M, x.shape[0] // M, x.shape[1])
            out.append(x)
        if not self.masked:
            out[2] = None
        return out

    def _denom(self, mask):
        """The global denominator (H33): B x S, or max(the global mask
        count, 1) summed over the data axes and sp."""
        if mask is None:
            return float(self.config.global_batch_size
                         * self.config.seq_len)
        return torch.clamp(allreduce_sum(mask.sum(), self.mesh, TOKEN_AXES),
                           min=1.0)

    def _hop(self, xs, shift):
        return pp_hop(xs, self.mesh, shift)

    def _timed(self, fn, ticks):
        """fn wrapped in CUDA events (the card's busy time a tick)."""
        def run(*a):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = fn(*a)
            e.record()
            ticks.append((s, e))
            return out
        return run

    # -- the step ---------------------------------------------------------

    def _factor(self) -> int:
        """The data and sp degree: how many shares of each microbatch."""
        return self.mesh.dim_size(TOKEN_AXES)

    def loss_and_grads(self, state: PPTrainState, tokens, targets,
                       mask=None):
        """Run the schedule over one global batch (this rank's rows).
        Returns (loss, f32 gradients of this rank's flat masters, summed
        as the module docstring says, {"moe_aux", "moe_drop_rate"} for a
        MoE config); the loss is the global objective's, the same on
        every rank."""
        cfg, M, P, v = (self.model_config, self.num_microbatches, self.pp,
                        self.interleave)
        toks, tgts, msk = self._streams(tokens, targets, mask)
        denom = self._denom(msk)
        model, dev, VP = state.model, self.device, v * P
        aux_w = self.config.moe_aux_weight / (M * self._factor())
        off = (self.layout.sp_rank * toks.shape[-1]
               if self.layout is not None else 0)
        zero = torch.zeros(toks.shape[1], toks.shape[2], cfg.embed_dim,
                           dtype=cfg.dtype, device=dev)
        acc = torch.zeros(3, dtype=torch.float32, device=dev)
        graphs: Dict[tuple, tuple] = {}

        def forward(k, m, x):
            h = (model.embed(toks[m], off) if k == 0
                 else x.detach().requires_grad_())
            y, aux, drops = model.run(h, self.chunks[k // P])
            terms = []
            if aux:
                a = sum(aux)
                acc[1] += a.detach()
                acc[2] += sum(drops)
                terms.append(a * aux_w)
            keep, out = y, y.detach()
            if k == VP - 1:
                ls, _ = model.head_loss(y, tgts[m],
                                        None if msk is None else msk[m],
                                        self.fused_xent)
                acc[0] += ls.detach()
                terms.append(ls / denom)
                keep = out = None
            graphs[(k, m)] = (None if k == 0 else h, keep, terms)
            return out

        def backward(k, m, g):
            h, y, terms = graphs.pop((k, m))
            ts, gs = ([y], [g]) if y is not None else ([], [])
            if terms:
                ts.append(sum(terms))
                gs.append(None)
            torch.autograd.backward(ts, gs)
            return None if h is None else h.grad

        ticks: List[tuple] = []
        if self.time_ticks:
            forward = self._timed(forward, ticks)
            backward = self._timed(backward, ticks)
        if self._sched is None:
            run_forward(forward, M, P, 1, self.rank, self._hop, lambda: zero)
            gpipe_backward(backward, M, P, self.rank, self._hop,
                           lambda: zero)
        else:
            run_1f1b(self._sched, self.rank, forward, backward, self._hop,
                     lambda: zero)
        self._ticks = ticks
        grads = []
        for name, shape in self._order:
            p = model.get_parameter(name)
            grads.append(p.grad.reshape(-1) if p.grad is not None
                         else torch.zeros(math.prod(shape), device=dev))
            p.grad = None
        grads = torch.cat(grads)
        self._sum_replicated(grads)
        allreduce_sum(grads, self.mesh, TOKEN_AXES, inplace=True)
        acc[0] = acc[0] / denom
        acc = allreduce_sum(acc, self.mesh, ("pp",) + TOKEN_AXES)
        loss = acc[0]
        extra = {}
        if self.moe:
            aux = acc[1] / (M * self._factor())
            loss = loss + self.config.moe_aux_weight * aux
            n_moe = len(_moe_layer_split(cfg.num_layers, cfg.num_experts,
                                         cfg.moe_every)[1])
            extra = {"moe_aux": aux, "moe_drop_rate":
                     acc[2] / (M * n_moe * self._factor())}
        return loss, grads, extra

    def _sum_replicated(self, grads: torch.Tensor) -> None:
        """H30: the replicated leaves' gradients summed over pp, in place
        (wte's is its embedding's on stage 0 plus its tied head's on the
        last stage; a middle stage adds zeros)."""
        cls, a, b = self._segments[0]
        allreduce_sum(grads[a:b], self.mesh, "pp", inplace=True)

    def _norm_weight(self, cls) -> float:
        """A class's weight in the norm's sum over pp x ep x tp: 1 over
        the ranks that hold the same values, so each parameter counts
        once (H34: a replicated leaf over pp x tp x ep; a block over the
        compute axes it is not split over, `class_weight`)."""
        if cls == SHARED:
            return class_weight(self.mesh, ()) / self.pp
        return class_weight(self.mesh, cls)

    def _global_norm(self, grads: torch.Tensor) -> torch.Tensor:
        sq = weighted_sq_norm(grads, self._segments, self._norm_weight)
        return allreduce_sum(sq, self.mesh, STATE_AXES).sqrt().float()

    def _apply(self, state: PPTrainState, grads: torch.Tensor) -> None:
        """One AdamW update of the flat masters, in place (no guard)."""
        g_norm = self._global_norm(grads)
        opt = state.opt
        p, mu, nu = adamw_update(state.params, grads, g_norm, opt,
                                 self.lr_schedule(opt.count), self.config)
        with torch.no_grad():
            state.params.copy_(p)
            opt.mu.copy_(mu)
            opt.nu.copy_(nu)
            opt.count.add_(1)

    def train_step(self, state: PPTrainState, tokens, targets, mask=None
                   ) -> Tuple[PPTrainState, Dict[str, torch.Tensor]]:
        """One step: the schedule, the gradient sums, the AdamW update.
        tokens / targets (+ the float mask when masked): this rank's
        [M, microbatch, S] stream or its flat rows."""
        if self.time_ticks:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        loss, grads, extra = self.loss_and_grads(state, tokens, targets,
                                                 mask)
        self._apply(state, grads)
        if self.time_ticks:
            end.record()
            self.last_ticks = (start, self._ticks, end)
        state.step += 1
        return state, {"loss": loss, **extra}

    # -- evaluation -------------------------------------------------------

    @torch.no_grad()
    def eval_step(self, state: PPTrainState, tokens, targets, mask=None
                  ) -> torch.Tensor:
        """Loss-only pipeline pass: a forward over the trainer's own
        virtual stages in order (`run_forward` with its interleave), no
        MoE aux term (it only shapes gradients)."""
        cfg, M, P, v = (self.model_config, self.num_microbatches, self.pp,
                        self.interleave)
        toks, tgts, msk = self._streams(tokens, targets, mask)
        model = state.model
        off = (self.layout.sp_rank * toks.shape[-1]
               if self.layout is not None else 0)
        zero = torch.zeros(toks.shape[1], toks.shape[2], cfg.embed_dim,
                           dtype=cfg.dtype, device=self.device)
        total = torch.zeros((), dtype=torch.float32, device=self.device)

        def forward(k, m, x):
            nonlocal total
            h = model.embed(toks[m], off) if k == 0 else x
            y, _, _ = model.run(h, self.chunks[k // P])
            if k < v * P - 1:
                return y
            ls, _ = model.head_loss(y, tgts[m],
                                    None if msk is None else msk[m],
                                    self.fused_xent)
            total = total + ls
            return None

        run_forward(forward, M, P, v, self.rank, self._hop, lambda: zero)
        return allreduce_sum(total / self._denom(msk), self.mesh,
                             ("pp",) + TOKEN_AXES)

    def evaluate(self, state: PPTrainState, dataset,
                 num_batches: int = 10) -> Dict[str, float]:
        """Mean held-out loss + perplexity over `num_batches` batches —
        the LMTrainer's contract, the training stream's batch shapes."""
        total = 0.0
        it = iter(dataset)
        for _ in range(num_batches):
            total += float(self.eval_step(state, *next(it)))
        mean = total / max(1, num_batches)
        return {"val_loss": mean, "perplexity": math.exp(min(mean, 30.0))}

    # -- the benchmark ----------------------------------------------------

    def benchmark(self, state: PPTrainState, dataset, num_steps: int = 50,
                  warmup_steps: int = 5, log: Callable[[str], None] = print,
                  step_hook: Optional[Callable] = None, resilience=None,
                  telemetry: Optional[TrainTelemetry] = None,
                  ) -> Tuple[PPTrainState, Dict[str, object]]:
        """The reference's pp benchmark: `warmup_steps` untimed steps,
        then `num_steps` timed as one block ending in one host read of
        the loss. step_hook(state, step) fires after every timed step
        (periodic checkpoints). resilience: the stop check every step
        (an emergency checkpoint, then Preempted) and, in place of an
        in-step guard, the loss read on the host every divergence_k
        steps and rolled back when it is not finite. telemetry: fed the
        run as num_steps observations of the mean step time. Returns the
        reference's keys (tokens_per_sec, tokens_per_sec_per_device,
        final_loss, bubble_fraction, step time and host gap p50/p99,
        flops_per_step, tflops_per_sec_per_device, mfu; moe_drop_rate for
        a MoE config) and `step_losses`. MFU counts the WHOLE model's
        parameters."""
        from .resilience import Preempted
        cfg = self.config
        tel = telemetry if telemetry is not None else TrainTelemetry()
        it = iter(dataset)
        for _ in range(max(1, warmup_steps)):
            state, metrics = self.train_step(state, *next(it))
        float(metrics["loss"])
        base_step = state.step
        tokens_per_step = cfg.global_batch_size * cfg.seq_len
        check_every = (resilience.config.divergence_k
                       if resilience is not None else 0)
        losses = []
        t0 = time.perf_counter()
        for i in range(1, num_steps + 1):
            with span("train.pp_step"):
                state, metrics = self.train_step(state, *next(it))
            losses.append(metrics["loss"])
            if step_hook is not None:
                step_hook(state, base_step + i)
            if check_every and i % check_every == 0 \
                    and not math.isfinite(float(metrics["loss"])):
                log(f"non-finite loss at step {base_step + i}: "
                    f"rolling back")
                state = resilience.rollback(state)
            if resilience is not None and resilience.on_step(base_step + i):
                log(f"preemption drain: stopping the gang at step "
                    f"{base_step + i}")
                resilience.emergency_save(state)
                raise Preempted(base_step + i)
        g0 = time.perf_counter()
        final_loss = float(metrics["loss"])          # the host read barrier
        dt = time.perf_counter() - t0
        tel.host_gap_seconds.observe(time.perf_counter() - g0)
        tps = tokens_per_step * num_steps / dt
        n = self.mesh.size
        stats = flops.throughput_stats(step_flops(cfg, self.model_config),
                                       tps / tokens_per_step, n, self.device)
        tel.observe_steps(dt / num_steps, num_steps)
        tel.update_window(tokens_per_sec=tps, mfu=stats["mfu"],
                          step=base_step + num_steps)
        log(f"pp={self.pp} M={self.num_microbatches} "
            f"schedule={self.schedule}"
            + (f"×{self.interleave}" if self.interleave > 1 else "")
            + f" bubble={self.bubble:.1%}: {tps:.0f} tokens/sec")
        extra = {}
        if "moe_drop_rate" in metrics:
            extra["moe_drop_rate"] = float(metrics["moe_drop_rate"])
        return state, dict(bench_report(tel, tps, n, stats, losses),
                           final_loss=final_loss,
                           bubble_fraction=self.bubble, **extra)


__all__ = ["PPTrainState", "PipelineLMTrainer", "STATE_AXES"]
