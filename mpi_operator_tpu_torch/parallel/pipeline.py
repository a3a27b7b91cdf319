"""Pipeline parallelism over the `pp` mesh axis: the counterpart of
`mpi_operator_tpu/parallel/pipeline.py` (GPipe, the stage embed and head
functions, the MoE layer split) for a gang of processes.

The reference stacks the blocks' parameters on a leading layer dim
sharded over pp and runs the whole schedule inside one `shard_map` as a
`lax.scan` over ticks: relay registers carry the token stream to stage
0, `lax.cond` picks the last stage's head, autodiff through `ppermute`
gives the backward, and GSPMD inserts tp and ep inside each tick. Here a
stage is a process that holds its own layers:

- `StageLM` is one rank's part of the model: its blocks under their
  GLOBAL state-dict names (`backbone.blocks.{i}....`, as the whole
  model's), so the converted flax weights, the draw from a seed and a
  checkpoint all work by name; and the replicated leaves (wte, wpe,
  ln_f; for BERT also ln_emb, wtte and the MLM head), held by every
  stage as in the reference (a middle stage holds them unused).
- The stage functions, one definition each for both schedules:
  `lm_stage_embed`, `lm_stage_head_loss` (with `fused`, through the
  port's `fused_lm_loss`), `lm_stage_mlm_embed` and
  `lm_stage_mlm_head_loss`.
- A hop is `collectives.ring_hop` over the mesh's pp group. Every rank
  of the group joins every hop of every tick, idle or not (H31): over
  gloo on CUDA tensors a hop is an all-to-all, and a rank that skipped
  one would hang the gang. Forward hops and backward hops take message
  tags of their own, above the sp ring's, so a stage body's ring
  attention and the pipeline's hops never match each other's messages.
- The backward is written out (`gpipe_backward`, and the 1F1B device
  half in parallel/pipeline_1f1b.py): a forward tick keeps its
  microbatch's graph, with the arriving activation as a detached leaf;
  a backward tick runs `torch.autograd.backward` on that graph from the
  cotangent that arrived and sends the leaf's gradient back. Autograd
  never runs through a hop: a rank whose graph skipped a hop would
  leave it out of its backward and hang the ring (H28).
- No relay registers: every pp rank with the same data coordinates is
  given the same rows (parallel/mesh.py: pp is not a batch axis); stage
  0 reads the tokens, the last stage the targets and the mask.

GPipe: M + P - 1 forward ticks (`run_forward`, stage p runs microbatch
t - p at tick t), then M + P - 1 backward ticks (`gpipe_backward`, the
last stage first, microbatches in reverse). The idle fraction is
(P - 1) / (M + P - 1) (`bubble_fraction`); callers pick M >= 4 P.
`run_forward` also runs a forward-only pass over interleaved virtual
stages (the 1F1B trainer's evaluation): virtual stage k = c P + d runs
on rank d as chunk c, microbatch t - k at tick t, and one hop a chunk
carries each tick's outputs on (rank P - 1's chunk c feeds rank 0's
chunk c + 1).

`pipeline_apply` is the reference's generic GPipe over a stage function,
as a `torch.autograd.Function` whose backward is the written-out
backward pipeline.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..models.transformer import (Block, Norm, TiedHead, TransformerConfig,
                                  _linear, uses_moe)
from .collectives import broadcast, ring_hop

#: message tags of the pp hops: forward hops from PP_TAG, backward hops
#: from PP_TAG + _BACK_TAG (a hop of n tensors takes n tags); the sp
#: ring's hops use tags below 32
PP_TAG = 32
_BACK_TAG = 16
#: the prefix of the block parameters' state-dict names
BLOCKS = "backbone.blocks."


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """Idle fraction of the GPipe schedule: (P-1)/(M+P-1)."""
    return (num_stages - 1) / (num_microbatches + num_stages - 1)


def _moe_layer_split(num_layers: int, num_experts: int, moe_every: int):
    """(dense_idx, moe_idx) layer-index lists for a MoE config: the same
    alternation the Backbone builds (block i is MoE when i % moe_every
    == moe_every - 1). Empty moe_idx for dense models."""
    if not num_experts:
        return list(range(num_layers)), []
    moe_idx = [i for i in range(num_layers)
               if i % moe_every == moe_every - 1]
    dense_idx = [i for i in range(num_layers) if i not in set(moe_idx)]
    return dense_idx, moe_idx


def block_of(name: str) -> Optional[int]:
    """The layer a state-dict name belongs to, or None for a replicated
    leaf (embeddings, norms and heads outside the blocks)."""
    if not name.startswith(BLOCKS):
        return None
    return int(name[len(BLOCKS):].split(".", 1)[0])


# ---------------------------------------------------------------------------
# the stage model and the stage functions
# ---------------------------------------------------------------------------

class StageLM(nn.Module):
    """One pp rank's part of a CausalLM (or MaskedLM for a bidirectional
    config): the blocks of `layers`, named as in the whole model, and
    every replicated leaf. Over a `layout` (tp, ep, sp) the blocks hold
    this rank's Megatron and expert blocks, as the whole model's do; the
    replicated leaves stay whole on every rank (the reference places
    every leaf outside the stacked blocks replicated, so the embedding
    and the head are not vocab-parallel under pp)."""

    def __init__(self, cfg: TransformerConfig, layers: Sequence[int],
                 layout=None):
        super().__init__()
        self.config = cfg
        self.layout = layout
        self.layers = tuple(layers)
        E = cfg.embed_dim
        self.wte = nn.Embedding(cfg.vocab_size, E)
        self.wpe = nn.Embedding(cfg.max_len, E)
        self.wtte = (nn.Embedding(2, E)
                     if not cfg.causal and cfg.use_token_types else None)
        self.ln_emb = Norm(cfg) if not cfg.causal else None
        self.backbone = nn.Module()
        self.backbone.blocks = nn.ModuleDict(
            {str(i): Block(cfg, use_moe=uses_moe(cfg, i), layout=layout)
             for i in self.layers})
        self.backbone.ln_f = Norm(cfg)
        if not cfg.causal:
            self.mlm_dense = nn.Linear(E, E)
            self.mlm_ln = Norm(cfg)
            self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def run(self, h: torch.Tensor, layers: Sequence[int]):
        """The blocks of `layers` in order over h: (h, [aux losses of the
        MoE blocks], [their drop rates])."""
        aux, drops = [], []
        for i in layers:
            block = self.backbone.blocks[str(i)]
            h, a = block(h, None, None, None, None, None)
            if a is not None:
                aux.append(a)
                drops.append(block.moe.drop_rate)
        return h, aux, drops

    def embed(self, tokens: torch.Tensor, pos_offset: int = 0):
        """Stage 0's input embedding (the causal or the masked one)."""
        if self.config.causal:
            return lm_stage_embed(self.config, self.wte.weight,
                                  self.wpe.weight, tokens, pos_offset)
        return lm_stage_mlm_embed(self.config, self, tokens, pos_offset)

    def head_loss(self, y, targets, mask=None, fused: bool = False):
        """The last stage's (summed loss, scored-token count)."""
        if self.config.causal:
            loss = lm_stage_head_loss(self.config, self.backbone.ln_f,
                                      self.wte.weight, y, targets, fused)
            return loss, None
        return lm_stage_mlm_head_loss(self.config, self, y, targets, mask)


def stage_param_names(cfg: TransformerConfig, layers: Sequence[int]
                      ) -> List[str]:
    """The state-dict names a StageLM over `layers` holds, in
    `param_shapes` order."""
    from ..models.transformer import param_shapes
    keep = set(layers)
    return [n for n in param_shapes(cfg)
            if block_of(n) is None or block_of(n) in keep]


def lm_stage_embed(cfg: TransformerConfig, wte: torch.Tensor,
                   wpe: torch.Tensor, toks: torch.Tensor,
                   pos_offset: int = 0) -> torch.Tensor:
    """Stage 0's input embedding, shared by the GPipe and 1F1B schedules:
    the token rows plus the positions of this sequence shard, from
    `pos_offset` (sp_rank x S under pp x sp, H29), in the model dtype."""
    S = toks.shape[-1]
    if pos_offset + S > cfg.max_len:
        raise ValueError(f"sequence of {pos_offset + S} tokens is longer "
                         f"than max_len={cfg.max_len} (the wpe table)")
    dt = cfg.dtype
    return F.embedding(toks, wte.to(dt)) + wpe[pos_offset:pos_offset + S
                                               ].to(dt)


def lm_stage_head_loss(cfg: TransformerConfig, ln_f: nn.Module,
                       wte: torch.Tensor, y: torch.Tensor,
                       tgt: torch.Tensor, fused: bool = False
                       ) -> torch.Tensor:
    """The last stage's ln_f, tied head and SUMMED token cross-entropy,
    shared by both schedules. fused=True runs the chunked tied-head xent
    (train/lm_trainer.py `fused_lm_loss` with denom 1, the sum): the
    [mb S, vocab] logits never exist on the last stage."""
    h = ln_f(y)
    if fused:
        from ..train.lm_trainer import fused_lm_loss
        return fused_lm_loss(h, wte, tgt, denom=1.0)
    logits = TiedHead.apply(h, wte.to(cfg.dtype))
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tgt.reshape(-1).long(), reduction="sum")


def lm_stage_mlm_embed(cfg: TransformerConfig, stage: StageLM,
                       toks: torch.Tensor, pos_offset: int = 0
                       ) -> torch.Tensor:
    """Stage 0's MaskedLM (BERT) embedding: token + position (+ the
    type-0 row when the config uses token types) through ln_emb."""
    h = lm_stage_embed(cfg, stage.wte.weight, stage.wpe.weight, toks,
                       pos_offset)
    if stage.wtte is not None:
        # the benchmark's contract: no token types, all type 0
        h = h + stage.wtte.weight[0].to(cfg.dtype)
    return stage.ln_emb(h)


def lm_stage_mlm_head_loss(cfg: TransformerConfig, stage: StageLM,
                           y: torch.Tensor, tgt: torch.Tensor,
                           msk: torch.Tensor):
    """The last stage's MLM transform head (ln_f, dense, gelu, LN, the
    tied decoder plus the vocab bias) and masked cross-entropy: (the
    masked xent SUM, the mask count); the schedules divide by the
    global count."""
    dt = cfg.dtype
    h = stage.backbone.ln_f(y)
    h = F.gelu(_linear(h, stage.mlm_dense, dt), approximate="tanh")
    logits = TiedHead.apply(stage.mlm_ln(h), stage.wte.weight.to(dt)) \
        + stage.mlm_bias.float()
    xent = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tgt.reshape(-1).long(), reduction="none")
    msk = msk.reshape(-1).float()
    return (xent * msk).sum(), msk.sum()


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------

def pp_hop(tensors: Sequence[torch.Tensor], mesh, shift: int
           ) -> List[torch.Tensor]:
    """One hop of the pp ring: each tensor to the rank `shift` places on,
    the rank `shift` places back's arriving. Forward and backward hops
    take their own tags."""
    tag = PP_TAG if shift > 0 else PP_TAG + _BACK_TAG
    return ring_hop(list(tensors), mesh, "pp", shift, tag).wait()


def run_forward(forward: Callable, num_microbatches: int, num_stages: int,
                interleave: int, rank: int, hop: Callable,
                zeros: Callable[[], torch.Tensor]) -> None:
    """The forward ticks on pp rank `rank`: virtual stage k = c P + rank
    (chunk c of `interleave`) runs microbatch t - k at tick t;
    forward(k, m, x) returns the activation to send on (None at the last
    virtual stage), x None for k = 0 (it embeds). Each tick ends in one
    hop of `interleave` tensors (zeros where a chunk was idle), which
    every rank joins; rank 0's chunk c + 1 takes rank P - 1's chunk c."""
    M, P, v = num_microbatches, num_stages, interleave
    acts: List[Optional[torch.Tensor]] = [None] * v
    for t in range(M + v * P - 1):
        outs = []
        for c in range(v):
            k = c * P + rank
            m = t - k
            y = forward(k, m, acts[c]) if 0 <= m < M else None
            outs.append(zeros() if y is None else y)
        got = hop(outs, 1)
        acts = [None] + list(got[:-1]) if rank == 0 else list(got)


def gpipe_backward(backward: Callable, num_microbatches: int,
                   num_stages: int, rank: int, hop: Callable,
                   zeros: Callable[[], torch.Tensor]) -> None:
    """GPipe's backward ticks on pp rank `rank`: the last stage first,
    microbatches in reverse; stage p runs microbatch M - 1 - (t - (P - 1
    - p)) at tick t. backward(k, m, g) returns the cotangent of the
    stage's input (None on stage 0); each tick ends in one backward hop
    that every rank joins."""
    M, P = num_microbatches, num_stages
    g = None
    for t in range(M + P - 1):
        m = M - 1 - (t - (P - 1 - rank))
        dx = backward(rank, m, g) if 0 <= m < M else None
        g, = hop([zeros() if dx is None else dx], -1)


# ---------------------------------------------------------------------------
# the generic pipeline
# ---------------------------------------------------------------------------

class _PipelineApply(torch.autograd.Function):
    """pipeline_apply's forward (GPipe's forward ticks, each stage keeping
    its microbatches' graphs) and backward (the backward ticks, written
    out)."""

    @staticmethod
    def forward(ctx, stage_fn, mesh, M, names, x, *params):
        P, d = mesh.shape["pp"], mesh.index(("pp",))
        leaves = [p.detach().requires_grad_(p.requires_grad)
                  for p in params]
        tree = dict(zip(names, leaves))
        graphs: Dict[int, tuple] = {}
        outs: List[Optional[torch.Tensor]] = [None] * M
        zero = torch.zeros_like(x[0])

        def fwd(k, m, inp):
            inp = (x[m] if k == 0 else inp).detach().requires_grad_()
            with torch.enable_grad():
                y = stage_fn(tree, inp)
            graphs[m] = (inp, y)
            if k == P - 1:
                outs[m] = y.detach()
                return None
            return y.detach()

        run_forward(fwd, M, P, 1, d, lambda xs, s: pp_hop(xs, mesh, s),
                    lambda: zero)
        out = (torch.stack(outs) if d == P - 1
               else torch.zeros_like(x))
        ctx.graphs, ctx.leaves, ctx.mesh, ctx.M = graphs, leaves, mesh, M
        return broadcast(out, mesh, "pp", root=P - 1)

    @staticmethod
    def backward(ctx, g_out):
        mesh, M, leaves = ctx.mesh, ctx.M, ctx.leaves
        P, d = mesh.shape["pp"], mesh.index(("pp",))
        grads = [torch.zeros_like(p) for p in leaves]
        dxs: List[Optional[torch.Tensor]] = [None] * M
        zero = torch.zeros_like(g_out[0])
        want = [p for p in leaves if p.requires_grad]

        def bwd(k, m, g):
            inp, y = ctx.graphs.pop(m)
            got = torch.autograd.grad(
                y, [inp] + want, g_out[m] if k == P - 1 else g,
                allow_unused=True)
            it = iter(got[1:])
            for i, p in enumerate(leaves):
                if p.requires_grad:
                    gp = next(it)
                    if gp is not None:
                        grads[i] += gp
            if k == 0:
                dxs[m] = got[0]
                return None
            return got[0]

        gpipe_backward(bwd, M, P, d, lambda xs, s: pp_hop(xs, mesh, s),
                       lambda: zero)
        dx = (torch.stack(dxs) if d == 0 else torch.zeros_like(g_out))
        dx = broadcast(dx, mesh, "pp", root=0)
        return (None, None, None, None, dx) + tuple(grads)


def pipeline_apply(stage_fn: Callable, stage_params: Dict[str, torch.Tensor],
                   x: torch.Tensor, mesh, num_microbatches: int
                   ) -> torch.Tensor:
    """Run a GPipe pipeline over `mesh`'s pp axis (the reference's
    `pipeline_apply`): stage_fn(params, x_mb) -> y_mb is one stage's
    computation over THIS rank's `stage_params` (a {name: tensor} dict);
    x is the [M, microbatch, ...] stream, the same on every pp rank (the
    reference shards it over pp; here only stage 0 reads it). Returns
    the last stage's [M, microbatch, ...] outputs on every pp rank.
    Differentiable: the backward pipeline is written out, and each
    rank's parameters get their own stage's gradients, x the gradient
    through stage 0 (the output's cotangent is read on the last stage)."""
    n_stages = mesh.shape["pp"]
    if num_microbatches % n_stages:
        raise ValueError(
            f"num_microbatches={num_microbatches} must divide evenly over "
            f"pp={n_stages}")
    if x.shape[0] != num_microbatches:
        raise ValueError(f"x has {x.shape[0]} microbatches, expected "
                         f"{num_microbatches}")
    names = list(stage_params)
    return _PipelineApply.apply(stage_fn, mesh, num_microbatches, names, x,
                                *(stage_params[n] for n in names))


__all__ = ["BLOCKS", "PP_TAG", "StageLM", "block_of", "bubble_fraction",
           "gpipe_backward", "lm_stage_embed", "lm_stage_head_loss",
           "lm_stage_mlm_embed", "lm_stage_mlm_head_loss", "pipeline_apply",
           "pp_hop", "run_forward", "stage_param_names"]
