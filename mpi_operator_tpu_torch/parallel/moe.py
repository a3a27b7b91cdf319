"""Mixture of experts: the counterpart of
`mpi_operator_tpu/parallel/moe.py::MoeMlp` (Switch/GShard top-k routing
with a capacity budget per expert, or dropless), with its experts over
the `ep` mesh axis and each expert's mlp dim over `tp`.

Routing follows the reference step for step:

- router: an f32 linear with no bias over the f32 tokens, then softmax;
- gating: the top-k experts of each token by probability, ties broken
  by the lower expert index as `jax.lax.top_k` breaks them (a stable
  descending sort: `torch.topk` makes no such promise), the k gates
  renormalised by max(their sum, 1e-9);
- aux loss: Switch's e * sum(top-1 fraction * mean probability);
- capacity: max(1, int(cf * N * k / e)) slots an expert; a (token,
  choice) pair's slot is the count of pairs routed to its expert before
  it, in token-major order over the flattened [N * k] pairs (a token's
  first choice before its second), and a pair whose slot is past the
  budget is dropped (its gate multiplied by 0);
- experts: tanh-gelu FFNs, `w_in [e, E, M]` and `w_out [e, M, E]` in f32
  cast to the compute dtype, no biases;
- combine: the kept gates times the expert outputs, summed in f32.

Dispatch is written in PyTorch's index form instead of the reference's
one-hot einsums. The reference builds [N, e, cap] one-hot dispatch and
combine tensors (168M entries a layer at gpt2-small's 16 x 512 tokens
with 8 experts) and a dispatch GEMM with about the experts' FLOPs. Here
each kept pair's token is copied into its slot of a flat [e * cap + 1,
E] buffer (the last row takes the dropped pairs and is never read), the
experts run as two batched GEMMs over [e, cap, E], and each pair reads
its slot's output back, weighted by its gate in f32, summed over the
token's k choices. Every slot holds one token or zeros, so the values
are the one-hot products' (`moe_ref` keeps the one-hot form as the
plain version the tests compare against). The sum over k is a reduction
over a fixed axis, not an atomic scatter, and the gathers' backward adds
at most one nonzero term into each row (slots are unique; a dropped
pair's gate is 0), so a step repeats bit for bit on the card — which
remat's recompute relies on.

The drop rate (the fraction of pairs over capacity; 0 when dropless) is
kept as `drop_rate` after each forward: a diagnostic the model exposes
(`moe_drop_rates()`), never part of the loss. The aux loss is returned
beside the output, so it flows through the graph the loss is built from
(under remat the checkpointed forward is recomputed, and module state
would hold the recompute's tensor).

Routing in a gang (H14). The reference's jit routes the GLOBAL batch,
so with `mesh` set (the LMTrainer sets every MoeMlp's to its mesh; None
routes this rank's tokens alone) each layer first gathers, over the
ranks that hold other tokens (the data axes and sp, `TOKEN_AXES`),
every rank's per-expert pair counts and top-1 fractions (one all_gather
a layer, `routing`):

- capacity comes from the global token count N x W (every rank holds N);
- a pair's queue position is its position among this rank's pairs plus
  the pairs that lower ranks routed to the same expert, an exclusive
  scan of the ranks' counts: one cumsum over the global rows in rank
  order, as the ranks hold consecutive rows. Under sp a rank holds a
  sequence shard of its rows, and the global order is token-major over
  [B, S]: the ranks gather per-row counts, and a pair's offset is the
  pairs of every earlier global row plus those of its own row in lower
  sp shards, its position counted within its row;
- the drop rate is the global one, from the global counts;
- the aux loss a rank returns is its SHARE of the global loss,
  e * sum(f * mean(probs) / W) with f the global top-1 fraction and
  mean(probs) this rank's: the shares of the W ranks sum to
  e * sum(f * global mean(probs)), and so do their gradients (the
  trainer scales each rank's objective by W and averages the
  gradients). Dropless needs only the aux.

Expert parallelism (`layout` over a mesh with ep and/or tp; the batch
is not sharded over ep, so the ranks of an ep group hold the same rows).
A rank holds E/ep experts (`w_in`, `w_out` and the router's rows of
them), each with its mlp_dim / tp columns: the reference's "expert" ->
ep and "expert_mlp" -> tp rules. Every rank routes all its tokens the
same way (the router's logits all-gathered over ep), runs its experts
on the pairs routed to them, and the partial outputs (f32) are summed
over ep x tp: GSPMD's psum of the reference's combine einsum, whose
dispatch needs no all-to-all when the tokens are replicated over ep.
The tokens and gates enter the per-shard work through `copy_to`, so
the gradients of the replicated router and of x are the whole sums.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .collectives import allgather, copy_to, gather_from, reduce_from
from .mesh import TOKEN_AXES


def route(probs: torch.Tensor, k: int):
    """(gate values [N, k], expert ids [N, k]) of the top-k experts by
    probability, lower index first among equals (`lax.top_k`'s order),
    the gates renormalised by max(sum, 1e-9)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    return vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9), idx


def aux_loss(probs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Switch's load-balancing loss: e * sum(top-1 fraction * mean
    probability) over the experts."""
    e = probs.shape[-1]
    top1 = F.one_hot(idx[:, 0], e).float().mean(0)
    return e * torch.sum(top1 * probs.mean(0))


def capacity(n_tokens: int, k: int, e: int, factor: float) -> int:
    return max(1, int(factor * n_tokens * k / e))


def slots(idx: torch.Tensor, e: int, cap: int,
          offset: Optional[torch.Tensor] = None, rows: int = 1):
    """(slot [N, k] int64, keep [N, k] bool): each (token, choice) pair's
    position in its expert's queue, counting every earlier pair routed to
    that expert in token-major order (plus `offset`: [e], the pairs lower
    ranks routed there; or with `rows` > 1, [rows, e] a row's, the count
    then running within each of the `rows` rows of the N tokens), and
    whether it is under `cap`."""
    # expert-major [.., e, N*k], so the running count scans the inner dim
    # (a scan over the outer dim of [N*k, e] is one slow kernel on the
    # card)
    onehot = F.one_hot(idx.reshape(rows, -1), e).transpose(1, 2).contiguous()
    pos = (torch.cumsum(onehot, 2) * onehot).sum(1) - 1       # [rows, .]
    if offset is not None:
        off = offset if rows > 1 else offset[None]
        pos = pos + off.gather(1, idx.reshape(rows, -1))
    pos = pos.reshape(idx.shape)
    return pos, pos < cap


def routing(idx: torch.Tensor, e: int, mesh=None, rows: int = 1):
    """(offset, total [e] int64, top-1 fraction [e] f32, W): the pairs
    lower ranks routed to each expert ([e]; with sp > 1, [rows, e], the
    pairs before each of this rank's `rows` rows in the global
    token-major order, `slots`), the pairs every rank routed there, the
    fraction of the global tokens whose first choice it is, and the
    number W of ranks holding other tokens (TOKEN_AXES). Without a mesh
    (or without such ranks) this rank's tokens alone: W 1, and no offset
    or total."""
    frac = F.one_hot(idx[:, 0], e).float().mean(0)
    if mesh is None or mesh.group(TOKEN_AXES) is None:
        return None, None, frac, 1
    W, r = mesh.dim_size(TOKEN_AXES), mesh.index(TOKEN_AXES)
    sp = mesh.shape["sp"]
    per_row = F.one_hot(idx.reshape(rows, -1), e).sum(1)      # [rows, e]
    mine = per_row if sp > 1 else per_row.sum(0, keepdim=True)
    # f64 holds the integer counts and the f32 fractions exactly
    every = allgather(torch.cat([mine.reshape(-1).double(), frac.double()]),
                      mesh, TOKEN_AXES, tiled=False)          # [W, . + e]
    counts = every[:, :-e].reshape(W, -1, e).long()
    total = counts.sum((0, 1))
    frac = (every[:, -e:].sum(0) / W).float()
    if sp == 1:
        return counts[:r, 0].sum(0), total, frac, W
    # [P, sp, rows, e] -> the global rows [P * rows, sp, e]
    grid = counts.view(W // sp, sp, rows, e).transpose(1, 2).reshape(
        -1, sp, e)
    row_tot = grid.sum(1)
    before = torch.cumsum(row_tot, 0) - row_tot               # [B, e]
    within = torch.cumsum(grid, 1) - grid                     # [B, sp, e]
    p, q = r // sp, r % sp
    mine = slice(p * rows, (p + 1) * rows)
    return before[mine] + within[mine, q], total, frac, W


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class MoeMlp(nn.Module):
    """Drop-in FFN over [B, S, E]: returns (out [B, S, E] in x's dtype,
    aux loss f32 scalar). Over a `layout` with ep or tp the rank holds
    its experts' blocks (see the module docstring)."""

    def __init__(self, num_experts: int, embed_dim: int, mlp_dim: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dropless: bool = False,
                 dtype: torch.dtype = torch.bfloat16, layout=None):
        super().__init__()
        self.num_experts = num_experts
        self.top_k = min(top_k, num_experts)
        self.capacity_factor = capacity_factor
        self.dropless = dropless
        self.dtype = dtype
        self.layout = layout
        ep = layout is not None and layout.ep_split("moe.w_in")
        tp = layout is not None and layout.tp_split("moe.w_in")
        # the axes this layer's expert outputs are partial sums over
        self.dims = tuple(a for a, on in (("ep", ep), ("tp", tp)) if on)
        el = num_experts // layout.ep if ep else num_experts
        ml = mlp_dim // layout.tp if tp else mlp_dim
        self.first = layout.ep_rank * el if ep else 0   # first local expert
        self.router = nn.Linear(embed_dim, el, bias=False)
        self.w_in = nn.Parameter(torch.empty(el, embed_dim, ml))
        self.w_out = nn.Parameter(torch.empty(el, ml, embed_dim))
        self.drop_rate = None
        # the mesh whose global batch this layer routes (parallel/mesh.py);
        # None routes this rank's tokens alone
        self.mesh = None

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, S, E = x.shape
        N, e, k, dt = B * S, self.num_experts, self.top_k, self.dtype
        tokens = x.reshape(N, E)
        mesh = self.layout.mesh if self.layout is not None else None
        ep = "ep" in self.dims
        logits = torch.matmul(
            copy_to(tokens.float(), mesh, "ep") if ep else tokens.float(),
            self.router.weight.float().t())
        if ep:
            logits = gather_from(logits, mesh, "ep", -1)
        probs = torch.softmax(logits, -1)
        gates, idx = route(probs, k)
        sp = self.mesh.shape["sp"] if self.mesh is not None else 1
        offset, total, frac, W = routing(idx, e, self.mesh,
                                         rows=B if sp > 1 else 1)
        aux = e * torch.sum(frac * (probs.mean(0) / W))
        if self.dims:
            tokens = copy_to(tokens, mesh, self.dims)
            gates = copy_to(gates, mesh, self.dims)
        w_in, w_out = self.w_in.to(dt), self.w_out.to(dt)
        el, e0 = w_in.shape[0], self.first
        if self.dropless:
            full = torch.zeros(N, e, dtype=torch.float32, device=x.device)
            full = full.scatter(1, idx, gates).to(dt)[:, e0:e0 + el]
            h = _gelu(torch.matmul(tokens.to(dt)[None], w_in))  # [el, N, M]
            y = torch.matmul(h.float(), w_out.float())           # [el, N, E]
            out = (y * full.float().t()[:, :, None]).sum(0)
            self.drop_rate = torch.zeros((), device=x.device)
            out = reduce_from(out, mesh, self.dims) if self.dims else out
            return out.reshape(B, S, E).to(x.dtype), aux
        cap = capacity(N * W, k, e, self.capacity_factor)
        pos, keep = slots(idx, e, cap, offset, rows=B if sp > 1 else 1)
        self.drop_rate = (1.0 - (keep.float().mean() if W == 1 else
                                 torch.clamp(total, max=cap).sum()
                                 / (N * W * k))).detach()
        gates = gates * keep
        # each pair's row in the flat [el * cap + 1, E] slot buffer of
        # this rank's experts; the dropped pairs and those of other
        # ranks' experts all land on the last row, which nothing reads
        mine = keep & (idx >= e0) & (idx < e0 + el)
        dest = torch.where(mine, (idx - e0) * cap + pos, el * cap).reshape(-1)
        src = tokens.to(dt).repeat_interleave(k, dim=0)           # [N*k, E]
        buf = torch.zeros(el * cap + 1, E, dtype=dt, device=x.device)
        expert_in = buf.index_copy(0, dest, src)[:-1].view(el, cap, E)
        h = _gelu(torch.bmm(expert_in, w_in))
        y = torch.bmm(h, w_out).reshape(el * cap, E)
        y = torch.cat([y, y.new_zeros(1, E)])                     # trash row
        picked = y.index_select(0, dest).float().view(N, k, E)
        out = (picked * gates[..., None]).sum(1)
        out = reduce_from(out, mesh, self.dims) if self.dims else out
        return out.reshape(B, S, E).to(x.dtype), aux


def moe_ref(x, router_w, w_in, w_out, top_k: int = 2,
            capacity_factor: float = 1.25, dtype=torch.bfloat16):
    """The plain version: the reference's one-hot dispatch and combine
    einsums, [N, e, cap] tensors and all (capacity mode). Returns (out,
    aux, drop rate)."""
    B, S, E = x.shape
    e = router_w.shape[0]
    N, k = B * S, min(top_k, e)
    tokens = x.reshape(N, E)
    probs = torch.softmax(tokens.float() @ router_w.float().t(), -1)
    gates, idx = route(probs, k)
    aux = aux_loss(probs, idx)
    cap = capacity(N, k, e, capacity_factor)
    pos, keep = slots(idx, e, cap)
    gates = gates * keep
    slot = F.one_hot(torch.where(keep, pos, cap), cap + 1)[..., :cap]
    expert = F.one_hot(idx, e)                                # [N, k, e]
    dispatch = (expert[..., None] * slot[:, :, None, :]).sum(1).to(dtype)
    combine = (gates[..., None, None] * expert[..., None].float()
               * slot[:, :, None, :].float()).sum(1)          # [N, e, cap]
    expert_in = torch.einsum("nd,nec->ecd", tokens.to(dtype), dispatch)
    h = _gelu(torch.einsum("ecd,edm->ecm", expert_in, w_in.to(dtype)))
    y = torch.einsum("ecm,emd->ecd", h, w_out.to(dtype))
    out = torch.einsum("ecd,nec->nd", y.float(), combine)
    return (out.reshape(B, S, E).to(x.dtype), aux,
            1.0 - keep.float().mean())


__all__ = ["MoeMlp", "aux_loss", "capacity", "moe_ref", "route", "routing",
           "slots"]
