"""Mixture of experts on one device: the counterpart of
`mpi_operator_tpu/parallel/moe.py::MoeMlp` (Switch/GShard top-k routing
with a capacity budget per expert, or dropless), without the `ep` mesh
axis (expert parallelism is a later slice).

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
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


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


def slots(idx: torch.Tensor, e: int, cap: int):
    """(slot [N, k] int64, keep [N, k] bool): each (token, choice) pair's
    position in its expert's queue, counting every earlier pair routed to
    that expert in token-major order, and whether it is under `cap`."""
    # expert-major [e, N*k], so the running count scans the inner dim (a
    # scan over the outer dim of [N*k, e] is one slow kernel on the card)
    onehot = F.one_hot(idx.reshape(-1), e).t().contiguous()
    pos = (torch.cumsum(onehot, 1) * onehot).sum(0) - 1
    pos = pos.reshape(idx.shape)
    return pos, pos < cap


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class MoeMlp(nn.Module):
    """Drop-in FFN over [B, S, E]: returns (out [B, S, E] in x's dtype,
    aux loss f32 scalar)."""

    def __init__(self, num_experts: int, embed_dim: int, mlp_dim: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dropless: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_experts = num_experts
        self.top_k = min(top_k, num_experts)
        self.capacity_factor = capacity_factor
        self.dropless = dropless
        self.dtype = dtype
        self.router = nn.Linear(embed_dim, num_experts, bias=False)
        self.w_in = nn.Parameter(torch.empty(num_experts, embed_dim,
                                             mlp_dim))
        self.w_out = nn.Parameter(torch.empty(num_experts, mlp_dim,
                                              embed_dim))
        self.drop_rate = None

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, S, E = x.shape
        N, e, k, dt = B * S, self.num_experts, self.top_k, self.dtype
        tokens = x.reshape(N, E)
        probs = torch.softmax(
            torch.matmul(tokens.float(), self.router.weight.float().t()), -1)
        gates, idx = route(probs, k)
        aux = aux_loss(probs, idx)
        w_in, w_out = self.w_in.to(dt), self.w_out.to(dt)
        if self.dropless:
            full = torch.zeros(N, e, dtype=torch.float32, device=x.device)
            full = full.scatter(1, idx, gates).to(dt)            # [N, e]
            h = _gelu(torch.matmul(tokens.to(dt)[None], w_in))  # [e, N, M]
            y = torch.matmul(h.float(), w_out.float())           # [e, N, E]
            out = (y * full.float().t()[:, :, None]).sum(0)
            self.drop_rate = torch.zeros((), device=x.device)
            return out.reshape(B, S, E).to(x.dtype), aux
        cap = capacity(N, k, e, self.capacity_factor)
        pos, keep = slots(idx, e, cap)
        self.drop_rate = (1.0 - keep.float().mean()).detach()
        gates = gates * keep
        # each pair's row in the flat [e * cap + 1, E] slot buffer; the
        # dropped pairs all land on the last row, which nothing reads
        dest = torch.where(keep, idx * cap + pos, e * cap).reshape(-1)
        src = tokens.to(dt).repeat_interleave(k, dim=0)           # [N*k, E]
        buf = torch.zeros(e * cap + 1, E, dtype=dt, device=x.device)
        expert_in = buf.index_copy(0, dest, src)[:-1].view(e, cap, E)
        h = _gelu(torch.bmm(expert_in, w_in))
        y = torch.bmm(h, w_out).reshape(e * cap, E)
        y = torch.cat([y, y.new_zeros(1, E)])                     # trash row
        picked = y.index_select(0, dest).float().view(N, k, E)
        out = (picked * gates[..., None]).sum(1)
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


__all__ = ["MoeMlp", "aux_loss", "capacity", "moe_ref", "route", "slots"]
