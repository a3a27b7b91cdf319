"""Logical-axis sharding rules: how the LMs' parameters map onto the
mesh. The counterpart of `mpi_operator_tpu/parallel/sharding.py`
without flax.

The reference annotates each parameter with logical axis names
(`"embed"`, `"heads"`, `"mlp"`, ...) through flax's
`with_logical_partitioning`, and one rule table maps them to mesh axes;
GSPMD then lays the parameters out and inserts the collectives. Here the
per-parameter logical axes are a table beside `param_shapes`
(`models/transformer.py` `param_axes`: each port parameter's flax path,
its logical axes and shape in the reference's layout, and how the
reference's dims fold into the port's), the same rules map them to
`PartitionSpec`s, and `param_shardings` turns those into `Placement`s:
which dims of the port's tensor a rank holds a block of.

What a placement means to the port:

- a dim over `tp` (heads, mlp, vocab, expert_mlp) or `ep` (expert) is
  split: a rank holds its block, and the model's layers compute on it
  (Megatron tensor parallelism, expert parallelism);
- `fsdp` shards storage only, as in the reference: the trainer keeps
  1/fsdp of its flat f32 buffer of masters and moments on each rank
  (train/lm_trainer.py), whatever the dims' specs say, so a placement's
  local shape ignores it;
- a dim that does not divide over its mesh axes replicates
  (`_divisible_spec`), as in the reference: 4 heads on tp = 8, or a
  vocab that tp x fsdp does not divide.

A spec is a tuple, one entry a dim: None (replicated), an axis name, or
a tuple of axis names.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from .collectives import allgather

# logical name -> mesh axis (or None = replicate). A name absent from the
# table replicates. Tuple values shard one dim over several mesh axes.
DEFAULT_RULES: Tuple[Tuple[str, Any], ...] = (
    ("batch", ("dcn", "dp", "fsdp")),
    ("seq", "sp"),
    ("embed", "fsdp"),
    ("mlp", "tp"),
    ("heads", "tp"),
    ("kv", None),
    # vocab shards over tp AND fsdp: embedding-table storage scales with
    # both degrees while the embed dim stays replicated. Needs vocab
    # divisible by tp*fsdp: model configs pad vocab to a multiple of 128
    ("vocab", ("tp", "fsdp")),
    ("expert", "ep"),
    ("expert_mlp", "tp"),
    ("layers", "pp"),
    ("norm", None),
    # the decode KV-cache length axis, replicated
    ("cache", None),
)

# the residual stream's layout: batch over the data axes, sequence over
# sp, embed replicated (fsdp shards parameter storage, never the stream);
# tp shards only the inner heads/mlp dims; "seq_tp" is the sequence over
# tp inside the ring collective-matmuls (tp_overlap)
ACTIVATION_RULES: Tuple[Tuple[str, Any], ...] = (
    ("batch", ("dcn", "dp", "fsdp")),
    ("seq", "sp"),
    ("embed", None),
    ("heads", "tp"),
    ("kv", None),
    ("mlp", "tp"),
    ("vocab", "tp"),
    ("cache", None),
    ("seq_tp", "tp"),
)

#: the axes a placement can split a port parameter over (the others,
#: fsdp included, leave each rank the whole dim)
COMPUTE_AXES = ("tp", "ep")


def tp_overlap_activation_spec(rank: int = 3) -> tuple:
    """The spec of an activation at a ring collective-matmul boundary:
    [batch, seq, ...] with batch over the data axes and SEQ over tp."""
    return (("dcn", "dp", "fsdp"), "tp") + (None,) * (rank - 2)


def tp_manual_spec(logical_axes: Sequence[Optional[str]],
                   rules=DEFAULT_RULES) -> tuple:
    """The spec of a parameter inside the tp-overlap region: dims whose
    rule involves tp stay sharded over it (the ring's stationary
    shards), every other dim replicated."""
    table = dict(rules)
    out = []
    for name in logical_axes:
        axis = table.get(name) if name is not None else None
        axis_tuple = axis if isinstance(axis, tuple) else (axis,)
        out.append("tp" if "tp" in axis_tuple else None)
    return tuple(out)


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    rules=DEFAULT_RULES) -> tuple:
    """Map logical axis names to a spec. A mesh axis shards at most one
    dim: when two names map to the same axis (an ("embed", "embed")
    kernel), the later dims replicate."""
    table = dict(rules)
    used: set = set()
    out = []
    for name in logical_axes:
        axis = table.get(name) if name is not None else None
        axis_tuple = axis if isinstance(axis, tuple) else (axis,)
        if axis is not None and any(a in used for a in axis_tuple):
            axis = None
        if axis is not None:
            used.update(axis_tuple)
        out.append(axis)
    return tuple(out)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _divisible_spec(mesh, spec, shape) -> tuple:
    """Replicate any dim whose size does not divide over its mesh axes
    (4 heads on tp = 8, odd vocab sizes), as the reference does."""
    fixed = []
    for d, entry in enumerate(spec):
        n = math.prod(mesh.shape[a] for a in _axes(entry))
        fixed.append(entry if entry is not None and shape[d] % n == 0
                     else None)
    return tuple(fixed)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one port parameter lives on the mesh. `spec` is the
    reference's spec in the reference's layout (flax dims); `port_spec`
    the same per dim of the port's tensor (a dim folded from several
    flax dims takes the first one's entry: heads over kv); `shape` the
    global port shape and `local_shape` the block a rank holds."""
    name: str
    path: Tuple[str, ...]
    spec: tuple
    port_spec: tuple
    shape: Tuple[int, ...]
    local_shape: Tuple[int, ...]

    def split(self, axis: str) -> Optional[int]:
        """The port dim split over mesh `axis`, or None."""
        for d, entry in enumerate(self.port_spec):
            if axis in _axes(entry):
                return d
        return None

    def sharded_over(self) -> Tuple[str, ...]:
        """The compute axes (tp, ep) this parameter is split over."""
        return tuple(a for a in COMPUTE_AXES if self.split(a) is not None)


def param_shardings(mesh, cfg, rules=DEFAULT_RULES) -> Dict[str, Placement]:
    """{port parameter name: Placement} of the config's LM on `mesh`
    (any object with a `shape` dict of axis sizes), in `param_shapes`
    order: the logical axes mapped by `rules`, non-divisible dims
    replicated."""
    from ..models.transformer import param_axes
    out = {}
    for name, (path, axes, flax_shape, fold) in param_axes(cfg).items():
        spec = _divisible_spec(mesh, logical_to_spec(axes, rules),
                               flax_shape)
        port_spec = tuple(next((spec[i] for i in dims
                                if spec[i] is not None), None)
                          for dims in fold)
        shape = tuple(math.prod(flax_shape[i] for i in dims)
                      for dims in fold)
        local = tuple(
            size // math.prod(mesh.shape[a] for a in _axes(entry)
                              if a in COMPUTE_AXES)
            for size, entry in zip(shape, port_spec))
        out[name] = Placement(name, tuple(path), spec, port_spec, shape,
                              local)
    return out


def local_block(t: torch.Tensor, placement: Placement,
                coords: Dict[str, int], sizes: Dict[str, int]
                ) -> torch.Tensor:
    """This rank's block of the global tensor `t`: its coordinate's
    slice of each dim split over tp or ep."""
    for axis in COMPUTE_AXES:
        d = placement.split(axis)
        if d is not None and sizes[axis] > 1:
            per = t.shape[d] // sizes[axis]
            t = t.narrow(d, coords[axis] * per, per)
    return t


def gather_block(x: torch.Tensor, placement: Placement, mesh
                 ) -> torch.Tensor:
    """The inverse of `local_block`, collective over the compute axes
    that split the parameter: the whole tensor from every rank's block."""
    for axis in COMPUTE_AXES:
        d = placement.split(axis)
        if d is not None and mesh.shape[axis] > 1:
            x = allgather(x.contiguous(), mesh, axis, axis=d)
    return x


def shard_init(cfg, mesh, seed: int = 0,
               state_dict: Optional[Dict[str, Any]] = None,
               device=None) -> Dict[str, torch.Tensor]:
    """This rank's blocks of the config's LM parameters, {name: tensor
    of the placement's local shape}, from `state_dict` (e.g. converted
    from the reference's flax tree by `models/convert.py`) or drawn from
    `seed` exactly as `init_params` draws them in one process. One
    parameter at a time is whole (the draw's order needs it); the model
    never is."""
    from ..models.convert import draw_params
    placements = param_shardings(mesh, cfg)
    coords, sizes = mesh.coords(), mesh.shape
    out = {}
    if state_dict is None:
        gen = torch.Generator(device=device or "cpu").manual_seed(seed)
        items = draw_params(cfg, gen, device)
    else:
        items = ((n, torch.as_tensor(state_dict[n])) for n in placements)
    for name, t in items:
        p = placements[name]
        out[name] = local_block(t.to(device), p, coords, sizes).contiguous()
        if tuple(out[name].shape) != p.local_shape:
            raise ValueError(f"{name}: block {tuple(out[name].shape)} != "
                             f"{p.local_shape}")
    return out


class ModelLayout:
    """What the LMs' layers need of a mesh: the mesh, the placements of
    the config's parameters, and this rank's size and coordinate on the
    model-parallel axes. `tp_split(suffix)` and `ep_split(suffix)` say
    whether a block's parameter (e.g. "attn.query.weight", read at the
    first block that has it) is split over tp or ep on this mesh."""

    def __init__(self, mesh, cfg):
        self.mesh = mesh
        self.placements = param_shardings(mesh, cfg)
        c = mesh.coords()
        self.tp, self.ep, self.sp = (mesh.shape[a] for a in ("tp", "ep",
                                                             "sp"))
        self.tp_rank, self.ep_rank, self.sp_rank = c["tp"], c["ep"], c["sp"]

    @classmethod
    def of(cls, mesh, cfg) -> Optional["ModelLayout"]:
        """The layout, or None where the mesh has no model-parallel axis
        (the model is then the single-device one)."""
        if mesh is None or all(mesh.shape[a] == 1 for a in ("tp", "ep",
                                                            "sp")):
            return None
        return cls(mesh, cfg)

    def _placement(self, suffix: str) -> Optional[Placement]:
        for name, p in self.placements.items():
            if name == suffix or name.endswith("." + suffix):
                return p
        return None

    def tp_split(self, suffix: str) -> bool:
        p = self._placement(suffix)
        return self.tp > 1 and p is not None and p.split("tp") is not None

    def ep_split(self, suffix: str) -> bool:
        p = self._placement(suffix)
        return self.ep > 1 and p is not None and p.split("ep") is not None


# ---------------------------------------------------------------------------
# regex restore rules: specs keyed by checkpoint tree path
# ---------------------------------------------------------------------------

def path_match(qs: Sequence[str], ks: Sequence[str]) -> bool:
    """True when the regex window `qs` matches a contiguous run of path
    components `ks` (each pattern is anchored with a trailing ``$``)."""
    qts = tuple(re.compile(x + "$") for x in qs)
    for i in range(len(ks) - len(qts) + 1):
        window = [q.match(k) for q, k in zip(qts, ks[i:])]
        if window and all(window):
            return True
    return False


def spec_for_path(path: Sequence[str], rules, default=None):
    """Resolve a checkpoint tree path against restore rules, a sequence
    of ((pattern, ...), spec-or-None) pairs; None in the spec slot
    means replicate (an empty spec). Falls through to `default`."""
    ks = tuple(str(k) for k in path)
    for qs, spec in rules or ():
        if path_match(tuple(qs), ks):
            return tuple(spec) if spec is not None else ()
    return default


def sharding_for_path(mesh, path: Sequence[str], rules, shape,
                      default=None):
    """The spec of one checkpoint leaf: the first matching restore rule,
    non-divisible dims replicated; no rule hit returns `default`."""
    spec = spec_for_path(path, rules)
    if spec is None:
        return default
    return _divisible_spec(mesh, spec, shape)


__all__ = ["ACTIVATION_RULES", "COMPUTE_AXES", "DEFAULT_RULES",
           "ModelLayout", "Placement",
           "gather_block", "local_block", "logical_to_spec", "param_shardings", "path_match",
           "shard_init", "sharding_for_path", "spec_for_path",
           "tp_manual_spec", "tp_overlap_activation_spec"]
