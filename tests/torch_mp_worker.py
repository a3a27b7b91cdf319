"""One rank of the port's model-parallel parity runs (tests/test_torch_tp.py,
test_torch_ring_attention.py and test_torch_ep.py on the CPU; chip_smoke.py's
[train-lm-mp] phase on the card runs the same legs).

    TPU_SLOTS_PER_WORKER=8 python -m mpi_operator_tpu_torch.bootstrap.launch \\
        -- python tests/torch_mp_worker.py <world> <port> <out> \\
        --legs NAME[,NAME...] [--device cpu|cuda] [--weights W.pt] \\
        [--train-dir D]

(`gang()` below starts it so.) The rank joins the gang through the
port's bootstrap, and each leg lays its own mesh over the first ranks of
the same processes (`make_mesh(..., ranks=range(n))`, every rank calling
it), so the processes start once for every leg. A leg is one of:

- a trainer leg (`kind` "train"): an LMTrainer of the leg's model over
  its mesh, from the same weights (`--weights`, the flax weights
  converted, or seed 0) on the same seeded numpy global batches, each
  rank its share (`mesh_share`); it saves the whole model's flat params
  after, mu, nu (`LMTrainer.global_flat`; the mesh's first rank, every
  rank their digests; one process also its params before: a gang
  starts from the same seed or weights), every step's loss and the
  K1-K3 launches. A leg's `fault` plants one of FAULTS.
- "ring": `ring_attention` over whole seeded q, k, v and a seeded
  cotangent at the leg's mesh, causal and not: the output and dq, dk,
  dv, and the launches.
- "matmul": the ring collective-matmuls, uni and bidir, against the
  einsum oracle on this rank, forward and backward.
- "ckpt": a same-mesh checkpoint resumed (bit-equal) and one written
  over another mesh refused.
- "bench": `LMTrainer.benchmark` on the mesh's TokenStream (the card's
  full-size leg: tokens/s, step p50, the state's bytes a rank, peak
  memory).

Rank r saves `<out>-<r>.pt`: {leg: result} for the legs it was part of.
"""
import argparse
import dataclasses
import hashlib
import os
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (ROOT, os.path.join(ROOT, "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

from mpi_operator_tpu_torch.data.synthetic import mesh_share  # noqa: E402
from mpi_operator_tpu_torch.models import transformer as tt  # noqa: E402
from mpi_operator_tpu_torch.ops import attention as ops  # noqa: E402
from mpi_operator_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from mpi_operator_tpu_torch.train import lm_trainer as tlm  # noqa: E402

GLOBAL_BATCH, VOCAB = 8, 96
FLASH = ("flash_fwd", "flash_dq", "flash_dkv")
#: the planted faults: each must miss the parity limit
FAULTS = ("allreduce-skipped", "fsdp-wrong-group", "norm-tp-times",
          "ring-diagonal-noncausal")


def model_configs(size="test"):
    """{name: TransformerConfig}. "test": the 2-layer test widths in f32
    with dense attention (vocab 96, the CPU tests). "chip": gpt2-medium's
    width at 2 layers and gpt2-small's with 8 experts, f32, dense (TF32
    off). "chip-bf16": gpt2-medium's width at 2 layers in bf16 through
    K1-K3. "full": gpt2-medium whole, bf16, K1-K3."""
    if size == "test":
        common = dict(attention="dense", dtype=torch.float32,
                      vocab_size=VOCAB, max_len=32)
        return {"gpt2": tt.gpt2_config("test", **common),
                "llama": tt.llama_config("test", **common),
                "bert": tt.bert_config("test", **common),
                "moe": tt.gpt2_config("test", num_experts=4, **common)}
    if size == "full":
        return {"gpt2": tt.gpt2_config("medium", attention="flash",
                                       max_len=512)}
    bf16 = size == "chip-bf16"
    common = dict(num_layers=2, max_len=512,
                  dtype=torch.bfloat16 if bf16 else torch.float32,
                  attention="flash" if bf16 else "dense")
    return {"gpt2": tt.gpt2_config("medium", **common),
            "moe": tt.gpt2_config("small", num_experts=8, **common)}


def leg(model, size="test", kind="train", steps=3, seq=16, accum=1,
        fault=None, batch=GLOBAL_BATCH, gather=("params", "mu", "nu"),
        **mesh_and_cfg):
    """A leg's spec: the mesh's sizes, the config's overrides (attention,
    tp_overlap, tp_ring), the trainer's shape, and which whole buffers a
    trainer leg gathers (each is a gather of the whole model)."""
    mesh = {k: v for k, v in mesh_and_cfg.items()
            if k in tmesh.MeshConfig().axis_sizes()}
    cfg = {k: v for k, v in mesh_and_cfg.items() if k not in mesh}
    return dict(model=model, size=size, kind=kind, steps=steps, seq=seq,
                accum=accum, fault=fault, batch=batch, mesh=mesh, cfg=cfg,
                gather=gather)


#: the legs of the CPU tests, by name
LEGS = {
    # trainer parity (test_torch_tp.py)
    "gpt2/dp2-fsdp2-tp2": leg("gpt2", dp=2, fsdp=2, tp=2),
    "llama/dp2-fsdp2-tp2": leg("llama", dp=2, fsdp=2, tp=2),
    "bert/dp2-fsdp2-tp2": leg("bert", dp=2, fsdp=2, tp=2),
    "gpt2/fsdp2-tp2": leg("gpt2", fsdp=2, tp=2),
    "gpt2/dp2-fsdp2-tp2-uni": leg("gpt2", dp=2, fsdp=2, tp=2,
                                  tp_overlap=True),
    "gpt2/dp2-fsdp2-tp2-bidir": leg("gpt2", dp=2, fsdp=2, tp=2,
                                    tp_overlap=True, tp_ring="bidir"),
    "gpt2/tp8": leg("gpt2", tp=8),
    "matmul/dp2-tp4": leg("gpt2", kind="matmul", dp=2, tp=4),
    "ckpt/fsdp2-tp2": leg("gpt2", kind="ckpt", fsdp=2, tp=2),
    "ckpt/dp2-fsdp2-tp2": leg("gpt2", kind="ckpt", dp=2, fsdp=2, tp=2),
    # the planted faults at (1, 2, 2)
    "gpt2/fsdp2-tp2/allreduce-skipped": leg(
        "gpt2", fsdp=2, tp=2, fault="allreduce-skipped"),
    "gpt2/fsdp2-tp2/fsdp-wrong-group": leg(
        "gpt2", fsdp=2, tp=2, fault="fsdp-wrong-group"),
    "gpt2/fsdp2-tp2/norm-tp-times": leg(
        "gpt2", fsdp=2, tp=2, fault="norm-tp-times"),
    # sequence parallelism (test_torch_ring_attention.py)
    "ring/dp2-sp4": leg("gpt2", kind="ring", dp=2, sp=4),
    "ring/sp8": leg("gpt2", kind="ring", sp=8),
    "ring/dp2-sp4-dense": dict(leg("gpt2", kind="ring", dp=2, sp=4),
                               ring=dict(impl="dense")),
    "ring/sp8-dense": dict(leg("gpt2", kind="ring", sp=8),
                           ring=dict(impl="dense")),
    "gpt2/dp2-sp2-tp2": leg("gpt2", dp=2, sp=2, tp=2, attention="ring"),
    "llama/dp2-sp2-tp2": leg("llama", dp=2, sp=2, tp=2, attention="ring"),
    "gpt2/dp2-sp2-tp2/ring-diagonal-noncausal": leg(
        "gpt2", dp=2, sp=2, tp=2, attention="ring",
        fault="ring-diagonal-noncausal"),
    # expert parallelism (test_torch_ep.py)
    "moe/dp2-ep4": leg("moe", dp=2, ep=4, accum=2),
    "moe/dp2-ep2-tp2": leg("moe", dp=2, ep=2, tp=2),
    "moe/dp2-sp2-ep2": leg("moe", dp=2, sp=2, ep=2, attention="ring"),
    "moe/dp2-ep4-dropless": leg("moe", dp=2, ep=4, moe_dropless=True),
    "moe-layer/dp2-ep4": leg("moe", kind="moe", dp=2, ep=4),
    "moe-layer/dp2-ep2-tp2": leg("moe", kind="moe", dp=2, ep=2, tp=2),
}

#: the card's legs (chip_smoke.py [train-lm-mp]), 4 ranks sharing it
CHIP = dict(size="chip", batch=8, seq=256)
RING_CHIP = dict(shape=(4, 2048, 16, 64), dtype=torch.bfloat16)
LEGS.update({
    # (a) gpt2-medium whole, bf16, K1-K3, global batch 16 x 512
    "chip/full-fsdp2-tp2": leg("gpt2", size="full", kind="bench", batch=16,
                               seq=512, fsdp=2, tp=2),
    # (b) f32 parity at gpt2-medium's width, 2 layers, 8 x 256
    "chip/fsdp2-tp2": leg("gpt2", fsdp=2, tp=2, **CHIP),
    "chip/dp2-fsdp2": leg("gpt2", dp=2, fsdp=2, **CHIP),
    "chip/fsdp2-tp2-uni": leg("gpt2", fsdp=2, tp=2, tp_overlap=True,
                              **CHIP),
    "chip/fsdp2-tp2-bidir": leg("gpt2", fsdp=2, tp=2, tp_overlap=True,
                                tp_ring="bidir", **CHIP),
    "chip/moe-dp2-ep2": leg("moe", dp=2, ep=2, accum=2, **CHIP),
    # (c) the ring through K1-K3, alone and in a trainer step
    "chip/ring-sp2": dict(leg("gpt2", kind="ring", sp=2), ring=RING_CHIP),
    "chip/ring-sp4": dict(leg("gpt2", kind="ring", sp=4), ring=RING_CHIP),
    "chip/ring-sp2/ring-diagonal-noncausal": dict(
        leg("gpt2", kind="ring", sp=2, fault="ring-diagonal-noncausal"),
        ring=RING_CHIP),
    "chip/sp2-tp2": leg("gpt2", size="chip-bf16", steps=2, batch=8,
                        seq=512, sp=2, tp=2, attention="ring"),
    # (d) the planted faults
    "chip/fsdp2-tp2/allreduce-skipped": leg(
        "gpt2", fsdp=2, tp=2, fault="allreduce-skipped", gather=("params",),
        **CHIP),
    "chip/fsdp2-tp2/fsdp-wrong-group": leg(
        "gpt2", fsdp=2, tp=2, fault="fsdp-wrong-group", gather=("params",),
        **CHIP),
    "chip/fsdp2-tp2/norm-tp-times": leg(
        "gpt2", fsdp=2, tp=2, fault="norm-tp-times", **CHIP),
    "chip/sp2-tp2/ring-diagonal-noncausal": leg(
        "gpt2", size="chip-bf16", steps=2, batch=8, seq=512, sp=2, tp=2,
        attention="ring", fault="ring-diagonal-noncausal",
        gather=("params",)),
})


def card_legs(world, size="full", batch=16, seq=512):
    """scripts/ddp_parity.py --mp's legs over `world` ranks, one card a
    rank (NCCL): gpt2-medium at `batch` x `seq` a card through
    LMTrainer.benchmark at tp = 1, 2, 4 (dp filling the rest), fsdp = 2,
    4, and tp with its all-reduces off (timing only: the step without
    them, for the exposed share)."""
    out = {}
    for tp in (1, 2, 4):
        if world % tp == 0 and tp <= world:
            mesh = dict(dp=world // tp, tp=tp)
            out[f"cards/tp{tp}"] = leg("gpt2", size=size, kind="bench",
                                       batch=batch * world, seq=seq, **mesh)
            if tp > 1:
                out[f"cards/tp{tp}-off"] = leg(
                    "gpt2", size=size, kind="bench", batch=batch * world,
                    seq=seq, fault="tp-allreduce-off", **mesh)
    for fsdp in (2, 4):
        if world % fsdp == 0 and fsdp <= world:
            out[f"cards/fsdp{fsdp}"] = leg(
                "gpt2", size=size, kind="bench", batch=batch * world,
                seq=seq, dp=world // fsdp, fsdp=fsdp)
    return out


def config_of(spec):
    cfg = model_configs(spec["size"])[spec["model"]]
    return dataclasses.replace(cfg, **spec["cfg"]) if spec["cfg"] else cfg


def trainer_config(spec, cfg):
    return tlm.LMTrainerConfig(
        global_batch_size=spec["batch"], seq_len=spec["seq"],
        warmup_steps=2, masked_lm=not cfg.causal, accum_steps=spec["accum"],
        fused_xent=bool(cfg.tp_overlap) and cfg.causal)


def batches(cfg, steps, seq, batch=GLOBAL_BATCH, seed=1):
    """`steps` seeded numpy global batches: (tokens, targets, None) for a
    causal model; for BERT (inputs with the mask id vocab - 1 at the
    scored slots, the original tokens, the f32 mask), 15% scored."""
    rs = np.random.RandomState(seed)
    V, out = cfg.vocab_size, []
    for _ in range(steps):
        toks = rs.randint(0, V - 1, (batch, seq + 1))
        if cfg.causal:
            out.append((toks[:, :-1], toks[:, 1:], None))
            continue
        toks = toks[:, :-1]
        mask = rs.random_sample(toks.shape) < 0.15
        out.append((np.where(mask, V - 1, toks), toks,
                    mask.astype(np.float32)))
    return out


def _counts():
    return {k: ops.launch_counts[k] for k in FLASH}


class _CountPlain:
    """On the CPU, where no kernel launches, count the calls of the plain
    versions K1-K3 run through (`ops.launch_counts` counts launches)."""

    def __init__(self):
        self.calls = {k: 0 for k in FLASH}
        self._saved = {}

    def __enter__(self):
        for k in FLASH:
            ref = getattr(ops, k + "_ref")
            self._saved[k] = ref

            def counted(*a, _k=k, _ref=ref, **kw):
                self.calls[_k] += 1
                return _ref(*a, **kw)
            setattr(ops, k + "_ref", counted)
        return self

    def __exit__(self, *exc):
        for k, ref in self._saved.items():
            setattr(ops, k + "_ref", ref)


def _plant(fault, trainer, state):
    """Plant `fault` in this trainer and state; returns the undo."""
    undo = []
    if fault == "allreduce-skipped":
        # one layer's row-parallel all-reduce skipped: each rank keeps its
        # heads' partial product
        attn = state.model.backbone.blocks[0].attn

        def forward(*a, **kw):
            saved = tt.reduce_from
            tt.reduce_from = lambda x, mesh, dims: x
            try:
                return type(attn).forward(attn, *a, **kw)
            finally:
                tt.reduce_from = saved
        attn.forward = forward
    elif fault == "fsdp-wrong-group":
        # the gradients reduce-scattered over tp instead of fsdp
        saved = tlm.reduce_scatter
        tlm.reduce_scatter = lambda x, mesh, dim, axis=0: saved(
            x, mesh, "tp" if dim == "fsdp" else dim, axis)
        undo.append(lambda: setattr(tlm, "reduce_scatter", saved))
    elif fault == "norm-tp-times":
        # H25: every class weighted 1, so a tp-replicated parameter counts
        # tp times in the norm the clip and the guard read
        trainer._norm_weight = lambda cls: 1.0
    elif fault == "ring-diagonal-noncausal":
        from mpi_operator_tpu_torch.parallel import ring_attention as ra
        saved = ra._block_fns

        def noncausal(impl):
            fwd, dq, dkv = saved(impl)
            return (lambda q, k, v, causal=True: fwd(q, k, v, False),
                    lambda q, k, v, do, lse, delta, causal=True: dq(
                        q, k, v, do, lse, delta, False),
                    lambda q, k, v, do, lse, delta, causal=True: dkv(
                        q, k, v, do, lse, delta, False))
        ra._block_fns = noncausal
        undo.append(lambda: setattr(ra, "_block_fns", saved))
    elif fault == "tp-allreduce-off":
        # timing only: every tp all-reduce of the step (forward and the
        # copies' backward) the identity, to time the step without them
        saved = (tt.reduce_from, tt.copy_to, tlm.reduce_from, tlm.copy_to)
        tt.reduce_from = tlm.reduce_from = lambda x, mesh, dims: x
        tt.copy_to = tlm.copy_to = lambda x, mesh, dims: x

        def restore():
            tt.reduce_from, tt.copy_to, tlm.reduce_from, tlm.copy_to = saved
        undo.append(restore)
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    return undo


def train_leg(spec, device, mesh=None, weights=None):
    """A trainer leg on this rank (or one process without a mesh)."""
    cfg = config_of(spec)
    trainer = tlm.LMTrainer(cfg, trainer_config(spec, cfg), device=device,
                            mesh=mesh)
    state = trainer.init_state(0, state_dict=weights)
    undo = _plant(spec["fault"], trainer, state)
    try:
        start = trainer.global_flat(state) if mesh is None else None
        losses, before = [], _counts()
        with _CountPlain() as plain:
            for b in batches(cfg, spec["steps"], spec["seq"],
                             spec["batch"]):
                mine = [None if a is None else torch.from_numpy(
                    np.ascontiguousarray(mesh_share(a, mesh,
                                                    spec["accum"]))
                ).to(device) for a in b]
                state, m = trainer.train_step(state, *mine)
                losses.append(float(m["loss"]))
        after = _counts()
        flats = {k: trainer.global_flat(state, k) for k in spec["gather"]}
        flats = {k: v.cpu() for k, v in dict(flats, start=start).items()
                 if v is not None}
        # the whole model's buffers are the same on every rank (gathered):
        # the mesh's first rank keeps them, every rank their digests
        keep = mesh is None or mesh.index(tmesh.AXIS_ORDER) == 0
        out = {**(flats if keep else {}),
               "digest": {k: hashlib.sha1(v.numpy().tobytes()).hexdigest()
                          for k, v in flats.items()},
               "count": int(state.opt.count), "losses": losses,
               "launches": {k: after[k] - before[k] for k in FLASH},
               "plain_calls": dict(plain.calls),
               "streak": int(state.nonfinite_streak)}
        out["masters_bytes"] = 4 * (state.masters.numel()
                                    + state.opt.mu.numel()
                                    + state.opt.nu.numel())
        return out
    finally:
        for u in undo:
            u()


def ring_inputs(B, S, H, D, dtype, seed=0, device="cpu"):
    """Seeded whole q, k, v and a cotangent dO, [B, S, H, D]."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, S, H, D, generator=g).to(device, dtype)
            for _ in range(4)]


def ring_leg(spec, device, mesh, shape=(4, 64, 2, 16),
             dtype=torch.float32, impl="flash"):
    """ring_attention over whole seeded inputs, causal and not, through
    `impl` ("flash": K1-K3 a block, their plain versions on the CPU;
    "dense": the einsum fallback): the output and dq, dk, dv of the
    seeded cotangent, and the launches (the plain versions' calls on
    the CPU)."""
    from mpi_operator_tpu_torch.parallel.ring_attention import \
        ring_attention
    q, k, v, do = ring_inputs(*shape, dtype, device=device)
    out = {}
    undo = _plant(spec["fault"], None, None)
    for causal in (True, False):
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        before = _counts()
        with _CountPlain() as plain:
            o = ring_attention(qs, ks, vs, mesh, causal=causal, impl=impl)
            o.backward(do)
        after = _counts()
        keep = mesh.index(tmesh.AXIS_ORDER) == 0
        out[causal] = {
            "launches": {n: after[n] - before[n] for n in FLASH},
            "plain_calls": dict(plain.calls),
            "sp_index": mesh.coords()["sp"],
            **({"out": o.detach().cpu(), "dq": qs.grad.cpu(),
                "dk": ks.grad.cpu(), "dv": vs.grad.cpu()} if keep else {})}
    for u in undo:
        u()
    return out


def matmul_leg(spec, device, mesh):
    """allgather_matmul and matmul_reducescatter, uni and bidir, on this
    rank's shards of seeded x, w (S = 8 and 6 rows for the
    reduce-scatter: 6 does not split over 4), against the einsum of the
    whole operands, forward and gradients of sum(sin(.)): the largest
    differences, and the argument errors' messages."""
    from mpi_operator_tpu_torch.parallel import collectives as col
    tp, n = mesh.index(("tp",)), mesh.shape["tp"]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 16, generator=g)
    w = torch.randn(16, 12, generator=g)
    err = {}

    def diff(a, b):
        return float((a - b).abs().max())
    for ring in ("uni", "bidir"):
        xl = x[:, tp * 8 // n:(tp + 1) * 8 // n].clone().requires_grad_()
        wl = w[:, tp * 12 // n:(tp + 1) * 12 // n].clone().requires_grad_()
        y = col.allgather_matmul(xl, wl, mesh, "tp", ring)
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        yr = xr @ wr
        torch.sin(col.gather_from(y, mesh, "tp", -1)).sum().backward()
        torch.sin(yr).sum().backward()
        err[f"agm-{ring}"] = max(
            diff(y, yr[..., tp * 12 // n:(tp + 1) * 12 // n]),
            diff(xl.grad, xr.grad[:, tp * 8 // n:(tp + 1) * 8 // n]),
            diff(wl.grad, wr.grad[:, tp * 12 // n:(tp + 1) * 12 // n]))
        for S in (8, 6):
            xs = x[:, :S]
            xl = xs[..., tp * 16 // n:(tp + 1) * 16 // n].clone() \
                .requires_grad_()
            wl = w[tp * 16 // n:(tp + 1) * 16 // n].clone().requires_grad_()
            y = col.matmul_reducescatter(xl, wl, mesh, "tp", ring)
            xr, wr = xs.clone().requires_grad_(), w.clone().requires_grad_()
            yr = xr @ wr
            full = col.gather_from(y, mesh, "tp", 1)
            pad_ok = bool((full[:, S:] == 0).all())
            torch.sin(full[:, :S]).sum().backward()
            torch.sin(yr).sum().backward()
            err[f"mrs-{ring}-{S}"] = max(
                diff(full[:, :S], yr),
                diff(xl.grad, xr.grad[..., tp * 16 // n:(tp + 1) * 16 // n]),
                diff(wl.grad, wr.grad[tp * 16 // n:(tp + 1) * 16 // n]))
            err[f"mrs-{ring}-{S}-shape"] = tuple(full.shape)
            err[f"mrs-{ring}-{S}-pad-zero"] = pad_ok
    msgs = []
    for fn, a, b, ring in ((col.allgather_matmul, torch.ones(4, 8),
                            torch.ones(16, 4), "uni"),
                           (col.matmul_reducescatter, torch.ones(4, 8),
                            torch.ones(16, 4), "uni"),
                           (col.allgather_matmul, torch.ones(4, 8),
                            torch.ones(8, 4), "ring"),
                           (col.allgather_matmul, torch.ones(8),
                            torch.ones(8, 4), "uni")):
        try:
            fn(a, b, mesh, "tp", ring)
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    err["messages"] = msgs
    return err


def moe_weights(seed=1):
    """Seeded weights of a 4-expert MoeMlp (E 32, mlp 64) and its
    [2, 16, 32] input: (router [4, 32], w_in, w_out, x)."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(4, 32, generator=g) * 0.5,
            torch.randn(4, 32, 64, generator=g) * 0.5,
            torch.randn(4, 64, 32, generator=g) * 0.5,
            torch.randn(2, 16, 32, generator=g))


def moe_layer(layout=None, mesh=None):
    """The reference test's MoeMlp (4 experts, top 2, capacity factor
    2.0, f32) over `layout`, holding this rank's blocks of
    `moe_weights`, routing over `mesh`."""
    from mpi_operator_tpu_torch.parallel.moe import MoeMlp
    from mpi_operator_tpu_torch.parallel.sharding import local_block
    router, w_in, w_out, _ = moe_weights()
    layer = MoeMlp(4, 32, 64, top_k=2, capacity_factor=2.0,
                   dtype=torch.float32, layout=layout)
    full = {"router.weight": router, "w_in": w_in, "w_out": w_out}
    if layout is not None:
        place = layout.placements
        pre = next(n for n in place if n.endswith("moe.w_in"))[:-len("w_in")]
        full = {n: local_block(t, place[pre + n], layout.mesh.coords(),
                               layout.mesh.shape) for n, t in full.items()}
    layer.load_state_dict({n: t.contiguous() for n, t in full.items()})
    layer.mesh = mesh
    return layer


def moe_leg(spec, device, mesh):
    """The 4-expert MoeMlp over the leg's mesh (its experts over ep, their
    mlp dim over tp), this rank's rows of the input: its output rows, aux
    share, drop rate and the gradients of sum(out^2) + aux (x's rows,
    the rank's weight blocks)."""
    from mpi_operator_tpu_torch.parallel.sharding import ModelLayout
    cfg = tt.gpt2_config("test", num_experts=4, embed_dim=32, mlp_dim=64)
    layer = moe_layer(ModelLayout(mesh, cfg), mesh)
    x = mesh_share(moe_weights()[3], mesh).clone().requires_grad_()
    out, aux = layer(x)
    ((out ** 2).sum() + aux).backward()
    return {"out": out.detach(), "aux": float(aux), "dx": x.grad,
            "drop_rate": float(layer.drop_rate),
            "grads": {n: p.grad for n, p in layer.named_parameters()},
            "coords": mesh.coords()}


def ckpt_leg(spec, device, mesh, train_dir):
    """Two steps, a checkpoint, a third step; a fresh state restored from
    the checkpoint takes the third step again: bit-equal params, mu, nu
    and loss. Then a state over another split (tp only) must refuse
    the checkpoint, naming ROADMAP.md step 10e."""
    from mpi_operator_tpu_torch.train import checkpoint as ck
    cfg = config_of(spec)
    tcfg = trainer_config(spec, cfg)
    trainer = tlm.LMTrainer(cfg, tcfg, device=device, mesh=mesh)
    state = trainer.init_state(0)
    data = [[None if a is None else torch.from_numpy(np.ascontiguousarray(
        mesh_share(a, mesh))).to(device) for a in b]
        for b in batches(cfg, 3, spec["seq"])]
    for b in data[:2]:
        state, _ = trainer.train_step(state, *b)
    ck.reset_saved_state()
    path = ck.save_checkpoint(train_dir, state)
    state, m = trainer.train_step(state, *data[2])
    want = {"params": state.params.clone(), "mu": state.opt.mu.clone(),
            "nu": state.opt.nu.clone(), "loss": float(m["loss"])}
    fresh = ck.restore_checkpoint(path, trainer.init_state(5))
    step = fresh.step
    fresh, m = trainer.train_step(fresh, *data[2])
    out = {"step": step, "loss_equal": float(m["loss"]) == want["loss"],
           "verified": ck.verify_checkpoint(path),
           **{k: bool(torch.equal(getattr(fresh, "params") if k == "params"
                                  else getattr(fresh.opt, k), want[k]))
              for k in ("params", "mu", "nu")}}
    # another split of the same ranks (its layout is all the restore
    # reads before it refuses; no group is needed)
    other = tmesh.Mesh(tmesh.MeshConfig(tp=mesh.size), mesh.ranks)
    try:
        ck.restore_checkpoint(path, tlm.LMTrainer(
            cfg, tcfg, device=device, mesh=other).init_state(0))
        out["other_mesh"] = None
    except ck.ReshardRequired as e:
        out["other_mesh"] = str(e)
    return out


def bench_leg(spec, device, mesh, steps=5, warmup=2):
    """trainer.benchmark at the leg's mesh on the synthetic stream (its
    share a rank): tokens/s, step p50, losses, the state's bytes a rank
    and the peak memory, K1-K3 launches."""
    from mpi_operator_tpu_torch.data import TokenStream
    cfg = config_of(spec)
    tcfg = dataclasses.replace(trainer_config(spec, cfg), log_every=steps)
    trainer = tlm.LMTrainer(cfg, tcfg, device=device, mesh=mesh)
    state = trainer.init_state(0)
    stream = TokenStream(spec["batch"], spec["seq"], cfg.vocab_size, seed=1,
                         device=device, mesh=mesh)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    undo = _plant(spec["fault"], trainer, state)
    before = _counts()
    try:
        state, m = trainer.benchmark(state, stream, num_steps=steps,
                                     warmup_steps=warmup,
                                     log=lambda s: None)
    finally:
        for u in undo:
            u()
    after = _counts()
    attn = state.model.backbone.blocks[0].attn
    return {"tokens_per_sec": m["tokens_per_sec"],
            "step_time_p50_ms": m["step_time_p50_ms"],
            "heads_per_launch": attn.query.out_features // cfg.head_dim,
            "losses": m["step_losses"], "streak": int(
                state.nonfinite_streak),
            "steps": steps + warmup,
            "masters_bytes": 4 * (state.masters.numel()
                                  + state.opt.mu.numel()
                                  + state.opt.nu.numel()),
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
            "launches": {k: after[k] - before[k] for k in FLASH}}


def run_leg(name, spec, device, mesh, weights=None, train_dir=None):
    kind = spec["kind"]
    if kind == "train":
        return train_leg(spec, device, mesh, (weights or {}).get(
            spec["model"]))
    if kind == "ring":
        return ring_leg(spec, device, mesh, **spec.get("ring", {}))
    if kind == "matmul":
        return matmul_leg(spec, device, mesh)
    if kind == "moe":
        return moe_leg(spec, device, mesh)
    if kind == "ckpt":
        return ckpt_leg(spec, device, mesh, os.path.join(
            train_dir, name.replace("/", "_")))
    if kind == "bench":
        return bench_leg(spec, device, mesh)
    raise ValueError(f"unknown leg kind {kind!r}")


def legs_for(names):
    """The specs of `names`: LEGS, or card_legs(world) for "cards/..."
    ("cards-test/..." at the test size on the CPU)."""
    import torch.distributed as dist
    world = dist.get_world_size()
    table = dict(LEGS)
    table.update(card_legs(world))
    table.update({n.replace("cards/", "cards-test/"): dict(
        spec, size="test", seq=16) for n, spec in card_legs(
            world, size="test", batch=2, seq=16).items()})
    return table


def run(names, legs, device, weights=None, train_dir=None):
    """Every leg of `names` on this rank's processes: each lays its mesh
    over the first ranks (every rank calls make_mesh); its members run
    it. Returns {name: result} for the legs this rank took part in."""
    import torch.distributed as dist
    me, out = dist.get_rank(), {}
    for name in names:
        spec = legs[name]
        cfg = tmesh.MeshConfig(**spec["mesh"])
        mesh = tmesh.make_mesh(cfg, ranks=range(cfg.num_devices))
        if me in mesh:
            out[name] = run_leg(name, spec, device, mesh, weights,
                                train_dir)
            out[name]["mesh"] = dict(mesh.shape)
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gang(world, out, legs, *extra, device="cpu", timeout=900):
    """This script as `world` ranks through one launch.py, joined through
    the bootstrap; returns [each rank's results]. Raises with the
    ranks' stderr if it exits non-zero."""
    env = dict(os.environ, TPU_SLOTS_PER_WORKER=str(world),
               OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    for k in ("TPU_WORKER_ID", "TPU_LOCAL_RANK", "TPU_FAULT_INJECT",
              "TPU_NUM_SLICES", "TPU_SLICE_ID"):
        env.pop(k, None)
    if "--train-dir" not in extra:       # one directory the ranks share
        extra = extra + ("--train-dir", out + "-ckpt")
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_operator_tpu_torch.bootstrap.launch",
         "--", sys.executable, os.path.abspath(__file__), str(world),
         str(free_port()), out, "--legs", ",".join(legs), "--device",
         device, *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f"gang of {world} failed (rc {proc.returncode}):"
                           f" {proc.stderr[-4000:]}")
    return [torch.load(f"{out}-{r}.pt") for r in range(world)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("world", type=int)
    parser.add_argument("port", type=int)
    parser.add_argument("out")
    parser.add_argument("--legs", required=True)
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--weights", default=None)
    parser.add_argument("--train-dir", default=None,
                        help="the checkpoint legs' directory, shared by "
                             "every rank")
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from mpi_operator_tpu_torch.bootstrap import initialize
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    env = dict(os.environ, TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{args.port}",
               TPU_NUM_PROCESSES=str(args.world))
    cpu = args.device == "cpu"
    info = initialize(env, hostname="lm-worker-0",
                      device="cpu" if cpu else None)
    device = (torch.device("cpu") if cpu
              else torch.device("cuda", torch.cuda.current_device()))
    legs = legs_for(args.legs.split(","))
    weights = torch.load(args.weights) if args.weights else None
    out = run(args.legs.split(","), legs, device, weights, args.train_dir)
    out["backend"] = dist.get_backend()
    torch.save(out, f"{args.out}-{info.process_id}.pt")
    dist.destroy_process_group()
    return 0


def rel(a, b) -> float:
    """||a - b|| / ||b|| (0 when both are 0)."""
    den = float(b.norm())
    return float((a - b).norm()) / den if den else float((a - b).norm())


def compare(got, want) -> dict:
    """The relative errors of a leg's model against another run's (one
    process's, whose start both runs share): the update (params after
    minus before), mu and nu where the leg gathered them; and the largest
    difference of the step losses."""
    start = got.get("start", want["start"])
    err = {"update": rel(got["params"] - start,
                         want["params"] - want["start"])}
    err.update({k: rel(got[k], want[k]) for k in ("mu", "nu") if k in got})
    err["loss"] = max(abs(a - b) for a, b in zip(got["losses"],
                                                 want["losses"]))
    return err


if __name__ == "__main__":
    sys.exit(main())
