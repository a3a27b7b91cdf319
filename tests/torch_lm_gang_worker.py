"""One rank of the port's data-parallel LM parity runs
(tests/test_torch_lm_gang.py; chip_smoke.py's [train-lm-ddp] phase and
scripts/ddp_parity.py run the same functions on the card).

    TPU_SLOTS_PER_WORKER=2 python -m mpi_operator_tpu_torch.bootstrap.launch \\
        -- python tests/torch_lm_gang_worker.py <world> <port> <out> \\
        [--device cpu|cuda] [--size test|chip|chip-bf16] [--steps N] \\
        [--only gpt2,bert,moe,resnet] [--faults] [--checks] \\
        [--weights W.pt] [--train-dir D]

(`gang()` below starts it so, one launch.py a slice). The rank joins
the gang through the port's bootstrap (the controller's env contract:
coordinator, gang size, slices; its rank from the pod's ordinal and
TPU_LOCAL_RANK) and lays the mesh with `bootstrap.hybrid_mesh`. It
trains the models of `parity_configs()` from the same weights (seed 0,
or `--weights`) on its rows of the same seeded numpy global batches,
each rank its share of every microbatch (`data/synthetic.py
rank_share`), and saves `<out>-<rank>.pt`: each model's flat params
before and after, the AdamW moments and every step's global loss.

- gpt2: causal; bert: non-causal, the MLM objective over padded rows
  (each row's valid length drawn, so the ranks' mask counts differ:
  H13); moe: gpt2 with 4 experts (8 on the card), capacity factor
  1.25, accum_steps 2 (H14, H16). See parity_configs for the sizes.
- `--faults` adds the planted faults, each a model of its own:
  bert/per-rank-denominator (each rank normalises by its own mask
  count, the average DDP would take), moe/per-rank-routing (each rank
  routes its tokens alone), moe/rows-then-microbatches (each rank keeps
  its consecutive rows and cuts them into microbatches, H16).
- `--checks` adds H13's mask counts, H14's routing of one MoE layer
  (ints and values), H15's guard agreement (a non-finite loss planted
  on the last rank) and a divergence rollback (in `--train-dir`), and
  the hierarchical all-reduce against the flat one.
- resnet (the multi-slice leg): tests/torch_ddp_worker.py's ResNet over
  the same mesh.
"""
import argparse
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

from mpi_operator_tpu_torch.data.synthetic import rank_share  # noqa: E402
from mpi_operator_tpu_torch.models import transformer as tt  # noqa: E402
from mpi_operator_tpu_torch.parallel import moe as tmoe  # noqa: E402
from mpi_operator_tpu_torch.train.lm_trainer import (  # noqa: E402
    LMTrainer, LMTrainerConfig)

GLOBAL_BATCH, VOCAB = 8, 96
SEQ = {"test": 16, "chip": 256, "chip-bf16": 256}
MODELS = ("gpt2", "bert", "moe")
# (model, planted fault)
FAULTS = (("bert", "per-rank-denominator"), ("moe", "per-rank-routing"),
          ("moe", "rows-then-microbatches"))


def parity_configs(size="test"):
    """{name: (TransformerConfig, accum_steps)}. "test": the 2-layer
    test widths in f32 with dense attention (the CPU tests; vocab 96).
    "chip": gpt2-medium's width, bert-large's and gpt2-small's with 8
    experts, each at 2 layers, in f32 with dense attention (TF32 off:
    the GEMMs of a rank's rows then round like one process's to f32
    ulps, so the comparison can tell a fault from rounding); "chip-bf16":
    the same in bf16 through K1-K3, where the ranks' GEMMs round like
    one process's only to bf16 ulps."""
    if size.startswith("chip"):
        bf16 = size == "chip-bf16"
        common = dict(num_layers=2, max_len=SEQ[size],
                      dtype=torch.bfloat16 if bf16 else torch.float32,
                      attention="flash" if bf16 else "dense")
        return {"gpt2": (tt.gpt2_config("medium", **common), 1),
                "bert": (tt.bert_config("large", **common), 1),
                "moe": (tt.gpt2_config("small", num_experts=8, **common), 2)}
    common = dict(attention="dense", dtype=torch.float32, vocab_size=VOCAB,
                  max_len=32)
    return {"gpt2": (tt.gpt2_config("test", **common), 1),
            "bert": (tt.bert_config("test", **common), 1),
            "moe": (tt.gpt2_config("test", num_experts=4, **common), 2)}


def trainer_config(cfg, seq, accum):
    return LMTrainerConfig(global_batch_size=GLOBAL_BATCH, seq_len=seq,
                           warmup_steps=2, masked_lm=not cfg.causal,
                           accum_steps=accum)


def batches(cfg, steps, seq, seed=1):
    """`steps` seeded numpy global batches: (tokens, targets) for a
    causal model; for BERT (inputs with the mask id vocab - 1 at the
    scored slots, the original tokens, the f32 mask), 15% of each row's
    valid prefix scored, the valid lengths drawn in [seq / 8, seq]."""
    rs = np.random.RandomState(seed)
    V, out = cfg.vocab_size, []
    for _ in range(steps):
        toks = rs.randint(0, V - 1, (GLOBAL_BATCH, seq + 1))
        if cfg.causal:
            out.append((toks[:, :-1], toks[:, 1:]))
            continue
        toks = toks[:, :-1]
        valid = np.arange(seq)[None] < rs.randint(seq // 8, seq + 1,
                                                  (GLOBAL_BATCH, 1))
        mask = (rs.random_sample(toks.shape) < 0.15) & valid
        out.append((np.where(mask, V - 1, toks), toks,
                    mask.astype(np.float32)))
    return out


def _flat(t):
    return t.detach().float().cpu().clone()


def train_lm(name, rank, world, device, steps, size="test", fault=None,
             weights=None, mesh=None):
    """One parity model trained `steps` steps on this rank's rows (all
    rows in one process); a dict of its flat params before and after,
    moments, losses and drop rates, on the CPU."""
    cfg, accum = parity_configs(size)[name]
    seq = SEQ[size]
    trainer = LMTrainer(cfg, trainer_config(cfg, seq, accum), device=device,
                        mesh=mesh)
    state = trainer.init_state(0, state_dict=weights)
    if fault == "per-rank-denominator":
        trainer._mask_total = \
            lambda mask: torch.clamp(mask.sum(), min=1.0) * world
    if fault == "per-rank-routing":
        for m in state.model.modules():
            if isinstance(m, tmoe.MoeMlp):
                m.mesh = None
    # H16's fault: consecutive rows, then cut into microbatches
    share_accum = 1 if fault == "rows-then-microbatches" else accum
    pos = trainer.mesh.position()
    start = _flat(state.params)
    losses, rates, counts = [], [], []
    for batch in batches(cfg, steps, seq):
        mine = [torch.from_numpy(np.ascontiguousarray(
            rank_share(a, pos, world, share_accum))).to(device)
            for a in batch]
        if len(mine) == 3:        # H13: this rank's count, the normaliser's
            counts.append((float(mine[2].sum()),
                           float(trainer._mask_total(mine[2]))))
        state, m = trainer.train_step(state, *mine)
        losses.append(float(m["loss"]))
        rates.extend(float(r) for r in state.model.moe_drop_rates())
    return {"start": start, "params": _flat(state.params),
            "mu": _flat(state.opt.mu), "nu": _flat(state.opt.nu),
            "count": int(state.opt.count), "losses": losses,
            "drop_rates": rates, "mask_counts": counts}


def routing_check(rank, world, device, mesh=None, seed=0):
    """H14 on one MoE layer (4 experts, E 32, mlp 64, f32, capacity
    factor 0.75, so that tokens drop) over a seeded [4, 16, 32] global
    input, this rank's
    rows: the capacity, every (token, choice) pair's queue position and
    kept flag, the output, the aux loss (this rank's share) and the
    drop rate."""
    gen = torch.Generator().manual_seed(seed)
    layer = tmoe.MoeMlp(4, 32, 64, capacity_factor=0.75,
                        dtype=torch.float32)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    layer = layer.to(device)
    layer.mesh = mesh
    x = torch.randn(4, 16, 32, generator=gen)
    mine = rank_share(x, mesh.position() if mesh else 0, world).to(device)
    out, aux = layer(mine)
    tokens = mine.reshape(-1, 32)
    probs = torch.softmax(tokens @ layer.router.weight.t(), -1)
    _, idx = tmoe.route(probs, layer.top_k)
    offset, _, _, W = tmoe.routing(idx, 4, mesh)
    cap = tmoe.capacity(tokens.shape[0] * W, layer.top_k, 4, 0.75)
    slot, keep = tmoe.slots(idx, 4, cap, offset)
    return {"cap": cap, "slot": slot.cpu(), "keep": keep.cpu(),
            "out": _flat(out), "aux": float(aux.detach()),
            "drop_rate": float(layer.drop_rate)}


def guard_check(rank, world, device, train_dir, mesh=None):
    """H15: a non-finite loss planted on the last rank only. (1) One
    step: every rank must skip it (same update count, params unchanged,
    streak 1). (2) trainer.benchmark with the resilience context
    (divergence_k 2, a checkpoint at step 1 in `train_dir`), the loss
    poisoned on the last rank for the first window's two steps: every
    rank must roll back at that window's fetch."""
    from mpi_operator_tpu_torch.data import TokenStream
    from mpi_operator_tpu_torch.train import checkpoint as ck
    from mpi_operator_tpu_torch.train import resilience as tres

    cfg, _ = parity_configs("test")["gpt2"]
    trainer = LMTrainer(cfg, LMTrainerConfig(
        global_batch_size=GLOBAL_BATCH, seq_len=16, warmup_steps=1,
        log_every=2), device=device, mesh=mesh)
    state = trainer.init_state(0)
    poison = {"calls": set()}
    loss_fn = trainer._loss
    calls = [0]

    def planted(*a, **kw):
        calls[0] += 1
        loss, logits = loss_fn(*a, **kw)
        if rank == world - 1 and calls[0] in poison["calls"]:
            loss = loss * float("nan")
        return loss, logits
    trainer._loss = planted
    stream = TokenStream(GLOBAL_BATCH, 16, cfg.vocab_size, device=device)
    state, _ = trainer.train_step(state, *next(stream))       # call 1
    before = _flat(state.params)
    poison["calls"] = {2}
    state, m = trainer.train_step(state, *next(stream))       # call 2
    skip = {"loss": float(m["loss"]), "streak": int(m["nonfinite_streak"]),
            "count": int(state.opt.count),
            "unchanged": bool(torch.equal(before, _flat(state.params)))}
    ck.save_checkpoint(train_dir, state)                      # step 2
    # benchmark: warmup (call 3), then the first window (calls 4, 5)
    poison["calls"] = {4, 5}
    logs = []
    ctx = tres.ResilienceContext(
        tres.ResilienceConfig(train_dir=train_dir, divergence_k=2),
        log=logs.append)
    state, bm = trainer.benchmark(state, stream, num_steps=4,
                                  warmup_steps=1, log=logs.append,
                                  resilience=ctx)
    return {"skip": skip,
            "rolled_back": any("divergence rollback" in s for s in logs),
            "step": state.step, "params": _flat(state.params),
            "losses": bm["step_losses"]}


def hierarchical_check(rank, mesh, device):
    """hierarchical_allreduce_mean against the flat mean over the mesh,
    for an odd length (33 x 7) that does not split over the in-slice
    ranks: the largest difference, and the flat mean."""
    from mpi_operator_tpu_torch.parallel import collectives as col
    x = torch.randn(33, 7, generator=torch.Generator().manual_seed(rank))
    x = x.to(device)
    flat = col.allreduce_mean(x, mesh)
    hier = col.hierarchical_allreduce_mean(x, mesh)
    return {"max_diff": float((hier - flat).abs().max()),
            "flat": flat.cpu()}


def run(rank, world, device, steps, size="test", only=MODELS, faults=False,
        checks=False, weights=None, train_dir=None, mesh=None):
    """Everything this rank computes: {key: result} (a single process
    when world is 1)."""
    weights = weights or {}
    out = {}
    for name in only:
        if name == "resnet":
            import torch_ddp_worker as image
            chip = size.startswith("chip")
            out["resnet"] = image.train(
                rank, world, device, steps, 64 if chip else 32,
                "chip" if chip else "test", only=["resnet"],
                mesh=mesh)["resnet"]
            continue
        out[name] = train_lm(name, rank, world, device, steps, size,
                             weights=weights.get(name), mesh=mesh)
        for model, fault in FAULTS if faults else ():
            if model == name:
                out[f"{name}/{fault}"] = train_lm(
                    name, rank, world, device, steps, size, fault=fault,
                    weights=weights.get(name), mesh=mesh)
    if checks:
        out["routing"] = routing_check(rank, world, device, mesh)
        if world > 1:
            out["guard"] = guard_check(rank, world, device, train_dir, mesh)
            out["hierarchical"] = hierarchical_check(rank, mesh, device)
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gang(world, out, *extra, slices=1, device="cpu", timeout=600):
    """This script as `world` ranks over `slices` slices, one launch.py
    a slice (TPU_SLOTS_PER_WORKER = world / slices; a slice's cards its
    own when there is a card a rank), joined through the bootstrap;
    returns ([each rank's results], seconds). Raises with the
    ranks' stderr if a slice exits non-zero."""
    import time
    port, per = free_port(), world // slices
    env = dict(os.environ, TPU_SLOTS_PER_WORKER=str(per),
               OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    for k in ("TPU_WORKER_ID", "TPU_LOCAL_RANK", "TPU_FAULT_INJECT"):
        env.pop(k, None)
    # with a card a rank, each slice sees its own cards, as each slice's
    # hosts would (on one card the ranks share it over gloo)
    cards = os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",") \
        if os.environ.get("CUDA_VISIBLE_DEVICES") \
        else [str(i) for i in range(torch.cuda.device_count())]
    t0 = time.perf_counter()
    procs = []
    for s in range(slices):
        if slices > 1:
            env.update(TPU_NUM_SLICES=str(slices), TPU_SLICE_ID=str(s),
                       TPU_WORKERS_PER_SLICE="1")
            if device == "cuda" and len(cards) >= world:
                env["CUDA_VISIBLE_DEVICES"] = ",".join(
                    cards[s * per:(s + 1) * per])
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mpi_operator_tpu_torch.bootstrap.launch",
             "--", sys.executable, os.path.abspath(__file__), str(world),
             str(port), out, "--device", device, *extra],
            cwd=ROOT, env=dict(env), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode:
            errs.append(f"rc {p.returncode}: {err[-3000:]}")
    if errs:
        raise RuntimeError(f"gang of {world} failed: " + "\n".join(errs))
    secs = time.perf_counter() - t0
    return [torch.load(f"{out}-{r}.pt") for r in range(world)], secs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("world", type=int)
    parser.add_argument("port", type=int)
    parser.add_argument("out")
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--size", default="test",
                        choices=["test", "chip", "chip-bf16"])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--only", default=",".join(MODELS))
    parser.add_argument("--faults", action="store_true")
    parser.add_argument("--checks", action="store_true")
    parser.add_argument("--weights", default=None)
    parser.add_argument("--train-dir", default=None)
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from mpi_operator_tpu_torch.bootstrap import hybrid_mesh, initialize
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    slices = int(os.environ.get("TPU_NUM_SLICES", "1") or "1")
    env = dict(os.environ, TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{args.port}",
               TPU_NUM_PROCESSES=str(args.world))
    host = (f"lm-worker-s{os.environ['TPU_SLICE_ID']}-0" if slices > 1
            else "lm-worker-0")
    cpu = args.device == "cpu"
    info = initialize(env, hostname=host, device="cpu" if cpu else None)
    if args.world == 1:
        # initialize() joins no group for one process; its rendezvous
        # joins one here, so the gang of one runs the collectives (NCCL
        # on the card)
        from mpi_operator_tpu_torch.bootstrap import bootstrap
        bootstrap._initialize_distributed(
            info, env, backend=bootstrap.dist_backend(info, cpu))
    mesh = hybrid_mesh(info)
    device = (torch.device("cpu") if cpu
              else torch.device("cuda", torch.cuda.current_device()))
    weights = torch.load(args.weights) if args.weights else None
    out = run(info.process_id, args.world, device, args.steps, args.size,
              only=args.only.split(","), faults=args.faults,
              checks=args.checks, weights=weights, train_dir=args.train_dir,
              mesh=mesh)
    out["backend"] = dist.get_backend()
    out["mesh"] = dict(mesh.shape)
    torch.save(out, f"{args.out}-{info.process_id}.pt")
    dist.destroy_process_group()
    return 0


def rel(a, b) -> float:
    """||a - b|| / ||b|| (0 when both are 0)."""
    den = float(b.norm())
    return float((a - b).norm()) / den if den else float((a - b).norm())


def compare(got, want) -> dict:
    """The relative errors of a gang's model against one process's: the
    update (params after minus before), mu and nu; and the largest
    difference of the step losses."""
    return {"update": rel(got["params"] - got["start"],
                          want["params"] - want["start"]),
            "mu": rel(got["mu"], want["mu"]), "nu": rel(got["nu"], want["nu"]),
            "loss": max(abs(a - b) for a, b in zip(got["losses"],
                                                   want["losses"]))}


if __name__ == "__main__":
    sys.exit(main())
