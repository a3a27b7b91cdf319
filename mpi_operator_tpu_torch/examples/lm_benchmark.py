"""LM training and decode benchmarks: the reference's
`mpi_operator_tpu/examples/lm_benchmark.py::run_lm_benchmark` (over a
dcn x dp x ep x sp x tp mesh of the gang's ranks, one process without a
gang), its `run_generate_benchmark`, and its CLI.

`run_lm_benchmark(workload="gpt2", size="medium", batch_per_device=16,
seq_len=512)` builds the model with max_len = max(seq_len, 32), an
LMTrainer over it on the mesh of every rank of the process group
(`num_slices` of them on dcn, `tp`, `ep` and `sp` as asked, dp filling
what they leave, with the reference's checks) and the step-keyed
synthetic TokenStream of the global batch, batch_per_device x ranks
rows of which each rank keeps its share (its place on the batch axes,
and under sp its sequence shard; or, with `data_dir`, the
`<stem>_tokens.npy` shards through NpyTokenDataset), runs
`trainer.benchmark` and, with `eval_steps`, `evaluate` on the batches
that follow. `sp` > 1 sets attention "ring" where it is "auto";
`tp_overlap` runs the tp projections and the fused loss as ring
collective-matmuls (`tp_ring` "uni" or "bidir"). `workload="bert"` trains the MaskedLM on the MLM
objective (MLM_MASK_RATE of the tokens replaced by the mask id, scored
against the originals); `moe_experts` turns every second FFN into a
top-2 mixture of experts (`moe_dropless`: every expert runs every
token), and after training one forward on a fresh batch reads the MoE
layers' mean drop rate into `moe_drop_rate`; `remat`/`remat_policy`
checkpoint each block. It runs on the CUDA card unless `device="cpu"`.

`run_generate_benchmark(size="medium", family="gpt2")` times
`models.generate` (prefill plus `new_tokens` decode steps, K4 on the
card) over bf16 weights cast once, and reports new tokens/s and MBU
against the card's HBM bandwidth.

Preemption contract (the reference's): with `train_dir` the run resumes
from the newest intact checkpoint there, writes one every `ckpt_every`
steps (async), drains on SIGTERM/SIGUSR1 with a blocking emergency
checkpoint and `Preempted` (the CLI exits 215, retryable), and writes
its events to `<train_dir>/events.jsonl` unless `event_log`/`events`
say otherwise. The synthetic stream is step-keyed, so a run killed at
step N and resumed trains on exactly the batches the uninterrupted run
would have, and `stop_at_step` makes it finish at the same global step.

    python -m mpi_operator_tpu_torch.examples.lm_benchmark --size medium \\
        --batch-per-device 16 --train-dir /ckpt --ckpt-every 100

`run_vit_benchmark(size="b16", batch_per_device=32, image_size=224)` is
the reference's ViT leg: the image Trainer (train/trainer.py) over
`create_vit`, with the same resilient wiring. The CLI runs every
benchmark here, alone or as a gang of processes through the bootstrap.

`pp` > 1 trains over pipeline stages instead (the reference's pp
branch): a PipelineLMTrainer (train/pp_trainer.py) over the mesh (pp,
tp, ep, sp as asked, `num_slices` on dcn, dp filling the rest) under
`pp_schedule` "gpipe" or "1f1b" with `pp_interleave` virtual stages a
rank, M = 4 x pp microbatches, on the same step-keyed stream (each rank
its share of every microbatch), resuming from and checkpointing into
`train_dir` by canonical parameter names (any schedule resumes any
other's checkpoint at the same pp, tp and ep). It refuses what the
reference refuses: `accum_steps` > 1, MoE under 1F1B, `tp_overlap`, and
device counts that pp x tp x ep x sp x slices does not divide.

`run_hfta_benchmark(k=8)` is the reference's fused sweep (`--hfta K`):
K replicas of a gpt2 or llama config trained by one HFTATrainer step
(train/hfta.py) over the data-parallel mesh, each on its own
batch_per_device x ranks rows a step of a step-keyed stream keyed by
(seed, step, replica), with per-replica learning rates (`--hfta-lrs`)
and init seeds (`--hfta-seeds`); it reports the aggregate tokens/s.
`TPU_RESHARD_RESTORE=1` resumes every entry point through the resharding
restore (train/checkpoint.py restore_resharded): a checkpoint written
over another split or world size.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..data.synthetic import TokenStream, mesh_share, synthetic_token_batch
from ..models.transformer import lm_config
from ..parallel.mesh import MeshConfig, data_parallel_mesh, make_mesh
from ..train.lm_trainer import LMTrainer, LMTrainerConfig, LMTrainState
from ..utils.device import DeviceLike, rank_and_world, resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def lm_mesh(tp: int = 1, ep: int = 1, sp: int = 1, num_slices: int = 1,
            moe_experts: int = 0, pp: int = 1):
    """The benchmark's mesh over every rank of the process group (one
    process without one): pp, tp, ep and sp as asked, `num_slices` on
    dcn, dp filling what they leave, with the reference's checks."""
    n = rank_and_world()[1]
    if pp > 1:
        if n % (pp * tp * ep * sp * num_slices):
            raise ValueError(f"{n} devices not divisible by pp={pp} × "
                             f"tp={tp} × ep={ep} × sp={sp} × "
                             f"slices={num_slices}")
        return make_mesh(MeshConfig(
            pp=pp, tp=tp, ep=ep, sp=sp,
            dp=n // (pp * tp * ep * sp * num_slices), dcn=num_slices))
    if ep > 1 and not moe_experts:
        raise ValueError("--ep needs --moe-experts (nothing to shard)")
    if moe_experts and moe_experts % ep:
        # the sharding rules REPLICATE a non-divisible expert dim, which
        # would mislabel a data-parallel run as expert-parallel
        raise ValueError(f"--moe-experts={moe_experts} must be divisible "
                         f"by --ep={ep}")
    if tp == ep == sp == 1:
        return data_parallel_mesh(num_slices)
    if n % (tp * ep * sp * num_slices):
        raise ValueError(f"{n} devices not divisible by tp={tp} × ep={ep} "
                         f"× sp={sp} × slices={num_slices}")
    return make_mesh(MeshConfig(dp=n // (tp * ep * sp * num_slices), tp=tp,
                                ep=ep, sp=sp, dcn=num_slices))


def _worker_telemetry(metrics_port, event_log, train_dir, events, log):
    """The run's WorkerTelemetry: a /metrics server when `metrics_port`
    is given (0 = ephemeral), an event log at `event_log` or, when a
    train dir exists, `<train_dir>/events.jsonl`. `events` borrows an
    already-open log (ownership stays with the caller). Returns
    (telemetry, owns_events)."""
    from ..telemetry import EventLog, WorkerTelemetry

    owns = events is None
    if events is None:
        path = event_log or (os.path.join(train_dir, "events.jsonl")
                             if train_dir else None)
        events = EventLog(path) if path else None
    if events is not None and os.environ.get("TPU_PACK_GROUP"):
        # packed jobs share one worker process (and one event file):
        # stamp the pack group into every record
        events = events.bind(pack_group=os.environ["TPU_PACK_GROUP"])
    wtel = WorkerTelemetry(events=events)
    if metrics_port is not None:
        log(f"worker /metrics listening on port "
            f"{wtel.serve(port=metrics_port).port}")
    return wtel, owns and events is not None


def run_lm_benchmark(
    workload: str = "gpt2",
    size: Optional[str] = None,
    batch_per_device: int = 8,
    seq_len: int = 512,
    num_steps: int = 50,
    warmup_steps: int = 5,
    eval_steps: int = 0,
    dtype_name: str = "bfloat16",
    tp: int = 1,
    pp: int = 1,
    pp_schedule: str = "gpipe",
    pp_interleave: int = 1,
    sp: int = 1,
    ep: int = 1,
    num_slices: int = 1,
    tp_overlap: bool = False,
    tp_ring: str = "uni",
    attention: str = "auto",
    remat: bool = False,
    remat_policy: str = "none",
    moe_experts: int = 0,
    moe_dropless: bool = False,
    num_layers: Optional[int] = None,
    fused_xent: bool = False,
    accum_steps: int = 1,
    data_dir: Optional[str] = None,
    train_dir: Optional[str] = None,
    ckpt_every: int = 0,
    ckpt_keep: int = 0,
    step_deadline: float = 0.0,
    divergence_k: int = 3,
    stop_check_every: Optional[int] = None,
    stop_at_step: Optional[int] = None,
    lr_schedule: str = "linear",
    decay_steps: int = 10_000,
    lr: Optional[float] = None,
    lr_warmup_steps: Optional[int] = None,
    profile_dir: Optional[str] = None,
    metrics_port: Optional[int] = None,
    event_log: Optional[str] = None,
    events=None,
    device: DeviceLike = None,
    log: Callable[[str], None] = print,
) -> Tuple[LMTrainState, Dict[str, object]]:
    """GPT-2 / llama / BERT token-stream benchmark over the mesh of the
    process group's ranks (`lm_mesh`: `num_slices` of them on dcn, tp, ep
    and sp as asked; one process when no group was joined), at a global
    batch of batch_per_device x ranks. Parameters from seed 0 and the synthetic
    stream's global batches from seed 1, step-keyed, as the reference's
    PRNGKey(0) and PRNGKey(1); the MoE drop-rate probe's global batch
    from seed 7 (the reference's PRNGKey(7)).
    Returns (state, metrics); raises Preempted after a drain (the
    emergency checkpoint committed) and DivergenceError when a rollback
    cannot help."""
    from ..train.checkpoint import (last_restore_info, maybe_resume,
                                    maybe_save, periodic_saver,
                                    wait_for_checkpoints)
    from ..train.resilience import ResilienceConfig, ResilienceContext

    if workload not in ("gpt2", "llama", "bert"):
        raise ValueError(f"workload={workload!r}: run_lm_benchmark trains "
                         f"gpt2, llama and bert; vit trains through the "
                         f"image Trainer, run_vit_benchmark (ROADMAP.md "
                         f"step 7)")
    if moe_dropless and not moe_experts:
        raise ValueError("--moe-dropless needs --moe-experts (no MoE is "
                         "built without it)")
    if sp > 1:
        # context parallelism: seq sharded over sp, attention rings the
        # K/V shards (parallel/ring_attention.py)
        if seq_len % sp:
            raise ValueError(f"--seq-len={seq_len} must be divisible by "
                             f"--sp={sp}")
        if attention == "auto":
            attention = "ring"
        elif attention != "ring":
            raise ValueError(f"--sp={sp} shards the sequence axis; "
                             f"--attention must be 'ring' (got "
                             f"{attention!r})")
    if tp_overlap:
        if tp <= 1:
            raise ValueError("--tp-overlap needs --tp > 1 (nothing to "
                             "ring over)")
        if pp > 1:
            raise ValueError("--tp-overlap composes with the flat trainer "
                             "only (the pipeline's stage bodies run tp "
                             "through the all-reduce layout)")
    elif tp_ring != "uni":
        raise ValueError("--tp-ring=bidir only changes the overlap ring "
                         "collectives; it needs --tp-overlap")
    if dtype_name not in _DTYPES:
        raise ValueError(f"dtype_name={dtype_name!r}; expected one of "
                         f"{sorted(_DTYPES)}")
    masked = workload == "bert"
    if fused_xent and masked:
        raise ValueError("--fused-xent supports the causal LM only (BERT's "
                         "MLM head has extra layers before the tied "
                         "decoder)")
    dev = resolve_device(device)
    overrides = dict(dtype=_DTYPES[dtype_name], attention=attention,
                     max_len=max(seq_len, 32), remat=remat,
                     remat_policy=remat_policy)
    if moe_experts:
        overrides.update(num_experts=moe_experts, moe_dropless=moe_dropless)
    if num_layers:
        overrides["num_layers"] = num_layers
    if tp_overlap:
        overrides.update(tp_overlap=True, tp_ring=tp_ring)
    cfg = lm_config(f"{workload}-{size}" if size else workload, **overrides)
    if pp > 1:
        if moe_experts and pp_schedule != "gpipe":
            raise ValueError("--pp with --moe-experts composes with "
                             "--pp-schedule gpipe only (1F1B stage bodies "
                             "are dense)")
        if accum_steps > 1:
            raise ValueError("--accum-steps is redundant with --pp: the "
                             "pipeline trainer already streams "
                             "microbatches; drop the flag")
    mesh = lm_mesh(tp, ep, sp, num_slices, moe_experts, pp)
    global_batch = batch_per_device * mesh.size
    opt_overrides = {}
    if lr is not None:
        opt_overrides["learning_rate"] = lr
    if lr_warmup_steps is not None:
        opt_overrides["warmup_steps"] = lr_warmup_steps
    tcfg = LMTrainerConfig(global_batch_size=global_batch,
                           seq_len=seq_len, masked_lm=masked,
                           fused_xent=fused_xent,
                           accum_steps=accum_steps, lr_schedule=lr_schedule,
                           decay_steps=decay_steps, **opt_overrides)
    if pp > 1:
        from ..train.pp_trainer import PipelineLMTrainer
        trainer = PipelineLMTrainer(cfg, mesh, tcfg, schedule=pp_schedule,
                                    interleave=pp_interleave, device=dev)
        micro = trainer.num_microbatches
    else:
        trainer = LMTrainer(cfg, tcfg, device=dev, mesh=mesh)
        micro = accum_steps
    state = trainer.init_state(0)

    wtel, owns_events = _worker_telemetry(metrics_port, event_log,
                                          train_dir, events, log)
    resilience = ResilienceContext(
        ResilienceConfig.from_env(train_dir=train_dir,
                                  divergence_k=divergence_k,
                                  step_deadline=step_deadline,
                                  stop_check_every=stop_check_every),
        log=log, events=wtel.events, telemetry=wtel.train)
    # entering fires the corrupt-latest-checkpoint fault (if injected)
    # BEFORE the resume below, so the fallback path is what gets tested
    resilience.__enter__()
    try:
        state = maybe_resume(train_dir, state, log)
        resumed_step = state.step
        info = last_restore_info() if resumed_step else {}
        resilience.record_restore(resumed_step, path=info.get("path"),
                                  seconds=info.get("seconds"),
                                  leaves=info.get("leaves"),
                                  resharded=info.get("resharded"))
        if stop_at_step is not None:
            # finish at the same GLOBAL step the uninterrupted run would
            # have: warmup batches advance the step counter too
            remaining = stop_at_step - resumed_step - max(1, warmup_steps)
            if remaining < 1:
                log(f"stop_at_step={stop_at_step} already reached at "
                    f"resumed step {resumed_step}; running 1 step")
            num_steps = max(1, remaining)
        if data_dir:
            from ..data.tokenstream import (NpyTokenDataset,
                                            mlm_host_transform)
            stream = NpyTokenDataset(
                data_dir, global_batch, seq_len, device=dev,
                vocab_size=cfg.vocab_size,
                host_transform=(mlm_host_transform(cfg.vocab_size)
                                if masked else None),
                accum_steps=micro, mesh=mesh)
        else:
            # under pp each rank keeps its share of every microbatch (H32)
            stream = TokenStream(global_batch, seq_len, cfg.vocab_size,
                                 seed=1, start=resumed_step, device=dev,
                                 masked_lm=masked, accum_steps=micro,
                                 mesh=mesh)
        try:
            extra = {} if pp > 1 else dict(profile_dir=profile_dir)
            state, metrics = trainer.benchmark(
                state, stream, num_steps=num_steps,
                warmup_steps=warmup_steps, log=log,
                step_hook=periodic_saver(train_dir, ckpt_every, log,
                                         keep_last=ckpt_keep,
                                         resilience=resilience),
                resilience=resilience, telemetry=wtel.train, **extra)
            if eval_steps:
                # evaluation continues the stream past the trained batches
                ev = trainer.evaluate(state, stream, num_batches=eval_steps)
                metrics.update(ev)
                log(f"val_loss: {ev['val_loss']:.3f}  perplexity: "
                    f"{ev['perplexity']:.1f}  ({eval_steps} batches)")
        finally:
            if data_dir:
                stream.close()
        # non-blocking final save: the write overlaps the teardown; the
        # join below makes it durable before return
        maybe_save(train_dir, state, log, block=False)
        if wtel.events is not None:
            # the terminal frontier marker the goodput ledger reads
            from ..telemetry import events as tev
            wtel.events.emit(tev.RUN_COMPLETE, step=state.step)
    finally:
        resilience.__exit__(None, None, None)
        wtel.close(close_events=owns_events)
    if moe_experts and pp == 1:
        rate = _moe_drop_rate(state.model, global_batch, seq_len, dev, mesh)
        metrics["moe_drop_rate"] = rate
        log(f"moe drop rate: {rate:.3f}")
    wait_for_checkpoints()
    return state, metrics


def run_hfta_benchmark(
    workload: str = "gpt2",
    size: Optional[str] = None,
    batch_per_device: int = 8,
    seq_len: int = 512,
    num_steps: int = 50,
    warmup_steps: int = 5,
    dtype_name: str = "bfloat16",
    k: int = 8,
    learning_rates=None,
    seeds=None,
    num_layers: Optional[int] = None,
    attention: str = "auto",
    num_slices: int = 1,
    train_dir: Optional[str] = None,
    lr_schedule: str = "linear",
    decay_steps: int = 10_000,
    lr: Optional[float] = None,
    lr_warmup_steps: Optional[int] = None,
    metrics_port: Optional[int] = None,
    event_log: Optional[str] = None,
    events=None,
    device: DeviceLike = None,
    log: Callable[[str], None] = print,
) -> Tuple[object, Dict[str, object]]:
    """The horizontally fused sweep (the reference's run_hfta_benchmark):
    K replicas of the gpt2 or llama config trained by ONE HFTATrainer
    step (train/hfta.py) over the data-parallel mesh of the process
    group's ranks. Each replica trains on its own batch_per_device x
    ranks rows a step, so a fused step does K times the solo step's
    token work and the aggregate tokens/s compares with K solo runs. The
    stream is step-keyed by (seed 1, step, replica) (FusedTokenStream),
    so a resumed fused run replays the same tokens. Resumes from and
    writes its final checkpoint to `train_dir`. Runs on the CUDA card
    unless `device="cpu"`. Returns (state, metrics)."""
    from ..train.checkpoint import (maybe_resume, maybe_save,
                                    wait_for_checkpoints)
    from ..train.hfta import FusedTokenStream, HFTAHyperparams, HFTATrainer

    if workload not in ("gpt2", "llama"):
        raise ValueError(f"--hfta fuses causal-LM workloads only "
                         f"(got {workload!r})")
    if dtype_name not in _DTYPES:
        raise ValueError(f"dtype_name={dtype_name!r}; expected one of "
                         f"{sorted(_DTYPES)}")
    dev = resolve_device(device)
    mesh = data_parallel_mesh(num_slices)
    name = f"{workload}-{size}" if size else workload
    overrides = dict(dtype=_DTYPES[dtype_name], attention=attention,
                     max_len=max(seq_len, 32))
    if num_layers:
        overrides["num_layers"] = num_layers
    cfg = lm_config(name, **overrides)
    global_batch = batch_per_device * mesh.size      # a replica's batch
    opt_overrides = {}
    if lr is not None:
        opt_overrides["learning_rate"] = lr
    if lr_warmup_steps is not None:
        opt_overrides["warmup_steps"] = lr_warmup_steps
    tcfg = LMTrainerConfig(global_batch_size=global_batch, seq_len=seq_len,
                           lr_schedule=lr_schedule, decay_steps=decay_steps,
                           **opt_overrides)
    hp = HFTAHyperparams.sweep(k, tcfg, learning_rates=learning_rates,
                               seeds=seeds)
    trainer = HFTATrainer(cfg, tcfg, hp, device=dev, mesh=mesh)
    log(f"hfta: fusing K={k} x {name} replicas, "
        f"lrs={list(hp.learning_rates)} seeds={list(hp.seeds)}")
    wtel, owns_events = _worker_telemetry(metrics_port, event_log,
                                          train_dir, events, log)
    try:
        state = maybe_resume(train_dir, trainer.init_state(), log)
        stream = FusedTokenStream(trainer, global_batch, seq_len,
                                  cfg.vocab_size, seed=1, start=state.step)
        state, metrics = trainer.benchmark(
            state, stream, num_steps=num_steps, warmup_steps=warmup_steps,
            log=log, registry=wtel.registry, events=wtel.events)
        maybe_save(train_dir, state, log, block=False)
        if wtel.events is not None:
            from ..telemetry import events as tev
            wtel.events.emit(tev.RUN_COMPLETE, step=state.step)
    finally:
        wtel.close(close_events=owns_events)
    wait_for_checkpoints()
    metrics["replica_learning_rates"] = list(hp.learning_rates)
    metrics["replica_seeds"] = list(hp.seeds)
    return state, metrics


@torch.no_grad()
def _moe_drop_rate(model, batch: int, seq_len: int, device,
                   mesh=None) -> float:
    """The MoE layers' mean drop rate over one forward of a fresh
    synthetic global batch (seed 7), each rank running its share and the
    layers routing globally: the reference's diagnostics probe."""
    gen = torch.Generator(device=device).manual_seed(7)
    toks, _ = synthetic_token_batch(gen, batch, seq_len,
                                    model.config.vocab_size)
    model.forward_train(mesh_share(toks, mesh))
    rates = model.moe_drop_rates()
    return float(torch.stack(rates).mean())


def run_generate_benchmark(
    size: Optional[str] = None,
    batch: int = 8,
    prompt_len: int = 128,
    new_tokens: int = 128,
    num_iters: int = 8,
    dtype_name: str = "bfloat16",
    temperature: float = 0.0,
    family: str = "gpt2",
    kv_cache_dtype: Optional[str] = None,
    decode_kernel: Optional[bool] = None,
    device: DeviceLike = None,
    log: Callable[[str], None] = print,
) -> Dict[str, object]:
    """KV-cache decode throughput through `models.generate`: new tokens
    a second over `num_iters` timed calls (prefill amortized in), after
    one warm call, for the gpt2 and llama families; `kv_cache_dtype=
    "int8"` quantizes the cache. `decode_kernel` None is the decode
    kernel (K4) on the card and the dense path on the CPU. The weights
    (random, seed 0) are cast to the compute dtype once up front: decode
    re-reads every weight each step. Each timed window ends in a host
    read. MBU = the bytes a step must read (`utils/flops.py
    decode_bytes_per_step`) x steps/s over the card's HBM bandwidth
    (None where it is unknown, the CPU included). Returns the
    reference's keys."""
    from ..models import cast_params, create_lm, generate
    from ..utils import flops

    if dtype_name not in _DTYPES:
        raise ValueError(f"dtype_name={dtype_name!r}; expected one of "
                         f"{sorted(_DTYPES)}")
    dtype = _DTYPES[dtype_name]
    dev = resolve_device(device)
    if decode_kernel is None:
        decode_kernel = dev.type == "cuda"
    name = f"{family}-{size}" if size else family
    model = create_lm(name, device=dev, seed=0, dtype=dtype,
                      kv_cache_dtype=kv_cache_dtype,
                      decode_kernel=decode_kernel,
                      max_len=max(prompt_len + new_tokens, 32))
    cfg = model.config
    num_params = flops.param_count(model)
    model = cast_params(model, dtype)
    # generate() takes host prompts (it moves them to the model's device)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=torch.Generator().manual_seed(1))
    sampler = (torch.Generator(device=dev).manual_seed(2)
               if temperature > 0 else None)

    def run():
        return generate(model, prompt, new_tokens, temperature=temperature,
                        generator=sampler, device=dev)

    int(run().tokens[0, -1])                # warm: the host read waits
    t0 = time.perf_counter()
    for _ in range(num_iters):
        out = run()
    int(out.tokens[0, -1])                  # host read = the barrier
    dt = time.perf_counter() - t0
    tps = batch * new_tokens * num_iters / dt
    int8 = kv_cache_dtype == "int8"
    bytes_per_step = flops.decode_bytes_per_step(
        num_params=num_params, num_layers=cfg.num_layers,
        num_kv_heads=cfg.kv_heads, head_dim=cfg.head_dim, batch=batch,
        avg_len=prompt_len + (new_tokens + 1) / 2.0,
        param_bytes=2 if dtype_name == "bfloat16" else 4,
        kv_cache_bytes=1.0 if int8 else 2.0,
        kv_scale_bytes=4.0 if int8 else 0.0)
    mbu = flops.mbu(bytes_per_step, steps_per_sec=tps / batch, device=dev)
    log(f"generate {name}{' kv=int8' if int8 else ''}"
        f"{' kernel' if decode_kernel else ''}: batch={batch} "
        f"prompt={prompt_len} new={new_tokens}: {tps:.0f} new tokens/sec"
        + (f"  MBU {mbu:.1%}" if mbu is not None else ""))
    return {"decode_tokens_per_sec": tps,
            "tokens_per_iter": batch * new_tokens,
            "mbu": mbu,
            "decode_kernel": bool(decode_kernel),
            "decode_bytes_per_step": bytes_per_step,
            "wall_seconds": dt}


def run_vit_benchmark(
    size: str = "b16",
    batch_per_device: int = 32,
    image_size: int = 224,
    num_steps: int = 50,
    warmup_steps: int = 5,
    dtype_name: str = "bfloat16",
    num_slices: int = 1,
    num_layers: Optional[int] = None,
    attention: str = "auto",
    data_dir: Optional[str] = None,
    train_dir: Optional[str] = None,
    ckpt_every: int = 0,
    ckpt_keep: int = 0,
    step_deadline: float = 0.0,
    divergence_k: int = 3,
    stop_check_every: Optional[int] = None,
    profile_dir: Optional[str] = None,
    metrics_port: Optional[int] = None,
    event_log: Optional[str] = None,
    events=None,
    device: DeviceLike = None,
    log: Callable[[str], None] = print,
) -> Tuple[object, Dict[str, float]]:
    """ViT image benchmark (ViT-B/16 by default: S = 197 tokens at 224
    px through K1-K3 on the card) through the image Trainer
    (train/trainer.py) over the data-parallel mesh of the process
    group's ranks (`num_slices` of them on dcn), with the reference's
    resilient wiring: resume from `train_dir`, periodic
    async checkpoints, the resilience context and its events. Weights
    from seed 0, the synthetic stream from seed 1 (or npy shards in
    `data_dir`). `num_layers` cuts the depth. Runs on the CUDA card
    unless `device="cpu"`. Returns (state, metrics)."""
    from ..models.transformer import create_vit
    from ..train.checkpoint import (last_restore_info, maybe_resume,
                                    maybe_save, periodic_saver,
                                    wait_for_checkpoints)
    from ..train.resilience import ResilienceConfig, ResilienceContext
    from ..train.trainer import Trainer, TrainerConfig
    from .benchmark import image_dataset

    if dtype_name not in _DTYPES:
        raise ValueError(f"dtype_name={dtype_name!r}; expected one of "
                         f"{sorted(_DTYPES)}")
    dev = resolve_device(device)
    dtype = _DTYPES[dtype_name]
    mesh = data_parallel_mesh(num_slices)
    global_batch = batch_per_device * mesh.size
    overrides = dict(dtype=dtype, attention=attention)
    if num_layers:
        overrides["num_layers"] = num_layers
    model = create_vit(f"vit-{size}", num_classes=1000, device=dev,
                       image_size=image_size, **overrides)
    trainer = Trainer(model, TrainerConfig(
        global_batch_size=global_batch, image_size=image_size,
        num_classes=1000), device=dev, mesh=mesh)
    state = trainer.init_state(0)
    wtel, owns_events = _worker_telemetry(metrics_port, event_log,
                                          train_dir, events, log)
    resilience = ResilienceContext(
        ResilienceConfig.from_env(train_dir=train_dir,
                                  divergence_k=divergence_k,
                                  step_deadline=step_deadline,
                                  stop_check_every=stop_check_every),
        log=log, events=wtel.events, telemetry=wtel.train)
    resilience.__enter__()
    try:
        state = maybe_resume(train_dir, state, log)
        info = last_restore_info() if state.step else {}
        resilience.record_restore(state.step, path=info.get("path"),
                                  seconds=info.get("seconds"),
                                  leaves=info.get("leaves"),
                                  resharded=info.get("resharded"))
        dataset = image_dataset(data_dir, global_batch, image_size, dtype,
                                dev, start=state.step)
        try:
            state, metrics = trainer.benchmark(
                state, dataset, num_steps=num_steps,
                warmup_steps=warmup_steps, log=log,
                profile_dir=profile_dir,
                step_hook=periodic_saver(train_dir, ckpt_every, log,
                                         keep_last=ckpt_keep,
                                         resilience=resilience),
                resilience=resilience, telemetry=wtel.train)
        finally:
            if hasattr(dataset, "close"):
                dataset.close()
        maybe_save(train_dir, state, log, block=False)
        if wtel.events is not None:
            from ..telemetry import events as tev
            wtel.events.emit(tev.RUN_COMPLETE, step=state.step)
    finally:
        resilience.__exit__(None, None, None)
        wtel.close(close_events=owns_events)
    wait_for_checkpoints()        # join the overlapped final save
    return state, metrics


def main(argv=None) -> int:
    """The CLI, with the reference's flags. --hfta K runs
    run_hfta_benchmark (--hfta-lrs, --hfta-seeds: K comma-separated
    values each). --pp, --tp, --sp and --ep
    lay the gang's mesh (dp fills what they leave; --sp defaults
    --attention to ring), --pp-schedule and --pp-interleave pick the
    pipeline's schedule, --tp-overlap and --tp-ring the ring
    collective-matmuls. `--workload vit` runs
    run_vit_benchmark, the others run_lm_benchmark. A gang
    (TPU_NUM_PROCESSES > 1, or the launcher role) goes through the
    bootstrap (bootstrap/bootstrap.py), its slices (TPU_NUM_SLICES) on
    the mesh's dcn dim: the launcher waits on rank 0's status channel
    and mirrors its exit code, rank 0 serves it, only rank 0 logs. Exits 0 after a complete run, 215 after a preemption
    drain (the emergency checkpoint committed), 1 on a divergence no
    rollback could fix; a watchdog stall exits 216 and an injected hard
    death 217 from inside the run."""
    parser = argparse.ArgumentParser(prog="lm-benchmark")
    parser.add_argument("--workload", default="gpt2",
                        choices=["gpt2", "llama", "bert", "vit"])
    parser.add_argument("--size", default=None,
                        help="gpt2: test|small|medium|large|xl; llama: "
                             "test|1b|7b; bert: test|base|large; vit: "
                             "test|b16|l16")
    parser.add_argument("--batch-per-device", type=int, default=None)
    parser.add_argument("--seq-len", type=int, default=512)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--num-steps", type=int, default=50)
    parser.add_argument("--warmup-steps", type=int, default=5)
    parser.add_argument("--eval-steps", type=int, default=0)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--num-layers", type=int, default=0)
    parser.add_argument("--accum-steps", type=int, default=1)
    parser.add_argument("--fused-xent", action="store_true")
    parser.add_argument("--attention", default="auto",
                        choices=["auto", "dense", "flash", "ring"])
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree (Megatron: heads, mlp "
                             "and vocab over tp)")
    parser.add_argument("--sp", type=int, default=1,
                        help="sequence/context-parallel degree: seq axis "
                             "sharded over sp, ring attention through "
                             "K1-K3 over the sp ranks")
    parser.add_argument("--ep", type=int, default=1,
                        help="expert-parallel degree (shards MoE experts; "
                             "needs --moe-experts)")
    parser.add_argument("--pp", type=int, default=1,
                        help="pipeline stages (train/pp_trainer.py; "
                             "learned-position models)")
    parser.add_argument("--pp-schedule", default="gpipe",
                        choices=["gpipe", "1f1b"],
                        help="gpipe = every forward, then every backward; "
                             "1f1b = interleaved one-forward-one-backward "
                             "(O(pp) microbatches in flight)")
    parser.add_argument("--pp-interleave", type=int, default=1,
                        help="virtual stages a rank for --pp-schedule 1f1b "
                             "(divides the pipeline bubble)")
    parser.add_argument("--tp-overlap", action="store_true",
                        help="ring collective-matmul tp projections and "
                             "overlapped vocab-parallel loss (needs "
                             "--tp > 1 and --fused-xent for the loss)")
    parser.add_argument("--tp-ring", default="uni",
                        choices=["uni", "bidir"],
                        help="overlap ring direction: bidir splits each "
                             "shard in half and rotates the halves in "
                             "opposite directions (needs --tp-overlap)")
    parser.add_argument("--hfta", type=int, default=0,
                        help="fuse K sweep replicas into one vmapped train "
                             "step (train/hfta.py): K x the token work a "
                             "step, aggregate tokens/sec; causal LM only")
    parser.add_argument("--hfta-lrs", default=None,
                        help="comma-separated per-replica learning rates "
                             "(K values; default: the config's lr)")
    parser.add_argument("--hfta-seeds", default=None,
                        help="comma-separated per-replica init seeds (K "
                             "values; default: all 0)")
    parser.add_argument("--moe-experts", type=int, default=0,
                        help="replace every other FFN with an N-expert "
                             "top-2 MoE")
    parser.add_argument("--moe-dropless", action="store_true",
                        help="dropless MoE: every expert runs every token "
                             "(num_experts x FFN FLOPs, no dropped "
                             "tokens); default is capacity dispatch")
    parser.add_argument("--remat", action="store_true",
                        help="recompute each block's forward in the "
                             "backward (torch.utils.checkpoint)")
    parser.add_argument("--remat-policy", default="none",
                        choices=["none", "dots"],
                        help="none: recompute everything; dots: keep the "
                             "projection GEMMs' outputs")
    parser.add_argument("--data-dir", default=None,
                        help="<stem>_tokens.npy packed token shards "
                             "(data/tokenstream.py); omit for synthetic "
                             "data")
    parser.add_argument("--train-dir", default=None)
    parser.add_argument("--ckpt-every", type=int, default=0,
                        help="async checkpoint every N steps into "
                             "--train-dir (0 = final only)")
    parser.add_argument("--ckpt-keep", type=int, default=0,
                        help="retain only the newest N step_ checkpoints "
                             "(0 = keep everything)")
    parser.add_argument("--step-deadline", type=float, default=0.0,
                        help="watchdog: seconds a step may take before the "
                             "process dumps all stacks and exits 216 (0 = "
                             "off; env TPU_STEP_DEADLINE)")
    parser.add_argument("--divergence-k", type=int, default=3,
                        help="consecutive non-finite steps before rolling "
                             "back to the newest checkpoint")
    parser.add_argument("--stop-check-every", type=int, default=None,
                        help="gang stop-bit cadence in steps (more than "
                             "one process only; env TPU_STOP_CHECK_EVERY)")
    parser.add_argument("--stop-at-step", type=int, default=None,
                        help="finish at this GLOBAL step instead of "
                             "running --num-steps past the resume point")
    parser.add_argument("--lr-schedule", default="linear",
                        choices=["linear", "cosine"])
    parser.add_argument("--decay-steps", type=int, default=10_000)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--lr-warmup-steps", type=int, default=None)
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler chrome trace of the "
                             "first measurement window here")
    parser.add_argument("--metrics-port", type=int,
                        default=(int(os.environ["TPU_METRICS_PORT"])
                                 if os.environ.get("TPU_METRICS_PORT")
                                 else None),
                        help="serve worker /metrics on this port (0 = a "
                             "free port; default $TPU_METRICS_PORT)")
    parser.add_argument("--event-log", default=None,
                        help="fsync'd JSONL event log path; defaults to "
                             "<train-dir>/events.jsonl")
    parser.add_argument("--device", default=None,
                        help="'cpu' to run on the CPU (default: the card)")
    args = parser.parse_args(argv)

    from ..bootstrap import initialize
    from ..bootstrap.bootstrap import (ENV_COORDINATOR, ENV_EXPECTED_CHIPS,
                                       ENV_LAUNCHER, ENV_NUM_PROCESSES,
                                       ENV_READY_FILE, StatusServer,
                                       launcher_wait, status_port)
    from ..telemetry import EventLog
    from ..train.resilience import DivergenceError, Preempted

    # the event log opens BEFORE the rendezvous so the bootstrap's retry
    # loop can record init_retry events; the benchmark borrows it
    ev_path = args.event_log or (
        os.path.join(args.train_dir, "events.jsonl")
        if args.train_dir else None)
    events = EventLog(ev_path) if ev_path else None
    procs = int(os.environ.get(ENV_NUM_PROCESSES, "1") or "1")
    # under the controller's env contract even a one-process job
    # bootstraps: device_check writes the readiness marker the gate waits
    # on, and rank 0's status channel is what the launcher polls
    managed = any(os.environ.get(k) for k in (
        ENV_COORDINATOR, ENV_READY_FILE, ENV_EXPECTED_CHIPS))
    gang = procs > 1 or os.environ.get(ENV_LAUNCHER) == "1" or managed
    info = initialize(events=events, device=args.device) if gang else None
    if info is not None and info.is_launcher:
        if events is not None:
            events.close()
        print("launcher: waiting on rank-0 status channel", flush=True)
        return launcher_wait(info, port=status_port())
    coordinator = info is None or info.is_coordinator
    num_slices = info.num_slices if info is not None else 1
    status = StatusServer(status_port()) if gang and coordinator else None
    log = print if coordinator else (lambda s: None)   # noqa: E731
    exit_code = 1
    try:
        if args.workload == "vit":
            _state, metrics = run_vit_benchmark(
                size=args.size or "b16",
                batch_per_device=args.batch_per_device or 32,
                image_size=args.image_size, num_steps=args.num_steps,
                warmup_steps=args.warmup_steps, dtype_name=args.dtype,
                num_slices=num_slices, num_layers=args.num_layers or None,
                attention=args.attention, data_dir=args.data_dir,
                train_dir=args.train_dir, ckpt_every=args.ckpt_every,
                ckpt_keep=args.ckpt_keep, step_deadline=args.step_deadline,
                divergence_k=args.divergence_k,
                stop_check_every=args.stop_check_every,
                profile_dir=args.profile_dir,
                metrics_port=args.metrics_port, events=events,
                device=args.device, log=log)
            headline = {"metric": "vit_images_per_sec",
                        "value": round(metrics["images_per_sec"], 2),
                        "unit": "images/sec"}
        elif args.hfta:
            _state, metrics = run_hfta_benchmark(
                workload=args.workload, size=args.size,
                batch_per_device=args.batch_per_device or 8,
                seq_len=args.seq_len, num_steps=args.num_steps,
                warmup_steps=args.warmup_steps, dtype_name=args.dtype,
                k=args.hfta,
                learning_rates=[float(x) for x in args.hfta_lrs.split(",")]
                if args.hfta_lrs else None,
                seeds=[int(x) for x in args.hfta_seeds.split(",")]
                if args.hfta_seeds else None,
                num_layers=args.num_layers or None, attention=args.attention,
                num_slices=num_slices, train_dir=args.train_dir,
                lr_schedule=args.lr_schedule, decay_steps=args.decay_steps,
                lr=args.lr, lr_warmup_steps=args.lr_warmup_steps,
                metrics_port=args.metrics_port, events=events,
                device=args.device, log=log)
            headline = {"metric":
                        f"{args.workload}_hfta{args.hfta}_tokens_per_sec",
                        "value": round(metrics["tokens_per_sec"], 0),
                        "unit": "tokens/sec (aggregate)",
                        "final_loss": [round(float(x), 6)
                                       for x in metrics["final_loss"]]}
        else:
            _state, metrics = run_lm_benchmark(
                workload=args.workload, size=args.size,
                batch_per_device=args.batch_per_device or 8,
                seq_len=args.seq_len, num_steps=args.num_steps,
                warmup_steps=args.warmup_steps, eval_steps=args.eval_steps,
                dtype_name=args.dtype, num_layers=args.num_layers or None,
                tp=args.tp, pp=args.pp, pp_schedule=args.pp_schedule,
                pp_interleave=args.pp_interleave, sp=args.sp, ep=args.ep,
                num_slices=num_slices, tp_overlap=args.tp_overlap,
                tp_ring=args.tp_ring,
                accum_steps=args.accum_steps, fused_xent=args.fused_xent,
                attention=args.attention, remat=args.remat,
                remat_policy=args.remat_policy,
                moe_experts=args.moe_experts,
                moe_dropless=args.moe_dropless, data_dir=args.data_dir,
                train_dir=args.train_dir, ckpt_every=args.ckpt_every,
                ckpt_keep=args.ckpt_keep, step_deadline=args.step_deadline,
                divergence_k=args.divergence_k,
                stop_check_every=args.stop_check_every,
                stop_at_step=args.stop_at_step,
                lr_schedule=args.lr_schedule,
                decay_steps=args.decay_steps, lr=args.lr,
                lr_warmup_steps=args.lr_warmup_steps,
                profile_dir=args.profile_dir,
                metrics_port=args.metrics_port, events=events,
                device=args.device, log=log)
            headline = {"metric": f"{args.workload}_tokens_per_sec",
                        "value": round(metrics["tokens_per_sec"], 0),
                        "unit": "tokens/sec"}
        if not args.hfta:
            headline["final_loss"] = round(float(metrics["final_loss"]), 6)
        if coordinator:
            print(json.dumps(headline))
        exit_code = 0
        return 0
    except Preempted as p:
        # the emergency checkpoint is committed (the loop saves before
        # raising): exit in the retryable band so the gang restarts
        log(f"preempted: drained at step {p.step}, exiting "
            f"{p.exit_code} (retryable)")
        exit_code = p.exit_code
        return exit_code
    except DivergenceError as exc:
        print(f"diverged: {exc}", file=sys.stderr)
        return 1
    finally:
        # the event log closes (flush + fsync) before the status channel
        # reports done, so a preemption exit never leaves its drain
        # record buffered
        if events is not None:
            events.close()
        if status is not None:
            status.set_done(exit_code)
            status.close()
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


__all__ = ["main", "run_generate_benchmark", "run_hfta_benchmark",
           "run_lm_benchmark", "run_vit_benchmark"]


if __name__ == "__main__":
    sys.exit(main())
