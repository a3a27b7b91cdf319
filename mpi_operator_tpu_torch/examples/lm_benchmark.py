"""LM training benchmark on one card: the flat single-device path of the
reference's `mpi_operator_tpu/examples/lm_benchmark.py::
run_lm_benchmark`.

`run_lm_benchmark(workload="gpt2", size="medium", batch_per_device=16,
seq_len=512)` builds the model with max_len = max(seq_len, 32), an
LMTrainer over it and the step-keyed synthetic TokenStream, runs
`trainer.benchmark` and, with `eval_steps`, `evaluate` on the batches
that follow. It runs on the CUDA card unless `device="cpu"`.

The arguments of the parts not ported yet (tp/pp/sp/ep meshes, MoE,
remat, BERT, token shards, checkpoints, the profiler window) raise
ValueError; none is ignored.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..data.synthetic import TokenStream
from ..models.transformer import lm_config
from ..train.lm_trainer import LMTrainer, LMTrainerConfig, LMTrainState
from ..utils.device import DeviceLike, resolve_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    sp: int = 1,
    ep: int = 1,
    num_slices: int = 1,
    attention: str = "auto",
    remat: bool = False,
    moe_experts: int = 0,
    num_layers: Optional[int] = None,
    fused_xent: bool = False,
    accum_steps: int = 1,
    data_dir: Optional[str] = None,
    train_dir: Optional[str] = None,
    lr_schedule: str = "linear",
    decay_steps: int = 10_000,
    lr: Optional[float] = None,
    lr_warmup_steps: Optional[int] = None,
    profile_dir: Optional[str] = None,
    device: DeviceLike = None,
    log: Callable[[str], None] = print,
) -> Tuple[LMTrainState, Dict[str, object]]:
    """GPT-2 / llama token-stream benchmark on one device. Parameters
    from seed 0 and the stream's batches from seed 1, step-keyed, as the
    reference's PRNGKey(0) and PRNGKey(1). Returns (state, metrics)."""
    if workload not in ("gpt2", "llama"):
        raise ValueError(f"workload={workload!r}: the port trains the "
                         f"causal LMs gpt2 and llama (bert is not ported)")
    unported = {"tp": tp > 1, "pp": pp > 1, "sp": sp > 1, "ep": ep > 1,
                "num_slices": num_slices > 1, "remat": remat,
                "moe_experts": bool(moe_experts),
                "data_dir": data_dir is not None,
                "train_dir": train_dir is not None,
                "profile_dir": profile_dir is not None}
    for name, asked in unported.items():
        if asked:
            raise ValueError(f"{name}: not in the port yet (the flat "
                             f"single-device path only; ROADMAP.md Queue 1)")
    if dtype_name not in _DTYPES:
        raise ValueError(f"dtype_name={dtype_name!r}; expected one of "
                         f"{sorted(_DTYPES)}")
    dev = resolve_device(device)
    overrides = dict(dtype=_DTYPES[dtype_name], attention=attention,
                     max_len=max(seq_len, 32))
    if num_layers:
        overrides["num_layers"] = num_layers
    cfg = lm_config(f"{workload}-{size}" if size else workload, **overrides)
    opt_overrides = {}
    if lr is not None:
        opt_overrides["learning_rate"] = lr
    if lr_warmup_steps is not None:
        opt_overrides["warmup_steps"] = lr_warmup_steps
    tcfg = LMTrainerConfig(global_batch_size=batch_per_device,
                           seq_len=seq_len, fused_xent=fused_xent,
                           accum_steps=accum_steps, lr_schedule=lr_schedule,
                           decay_steps=decay_steps, **opt_overrides)
    trainer = LMTrainer(cfg, tcfg, device=dev)
    state = trainer.init_state(0)
    stream = TokenStream(batch_per_device, seq_len, cfg.vocab_size, seed=1,
                         start=state.step, device=dev)
    state, metrics = trainer.benchmark(state, stream, num_steps=num_steps,
                                       warmup_steps=warmup_steps, log=log)
    if eval_steps:
        # evaluation continues the stream past the trained batches
        ev = trainer.evaluate(state, stream, num_batches=eval_steps)
        metrics.update(ev)
        log(f"val_loss: {ev['val_loss']:.3f}  perplexity: "
            f"{ev['perplexity']:.1f}  ({eval_steps} batches)")
    return state, metrics


__all__ = ["run_lm_benchmark"]
