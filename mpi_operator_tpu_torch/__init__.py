"""tpu-job-operator's data plane ported to PyTorch and CUDA (NVIDIA H100).

A package of its own beside the JAX reference (`mpi_operator_tpu`): it
imports torch and never jax, flax or the reference package. Each module
mirrors the reference module of the same path; each TPU kernel on a
ported path is a kernel hand-written for Hopper (ops/csrc/), beside its
plain PyTorch version.

Ported so far: the continuous-batching serving engine, contiguous and
paged (serve/engine.py), over the decode-mode CausalLM (models/), with
the decode-attention kernels K4 and K5; and single-device LM training
(train/lm_trainer.py, examples/lm_benchmark.py) over the training
forward, with the flash-attention kernels K1-K3 (ops/attention.py),
that survives preemption: checkpoints (train/checkpoint.py), the
resilience runtime (train/resilience.py), token shards (data/) and the
profiler window (utils/profiling.py); BERT's masked LM, mixture-of-
experts FFNs (parallel/moe.py) and remat in training, and the decode
benchmark (examples/lm_benchmark.py run_generate_benchmark).
Entry points run on the CUDA card unless the caller passes
device="cpu".
"""
