"""tpu-job-operator ported to PyTorch and CUDA (NVIDIA H100).

A package of its own beside the JAX reference (`mpi_operator_tpu`): its
data plane imports torch and never jax, flax or the reference package;
its control plane (api/, cluster/, controller/, `python -m
mpi_operator_tpu_torch`) imports neither torch nor jax. Each module
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
benchmark (examples/lm_benchmark.py run_generate_benchmark); and
data-parallel image training: ResNet (models/resnet.py) and ViT through
the image Trainer (train/trainer.py) under DistributedDataParallel, the
npy image shards (data/imagefolder.py, native/), the worker bootstrap
on torch.distributed (bootstrap/) and the image benchmark
(examples/benchmark.py); and the operator in GPU mode, whose jobs ask
for `nvidia.com/gpu` (controller/), with its job observatory (metrics
federation, merged timelines and the progress lease:
telemetry/collector.py), the postmortem CLI (postmortem.py), the chaos
soak (controller/chaos.py, telemetry/chaos.py) and its own CRD, images
and GPU manifests (deploy/).
Entry points run on the CUDA card unless the caller passes
device="cpu".
"""
