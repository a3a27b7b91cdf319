#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (mpi_operator_tpu_torch).

    python3 chip_smoke.py        # from the repo root, on one NVIDIA H100

It drives the port only: it imports neither JAX nor the JAX package.
Phases, each of which fails the run (non-zero exit, no result line):

1. Device: the card's name and power limit, as nvidia-smi reports them.
2. Build: every hand-written kernel of the serving and training paths,
   from the sources in ops/csrc/, one nvcc per source, all started
   together (K4 and K5 share one source, K1-K3 another); ptxas'
   registers, shared memory and spills printed for each kernel, and
   K1-K3 (warp specialised, setmaxnreg 40/232) must read 168 registers
   and no spills.
3. Kernel K4 (decode attention) against its plain PyTorch version on
   the card, for the gpt2-medium (H=KV=16) and llama-1b (H=32, KV=8)
   head layouts, D=64, bf16 and int8 caches, B=8, L=1024, ragged
   per-row cursors with the cache past every cursor poisoned: edge
   cursors, the split edges of the split length the wrapper picks
   (length - 1, + 0, + 1, twice it, 1022, 1023, and a short row whose
   later splits lie past its cursor), the serving depths and a long set
   (896..1023). Times the kernel, the plain version and one
   scaled_dot_product_attention call (a yardstick only: the port never
   calls it) with L2 flushed between launches, beside the least time
   the card could take (bytes bound), at the serving and long sets.
4. Kernel K5 (paged decode attention) against its plain version and,
   bit for bit, against K4 on the same logical cache gathered
   contiguous: both head layouts, bf16 and int8, pages of 64 and 16
   positions, logical L=1024, the pool a seeded permutation with the
   trash page and one never-mapped page poisoned, two rows sharing their
   first pages, the cache past every cursor poisoned; cursors at the
   edges (0, 1, 15, 16, 17, 63, 64, 65, 1022, 1023: one row each), the
   split edges, the serving depths and the long set (B=8), and the
   paged serving phase's own shape (logical L=384, cursors in 160..319).
   Times K5, K4 on the gathered cache (the cost of the indirection) and
   the plain version, beside the bytes bound, at the serving, long and
   paged serving sets; the kernels line's K5 row is the paged serving
   set's, pages of 64. No single PyTorch call reads a paged cache:
   library time null.
5. Serving, contiguous: ServingEngine.run on gpt2-medium at full width
   and depth, bf16, decode_kernel=True, 8 slots, chunk buckets (32,
   128), 24 seeded requests (prompts of 32/64/128 tokens, 32 or 64 new
   tokens; odd ids sample at temperature 0.8 with top_k=40). The engine
   runs its decode steps and prefill chunks as CUDA graphs (the
   default): every program is captured once, at most 3 step programs
   and one prefill program a bucket. K4's launch count (replays
   counted) must equal layers x decode steps, K5's must be 0; greedy
   tokens are teacher-forced through the dense path (decode_kernel=
   False) and must agree with it modulo bf16 near-ties. Then 20 decode
   steps of 8 requests under torch.profiler give the device's idle
   share, device time by kernel group and the host's runtime calls a
   step. In that window K4's launches, counted where no record can be
   lost (each graph replay adds the K4 nodes its capture launched), must
   equal layers x steps; the profiler's own count of K4 records is
   printed beside it, and fails only above that count or if it is still
   short when the window is run again, up to 3 times (the profiler has
   dropped a record in about one window in 19 of full runs).
6. Llama: the same engine on llama-1b at full width, 2 layers, int8 KV
   cache — GQA, RoPE and int8 through K4.
7. Serving, paged (this slice's main path, the JAX bench's
   serving_paged leg): gpt2-medium at full width and depth, bf16,
   max_len 384, 8 slots, chunk buckets (32, 128), paged=True,
   page_size 64, the default pool (49 pages); 32 greedy requests, each
   one seeded 128-token system prompt plus 32/64/128 user tokens, 32 or
   64 new tokens. K5's launch count must equal layers x decode steps and
   K4's must be 0; every request ends "length"; tokens agree with the
   dense path as above; at least one request reports 128 cached tokens
   and none anything but 0 or 128; the allocator is empty and passes its
   audit afterwards. Then a profiled window as in phase 5, and an A/B
   on the same trace: the contiguous engine and the paged engine in
   turns (contiguous, paged, paged, contiguous), throughput, TTFT and
   TPOT of each run.
8. Llama, paged: llama-1b at full width, 2 layers, int8 KV, page_size
   16, a 32-token shared prefix (the router bench's settings), 12
   requests — GQA, paged int8 scales and tiles that span pages.
9. Kernels K1-K3 (flash attention forward, dq, dk/dv) against their
   plain versions in bf16: the training shape (B=16, S=512, gpt2-medium
   heads H=16, D=64, causal), bert-large's (the same, non-causal) with
   and without a key mask (row 0 padded after 3/4), llama-1b's heads
   after the K/V repeat (H=32), a [B, S] key mask with one fully masked
   row (non-causal and causal), a ragged S=500, S=129 (one past K1's
   128-row tiles), D=128 (two 64-column boxes a tile), and ViT-B/16's
   attention (B=256, S=197, H=12, D=64, non-causal, no mask: the last
   64-row tile holds 5 valid rows, the last 128-row tile 69). K2/K3 get
   the plain forward's lse and delta. Each output is held to a relative
   error limit, and at the training shape each limit must fail planted
   faults made from the plain versions (a skipped tile; for K2/K3 ds
   left unrounded). Times each kernel at the training shape and at both
   bert-large shapes and ViT-B/16's with L2 flushed beside its bound
   (the bytes, or the
   products over this input's visible pairs), its plain version, and
   one scaled_dot_product_attention call with the same causality and
   mask, forward and backward through autograd (yardsticks only: the
   port never calls SDPA), and prints K1 over SDPA's forward and K2 + K3
   over SDPA's backward, ratios taken in the same call.
10. Training, gpt2-medium (this slice's main path, the JAX bench's gpt2
   leg): run_lm_benchmark(workload="gpt2", size="medium",
   batch_per_device=16, seq_len=512), bf16 compute over f32 masters,
   attention="flash", AdamW with warmup, 3 warmup steps then 3 windows
   of 10 steps. K1, K2 and K3 must each launch num_layers x steps times
   (the decode kernels never); every step's loss finite and no update
   skipped by the guard. Then one step's gradients from the same weights
   and batch through attention="flash" and "dense" must agree (cosine >=
   0.999 per parameter tensor, global norm within 1%), and two profiled
   steps give K1-K3's share of device time and the idle share.
11. Training, llama-1b at full width, 2 layers, batch 8 x 512: RoPE, GQA
   through the repeat, SwiGLU and RMSNorm in training, with the same
   launch and finiteness checks.
12. (Run after 8.) The serving benchmark (examples/serve_benchmark.py)
   at bench.py's
   `serving` leg (gpt2-medium, 8 slots, 12 requests, prompts 32/64/128,
   32/64 new tokens, buckets (32, 128), the sequential generate()
   baseline and the sync A/B), the same leg with odd ids sampled, and
   the `serving_paged` leg (pages of 64, a 128-token shared prefix).
   Each: serving_no_recompile, every program captured once, and a
   graphs-on/graphs-off A/B on the same trace and settings (runs
   alternated, best of two an arm) whose tokens, greedy and sampled,
   must be identical; tokens/s and TPOT p50/p99 of both arms, and
   whether they moved beyond the arms' run-to-run spread. For the two
   bench legs, with graphs on and off: every program built (a request
   in each sampling mode, prompts reaching both buckets) and the memory
   the engine reserved, then a profiled window of 20 steps: device time
   a step, idle share, host launch calls a step, and the K4/K5 count
   against layers x steps as in phase 5. After the `serving` leg's
   graphed window, a planted fault: a fresh engine whose captured step
   runs one layer's attention through K4's plain version must fail that
   check in each of 2 windows. The engine runs with its
   telemetry and a tracer attached, as the benchmark always runs it:
   every request's trace complete (hops tiling its end-to-end time) and
   the host gap printed; the `serving` leg also logs its events to a
   temporary directory (one slot_admit and one slot_retire a request)
   and runs a hooks A/B (no telemetry, tracer or event log; alternated,
   best of two an arm, greedy tokens identical).
13. (Run after 12.) Speculative serving, the JAX bench's `serving_spec`
   leg at full size through run_serving_benchmark: gpt2-medium, bf16,
   decode_kernel=True, 8 slots, 32 greedy requests with a 128-token
   shared prefix, buckets (32, 128), speculative="ngram", draft_k=4,
   paged (pages of 64) and then contiguous (the trash row takes the
   verify step's padded columns). Each: acceptance rate, effective
   tokens a row-step, verify steps; tokens/s and TPOT p50/p99 with
   speculation and without (alternated, best of two an arm) and whether
   they moved beyond the arms' spread; at most len(_verify_buckets)
   verify programs, each captured once; both arms' tokens and logprobs
   against the teacher-forced dense path; every token where the arms
   differ a near tie of the dense path (SPEC_MARGIN: the arms run other
   kernels and GEMM shapes in bf16), and a planted fault (a draft token
   accepted past the match) caught by that check; K4/K5 launched once a
   layer a plain step and never in a verify step; profiled windows with
   speculation on and off (device time a verify step against a plain
   step, idle share). Then a contiguous f32 run with decode_kernel=False
   (16 requests) whose greedy tokens must be identical between the arms.
14. (Run after 11.) BERT: run_lm_benchmark(workload="bert", size=
   "large", batch_per_device=16, seq_len=512), the JAX bench's bert leg
   (MLM rate 0.15, the MaskedLM's attention non-causal through K1-K3),
   3 warmup steps and 10 timed: K1-K3 launches 24 x steps each, losses
   finite, no skipped update; tokens/s, step p50/p99, MFU (attention
   FLOPs not halved) and peak memory. Then one step's gradients through
   flash and dense from the same weights and an MLM batch under a key
   mask padding two rows (cosine >= 0.999 a tensor), and two profiled
   steps.
15. MoE: gpt2-small with 8 experts (top-2, capacity factor 1.25, MoE on
   every second block), 16 x 512, the bench's moe leg, 13 steps: K2/K3
   launches 12 x steps, K1 12 x (steps + 1) (the drop-rate probe's
   forward), finite losses, no skip, the drop rate in [0, 0.5]; two
   profiled steps; then 4 layers dropless for 5 steps, drop rate 0.
16. Remat: gpt2-medium, 16 x 512, 2 + 2 steps each with remat off, "none"
   and "dots", one seed and one stream: the params of both remat arms
   equal remat off's bit for bit; K1 launches 2 x 24 x steps under
   remat, K2/K3 24 x steps; peak memory and step p50 of each arm.
17. Generate: run_generate_benchmark for gpt2-medium and llama-1b,
   bf16 and int8 KV, batch 8, prompt 128, 16 new tokens, greedy,
   decode_kernel=True, 1 timed call after a warm one: K4 launches
   layers x 15 decode steps x calls (the prefill runs the dense path),
   no other kernel; the last call's tokens against decode_kernel=False
   on the same model, each row's first divergence a near tie of the
   dense path; tokens/s and MBU against 3.35 TB/s. Every phase from 14
   on prints the card's name and power limit beside its numbers.
18. Image training, ResNet ([train-resnet]): run_benchmark at the JAX
   bench's headline leg (bench.py:181-200): ResNet-101 with the conv7
   stem, bf16 over f32 params, 256 x 224^2, SGD with momentum, 3 warmup
   and 10 timed steps; then ResNet-50 with the s2d stem for 2 + 10, so
   both stems run through cuDNN. No flash or decode kernel launches;
   every loss finite and no step skipped by the guard (each step's
   streak read). Prints images/s, step p50/p99, MFU (the analytic FLOP
   count, utils/flops.py), peak memory; two profiled steps give device
   busy, the idle share and device time by group (cuDNN convs,
   reductions, elementwise: BN apply, ReLU, casts, optimizer), and the
   optimizer's update is timed alone. Then the shard path: two seeded
   uint8 npy shards, the native loader's batch on the card equal to the
   Python path's, and ResNet-50 s2d at 64 px trained on them through
   run_benchmark(data_dir=).
19. ViT ([train-vit]): run_vit_benchmark(size="b16",
   batch_per_device=256, image_size=224), the bench's vit leg
   (bench.py:1046-1064), 3 + 10 steps: K1-K3 launches 12 x the steps
   run, the same checks and prints as 18, K1-K3's share of device time;
   then a 2-layer cut's gradients through flash and dense from the same
   weights and batch (64 images), as the BERT check: flash with delta
   from an f32 O against the dense path with f32 attention at cosine >=
   0.999 a tensor, the others printed.
20. DDP ([train-ddp]): tests/torch_ddp_worker.py as two ranks on the one
   card over gloo (NCCL refuses two ranks on one device; gloo all-
   reduces CUDA tensors), started by the port's launch.py
   (TPU_SLOTS_PER_WORKER=2) and joined through its bootstrap: ResNet-50
   (s2d, 64 px, f32) and ViT-B/16's width at 2 layers (bf16, K1-K3), 3
   SGD steps on a global batch of 16; then one rank over NCCL (a group
   of one, joined through the bootstrap's rendezvous, so the NCCL path
   runs). Each against this process's run of the same models, weights
   and batches, cuDNN autotuning off as in the ranks (20 and 21 run
   under `cudnn_heuristics`): the relative error of the update (params
   after minus before), of the momentum and of the BN statistics within
   DDP_REL.
   Then the 2 gloo ranks again with H12's planted fault (each rank
   normalises with its own BN statistics): the ResNet must exceed
   DDP_REL by the same check.
21. Data-parallel LM training ([train-lm-ddp]): (a) the [train] leg's
   gpt2-medium (24 layers, E=1024, vocab 50304, 16 x 512, bf16 over f32
   masters, flash) through run_lm_benchmark as a gang of one over NCCL,
   joined through the bootstrap's rendezvous, so the LMTrainer's
   gradient all-reduce runs: K1-K3 launches 24 x steps each, finite
   losses, no skip, and its tokens/s and step p50 beside the [train]
   leg's. (b) tests/torch_lm_gang_worker.py as two gloo ranks on the
   card through launch.py and the bootstrap against this process, at
   the global batch of 8 x 256 with the same numpy batches: gpt2-medium's
   width, bert-large's (MLM over padded rows: H13) and gpt2-small's with
   8 experts (capacity factor 1.25, accum_steps 2: H14, H16), 2 layers
   each, in f32 with dense attention, 3 AdamW steps: the relative error
   of the update, mu and nu within LM_DDP_REL, the ranks' params equal;
   then the planted faults (per-rank mask count, per-rank routing, rows
   cut into microbatches after the split) must each exceed it; H15 (a
   non-finite loss on one rank: both skip, both roll back), H14's
   queue positions against one process's, the hierarchical mean
   against the flat one. (c) 2 slices x 2 gloo ranks (two launch.py
   trees, TPU_NUM_SLICES 2, the dcn x dp mesh from hybrid_mesh): gpt2 in
   bf16 through K1-K3 within LM_DDP_BF16_REL and ResNet-50 (s2d, 64 px,
   f32) within DDP_REL, its DDP buckets through the hierarchical hook;
   the hierarchical mean equal to the flat one. (d)
   examples/allreduce_bench.py alone (a gang of one over NCCL) at 1, 16
   and 64 MB: the n = 1 points and the empty curve, no score.
22. (Run last.) Training that survives preemption, gpt2-medium at
   full width, bf16, attention="flash", 16 x 512, through
   run_lm_benchmark's resilient path in a temporary directory (at least
   20 GB free, or the phase fails): periodic async checkpoints every 6
   steps keeping 2 (torch.distributed.checkpoint). A and A': two
   uninterrupted runs to step 15, A with the periodic saves and A'
   without (a save changes no state), compared bit for bit (params, mu,
   nu, losses). B1: TPU_FAULT_INJECT=sigterm-at-step:10 must end in
   Preempted (exit code 215) with step_10 committed and preemption_drain
   then emergency_checkpoint in events.jsonl. B2: stop_at_step=15
   resumes from step_10 (checkpoint_restore and first_resume_step
   logged) and must end equal to A — params, mu, nu and opt.count bit
   for bit and the losses of the steps it ran — or, if A and A' differ,
   within twice their difference. Each run's K1-K3 launches equal 24 x
   the steps it executed (warmup included). Prints, with the card's name
   and power limit: the emergency save's seconds and bytes, step time
   in windows holding a periodic save against windows without one, the
   device clone against a pinned host copy of the state, restore and
   first-resumed-step seconds, the writer's thread count. Then the CLI
   at 2 layers: sigterm-at-step:5 exits 215 with step_5, and the resume
   with --stop-at-step 8 and TPU_RESHARD_RESTORE=1 exits 0 with step_8,
   its checkpoint_restore record resharded; step_5 through
   restore_resharded is bit-equal to the plain restore.

23. (Run after 13.) The serving fleet, each leg of
   examples/serve_benchmark.py at gpt2-medium's full width and depth,
   bf16, decode_kernel=True, CUDA graphs on, with every kernel count
   zeroed just before it and read just after (K5 launched, nothing
   else), and in each arm K5's launches equal to layers x that arm's
   decode steps. [disagg]: run_disagg_benchmark (8 slots, 24 requests,
   prompts 64/256/384, pages of 64): a PrefillEngine and a DecodeEngine
   on this card bridged by the paged-KV handoff against the colocated
   paged engine — greedy tokens identical, the prefill pool with no
   step program and the decode pool with no prefill program, each
   program captured once, transfer widths within their cap, one handoff
   a request, complete traces, every page back; then the handoff alone
   (PageTransfer.move of 1, 4 and 6 pages between two gpt2-medium pools:
   the pages equal, device and host time a move, operations a move,
   bytes bound). [router]: run_router_benchmark (2 replicas of 4 slots,
   24 requests of the multi-tenant trace, an arrival every 0.02 s,
   prefill widths 16 and 64): affinity on and off and one engine at the
   same offered rate, every arm's tokens equal to the single-engine
   oracle's modulo near ties (each first divergence a near tie of the
   dense path, at most FLEET_MAX_DIVERGED of an arm's requests), no
   replica lost to failover, no low-load shed, the burst shedding and
   recovering, pins held, every page back. [livescale]:
   run_livescale_benchmark (24 requests, an arrival every 0.05 s): the
   live +1/-1 cycle drops and sheds nothing and loses no replica, both
   arms' tokens the oracle's modulo near ties as above, the live ledger
   total under the gang restart's, every page back. Each prints its
   numbers with the card's name and power limit.

24. (Run after 22.) The operator ([operator]): the port's
   TPUJobController on its GPU defaults (nvidia.com/gpu, 8 a worker)
   over the in-memory API server, through the threaded run loop, with
   LocalKubelet playing the node: one process a pod, the rendered env,
   TPU_WORKER_ID for the missing pod hostname, the coordinator at
   127.0.0.1, a pod-private /tmp and ConfigMap volume,
   CUDA_VISIBLE_DEVICES the first as many of the run's own cards as the
   nvidia.com/gpu limit (the phase fails if the run sees fewer; none
   for the launcher), the rendered exec probe setting ready_replicas,
   crash-loop restarts, the launcher's exit code into the Job's status.
   Two planted faults at once: a worker that exits non-zero (an unknown
   --size) must end Failed with the launcher mirroring its code, and a
   worker told to expect 2 cards on a pod that sees one must never be
   Ready nor get a launcher (held 10 s after its first exit). Then the
   job a user submits: processingUnits 1, processingUnitsPerWorker 1,
   nvidia.com/gpu, restart policy Never, whose pod runs the LM CLI's
   main() (`--workload vit --size b16`, 256 x 224^2, 2 + 150 steps) and
   reports the steps run and the launch counts: the worker set's limits
   {nvidia.com/gpu: 1} with no TPU selector, the gate's env and probe,
   no launcher before the marker, worker and launcher exit 0, Succeeded,
   workers scaled to 0, rank 0's throughput line, K1-K3 12 x the steps
   run (the decode kernels 0). Prints images/s, the seconds from submit
   to the worker set, worker start to Ready, Ready to the launcher and
   the launcher to Succeeded, with the card's name and power limit.
   The controller runs its job observatory (a worker metrics port, an
   events directory in the phase's temporary directory, scrapes at most
   every 2 s): LocalKubelet gives each worker pod a free
   TPU_METRICS_PORT of its own, and the observatory's fetch maps the
   rendered pod URL to 127.0.0.1 at that port; the phase resyncs every
   job each second, as an informer's resync period would (the
   controller scrapes only in its syncs). The ViT-B/16 job sets
   progressDeadlineSeconds 60 and writes its worker event log: the
   observatory must scrape the live worker at least 3 times with the
   step frontier advancing, the lease must never fire on it (Succeeded,
   restart count 0), and its merged timeline must hold the controller's
   and the worker's records, on which postmortem.summarize reports a
   goodput ledger and render prints the report. Then a third planted
   fault, after the ViT-B/16 job: a hung worker (ViT at 2 layers of
   B/16 width, batch 16, restart policy OnFailure,
   progressDeadlineSeconds 10) that LocalKubelet stops with SIGSTOP
   once the observatory's scrape shows a step > 0; the lease must
   declare the gang stuck and restart it (restart count 1, the
   Restarting condition's reason GangStuck, a StuckGang condition, one
   gang_stuck record with a stall of at least 10 s) at most 25 s after
   the stop, and LocalKubelet kills the stopped process when the
   controller deletes its pod.

25. (Run after 21.) [train-lm-mp]: tests/torch_mp_worker.py as one gang
   of 4 gloo ranks on the card (launch.py, TPU_SLOTS_PER_WORKER 4, the
   bootstrap), every leg laying its own mesh over the same processes.
   (a) gpt2-medium at full width and depth, bf16 over f32 masters,
   attention flash, (dp, fsdp, tp) = (1, 2, 2), global batch 16 x 512,
   2 + 3 steps through LMTrainer.benchmark: finite losses, no skip, each
   rank's K1-K3 launches 24 x 5 with 8 heads a launch; its tokens/s and
   step p50 beside [train]'s one process (4 ranks sharing one card over
   gloo: not a scale-out figure), each rank's masters + mu + nu against
   one process's / (fsdp x tp), peak memory a rank. (b) f32 parity at
   gpt2-medium's width, 2 layers, dense attention, 8 x 256, 3 AdamW
   steps from seed 0's weights and numpy batches, against this
   process's run of the same: (1, 2, 2), (2, 2, 1), (1, 2, 2) with
   tp_overlap uni and bidir, and gpt2-small's width with 8 experts
   (capacity factor 1.25, accum_steps 2) at (dp, ep) = (2, 2); update,
   mu, nu within LM_DDP_REL, the ranks' gathered state equal. (c) ring
   attention through K1-K3 at sp 2 and 4, B 4, S 2048, 16 heads, D 64,
   bf16, causal and not, against K1-K3 over the whole sequence in this
   process (RING_REL) with H28's launch plan on each rank; then a
   trainer at (dp, sp, tp) = (1, 2, 2), gpt2-medium's width at 2 layers,
   bf16, S 512: its launches H28's plan, its losses and update within
   LM_DDP_BF16_REL of one process's K1-K3 run. (d) The planted faults
   (one layer's row-parallel all-reduce skipped, fsdp's reduce-scatter
   over tp, a tp-replicated parameter counted tp times in the norm,
   the ring's diagonal block non-causal) must each exceed the limit.

26. (Run after 25.) [train-lm-pp]: tests/torch_mp_worker.py's pipeline
   legs, run in the same gang of 4 gloo ranks as 25's ([train-lm-gang]:
   one start of the ranks for both). (a) gpt2-medium at full
   width and depth, bf16 over f32 masters, attention flash, pp = 4 (6
   layers a rank), global batch 16 x 512 in M = 16 microbatches, 2 + 5
   steps through PipelineLMTrainer.benchmark, once under GPipe and once
   under 1F1B with interleave 2: finite losses; each rank's K1-K3
   launches (L / P) x M a step (each in-flight microbatch keeps its
   graph: K1 once a layer a microbatch, K2 and K3 once in its backward);
   each rank's masters + mu + nu 12 B x (its blocks + the replicated
   leaves), 0.3611 x one process's within 1%; the replicated leaves'
   digests equal on every rank; 1F1B's peak memory below GPipe's on
   every rank; tokens/s, step p50, the bubble and the last step's idle
   share (CUDA events around each tick's compute). (b) f32 parity at 4
   layers, 8 x 256, 3 AdamW steps, against this process's run of the
   same model and batches within LM_DDP_REL: gpt2-medium's width at
   (pp, dp) = (2, 2) GPipe and (pp, tp) = (2, 2) 1F1B x 2, bert-large's
   at (pp, dp) = (2, 2) 1F1B (against the LMTrainer), gpt2-small's with
   8 experts at (pp, ep) = (2, 2) GPipe (against the LMTrainer with
   accum_steps = M: the routing is per microbatch, as the reference's). (c) The
   planted faults (the tied embedding's gradient not summed over pp,
   one backward hop dropped, the replicated leaves counted pp times in
   the norm) must each exceed the limit.

27. (In 25's gang.) restore_resharded: gpt2-medium at full width and
   depth, bf16, (dp, fsdp, tp) = (1, 2, 2), its seed-0 masters with no
   step trained (mu = p / 2 and nu = p * p set from the masters, count
   and step 7), saved (one shard a rank); restored at (1, 4, 1) on the 4
   ranks, at fsdp 2 on ranks 0 and 1 (their groups made on every rank)
   and as one replica on rank 0. Each rank's restored masters, mu, nu
   and the step are bit-equal to that rank's share of the saved state,
   as the target's own init_state builds it on the CPU from the global
   buffers (no checkpoint code, no collective); each rank's ReadStats
   (bytes read against its share, the peak in flight, seconds). The
   planted fault (rank 1's fsdp slice cut at the wrong offset) must
   break the bit-equality.

28. [hfta]: the HFTA fused trainer (train/hfta.py). vmap(flash_attention)
   at K = 4 over [2, 512, 12, 64] bf16 with a key mask bit-equal to four
   calls (out, dq, dk, dv), K1-K3 launched once each; at gpt2-small's
   width and 2 layers the fused K = 1 step bit-equal to LMTrainer after
   3 steps (params, mu, nu) and K = 4 with nan-replica:1@2 freezing
   replica 1 while the others stay bit-equal to an unpoisoned fused
   run, and the planted fault (the guard's per-row select made one
   select of the whole state) failing that. Then the reference bench's
   leg: gpt2-small, K = 8 replicas of 8 x 512, bf16 over f32 masters,
   flash, 3 + 10 steps through HFTATrainer.benchmark with the counts
   zeroed just before and read just after: K1-K3 each 12 launches a
   step (the layers, all 8 replicas in each launch), not 96; against
   the solo LMTrainer at one replica's size: aggregate and solo tokens/s,
   fused_speedup, per-replica MFU, peak memory, with the card's name and
   power limit.

The line before the last is {"kernels": [...]}: K4, K5 and K1-K3 (at
the gpt2 training shape, with a `vit_b16` entry each: launches in
[train-vit] and the timing row at ViT-B/16's shape; and an
`lm_gang_of_one` entry: launches in [train-lm-ddp]'s gang of one; an
`lm_mp` entry: rank 0's launches in [train-lm-mp] (a) and each rank's
in its causal rings; an `lm_pp` entry: each rank's launches in
[train-lm-pp] (a) under each schedule; an `operator` entry: launches in the
[operator] job's worker; and an `hfta` entry: K and the launches of
[hfta]'s leg); K5's
entry adds `disagg`, `router` and `livescale`: its launches in each
fleet phase. The last line is {"ok": true, "device": {...}}.
"""
import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

# NVIDIA H100 SXM data-sheet peaks (dense): HBM bandwidth and the bf16
# tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12

# K4 against its plain version: the kernel's online softmax rounds p to
# bf16 against a running max, the plain version against the row max, so
# bf16 outputs differ by a few bf16 ulps (2^-8 relative) at |out| ~ 1
KERNEL_ATOL, KERNEL_RTOL = 2e-2, 2e-2
# engine logprobs against the teacher-forced dense path, in nats: the two
# run different kernels and GEMM shapes in bf16 through every layer, so
# logits (std ~0.6 at random init) differ by a few bf16 ulps
LOGPROB_TOL = 0.1
POISON = 1e4
B_KERNEL, L_KERNEL, D_KERNEL = 8, 1024, 64
LAYOUTS = {"gpt2-medium": (16, 16), "llama-1b": (32, 8)}

# K1-K3 against their plain versions in bf16, read as the relative error
# ||kernel - plain|| / ||plain|| of each output tensor (out; dq; dk and
# dv), so the limit scales with the outputs (|dq| is ~0.05 at the
# training shape, far under an absolute 2e-2). K1 rounds p to bf16
# against a running max, the plain version against the row max, so most
# p differ by up to half a bf16 ulp. K2/K3 round ds as the plain version
# does, after f32 sums in another order: their outputs differ only where
# a sum lands across a bf16 rounding boundary. Each limit lies between
# the sound kernel's reading and the smallest reading of a planted fault
# (`planted_faults`), which the run checks. lse (f32) within f32 sums
# over up to 512 terms.
FLASH_REL = {"flash_fwd": 4e-3, "flash_dq": 4e-4, "flash_dkv": 4e-4}
LSE_ATOL = 1e-3
# the tile each kernel walks at D <= 64, the unit a skipped-tile fault
# drops: K1's and K2's k-tiles of 128 keys (under 128-query CTAs), K3's
# q-tiles of 64 (under 128-key CTAs)
FLASH_TILE = {"flash_fwd": 128, "flash_dq": 128, "flash_dkv": 64}
# (name, B, S, H, D, causal, mask): the training shape first; the
# bert-large cases are the [train-bert] phase's non-causal shape, without
# and with a key mask (row 0 padded after 3/4 of S)
FLASH_CASES = [
    ("gpt2-medium", 16, 512, 16, 64, True, None),
    ("bert-large", 16, 512, 16, 64, False, None),
    ("bert-large-pad", 16, 512, 16, 64, False, "pad"),
    ("llama-1b", 8, 512, 32, 64, True, None),
    ("masked", 4, 512, 16, 64, False, "empty"),
    ("masked-causal", 4, 512, 16, 64, True, "pad"),
    ("ragged", 16, 500, 16, 64, True, None),
    # one row past K1's 128-row q-tile and k-tile and K3's key tile
    ("tile-edge", 16, 129, 16, 64, True, None),
    # D=128: two 64-column boxes a tile; K1 and K2 walk 64-key tiles, K3
    # 32-query tiles
    ("unequal-tiles", 4, 512, 16, 128, True, None),
    # ViT-B/16's attention in [train-vit]: 196 patches + cls, the last
    # 64-row tile holds 5 valid rows and the last 128-row tile 69
    ("vit-b16", 256, 197, 12, 64, False, None),
]
# one step's gradients, flash against dense, same weights and batch: both
# bf16; dense rounds its scores to bf16 (the reference's einsum does) and
# its probabilities after an f32 softmax, flash rounds p against a running
# max, so entries differ by a few bf16 ulps that average out over the
# 8192 tokens of a batch. The key bias is left out of the cosine: it
# shifts a row's scores uniformly, so its exact gradient is 0 and both
# sides hold rounding noise (checked to be under 1e-3 of the global norm)
GRAD_COSINE, GRAD_NORM_RTOL, NOISE_NORM = 0.999, 0.01, 1e-3


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg):
    print(msg, flush=True)


@functools.lru_cache(maxsize=None)
def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# the kernel phase
# ---------------------------------------------------------------------------

def poisoned_cache(H, KV, cache, curs, gen, dev, L=L_KERNEL):
    """q [B,H,D] bf16 and a [B,KV,L,D] cache (bf16, or int8 + f32
    scales) filled up to each row's cursor and POISONed past it; B is
    the number of cursors."""
    B, D = curs.shape[0], D_KERNEL
    q = torch.randn(B, H, D, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, KV, L, D, generator=gen, device=dev)
    v = torch.randn(B, KV, L, D, generator=gen, device=dev)
    dead = (torch.arange(L, device=dev)[None, :]
            > curs[:, None])[:, None, :]                      # [B, 1, L]
    if cache == "bf16":
        k = torch.where(dead[..., None], POISON, k).bfloat16()
        v = torch.where(dead[..., None], POISON, v).bfloat16()
        return q, k, v, None, None
    out = []
    for x in (k, v):
        s = torch.clamp(x.abs().amax(-1) / 127.0, min=1e-8)
        x8 = torch.clamp(torch.round(x / s[..., None]), -127, 127)
        out.append((torch.where(dead[..., None], 127.0, x8).to(torch.int8),
                    torch.where(dead, POISON, s)))
    (k8, ks), (v8, vs) = out
    return q, k8, v8, ks, vs


def time_ms(fn, iters, flush) -> float:
    """Median device time of one call, from CUDA events around each call
    with the 50 MB L2 flushed before it (the serving step reaches each
    layer's cache cold, after the other layers' weights)."""
    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for e0, e1 in ev:
        flush.zero_()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return float(np.median([e0.elapsed_time(e1) for e0, e1 in ev]))


def bound(H, KV, cache, curs, page_size=None, L=L_KERNEL):
    """(bound_ms, bound_by): the larger of the bytes K4 must move — the
    filled prefix of k and v (plus 8 bytes a position for int8 scales),
    q, the cursors and the output, each once — over HBM bandwidth, and
    its multiply-adds (q.k and p.v, 4 ops a position, head and element)
    over the bf16 tensor-core rate. With `page_size` (K5), plus the
    4-byte page-table entries the cursors reach."""
    B, D = curs.shape[0], D_KERNEL
    last = (curs.long() + 1).clamp(max=L)
    positions = int(last.sum())
    elt = 1 if cache == "int8" else 2
    nbytes = positions * KV * (2 * D * elt + (8 if cache == "int8" else 0))
    nbytes += 2 * B * H * D * 2 + B * 4
    if page_size is not None:
        nbytes += int(((last - 1).clamp(min=0) // page_size + 1).sum()) * 4
    ops = positions * H * D * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# the decode cursor sets that are timed beside their bound
TIMED_CURSORS = ("serving", "long", "paged-serving")
# the paged serving phase's logical cache length (its max_len)
L_PAGED = 384


def decode_cursor_sets(ops, KV, edges, dev):
    """The decode phases' B=8 cursor sets for one head layout: `edges`;
    the split edges of the split length the wrappers pick at this layout
    (length - 1, + 0, + 1, twice the length, 1022, 1023, and a short row
    whose later splits lie wholly past its cursor); the serving phase's
    depths (prompt <= 128 + new <= 64); and a long set, 896..1023."""
    rs = np.random.RandomState(0)
    c = ops.decode_split_len(L_KERNEL, B_KERNEL * KV,
                             torch.cuda.get_device_properties(
                                 dev).multi_processor_count,
                             ops.decode_tile(torch.bfloat16))
    return {
        "edges": edges,
        "split-edges": [c - 1, c, c + 1, 2 * c - 1, 2 * c, 1022, 1023, 5],
        "serving": sorted(rs.randint(32, 192, B_KERNEL).tolist()),
        "long": sorted(np.random.RandomState(1).randint(
            896, 1024, B_KERNEL).tolist()),
    }


def kernel_phase(k4, dev):
    """K4 vs its plain version at the main path's head layouts; returns
    (max_abs_err over every check, the timing row of the main path's
    layout: gpt2-medium, bf16 cache, serving cursors)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB
    worst, main_row = 0.0, None
    for layout, (H, KV) in LAYOUTS.items():
        cursor_sets = decode_cursor_sets(
            k4, KV, [0, 1, 63, 64, 65, 511, 1022, 1023], dev)
        for cache in ("bf16", "int8"):
            for cname, cl in cursor_sets.items():
                curs = torch.tensor(cl, dtype=torch.int32, device=dev)
                q, k, v, ks, vs = poisoned_cache(H, KV, cache, curs, gen, dev)
                out = k4.decode_attention(q, k, v, curs, ks, vs)
                torch.cuda.synchronize()
                ref = k4.decode_attention_ref(q, k, v, curs, ks, vs)
                err = float((out.float() - ref.float()).abs().max())
                check(torch.isfinite(out).all().item(),
                      f"K4 {layout} {cache} {cname}: non-finite output")
                check(torch.allclose(out.float(), ref.float(),
                                     atol=KERNEL_ATOL, rtol=KERNEL_RTOL),
                      f"K4 {layout} {cache} {cname}: max |kernel - plain| "
                      f"= {err} beyond atol {KERNEL_ATOL} rtol "
                      f"{KERNEL_RTOL}")
                worst = max(worst, err)
                if cname not in TIMED_CURSORS:
                    log(f"  K4 {layout:11s} {cache:4s} {cname:11s} "
                        f"max_abs_err {err:.3e} cursors {cl}")
                    continue
                ms = time_ms(lambda: k4.decode_attention(q, k, v, curs, ks,
                                                         vs), 50, flush)
                plain_ms = time_ms(lambda: k4.decode_attention_ref(
                    q, k, v, curs, ks, vs), 10, flush)
                library_ms = None
                if cache == "bf16":
                    mask = (torch.arange(L_KERNEL, device=dev)[None, :]
                            <= curs[:, None])[:, None, None, :]
                    q4 = q[:, :, None]
                    library_ms = time_ms(
                        lambda: F.scaled_dot_product_attention(
                            q4, k, v, attn_mask=mask, enable_gqa=H != KV),
                        50, flush)
                bound_ms, bound_by = bound(H, KV, cache, curs)
                log(f"  K4 {layout:11s} {cache:4s} {cname:11s} "
                    f"max_abs_err {err:.3e}  kernel {ms:.4f} ms  plain "
                    f"{plain_ms:.4f} ms  sdpa {library_ms} ms  bound "
                    f"{bound_ms:.4f} ms ({bound_by}) cursors {cl}")
                if (layout == "gpt2-medium" and cache == "bf16"
                        and cname == "serving"):
                    main_row = dict(ms=ms, plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    library_ms=library_ms)
    del flush
    return worst, main_row


def paged_pool(k, v, ks, vs, curs, ps, gen):
    """The logical [B,KV,L,D] cache (and [B,KV,L] scales) scattered into
    a pool of B*nblk + 2 pages through a seeded permutation of pages
    1..NP-2: the trash page 0 and the never-mapped page NP-1 hold
    POISON. The two rows with the largest cursors share their first
    pages (up to 2, all below both cursors), as a prefix hit does; the
    logical cache of the second is made to match. Returns the pool
    tensors, the int32 [B, nblk] table and the (possibly edited) logical
    cache."""
    B, KV, L, D = k.shape
    nblk = L // ps
    NP = B * nblk + 2
    table = (torch.randperm(NP - 2, generator=gen, device=k.device)
             + 1).reshape(B, nblk)
    i, j = torch.sort(curs, stable=True).indices[-2:].tolist()
    n = min(2, (int(curs[i]) + 1) // ps, nblk)
    table[j, :n] = table[i, :n]
    logical = [None if x is None else x.clone() for x in (k, v, ks, vs)]
    for x in logical:
        if x is not None:
            x[j, :, :n * ps] = x[i, :, :n * ps]
    flat = table.reshape(-1)

    def pool(x, fill):
        out = torch.full((NP, KV, ps) + tuple(x.shape[3:]), fill,
                         dtype=x.dtype, device=x.device)
        blocks = x.reshape(B, KV, nblk, ps, *x.shape[3:]).transpose(1, 2)
        out[flat] = blocks.reshape(B * nblk, KV, ps, *x.shape[3:])
        return out
    dead = 127 if k.dtype == torch.int8 else POISON
    pools = [pool(logical[0], dead), pool(logical[1], dead)]
    pools += [None, None] if ks is None else [pool(logical[2], POISON),
                                              pool(logical[3], POISON)]
    return pools, table.to(torch.int32), logical


def paged_kernel_phase(ops, dev):
    """K5 vs its plain version and vs K4 on the gathered cache; returns
    (max_abs_err over every check, the timing row of the main path's
    shape: gpt2-medium, bf16 pool, pages of 64, the paged serving
    phase's L and cursor depths)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)  # 256 MB
    worst, main_row = 0.0, None
    for layout, (H, KV) in LAYOUTS.items():
        cursor_sets = decode_cursor_sets(
            ops, KV, [0, 1, 15, 16, 17, 63, 64, 65, 1022, 1023], dev)
        # the paged serving phase's own shape: L = max_len 384, a
        # 128-token prefix plus 32..128 prompt and up to 64 new tokens
        cursor_sets["paged-serving"] = sorted(np.random.RandomState(
            2).randint(160, 320, B_KERNEL).tolist())
        for cache in ("bf16", "int8"):
            for ps in (64, 16):
                for cname, cl in cursor_sets.items():
                    L = L_PAGED if cname == "paged-serving" else L_KERNEL
                    curs = torch.tensor(cl, dtype=torch.int32, device=dev)
                    q, k, v, ks, vs = poisoned_cache(H, KV, cache, curs,
                                                     gen, dev, L)
                    (kp, vp, ksp, vsp), pt, (k, v, ks, vs) = paged_pool(
                        k, v, ks, vs, curs, ps, gen)
                    tag = (f"K5 {layout:11s} {cache:4s} ps {ps:2d} "
                           f"{cname:11s}")
                    out = ops.paged_decode_attention(q, kp, vp, curs, pt,
                                                     ksp, vsp)
                    torch.cuda.synchronize()
                    ref = ops.paged_decode_attention_ref(q, kp, vp, curs, pt,
                                                         ksp, vsp)
                    err = float((out.float() - ref.float()).abs().max())
                    check(torch.isfinite(out).all().item(),
                          f"{tag}: non-finite output")
                    check(torch.allclose(out.float(), ref.float(),
                                         atol=KERNEL_ATOL, rtol=KERNEL_RTOL),
                          f"{tag}: max |kernel - plain| = {err} beyond "
                          f"atol {KERNEL_ATOL} rtol {KERNEL_RTOL}")
                    k4_out = ops.decode_attention(q, k, v, curs, ks, vs)
                    diff = float((out.float() - k4_out.float()).abs().max())
                    check(torch.equal(out, k4_out),
                          f"{tag}: K5 differs from K4 on the gathered cache "
                          f"by {diff}")
                    worst = max(worst, err)
                    if cname not in TIMED_CURSORS:
                        log(f"  {tag} max_abs_err {err:.3e}  == K4 cursors "
                            f"{cl}")
                        continue
                    ms = time_ms(lambda: ops.paged_decode_attention(
                        q, kp, vp, curs, pt, ksp, vsp), 50, flush)
                    k4_ms = time_ms(lambda: ops.decode_attention(
                        q, k, v, curs, ks, vs), 50, flush)
                    plain_ms = time_ms(lambda: ops.paged_decode_attention_ref(
                        q, kp, vp, curs, pt, ksp, vsp), 10, flush)
                    bound_ms, bound_by = bound(H, KV, cache, curs, ps, L)
                    log(f"  {tag} max_abs_err {err:.3e}  == K4  kernel "
                        f"{ms:.4f} ms  K4 on the gathered cache {k4_ms:.4f} "
                        f"ms  plain {plain_ms:.4f} ms  bound {bound_ms:.5f} "
                        f"ms ({bound_by}) cursors {cl}")
                    if (layout == "gpt2-medium" and cache == "bf16"
                            and ps == 64 and cname == "paged-serving"):
                        main_row = dict(ms=ms, plain_ms=plain_ms,
                                        bound_ms=bound_ms, bound_by=bound_by,
                                        library_ms=None)
    del flush
    return worst, main_row


# ---------------------------------------------------------------------------
# the serving phases
# ---------------------------------------------------------------------------

def make_paged_trace(vocab, n, seed, shared_len, prompt_grid, new_grid):
    """The JAX bench's shared-system-prompt trace: one seeded system
    prompt of `shared_len` tokens, then per request a random tail from
    `prompt_grid` and a new-token budget from `new_grid`; all greedy,
    all waiting at t=0."""
    from mpi_operator_tpu_torch.serve import Request
    rs = np.random.RandomState(seed)
    system = rs.randint(0, vocab, shared_len).tolist()
    return [Request(id=i, prompt=system + rs.randint(
        0, vocab, int(rs.choice(prompt_grid))).tolist(),
        max_new_tokens=int(rs.choice(new_grid))) for i in range(n)]


def make_trace(vocab, n, seed):
    """The serving benchmark's trace shape: prompts of 32/64/128 random
    tokens, 32 or 64 new tokens, odd ids sampled (temperature 0.8,
    top_k 40), even ids greedy; every request waiting at t=0."""
    from mpi_operator_tpu_torch.serve import Request
    rs = np.random.RandomState(seed)
    trace = []
    for i in range(n):
        p, new = int(rs.choice((32, 64, 128))), int(rs.choice((32, 64)))
        temp = 0.8 if i % 2 == 1 else 0.0
        trace.append(Request(id=i, prompt=rs.randint(0, vocab, p).tolist(),
                             max_new_tokens=new, temperature=temp,
                             top_k=40 if temp > 0 else 0))
    return trace


@torch.inference_mode()
def teacher_forced_logp(dense, req, tokens):
    """log_softmax of the dense path's logits at the positions that
    chose each new token: [n, V] f32."""
    seq = list(req.prompt) + tokens[:-1]
    toks = torch.tensor([seq], dtype=torch.int64, device=dense.device)
    logits = dense(toks, positions=np.arange(len(seq))[None],
                   cache=dense.new_cache(1))
    return torch.log_softmax(logits[0, len(req.prompt) - 1:].float(), -1)


def check_results(engine, trace, results, name):
    """Every request complete with finite logprobs; greedy tokens agree
    with the dense path modulo near-ties; sampled tokens inside their
    top_k. Returns (greedy positions checked, positions where the engine
    chose the dense argmax exactly, worst logprob deviation)."""
    from mpi_operator_tpu_torch.models import decode_model
    dense = decode_model(engine.dmodel, decode_kernel=False)
    check(len(results) == len(trace), f"{name}: {len(results)} results for "
          f"{len(trace)} requests")
    n_pos = n_exact = 0
    worst = 0.0
    for req in trace:
        r = results[req.id]
        check(r.finish_reason == "length"
              and len(r.tokens) == req.max_new_tokens,
              f"{name}: request {req.id} ended {r.finish_reason} after "
              f"{len(r.tokens)}/{req.max_new_tokens} tokens")
        lp = np.asarray(r.logprobs)
        check(np.isfinite(lp).all() and (lp <= 1e-3).all(),
              f"{name}: request {req.id} has bad logprobs")
        logp = teacher_forced_logp(dense, req, r.tokens)
        idx = torch.tensor(r.tokens, device=logp.device)
        chosen = logp.gather(-1, idx[:, None])[:, 0].cpu()
        dev_lp = float((chosen - torch.from_numpy(lp).float()).abs().max())
        worst = max(worst, dev_lp)
        check(dev_lp <= LOGPROB_TOL,
              f"{name}: request {req.id} logprob differs from the dense "
              f"path by {dev_lp} > {LOGPROB_TOL}")
        if req.temperature == 0.0:
            gap = (logp.max(-1).values.cpu() - chosen)
            check(float(gap.max()) <= LOGPROB_TOL,
                  f"{name}: greedy request {req.id} chose a token "
                  f"{float(gap.max())} nats below the dense argmax")
            n_pos += len(r.tokens)
            n_exact += int((gap == 0).sum())
        else:
            kth = torch.topk(logp, req.top_k, -1).values[:, -1].cpu()
            check(bool((chosen >= kth - LOGPROB_TOL).all()),
                  f"{name}: sampled request {req.id} left its top_k")
    return n_pos, n_exact, worst


def kernel_group(name: str) -> str:
    if "decode_attention" in name:
        return ("K5 paged_decode_attention" if "PagedRows" in name
                else "K4 decode_attention")
    for kernel, group in (("flash_fwd_kernel", "K1 flash_fwd"),
                          ("flash_dq_kernel", "K2 flash_dq"),
                          ("flash_dkv_kernel", "K3 flash_dkv")):
        if kernel in name:
            return group
    if any(s in name.lower() for s in ("gemm", "xmma", "cutlass", "gemv",
                                       "nvjet")):
        return "GEMM (cuBLAS)"
    return name[:70]


KERNEL_GROUPS = {"decode_attention": "K4 decode_attention",
                 "paged_decode_attention": "K5 paged_decode_attention"}


#: windows a short profiler count is run again before it fails: the
#: profiler (CUPTI) may drop a kernel record now and then, so only a count
#: that stays short is a fault (the deterministic count is checked first,
#: in every window)
PROFILE_RERUNS = 3


def profile_window(engine, trace, ticks):
    """One profiled window: the engine takes `trace` again (after the
    measured run, so the phase's launch counts are untouched), runs until
    every request has finished prefilling, then `ticks` loop iterations
    under torch.profiler, then drains. Returns (profiler, wall us, decode
    steps, verify steps, wrapper launch counts over the window, results)."""
    from torch.profiler import ProfilerActivity, profile

    from mpi_operator_tpu_torch.ops import attention as ops
    engine.reset()
    engine.start()
    for r in trace:
        engine.submit(r)
    engine.tick()                                     # admits the trace
    while engine.scheduler.next_prefill() is not None:
        engine.tick()
    steps0, verify0 = engine.steps_dispatched, engine.spec_steps
    torch.cuda.synchronize()
    launches0 = dict(ops.launch_counts)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            engine.tick()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    launched = {k: ops.launch_counts[k] - launches0[k] for k in launches0}
    steps = engine.steps_dispatched - steps0
    verify = engine.spec_steps - verify0
    while engine.active:
        engine.tick()
    return prof, wall_us, steps, verify, launched, engine.finish()


def device_groups(prof):
    """({kernel group: [device us, records]}, {runtime call: count}) of
    a profiler's events."""
    groups, runtime = {}, {}
    for e in prof.events():
        if e.is_user_annotation:
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            g = groups.setdefault(kernel_group(e.name), [0.0, 0])
            g[0] += e.time_range.elapsed_us()
            g[1] += 1
        elif re.match(r"cu(da)?[A-Z]", e.name):
            runtime[e.name] = runtime.get(e.name, 0) + 1
    return groups, runtime


def profile_run(engine, trace, kernel=None, ticks=20):
    """Where a serving run's time goes: `profile_window` over `ticks`
    loop iterations (one decode step each). Prints the device's busy and
    idle share of that window, device time by kernel group and the
    host's CUDA runtime calls a step (launch calls: kernels and graphs).
    Kernels run on one stream and do not overlap, so their summed time
    is the busy time. A speculative engine's window mixes verify steps
    (counted apart) with plain decode steps.

    With `kernel`, its launches in the window must equal layers x plain
    decode steps, counted where no record can be lost: each replay of a
    CUDA graph adds the launches its capture made (the wrappers'
    counters during capture, serve/programs.py), and each eager launch
    adds one. The profiler's own count of its device records is printed
    beside it: more records than that count fail, and fewer fail only if
    the window is still short when run again, up to PROFILE_RERUNS
    times (the profiler drops a kernel record now and then). Returns
    the window's numbers."""
    layers = engine.model_config.num_layers
    for attempt in range(PROFILE_RERUNS + 1):
        prof, wall_us, steps, verify, launched, _ = profile_window(
            engine, trace, ticks)
        groups, runtime = device_groups(prof)
        if kernel is None:
            break
        want = layers * (steps - verify)
        check(steps > 0 and launched[kernel] == want,
              f"{launched[kernel]} {kernel} launches (captured nodes x "
              f"replays, and eager launches) over {steps - verify} plain "
              f"decode steps of {layers} layers; expected {want}")
        seen = groups.get(KERNEL_GROUPS[kernel], [0.0, 0])[1]
        check(seen <= want, f"the profiler saw {seen} {kernel} launches, "
              f"more than the {want} launched")
        log(f"  profile: {kernel} launches {launched[kernel]} (layers x "
            f"plain steps {want}), profiler records {seen}"
            + ("" if attempt == 0 else f" (window run {attempt + 1})"))
        if seen == want:
            break
        check(attempt < PROFILE_RERUNS,
              f"the profiler saw {seen} {kernel} launches over "
              f"{steps - verify} plain decode steps of {layers} layers in "
              f"{PROFILE_RERUNS + 1} windows running; {want} were launched")
    busy = sum(g[0] for g in groups.values())
    n = max(steps, 1)
    launch_calls = sum(c for name, c in runtime.items() if "Launch" in name)
    stats = dict(steps=steps, verify_steps=verify,
                 device_busy_ms=busy / 1e3, wall_ms_per_step=wall_us / 1e3 / n,
                 device_ms_per_step=busy / 1e3 / n,
                 idle_share=1 - busy / wall_us,
                 launch_calls_per_step=launch_calls / n,
                 runtime_calls_per_step=sum(runtime.values()) / n)
    log(f"  profile: {steps} decode steps ({verify} of them verify "
        f"steps), wall {wall_us / 1e3:.2f} ms "
        f"({stats['wall_ms_per_step']:.3f} ms a step), device busy "
        f"{busy / 1e3:.2f} ms ({stats['device_ms_per_step']:.3f} ms a "
        f"step), idle share {stats['idle_share']:.3f}, host launch calls "
        f"{stats['launch_calls_per_step']:.1f} a step (CUDA runtime calls "
        f"{stats['runtime_calls_per_step']:.1f})")
    for name, (us, c) in sorted(groups.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  profile: {us / 1e3:8.3f} ms {us / max(busy, 1e-9):6.1%} "
            f"{c:5d} launches  {name}")
    for name, c in sorted(runtime.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  profile host: {c / n:8.1f} calls a step  {name}")
    if kernel is not None:
        stats["kernel_launches"] = launched[kernel]
        stats["profiled_kernel_launches"] = seen
        stats["profile_windows_run"] = attempt + 1
    return stats


class SkipOneLayer:
    """A planted fault for profile_run's launch check: while installed,
    the decode step's attention in layer `layer` runs the kernel's plain
    version instead of the kernel (calls are counted modulo the layers,
    which every step makes in order), so each graph captured meanwhile
    holds one K4/K5 node fewer than its layers."""

    def __init__(self, kernel, layers, layer=5):
        from mpi_operator_tpu_torch.models import transformer
        from mpi_operator_tpu_torch.ops import attention as ops
        self.module, self.name = transformer, kernel
        self.real = getattr(transformer, kernel)
        self.plain = getattr(ops, f"{kernel}_ref")
        self.layers, self.layer, self.calls = layers, layer, 0

    def __call__(self, *args, **kwargs):
        i, self.calls = self.calls % self.layers, self.calls + 1
        return (self.plain if i == self.layer else self.real)(*args, **kwargs)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def planted_skip_check(model, config, trace, kernel, windows=3):
    """profile_run's launch check against SkipOneLayer on a fresh graphed
    engine: it must fail in each of `windows` windows. Returns the
    messages it failed with."""
    from mpi_operator_tpu_torch.serve import ServingEngine
    failures = []
    with SkipOneLayer(kernel, model.config.num_layers):
        engine = ServingEngine(model, config)
        engine.run(trace[:2])
        check(engine.cuda_graphs, "the planted fault needs CUDA graphs on")
        for _ in range(windows):
            try:
                profile_run(engine, trace, kernel)
            except RuntimeError as e:
                failures.append(str(e))
    check(len(failures) == windows,
          f"the launch check passed a step that skips {kernel} in one "
          f"layer in {windows - len(failures)} of {windows} windows")
    log(f"  planted fault (one layer's {kernel} skipped in the captured "
        f"step): the launch check failed {len(failures)} of {windows} "
        f"windows: {failures[0]}")
    del engine
    return failures


def serve_phase(name, model, trace, ops, config, kernel,
                profile_requests=0, shared_len=0):
    """Warm the engine on two requests, reset, then drive `trace` with
    every kernel count zeroed just before and read just after: `kernel`
    must have launched once a layer a decode step, every other kernel
    never. A paged `config` also checks the prefix cache (every request
    reports 0 or `shared_len` cached tokens, at least one the latter)
    and that the allocator is empty afterwards. Then, with
    `profile_requests`, profile a run of that many requests."""
    from mpi_operator_tpu_torch.serve import ServingEngine
    num_layers = model.config.num_layers
    engine = ServingEngine(model, config)
    engine.run(trace[:2])
    engine.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = engine.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    launches = counts[kernel]
    steps = engine.steps_dispatched
    check(steps > 0 and launches == num_layers * steps,
          f"{name}: {kernel} launched {launches} times over {steps} decode "
          f"steps of {num_layers} layers")
    check(all(n == 0 for k, n in counts.items() if k != kernel),
          f"{name}: other kernels launched: {counts}")
    programs = engine.compile_counts()
    captured = engine.capture_counts()
    check(programs["step"] <= 3
          and programs["prefill"] <= len(config.chunk_buckets)
          and captured == {k: programs[k] for k in captured},
          f"{name}: programs {programs}, CUDA graphs {captured}")
    n_pos, n_exact, worst = check_results(engine, trace, results, name)
    new_tokens = sum(len(r.tokens) for r in results.values())
    ttft = [r.ttft for r in results.values()]
    tpot = [dt for r in results.values() for dt in np.diff(r.token_times)]
    pct = lambda xs, p: float(np.percentile(xs, p)) * 1e3  # noqa: E731
    stats = dict(requests=len(trace), new_tokens=new_tokens,
                 wall_s=wall, tokens_per_s=new_tokens / wall,
                 ttft_p50_ms=pct(ttft, 50), ttft_p99_ms=pct(ttft, 99),
                 tpot_p50_ms=pct(tpot, 50), tpot_p99_ms=pct(tpot, 99),
                 decode_steps=steps, launches={kernel: launches},
                 greedy_positions=n_pos, greedy_exact_argmax=n_exact,
                 max_logprob_dev=worst, programs=programs, graphs=captured,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                 reserved_gib=torch.cuda.memory_reserved() / 2**30)
    if config.paged:
        alloc = engine.page_allocator
        cached = sorted({r.cached_tokens for r in results.values()})
        check(set(cached) <= {0, shared_len} and shared_len in cached,
              f"{name}: cached_tokens {cached}, expected 0 or {shared_len} "
              f"with at least one hit")
        check(alloc.in_use == 0, f"{name}: {alloc.in_use} pages still in "
              f"use after the run")
        alloc.check()
        adm = {c: [(r.token_times[0] - r.admitted_at) for r in
                   results.values() if r.cached_tokens == c] for c in cached}
        stats.update(
            prefix_hit_requests=len(adm.get(shared_len, [])),
            prefix_hit_rate=alloc.hits / max(alloc.hits + alloc.misses, 1),
            ttft_from_admission_cold_p50_ms=pct(adm[0], 50) if 0 in adm
            else None,
            ttft_from_admission_hit_p50_ms=pct(adm[shared_len], 50),
            pages_in_use_peak=engine.pages_in_use_peak,
            pages_usable=alloc.usable, occupancy_peak=engine.occupancy_peak)
    log(f"  {name}: {json.dumps(stats)}")
    if profile_requests:
        profile_run(engine, trace[:profile_requests], kernel)
    return launches


def ab_runs(model, trace, configs):
    """Serve `trace` once with each (name, EngineConfig) in turn, after
    a two-request warm-up of each engine; prints and returns each run's
    throughput and TTFT/TPOT p50. No checks: the phases before it check
    these paths."""
    from mpi_operator_tpu_torch.serve import ServingEngine
    engines = {}
    out = []
    for name, config in configs:
        if name not in engines:
            engines[name] = ServingEngine(model, config)
            engines[name].run(trace[:2])
        engine = engines[name]
        engine.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.run(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        new = sum(len(r.tokens) for r in results.values())
        tpot = [dt for r in results.values() for dt in np.diff(r.token_times)]
        row = dict(engine=name, tokens_per_s=new / wall,
                   ttft_p50_ms=float(np.percentile(
                       [r.ttft for r in results.values()], 50)) * 1e3,
                   tpot_p50_ms=float(np.percentile(tpot, 50)) * 1e3,
                   decode_steps=engine.steps_dispatched)
        log(f"  A/B: {json.dumps(row)}")
        out.append(row)
    return out


# the serving benchmark's legs (bench.py's `serving` and `serving_paged`
# at full size), and a sampled variant of the first for the graphs A/B;
# 12 requests of bench.py's 32, to make room for [train-lm-mp] in the
# run's time (PERF.md section 6)
BENCH_COMMON = dict(size="medium", slots=8, num_requests=12,
                    prompt_grid=(32, 64, 128), new_grid=(32, 64),
                    chunk_buckets=(32, 128), compare_graphs=True)
BENCH_LEGS = [
    ("serving", dict(compare_sync=True, compare_hooks=True),
     "decode_attention"),
    ("serving-sampled", dict(temperature=0.8, baseline=False),
     "decode_attention"),
    ("serving_paged", dict(paged=True, page_size=64, shared_prefix_len=128,
                           baseline=False), "paged_decode_attention"),
]


def build_every_program(engine):
    """Serve one request a sampling mode (greedy; bounded: top_k 40;
    full: top_k 0), each alone, with prompts that reach both chunk
    buckets, so the engine builds all its programs: 3 step programs and
    one prefill program a bucket, each captured once with graphs on."""
    from mpi_operator_tpu_torch.serve import Request
    rs = np.random.RandomState(5)
    vocab = engine.model_config.vocab_size
    small, big = engine.config.chunk_buckets[0], engine.config.chunk_buckets[-1]
    for i, (p, temp, top_k) in enumerate([(big + small // 2 + 1, 0.0, 0),
                                          (small // 2 + 1, 0.8, 40),
                                          (small // 2 + 1, 0.8, 0)]):
        engine.run([Request(900 + i, rs.randint(0, vocab, p).tolist(), 4,
                            temperature=temp, top_k=top_k)])
    want = {"step": 3, "prefill": len(engine.config.chunk_buckets),
            "verify": 0}
    got = engine.compile_counts()
    check({k: got[k] for k in want} == want
          and engine.capture_counts() == (want if engine.cuda_graphs else
                                          dict.fromkeys(want, 0)),
          f"programs {got}, graphs {engine.capture_counts()}; expected "
          f"{want}")


def moved(runs, key, higher_is_better, arms=("graphs", "eager")):
    """(best of the first arm, best of the second, spread, verdict) of
    `key`: the best of each arm's two runs, the larger of the two arms'
    run-to-run spreads, and whether the arms' bests differ by more than
    that."""
    on = [r[key] for r in runs[arms[0]]]
    off = [r[key] for r in runs[arms[1]]]
    pick = max if higher_is_better else min
    spread = max(max(on) - min(on), max(off) - min(off))
    diff = pick(on) - pick(off)
    return pick(on), pick(off), spread, abs(diff) > spread


def ab_verdicts(m, arms):
    """moved() of tokens/s and TPOT p50/p99 over the report's
    serving_<arm>_runs of the two `arms`."""
    runs = {arm: m[f"serving_{arm}_runs"] for arm in arms}
    out = {}
    for metric, key, higher in (("tokens_per_s", "tokens_per_sec", True),
                                ("tpot_p50_ms", "run_tpot_p50_ms", False),
                                ("tpot_p99_ms", "run_tpot_p99_ms", False)):
        a, b, spread, beyond = moved(runs, key, higher, arms)
        out[metric] = {arms[0]: a, arms[1]: b, "spread": spread,
                       "moved_beyond_spread": beyond}
    return out


def bench_phase():
    """run_serving_benchmark at each BENCH_LEGS leg, graphs A/B included:
    the programs within the no-recompile contract and every one captured
    once, every token of the graphs arm equal to the eager arm's (greedy
    and sampled), the sync A/B's greedy tokens equal. Prints tokens/s and
    TPOT p50/p99 of both arms and whether they moved beyond the arms'
    run-to-run spread. The engine runs with ServeTelemetry and a
    Tracer(sample=1.0) attached, as the benchmark always runs it: every
    measured request's trace must be complete (its hops tile its
    end-to-end time), and the host gap p50 is printed. The `serving` leg
    also logs events to a temporary directory (a slot_admit and a
    slot_retire a request) and runs the hooks A/B (the same settings with
    no telemetry, tracer or event log, runs alternated, best of two an
    arm). Then, for the two bench legs, with graphs on and
    off: every program built (`build_every_program`) and the memory the
    engine reserved, and a profiled window of 20 decode steps of 8
    requests: device time a step, idle share, host launch calls a step,
    and the profiler's count of K4/K5 launches (layers x steps).
    Returns {leg: report}."""
    from mpi_operator_tpu_torch.examples.serve_benchmark import (
        run_serving_benchmark, serving_max_len, serving_trace)
    from mpi_operator_tpu_torch.models import create_lm
    from mpi_operator_tpu_torch.serve import EngineConfig, ServingEngine
    out = {}
    for leg, kw, kernel in BENCH_LEGS:
        with tempfile.TemporaryDirectory() as tmp:
            events = (os.path.join(tmp, "events.jsonl")
                      if kw.get("compare_hooks") else None)
            m = run_serving_benchmark(**BENCH_COMMON, **kw,
                                      events_path=events,
                                      log=lambda line: log(f"  {line}"))
        check(m["serving_trace_complete"]
              and m["serving_host_gap_p50_ms"] is not None,
              f"{leg}: trace complete {m['serving_trace_complete']}, host "
              f"gap p50 {m['serving_host_gap_p50_ms']}")
        log(f"  [{leg}] hooks: host gap p50/p99 "
            f"{m['serving_host_gap_p50_ms']}/{m['serving_host_gap_p99_ms']}"
            f" ms, trace max gap {m['serving_trace_max_gap_ms']} ms, hops "
            f"{json.dumps({k: v for k, v in m.items() if '_hop_' in k})}")
        if kw.get("compare_hooks"):
            n = BENCH_COMMON["num_requests"]
            check(m["serving_events_logged"] == 2 * n
                  and m["serving_hooks_greedy_identical"],
                  f"{leg}: {m['serving_events_logged']} events for {n} "
                  f"requests, tokens identical with and without hooks "
                  f"{m['serving_hooks_greedy_identical']}")
            m["hooks_ab"] = ab_verdicts(m, ("hooks", "nohooks"))
            log(f"  [{leg}] hooks A/B: {json.dumps(m['hooks_ab'])}, cost "
                f"{m['serving_hooks_cost']:.4f} of the hooks arm's wall")
        check(m["serving_no_recompile"]
              and m["serving_step_captures"] == m["serving_step_compiles"]
              and m["serving_prefill_captures"]
              == m["serving_prefill_compiles"],
              f"{leg}: programs {m['serving_step_compiles']} / "
              f"{m['serving_prefill_compiles']}, graphs "
              f"{m['serving_step_captures']} / "
              f"{m['serving_prefill_captures']}")
        check(m["serving_graphs_tokens_identical"],
              f"{leg}: graphs and eager arms gave different tokens")
        check(m.get("serving_async_greedy_identical", True),
              f"{leg}: sync and async loops gave different greedy tokens")
        m["graphs_ab"] = ab_verdicts(m, ("graphs", "eager"))
        log(f"  [{leg}] graphs A/B: {json.dumps(m['graphs_ab'])}")
        if leg != "serving-sampled":
            paged = kw.get("paged", False)
            shared = kw.get("shared_prefix_len", 0)
            page_size = kw.get("page_size", 64)
            grids = BENCH_COMMON["prompt_grid"], BENCH_COMMON["new_grid"]
            model = create_lm(f"gpt2-{BENCH_COMMON['size']}", seed=0,
                              dtype=torch.bfloat16, decode_kernel=True,
                              max_len=serving_max_len(*grids, shared, paged,
                                                      page_size))
            trace, _ = serving_trace(model.config.vocab_size,
                                     BENCH_COMMON["slots"], *grids,
                                     shared_prefix_len=shared)
            for graphs in (True, False):
                # engines are freed by the cycle collector (their
                # programs hold bound methods): collect them before the
                # memory baseline, so the delta is this engine's alone
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved()
                engine = ServingEngine(model, EngineConfig(
                    slots=BENCH_COMMON["slots"],
                    chunk_buckets=BENCH_COMMON["chunk_buckets"],
                    paged=paged, page_size=page_size, cuda_graphs=graphs))
                build_every_program(engine)
                torch.cuda.synchronize()
                engine_gib = (torch.cuda.memory_reserved() - reserved) / 2**30
                log(f"  [{leg}] graphs {graphs}: programs "
                    f"{engine.compile_counts()}, graphs "
                    f"{engine.capture_counts()}; memory reserved by the "
                    f"engine (cache, programs, pools) {engine_gib:.3f} GiB")
                m[f"profile_graphs_{graphs}"] = dict(
                    profile_run(engine, trace, kernel),
                    engine_reserved_gib=engine_gib)
                del engine
                if graphs and leg == "serving":
                    planted_skip_check(model, EngineConfig(
                        slots=BENCH_COMMON["slots"],
                        chunk_buckets=BENCH_COMMON["chunk_buckets"]),
                        trace, kernel, windows=2)
            del model
            torch.cuda.empty_cache()
        keys = ("serving_tokens_per_sec", "serving_tpot_p50_ms",
                "serving_tpot_p99_ms", "serving_ttft_p50_ms",
                "serving_ttft_p99_ms", "serving_eager_tokens_per_sec",
                "serving_graphs_speedup", "serving_step_compiles",
                "serving_prefill_compiles", "serving_no_recompile",
                "sequential_tokens_per_sec", "serving_vs_sequential",
                "serving_async_speedup", "serving_prefix_hit_rate",
                "serving_ttft_cold_p50_ms", "serving_ttft_hit_p50_ms",
                "serving_pages_in_use_peak", "serving_host_gap_p50_ms",
                "serving_host_gap_p99_ms", "serving_trace_complete",
                "serving_nohooks_tokens_per_sec", "serving_hooks_cost",
                "profile_graphs_True", "profile_graphs_False")
        log(f"  [{leg}] {json.dumps({k: m[k] for k in keys if k in m})}")
        out[leg] = m
    return out


# ---------------------------------------------------------------------------
# the speculative serving phase
# ---------------------------------------------------------------------------

# the JAX bench's serving_spec leg at full size (bench.py:558-583): the
# paged serving leg with prompt-lookup drafting, then the same contiguous
# 16 requests of the leg's 32, to make room for [train-lm-mp] in the
# run's time (PERF.md section 6)
SPEC_COMMON = dict(size="medium", slots=8, num_requests=16,
                   prompt_grid=(32, 64, 128), new_grid=(32, 64),
                   chunk_buckets=(32, 128), shared_prefix_len=128,
                   decode_kernel=True, speculative="ngram", draft_k=4,
                   compare_spec=True, baseline=False)
SPEC_LEGS = [
    ("spec_paged", dict(paged=True, page_size=64), "paged_decode_attention"),
    ("spec_contiguous", {}, "decode_attention"),
]
# where the spec and no-spec arms choose different greedy tokens, in
# nats of the dense path's log-softmax: the verify step runs dense
# attention and a W-row GEMM, the plain step K4/K5 and a 1-row GEMM, all
# in bf16, and each arm stays within LOGPROB_TOL of the dense path
# (check_results). So two tokens can differ only where the dense path's
# top-2 margin is under that tolerance, and both must lie within it of
# its argmax. A token accepted without a match lies far below it.
SPEC_MARGIN = LOGPROB_TOL


@contextlib.contextmanager
def recorded_runs():
    """Record every ServingEngine.run in the block as (engine, requests,
    results, speculative)."""
    from mpi_operator_tpu_torch.serve import ServingEngine
    runs = []
    run = ServingEngine.run

    def recording(self, requests=(), on_token=None):
        results = run(self, requests, on_token)
        runs.append((self, list(requests), results,
                     self.config.speculative))
        return results
    ServingEngine.run = recording
    try:
        yield runs
    finally:
        ServingEngine.run = run


def first_divergences(dense, trace, got, want):
    """For each greedy request whose tokens differ between the runs
    `got` and `want`: the first index i where they do, the dense path's
    top-2 margin at it (given the prompt and want's tokens before i) and
    how far below the dense argmax each run's token lies, in nats."""
    out = []
    for req in trace:
        if req.temperature > 0:
            continue
        a, b = got[req.id].tokens, want[req.id].tokens
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            continue
        logp = teacher_forced_logp(dense, req, b[:i + 1])[-1]
        top2 = torch.topk(logp, 2).values
        out.append(dict(request=req.id, index=i,
                        margin=float(top2[0] - top2[1]),
                        gap=float(top2[0] - logp[a[i]]),
                        want_gap=float(top2[0] - logp[b[i]])))
    return out


def near_tie(d) -> bool:
    return max(d["margin"], d["gap"], d["want_gap"]) <= SPEC_MARGIN


def planted_fault_engine():
    """A ServingEngine whose greedy acceptance takes one draft token more
    than matched: the fault the identity check must catch. `planted`
    counts the verify rows where the fault changed what was accepted."""
    from mpi_operator_tpu_torch.serve import ServingEngine

    class AcceptOneMore(ServingEngine):
        planted = 0

        def _accepted(self, draft, targets):
            n = ServingEngine._accepted(draft, targets)
            if n < len(draft):
                self.planted += 1
                return n + 1
            return n
    return AcceptOneMore


def spec_phase(ops):
    """run_serving_benchmark at each SPEC_LEGS leg, the spec A/B included
    (no-spec, spec, no-spec after the measured spec run; best of two an
    arm). Prints the acceptance rate, effective tokens a row-step, verify
    steps, tokens/s and TPOT p50/p99 of both arms and whether they moved
    beyond the arms' spread. Checks: the no-recompile contract with at
    most len(_verify_buckets) verify programs (one sampling mode: the
    trace is greedy), each captured once; both arms' tokens and logprobs
    against the teacher-forced dense path (check_results); every token
    where the arms differ a near tie (SPEC_MARGIN), and a planted fault
    (one draft token accepted past the match) caught by that check; K4 /
    K5 launched layers x plain decode steps in a spec run, no other
    kernel. Then profiled windows with speculation on and off: device
    time a verify step against a plain step, and the idle share. Last, a
    decode_kernel=False contiguous run in f32 (16 requests) must give
    the same greedy tokens with speculation and without."""
    from mpi_operator_tpu_torch.examples.serve_benchmark import (
        run_serving_benchmark)
    from mpi_operator_tpu_torch.models import decode_model
    out = {}
    n = SPEC_COMMON["num_requests"]
    for leg, kw, kernel in SPEC_LEGS:
        with recorded_runs() as runs:
            m = run_serving_benchmark(**SPEC_COMMON, **kw,
                                      log=lambda line: log(f"  {line}"))
        measured = [r for r in runs if len(r[1]) == n]
        engine, trace, spec_res, _ = next(r for r in measured if r[3])
        nospec_res = next(r for r in measured if r[3] is None)[2]
        del runs, measured
        counts, caps = engine.compile_counts(), engine.capture_counts()
        check(m["serving_no_recompile"]
              and 1 <= counts["verify"] <= len(engine._verify_buckets)
              and caps == {k: counts[k] for k in caps},
              f"{leg}: programs {counts}, CUDA graphs {caps}")
        stats = {k: m[f"serving_spec_{k}"] for k in (
            "acceptance_rate", "effective_tokens_per_step", "verify_steps",
            "proposed", "accepted")}
        m["spec_ab"] = ab_verdicts(m, ("spec", "nospec"))
        log(f"  [{leg}] speculation: {json.dumps(stats)}; programs "
            f"{counts}, graphs {caps}")
        log(f"  [{leg}] spec A/B: {json.dumps(m['spec_ab'])}, spec over "
            f"no-spec {m['serving_spec_speedup']:.4f}x in tokens/s, "
            f"greedy tokens identical {m['serving_spec_greedy_identical']}")
        dense = decode_model(engine.dmodel, decode_kernel=False)
        for arm, res in (("spec", spec_res), ("nospec", nospec_res)):
            n_pos, n_exact, worst = check_results(engine, trace, res,
                                                  f"{leg}-{arm}")
            log(f"  [{leg}] {arm} arm against the dense path: {n_exact} "
                f"of {n_pos} greedy tokens its argmax, worst logprob "
                f"deviation {worst:.4f}")
        div = first_divergences(dense, trace, spec_res, nospec_res)
        bad = [d for d in div if not near_tie(d)]
        check(not bad, f"{leg}: spec and no-spec arms diverge off a near "
              f"tie: {bad}")
        log(f"  [{leg}] arms diverge in {len(div)} of {n} requests, each "
            f"at a near tie (margins "
            f"{sorted(round(d['margin'], 4) for d in div)})")
        # the main path's launches: K4/K5 in the plain steps only
        layers = engine.model_config.num_layers
        engine.reset()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        engine.run(trace)
        torch.cuda.synchronize()
        launched = dict(ops.launch_counts)
        steps, verify = engine.steps_dispatched, engine.spec_steps
        check(verify > 0 and launched[kernel] == layers * (steps - verify)
              and all(c == 0 for k, c in launched.items() if k != kernel),
              f"{leg}: launches {launched} over {steps} steps, {verify} of "
              f"them verify steps, {layers} layers")
        m["launches"] = {kernel: launched[kernel], "steps": steps,
                         "verify_steps": verify}
        log(f"  [{leg}] a spec run: {kernel} launched {launched[kernel]} "
            f"times = {layers} layers x {steps - verify} plain steps "
            f"({verify} verify steps run no kernel)")
        # where a verify step's time goes: windows with speculation on
        # (verify and plain steps) and off (plain steps only)
        prof_spec = profile_run(engine, trace[:8], kernel)
        engine.config.speculative = None
        prof_plain = profile_run(engine, trace[:8], kernel)
        engine.config.speculative = SPEC_COMMON["speculative"]
        plain_ms = prof_plain["device_ms_per_step"]
        v = prof_spec["verify_steps"]
        verify_ms = ((prof_spec["device_busy_ms"] - plain_ms
                      * (prof_spec["steps"] - v)) / v if v else None)
        m["profile"] = dict(spec=prof_spec, nospec=prof_plain,
                            verify_device_ms=verify_ms,
                            plain_device_ms=plain_ms)
        log(f"  [{leg}] device time a verify step {verify_ms} ms against "
            f"{plain_ms:.4f} ms a plain step; idle share "
            f"{prof_spec['idle_share']:.3f} with speculation, "
            f"{prof_plain['idle_share']:.3f} without")
        # the planted fault must fail the divergence check
        fault = planted_fault_engine()(engine.dmodel, engine.config)
        fault.run(trace[:2])
        fault.reset()
        fault_div = first_divergences(dense, trace, fault.run(trace),
                                      nospec_res)
        caught = [d for d in fault_div if not near_tie(d)]
        check(fault.planted and caught, f"{leg}: a planted fault (one "
              f"draft token accepted past the match, {fault.planted} "
              f"times) passed the identity check: {fault_div}")
        log(f"  [{leg}] planted fault ({fault.planted} rows accepted one "
            f"draft token past the match) caught: {len(caught)} requests "
            f"diverge off a near tie (first: {caught[0]})")
        del fault, engine, dense, spec_res, nospec_res
        torch.cuda.empty_cache()
        keys = ("serving_tokens_per_sec", "serving_nospec_tokens_per_sec",
                "serving_spec_speedup", "serving_tpot_p50_ms",
                "serving_tpot_p99_ms", "serving_nospec_tpot_p50_ms",
                "serving_nospec_tpot_p99_ms", "serving_ttft_p50_ms",
                "serving_host_gap_p50_ms", "serving_verify_compiles",
                "serving_verify_captures", "serving_step_compiles",
                "serving_prefill_compiles", "serving_no_recompile",
                "serving_trace_complete", "serving_prefix_hit_rate",
                "launches", "profile")
        log(f"  [{leg}] {json.dumps({k: m[k] for k in keys if k in m})}")
        out[leg] = m
    m = run_serving_benchmark(**dict(SPEC_COMMON, dtype_name="float32",
                                     decode_kernel=False),
                              log=lambda line: log(f"  {line}"))
    check(m["serving_spec_greedy_identical"],
          "f32, decode_kernel=False: spec and no-spec arms gave different "
          "greedy tokens")
    log(f"  [spec_f32_dense] greedy tokens identical between the arms; "
        f"acceptance {m['serving_spec_acceptance_rate']:.4f}")
    out["spec_f32_dense"] = m
    return out


# ---------------------------------------------------------------------------
# the serving fleet
# ---------------------------------------------------------------------------

# the JAX bench's fleet legs at gpt2-medium's full width and depth, bf16,
# through K5 with CUDA graphs on: disaggregated prefill/decode on a
# long-prompt trace (prompts 64/256/384, 16 or 32 new tokens, pages of
# 64, buckets (64, 128)); two replicas behind the router and a live +1/-1
# cycle on the multi-tenant trace (4 tenants' 32-token prefixes, 16/32
# user tokens, 8 or 16 new, pages of 16, prefill widths (16, 64)). One
# change from the JAX legs' defaults, for the card: arrivals 0.02 s
# (router) and 0.05 s (livescale) apart instead of 0.15 s, since a
# request here is served in ~50 ms and at 0.15 s one replica would take
# every request.
FLEET_COMMON = dict(size="medium", dtype_name="bfloat16", decode_kernel=True)
FLEET_LEGS = {
    "disagg": dict(slots=8, num_requests=24),
    "router": dict(replicas=2, slots=4, num_requests=24, arrival_gap=0.02),
    "livescale": dict(replicas=2, slots=4, num_requests=24, arrival_gap=0.05),
}
#: what each leg must report true. The disaggregated leg's tokens equal
#: the colocated engine's exactly: both prefill every prompt at the same
#: widths and the handoff copies the bytes. The router's and livescale's
#: arms are held to the oracle modulo near ties (FLEET_MAX_DIVERGED): a
#: request whose tenant prefix a replica had cached prefills its tail in
#: a narrower window than the oracle did, and bf16 GEMMs of another
#: shape round its K/V otherwise, so its greedy tokens may move where
#: the top two lie within rounding of each other
FLEET_GATES = {
    "disagg": ("disagg_token_identical", "disagg_pool_pins_held",
               "disagg_trace_complete"),
    "router": ("router_compile_pins_held", "router_trace_complete",
               "router_affinity_nonzero", "router_burst_recovery_clean"),
    "livescale": ("livescale_compile_pins_held", "livescale_trace_complete",
                  "livescale_ledger_vs_gang_ok"),
}
#: of an arm's requests, the share whose tokens may leave the oracle's,
#: each at a near tie (near_tie: the dense path's top-2 margin and both
#: tokens' distance below its argmax within SPEC_MARGIN)
FLEET_MAX_DIVERGED = 0.25
#: pages a timed handoff moves, at the disaggregated leg's widths
HANDOFF_PAGES = (1, 4, 6)


def fleet_phase(leg, ops):
    """Run the fleet leg `leg` (examples/serve_benchmark.py
    run_<leg>_benchmark at FLEET_LEGS) with every kernel count zeroed just
    before and read just after: K5 launched, nothing else. In each arm of
    the leg (oracle, colocated, disaggregated, fleets, burst, single
    engine, live and gang), K5's launches equal layers x that arm's
    decode steps. Then the leg's gates (FLEET_GATES: greedy tokens equal
    to the oracle's, pins, complete traces), no request dropped, every
    page back (allocators audited), every program captured once. Returns
    (K5 launches over the phase, the report)."""
    from mpi_operator_tpu_torch.examples import serve_benchmark as sb
    from mpi_operator_tpu_torch.models.transformer import lm_config
    layers = lm_config(f"gpt2-{FLEET_COMMON['size']}").num_layers
    ops.reset_launch_counts()
    m = getattr(sb, f"run_{leg}_benchmark")(
        **FLEET_COMMON, **FLEET_LEGS[leg], log=lambda line: log(f"  {line}"))
    counts = dict(ops.launch_counts)
    k5 = counts["paged_decode_attention"]
    check(k5 > 0 and all(n == 0 for k, n in counts.items()
                         if k != "paged_decode_attention"),
          f"{leg}: kernel launches {counts}")
    in_arms = 0
    for arm, launched in m[f"{leg}_arm_launches"].items():
        steps = m[f"{leg}_arm_decode_steps"][arm]
        in_arms += launched["paged_decode_attention"]
        check(steps > 0
              and launched["paged_decode_attention"] == layers * steps
              and sum(launched.values()) == launched[
                  "paged_decode_attention"],
              f"{leg} {arm}: launches {launched} over {steps} decode steps "
              f"of {layers} layers")
    check(in_arms <= k5, f"{leg}: the arms launched {in_arms} > {k5}")
    for key in FLEET_GATES[leg]:
        check(m[key] is True, f"{leg}: {key} {m[key]}")
    if leg != "disagg":
        # a replica whose tick raised is failed over and its requests
        # replayed: the tokens would still match, so hold deaths apart
        check(all(d == [] for d in m[f"{leg}_dead_replicas"].values()),
              f"{leg}: replicas lost to failover "
              f"{m[f'{leg}_dead_replicas']}")
        div = m[f"{leg}_token_divergences"]
        bad = [d for d in div if d["index"] is None or not near_tie(d)]
        check(not bad, f"{leg}: tokens leave the oracle's off a near "
              f"tie: {bad}")
        n = FLEET_LEGS[leg]["num_requests"]
        per_arm = {arm: sum(1 for d in div if d["arm"] == arm)
                   for arm in sorted({d["arm"] for d in div})}
        check(all(c <= FLEET_MAX_DIVERGED * n for c in per_arm.values()),
              f"{leg}: diverged requests an arm {per_arm} of {n}")
        margins = sorted(round(d["margin"], 4) for d in div
                         if d["index"] is not None)
        log(f"  [{leg}] tokens against the oracle: diverged requests an "
            f"arm {per_arm} of {n}, each at a near tie (margins "
            f"{margins})")
    check(m[f"{leg}_pages_in_use_after"] == 0,
          f"{leg}: {m[f'{leg}_pages_in_use_after']} pages still in use")
    if leg == "disagg":
        caps = m["disagg_capture_counts"]
        check(m["disagg_handoffs"] == FLEET_LEGS[leg]["num_requests"]
              and m["disagg_transfer_widths"]
              <= m["disagg_transfer_width_cap"]
              and caps["prefill_pool"]["step"] == 0
              and caps["prefill_pool"]["prefill"]
              == m["disagg_prefill_pool_prefill_compiles"] > 0
              and caps["decode_pool"]["prefill"] == 0
              and caps["decode_pool"]["step"]
              == m["disagg_decode_pool_step_compiles"] > 0,
              f"disagg: {m['disagg_handoffs']} handoffs, widths "
              f"{m['disagg_transfer_widths']} (cap "
              f"{m['disagg_transfer_width_cap']}), graphs {caps}")
    elif leg == "router":
        check(m["router_shed_low_load"] == 0 and m["router_burst_sheds"] > 0,
              f"router: {m['router_shed_low_load']} low-load sheds, "
              f"{m['router_burst_sheds']} burst sheds")
    else:
        check(m["livescale_dropped"] == m["livescale_sheds"]
              == m["livescale_gang_dropped"] == 0
              and m["livescale_detached_replicas"] == [0]
              and m["livescale_attaches"] == 1,
              f"livescale: dropped {m['livescale_dropped']}, sheds "
              f"{m['livescale_sheds']}, gang dropped "
              f"{m['livescale_gang_dropped']}, detached "
              f"{m['livescale_detached_replicas']}")
    keys = [k for k in m if not k.startswith(f"{leg}_hop_")]
    log(f"  [{leg}] {device_line()}: K5 {k5} launches over the phase; "
        f"{json.dumps({k: m[k] for k in keys})}")
    return k5, m


def handoff_timing(dev):
    """PageTransfer.move alone at gpt2-medium's width (24 layers, 16
    heads, D=64, bf16, pages of 64), between two pools of the
    disaggregated leg's size on this card, at HANDOFF_PAGES pages: the
    pages land equal, and each move's device time (CUDA events over 20
    moves after 3 warm ones, no L2 flush: a handoff follows the prefill
    that wrote its pages), the host's time to enqueue it, the tensor
    operations it enqueues, and its bytes bound (each page read once and
    written once over the card's memory rate)."""
    from mpi_operator_tpu_torch.models.transformer import (PagedKVCache,
                                                            lm_config)
    from mpi_operator_tpu_torch.serve import PageTransfer
    cfg = lm_config("gpt2-medium", dtype=torch.bfloat16, max_len=448)
    NP = 8 * 448 // 64 + 1
    src, dst = (PagedKVCache.zeros(cfg, NP, 64, dev) for _ in range(2))
    gen = torch.Generator(dev).manual_seed(0)
    for layer in src.layers:
        for t in layer.tensors():
            t.normal_(generator=gen)
    page_bytes = PageTransfer.page_bytes(src, NP)
    rows = []
    for n in HANDOFF_PAGES:
        transfer = PageTransfer(NP, NP)
        sids, dids = list(range(1, n + 1)), list(range(NP - n, NP))
        for _ in range(3):
            transfer.move(src, dst, sids, dids)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        for _ in range(20):
            transfer.move(src, dst, sids, dids)
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3 / 20
        torch.cuda.synchronize()
        for ls, ld in zip(src.layers, dst.layers):
            for a, b in zip(ls.tensors(), ld.tensors()):
                check(torch.equal(a[sids], b[dids]),
                      f"handoff of {n} pages: the pages differ")
        nbytes = 2 * n * page_bytes
        rows.append(dict(pages=n, device_ms=start.elapsed_time(end) / 20,
                         host_ms=host_ms, ops_a_move=transfer.last_ops,
                         bytes=nbytes,
                         bound_ms=nbytes / HBM_BYTES_PER_S * 1e3))
    log(f"  [disagg] handoff alone, {device_line()}: {json.dumps(rows)}")
    return rows


# ---------------------------------------------------------------------------
# the training phases: K1-K3 alone, then LM training through them
# ---------------------------------------------------------------------------

def flash_inputs(B, S, H, D, mask, gen, dev):
    """bf16 q, k, v, do [B, S, H, D] and an optional [B, S] bool key mask:
    row 0 padded after 3/4 of S; with "empty", row 1 masked everywhere."""
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen, device=dev)
                   .bfloat16() for _ in range(4))
    m = None
    if mask is not None:
        m = torch.ones(B, S, dtype=torch.bool, device=dev)
        m[0, (3 * S) // 4:] = False
        if mask == "empty":
            m[1] = False
    return q, k, v, do, m


def flash_bound(name, B, S, H, D, causal, mask=None):
    """(bound_ms, bound_by) of one flash kernel: the bytes it must move
    (each bf16 [B, S, H, D] input and output once, f32 [B, H, S] lse and
    delta once, the uint8 [B, S] mask once) over HBM bandwidth, against
    its products over this input's visible (query, key) pairs (2*D flops
    a pair and product: K1 q.k and p.v, K2 adds do.v and ds.k for 3, K3
    q.k, do.v, p.do, ds.q for 4) over the bf16 tensor-core rate. A
    valid key j is seen by S - j queries when causal, by all S when
    not."""
    t, stat = B * S * H * D * 2, B * H * S * 4
    keys = (torch.ones(B, S, dtype=torch.long) if mask is None
            else mask.cpu().long())
    seen = (S - torch.arange(S)) if causal else torch.full((S,), S)
    pairs = H * int((keys * seen).sum())
    nbytes, products = {"flash_fwd": (4 * t + stat, 2),
                        "flash_dq": (5 * t + 2 * stat, 3),
                        "flash_dkv": (6 * t + 2 * stat, 4)}[name]
    nbytes += 0 if mask is None else B * S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = products * 2 * D * pairs / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def rel_err(got, want) -> float:
    """||got - want|| / ||want|| over the whole tensor, in f32."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def planted_faults(ops, q, k, v, do, lse, delta, causal, want):
    """What the relative error would read for a kernel with a planted
    fault, made from the plain versions and held against the sound plain
    outputs `want` {"flash_fwd": out, "flash_dq": dq, "flash_dkv": (dk,
    dv)}: one tile skipped (the smallest reading over every tile: a
    k-tile's keys masked for K1/K2, a q-tile's do and delta zeroed for
    K3), and ds left unrounded (the plain versions on f32 copies of
    the inputs, the output rounded to bf16). Returns [(kernel, fault,
    reading)]."""
    B, S = q.shape[:2]

    def tiles(name):
        return [slice(j, j + FLASH_TILE[name])
                for j in range(0, S, FLASH_TILE[name])]

    def keys_off(t):
        m = torch.ones(B, S, dtype=torch.bool, device=q.device)
        m[:, t] = False
        return m

    def rows_off(t):
        d, dl = do.clone(), delta.clone()
        d[:, t], dl[:, :, t] = 0, 0
        return ops.flash_dkv_ref(q, k, v, d, lse, dl, causal)

    dk, dv = want["flash_dkv"]
    f32 = [x.float() for x in (q, k, v, do)]
    return [
        ("flash_fwd", "skipped k-tile", min(
            rel_err(ops.flash_fwd_ref(q, k, v, causal, keys_off(t))[0],
                    want["flash_fwd"]) for t in tiles("flash_fwd"))),
        ("flash_dq", "skipped k-tile", min(
            rel_err(ops.flash_dq_ref(q, k, v, do, lse, delta, causal,
                                     keys_off(t)), want["flash_dq"])
            for t in tiles("flash_dq"))),
        ("flash_dkv", "skipped q-tile", min(
            max(rel_err(a, dk), rel_err(b, dv))
            for a, b in map(rows_off, tiles("flash_dkv")))),
        ("flash_dq", "unrounded ds", rel_err(
            ops.flash_dq_ref(*f32, lse, delta, causal).bfloat16(),
            want["flash_dq"])),
        ("flash_dkv", "unrounded ds", rel_err(
            ops.flash_dkv_ref(*f32, lse, delta, causal)[0].bfloat16(), dk)),
    ]


def flash_kernel_phase(ops, dev):
    """K1-K3 against their plain versions over FLASH_CASES, and the
    planted faults' readings at the training shape against the limits;
    returns ({kernel: max abs error}, {timed case: {kernel: timing
    row}})."""
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    worst_rel = dict(worst)
    rows = {}
    for name, B, S, H, D, causal, mask in FLASH_CASES:
        q, k, v, do, m = flash_inputs(B, S, H, D, mask, gen, dev)
        out, lse = ops.flash_fwd(q, k, v, causal, m)
        torch.cuda.synchronize()
        ref_out, ref_lse = ops.flash_fwd_ref(q, k, v, causal, m)
        delta = ops.flash_delta(ref_out, do)
        dq = ops.flash_dq(q, k, v, do, ref_lse, delta, causal, m)
        dk, dv = ops.flash_dkv(q, k, v, do, ref_lse, delta, causal, m)
        torch.cuda.synchronize()
        ref_dq = ops.flash_dq_ref(q, k, v, do, ref_lse, delta, causal, m)
        ref_dk, ref_dv = ops.flash_dkv_ref(q, k, v, do, ref_lse, delta,
                                           causal, m)
        lse_err = float((lse - ref_lse).abs().max())
        check(lse_err <= LSE_ATOL, f"K1 {name}: lse differs from the plain "
              f"version by {lse_err} > {LSE_ATOL}")
        errs, rels = {}, {}
        for kname, got, want in (("flash_fwd", out, ref_out),
                                 ("flash_dq", dq, ref_dq),
                                 ("flash_dkv", dk, ref_dk),
                                 ("flash_dkv", dv, ref_dv)):
            err = float((got.float() - want.float()).abs().max())
            rel = rel_err(got, want)
            check(torch.isfinite(got).all().item(),
                  f"{kname} {name}: non-finite output")
            check(rel <= FLASH_REL[kname],
                  f"{kname} {name}: ||kernel - plain|| / ||plain|| = {rel} "
                  f"> {FLASH_REL[kname]} (max abs error {err})")
            errs[kname] = max(errs.get(kname, 0.0), err)
            rels[kname] = max(rels.get(kname, 0.0), rel)
            worst[kname] = max(worst[kname], err)
            worst_rel[kname] = max(worst_rel[kname], rel)
        if mask == "empty":      # the row with no valid key: no gradient
            check(not dq[1].any() and not dk[1].any() and not dv[1].any(),
                  f"{name}: gradients flow from the fully masked row")
        log(f"  K1-K3 {name:13s} B={B} S={S} H={H} D={D} causal={causal} "
            f"mask={mask}: relative error fwd {rels['flash_fwd']:.3e} dq "
            f"{rels['flash_dq']:.3e} dkv {rels['flash_dkv']:.3e}; max abs "
            f"error fwd {errs['flash_fwd']:.3e} dq {errs['flash_dq']:.3e} "
            f"dkv {errs['flash_dkv']:.3e}; lse {lse_err:.3e}")
        if name == "gpt2-medium":
            faults = planted_faults(ops, q, k, v, do, ref_lse, delta,
                                    causal, {"flash_fwd": ref_out,
                                             "flash_dq": ref_dq,
                                             "flash_dkv": (ref_dk, ref_dv)})
            for kname, fault, reading in faults:
                log(f"  planted fault {kname} {fault}: relative error "
                    f"{reading:.3e} against the limit "
                    f"{FLASH_REL[kname]:.1e}")
                check(reading > FLASH_REL[kname],
                      f"{kname}: the limit {FLASH_REL[kname]} passes a "
                      f"kernel with a {fault} ({reading})")
        if name in TIMED_FLASH_CASES:
            rows[name] = time_flash(ops, name, q, k, v, do, causal, m, dev)
    torch.cuda.empty_cache()
    log(f"  K1-K3 worst relative error over the cases: "
        + ", ".join(f"{n} {worst_rel[n]:.3e} (limit {FLASH_REL[n]:.1e})"
                    for n in worst_rel))
    return worst, rows


FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
# the cases timed beside SDPA: the gpt2 training shape (the kernels
# line's rows), bert-large's, without and with its key mask, and
# ViT-B/16's (the kernels line's `vit_b16` entries)
TIMED_FLASH_CASES = ("gpt2-medium", "bert-large", "bert-large-pad",
                     "vit-b16")


def time_flash(ops, name, q, k, v, do, causal, m, dev):
    """K1-K3 at one case's inputs, L2 flushed, beside their bounds, their
    plain versions and one scaled_dot_product_attention call (same
    causality and key mask; a yardstick the port never calls) forward
    and backward. Returns {kernel: timing row}."""
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    m8 = None if m is None else ops._mask_u8(m, dev)
    out, lse = ops.flash_fwd(q, k, v, causal, m8)
    delta = ops.flash_delta(out, do)
    calls = {
        "flash_fwd": (lambda: ops.flash_fwd(q, k, v, causal, m8),
                      lambda: ops.flash_fwd_ref(q, k, v, causal, m8)),
        "flash_dq": (lambda: ops.flash_dq(q, k, v, do, lse, delta, causal,
                                          m8),
                     lambda: ops.flash_dq_ref(q, k, v, do, lse, delta,
                                              causal, m8)),
        "flash_dkv": (lambda: ops.flash_dkv(q, k, v, do, lse, delta, causal,
                                            m8),
                      lambda: ops.flash_dkv_ref(q, k, v, do, lse, delta,
                                                causal, m8)),
    }
    # SDPA's [B, H, S, D] views of the same inputs, the key mask as a
    # [B, 1, 1, S] boolean (True = attend); its cotangent made contiguous
    # once, outside the timing
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    am = None if m is None else m[:, None, None, :]
    backend = torch._fused_sdp_choice(qt, kt, vt, attn_mask=am,
                                      is_causal=causal)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am,
                                              is_causal=causal)
    sdpa_fwd = time_ms(sdpa, 20, flush)
    so = sdpa()
    dot = do.transpose(1, 2).contiguous()
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        so, (qt, kt, vt), dot, retain_graph=True), 20, flush)
    log(f"  {name}: SDPA (is_causal={causal}, mask={m is not None}, "
        f"yardstick; backend choice {backend}): forward {sdpa_fwd:.4f} ms, "
        f"backward (dq, dk, dv in one call) {sdpa_bwd:.4f} ms")
    rows = {}
    B, S, H, D = q.shape
    for kname, (kernel, plain) in calls.items():
        ms = time_ms(kernel, 20, flush)
        plain_ms = time_ms(plain, 5, flush)
        bound_ms, bound_by = flash_bound(kname, B, S, H, D, causal, m)
        lib = sdpa_fwd if kname == "flash_fwd" else sdpa_bwd
        rows[kname] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=lib)
        log(f"  {name}: {kname:9s} kernel {ms:.4f} ms  plain {plain_ms:.4f} "
            f"ms  bound {bound_ms:.4f} ms ({bound_by})  SDPA "
            f"{'forward' if kname == 'flash_fwd' else 'backward'} "
            f"{lib:.4f} ms")
    log(f"  {name}: ratios in this call: K1 / SDPA forward "
        f"{rows['flash_fwd']['ms'] / sdpa_fwd:.3f}, (K2 + K3) / SDPA "
        f"backward "
        f"{(rows['flash_dq']['ms'] + rows['flash_dkv']['ms']) / sdpa_bwd:.3f}")
    return rows


def train_phase(name, ops, **kw):
    """run_lm_benchmark(**kw) with every kernel count zeroed just before
    and read just after: K2 and K3 must each have launched once a layer
    a step, K1 once a layer a step and a forward (twice under remat: the
    backward recomputes it; one more forward for the MoE drop-rate probe
    after training), the decode kernels never; every timed step's loss
    finite and no update skipped by the guard. Returns (state, metrics,
    counts)."""
    from mpi_operator_tpu_torch.examples.lm_benchmark import run_lm_benchmark
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    state, m = run_lm_benchmark(log=lambda line: log(f"  {line}"), **kw)
    torch.cuda.synchronize()
    counts = dict(ops.launch_counts)
    layers, steps = state.model.config.num_layers, state.step
    forwards = steps * (2 if kw.get("remat") else 1) \
        + (1 if kw.get("moe_experts") else 0)
    want = {"flash_fwd": layers * forwards, "flash_dq": layers * steps,
            "flash_dkv": layers * steps}
    check(all(counts[k] == want[k] for k in FLASH_KERNELS),
          f"{name}: flash launches {counts} over {steps} steps of {layers} "
          f"layers; expected {want}")
    check(all(n == 0 for k, n in counts.items() if k not in FLASH_KERNELS),
          f"{name}: other kernels launched: {counts}")
    losses = m["step_losses"]
    check(all(math.isfinite(x) for x in losses)
          and math.isfinite(m["final_loss"]),
          f"{name}: non-finite loss among {losses}")
    check(int(state.opt.count) == steps,
          f"{name}: the guard skipped {steps - int(state.opt.count)} updates")
    stats = {k: m[k] for k in ("tokens_per_sec", "step_time_p50_ms",
                               "step_time_p99_ms", "host_gap_p50_ms",
                               "mfu", "tflops_per_sec_per_device",
                               "flops_per_step", "final_loss",
                               "moe_drop_rate") if k in m}
    stats.update(steps=steps, launches={k: counts[k] for k in FLASH_KERNELS},
                 first_loss=losses[0], last_loss=losses[-1],
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                 card=device_line())
    log(f"  {name}: {json.dumps(stats)}")
    return state, m, counts


def padded_rows(B, S, dev):
    """The [B, S] key mask of the BERT gradient check: row 0 padded after
    3/4 of S, row 1 after 1/4, the others whole. (A row with no valid
    key is left out: there dense and flash differ by design — the dense
    softmax passes a gradient through its uniform row, flash none.)"""
    pad = torch.ones(B, S, dtype=torch.bool, device=dev)
    pad[0, (3 * S) // 4:] = False
    pad[1, S // 4:] = False
    return pad


def masked_loss_and_grads(state, batch, attention_mask):
    """(MLM loss, flat f32 gradients in param_shapes order) of a MaskedLM
    under a key-padding mask (LMTrainer.loss_and_grads passes none, as
    the reference trainer does)."""
    from mpi_operator_tpu_torch.models.transformer import param_shapes
    from mpi_operator_tpu_torch.train import lm_loss
    toks, tgts, mask = batch
    model = state.model
    loss = lm_loss(model(toks, attention_mask=attention_mask), tgts, mask)
    loss.backward()
    params = [model.get_parameter(n) for n in param_shapes(model.config)]
    g = torch.cat([p.grad.reshape(-1) for p in params])
    for p in params:
        p.grad = None
    return loss.detach(), g


@contextlib.contextmanager
def exact_dense_attention():
    """The model's dense attention computed in f32 from its bf16 q, k and
    v (scores, softmax, its backward and both products unrounded), the
    output cast back: the attention flash approximates, with no bf16
    rounding of scores or of their gradients."""
    from mpi_operator_tpu_torch.models import transformer as tt
    dense = tt.dense_attention

    def exact(q, k, v, mask=None, causal=True, dtype=torch.float32):
        return dense(q.float(), k.float(), v.float(), mask, causal,
                     torch.float32).to(q.dtype)
    tt.dense_attention = exact
    try:
        yield
    finally:
        tt.dense_attention = dense


@contextlib.contextmanager
def f32_delta():
    """The flash backward (K2, K3) with delta = rowsum(dO * O) taken from
    the f32 output of the plain forward on the same q, k, v instead of
    K1's bf16 output (the reference's convention, `_flash_bwd`). Where
    the values share a large common component, O's bf16 rounding moves
    every delta_i, each such error shifts row i's dq by a multiple of its
    mean key, and those shifts add up in the query bias's gradient."""
    from mpi_operator_tpu_torch.ops import attention as ops
    backward = ops.FlashAttention.backward

    def exact_delta(ctx, do, _dlse):
        q, k, v, out, lse, mask = ctx.saved_tensors
        do = do.contiguous()
        o32, _ = ops.flash_fwd_ref(q.float(), k.float(), v.float(),
                                   ctx.causal, mask)
        delta = ops.flash_delta(o32, do)
        dq = ops.flash_dq(q, k, v, do, lse, delta, ctx.causal, mask)
        dk, dv = ops.flash_dkv(q, k, v, do, lse, delta, ctx.causal, mask)
        return dq, dk, dv, None, None
    ops.FlashAttention.backward = staticmethod(exact_delta)
    try:
        yield
    finally:
        ops.FlashAttention.backward = backward


def compare_grads(mcfg, name, ga, gb):
    """(worst cosine, its parameter) of two flat gradients over every
    parameter tensor but the key biases, whose exact gradient is 0 and
    which must hold rounding noise only (under NOISE_NORM of the global
    norm); the global norms within GRAD_NORM_RTOL. Logs and checks."""
    from mpi_operator_tpu_torch.models.transformer import param_shapes
    (la, a_all), (lb, b_all) = ga, gb
    norm_a, norm_b = float(a_all.norm()), float(b_all.norm())
    worst, off = (1.0, ""), 0
    for pname, shape in param_shapes(mcfg).items():
        n = math.prod(shape)
        a, b = a_all[off:off + n], b_all[off:off + n]
        off += n
        if pname.endswith("attn.key.bias"):
            check(float(a.norm()) <= NOISE_NORM * norm_a
                  and float(b.norm()) <= NOISE_NORM * norm_b,
                  f"{pname}: gradient {float(a.norm())} / {float(b.norm())} "
                  f"is not rounding noise")
            continue
        cos = float(torch.dot(a, b) / (a.norm() * b.norm()).clamp(min=1e-30))
        worst = min(worst, (cos, pname))
    log(f"  grads {name}: loss {la:.6f} vs {lb:.6f}, global norm "
        f"{norm_a:.6f} vs {norm_b:.6f}, worst cosine {worst[0]:.6f} "
        f"({worst[1]})")
    return worst, abs(norm_a - norm_b) <= GRAD_NORM_RTOL * norm_b


def grads_agree(tcfg, mcfg, dev, attention_mask=None):
    """One step's gradients from the same weights and batch through
    attention="flash" and "dense"; returns the flash trainer and state
    for profiling. For BERT (the MLM stream's batch under
    `attention_mask`) the reference is the dense path with its attention
    computed in f32 (`exact_dense_attention`), and what is held to it
    is the flash path with delta from an f32 output (`f32_delta`): with
    delta from K1's bf16 output, as the reference's flash backward takes
    it, BERT's query-bias gradients read a cosine of ~0.998 against the
    f32 attention, where the bf16 dense path reads 0.9997 (a chip run of
    this check), which is the rounding of delta and not K1-K3's
    arithmetic. The flash path as shipped and the bf16 dense path are
    printed against the f32 one."""
    from mpi_operator_tpu_torch.data import TokenStream
    from mpi_operator_tpu_torch.train import LMTrainer
    batch = TokenStream(tcfg.global_batch_size, tcfg.seq_len,
                        mcfg.vocab_size, seed=1, device=dev,
                        masked_lm=not mcfg.causal).batch(0)
    impls = ("dense", "flash") if mcfg.causal else (
        "exact", "dense", "flash-f32-delta", "flash")
    contexts = {"exact": exact_dense_attention, "flash-f32-delta": f32_delta}
    grads = {}
    for impl in impls:
        attention = "flash" if impl.startswith("flash") else "dense"
        trainer = LMTrainer(dataclasses.replace(mcfg, attention=attention),
                            tcfg, device=dev)
        state = trainer.init_state(0)
        with contexts.get(impl, contextlib.nullcontext)():
            if attention_mask is None:
                loss, g, _ = trainer.loss_and_grads(state, *batch)
            else:
                loss, g = masked_loss_and_grads(state, batch,
                                                attention_mask)
        grads[impl] = (float(loss), g)
        if impl != "flash":
            del trainer, state
            torch.cuda.empty_cache()
    got, ref = ("flash", "dense") if mcfg.causal else ("flash-f32-delta",
                                                        "exact")
    (cos, pname), norms_ok = compare_grads(
        mcfg, f"{got} vs {ref}", grads[got], grads[ref])
    if not mcfg.causal:
        for a, b in (("flash", "exact"), ("dense", "exact"),
                     ("flash", "dense")):
            compare_grads(mcfg, f"{a} vs {b} (printed)", grads[a], grads[b])
    check(cos >= GRAD_COSINE, f"gradient cosine {cos} < {GRAD_COSINE} for "
          f"{pname} ({got} vs {ref})")
    check(norms_ok, f"global gradient norms of {got} and {ref} beyond "
          f"{GRAD_NORM_RTOL:.0%}")
    return trainer, state, batch


def profile_train(trainer, state, batch, step_ms, steps=2):
    """Where a training step's time goes: `steps` train steps under
    torch.profiler after one unprofiled step; device busy per step
    against the profiled wall time and against `step_ms`, the unprofiled
    benchmark's step time (the profiler's own host cost inflates the
    former), device time by kernel group, K1-K3's share, and the host
    ops that take the most CPU time."""
    from torch.profiler import ProfilerActivity, profile
    trainer.train_step(state, *batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(state, *batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups = {}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.is_user_annotation):
            continue
        g = groups.setdefault(kernel_group(e.name), [0.0, 0])
        g[0] += e.time_range.elapsed_us()
        g[1] += 1
    busy = sum(g[0] for g in groups.values())
    flash = sum(groups.get(k, [0.0])[0] for k in
                ("K1 flash_fwd", "K2 flash_dq", "K3 flash_dkv"))
    busy_ms = busy / 1e3 / steps
    log(f"  profile: {steps} train steps, wall {wall_us / 1e3:.2f} ms "
        f"({wall_us / 1e3 / steps:.2f} ms a step), device busy "
        f"{busy_ms:.2f} ms a step, idle share {1 - busy / wall_us:.3f} "
        f"profiled, {1 - busy_ms / step_ms:.3f} against the unprofiled "
        f"step of {step_ms:.2f} ms; K1-K3 {flash / max(busy, 1e-9):.1%} of "
        f"device time")
    for name, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f"  profile: {us / 1e3 / steps:8.3f} ms a step "
            f"{us / max(busy, 1e-9):6.1%} {n // steps:5d} launches a step  "
            f"{name}")
    log("  profile: K1 / K2 / K3 " + " / ".join(
        f"{groups.get(k, [0.0])[0] / 1e3 / steps:.3f}" for k in
        ("K1 flash_fwd", "K2 flash_dq", "K3 flash_dkv")) + " ms a step")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in host[:8]:
        log(f"  profile host: {e.self_cpu_time_total / 1e3 / steps:8.3f} ms "
            f"a step self CPU, {e.count // steps:5d} calls a step  {e.key[:60]}")


# ---------------------------------------------------------------------------
# the train-resume phase
# ---------------------------------------------------------------------------

# gpt2-medium at the bench's gpt2 leg, through run_lm_benchmark's
# resilient path: uninterrupted to RESUME_T twice (A, A'), then SIGTERM
# at RESUME_KILL (between the periodic saves at 6 and 12) and a resume
# to RESUME_T. A window of 10 timed steps after 3 warmup steps covers
# global steps 4-13: A's holds the saves at 6 and 12, A' runs without
# periodic saves, so its window is the one without. (25, 18, 12 before
# the [hfta] phase needed the run's time: PERF.md section 6.)
RESUME_T, RESUME_KILL, RESUME_EVERY, RESUME_KEEP = 15, 10, 6, 2
RESUME_COMMON = dict(workload="gpt2", size="medium", batch_per_device=16,
                     seq_len=512, warmup_steps=3, attention="flash",
                     ckpt_every=RESUME_EVERY, ckpt_keep=RESUME_KEEP)
# a run writes up to keep + 2 checkpoints of ~4.25 GB (keep_last, the
# in-flight periodic write, the final or emergency save)
RESUME_DISK_BYTES = 20e9


def resumed_run(name, ops, train_dir, resumed_from=0, **kw):
    """One run_lm_benchmark of the drill with the kernel counts zeroed
    just before and read just after: K1-K3 each once a layer for every
    step THIS run executed (warmup included), the decode kernels never,
    and every update applied (opt.count == step). Returns (state,
    metrics or the Preempted, log lines)."""
    from mpi_operator_tpu_torch.examples.lm_benchmark import run_lm_benchmark
    from mpi_operator_tpu_torch.models.transformer import lm_config
    from mpi_operator_tpu_torch.train.resilience import Preempted
    lines = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state = None
    try:
        state, out = run_lm_benchmark(train_dir=train_dir, log=lines.append,
                                      **{**RESUME_COMMON, **kw})
        end = state.step
        check(int(state.opt.count) == end,
              f"{name}: opt.count {int(state.opt.count)} != step {end}")
    except Preempted as p:      # the state stays inside the run
        out, end = p.with_traceback(None), p.step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    layers = lm_config(f"{RESUME_COMMON['workload']}-"
                       f"{RESUME_COMMON['size']}").num_layers
    ran = end - resumed_from
    check(all(counts[k] == layers * ran for k in FLASH_KERNELS),
          f"{name}: flash launches {counts} over the {ran} steps "
          f"({resumed_from} -> {end}) of {layers} layers it ran")
    check(all(n == 0 for k, n in counts.items() if k not in FLASH_KERNELS),
          f"{name}: other kernels launched: {counts}")
    log(f"  {name}: steps {resumed_from} -> {end} in {wall:.2f} s, "
        f"K1-K3 {counts['flash_fwd']} launches each = {layers} x {ran}")
    return state, out, lines


def window_step_ms(lines, base, every, tokens_per_step):
    """(window's last global step, ms a step, holds a save dispatch) for
    each window line of a benchmark log ("<i>\ttokens/sec: <tps>\t...");
    `base` is the global step before the first timed step."""
    out, prev = [], 0
    for line in lines:
        m = re.match(r"(\d+)\ttokens/sec: (\d+)", line)
        if m:
            i, tps = int(m.group(1)), float(m.group(2))
            lo, hi = base + prev + 1, base + i
            out.append((hi, tokens_per_step / tps * 1e3, every > 0
                        and any(s % every == 0 for s in range(lo, hi + 1))))
            prev = i
    return out


def flat_state(state):
    return {"params": state.params, "mu": state.opt.mu, "nu": state.opt.nu}


def max_diff(a, b):
    return {k: float((a[k] - b[k]).abs().max()) for k in a}


def snapshot_costs(state):
    """What a save's snapshot costs the training stream, the two designs
    timed on the same 4.25 GB: a device clone (kept) against a copy into
    pinned host memory on the critical path, CUDA events, after one
    untimed pass of each."""
    tensors = list(flat_state(state).values())
    pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
              for t in tensors]
    costs = {}
    for name, fn in (("clone", lambda: [t.clone() for t in tensors]),
                     ("pinned", lambda: [h.copy_(t, non_blocking=True)
                                         for h, t in zip(pinned, tensors)])):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        got = fn()
        end.record()
        torch.cuda.synchronize()
        costs[name] = start.elapsed_time(end)
        del got
    del pinned
    torch.cuda.empty_cache()
    return costs


def cli_leg(train_dir, fault=None, *extra, reshard=False):
    """python -m mpi_operator_tpu_torch.examples.lm_benchmark as the
    controller starts a worker: gpt2-medium width, 2 layers, 16 x 512;
    `reshard` resumes through the resharding restore
    (TPU_RESHARD_RESTORE=1)."""
    env = dict(os.environ)
    env.pop("TPU_FAULT_INJECT", None)
    env.pop("TPU_RESHARD_RESTORE", None)
    if fault:
        env["TPU_FAULT_INJECT"] = fault
    if reshard:
        env["TPU_RESHARD_RESTORE"] = "1"
    cmd = [sys.executable, "-m", "mpi_operator_tpu_torch.examples."
           "lm_benchmark", "--size", "medium", "--num-layers", "2",
           "--batch-per-device", "16", "--seq-len", "512", "--attention",
           "flash", "--warmup-steps", "1", "--num-steps", "20",
           "--train-dir", train_dir, *extra]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         env=env)
    return out, time.perf_counter() - t0


def cli_reshard_equal(path):
    """The CLI's checkpoint at `path` (gpt2-medium width, 2 layers)
    restored through restore_resharded and through the plain restore
    into two fresh states: params, mu, nu, count and step bit-equal."""
    from mpi_operator_tpu_torch.models.transformer import lm_config
    from mpi_operator_tpu_torch.train import LMTrainer, LMTrainerConfig
    from mpi_operator_tpu_torch.train import checkpoint as ck
    tr = LMTrainer(lm_config("gpt2-medium", num_layers=2, max_len=512),
                   LMTrainerConfig(global_batch_size=16, seq_len=512))
    a = ck.restore_resharded(path, tr.init_state(3))
    b = ck.restore_checkpoint(path, tr.init_state(4))
    same = (a.step == b.step and int(a.opt.count) == int(b.opt.count)
            and all(torch.equal(x, y) for x, y in (
                (a.params, b.params), (a.opt.mu, b.opt.mu),
                (a.opt.nu, b.opt.nu))))
    check(same, f"CLI checkpoint {path}: the resharded restore differs from "
          f"the plain one")
    del a, b, tr
    torch.cuda.empty_cache()
    return same


def train_resume_phase(ops):
    """The preemption drill at full gpt2-medium width on the card: A and
    A' uninterrupted (bit-equal, or the op that is not deterministic is
    named and the resume held to their difference), B1 preempted by
    TPU_FAULT_INJECT=sigterm-at-step:RESUME_KILL (Preempted with step_k
    committed, preemption_drain then emergency_checkpoint logged), B2
    resumed to RESUME_T (first_resume_step logged; params, mu, nu,
    opt.count and its losses equal A's); each run's launch counts are
    layers x its own steps. Then the CLI pair at 2 layers: 215 with
    step_5, 0 with step_8. Prints the save, restore and first-step
    seconds with the card's name and power limit."""
    import shutil
    from mpi_operator_tpu_torch.telemetry import read_events
    from mpi_operator_tpu_torch.train import checkpoint as ck
    from mpi_operator_tpu_torch.train.resilience import (
        PREEMPTED_EXIT, Preempted, drain_latency_from_events)

    root = tempfile.mkdtemp(prefix="train-resume-")
    try:
        free = shutil.disk_usage(root).free
        check(free >= RESUME_DISK_BYTES,
              f"[train-resume] needs {RESUME_DISK_BYTES / 1e9:.0f} GB free "
              f"under {root} for its checkpoints, has {free / 1e9:.1f} GB")
        log(f"  {device_line()}; {free / 1e9:.1f} GB free under the temp "
            f"dir; DCP FileSystemWriter thread_count {ck.WRITER_THREADS}")
        tokens_per_step = (RESUME_COMMON["batch_per_device"]
                           * RESUME_COMMON["seq_len"])
        runs, windows = {}, []
        for name, every in (("A", RESUME_EVERY), ("A'", 0)):
            d = os.path.join(root, name.replace("'", "2"))
            state, m, lines = resumed_run(
                name, ops, d, num_steps=RESUME_T - 3, ckpt_every=every)
            check(state.step == RESUME_T, f"{name}: ended at {state.step}")
            windows += window_step_ms(lines, 3, every, tokens_per_step)
            info = ck.last_save_info()
            log(f"  {name}: final save {info['bytes']} bytes, to host "
                f"{info['to_host_seconds']:.3f} s, write "
                f"{info['write_seconds']:.3f} s; periodic saves "
                f"{[l for l in lines if 'async checkpoint' in l]}")
            runs[name] = ({k: v.clone() for k, v in flat_state(state).items()},
                          m["step_losses"])
            if name == "A":
                costs = snapshot_costs(state)
                log(f"  snapshot of {info['bytes']} bytes: device clone "
                    f"{costs['clone']:.3f} ms, pinned host copy "
                    f"{costs['pinned']:.3f} ms (CUDA events)")
            del state
            shutil.rmtree(d, ignore_errors=True)
            torch.cuda.empty_cache()
        (fa, la), (fa2, la2) = runs["A"], runs["A'"]
        det = all(torch.equal(fa[k], fa2[k]) for k in fa) and la == la2
        diff_aa = max_diff(fa, fa2)
        log(f"  A vs A': bit-equal {det}; max |A - A'| {diff_aa}; losses "
            f"equal {la == la2}")
        with_save = [ms for _, ms, s in windows if s]
        without = [ms for _, ms, s in windows if not s]
        log(f"  periodic async save: step time {with_save} ms in windows "
            f"holding a save dispatch, {without} ms in windows without "
            f"one ({device_line()})")

        d = os.path.join(root, "B")
        os.environ["TPU_FAULT_INJECT"] = f"sigterm-at-step:{RESUME_KILL}"
        try:
            state, p, lines = resumed_run(
                "B1", ops, d, num_steps=RESUME_T - 3)
        finally:
            del os.environ["TPU_FAULT_INJECT"]
        check(isinstance(p, Preempted) and p.step == RESUME_KILL
              and p.exit_code == PREEMPTED_EXIT,
              f"B1: expected Preempted at {RESUME_KILL}, got {p!r}")
        check(ck.latest_checkpoint(d).endswith(f"step_{RESUME_KILL}"),
              f"B1: newest checkpoint {ck.latest_checkpoint(d)}")
        kinds = [e["event"] for e in read_events(
            os.path.join(d, "events.jsonl"))]
        check(kinds[-2:] == ["preemption_drain", "emergency_checkpoint"],
              f"B1: events {kinds}")
        info = ck.last_save_info()
        drain, _ = drain_latency_from_events(os.path.join(d, "events.jsonl"))
        log(f"  B1: blocking emergency save of step {info['step']}: "
            f"{drain:.3f} s drain (preemption_drain -> emergency_checkpoint),"
            f" {info['bytes']} bytes, to host {info['to_host_seconds']:.3f} "
            f"s, write {info['write_seconds']:.3f} s ({device_line()})")
        ck.reset_saved_state()

        state, m, lines = resumed_run(
            "B2", ops, d, resumed_from=RESUME_KILL, num_steps=100,
            stop_at_step=RESUME_T)
        check(any(f"resumed from" in l and f"step_{RESUME_KILL}" in l
                  for l in lines), "B2 did not resume from the drill's step")
        events = read_events(os.path.join(d, "events.jsonl"))
        restore = [e for e in events if e["event"] == "checkpoint_restore"]
        first = [e for e in events if e["event"] == "first_resume_step"]
        check(restore and first, f"B2: events {[e['event'] for e in events]}")
        got = flat_state(state)
        diff = max_diff(got, fa)
        ran = m["step_losses"]
        want = la[-len(ran):]
        if det:
            check(all(torch.equal(got[k], fa[k]) for k in fa)
                  and int(state.opt.count) == RESUME_T and ran == want,
                  f"B2 differs from A: max |B - A| {diff}, losses {ran} "
                  f"vs {want}")
        else:
            check(all(diff[k] <= 2 * diff_aa[k] for k in diff),
                  f"B2 vs A {diff} beyond twice A vs A' {diff_aa}")
        log(f"  B2: resumed from step {restore[0]['step']}, restore "
            f"{restore[0]['seconds']:.3f} s ({restore[0]['leaves']} leaves, "
            f"{ck.last_restore_info()['bytes']} bytes), first resumed step "
            f"{first[0]['step']} after {first[0]['seconds']:.3f} s; final "
            f"state vs A bit-equal {all(diff[k] == 0 for k in diff)}, max "
            f"|B - A| {diff}; losses of steps {RESUME_T - len(ran) + 1}-"
            f"{RESUME_T} equal A's {ran == want} ({device_line()})")
        del state, runs, fa, fa2, got
        shutil.rmtree(d, ignore_errors=True)
        torch.cuda.empty_cache()

        d = os.path.join(root, "cli")
        out, secs = cli_leg(d, "sigterm-at-step:5")
        check(out.returncode == PREEMPTED_EXIT
              and os.path.isdir(os.path.join(d, "step_5")),
              f"CLI preempted leg: rc {out.returncode}\n{out.stdout[-1500:]}"
              f"\n{out.stderr[-1500:]}")
        out2, secs2 = cli_leg(d, None, "--stop-at-step", "8", reshard=True)
        check(out2.returncode == 0 and os.path.isdir(os.path.join(d, "step_8"))
              and "step_5" in out2.stdout,
              f"CLI resume leg: rc {out2.returncode}\n{out2.stdout[-1500:]}"
              f"\n{out2.stderr[-1500:]}")
        restores = [e for e in read_events(os.path.join(d, "events.jsonl"))
                    if e["event"] == "checkpoint_restore"]
        check([e.get("resharded") for e in restores] == [True],
              f"CLI resume leg: checkpoint_restore records {restores}")
        same = cli_reshard_equal(os.path.join(d, "step_5"))
        log(f"  CLI (2 layers): sigterm-at-step:5 exit {out.returncode} with "
            f"step_5 in {secs:.1f} s; TPU_RESHARD_RESTORE=1 --stop-at-step 8 "
            f"exit 0 with step_8 in {secs2:.1f} s, its checkpoint_restore "
            f"resharded {restores[0]['resharded']} in "
            f"{restores[0]['seconds']:.3f} s; step_5 through "
            f"restore_resharded bit-equal to the plain restore {same}; "
            f"{out2.stdout.strip().splitlines()[-1]}")
    finally:
        ck.wait_for_checkpoints()
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# image training: ResNet and ViT through the image Trainer, and DDP
# ---------------------------------------------------------------------------

# the JAX bench's headline leg (bench.py:181-200): ResNet-101, the conv7
# stem, 224 px, bf16, 256 a device (one window of 10 timed steps, 30
# before [train-lm-pp] needed the run's time: PERF.md section 6); then
# ResNet-50 with the s2d stem
RESNET_LEGS = [
    ("resnet101-conv7", dict(model_name="resnet101", stem="conv7",
                             batch_per_device=256, image_size=224,
                             num_steps=10, warmup_steps=3)),
    ("resnet50-s2d", dict(model_name="resnet50", stem="s2d",
                          batch_per_device=256, image_size=224,
                          num_steps=10, warmup_steps=2)),
]
# the bench's vit leg (bench.py:1046-1064): ViT-B/16, 256 x 224^2; one
# window of 10 timed steps (30 before [train-lm-pp] needed the run's
# time)
VIT_LEG = dict(size="b16", batch_per_device=256, image_size=224,
               num_steps=10, warmup_steps=3)
# the flash-against-dense gradient check on a 2-layer cut of ViT-B/16
VIT_GRAD_BATCH, VIT_GRAD_LAYERS = 64, 2
# [train-ddp]: 2 gloo ranks on the one card against one process at the
# global batch of 16 after 3 SGD steps, compared by the relative error
# of the update (params after minus params before): ResNet-50 (s2d, 64
# px) in f32 with TF32 off, where the ranks' convs run at another batch
# size (cuDNN may pick other algorithms) and gloo sums the gradients in
# another order; the 2-layer ViT in bf16 through K1-K3, where the GEMMs
# of 8 rows round like those of 16 only up to bf16 ulps. On the H100 the
# sound ResNet reads up to 3.3e-6 and the planted per-rank-BN fault 0.30
# (update) / 0.28 (momentum) / 9.9e-3 (statistics): 1e-3 sits near the
# geometric mean of the two, ~300x from each
DDP_STEPS, DDP_IMAGE = 3, 64
DDP_REL = {"resnet": 1e-3, "vit": 2e-2}


def image_group(name: str) -> str:
    """Device kernels of an image training step by kind."""
    low = name.lower()
    for kernel, group in (("flash_fwd_kernel", "K1 flash_fwd"),
                          ("flash_dq_kernel", "K2 flash_dq"),
                          ("flash_dkv_kernel", "K3 flash_dkv")):
        if kernel in name:
            return group
    if any(t in low for t in ("fprop", "dgrad", "wgrad", "conv", "implicit",
                              "cudnn", "nhwc", "nchw")):
        return "convs (cuDNN)"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "gemv", "nvjet")):
        return "GEMM (cuBLAS)"
    if "reduce" in low:
        return "reductions (BN statistics, norms, loss)"
    if any(t in low for t in ("elementwise", "vectorized", "unrolled")):
        return "elementwise (BN apply, ReLU, casts, optimizer)"
    return name[:70]


def image_phase(name, ops, run, flash_layers=0, **kw):
    """`run(**kw)` (run_benchmark or run_vit_benchmark) with every kernel
    count zeroed just before and read just after: K1-K3 each
    flash_layers x the steps run (the decode kernels never); every
    timed loss finite and no step skipped by the guard (the streak of
    every step read, warmup included). Returns (state, metrics,
    counts)."""
    from mpi_operator_tpu_torch.train import trainer as tr
    streaks = []
    step = tr.Trainer.train_step

    def recording(self, state, images, labels):
        state, m = step(self, state, images, labels)
        streaks.append(m["nonfinite_streak"])
        return state, m
    tr.Trainer.train_step = recording
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    try:
        state, m = run(log=lambda line: log(f"  {line}"), **kw)
        torch.cuda.synchronize()
    finally:
        tr.Trainer.train_step = step
    counts = dict(ops.launch_counts)
    steps = state.step
    want = {k: flash_layers * steps for k in FLASH_KERNELS}
    check(all(counts[k] == want[k] for k in FLASH_KERNELS)
          and all(n == 0 for k, n in counts.items()
                  if k not in FLASH_KERNELS),
          f"{name}: launches {counts} over {steps} steps; K1-K3 expected "
          f"{want}, the decode kernels 0")
    losses = m["step_losses"]
    check(all(math.isfinite(x) for x in losses)
          and math.isfinite(m["final_loss"]),
          f"{name}: non-finite loss among {losses}")
    check(len(streaks) == steps and int(torch.stack(streaks).max()) == 0,
          f"{name}: the guard skipped a step")
    stats = {k: m[k] for k in ("images_per_sec", "step_time_p50_ms",
                               "step_time_p99_ms", "host_gap_p50_ms",
                               "mfu", "tflops_per_sec_per_device",
                               "flops_per_step", "final_loss")}
    stats.update(steps=steps, launches={k: counts[k] for k in FLASH_KERNELS},
                 first_loss=losses[0], last_loss=losses[-1],
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                 card=device_line())
    log(f"  {name}: {json.dumps(stats)}")
    return state, m, counts


def profile_image(state, batch_size, image_size, step_ms, steps=2):
    """Where an image training step's time goes: `steps` steps under
    torch.profiler after one unprofiled step, on the run's own state;
    device busy a step against the unprofiled step time, the idle
    share, device time by kernel group; then the optimizer's update
    (SGD, the statistics and the guard over the flat buffers,
    Trainer.apply_update) timed alone with CUDA events on the run's
    state, which it leaves changed."""
    from torch.profiler import ProfilerActivity, profile

    from mpi_operator_tpu_torch.data import SyntheticImageDataset
    from mpi_operator_tpu_torch.train import Trainer, TrainerConfig
    dev = state.params.device
    trainer = Trainer(state.model, TrainerConfig(
        global_batch_size=batch_size, image_size=image_size), device=dev)
    batch = SyntheticImageDataset(batch_size, image_size, seed=1,
                                  device=dev).batch(0)
    trainer.train_step(state, *batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(state, *batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups = {}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.is_user_annotation):
            continue
        g = groups.setdefault(image_group(e.name), [0.0, 0])
        g[0] += e.time_range.elapsed_us()
        g[1] += 1
    busy = sum(g[0] for g in groups.values())
    busy_ms = busy / 1e3 / steps
    log(f"  profile ({device_line()}): {steps} steps, wall "
        f"{wall_us / 1e3 / steps:.2f} ms a step profiled, device busy "
        f"{busy_ms:.2f} ms a step, idle share {1 - busy / wall_us:.3f} "
        f"profiled, {1 - busy_ms / step_ms:.3f} against the unprofiled "
        f"step of {step_ms:.2f} ms")
    for name, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  profile: {us / 1e3 / steps:8.3f} ms a step "
            f"{us / max(busy, 1e-9):6.1%} {n // steps:5d} launches a step  "
            f"{name}")
    g = torch.randn(state.params.shape, device=dev) * 1e-3
    loss = torch.zeros((), device=dev)
    trainer.apply_update(state, g, loss)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(10):
        trainer.apply_update(state, g, loss)
    end.record()
    torch.cuda.synchronize()
    log(f"  profile: optimizer alone (Trainer.apply_update: SGD, BN "
        f"statistics and the guard over {state.params.numel()} f32 "
        f"params) {start.elapsed_time(end) / 10:.3f} ms")
    return busy_ms


def train_resnet_phase(ops):
    """RESNET_LEGS through run_benchmark, each profiled; then the npy
    shard path on the card (`shard_leg`)."""
    from mpi_operator_tpu_torch.examples.benchmark import run_benchmark
    for name, kw in RESNET_LEGS:
        state, m, _ = image_phase(name, ops, run_benchmark, **kw)
        profile_image(state, kw["batch_per_device"], kw["image_size"],
                      m["step_time_p50_ms"])
        del state
        gc.collect()
        torch.cuda.empty_cache()
    shard_leg(ops)


# the shard leg: ResNet-50 s2d at 64 px on uint8 npy shards, a cut of
# the headline leg's data path (resolution and depth: the path is what
# is checked, not its speed)
SHARD_KW = dict(model_name="resnet50", stem="s2d", batch_per_device=32,
                image_size=64, num_steps=4, warmup_steps=1)


def shard_leg(ops):
    """Two seeded uint8 npy shards in a temporary directory: the native
    loader's batch on the card equals the Python path's bit for bit (one
    shard, the same order), and run_benchmark(data_dir=) trains on them
    through the pinned host-to-device copy with finite losses."""
    from mpi_operator_tpu_torch.data.imagefolder import (NpyImageDataset,
                                                         write_npy_shard)
    from mpi_operator_tpu_torch.examples.benchmark import run_benchmark
    size, b = SHARD_KW["image_size"], SHARD_KW["batch_per_device"]
    rs = np.random.RandomState(5)
    with tempfile.TemporaryDirectory() as tmp:
        one = os.path.join(tmp, "one")
        for i in range(2):
            write_npy_shard(tmp if i else one, f"s{i}",
                            rs.randint(0, 256, (4 * b, size, size, 3))
                            .astype(np.uint8),
                            rs.randint(0, 1000, 4 * b).astype(np.int64))
        sets = [NpyImageDataset(one, b, size, dtype=torch.bfloat16,
                                use_native=mode)
                for mode in ("always", "never")]
        try:
            (xn, yn), (xp, yp) = next(sets[0]), next(sets[1])
            torch.cuda.synchronize()
            check(xn.is_cuda and torch.equal(xn.view(torch.int16),
                                             xp.view(torch.int16))
                  and torch.equal(yn, yp),
                  "native and Python shard batches differ on the card")
        finally:
            for ds in sets:
                ds.close()
        os.replace(os.path.join(one, "s0_images.npy"),
                   os.path.join(tmp, "s0_images.npy"))
        os.replace(os.path.join(one, "s0_labels.npy"),
                   os.path.join(tmp, "s0_labels.npy"))
        image_phase("resnet50-s2d-shards", ops, run_benchmark,
                    data_dir=tmp, **SHARD_KW)


def named_grads(model, trainer, state, batch):
    """{name: f32 gradient} of one batch through the image trainer."""
    loss, g, _ = trainer.loss_and_grads(state, *batch)
    out, off = {}, 0
    for name, p in model.named_parameters():
        out[name] = g[off:off + p.numel()]
        off += p.numel()
    return float(loss), out


def vit_grads_agree(dev):
    """One batch's gradients of a 2-layer ViT-B/16 cut from the same
    weights through flash (K1-K3) and dense attention, as the BERT check
    does: flash with delta from an f32 O against the dense path with f32
    attention at cosine >= GRAD_COSINE a tensor (key biases: rounding
    noise under NOISE_NORM of the global norm), the global norms within
    GRAD_NORM_RTOL; the shipped flash and the bf16 dense path printed
    against it."""
    from mpi_operator_tpu_torch.data import SyntheticImageDataset
    from mpi_operator_tpu_torch.models import create_vit
    from mpi_operator_tpu_torch.train import Trainer, TrainerConfig
    batch = SyntheticImageDataset(VIT_GRAD_BATCH, 224, seed=1,
                                  device=dev).batch(0)
    contexts = {"exact": exact_dense_attention, "flash-f32-delta": f32_delta}
    grads = {}
    for impl in ("exact", "dense", "flash-f32-delta", "flash"):
        attention = "flash" if impl.startswith("flash") else "dense"
        model = create_vit("vit-b16", device=dev, seed=0,
                           num_layers=VIT_GRAD_LAYERS, attention=attention)
        trainer = Trainer(model, TrainerConfig(
            global_batch_size=VIT_GRAD_BATCH), device=dev)
        state = trainer.init_state(0)
        with contexts.get(impl, contextlib.nullcontext)():
            grads[impl] = named_grads(model, trainer, state, batch)
        del model, trainer, state
        torch.cuda.empty_cache()

    def compare(a, b, checked):
        (la, ga), (lb, gb) = grads[a], grads[b]
        na = float(torch.cat(list(ga.values())).norm())
        nb = float(torch.cat(list(gb.values())).norm())
        worst = (1.0, "")
        for name in ga:
            x, y = ga[name], gb[name]
            if name.endswith("attn.key.bias"):
                if checked:
                    check(float(x.norm()) <= NOISE_NORM * na
                          and float(y.norm()) <= NOISE_NORM * nb,
                          f"{name}: gradient is not rounding noise")
                continue
            cos = float(torch.dot(x, y) / (x.norm() * y.norm())
                        .clamp(min=1e-30))
            worst = min(worst, (cos, name))
        log(f"  vit grads {a} vs {b}: loss {la:.6f} vs {lb:.6f}, global "
            f"norm {na:.6f} vs {nb:.6f}, worst cosine {worst[0]:.6f} "
            f"({worst[1]})")
        if checked:
            check(worst[0] >= GRAD_COSINE, f"vit gradient cosine {worst}")
            check(abs(na - nb) <= GRAD_NORM_RTOL * nb,
                  f"vit global gradient norms {na} / {nb}")
    compare("flash-f32-delta", "exact", True)
    for a, b in (("flash", "exact"), ("dense", "exact"), ("flash", "dense")):
        compare(a, b, False)


def train_vit_phase(ops, dev):
    """VIT_LEG through run_vit_benchmark (K1-K3 12 x the steps run),
    profiled; then the gradient check on a 2-layer cut. Returns the
    run's launch counts."""
    from mpi_operator_tpu_torch.examples.lm_benchmark import \
        run_vit_benchmark
    state, m, counts = image_phase("vit-b16", ops, run_vit_benchmark,
                                   flash_layers=12, **VIT_LEG)
    profile_image(state, VIT_LEG["batch_per_device"], VIT_LEG["image_size"],
                  m["step_time_p50_ms"])
    del state
    gc.collect()
    torch.cuda.empty_cache()
    vit_grads_agree(dev)
    return counts


def ddp_gang(world, backend, out, port, *extra):
    """tests/torch_ddp_worker.py as `world` ranks on the card, through
    the port's launch.py (TPU_SLOTS_PER_WORKER=world) and bootstrap,
    which must pick `backend`; returns (rank 0's saved results,
    seconds)."""
    env = dict(os.environ, TPU_SLOTS_PER_WORKER=str(world))
    for k in ("TPU_WORKER_ID", "TPU_LOCAL_RANK", "TPU_FAULT_INJECT"):
        env.pop(k, None)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_operator_tpu_torch.bootstrap.launch",
         "--", sys.executable, os.path.join(root, "tests",
                                            "torch_ddp_worker.py"),
         str(world), str(port), out, "--device", "cuda", "--size", "chip",
         "--image-size", str(DDP_IMAGE), "--steps", str(DDP_STEPS),
         *extra],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"DDP gang of {world} over {backend} exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    saved = torch.load(out)
    check(saved["backend"] == backend,
          f"the gang ran over {saved['backend']}, not {backend}")
    return saved["results"], secs


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def cudnn_heuristics():
    """cuDNN picks its conv algorithms by heuristics inside, as the
    gangs' worker processes do. [train-resnet]'s run_benchmark turns on
    cuDNN autotuning (cudnn.benchmark) for the rest of this process, and
    the autotuner's timing-dependent pick of an f32 algorithm can round
    otherwise than the ranks': the 2 x 2 ResNet-50 update read 1.03e-3
    against the ranks' in one full run, ~1e-6 in every other."""
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = prev


def train_ddp_phase(dev):
    """Two ranks on the one card over gloo (NCCL refuses two ranks on one
    device), then one rank over NCCL, each against this process's
    single-process run of the same models, weights and global batches:
    the relative error of each update within DDP_REL, the statistics
    too. Then the planted per-rank-BN fault, which must fail that
    check."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import torch_ddp_worker as worker
    want = worker.train(0, 1, dev, DDP_STEPS, DDP_IMAGE, "chip")
    legs = [(2, "gloo", None), (1, "nccl", None), (2, "gloo", "per-rank-bn")]
    with tempfile.TemporaryDirectory() as tmp:
        for world, backend, fault in legs:
            extra = ("--fault", fault, "--only", "resnet") if fault else ()
            got, secs = ddp_gang(world, backend,
                                 os.path.join(tmp, f"{backend}-{world}.pt"),
                                 free_port(), *extra)
            for name, (s0, p, mom, st) in got.items():
                w0, wp, wm, ws = want[name]
                check(torch.equal(s0, w0), f"{name}: the ranks started "
                      f"from other weights")
                upd = float(((p - s0) - (wp - w0)).norm()
                            / (wp - w0).norm())
                mrel = float((mom - wm).norm() / wm.norm())
                srel = (float((st - ws).norm() / ws.norm())
                        if ws.numel() else 0.0)
                log(f"  ddp {name} {world} rank(s) over {backend}"
                    f"{', fault ' + fault if fault else ''} "
                    f"({device_line()}, {secs:.1f} s): update relative "
                    f"error {upd:.3e}, momentum {mrel:.3e}, statistics "
                    f"{srel:.3e} (limit {DDP_REL[name]:.0e})")
                agrees = max(upd, mrel, srel) <= DDP_REL[name]
                if fault:
                    check(not agrees, f"ddp {name}: the planted fault "
                          f"{fault} passed the check ({upd}, {mrel}, "
                          f"{srel} <= {DDP_REL[name]})")
                else:
                    check(agrees, f"ddp {name} over {backend}: {upd}, "
                          f"{mrel}, {srel} > {DDP_REL[name]}")


# ---------------------------------------------------------------------------
# [train-lm-ddp]: the data-parallel LM trainer, its mesh and collectives
# ---------------------------------------------------------------------------

# (a): the [train] leg's gpt2-medium at full width and depth as a gang of
# one over NCCL (the bootstrap's rendezvous, the flat all-reduce)
LM_GANG1 = dict(workload="gpt2", size="medium", batch_per_device=16,
                seq_len=512, num_steps=10, warmup_steps=3, attention="flash")
# (b), (c): tests/torch_lm_gang_worker.py's chip configs, 3 AdamW steps on
# a global batch of 8 x 256, gangs against this process, compared by the
# relative error of the update, mu and nu. (b) runs the three models in
# f32 with dense attention, TF32 off: in bf16 through K1-K3 the ranks'
# GEMMs of 4 rows round like those of 8 only to bf16 ulps, and on the
# H100 the sound MoE then read 2.9e-2 against 8.7e-2 for the planted
# per-rank denominator, too close to tell apart. In f32 the sound
# models read 3.6e-6-1.4e-5 and the faults 8.6e-2-0.39: 1e-3 sits near
# the geometric mean of the nearest two, ~70x from each. (c) runs gpt2
# in bf16 through K1-K3 (sound 7.8e-3 on the H100) and ResNet-50 in f32.
LM_DDP_STEPS = 3
LM_DDP_REL = 1e-3
LM_DDP_BF16_REL = 3e-2


def gang_of_one(ops, name, **kw):
    """train_phase(name, **kw) inside a process group of one, joined
    through the bootstrap's rendezvous and backend choice (NCCL on the
    card), so the LMTrainer runs its gradient all-reduce; the group is
    left afterwards. Returns train_phase's (state, metrics, counts)."""
    import torch.distributed as dist

    from mpi_operator_tpu_torch.bootstrap import bootstrap, initialize
    env = {"TPU_COORDINATOR_ADDRESS": f"127.0.0.1:{free_port()}",
           "TPU_NUM_PROCESSES": "1"}
    info = initialize(env, hostname="lm-worker-0")
    bootstrap._initialize_distributed(info, env,
                                      backend=bootstrap.dist_backend(info))
    try:
        check(dist.get_backend() == "nccl",
              f"the gang of one joined over {dist.get_backend()}")
        return train_phase(name, ops, **kw)
    finally:
        dist.destroy_process_group()


def lm_ddp_errors(label, got, want, limit, fault=False):
    """Print a gang's errors against one process; check that they are
    within `limit` (or, for a planted fault, that they are not)."""
    import torch_lm_gang_worker as worker
    err = worker.compare(got, want)
    worst = max(err["update"], err["mu"], err["nu"])
    log(f"  lm-ddp {label} ({device_line()}): update relative error "
        f"{err['update']:.3e}, mu {err['mu']:.3e}, nu {err['nu']:.3e}, "
        f"loss {err['loss']:.3e} (limit {limit:.0e})")
    if fault:
        check(worst > limit, f"lm-ddp {label}: the planted fault passed "
              f"the check ({err} <= {limit})")
    else:
        check(worst <= limit, f"lm-ddp {label}: {err} > {limit}")
    return err


def train_lm_ddp_phase(ops, dev, single):
    """(a) gpt2-medium as a gang of one over NCCL beside `single`, the
    [train] leg's metrics; (b) two gloo ranks on the card against this
    process for gpt2, bert and MoE, then the planted faults; (c) 2 slices
    x 2 gloo ranks for gpt2 and ResNet-50, and the hierarchical mean
    against the flat one; (d) the allreduce harness alone, which must
    report the empty curve. Returns (a)'s launch counts."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import torch_lm_gang_worker as worker
    torch.cuda.empty_cache()
    _, m, counts = gang_of_one(ops, "gpt2-medium-gang-of-one", **LM_GANG1)
    log(f"  gang of one against the single process ({device_line()}): "
        f"tokens/s {m['tokens_per_sec']:.1f} vs "
        f"{single['tokens_per_sec']:.1f}, step p50 "
        f"{m['step_time_p50_ms']:.1f} vs {single['step_time_p50_ms']:.1f} "
        f"ms, per device {m['tokens_per_sec_per_device']:.1f}")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        want = worker.run(0, 1, dev, LM_DDP_STEPS, "chip")
        got, secs = worker.gang(2, os.path.join(tmp, "r"), "--size", "chip",
                                "--faults", "--checks", "--train-dir",
                                os.path.join(tmp, "ckpt"), device="cuda")
        log(f"  2 ranks over {got[0]['backend']} on the card: {secs:.1f} s")
        check(got[0]["backend"] == "gloo", "two ranks on one card not gloo")
        for name in worker.MODELS:
            for r, res in enumerate(got):
                lm_ddp_errors(f"{name} rank {r}", res[name], want[name],
                              LM_DDP_REL)
            check(torch.equal(got[0][name]["params"], got[1][name]["params"]),
                  f"lm-ddp {name}: the ranks hold other params")
            log(f"  {name} drop rates: gang {got[0][name]['drop_rates']}, "
                f"one process {want[name]['drop_rates']}")
        for name, fault in worker.FAULTS:
            lm_ddp_errors(f"{name} fault {fault}", got[0][f"{name}/{fault}"],
                          want[name], LM_DDP_REL, fault=True)
        check(all(r["guard"]["rolled_back"] and r["guard"]["skip"]["unchanged"]
                  for r in got), f"H15: {[r['guard']['skip'] for r in got]}")
        check(all(r["hierarchical"]["max_diff"] < 1e-6 for r in got),
              "hierarchical mean != flat mean over 2 ranks")
        routing = worker.routing_check(0, 1, dev)
        check(torch.equal(torch.cat([r["routing"]["slot"] for r in got]),
                          routing["slot"]), "H14: queue positions differ")
    with tempfile.TemporaryDirectory() as tmp:
        want = worker.run(0, 1, dev, LM_DDP_STEPS, "chip-bf16",
                          only=["gpt2", "resnet"])
        got, secs = worker.gang(4, os.path.join(tmp, "r"), "--size",
                                "chip-bf16", "--only", "gpt2,resnet",
                                "--checks",
                                "--train-dir", os.path.join(tmp, "ckpt"),
                                slices=2, device="cuda")
        check([r["mesh"]["dcn"] for r in got] == [2] * 4,
              f"the mesh of 2 slices: {got[0]['mesh']}")
        log(f"  2 slices x 2 ranks over {got[0]['backend']}: {secs:.1f} s, "
            f"hierarchical - flat "
            f"{max(r['hierarchical']['max_diff'] for r in got):.3e}")
        check(all(r["hierarchical"]["max_diff"] < 1e-6 for r in got),
              "hierarchical mean != flat mean over 2 x 2")
        for r, res in enumerate(got):
            lm_ddp_errors(f"gpt2 bf16 2x2 rank {r}", res["gpt2"],
                          want["gpt2"], LM_DDP_BF16_REL)
            (s0, p, mom, st), (w0, wp, wm, ws) = res["resnet"], want["resnet"]
            upd = float(((p - s0) - (wp - w0)).norm() / (wp - w0).norm())
            mrel = float((mom - wm).norm() / wm.norm())
            srel = float((st - ws).norm() / ws.norm())
            log(f"  resnet50 2x2 rank {r}: update {upd:.3e}, momentum "
                f"{mrel:.3e}, statistics {srel:.3e} (limit "
                f"{DDP_REL['resnet']:.0e})")
            check(max(upd, mrel, srel) <= DDP_REL["resnet"],
                  f"resnet 2x2 rank {r}: {upd}, {mrel}, {srel}")
    env = dict(os.environ, TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}",
               TPU_NUM_PROCESSES="1")
    for k in ("TPU_WORKER_ID", "TPU_LOCAL_RANK", "TPU_SLOTS_PER_WORKER"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_operator_tpu_torch.examples."
         "allreduce_bench", "--payload-mb", "1", "16", "64"],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"allreduce_bench: {proc.stderr[-2000:]}")
    bench = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"  allreduce_bench alone: {json.dumps(bench)}")
    check(bench["value"] is None and bench["efficiency_curve"]
          == "insufficient devices (need >1)"
          and [p["devices"] for p in bench["points"]] == [1, 1, 1],
          f"allreduce_bench on one card: {bench}")
    return counts


# ---------------------------------------------------------------------------
# [train-lm-mp]: fsdp, tensor, sequence and expert parallelism
# ---------------------------------------------------------------------------

# tests/torch_mp_worker.py's legs, one gang of 4 gloo ranks on the card
# (launch.py, TPU_SLOTS_PER_WORKER 4, the bootstrap), each leg laying its
# own mesh over the same processes
LM_MP_FULL = "chip/full-fsdp2-tp2"
LM_MP_PARITY = ("chip/fsdp2-tp2", "chip/dp2-fsdp2", "chip/fsdp2-tp2-uni",
                "chip/fsdp2-tp2-bidir", "chip/moe-dp2-ep2")
LM_MP_RINGS = ("chip/ring-sp2", "chip/ring-sp4")
LM_MP_RING_ALONE_FAULT = "chip/ring-sp2/ring-diagonal-noncausal"
# The ring in bf16 against K1-K3 over the whole sequence: every visible
# block's output and gradients leave K1-K3 rounded to bf16 before the
# f32 combine, where the whole-sequence kernels round once, so the two
# differ by a few bf16 rounding errors of a partial: 1.0e-3 to 3.1e-3
# relative on the H100 at sp 2 and 4 (the whole-sequence K1-K3 chain
# against its plain chain reads 2.4e-4 to 2.3e-3). `out` stays within
# F3's K1 limit (FLASH_REL["flash_fwd"]); F3's K2/K3 limit (4e-4) holds
# a kernel against its plain version given the same lse and delta, not
# a different summation, so dq, dk and dv are held to RING_REL, under
# which the ring with its diagonal block run non-causal must fail.
RING_REL = {"out": FLASH_REL["flash_fwd"], "dq": 1e-2, "dk": 1e-2,
            "dv": 1e-2}
LM_MP_RING_TRAIN = "chip/sp2-tp2"
LM_MP_FAULTS = ("chip/fsdp2-tp2/allreduce-skipped",
                "chip/fsdp2-tp2/fsdp-wrong-group",
                "chip/fsdp2-tp2/norm-tp-times")
LM_MP_RING_FAULT = "chip/sp2-tp2/ring-diagonal-noncausal"
LM_MP_RANKS = 4


def one_process_leg(worker, name, dev):
    """A leg's model at one process on the card from the same weights and
    numpy batches: attention as the size gives it (K1-K3 in bf16, dense
    in f32), no fault, no overlap rings."""
    spec = dict(worker.LEGS[name], fault=None)
    spec["cfg"] = {k: v for k, v in spec["cfg"].items()
                   if k not in ("attention", "tp_overlap", "tp_ring")}
    try:
        return worker.train_leg(spec, dev)
    finally:
        torch.cuda.empty_cache()


def ring_errors(worker, name, res, dev):
    """The ring's out, dq, dk, dv (gathered, rank 0) against K1-K3 over
    the whole sequence in this process, same inputs and cotangent, as
    relative errors; and the plain versions' against K1-K3, the same
    comparison without the ring."""
    from mpi_operator_tpu_torch.ops import attention as ops
    q, k, v, do = worker.ring_inputs(*worker.LEGS[name]["ring"]["shape"],
                                     torch.bfloat16, device=dev)
    out = {}
    for causal in (True, False):
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        o = ops.flash_attention(qs, ks, vs, causal=causal)
        o.backward(do)
        got = res[causal]
        out[causal] = {n: rel_err(got[n].to(dev).float(), t.float())
                       for n, t in (("out", o), ("dq", qs.grad),
                                    ("dk", ks.grad), ("dv", vs.grad))}
        del qs, ks, vs, o
    return out


def lm_mp_check(label, err, limit, fault=False):
    """Print a leg's errors against one process; check the worst of the
    update, mu and nu (those the leg gathered) against `limit` (for a
    planted fault, that it exceeds it)."""
    worst = max(err.get(k, 0.0) for k in ("update", "mu", "nu"))
    log(f"  lm-mp {label} ({device_line()}): relative error "
        + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
        + f" (limit {limit:.0e})")
    if fault:
        check(worst > limit, f"lm-mp {label}: the planted fault passed the "
              f"check ({err} <= {limit})")
    else:
        check(worst <= limit, f"lm-mp {label}: {err} > {limit}")


def mp_worker():
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import torch_mp_worker as worker
    return worker


# the resharding leg (restore_resharded): gpt2-medium at (1, 2, 2) saved,
# restored at (1, 4, 1), at fsdp 2 on ranks 0 and 1 and as one replica on
# rank 0, then the wrong-offset fault
LM_RESHARD = "chip/reshard-fsdp2-tp2"


def reshard_checks(got):
    """The resharding leg's results: every target bit-equal (each rank's
    masters, mu, nu and the step against its share of the saved state)
    on every rank of its mesh, the planted fault caught on rank 1; each
    rank's ReadStats printed."""
    worker = mp_worker()
    chain = dict(worker.LEGS[LM_RESHARD]["chain"])
    for label, sizes in chain.items():
        n = max(1, math.prod(sizes.values()))
        rows = [r[LM_RESHARD] for r in got[:n]]
        check(all(r["checks"][label] for r in rows),
              f"[train-lm-gang] reshard to {label}: "
              f"{[r['checks'][label] for r in rows]}")
        for rank, r in enumerate(rows):
            st = r["stats"][label]
            log(f"  reshard (1, 2, 2) -> {label} rank {rank}: read "
                f"{st['bytes_read']} bytes in {st['reads']} tensors against "
                f"a share of {st['share_bytes']} (checkpoint "
                f"{st['total_bytes']}), peak in flight "
                f"{st['peak_in_flight_bytes']}, {st['seconds']:.2f} s")
    faults = [r[LM_RESHARD]["checks"]["fault"] for r in got[:2]]
    check(faults == [True, False], f"[train-lm-gang] the wrong-offset "
          f"fault on rank 1 of the fsdp 2 target: checks {faults}")
    log(f"  reshard: every target bit-equal; the wrong-offset fault caught "
        f"on rank 1 (checks {faults}); the leg "
        f"{got[0][LM_RESHARD]['seconds']:.1f} s ({device_line()})")


def lm_gang_phase():
    """[train-lm-mp]'s and [train-lm-pp]'s legs and the resharding leg
    as ONE gang of 4 gloo ranks on the card (one start of the ranks for
    all of them), each leg laying its own mesh over the same processes.
    Returns every rank's results."""
    worker = mp_worker()
    torch.cuda.empty_cache()
    legs = ((LM_MP_FULL,) + LM_MP_PARITY + LM_MP_RINGS
            + (LM_MP_RING_ALONE_FAULT, LM_MP_RING_TRAIN) + LM_MP_FAULTS
            + (LM_MP_RING_FAULT,) + LM_PP_FULL + LM_PP_PARITY
            + LM_PP_FAULTS + (LM_RESHARD,))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        got = worker.gang(LM_MP_RANKS, os.path.join(tmp, "r"), legs,
                          device="cuda", timeout=900)
    log(f"  one gang of {LM_MP_RANKS} ranks over {got[0]['backend']} on the "
        f"card, {len(legs)} legs: {time.perf_counter() - t0:.1f} s (by leg: "
        + ", ".join(f"{n} {got[0][n]['seconds']:.1f}" for n in legs) + ")")
    check(got[0]["backend"] == "gloo", "ranks sharing one card not gloo")
    reshard_checks(got)
    return got


def train_lm_mp_phase(ops, dev, single, got):
    """fsdp, tp, sp and ep on one card, from the gang's results (`got`,
    lm_gang_phase): (a) gpt2-medium whole at (dp, fsdp, tp) = (1, 2, 2),
    bf16, K1-K3, 16 x 512, 2 + 3 steps; (b) f32 parity legs against one
    process; (c) the ring through K1-K3 alone against whole-sequence
    K1-K3, then a trainer step at (dp, sp, tp) = (1, 2, 2); (d) the
    planted faults. Returns {kernel: rank 0's launches in (a)} and the
    ring's."""
    worker = mp_worker()

    # (a) gpt2-medium at full width and depth
    cfg = worker.config_of(worker.LEGS[LM_MP_FULL])
    ranks = [r[LM_MP_FULL] for r in got]
    one_bytes = 12 * sum(math.prod(s) for s in
                         worker.tt.param_shapes(cfg).values())
    for i, r in enumerate(ranks):
        check(all(math.isfinite(x) for x in r["losses"]),
              f"(a) rank {i}: non-finite loss {r['losses']}")
        check(r["streak"] == 0, f"(a) rank {i}: the guard skipped a step")
        want = cfg.num_layers * r["steps"]
        check(r["launches"] == {k: want for k in worker.FLASH},
              f"(a) rank {i}: K1-K3 launches {r['launches']} != "
              f"{cfg.num_layers} x {r['steps']}")
        check(r["heads_per_launch"] == cfg.num_heads // 2,
              f"(a) rank {i}: {r['heads_per_launch']} heads a launch")
        ratio = r["masters_bytes"] / (one_bytes / 4)
        log(f"  (a) rank {i} ({device_line()}): masters + mu + nu "
            f"{r['masters_bytes'] / 1e9:.3f} GB = {ratio:.4f} x one "
            f"process's {one_bytes / 1e9:.3f} GB / (fsdp 2 x tp 2); peak "
            f"memory {r['peak_bytes'] / 1e9:.2f} GB; losses "
            f"{[round(x, 4) for x in r['losses']]}")
        check(1.0 <= ratio < 1.01, f"(a) rank {i}: state bytes ratio {ratio}")
    log(f"  (a) gpt2-medium at (dp, fsdp, tp) = (1, 2, 2), 4 ranks sharing "
        f"one card over gloo (not a scale-out figure; {device_line()}): "
        f"tokens/s {ranks[0]['tokens_per_sec']:.1f} (the gang's), step p50 "
        f"{ranks[0]['step_time_p50_ms']:.1f} ms, against [train]'s one "
        f"process {single['tokens_per_sec']:.1f} tokens/s, step p50 "
        f"{single['step_time_p50_ms']:.1f} ms; K1-K3 "
        f"{ranks[0]['launches']} a rank, 8 heads a launch")

    # (b) f32 parity against one process
    refs = {}
    for name in LM_MP_PARITY:
        want = refs[name] = one_process_leg(worker, name, dev)
        mine = [r[name] for r in got if name in r]
        lm_mp_check(name, worker.compare(mine[0], want), LM_DDP_REL)
        check(all(r["digest"] == mine[0]["digest"] for r in mine),
              f"(b) {name}: the ranks' gathered shards differ")

    # (c) the ring through K1-K3
    ring_counts = {}
    for name in LM_MP_RINGS:
        n = worker.LEGS[name]["mesh"]["sp"]
        errs = ring_errors(worker, name, got[0][name], dev)
        for causal, e in errs.items():
            log(f"  (c) {name} {'causal' if causal else 'non-causal'} "
                f"({device_line()}): against K1-K3 over the whole "
                f"sequence, relative error "
                + ", ".join(f"{k} {v:.3e}" for k, v in e.items())
                + f" (limits {RING_REL})")
            for k, v in e.items():
                check(v <= RING_REL[k], f"(c) {name} causal={causal}: {k} "
                      f"{v} > {RING_REL[k]}")
            for r in got:
                if name not in r:
                    continue
                res = r[name][causal]
                want = res["sp_index"] + 1 if causal else n
                check(res["launches"] == {k: want for k in worker.FLASH},
                      f"(c) {name} causal={causal} sp rank "
                      f"{res['sp_index']}: launches {res['launches']}, "
                      f"H28's plan {want}")
        ring_counts[name] = [r[name][True]["launches"]
                             for r in got if name in r]
    fault = ring_errors(worker, LM_MP_RING_ALONE_FAULT,
                        got[0][LM_MP_RING_ALONE_FAULT], dev)[True]
    log(f"  (c) planted: {LM_MP_RING_ALONE_FAULT} causal, relative error "
        + ", ".join(f"{k} {v:.3e}" for k, v in fault.items()))
    check(all(fault[k] > RING_REL[k] for k in ("out", "dq")),
          f"(c) the ring's non-causal diagonal passed RING_REL: {fault}")
    cfg = worker.config_of(worker.LEGS[LM_MP_RING_TRAIN])
    want = one_process_leg(worker, LM_MP_RING_TRAIN, dev)
    for i, r in enumerate(got):
        res = r[LM_MP_RING_TRAIN]
        sp_index = i // 2 % 2                  # (sp, tp) = (2, 2), tp inner
        plan = cfg.num_layers * len(res["losses"]) * (sp_index + 1)
        check(res["launches"] == {k: plan for k in worker.FLASH},
              f"(c) ring step rank {i}: launches {res['launches']}, H28's "
              f"plan {plan}")
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(res["losses"], want["losses"]))
        log(f"  (c) trainer at (dp, sp, tp) = (1, 2, 2), bf16, rank {i}: "
            f"K1-K3 {res['launches']} (plan {plan}), losses "
            f"{res['losses']} against one process's {want['losses']}: "
            f"relative {loss_rel:.3e} (limit {LM_DDP_BF16_REL:.0e})")
        check(loss_rel <= LM_DDP_BF16_REL, f"(c) ring step loss {loss_rel}")
        check(res["digest"] == got[0][LM_MP_RING_TRAIN]["digest"],
              f"(c) ring step rank {i}: the gathered shards differ")
    lm_mp_check(LM_MP_RING_TRAIN, worker.compare(got[0][LM_MP_RING_TRAIN],
                                                 want), LM_DDP_BF16_REL)

    # (d) the planted faults
    base = refs["chip/fsdp2-tp2"]
    for name in LM_MP_FAULTS:
        lm_mp_check(name, worker.compare(got[0][name], base), LM_DDP_REL,
                    fault=True)
    lm_mp_check(LM_MP_RING_FAULT, worker.compare(got[0][LM_MP_RING_FAULT],
                                                 want),
                LM_DDP_BF16_REL, fault=True)
    return ranks[0]["launches"], ring_counts


# ---------------------------------------------------------------------------
# [train-lm-pp]: pipelines over pp
# ---------------------------------------------------------------------------

# tests/torch_mp_worker.py's pipeline legs, one gang of 4 gloo ranks on
# the card
LM_PP_FULL = ("chip-pp/full-pp4-gpipe", "chip-pp/full-pp4-1f1b2")
LM_PP_PARITY = ("chip-pp/pp2-dp2-gpipe", "chip-pp/pp2-tp2-1f1b2",
                "chip-pp/bert-pp2-dp2-1f1b", "chip-pp/moe-pp2-ep2-gpipe")
LM_PP_FAULTS = ("chip-pp/pp2-dp2-gpipe/tied-not-summed",
                "chip-pp/pp2-dp2-gpipe/hop-dropped",
                "chip-pp/pp2-dp2-gpipe/norm-pp-times")
# a pp rank's masters + mu + nu against its share of one process's
LM_PP_BYTES_REL = 0.01


def pp_reference(worker, name, dev):
    """A pipeline leg's model at one process on the card, from the same
    weights and numpy batches: the LMTrainer, for MoE accumulating over
    the leg's M microbatches (each routed over its own rows, as the
    pipeline routes it)."""
    spec = dict(worker.LEGS[name], fault=None, mesh={}, kind="train")
    spec["cfg"] = {k: v for k, v in spec["cfg"].items() if k != "attention"}
    if spec["model"] == "moe":
        spec["accum"] = spec["micro"]
    try:
        return worker.train_leg(spec, dev)
    finally:
        torch.cuda.empty_cache()


def train_lm_pp_phase(ops, dev, got):
    """Pipelines on one card, from the gang's results (`got`,
    lm_gang_phase): (a) gpt2-medium whole at pp = 4 under GPipe and 1F1B
    x 2, bf16, K1-K3; (b) f32 parity legs against one process; (c) the
    planted faults. Returns {schedule: [each rank's K1-K3 launches in
    (a)]}."""
    worker = mp_worker()
    log(f"  the pipeline legs in the gang: " + ", ".join(
        f"{n} {got[0][n]['seconds']:.1f} s"
        for n in LM_PP_FULL + LM_PP_PARITY + LM_PP_FAULTS))

    # (a) gpt2-medium whole at pp = 4
    counts, peaks = {}, {}
    for name in LM_PP_FULL:
        spec = worker.LEGS[name]
        cfg = worker.config_of(spec)
        shapes = worker.tt.param_shapes(cfg)
        total = sum(math.prod(s) for s in shapes.values())
        blocks = sum(math.prod(s) for n, s in shapes.items()
                     if n.startswith("backbone.blocks."))
        share = (blocks / spec["mesh"]["pp"] + total - blocks) / total
        plan = cfg.num_layers // spec["mesh"]["pp"] * spec["micro"]
        ranks = [r[name] for r in got]
        sched = f"{spec['schedule']}x{spec['interleave']}"
        for i, r in enumerate(ranks):
            check(all(math.isfinite(x) for x in r["losses"]),
                  f"(a) {sched} rank {i}: non-finite loss {r['losses']}")
            check(r["launches"] == {k: plan * r["steps"]
                                    for k in worker.FLASH},
                  f"(a) {sched} rank {i}: K1-K3 launches {r['launches']} "
                  f"!= (L / P) x M = {plan} x {r['steps']} steps")
            ratio = r["masters_bytes"] / (12 * total)
            log(f"  (a) {sched} rank {i} layers {r['layers']} "
                f"({device_line()}): masters + mu + nu "
                f"{r['masters_bytes'] / 1e9:.4f} GB = {ratio:.4f} x one "
                f"process's {12 * total / 1e9:.4f} GB (expected "
                f"{share:.4f}); peak {r['peak_bytes'] / 1e9:.2f} GB; idle "
                f"share of the last step {r['idle_share']:.4f} (busy "
                f"{r['busy_ms']:.1f} of {r['wall_ms']:.1f} ms) against the "
                f"bubble {r['bubble']:.4f}; losses "
                f"{[round(x, 4) for x in r['losses']]}")
            check(abs(ratio - share) <= LM_PP_BYTES_REL * share,
                  f"(a) {sched} rank {i}: state bytes ratio {ratio} vs "
                  f"{share}")
            check(r["replicated_digest"] == ranks[0]["replicated_digest"],
                  f"(a) {sched} rank {i}: the replicated leaves differ")
        log(f"  (a) gpt2-medium, pp = 4, M = {spec['micro']}, {sched}, 4 "
            f"ranks sharing one card over gloo (not a scale-out figure; "
            f"{device_line()}): tokens/s {ranks[0]['tokens_per_sec']:.1f}, "
            f"mean step {ranks[0]['step_mean_ms']:.1f} ms (the timed "
            f"window over its steps), step p50 "
            f"{ranks[0]['step_time_p50_ms']:.1f} ms (a histogram bucket's "
            f"bound), bubble "
            f"{ranks[0]['bubble']:.4f}, MFU {ranks[0]['mfu']}; K1-K3 "
            f"{plan} x {ranks[0]['steps']} a rank")
        counts[sched] = [r["launches"] for r in ranks]
        peaks[sched] = [r["peak_bytes"] for r in ranks]
    gp, f2 = peaks.values()
    for i, (a, b) in enumerate(zip(gp, f2)):
        check(b < a, f"(a) rank {i}: 1F1B x 2's peak {b} not below "
              f"GPipe's {a}")

    # (b) f32 parity against one process
    refs = {}
    for name in LM_PP_PARITY:
        want = refs[name] = pp_reference(worker, name, dev)
        mine = [r[name] for r in got if name in r]
        lm_mp_check(name, worker.compare(mine[0], want), LM_DDP_REL)
        check(all(r["digest"] == mine[0]["digest"]
                  and r["replicated_digest"] == mine[0]["replicated_digest"]
                  for r in mine),
              f"(b) {name}: the ranks' gathered state or replicas differ")

    # (c) the planted faults
    base = refs["chip-pp/pp2-dp2-gpipe"]
    for name in LM_PP_FAULTS:
        lm_mp_check(name, worker.compare(got[0][name], base), LM_DDP_REL,
                    fault=True)
    return counts


# ---------------------------------------------------------------------------
# BERT, MoE and remat training; the generate leg
# ---------------------------------------------------------------------------

# the JAX bench's bert leg (bench.py:835): bert-large, 16 x 512, MLM 0.15
BERT_COMMON = dict(workload="bert", size="large", batch_per_device=16,
                   seq_len=512, attention="flash")
# the moe leg (bench.py:862-865): gpt2-small, 8 experts, top-2, capacity
# factor 1.25, MoE on every second block, 16 x 512
MOE_COMMON = dict(workload="gpt2", size="small", batch_per_device=16,
                  seq_len=512, attention="flash", moe_experts=8)
# a capacity factor of 1.25 admits 1.25x the balanced load an expert;
# past half the routes dropped the router has collapsed onto few experts
MOE_DROP_MAX = 0.5
# 2 timed steps an arm (10 before [train-lm-mp], 3 before [train-lm-pp]
# needed the run's time)
REMAT_COMMON = dict(workload="gpt2", size="medium", batch_per_device=16,
                    seq_len=512, attention="flash", num_steps=2,
                    warmup_steps=2)
REMAT_ARMS = [("off", {}), ("none", dict(remat=True, remat_policy="none")),
              ("dots", dict(remat=True, remat_policy="dots"))]
# the generate leg (bench.py:382 decode_leg): batch 8, prompt 128,
# greedy, decode_kernel=True; cut to 16 new tokens (of 128) and one timed
# call, to make room for [train-lm-mp] in the run's time (PERF.md
# section 6)
GEN_COMMON = dict(batch=8, prompt_len=128, new_tokens=16, num_iters=1,
                  decode_kernel=True)
GEN_LEGS = [("gpt2", "medium", None), ("gpt2", "medium", "int8"),
            ("llama", "1b", None), ("llama", "1b", "int8")]


def train_bert_phase(ops, dev):
    """bert-large through run_lm_benchmark (K1-K3 non-causal), then its
    gradients through flash and dense at a padded batch, and two
    profiled steps. Returns the run's launch counts."""
    from mpi_operator_tpu_torch.train import LMTrainerConfig
    # one window of 10 timed steps (30 before [train-lm-pp] needed the
    # run's time)
    state, m, counts = train_phase("bert-large-train", ops, num_steps=10,
                                   warmup_steps=3, **BERT_COMMON)
    mcfg = state.model.config
    del state
    torch.cuda.empty_cache()
    B, S = BERT_COMMON["batch_per_device"], BERT_COMMON["seq_len"]
    trainer, tstate, batch = grads_agree(
        LMTrainerConfig(global_batch_size=B, seq_len=S, masked_lm=True),
        mcfg, dev, attention_mask=padded_rows(B, S, dev))
    profile_train(trainer, tstate, batch, m["step_time_p50_ms"])
    del trainer, tstate, batch
    torch.cuda.empty_cache()
    return counts


def train_moe_phase(ops, dev):
    """gpt2-small with 8 experts through run_lm_benchmark: launches,
    finite losses, no skipped update, the drop rate a fraction under
    MOE_DROP_MAX; two profiled steps; then 4 layers dropless, whose drop
    rate must be 0."""
    from mpi_operator_tpu_torch.data import TokenStream
    from mpi_operator_tpu_torch.train import LMTrainer, LMTrainerConfig
    state, m, counts = train_phase("gpt2-small-moe8-train", ops,
                                   num_steps=10, warmup_steps=3,
                                   **MOE_COMMON)
    rate = m["moe_drop_rate"]
    check(0.0 <= rate <= MOE_DROP_MAX,
          f"moe drop rate {rate} outside [0, {MOE_DROP_MAX}]")
    B, S = MOE_COMMON["batch_per_device"], MOE_COMMON["seq_len"]
    mcfg = state.model.config
    trainer = LMTrainer(mcfg, LMTrainerConfig(global_batch_size=B,
                                              seq_len=S), device=dev)
    batch = TokenStream(B, S, mcfg.vocab_size, seed=1, device=dev).batch(0)
    profile_train(trainer, state, batch, m["step_time_p50_ms"])
    del state, trainer, batch
    torch.cuda.empty_cache()
    _, m, _ = train_phase("gpt2-small-moe8-dropless-4l", ops, num_steps=4,
                          warmup_steps=1, num_layers=4, moe_dropless=True,
                          **MOE_COMMON)
    check(m["moe_drop_rate"] == 0.0,
          f"dropless drop rate {m['moe_drop_rate']}")
    torch.cuda.empty_cache()
    return counts


def train_remat_phase(ops):
    """gpt2-medium with remat off, "none" and "dots" from the same seed
    and batches: the params after the run must equal remat off's bit for
    bit; train_phase holds K1 at 2 x layers a step under remat and K2/K3
    at layers a step. Prints each arm's peak memory and step p50, and
    profiles two steps of each."""
    from mpi_operator_tpu_torch.data import TokenStream
    from mpi_operator_tpu_torch.train import LMTrainer, LMTrainerConfig
    B, S = REMAT_COMMON["batch_per_device"], REMAT_COMMON["seq_len"]
    arms = {}
    for label, kw in REMAT_ARMS:
        state, m, counts = train_phase(f"gpt2-medium-remat-{label}", ops,
                                       **REMAT_COMMON, **kw)
        peak = torch.cuda.max_memory_allocated() / 2**30
        trainer = LMTrainer(state.model.config, LMTrainerConfig(
            global_batch_size=B, seq_len=S), device=state.params.device)
        batch = TokenStream(B, S, state.model.config.vocab_size, seed=1,
                            device=state.params.device).batch(0)
        profile_train(trainer, state, batch, m["step_time_p50_ms"])
        del trainer, batch
        arms[label] = dict(
            params=state.params.clone(), counts=counts,
            step_time_p50_ms=m["step_time_p50_ms"],
            tokens_per_sec=m["tokens_per_sec"], peak_mem_gib=peak)
        del state
        torch.cuda.empty_cache()
    base = arms["off"]
    for label in ("none", "dots"):
        arm = arms[label]
        same = torch.equal(arm["params"], base["params"])
        diff = float((arm["params"] - base["params"]).abs().max())
        check(same, f"remat {label}: params differ from remat off by up to "
              f"{diff}")
    summary = {label: {k: v for k, v in arm.items() if k != "params"}
               for label, arm in arms.items()}
    log(f"  remat ({device_line()}): {json.dumps(summary)}")
    for label in ("none", "dots"):
        log(f"  remat {label} against off: peak memory "
            f"{arms[label]['peak_mem_gib']:.3f} / "
            f"{base['peak_mem_gib']:.3f} GiB, step p50 "
            f"{arms[label]['step_time_p50_ms']:.2f} / "
            f"{base['step_time_p50_ms']:.2f} ms; params bit-equal")
    del arms
    torch.cuda.empty_cache()


def profile_generate(model, prompt, n_new=32):
    """Where a generate() call's time goes: one call of `n_new` tokens
    under torch.profiler after an unprofiled one; device busy against
    wall time a token step (the prefill included), K4's share, and the
    host ops that take the most CPU time."""
    from torch.profiler import ProfilerActivity, profile

    from mpi_operator_tpu_torch import models
    n_new = min(n_new, model.config.max_len - prompt.shape[1])
    models.generate(model, prompt, n_new, device=model.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        models.generate(model, prompt, n_new, device=model.device)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = k4 = 0.0
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation):
            busy += e.time_range.elapsed_us()
            if kernel_group(e.name) == "K4 decode_attention":
                k4 += e.time_range.elapsed_us()
    log(f"  profile: generate {n_new} tokens, wall {wall_us / 1e3:.2f} ms "
        f"({wall_us / 1e3 / n_new:.3f} ms a token step), device busy "
        f"{busy / 1e3:.2f} ms ({busy / 1e3 / n_new:.3f} ms a step), idle "
        f"share {1 - busy / wall_us:.3f}, K4 {k4 / max(busy, 1e-9):.1%} "
        f"of device time")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in host[:6]:
        log(f"  profile host: {e.self_cpu_time_total / 1e3 / n_new:8.3f} ms "
            f"a step self CPU, {e.count / n_new:7.1f} calls a step  "
            f"{e.key[:60]}")


def generate_phase(ops):
    """run_generate_benchmark at the generate leg's shape for each of
    GEN_LEGS, every kernel count zeroed just before and read just after:
    K4 must have launched once a layer a decode step of every generate()
    call (the warm call and the timed ones; the prefill runs the dense
    path), no other kernel. The last call's greedy tokens against the
    same model's decode_kernel=False run: where a row first differs, a
    near tie of the dense path (SPEC_MARGIN). Prints tokens/s and MBU
    against HBM_BYTES_PER_S, and profiles a call of each bf16 leg.
    Returns the K4 launches of the last leg."""
    import types

    from mpi_operator_tpu_torch import models
    from mpi_operator_tpu_torch.examples.lm_benchmark import \
        run_generate_benchmark
    gen = models.generate
    n_new = GEN_COMMON["new_tokens"]
    launches = 0
    for family, size, kv in GEN_LEGS:
        name = f"{family}-{size}{'-int8' if kv else ''}"
        calls = []

        def recording(model, prompt, n, **kw):
            out = gen(model, prompt, n, **kw)
            calls.append((model, prompt, out.tokens))
            return out
        models.generate = recording
        try:
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            m = run_generate_benchmark(
                size=size, family=family, kv_cache_dtype=kv,
                log=lambda line: log(f"  {line}"), **GEN_COMMON)
            torch.cuda.synchronize()
            counts = dict(ops.launch_counts)
        finally:
            models.generate = gen
        model, prompt, got = calls[-1]
        layers = model.config.num_layers
        want = layers * (n_new - 1) * len(calls)
        check(counts["decode_attention"] == want
              and all(n == 0 for k, n in counts.items()
                      if k != "decode_attention"),
              f"{name}: launches {counts}; K4 expected {want} (layers x "
              f"{n_new - 1} decode steps x {len(calls)} calls)")
        launches = counts["decode_attention"]
        want_tok = gen(model, prompt, n_new, decode_kernel=False,
                       device=model.device).tokens
        P = prompt.shape[1]
        dense = models.decode_model(model, decode_kernel=False)
        rows = [types.SimpleNamespace(id=b, prompt=prompt[b].tolist(),
                                      temperature=0.0)
                for b in range(prompt.shape[0])]

        def results(toks):
            return {b: types.SimpleNamespace(tokens=toks[b, P:].tolist())
                    for b in range(toks.shape[0])}
        divs = first_divergences(dense, rows, results(got),
                                 results(want_tok))
        for d in divs:
            check(near_tie(d), f"{name}: row {d['request']} leaves the "
                  f"dense path at token {d['index']} with no near tie: {d}")
        stats = dict(card=device_line(), calls=len(calls),
                     launches=launches,
                     rows_identical=prompt.shape[0] - len(divs),
                     first_divergences=divs,
                     decode_tokens_per_sec=m["decode_tokens_per_sec"],
                     mbu=m["mbu"], hbm_bytes_per_s=HBM_BYTES_PER_S,
                     decode_bytes_per_step=m["decode_bytes_per_step"],
                     wall_seconds=m["wall_seconds"],
                     peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        log(f"  generate {name}: {json.dumps(stats)}")
        if kv is None:
            profile_generate(model, prompt)
        del model, prompt, dense, calls
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# [operator]: the control plane in GPU mode, with a local kubelet
# ---------------------------------------------------------------------------

# the operator's job: ViT-B/16 at full width (12 layers, 224^2, S = 197
# through K1-K3), 256 images a step, one card. Rank 0 serves "done" for
# 10 s after its run (bootstrap.StatusServer.set_done) and the launcher
# starts only once the worker is Ready; on the card a pod takes ~20 s
# from its start to its first poll, so the run lasts 2 + 150 steps
# (~25 s) and the launcher polls well before the end, as it does for a
# real job
OPERATOR_ARGS = ("--workload", "vit", "--size", "b16", "--image-size", "224",
                 "--batch-per-device", "256", "--warmup-steps", "2",
                 "--num-steps", "150")
OPERATOR_LAYERS = 12
# the worker's fsync'd event log (its /events endpoint serves it), in the
# pod's own directory
OPERATOR_EVENTS = ("--event-log", "events.jsonl")
# the observatory: the worker metrics port the controller renders (each
# pod's real port is LocalKubelet's), the scrape rate limit, the phase's
# resync period and the ViT-B/16 job's progress lease
OPERATOR_METRICS_PORT, OPERATOR_SCRAPE_S, OPERATOR_RESYNC_S = 9100, 2.0, 1.0
OPERATOR_DEADLINE = 60
# the hung worker: ViT at 2 layers of B/16 width, batch 16. The first
# scrape that sees it train already reads tens of steps, so 400 steps
# could end between two scrapes: it is given far more than it runs
# before it is stopped
HUNG_ARGS = ("--workload", "vit", "--size", "b16", "--num-layers", "2",
             "--image-size", "224", "--batch-per-device", "16",
             "--warmup-steps", "2", "--num-steps", "100000")
HUNG_DEADLINE = 10
# the lease must fire at most this long after the SIGSTOP, and not before
# HUNG_DEADLINE of stall (its clock starts at the last scrape that saw
# the frontier move, just before the stop)
HUNG_FIRES_BY = 25.0
# the pod's command: the CLI's main() as a worker image runs it, then the
# steps the trainer ran and the kernels' launch counts on one line
POD_MAIN = """\
import json, sys
from mpi_operator_tpu_torch.examples import lm_benchmark as bench
from mpi_operator_tpu_torch.ops import attention as ops
steps = []
run = bench.run_vit_benchmark
def counted(**kw):
    state, metrics = run(**kw)
    steps.append(int(state.step))
    return state, metrics
bench.run_vit_benchmark = counted
ops.reset_launch_counts()
rc = bench.main(sys.argv[1:])
print("operator-pod " + json.dumps(
    {"steps": steps, "launches": dict(ops.launch_counts)}), flush=True)
sys.exit(rc)
"""
# kubelet's CrashLoopBackOff starts at 10 s; a pod its set no longer
# wants gets a grace period to exit before it is killed
CRASH_BACKOFF, STOP_GRACE = 10.0, 30.0


@dataclasses.dataclass
class LocalPod:
    name: str
    root: str                      # the pod's private filesystem
    cmd: list
    env: dict
    probe: object = None
    labels: dict = None            # a worker pod's labels (its Pod object)
    proc: object = None
    attempts: int = 0
    exit_codes: list = dataclasses.field(default_factory=list)
    restart_at: float = 0.0
    stop_at: float = None
    ready: bool = False
    probed_at: float = 0.0

    def output(self) -> str:
        with open(os.path.join(self.root, "output.log"), errors="replace") \
                as f:
            return f.read()


class LocalKubelet:
    """The node, for the pods the controller renders (chip_smoke only).

    One process a pod, with the pod's rendered command and env. There is
    no pod DNS here, so a worker gets TPU_WORKER_ID=<ordinal>, and each
    job's coordinator address becomes 127.0.0.1 at a free port beside a
    free TPU_STATUS_PORT. A pod's /tmp is a directory of its own (the
    readiness marker lands there), and its ConfigMap volume is written
    there. A worker sees as many cards as its nvidia.com/gpu limit, the
    first of the cards this run was given (CUDA_VISIBLE_DEVICES, as
    NVIDIA's device plugin sets it); the launcher sees none. The worker's exec readiness probe runs as
    rendered, against the pod's /tmp, and sets the StatefulSet's
    ready_replicas. A worker that exits non-zero restarts after the
    crash-loop backoff while its set still wants it; one its set no
    longer wants is given STOP_GRACE seconds to exit, then killed. The
    launcher's exit code lands in the Job's status (0 succeeded, else
    failed).

    Each worker pod also gets a Pod object in the API (its name and
    labels; its status is not written), so the controller's gang deletes
    reach it: when a worker's Pod object is deleted, its process is
    killed and a fresh one started with a new Pod object, as the
    StatefulSet controller recreates a deleted pod. A worker rendered
    with TPU_METRICS_PORT gets a free port of its own instead (jobs
    share one host here), and `fetch` is the observatory's transport:
    it maps a rendered pod URL (http://<pod>.<service>...:<port>/path)
    to 127.0.0.1 at that pod's port, and logs every /metrics scrape.
    `pause` stops a pod's process with SIGSTOP (a hung worker).
    """

    def __init__(self, api, namespace, root):
        from mpi_operator_tpu_torch.cluster.apiserver import ConflictError
        self.api, self.ns, self.root = api, namespace, root
        self.conflict = ConflictError
        self.pods = {}
        self.ports = {}
        self.metrics_ports = {}  # worker pod -> its TPU_METRICS_PORT
        self.scrapes = []        # (time, pod, the step it reported or None)
        self.stopped_at = {}     # pod -> wall time of its SIGSTOP
        self.log = []            # (time, pod, what)

    def note(self, pod, what):
        self.log.append((time.perf_counter(), pod, what))

    def first(self, pod, what):
        return next((t for t, p, w in self.log if p == pod and w == what),
                    None)

    def _update(self, kind, name, fn):
        for _ in range(10):
            obj = self.api.try_get(kind, self.ns, name)
            if obj is None:
                return None
            fn(obj)
            try:
                return self.api.update(obj)
            except self.conflict:
                continue
        raise RuntimeError(f"chip_smoke: {kind}/{name} kept conflicting")

    @staticmethod
    def _cards(pod, limit):
        """The first `limit` cards of this run's own: the entries of its
        CUDA_VISIBLE_DEVICES where it has one (indices or UUIDs), else the
        indices of every card the run sees."""
        import torch
        mask = os.environ.get("CUDA_VISIBLE_DEVICES")
        cards = ([d.strip() for d in mask.split(",") if d.strip()]
                 if mask is not None
                 else [str(i) for i in range(torch.cuda.device_count())])
        if limit > len(cards):
            raise RuntimeError(
                f"chip_smoke: pod {pod} asks for {limit} card(s) and this "
                f"run sees {len(cards)}")
        return cards[:limit]

    def _pod(self, name, job, template, launcher, ordinal=None):
        from mpi_operator_tpu_torch.api.types import RESOURCE_GPU
        root = os.path.join(self.root, name)
        os.makedirs(root, exist_ok=True)
        c = template.main_container()

        def local(path):
            return (os.path.join(root, "tmp", path[len("/tmp/"):])
                    if path.startswith("/tmp/") else path)
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("TPU_", "MEGASCALE_"))}
        env.update({k: str(v) for k, v in c.env.items()})
        coord, status = self.ports.setdefault(job, (free_port(),
                                                    free_port()))
        env.update(TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{coord}",
                   TPU_STATUS_PORT=str(status),
                   TMPDIR=os.path.join(root, "tmp"))
        if "TPU_READY_FILE" in env:
            env["TPU_READY_FILE"] = local(env["TPU_READY_FILE"])
        for mount in c.volume_mounts:
            vol = next((v for v in template.volumes
                        if v["name"] == mount["name"]), None)
            cm = vol and self.api.try_get("ConfigMap", self.ns,
                                          vol["configMap"])
            if cm is not None:
                mdir = os.path.join(root, "cm", mount["name"])
                os.makedirs(mdir, exist_ok=True)
                for key, value in cm.data.items():
                    with open(os.path.join(mdir, key), "w") as f:
                        f.write(value)
                if env.get("TPU_CONFIG_PATH") == mount["mountPath"]:
                    env["TPU_CONFIG_PATH"] = mdir
        if launcher:
            env["CUDA_VISIBLE_DEVICES"] = ""
        else:
            env["TPU_WORKER_ID"] = str(ordinal)
            env["CUDA_VISIBLE_DEVICES"] = ",".join(
                self._cards(name, int(c.limits.get(RESOURCE_GPU, 0))))
            if "TPU_METRICS_PORT" in env:
                env["TPU_METRICS_PORT"] = str(
                    self.metrics_ports.setdefault(name, free_port()))
        here = os.path.dirname(os.path.abspath(__file__))
        env["PYTHONPATH"] = os.pathsep.join(
            [here] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        cmd = list(c.command) + list(c.args)
        if cmd and cmd[0] == "python":
            cmd[0] = sys.executable
        probe = None
        if c.readiness_probe is not None:
            probe = [" ".join(local(w) for w in a.split(" "))
                     for a in c.readiness_probe["exec"]["command"]]
        labels = (None if launcher else
                  dict(template.metadata.labels))
        return LocalPod(name, root, cmd, env, probe, labels)

    def _pod_object(self, pod):
        """Write the worker's Pod object, fresh (a new uid) each start
        after a delete."""
        from mpi_operator_tpu_torch.api.types import ObjectMeta
        from mpi_operator_tpu_torch.cluster.resources import Pod
        if pod.labels is not None and self.api.try_get(
                "Pod", self.ns, pod.name) is None:
            self.api.create(Pod(metadata=ObjectMeta(
                name=pod.name, namespace=self.ns, labels=dict(pod.labels))))

    def fetch(self, url):
        """The observatory's scrape of a rendered pod URL, sent to the
        pod's own port on this host."""
        import urllib.parse
        import urllib.request
        parts = urllib.parse.urlsplit(url)
        pod = (parts.hostname or "").split(".")[0]
        port = self.metrics_ports.get(pod)
        step = None
        try:
            if port is None:
                raise OSError(f"no metrics port for pod {pod!r}")
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{parts.path}",
                    timeout=2.0) as resp:
                text = resp.read().decode("utf-8", "replace")
            if parts.path == "/metrics":
                m = re.search(r"^tpu_worker_step(?:\{[^}]*\})? (\S+)$",
                              text, re.M)
                step = int(float(m.group(1))) if m else 0
            return text
        finally:
            if parts.path == "/metrics":
                self.scrapes.append((time.perf_counter(), pod, step))

    def pause(self, name):
        pod = self.pods[name]
        os.kill(pod.proc.pid, signal.SIGSTOP)
        self.stopped_at[name] = time.time()     # the controller's clock
        self.note(name, "stopped")

    def _start(self, pod):
        pod.attempts += 1
        pod.ready = False
        # a container starts on a fresh filesystem: no marker survives
        # a restart
        tmp = os.path.join(pod.root, "tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        log_file = open(os.path.join(pod.root, "output.log"), "a")
        pod.proc = subprocess.Popen(pod.cmd, env=pod.env, cwd=pod.root,
                                    stdout=log_file,
                                    stderr=subprocess.STDOUT)
        log_file.close()
        self._pod_object(pod)
        self.note(pod.name, f"start {pod.attempts}")

    def _kill(self, pod):
        if pod.proc is not None and pod.proc.poll() is None:
            pod.proc.kill()
            pod.proc.wait()
            self.note(pod.name, "killed")

    def stop_all(self):
        for pod in self.pods.values():
            self._kill(pod)

    def step(self):
        now = time.perf_counter()
        for pod in self.pods.values():
            code = pod.proc.poll()
            if code is not None and len(pod.exit_codes) < pod.attempts:
                pod.exit_codes.append(code)
                pod.ready = False
                pod.restart_at = now + CRASH_BACKOFF * 2 ** min(
                    pod.attempts - 1, 5)
                self.note(pod.name, f"exit {code}")
        wanted = set()
        for sts in self.api.list("StatefulSet", self.ns):
            job = sts.metadata.labels.get("tpu_job_name")
            for i in range(sts.spec.replicas or 0):
                name = f"{sts.metadata.name}-{i}"
                wanted.add(name)
                pod = self.pods.get(name)
                if pod is None:
                    pod = self.pods[name] = self._pod(
                        name, job, sts.spec.template, False, i)
                    self._start(pod)
                if (pod.proc.poll() is None and self.api.try_get(
                        "Pod", self.ns, name) is None):
                    # the controller deleted the pod: kill what runs and
                    # start it afresh, as its StatefulSet recreates it
                    self._kill(pod)
                    pod.exit_codes.append(pod.proc.returncode)
                    self.note(name, "pod deleted")
                    self._start(pod)
                code = pod.proc.poll()
                if code not in (None, 0) and now >= pod.restart_at:
                    self._start(pod)
                if (pod.proc.poll() is None and pod.probe is not None
                        and now - pod.probed_at >= 0.2):
                    pod.probed_at = now
                    ok = subprocess.run(pod.probe).returncode == 0
                    if ok and not pod.ready:
                        self.note(name, "ready")
                    pod.ready = ok
            ready = sum(self.pods[n].ready for n in wanted
                        if n.startswith(sts.metadata.name + "-"))
            if (sts.status.ready_replicas != ready
                    or sts.status.replicas != sts.spec.replicas):
                def mark(s, ready=ready):
                    s.status.ready_replicas = ready
                    s.status.replicas = s.spec.replicas
                self._update("StatefulSet", sts.metadata.name, mark)
                self.note(sts.metadata.name, f"ready_replicas {ready}")
        for launcher in self.api.list("Job", self.ns):
            name = launcher.metadata.name
            wanted.add(name)
            pod = self.pods.get(name)
            if pod is None:
                pod = self.pods[name] = self._pod(
                    name, launcher.metadata.labels.get("tpu_job_name"),
                    launcher.spec.template, True)
                self._start(pod)

                def active(j):
                    j.status.active = 1
                    j.status.start_time = time.time()
                self._update("Job", name, active)
            if (self.first(name, "polling") is None
                    and "launcher: waiting on rank-0" in pod.output()):
                self.note(name, "polling")
            if pod.exit_codes and not (launcher.status.succeeded
                                       or launcher.status.failed):
                def finished(j, code=pod.exit_codes[0]):
                    j.status.active = 0
                    j.status.succeeded = int(code == 0)
                    j.status.failed = int(code != 0)
                    j.status.completion_time = time.time()
                self._update("Job", name, finished)
        for name, pod in self.pods.items():
            if name in wanted or pod.proc.poll() is not None:
                continue
            if pod.stop_at is None:
                pod.stop_at = now + STOP_GRACE
                self.note(name, "stopping")
            elif now >= pod.stop_at:
                self._kill(pod)


def wait_until(step, pred, what, timeout):
    """Call step() until pred() holds; fail after `timeout` s."""
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        step()
        got = pred()
        if got:
            return got
        time.sleep(0.05)
    raise RuntimeError(f"chip_smoke: [operator] {what} within {timeout} s")


def operator_job(name, args, env=None, restart_policy="Never",
                 deadline=None):
    """One nvidia.com/gpu TPUJob as a user submits it: processingUnits
    1, one a worker, the pod command above; `deadline` sets
    progressDeadlineSeconds (the observatory's progress lease)."""
    from mpi_operator_tpu_torch.api.types import RESOURCE_GPU, new_tpu_job
    job = new_tpu_job(name, processing_units=1, processing_units_per_worker=1,
                      processing_resource_type=RESOURCE_GPU,
                      restart_policy=restart_policy)
    job.spec.progress_deadline_seconds = deadline
    c = job.spec.template.main_container()
    c.image = "tpu-bench-torch:latest"
    c.command = ["python", "-c", POD_MAIN]
    c.args = list(args)
    c.env = dict(env or {})
    return job


def condition(api, name, kind):
    job = api.get("TPUJob", "default", name)
    cond = job.status.get_condition(kind)
    return cond is not None and cond.status == "True"


def timeline(kubelet, t0):
    """Each pod's kubelet events, in seconds from t0."""
    pods = {}
    for t, pod, what in kubelet.log:
        pods.setdefault(pod, []).append(f"{what} @{t - t0:.1f}")
    return pods


def operator_phase():
    """The port's TPUJobController on its GPU defaults over the
    in-memory API server, through the threaded run loop, with
    LocalKubelet as the node and the job observatory on. Three jobs at
    once: a worker that exits non-zero (an unknown --size) must end
    Failed with the launcher mirroring its code; a worker told to expect
    2 cards on a pod that sees one must never become Ready nor get a
    launcher (checked at every kubelet step, until 10 s after its first
    exit); and the job, ViT-B/16 through K1-K3, must reach Succeeded
    with its worker set scaled to 0, the gate held until the marker,
    K1-K3 at 12 x the steps the worker ran, at least 3 scrapes of its
    live worker with the step frontier advancing, no lease restart, and
    a merged timeline the postmortem renders. Then, after it, the hung
    worker: stopped once a scrape shows a step, it must be declared
    stuck and restarted by the lease within HUNG_FIRES_BY of the stop
    and not before HUNG_DEADLINE of stall. Returns the numbers."""
    import threading

    from mpi_operator_tpu_torch import postmortem
    from mpi_operator_tpu_torch.api.types import COND_STUCK, RESOURCE_GPU
    from mpi_operator_tpu_torch.cluster.apiserver import InMemoryAPIServer
    from mpi_operator_tpu_torch.controller import (ControllerConfig,
                                                   TPUJobController)
    from mpi_operator_tpu_torch.telemetry.collector import JobObservatory
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        api = InMemoryAPIServer()
        kubelet = LocalKubelet(api, "default", tmp)
        events_dir = os.path.join(tmp, "events")
        config = ControllerConfig(worker_metrics_port=OPERATOR_METRICS_PORT,
                                  events_dir=events_dir,
                                  scrape_interval=OPERATOR_SCRAPE_S)
        # the controller's own observatory, but for its transport: the
        # pods' DNS names do not resolve here, LocalKubelet maps them
        obs = JobObservatory(events_dir=events_dir,
                             scrape_interval=config.scrape_interval,
                             fetch=kubelet.fetch)
        ctrl = TPUJobController(api, config=config, observatory=obs)
        check(ctrl.config.processing_resource_type == RESOURCE_GPU
              and ctrl.config.processing_units_per_worker == 8,
              f"the operator's defaults are {ctrl.config}")
        stop = threading.Event()
        ctrl.run(threadiness=2, stop_event=stop)
        resynced = [0.0]

        def scraped(pod):
            return [(t, n) for t, p, n in kubelet.scrapes
                    if p == pod and n is not None]

        def step():
            kubelet.step()
            now = time.perf_counter()
            if now - resynced[0] >= OPERATOR_RESYNC_S:
                resynced[0] = now
                for job in api.list("TPUJob", "default"):
                    ctrl.enqueue_tpu_job(job)
            hung = kubelet.pods.get("hung-worker-0")
            if (hung is not None and kubelet.first("hung-worker-0",
                                                   "stopped") is None
                    and hung.proc.poll() is None
                    and any(n > 0 for _, n in scraped("hung-worker-0"))):
                kubelet.pause("hung-worker-0")
            sts = api.try_get("StatefulSet", "default", "op-chips-worker")
            check(api.try_get("Job", "default", "op-chips-launcher") is None
                  and (sts is None or not sts.status.ready_replicas),
                  "op-chips: a worker that sees 1 of 2 cards became Ready "
                  "or got its launcher")
            vit = api.try_get("Job", "default", "vit-launcher")
            check(vit is None or kubelet.first("vit-worker-0", "ready")
                  is not None, "the vit launcher Job existed before the "
                  "worker's readiness marker")
        t0 = time.perf_counter()
        try:
            args = list(OPERATOR_ARGS)
            bad = list(args)
            bad[bad.index("--size") + 1] = "no-such-size"
            api.create(operator_job("vit", args + list(OPERATOR_EVENTS),
                                    deadline=OPERATOR_DEADLINE))
            api.create(operator_job("op-exit", bad))
            api.create(operator_job("op-chips", args,
                                    env={"TPU_EXPECTED_CHIPS": "2"}))
            sts = wait_until(step, lambda: api.try_get(
                "StatefulSet", "default", "vit-worker"), "worker set", 30)
            t_sts = time.perf_counter()
            c = sts.spec.template.main_container()
            selectors = [k for k in sts.spec.template.node_selector
                         if k.startswith("cloud.google.com/gke-tpu-")]
            check(c.limits == {RESOURCE_GPU: 1} and not selectors,
                  f"vit-worker limits {c.limits}, selectors {selectors}")
            check(c.env.get("TPU_READY_FILE") == "/tmp/tpu-ready"
                  and c.env.get("TPU_EXPECTED_CHIPS") == "1"
                  and c.env.get("TPU_METRICS_PORT")
                  == str(OPERATOR_METRICS_PORT)
                  and c.readiness_probe is not None
                  and c.readiness_probe["exec"]["command"][-1]
                  == "test -f /tmp/tpu-ready",
                  f"vit-worker gate: env {c.env}, probe "
                  f"{c.readiness_probe}")
            wait_until(step, lambda: api.try_get(
                "Job", "default", "vit-launcher"),
                "the launcher after Ready", 300)
            t_launcher = time.perf_counter()
            wait_until(step, lambda: condition(api, "vit", "Succeeded"),
                       "the job Succeeded", 300)
            t_done = time.perf_counter()
            # the third planted fault runs after the ViT-B/16 job: a
            # worker that hangs once it has trained a few steps
            api.create(operator_job("hung", HUNG_ARGS,
                                    restart_policy="OnFailure",
                                    deadline=HUNG_DEADLINE))
            t_hung = time.perf_counter()
            wait_until(step, lambda: api.get(
                "StatefulSet", "default", "vit-worker").spec.replicas == 0,
                "workers scaled to 0", 30)
            wait_until(step, lambda: condition(api, "op-exit", "Failed"),
                       "the failing worker's job ended Failed", 300)
            chips = wait_until(
                step, lambda: kubelet.pods.get("op-chips-worker-0")
                if kubelet.pods.get("op-chips-worker-0") is not None
                and kubelet.pods["op-chips-worker-0"].exit_codes else None,
                "the 2-card worker exited", 120)
            held = kubelet.first("op-chips-worker-0", "exit 1")
            wait_until(step, lambda: held is None or
                       time.perf_counter() >= held + 10.0,
                       "10 s after the 2-card worker's exit", 30)
            worker = kubelet.pods["vit-worker-0"]
            wait_until(step, lambda: worker.exit_codes,
                       "the vit worker's exit", STOP_GRACE + 10)
            launcher = kubelet.pods["vit-launcher"]
            text = worker.output()
            check(worker.exit_codes == [0] and launcher.exit_codes == [0],
                  f"vit: worker exits {worker.exit_codes}, launcher "
                  f"{launcher.exit_codes}: {text[-3000:]}\n"
                  f"{launcher.output()[-2000:]}")
            bad_worker = kubelet.pods["op-exit-worker-0"]
            bad_launcher = kubelet.pods["op-exit-launcher"]
            check(bad_worker.exit_codes and 0 not in bad_worker.exit_codes
                  and bad_launcher.exit_codes == [bad_worker.exit_codes[0]]
                  and "no-such-size" in bad_worker.output(),
                  f"op-exit: worker exits {bad_worker.exit_codes}, launcher "
                  f"{bad_launcher.exit_codes}: "
                  f"{bad_worker.output()[-2000:]}")
            check(0 not in chips.exit_codes and
                  "enumerates 1 device(s) but the controller allocated 2"
                  in chips.output(), f"op-chips exits {chips.exit_codes}: "
                  f"{chips.output()[-2000:]}")
            head = [json.loads(line) for line in text.splitlines()
                    if line.startswith('{"metric": "vit_images_per_sec"')]
            report = [json.loads(line.split(" ", 1)[1])
                      for line in text.splitlines()
                      if line.startswith("operator-pod ")]
            check(len(head) == 1 and head[0]["value"] > 0
                  and math.isfinite(head[0]["final_loss"]),
                  f"vit: rank 0's throughput line {head}")
            check(len(report) == 1 and len(report[0]["steps"]) == 1,
                  f"vit: the pod's report {report}")
            steps = report[0]["steps"][0]
            counts = report[0]["launches"]
            want = OPERATOR_LAYERS * steps
            check(all(counts[k] == want for k in FLASH_KERNELS)
                  and all(n == 0 for k, n in counts.items()
                          if k not in FLASH_KERNELS),
                  f"vit: launches {counts} over {steps} steps; K1-K3 "
                  f"expected {want} each, the decode kernels 0")
            # the observatory on the live ViT-B/16 worker
            frontier = [n for _, n in scraped("vit-worker-0")]
            check(len(frontier) >= 3 and frontier == sorted(frontier)
                  and frontier[-1] > frontier[0],
                  f"vit: the observatory's scrapes of the live worker "
                  f"read steps {frontier}: at least 3, advancing")
            vit_job = api.get("TPUJob", "default", "vit")
            check(vit_job.status.restart_count == 0
                  and vit_job.status.get_condition(COND_STUCK) is None,
                  f"vit: the progress lease fired on a live job "
                  f"(restarts {vit_job.status.restart_count}, "
                  f"{vit_job.status.get_condition(COND_STUCK)})")
            records = postmortem.read_timeline(
                os.path.join(events_dir, "vit", "timeline.jsonl"))
            hosts = {r.get("host") for r in records}
            worker_hosts = {h for h in hosts
                            if str(h).startswith("vit-worker-0.")}
            check("controller" in hosts and worker_hosts
                  and not [r for r in records
                           if r["event"] == "gang_stuck"],
                  f"vit: the merged timeline's hosts are {sorted(hosts)}")
            summary = postmortem.summarize(records)
            ledger = summary["ledger"]
            check(math.isfinite(ledger["goodput"])
                  and 0.0 <= ledger["goodput"] <= 1.0,
                  f"vit: the postmortem's goodput ledger {ledger}")
            buf = io.StringIO()
            postmortem.render(summary, buf)
            rendered = buf.getvalue()
            check("goodput" in rendered, "vit: the rendered postmortem "
                  "has no goodput ledger")
            for line in rendered.splitlines():
                log(f"  operator postmortem | {line}")
            # the hung worker: stopped, caught by the lease, restarted
            wait_until(step, lambda: kubelet.first("hung-worker-0",
                                                   "stopped"),
                       "a scrape of the hung worker showing a step", 180)
            t_stop = kubelet.stopped_at["hung-worker-0"]

            def verdict():
                # the StuckGang condition is set with the restart; the
                # restarted gang's first scrape re-arms the lease and
                # retires it (ProgressResumed), so the timeline's
                # gang_stuck record carries the verdict's time
                job = api.get("TPUJob", "default", "hung")
                recs = [r for r in obs.merged_records("hung")
                        if r["event"] == "gang_stuck"]
                restarting = job.status.get_condition("Restarting")
                return (recs if job.status.restart_count >= 1
                        and restarting is not None
                        and restarting.reason == "GangStuck"
                        and job.status.get_condition(COND_STUCK)
                        is not None else None)
            stuck_recs = wait_until(step, verdict, "the lease's verdict on "
                                    "the hung worker",
                                    HUNG_FIRES_BY + 15)
            wait_until(step, lambda: kubelet.first("hung-worker-0",
                                                   "pod deleted"),
                       "the stopped worker killed", 30)
            hung_job = api.get("TPUJob", "default", "hung")
            # the lease runs from the last scrape that saw the frontier
            # move, which comes just before the stop: it must not fire
            # before its deadline, nor later than the window's end
            fired_after = stuck_recs[0]["ts"] - t_stop
            check(len(stuck_recs) == 1
                  and stuck_recs[0]["stall_seconds"] >= HUNG_DEADLINE
                  and fired_after <= HUNG_FIRES_BY
                  and hung_job.status.restart_count == 1,
                  f"hung: the lease fired {fired_after:.1f} s after the "
                  f"stop (at most {HUNG_FIRES_BY} s, stall at least "
                  f"{HUNG_DEADLINE} s): {stuck_recs}, "
                  f"restarts {hung_job.status.restart_count}")
            hung_steps = [n for _, n in scraped("hung-worker-0")]
            ready = kubelet.first("vit-worker-0", "ready")
            started = kubelet.first("vit-worker-0", "start 1")
            polling = kubelet.first("vit-launcher", "polling")
            out = dict(
                images_per_sec=head[0]["value"], steps=steps,
                launches={k: counts[k] for k in FLASH_KERNELS},
                submit_to_worker_set_s=t_sts - t0,
                worker_start_to_ready_s=ready - started,
                ready_to_launcher_s=t_launcher - ready,
                launcher_start_to_polling_s=(
                    None if polling is None else
                    polling - kubelet.first("vit-launcher", "start 1")),
                launcher_to_succeeded_s=t_done - t_launcher,
                job_s=t_done - t0,
                scrapes=len(frontier), first_frontier=frontier[0],
                last_frontier=frontier[-1], timeline_records=len(records),
                timeline_hosts=sorted(hosts), goodput=ledger["goodput"],
                hung=dict(
                    submit_to_stop_s=kubelet.first("hung-worker-0",
                                                   "stopped") - t_hung,
                    steps_seen=hung_steps,
                    stop_to_stuck_s=fired_after,
                    stall_s=stuck_recs[0]["stall_seconds"],
                    restarts=hung_job.status.restart_count,
                    restarting=hung_job.status.get_condition(
                        "Restarting").message),
                phase_s=time.perf_counter() - t0,
                op_exit=dict(worker_exits=bad_worker.exit_codes,
                             launcher_exits=bad_launcher.exit_codes),
                op_chips=dict(worker_exits=chips.exit_codes),
                card=device_line())
            log(f"  operator: scrapes of the live vit worker "
                f"{out['scrapes']}, frontier {out['first_frontier']} -> "
                f"{out['last_frontier']}; timeline {len(records)} records "
                f"from {len(hosts)} hosts; goodput {ledger['goodput']}")
            log(f"  operator: hung worker stopped at step "
                f"{max(hung_steps)}, declared stuck and restarted "
                f"{fired_after:.1f} s after the stop")
            log(f"  operator: {json.dumps(out)}")
        except Exception:
            log(f"  operator timeline: {json.dumps(timeline(kubelet, t0))}")
            raise
        finally:
            kubelet.stop_all()
            stop.set()
            ctrl.queue.shut_down()
            obs.close()
        log(f"  operator timeline: {json.dumps(timeline(kubelet, t0))}")
    return out


# the warp-specialised flash kernels: 384 threads at 168 registers fill
# the register file, which setmaxnreg splits 40/232 between the producer
# and the consumer warpgroups
WS_KERNELS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")
WS_REGISTERS = 168


# ---------------------------------------------------------------------------
# [hfta]: the fused sweep trainer through K1-K3 under torch.func.vmap
# ---------------------------------------------------------------------------

# the reference bench's HFTA leg (bench.py:872-910): gpt2-small, K = 8
# replicas of 8 x 512 each, bf16 over f32 masters, attention flash, one
# window of 10 timed steps after 3 warmup steps, against the solo
# LMTrainer at the same size
HFTA_K, HFTA_BATCH, HFTA_SEQ, HFTA_STEPS, HFTA_WARMUP = 8, 8, 512, 10, 3


def hfta_fold_check(ops, dev):
    """vmap(flash_attention) at K = 4 over [4, 2, 512, 12, 64] bf16,
    causal, with a key mask: the output and dq, dk, dv bit-equal to four
    separate calls; the folded call launches K1 once and K2, K3 once
    each."""
    g = torch.Generator(device=dev).manual_seed(11)
    K, shape = 4, (2, 512, 12, 64)
    q, k, v = (torch.randn((K,) + shape, generator=g, device=dev
                           ).bfloat16().requires_grad_() for _ in range(3))
    mask = (torch.rand((K,) + shape[:2], generator=g, device=dev) > 0.1
            ).float()
    do = torch.randn((K,) + shape, generator=g, device=dev).bfloat16()
    ops.reset_launch_counts()
    out = torch.func.vmap(
        lambda a, b, c, m: ops.flash_attention(a, b, c, True, m))(
        q, k, v, mask)
    out.backward(do)
    torch.cuda.synchronize()
    folded = {n: ops.launch_counts[n] for n in FLASH_KERNELS}
    check(folded == {n: 1 for n in FLASH_KERNELS},
          f"[hfta] vmapped flash launched {folded}, not once each")
    equal = []
    for r in range(K):
        qr, kr, vr = (x[r].detach().clone().requires_grad_()
                      for x in (q, k, v))
        o = ops.flash_attention(qr, kr, vr, True, mask[r])
        o.backward(do[r])
        equal.append(all(torch.equal(a, b) for a, b in (
            (o, out[r]), (qr.grad, q.grad[r]), (kr.grad, k.grad[r]),
            (vr.grad, v.grad[r]))))
    check(all(equal), f"[hfta] folded flash differs from the loop: {equal}")
    log(f"  fold: vmap(flash_attention) at K={K} over {list(shape)} "
        f"bit-equal to {K} calls (out, dq, dk, dv) with one launch each "
        f"of K1-K3")


def hfta_small(layers=2, **kw):
    """gpt2-small's width at `layers` layers, bf16, flash, 4 x 512."""
    from mpi_operator_tpu_torch.models.transformer import lm_config
    from mpi_operator_tpu_torch.train import LMTrainerConfig
    cfg = lm_config("gpt2-small", attention="flash", num_layers=layers,
                    max_len=HFTA_SEQ)
    return cfg, LMTrainerConfig(global_batch_size=4, seq_len=HFTA_SEQ,
                                warmup_steps=2, **kw)


def hfta_exact_checks(dev):
    """At gpt2-small's width, 2 layers: the fused K = 1 step against the
    solo LMTrainer after 3 steps (params, mu, nu bit-equal); K = 4 with
    nan-replica:1@2 against an unpoisoned fused run (replica 1 frozen,
    replicas 0, 2, 3 bit-equal), then the planted fault (the guard's
    per-row select made one select of the whole state) failing it."""
    from mpi_operator_tpu_torch.data import TokenStream
    from mpi_operator_tpu_torch.train import LMTrainer
    from mpi_operator_tpu_torch.train import hfta
    from mpi_operator_tpu_torch.train.resilience import FaultInjector
    cfg, tcfg = hfta_small()
    solo = LMTrainer(cfg, tcfg, device=dev)
    fused = hfta.HFTATrainer(cfg, tcfg, hfta.HFTAHyperparams.sweep(1, tcfg),
                             device=dev)
    s, f = solo.init_state(0), fused.init_state()
    stream = TokenStream(4, HFTA_SEQ, cfg.vocab_size, seed=1, device=dev)
    for _ in range(3):
        t, y = next(stream)
        s, _ = solo.train_step(s, t, y)
        f, _ = fused.train_step(f, t[None], y[None])
    k1 = {n: torch.equal(a, b) for n, (a, b) in (
        ("params", (s.params, f.params[0])), ("mu", (s.opt.mu, f.opt.mu[0])),
        ("nu", (s.opt.nu, f.opt.nu[0])))}
    check(all(k1.values()), f"[hfta] fused K=1 vs LMTrainer after 3 steps: "
          f"{k1}, max |diff| "
          f"{float((s.params - f.params[0]).abs().max())}")
    del solo, fused, s, f

    tcfg = hfta_small(log_every=1)[1]
    tr = hfta.HFTATrainer(cfg, tcfg, hfta.HFTAHyperparams.sweep(
        4, tcfg, seeds=[0, 1, 2, 3]), freeze_after=2, device=dev)

    def run(faults, select=None):
        real = hfta.select_replicas
        if select is not None:
            hfta.select_replicas = select
        try:
            st, m = tr.benchmark(
                tr.init_state(), hfta.FusedTokenStream(
                    tr, 4, HFTA_SEQ, cfg.vocab_size), num_steps=5,
                warmup_steps=1, log=lambda line: None,
                faults=FaultInjector(faults))
        finally:
            hfta.select_replicas = real
        return st, m

    def whole(ok, pairs):
        for old, new in pairs:
            torch.where(ok.all(), new, old, out=old)

    ctrl, _ = run("")
    bad, m = run("nan-replica:1@2")
    iso = [torch.equal(bad.params[k], ctrl.params[k]) for k in (0, 2, 3)]
    check(m["per_replica"]["frozen"] == [False, True, False, False]
          and all(iso), f"[hfta] isolation: frozen "
          f"{m['per_replica']['frozen']}, siblings bit-equal {iso}")
    fault, _ = run("nan-replica:1@2", whole)
    held = [torch.equal(fault.params[k], ctrl.params[k]) for k in (0, 2, 3)]
    check(not any(held), f"[hfta] the whole-state select fault kept the "
          f"siblings bit-equal {held}")
    log(f"  exact: fused K=1 bit-equal to LMTrainer after 3 steps "
        f"(2 layers) {k1}; K=4 nan-replica:1@2 froze "
        f"{m['per_replica']['frozen']}, siblings bit-equal {iso}; the "
        f"whole-state select fault: siblings bit-equal {held} (must fail)")


def hfta_phase(ops, dev):
    """The fused trainer on the card: the folding, exactness and
    isolation checks, then the reference bench's leg (HFTA_*): K = 8
    gpt2-small replicas through HFTATrainer.benchmark with the kernel
    counts zeroed just before and read just after (K1-K3 each once a
    layer a step for all K replicas, not K times), against the solo
    LMTrainer at one replica's size. Returns the leg's launches."""
    from mpi_operator_tpu_torch.data import TokenStream
    from mpi_operator_tpu_torch.models.transformer import lm_config
    from mpi_operator_tpu_torch.train import LMTrainer, LMTrainerConfig
    from mpi_operator_tpu_torch.train import hfta
    hfta_fold_check(ops, dev)
    hfta_exact_checks(dev)
    cfg = lm_config("gpt2-small", attention="flash", max_len=HFTA_SEQ)
    tcfg = LMTrainerConfig(global_batch_size=HFTA_BATCH, seq_len=HFTA_SEQ,
                           log_every=HFTA_STEPS)
    solo = LMTrainer(cfg, tcfg, device=dev)
    _, sm = solo.benchmark(solo.init_state(0), TokenStream(
        HFTA_BATCH, HFTA_SEQ, cfg.vocab_size, seed=1, device=dev),
        num_steps=HFTA_STEPS, warmup_steps=HFTA_WARMUP, log=lambda l: None)
    del solo
    torch.cuda.empty_cache()
    tr = hfta.HFTATrainer(cfg, tcfg, hfta.HFTAHyperparams.sweep(
        HFTA_K, tcfg, learning_rates=[2.5e-4 * (1 + k / 4)
                                      for k in range(HFTA_K)],
        seeds=list(range(HFTA_K))), device=dev)
    state = tr.init_state()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    state, m = tr.benchmark(state, hfta.FusedTokenStream(
        tr, HFTA_BATCH, HFTA_SEQ, cfg.vocab_size), num_steps=HFTA_STEPS,
        warmup_steps=HFTA_WARMUP, log=lambda line: log(f"  {line}"))
    torch.cuda.synchronize()
    counts = dict(ops.launch_counts)
    steps, layers = state.step, cfg.num_layers
    check(all(counts[n] == layers * steps for n in FLASH_KERNELS),
          f"[hfta] K1-K3 launches {counts} over {steps} fused steps of "
          f"{layers} layers; expected {layers * steps} each (K={HFTA_K} "
          f"replicas folded into each launch)")
    check(all(n == 0 for k, n in counts.items() if k not in FLASH_KERNELS),
          f"[hfta] other kernels launched: {counts}")
    check(all(math.isfinite(x) for x in m["final_loss"])
          and m["frozen_replicas"] == 0,
          f"[hfta] losses {m['final_loss']}, frozen {m['frozen_replicas']}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    speedup = m["tokens_per_sec"] / sm["tokens_per_sec"]
    log(f"  leg: gpt2-small K={HFTA_K} x {HFTA_BATCH} x {HFTA_SEQ}, "
        f"{HFTA_STEPS} timed steps: aggregate {m['tokens_per_sec']:.0f} "
        f"tokens/s, solo {sm['tokens_per_sec']:.0f} tokens/s, "
        f"fused_speedup {speedup:.3f}, per-replica MFU "
        f"{m['per_replica']['mfu'][0]}, solo MFU {sm['mfu']}, peak "
        f"{peak:.2f} GiB; K1-K3 {counts['flash_fwd']} launches each = "
        f"{layers} a step x {steps} steps, not {layers * HFTA_K} a step; "
        f"final losses {[round(x, 4) for x in m['final_loss']]} "
        f"({device_line()})")
    del state, tr
    gc.collect()
    torch.cuda.empty_cache()
    return {n: counts[n] for n in FLASH_KERNELS}


def decode_types(args):
    """The compute and cache dtypes at the head of a mangled decode
    kernel's template arguments (bf16 is a named type, f32 `f`, int8
    `a`; a repeat of bf16 is a substitution `S..._`); [] for the flash
    kernels, whose only argument is an int."""
    if not args.startswith("I") or args.startswith("ILi"):
        return []
    rest, out = args[1:], []
    for _ in range(2):
        if rest.startswith("13__nv_bfloat16"):
            out.append("bf16")
            rest = rest[len("13__nv_bfloat16"):]
        elif rest[:1] in ("f", "a"):
            out.append("f32" if rest[0] == "f" else "int8")
            rest = rest[1:]
        elif rest.startswith("S"):
            out.append(out[-1] if out else "?")
            rest = rest[rest.index("_") + 1:]
    return out


def ptxas_report(log_text):
    """[(kernel, "N registers, M bytes smem, spill stores/loads")] from
    `nvcc -Xptxas -v` output: each entry function's name (demangled down
    to the kernel and its template arguments) and what ptxas used."""
    out, kernel, spills = [], None, ""
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            for name in ("flash_fwd_kernel", "flash_dq_kernel",
                         "flash_dkv_kernel", "wgmma_probe_kernel",
                         "decode_attention_kernel"):
                if name in mangled:
                    args = mangled.split(name, 1)[1]
                    kernel = name + "<" + ",".join(
                        decode_types(args) + re.findall(r"Li(\d+)E", args)
                        + [t for t in ("Contiguous", "Paged")
                           if f"{t}Rows" in args]) + ">"
                    break
            else:
                kernel = mangled[:60]
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and kernel:
            used = line.split("Used", 1)[1].strip()
            out.append((kernel, f"{used}; {spills}"))
            kernel = None
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from mpi_operator_tpu_torch.models import create_lm
    from mpi_operator_tpu_torch.ops import _build
    from mpi_operator_tpu_torch.ops import attention as ops
    from mpi_operator_tpu_torch.serve import EngineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    log(f"[device] {device_line()}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.build(["decode_attention", "flash_attention"])
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        seen = set()
        for kernel, report in ptxas_report(text):
            log(f"[build] {name}: {kernel}: {report}")
            base = kernel.split("<")[0]
            if base in WS_KERNELS:
                seen.add(base)
                check(report.startswith(f"{WS_REGISTERS} registers")
                      and "0 bytes spill stores, 0 bytes spill loads"
                      in report, f"{kernel}: ptxas reports {report}; the "
                      f"40/232 setmaxnreg split needs {WS_REGISTERS} "
                      f"registers and no spills")
        check(name != "flash_attention" or seen == set(WS_KERNELS),
              f"ptxas reported {sorted(seen)} of {WS_KERNELS}")

    t0 = time.perf_counter()
    log("[kernel] K4 decode_attention vs decode_attention_ref")
    err, row = kernel_phase(ops, dev)
    log(f"[kernel] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[kernel] K5 paged_decode_attention vs paged_decode_attention_ref "
        "and vs K4 on the gathered cache")
    err5, row5 = paged_kernel_phase(ops, dev)
    log(f"[kernel] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[kernel] K1-K3 flash_fwd / flash_dq / flash_dkv vs their plain "
        "versions")
    flash_err, flash_rows = flash_kernel_phase(ops, dev)
    log(f"[kernel] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[serve] gpt2-medium, bf16, decode_kernel=True, contiguous")
    gpt2 = create_lm("gpt2-medium", seed=0, dtype=torch.bfloat16,
                     decode_kernel=True)
    launches = serve_phase(
        "gpt2-medium", gpt2, make_trace(gpt2.config.vocab_size, 24, seed=0),
        ops, EngineConfig(slots=8, chunk_buckets=(32, 128)),
        "decode_attention", profile_requests=8)
    del gpt2
    torch.cuda.empty_cache()
    log(f"[serve] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[llama] llama-1b (2 layers), bf16, int8 KV, decode_kernel=True")
    llama = create_lm("llama-1b", seed=1, dtype=torch.bfloat16,
                      num_layers=2, kv_cache_dtype="int8",
                      decode_kernel=True)
    serve_phase("llama-1b-2l-int8", llama,
                make_trace(llama.config.vocab_size, 12, seed=1), ops,
                EngineConfig(slots=8, chunk_buckets=(32, 128)),
                "decode_attention")
    del llama
    torch.cuda.empty_cache()
    log(f"[llama] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[paged] gpt2-medium, bf16, decode_kernel=True, paged, page_size "
        "64, 128-token shared prefix")
    gpt2 = create_lm("gpt2-medium", seed=0, dtype=torch.bfloat16,
                     decode_kernel=True, max_len=384)
    trace = make_paged_trace(gpt2.config.vocab_size, 32, 2, 128,
                             (32, 64, 128), (32, 64))
    paged = EngineConfig(slots=8, chunk_buckets=(32, 128), paged=True,
                         page_size=64)
    launches5 = serve_phase(
        "gpt2-medium-paged", gpt2, trace, ops, paged,
        "paged_decode_attention", profile_requests=8, shared_len=128)
    contiguous = EngineConfig(slots=8, chunk_buckets=(32, 128))
    ab_runs(gpt2, trace, [("contiguous", contiguous), ("paged", paged),
                          ("paged", paged), ("contiguous", contiguous)])
    del gpt2
    torch.cuda.empty_cache()
    log(f"[paged] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[paged-llama] llama-1b (2 layers), bf16, int8 KV, paged, "
        "page_size 16, 32-token shared prefix")
    llama = create_lm("llama-1b", seed=1, dtype=torch.bfloat16,
                      num_layers=2, kv_cache_dtype="int8",
                      decode_kernel=True, max_len=80)
    serve_phase("llama-1b-2l-int8-paged", llama,
                make_paged_trace(llama.config.vocab_size, 12, 3, 32,
                                 (16, 32), (8, 16)),
                ops, EngineConfig(slots=4, chunk_buckets=(16, 64),
                                  paged=True, page_size=16),
                "paged_decode_attention", shared_len=32)
    del llama
    torch.cuda.empty_cache()
    log(f"[paged-llama] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[bench] run_serving_benchmark: the serving and serving_paged legs "
        "at full size, CUDA graphs on and off")
    bench_phase()
    log(f"[bench] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[spec] run_serving_benchmark: the serving_spec leg at full size "
        "(ngram drafts, draft_k 4), paged and contiguous, against no-spec")
    spec_phase(ops)
    log(f"[spec] {time.perf_counter() - t0:.1f} s")

    fleet = {}
    for leg, what in (
            ("disagg", "run_disagg_benchmark: gpt2-medium, bf16, K5, a "
             "PrefillEngine and a DecodeEngine bridged by the paged-KV "
             "handoff, against the colocated paged engine"),
            ("router", "run_router_benchmark: 2 gpt2-medium replicas "
             "behind the prefix-affinity router, affinity on and off, one "
             "engine at the same offered rate, an overload burst, the "
             "single-engine oracle"),
            ("livescale", "run_livescale_benchmark: a live +1/-1 replica "
             "cycle against a gang restart, the single-engine oracle")):
        t0 = time.perf_counter()
        log(f"[{leg}] {what}")
        fleet[leg], _ = fleet_phase(leg, ops)
        if leg == "disagg":
            handoff_timing(dev)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[{leg}] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[train] gpt2-medium, bf16 over f32 masters, attention=flash, "
        "batch 16 x 512, AdamW with warmup")
    state, train_metrics, train_counts = train_phase(
        "gpt2-medium-train", ops, workload="gpt2", size="medium",
        batch_per_device=16, seq_len=512, num_steps=30, warmup_steps=3,
        attention="flash")
    mcfg = state.model.config
    del state
    torch.cuda.empty_cache()
    from mpi_operator_tpu_torch.train import LMTrainerConfig
    trainer, tstate, batch = grads_agree(
        LMTrainerConfig(global_batch_size=16, seq_len=512), mcfg, dev)
    profile_train(trainer, tstate, batch, train_metrics["step_time_p50_ms"])
    del trainer, tstate, batch
    torch.cuda.empty_cache()
    log(f"[train] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[train-llama] llama-1b (2 layers), bf16, attention=flash, batch "
        "8 x 512")
    train_phase("llama-1b-2l-train", ops, workload="llama", size="1b",
                batch_per_device=8, seq_len=512, num_layers=2, num_steps=10,
                warmup_steps=2, attention="flash")
    log(f"[train-llama] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[train-bert] bert-large, bf16 over f32 masters, attention=flash "
        "(non-causal), batch 16 x 512, MLM rate 0.15")
    train_bert_phase(ops, dev)
    log(f"[train-bert] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[train-moe] gpt2-small, 8 experts, top-2, capacity factor 1.25, "
        "MoE every 2nd block, batch 16 x 512; then 4 layers dropless")
    train_moe_phase(ops, dev)
    log(f"[train-moe] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[train-remat] gpt2-medium, batch 16 x 512, remat off / none / "
        "dots from one seed and one stream")
    train_remat_phase(ops)
    log(f"[train-remat] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[hfta] HFTATrainer: gpt2-small, K={HFTA_K} replicas of "
        f"{HFTA_BATCH} x {HFTA_SEQ}, bf16 over f32 masters, attention=flash, "
        f"{HFTA_STEPS} timed steps, against the solo LMTrainer; the folded "
        f"flash, K=1 and isolation checks at 2 layers")
    hfta_counts = hfta_phase(ops, dev)
    log(f"[hfta] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[generate] run_generate_benchmark: gpt2-medium and llama-1b, "
        "batch 8, prompt 128, 16 new tokens, bf16 and int8 KV, "
        "decode_kernel=True")
    generate_phase(ops)
    log(f"[generate] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[train-resnet] run_benchmark: ResNet-101 (conv7 stem) and "
        "ResNet-50 (s2d stem), bf16 over f32 params, 256 x 224^2, SGD "
        "with momentum")
    train_resnet_phase(ops)
    log(f"[train-resnet] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[train-vit] run_vit_benchmark: ViT-B/16, bf16, 256 x 224^2 "
        "(S = 197 through K1-K3); flash against dense gradients on a "
        "2-layer cut")
    vit_counts = train_vit_phase(ops, dev)
    log(f"[train-vit] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[train-ddp] 2 ranks on the card over gloo through launch.py and "
        "the bootstrap, then 1 rank over NCCL, against one process: "
        "ResNet-50 (s2d, 64 px, f32) and a 2-layer ViT-B/16 (bf16); then "
        "the planted per-rank-BN fault")
    with cudnn_heuristics():
        train_ddp_phase(dev)
    log(f"[train-ddp] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[train-lm-ddp] gpt2-medium as a gang of one over NCCL; 2 gloo "
        "ranks on the card against one process (gpt2, bert, MoE at 2 "
        "layers, the planted faults); 2 slices x 2 ranks (gpt2, "
        "ResNet-50); allreduce_bench alone")
    with cudnn_heuristics():
        gang_counts = train_lm_ddp_phase(ops, dev, train_metrics)
    log(f"[train-lm-ddp] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[train-lm-gang] one gang of 4 gloo ranks on the card runs the "
        "legs of [train-lm-mp] and [train-lm-pp], and restore_resharded: "
        "gpt2-medium at (dp, fsdp, tp) = (1, 2, 2) restored at (1, 4, 1), "
        "at fsdp 2 on 2 ranks and as one replica, then the wrong-offset "
        "fault")
    lm_gang = lm_gang_phase()
    log(f"[train-lm-gang] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[train-lm-mp] the gang's legs: gpt2-medium at (dp, fsdp, tp) = "
        "(1, 2, 2) in bf16 through K1-K3; f32 parity at (1, 2, 2), (2, 2, "
        "1), tp_overlap uni and bidir, MoE at (dp, ep) = (2, 2); ring "
        "attention through K1-K3 at sp 2 and 4 and a trainer at (dp, sp, "
        "tp) = (1, 2, 2); the planted faults")
    mp_counts, ring_counts = train_lm_mp_phase(ops, dev, train_metrics,
                                               lm_gang)
    log(f"[train-lm-mp] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[train-lm-pp] the gang's legs: gpt2-medium at pp = 4, M = 16, "
        "bf16 through K1-K3 under GPipe and 1F1B x 2; f32 parity at (pp, "
        "dp) = (2, 2), (pp, tp) = (2, 2) 1F1B x 2, bert-large's width, 8 "
        "experts at (pp, ep) = (2, 2); the planted faults")
    pp_counts = train_lm_pp_phase(ops, dev, lm_gang)
    del lm_gang
    log(f"[train-lm-pp] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log(f"[train-resume] gpt2-medium, bf16, attention=flash, 16 x 512: "
        f"uninterrupted to step {RESUME_T} twice, SIGTERM at step "
        f"{RESUME_KILL}, resume; the CLI pair at 2 layers")
    train_resume_phase(ops)
    log(f"[train-resume] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("[operator] the port's TPUJobController in GPU mode over the "
        "in-memory API server, a local kubelet as the node, the job "
        "observatory scraping the workers: an nvidia.com/gpu job "
        "(processingUnits 1) whose worker trains ViT-B/16 through K1-K3, "
        "beside two planted faults, then a hung worker for the progress "
        "lease")
    operator = operator_phase()
    log(f"[operator] images/s {operator['images_per_sec']}, scrapes "
        f"{operator['scrapes']}, frontier {operator['first_frontier']} -> "
        f"{operator['last_frontier']}, timeline "
        f"{operator['timeline_records']} records, goodput "
        f"{operator['goodput']}, hung worker stuck "
        f"{operator['hung']['stop_to_stuck_s']:.1f} s after its stop, "
        f"{time.perf_counter() - t0:.1f} s ({device_line()})")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")

    source = "mpi_operator_tpu_torch/ops/csrc/decode_attention.cu"
    flash_source = "mpi_operator_tpu_torch/ops/csrc/flash_attention.cu"
    flash_lines = {"flash_fwd": 137, "flash_dq": 305, "flash_dkv": 344}
    print(json.dumps({"kernels": [
        dict(name="decode_attention", route="cuda", source=source,
             replaces="mpi_operator_tpu/ops/attention.py:621",
             launches=launches, max_abs_err=err, **row),
        dict(name="paged_decode_attention", route="cuda", source=source,
             replaces="mpi_operator_tpu/ops/attention.py:724",
             launches=launches5, max_abs_err=err5, **row5, **fleet)] + [
        dict(name=name, route="cuda", source=flash_source,
             replaces=f"mpi_operator_tpu/ops/attention.py:{line}",
             launches=train_counts[name], max_abs_err=flash_err[name],
             **flash_rows["gpt2-medium"][name],
             vit_b16=dict(launches=vit_counts[name],
                          **flash_rows["vit-b16"][name]),
             lm_gang_of_one=dict(launches=gang_counts[name]),
             lm_mp=dict(launches=mp_counts[name], ranks=LM_MP_RANKS,
                        ring_causal_launches={
                            leg: [c[name] for c in counts]
                            for leg, counts in ring_counts.items()}),
             lm_pp={sched: [c[name] for c in ranks]
                    for sched, ranks in pp_counts.items()},
             operator=dict(launches=operator["launches"][name]),
             hfta=dict(k=HFTA_K, launches=hfta_counts[name]))
        for name, line in flash_lines.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
