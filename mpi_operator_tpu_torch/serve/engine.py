"""Continuous-batching serving engine over the decode fast path (PyTorch).

The counterpart of `mpi_operator_tpu/serve/engine.py` in its colocated
modes: the contiguous slot cache and the paged cache with prefix
caching. `generate()` (models/generate.py) is the fixed-batch oracle;
this engine serves the same model the way a front end needs it served:

- **Slots.** The KV cache is ONE fixed [SLOTS, KV, L, D] buffer per layer;
  each row is an independent request at its own depth, driven by
  per-row cursors the host owns (slots.py). Finishing a request frees
  its row at once; the next queued request moves in.
- **One decode step for all slots.** Every step advances ALL slots one
  token — cursors, input tokens and per-slot sampling params are plain
  tensors — and runs each layer's attention through the CUDA decode
  kernel (ops/attention.py) when `decode_kernel` is on.
- **Chunked prefill.** Prompts prefill in windows bucketed to <= 3 sizes
  (scheduler.plan_chunks), one chunk per loop iteration, interleaved
  with decode steps — a long prompt cannot stall in-flight decodes.
- **Double-buffered decode.** A step's input tokens chain ON THE DEVICE:
  a decoding row's next input is the previous step's output for its
  slot (`torch.where(use_prev, prev_tok, host_toks)`), so the host never
  reads a token to dispatch the next step. `run()` dispatches step N+1
  BEFORE syncing step N: the step's tokens and logprobs are copied
  without blocking into pinned host buffers (two, used in turn) behind
  a CUDA event, and the sync waits on that event only. Length-finished
  rows free at DISPATCH (deterministic host state); only EOS, which the
  host sees at the sync, costs one discarded junk step.
  `EngineConfig.async_decode=False` drains every step before the next
  dispatch — token-identical at temperature 0.
- **In-place cache.** Prefill chunks and decode steps write the cache
  in place (the reference donates the cache buffers to its jitted
  programs for the same effect: one live copy of the largest
  allocation).
- **Paged KV + prefix caching** (`EngineConfig.paged`). The per-layer
  cache becomes a POOL of `page_size`-position pages ([num_pages, KV,
  page_size, D], models/transformer.py PagedKVCache) and each slot
  carries a page table (page 0 is the trash page that free rows and
  unallocated blocks point at). Admission reserves a request's whole
  worst-case page span up front (slots.PageAllocator via
  Scheduler.admit), so decode never allocates mid-flight. Fully
  prefilled PROMPT pages are published into a refcounted prefix cache
  keyed by chained token windows: a request sharing a system prompt pins
  those pages and starts prefill at the first page it does not share
  (copy-on-write at page granularity). Prefill is BATCHED: every waiting
  slot whose next chunk has the same bucket advances in one [S, C] call.
  Decode steps read the cache through K5 (paged decode attention) with
  `decode_kernel`. Each step's page table is a fresh host array, staged
  with the step's other inputs, so a table the host rebuilds can never
  change under a step still in flight.
- **Compiled programs** (serve/programs.py). The decode step (one
  program per sampling mode) and prefill (one per chunk bucket) run as
  CUDA graphs on the card, replayed over static device buffers: a step
  is one host-to-device copy of its packed inputs from pinned memory
  and one graph launch. `compile_counts()` holds the reference's
  no-recompile contract over them; `EngineConfig.cuda_graphs=False`
  runs the same programs eagerly, as the CPU always does.

Not here (later slices of the port): speculative decoding and the
telemetry / event-log / tracer hooks (with the paged mode's page
gauges).

Parity: at temperature 0 a request produces token-for-token the output
of `generate()` — pinned against the port's generate() and the JAX
engine in tests/test_torch_serve.py.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.generate import _categorical, cast_params, decode_model
from ..models.transformer import CausalLM, head_logits
from ..telemetry import span
from ..utils.device import resolve_device
from .programs import Program, Staging
from .scheduler import Request, RequestState, Scheduler
from .slots import PageAllocator, SlotManager


@dataclasses.dataclass
class EngineConfig:
    """Serving knobs, as the reference's. `slots` is the decode batch
    (rows in the cache); `chunk_buckets` the <= 3 prefill widths;
    `decode_kernel` None inherits the model config; `async_decode`
    dispatches step N+1 before syncing step N; `admit_lookahead` bounds
    the admission scan past a head-of-queue that does not fit;
    `request_timeout` (seconds, None = off) retires a request that
    outlives its deadline with finish_reason "timeout". `speculative`
    raises until its slice of the port lands (its draft knobs come with
    it). `cuda_graphs` False runs the engine's programs eagerly on the
    card (the same programs, bit for bit; the CPU never captures).

    `paged` switches the cache to the page pool: `page_size` positions
    a page (must divide max_len; any size >= 1 runs K5), `num_pages`
    physical pages including the trash page (None sizes the pool to the
    contiguous layout's bytes: slots * max_len // page_size + 1),
    `prefix_cache` publishes fully prefilled prompt pages for sharing
    across requests (False keeps pure paging)."""
    slots: int = 8
    chunk_buckets: Tuple[int, ...] = (32, 128, 512)
    decode_kernel: Optional[bool] = None
    rng_seed: int = 0
    async_decode: bool = True
    paged: bool = False
    page_size: int = 64
    num_pages: Optional[int] = None
    prefix_cache: bool = True
    admit_lookahead: int = 8
    request_timeout: Optional[float] = None
    speculative: Optional[str] = None
    cuda_graphs: bool = True


@dataclasses.dataclass
class RequestResult:
    id: int
    tokens: List[int]                 # new tokens only (no prompt)
    logprobs: List[float]
    finish_reason: str                # "eos" | "length" | "timeout"
    ttft: float                       # arrival -> first new token, seconds
    #                                   (-1.0 when the request timed out
    #                                   before its first token)
    token_times: List[float]          # absolute (run-relative) per token
    cached_tokens: int = 0            # prompt span served from the prefix
    #                                   cache (paged mode; 0 = cold)
    admitted_at: float = 0.0          # run-relative admission time


#: bounded-mode candidate pool: exact for any request with an active
#: top_k <= this (the nucleus then lives inside the kept top-k set)
SAMPLE_POOL = 128


def sample_slots(logits: torch.Tensor, generator: Optional[torch.Generator],
                 temperature: torch.Tensor, top_k: torch.Tensor,
                 top_p: torch.Tensor, mode: str = "full",
                 gumbel: Optional[torch.Tensor] = None):
    """[B, V] logits + per-row [B] sampling params -> ([B] token, [B]
    logprob of the choice under the UNfiltered distribution).

    The reference's three variants, chosen by the host:
      "greedy"  — every active row is temperature 0: argmax only;
      "bounded" — every sampling row has 1 <= top_k <= SAMPLE_POOL: the
                  candidate pool is the top SAMPLE_POOL scores, exact for
                  both filters;
      "full"    — anything else: the pool is the whole vocab, sorted.
    Temperature-0 rows pick argmax in every mode. The top-k threshold
    reads off the sorted pool; the nucleus cutoff is taken in the LOGIT
    domain (pool entries are exact copies of `scaled` entries, so the
    comparison is exact — no 1-ulp softmax drift strands the boundary
    token). `gumbel` injects the sampling noise (tests)."""
    logits = logits.float()
    V = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    greedy_tok = torch.argmax(logits, dim=-1)
    if mode == "greedy":
        return greedy_tok, logp.gather(-1, greedy_tok[:, None])[:, 0]
    if mode not in ("bounded", "full"):
        raise ValueError(f"mode={mode!r}: expected greedy, bounded or full")
    W = V if mode == "full" else min(SAMPLE_POOL, V)
    scaled = logp / torch.clamp(temperature, min=1e-6)[:, None]
    pool = torch.topk(scaled, W, dim=-1, sorted=True).values  # descending
    # top-k: mask below the k-th largest; k <= 0 disables (keeps the pool)
    k = torch.where(top_k <= 0, W, torch.clamp(top_k, 1, W)).long()
    kth = pool.gather(-1, (k - 1)[:, None])
    scaled = torch.where(scaled < kth, -torch.inf, scaled)
    cols = torch.arange(W, device=logits.device)[None, :]
    pool_masked = torch.where(cols < k[:, None], pool, -torch.inf)
    sorted_p = torch.softmax(pool_masked, dim=-1)
    cum = torch.cumsum(sorted_p, dim=-1)
    cutoff_idx = torch.clamp((cum < top_p[:, None]).sum(-1), max=W - 1)
    cutoff = pool_masked.gather(-1, cutoff_idx[:, None])
    scaled = torch.where(scaled < cutoff, -torch.inf, scaled)
    sampled = _categorical(scaled, generator, gumbel)
    tok = torch.where(temperature <= 0.0, greedy_tok, sampled)
    return tok, logp.gather(-1, tok[:, None])[:, 0]


class ServingEngine:
    """Continuous-batching inference over a CausalLM.

    Usage:
        engine = ServingEngine(model, EngineConfig(slots=8))
        results = engine.run([Request(0, prompt_ids, max_new_tokens=64)])

    Runs on the CUDA card unless `device="cpu"`; the model must already
    live on that device. `run` drives the admit -> prefill-chunk ->
    decode-step loop to completion; `start`/`submit`/`tick`/`finish` are
    the same loop one iteration at a time."""

    def __init__(self, model: CausalLM, config: Optional[EngineConfig] = None,
                 device=None, telemetry=None, events=None, tracer=None):
        cfg = config or EngineConfig()
        for name, hook in (("telemetry", telemetry), ("events", events),
                           ("tracer", tracer)):
            if hook is not None:
                raise NotImplementedError(
                    f"{name}= is not ported yet: the engine's telemetry, "
                    f"event-log and tracer hooks come with a later slice "
                    f"of the PyTorch port")
        if cfg.speculative is not None:
            raise NotImplementedError(
                "speculative decoding comes with a later slice of the "
                "PyTorch port")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, the engine "
                             f"was asked to run on {self.device}")
        mcfg = model.config
        if not mcfg.causal:
            raise ValueError("serving needs a causal LM")
        for b in cfg.chunk_buckets:
            if b > mcfg.max_len:
                raise ValueError(f"chunk bucket {b} exceeds "
                                 f"max_len={mcfg.max_len}")
        self.config = cfg
        self.model_config = mcfg
        # params cast once, device-resident across every step
        self.dmodel = cast_params(decode_model(model, cfg.decode_kernel),
                                  mcfg.dtype)
        self._casts = 1
        self._table = self.dmodel.wte.weight
        S = cfg.slots
        self.scheduler = Scheduler(cfg.chunk_buckets, mcfg.max_len,
                                   admit_lookahead=cfg.admit_lookahead)
        self.slots = SlotManager(S)
        self.page_allocator: Optional[PageAllocator] = None
        if cfg.paged:
            ps = cfg.page_size
            if ps < 1 or mcfg.max_len % ps:
                raise ValueError(f"page_size={ps} must be >= 1 and divide "
                                 f"max_len={mcfg.max_len}")
            NP = cfg.num_pages
            if NP is None:
                # the contiguous layout's bytes, plus the trash page
                NP = S * (mcfg.max_len // ps) + 1
            self.page_allocator = PageAllocator(NP, ps)
            self._nblk = mcfg.max_len // ps
            self.cache = self.dmodel.new_paged_cache(NP, ps)
        else:
            self.cache = self.dmodel.new_cache(S)
        self._cache_builds = 1
        # the device-side token chain: every step program, of every mode,
        # reads it at its start and writes its sampled tokens into it
        self._prev_tok = torch.zeros(S, dtype=torch.int64, device=self.device)
        self._out_logp = torch.zeros(S, dtype=torch.float32,
                                     device=self.device)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(cfg.rng_seed)
        self._capture = cfg.cuda_graphs and self.device.type == "cuda"
        self._pool = torch.cuda.graph_pool_handle() if self._capture else None
        self._stream = (torch.cuda.Stream(self.device) if self._capture
                        else None)
        self._programs: Dict[Tuple, Program] = {}
        self._staging = Staging(self.device)
        # two host buffer pairs, used in turn: step N's copy lands in one
        # while step N-1's is still waiting to be read from the other
        pin = self.device.type == "cuda"
        self._host_bufs = [
            (torch.zeros(S, dtype=torch.int64, pin_memory=pin),
             torch.zeros(S, dtype=torch.float32, pin_memory=pin))
            for _ in range(2)]
        self._buf_i = 0
        self._steps_dispatched = 0
        self._session: Optional[Dict] = None
        # high-water marks over a run: paged mode sustains more slots
        # than contiguous at equal cache bytes exactly when
        # pages_in_use_peak stays under the pool while occupancy_peak
        # exceeds the contiguous slot count
        self.occupancy_peak = 0
        self.pages_in_use_peak = 0

    # -- bookkeeping ------------------------------------------------------

    def reset(self) -> None:
        """Clear all serving state (queue, slots, cache contents, page
        allocator and prefix cache) and rewind the sampling generator, so
        a reset engine replays a trace with identical tokens, sampled
        draws included."""
        self._sync_device()
        self.scheduler = Scheduler(self.config.chunk_buckets,
                                   self.model_config.max_len,
                                   admit_lookahead=self.config
                                   .admit_lookahead)
        self.slots = SlotManager(self.config.slots)
        if self.page_allocator is not None:
            # cached prefix pages index into the cache zeroed below, so
            # the prefix cache goes with it
            self.page_allocator.reset()
        self.cache.zero_()
        self._prev_tok.zero_()
        self._out_logp.zero_()
        self._generator.manual_seed(self.config.rng_seed)
        self._steps_dispatched = 0
        self._session = None
        self.occupancy_peak = 0
        self.pages_in_use_peak = 0

    def compile_counts(self) -> Dict[str, int]:
        """Programs built, keyed as the reference's executable caches:
        the contract is `step <= 3` (one program per sample_slots mode),
        `prefill <= len(chunk_buckets)` (one per bucket) whatever trace
        ran, and no growth across reset(); `verify` stays 0 until
        speculative decoding is ported; the cache and the cast params
        are built once (`init_cache`, `cast`)."""
        kinds = [key[0] for key in self._programs]
        return {"step": kinds.count("step"),
                "prefill": kinds.count("prefill"), "verify": 0,
                "init_cache": self._cache_builds, "cast": self._casts}

    def capture_counts(self) -> Dict[str, int]:
        """CUDA graphs captured, by program kind: equal to
        compile_counts()' on the card with cuda_graphs on, 0 otherwise."""
        kinds = [key[0] for key, p in self._programs.items()
                 if p.graph is not None]
        return {"step": kinds.count("step"),
                "prefill": kinds.count("prefill")}

    @property
    def cuda_graphs(self) -> bool:
        """True when the programs run as CUDA graphs (on the card, with
        EngineConfig.cuda_graphs on)."""
        return self._capture

    @property
    def steps_dispatched(self) -> int:
        """Decode steps dispatched since construction/reset()."""
        return self._steps_dispatched

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- device work: the programs ----------------------------------------

    def _program(self, kind: str, arg) -> Program:
        """The program ("step", mode) or ("prefill", bucket), built at
        its first use and kept for the engine's life."""
        key = (kind, self.config.paged, arg)
        prog = self._programs.get(key)
        if prog is not None:
            return prog
        S, i32, f32 = self.config.slots, np.int32, np.float32
        table = ([("pages", (S, self._nblk), i32)] if self.config.paged
                 else [])
        if kind == "step":
            layout = [("toks", (S,), i32), ("use_prev", (S,), i32),
                      ("pos", (S,), i32), ("top_ks", (S,), i32),
                      ("temps", (S,), f32), ("top_ps", (S,), f32)] + table
            fn = functools.partial(self._step, arg)
        elif self.config.paged:
            layout = [("tokens", (S, arg), i32), ("starts", (S,), i32)] \
                + table
            fn = self._prefill_paged_program
        else:
            layout = [("tokens", (1, arg), i32), ("slot", (1,), i32),
                      ("start", (1,), i32)]
            fn = self._prefill_program
        sampled = kind == "step" and arg != "greedy"
        prog = Program(key, fn, layout, self.device, self._capture,
                       self._pool, self._stream,
                       self._generator if sampled else None)
        self._programs[key] = prog
        return prog

    def _prefill_program(self, x) -> None:
        """One chunk for one slot: the slot's cache row sliced out, the
        backbone over [1, C] tokens at positions start..start+C, the row
        spliced back (the reference's dynamic slice and update, so one
        program serves every slot); the hidden state is discarded."""
        slot = x["slot"].long()
        tokens = x["tokens"].long()
        positions = (x["start"].long()[:, None]
                     + torch.arange(tokens.shape[1], device=self.device))
        row = self.cache.take_rows(slot)
        self.dmodel.forward_device(tokens, positions, row)
        self.cache.put_rows(slot, row)

    def _prefill_paged_program(self, x) -> None:
        """One paged chunk for every slot row: [S, C] tokens at positions
        starts[b]..starts[b]+C, written into the pool through the [S,
        nblk] page tables; the hidden state is discarded."""
        tokens = x["tokens"].long()
        positions = (x["starts"].long()[:, None]
                     + torch.arange(tokens.shape[1], device=self.device))
        self.dmodel.forward_device(tokens, positions, self.cache,
                                   x["pages"])

    def _step(self, mode: str, x) -> None:
        """ONE token for ALL slots: [S] tokens at [S] cursors (through
        the [S, nblk] page tables in paged mode). A row's input is the
        previous step's device output (use_prev) or the host token (the
        bonus token after prefill). The sampled tokens go into the chain
        `_prev_tok`, their logprobs into `_out_logp`."""
        tokens = torch.where(x["use_prev"].bool(), self._prev_tok,
                             x["toks"].long())
        h = self.dmodel.forward_device(tokens[:, None],
                                       x["pos"].long()[:, None], self.cache,
                                       x.get("pages"))
        logits = head_logits(h[:, 0], self._table, self.model_config.dtype)
        tok, logp = sample_slots(logits, self._generator, x["temps"],
                                 x["top_ks"], x["top_ps"], mode=mode)
        self._prev_tok.copy_(tok)
        self._out_logp.copy_(logp)

    def _prefill(self, slot: int, window: List[int], start: int) -> None:
        """Run the contiguous prefill program of this window's bucket.
        Its multi-token cache write takes no drop branch, so the window
        must end inside the cache; plan_chunks' windows always do in
        contiguous mode (start 0: they end at the prompt or at the first
        bucket)."""
        end = start + len(window)
        if end > self.model_config.max_len:
            raise RuntimeError(f"prefill window [{start}, {end}) ends past "
                               f"max_len={self.model_config.max_len}")
        prog = self._program("prefill", len(window))
        self._staging.upload(prog, {"tokens": window, "slot": [slot],
                                    "start": [start]})
        prog()

    def _prefill_batched(self, toks: np.ndarray, starts: np.ndarray,
                         pages: np.ndarray) -> None:
        """Run the paged prefill program of this bucket over every slot
        row ([S, C] tokens, [S] starts, [S, nblk] page tables)."""
        prog = self._program("prefill", toks.shape[1])
        self._staging.upload(prog, {"tokens": toks, "starts": starts,
                                    "pages": pages})
        prog()

    # -- the loop ---------------------------------------------------------

    def _run_prefill_chunk(self, st: RequestState) -> None:
        w, size = st.chunks.pop(0)
        p1 = len(st.req.prompt) - 1
        window = list(st.req.prompt[w:min(w + size, p1)])
        window += [0] * (size - len(window))     # right-pad short prompts
        with span("serve.prefill"):
            self._prefill(st.slot, window, w)
        st.pos = min(p1, w + size)

    def _page_table_array(self) -> np.ndarray:
        """[S, nblk] physical-page tables for every slot row, built anew
        for each call; free rows are all trash-page entries (their
        masked writes sink there)."""
        pt = np.zeros((self.config.slots, self._nblk), np.int32)
        for st in self.slots.states:
            if st is not None:
                pt[st.slot] = st.page_table
        return pt

    def _run_prefill_batched(self, lead: RequestState) -> None:
        """Paged prefill: advance EVERY waiting slot whose next chunk
        has the lead's bucket in one [S, C] call. Bound non-member rows
        run zero tokens at their own cursor: their junk K/V lands where
        their next real write (chunk or decode step) overwrites it, in
        their own private pages (a row never writes below its cursor,
        and its shared prefix pages all lie below it); free rows write
        into the trash page."""
        size = lead.chunks[0][1]
        batch = [st for st in self.scheduler.active
                 if st.prefilling and st.chunks[0][1] == size]
        toks = np.zeros((self.config.slots, size), np.int64)
        starts = np.zeros((self.config.slots,), np.int64)
        for st in self.slots.states:
            if st is not None:
                starts[st.slot] = st.pos
        done = []
        for st in batch:
            w, _ = st.chunks.pop(0)
            p1 = len(st.req.prompt) - 1
            window = list(st.req.prompt[w:min(w + size, p1)])
            toks[st.slot, :len(window)] = window
            starts[st.slot] = w
            done.append((st, w, p1))
        with span("serve.prefill"):
            self._prefill_batched(toks, starts, self._page_table_array())
        for st, w, p1 in done:
            st.pos = max(st.pos, min(p1, w + size))
            if self.config.prefix_cache:
                self._publish_prompt_pages(st)

    def _publish_prompt_pages(self, st: RequestState) -> None:
        """Register this request's newly COMPLETED prompt pages in the
        prefix cache (chained keys, slots.PageAllocator.publish). Only
        full pages of prompt positions [0, P-1) are ever published — the
        partial tail page also holds decode tokens and stays private.
        A False from publish() means another request registered the
        identical prefix first; this copy stays private, and publishing
        stops (descendants would chain off a page nothing can reach
        through the cache)."""
        alloc = self.page_allocator
        ps = alloc.page_size
        full = (len(st.req.prompt) - 1) // ps
        while (st.published_pages < full
               and (st.published_pages + 1) * ps <= st.pos):
            k = st.published_pages
            page = st.page_table[k]
            if not alloc.publish(page, st.publish_parent,
                                 st.req.prompt[k * ps:(k + 1) * ps]):
                st.published_pages = full
                break
            st.published_pages = k + 1
            st.publish_parent = page

    def _dispatch_decode_step(self):
        """Build the step arrays and dispatch ONE decode step without
        waiting for its result. Returns the pending sync handle (host
        buffers + event, the consumers at dispatch time, dispatch time),
        or None when no state consumes a step. Cursors and dispatch
        counts advance HERE — they are deterministic, so the host's view
        stays exact while the tokens are in flight."""
        toks, pos, use_prev, temps, top_ks, top_ps, consumers = \
            self.slots.step_arrays()
        if not consumers:
            return None
        sampling = [st.req for st in consumers if st.req.temperature > 0.0]
        if not sampling:
            mode = "greedy"
        elif all(1 <= r.top_k <= SAMPLE_POOL for r in sampling):
            mode = "bounded"
        else:
            mode = "full"
        self._steps_dispatched += 1
        step_t0 = time.perf_counter()
        inputs = dict(toks=toks, use_prev=use_prev, pos=pos, top_ks=top_ks,
                      temps=temps, top_ps=top_ps)
        if self.config.paged:
            inputs["pages"] = self._page_table_array()
        prog = self._program("step", mode)
        with span("serve.decode_step"):
            self._staging.upload(prog, inputs)
            prog()
            buf_tok, buf_lp = self._host_bufs[self._buf_i]
            self._buf_i ^= 1
            buf_tok.copy_(self._prev_tok, non_blocking=True)
            buf_lp.copy_(self._out_logp, non_blocking=True)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
        for st in consumers:
            st.pos += 1                          # the step wrote at pos
            st.dispatched += 1
            st.host_next = False
            if st.dispatched >= st.req.max_new_tokens:
                # length exhaustion is known NOW: free the row so the
                # next iteration admits into it. A new occupant's prefill
                # is enqueued after this step, so its writes land on top
                # of (never under) this request's K/V.
                self.slots.release(st)
                st.slot_released = True
        return buf_tok, buf_lp, event, consumers, step_t0

    def _sync_decode_step(self, pending, now_fn, on_token=None) \
            -> List[RequestState]:
        """Host-sync a dispatched step: wait for its event (the only
        blocking device wait in the loop), stream its tokens, mark
        EOS/length retirements. A consumer already done at sync time took
        its one post-EOS junk step; its junk token is discarded here."""
        buf_tok, buf_lp, event, consumers, _ = pending
        if event is not None:
            event.synchronize()
        out_tok = buf_tok.numpy().copy()
        out_logp = buf_lp.numpy().copy()
        now = now_fn()
        finished = []
        for st in consumers:
            if st.done:
                continue
            t = int(out_tok[st.slot])
            st.next_input = t
            st.generated.append(t)
            st.logprobs.append(float(out_logp[st.slot]))
            st.token_times.append(now)
            if on_token is not None:
                on_token(st.req, t)
            if st.req.eos_id is not None and t == st.req.eos_id:
                st.finish_reason = "eos"
            elif len(st.generated) >= st.req.max_new_tokens:
                st.finish_reason = "length"
            if st.done:
                finished.append(st)
        return finished

    def _note_admissions(self, admitted: List[RequestState]) -> None:
        timeout = self.config.request_timeout
        for st in admitted:
            if timeout is not None:
                st.deadline = st.admitted_at + timeout
            self.slots.bind(st)

    def _retire_state(self, st: RequestState,
                      results: Dict[int, RequestResult]) -> None:
        self.scheduler.retire(st)
        if not st.slot_released:          # EOS path: freed here; the
            self.slots.release(st)        # length path freed its row
            st.slot_released = True       # at dispatch already
        if self.page_allocator is not None:
            # drop every reference this request held, shared prefix
            # pages and private pages alike; its PUBLISHED pages park in
            # the evictable LRU where later lookups still find them. A
            # step still in flight may write this row's pages, but any
            # new owner's writes are enqueued after it on the stream.
            for p in st.owned_pages:
                self.page_allocator.release(p)
            st.owned_pages = []
        results[st.req.id] = RequestResult(
            id=st.req.id, tokens=list(st.generated),
            logprobs=list(st.logprobs),
            finish_reason=st.finish_reason,
            ttft=(st.token_times[0] - st.req.arrival
                  if st.token_times else -1.0),
            token_times=list(st.token_times),
            cached_tokens=st.cached_tokens,
            admitted_at=st.admitted_at)

    def _sweep_timeouts(self, now: float,
                        results: Dict[int, RequestResult]) -> None:
        """Retire every resident state past its deadline with
        finish_reason "timeout", through the normal retire path. Marking
        it done also makes an in-flight step's sync skip it."""
        if self.config.request_timeout is None:
            return
        for st in list(self.scheduler.active):
            if st.done or st.deadline is None or now < st.deadline:
                continue
            st.finish_reason = "timeout"
            st.chunks = []
            self._retire_state(st, results)

    # -- steppable session ------------------------------------------------

    def start(self, on_token: Optional[Callable[[Request, int], None]]
              = None, now_fn: Optional[Callable[[], float]] = None) -> None:
        """Open a streaming session: submit() feeds requests in, tick()
        advances the loop one iteration, finish() closes it and returns
        the results. `now_fn` is the session clock (seconds); None
        starts a private clock at 0."""
        if self._session is not None:
            raise RuntimeError("session already open (call finish())")
        if now_fn is None:
            t0 = time.perf_counter()
            now_fn = lambda: time.perf_counter() - t0   # noqa: E731
        self._session = {"results": {}, "pending": None,
                         "on_token": on_token, "now_fn": now_fn}

    def submit(self, req: Request) -> None:
        """Queue one request into the open session; raises ValueError for
        a span the engine can never hold (prompt + new > max_len, or more
        KV pages than the whole pool)."""
        if self._session is None:
            raise RuntimeError("submit() outside a session (call start())")
        alloc = self.page_allocator
        if alloc is not None:
            need = Scheduler.pages_needed(req, alloc.page_size)
            if need > alloc.usable:
                # it would sit at the head of the queue forever
                raise ValueError(
                    f"request {req.id}: worst-case span needs {need} KV "
                    f"pages but the pool has {alloc.usable} usable "
                    f"(raise num_pages or lower max_new_tokens)")
        self.scheduler.submit(req)

    @property
    def active(self) -> bool:
        """True while the open session still has work in flight."""
        return (self._session is not None
                and not (self.scheduler.idle
                         and self._session["pending"] is None))

    def tick(self) -> bool:
        """One iteration of the admit -> prefill -> decode loop. Returns
        False when there was nothing to do this instant (idle, or every
        queued arrival is in the future) without sleeping."""
        sess = self._session
        if sess is None:
            raise RuntimeError("tick() outside a session (call start())")
        if not self.active:
            return False
        now_fn = sess["now_fn"]
        on_token = sess["on_token"]
        results = sess["results"]

        def retire(finished: List[RequestState]) -> None:
            for st in finished:
                self._retire_state(st, results)

        now = now_fn()
        self._sweep_timeouts(now, results)
        alloc = self.page_allocator
        with span("serve.schedule"):
            self._note_admissions(self.scheduler.admit(
                self.slots.free, now, allocator=alloc))
        self.occupancy_peak = max(self.occupancy_peak, self.slots.occupied)
        if alloc is not None:
            self.pages_in_use_peak = max(self.pages_in_use_peak,
                                         alloc.in_use)
        pending = sess["pending"]
        if self.slots.occupied == 0 and pending is None:
            nxt = self.scheduler.next_arrival()
            if nxt is not None and nxt > now_fn():
                return False
        st = self.scheduler.next_prefill()
        if st is not None:
            if self.config.paged:
                self._run_prefill_batched(st)
            else:
                self._run_prefill_chunk(st)
        new_pending = (self._dispatch_decode_step()
                       if self.scheduler.decoding() else None)
        if pending is not None:
            retire(self._sync_decode_step(pending, now_fn, on_token))
            pending = None
        if self.config.async_decode:
            pending = new_pending
        elif new_pending is not None:
            retire(self._sync_decode_step(new_pending, now_fn, on_token))
        sess["pending"] = pending
        return True

    def finish(self) -> Dict[int, RequestResult]:
        """Close the session and return {request.id: RequestResult}."""
        sess = self._session
        if sess is None:
            raise RuntimeError("finish() outside a session")
        self._session = None
        return sess["results"]

    def run(self, requests: Sequence[Request] = (),
            on_token: Optional[Callable[[Request, int], None]] = None,
            ) -> Dict[int, RequestResult]:
        """Drive the engine until every submitted request completes.
        `on_token(request, token)` streams tokens as they are fetched.
        Returns {request.id: RequestResult}."""
        self.start(on_token)
        try:
            for r in requests:
                self.submit(r)
            while self.active:
                if not self.tick():
                    nxt = self.scheduler.next_arrival()
                    now = self._session["now_fn"]()
                    if nxt is not None and nxt > now:
                        time.sleep(min(nxt - now, 0.05))
        except BaseException:
            self._session = None
            raise
        return self.finish()


__all__ = ["EngineConfig", "RequestResult", "SAMPLE_POOL", "ServingEngine",
           "sample_slots"]
