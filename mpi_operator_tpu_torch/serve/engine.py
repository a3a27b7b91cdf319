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
- **Speculative decoding** (`EngineConfig.speculative`). A host-side
  drafter proposes up to `draft_k` tokens a greedy row ("ngram":
  prompt lookup in the request's own history, `propose_ngram`;
  "draft": any callable handed to the engine), and ONE verify program
  scores every row's [next input, drafts...] at consecutive cursors,
  bucketed to <= 2 widths (`_verify_buckets`). Greedy acceptance keeps
  the longest draft prefix equal to the previous column's argmax, then
  the model's own next token: speculation changes when tokens are
  computed, never which. The rejected tail is a cursor rewind
  (SlotManager.rewind). A row's padded columns sit at max_len: paged,
  their writes go to trash page 0; contiguous, to the cache's trash row
  (models/transformer.py). The verify step attends through the dense
  multi-token path, as the reference's does (its kernel gate is one
  token a call); the plain steps between verify steps keep K4/K5.
- **Hooks.** `telemetry=` (a telemetry.ServeTelemetry: TTFT, TPOT,
  prefill, decode step and host-gap histograms, queue, slot and page
  gauges, prefix and speculation counters), `events=` (a
  telemetry.EventLog: slot_admit, slot_retire, request_timeout) and
  `tracer=` (a telemetry.Tracer: per-request hop chains admission ->
  prefill -> decode and a session span holding the decode and verify
  step spans), all host bookkeeping: no program changes with them, and
  tokens and program counts are the same with them on or off.
  `set_heartbeat` installs a rate-limited load reporter.
- **Disaggregated serving** (`DisaggEngine`). A `PrefillEngine` (prompt
  pages reserved, prefill programs only) and a `DecodeEngine` (decode
  programs only) with a paged-KV handoff between them
  (serve/transfer.py), on one card or two; the reference's
  disaggregated facade, token for token the colocated paged engine.

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
from ..models.transformer import CausalLM, build_lm, head_logits
from ..telemetry import events as ev
from ..telemetry import span
from ..utils.device import resolve_device
from .programs import Program, Staging
from .scheduler import Request, RequestState, Scheduler
from .slots import PageAllocator, SlotManager
from .transfer import PageTransfer


@dataclasses.dataclass
class EngineConfig:
    """Serving knobs, as the reference's. `slots` is the decode batch
    (rows in the cache); `chunk_buckets` the <= 3 prefill widths;
    `decode_kernel` None inherits the model config; `async_decode`
    dispatches step N+1 before syncing step N; `admit_lookahead` bounds
    the admission scan past a head-of-queue that does not fit;
    `request_timeout` (seconds, None = off) retires a request that
    outlives its deadline with finish_reason "timeout". `speculative`
    (None = off) turns on multi-token verify: "ngram" self-drafts by
    prompt lookup (`spec_ngram` caps the match length), "draft" calls
    the engine's `drafter`; `draft_k` caps the tokens proposed a row a
    verify step, and the verify program runs at <= 2 widths from {2,
    draft_k + 1}. Sampling rows never draft; they ride along in column
    0. `cuda_graphs` False runs the engine's programs eagerly on the
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
    speculative: Optional[str] = None     # None | "ngram" | "draft"
    draft_k: int = 4
    spec_ngram: int = 3
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


def propose_ngram(history: Sequence[int], k: int,
                  max_n: int = 3) -> List[int]:
    """Prompt-lookup self-drafting: up to `k` tokens copied from what
    followed the most recent EARLIER occurrence of the longest suffix
    n-gram (n = max_n down to 1) of `history`; [] when nothing matches.
    Wrong proposals cost a verify column, never a token."""
    L = len(history)
    out: List[int] = []
    if k < 1 or L < 2:
        return out
    for n in range(min(max_n, L - 1), 0, -1):
        pat = list(history[L - n:])
        # right to left: the latest occurrence predicts a repeating tail
        for s in range(L - n - 1, -1, -1):
            if list(history[s:s + n]) == pat:
                out = [int(t) for t in history[s + n:s + n + k]]
                break
        if out:
            break
    return out


class ServingEngine:
    """Continuous-batching inference over a CausalLM.

    Usage:
        engine = ServingEngine(model, EngineConfig(slots=8))
        results = engine.run([Request(0, prompt_ids, max_new_tokens=64)])

    Runs on the CUDA card unless `device="cpu"`; the model must already
    live on that device. `run` drives the admit -> prefill-chunk ->
    decode-step loop to completion; `start`/`submit`/`tick`/`finish` are
    the same loop one iteration at a time."""

    #: the hop a request's trace enters when its prompt finishes
    #: prefilling (telemetry/trace.py taxonomy)
    POST_PREFILL_HOP = "serve.decode"

    #: the page span admission reserves (Scheduler reserve=): the whole
    #: request here; the prompt only in a disaggregated prefill pool
    RESERVE = "full"

    def __init__(self, model: CausalLM, config: Optional[EngineConfig] = None,
                 device=None, telemetry=None, events=None, drafter=None,
                 tracer=None):
        """telemetry: a telemetry.ServeTelemetry; events: a
        telemetry.EventLog; tracer: a telemetry.Tracer (see the module
        docstring; each None costs nothing). drafter: the
        speculative="draft" proposal hook, callable(history, k) -> up to
        k tokens (history = prompt + generated so far); correctness never
        depends on what it returns."""
        cfg = config or EngineConfig()
        if cfg.speculative not in (None, "ngram", "draft"):
            raise ValueError(f"speculative={cfg.speculative!r}: expected "
                             f"None, 'ngram' or 'draft'")
        if cfg.speculative is not None and cfg.draft_k < 1:
            raise ValueError(f"draft_k={cfg.draft_k}: speculation needs "
                             f"at least one proposed token")
        if cfg.speculative == "draft" and drafter is None:
            raise ValueError("speculative='draft' needs a drafter "
                             "callable (history, k) -> tokens")
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
        self._drafter = drafter
        # <= 2 verify widths: a narrow one for single-token proposals and
        # the full draft_k + 1 (compile_counts pins this)
        self._verify_buckets = tuple(sorted({min(2, cfg.draft_k + 1),
                                             cfg.draft_k + 1}))
        self.config = cfg
        self.model_config = mcfg
        self.telemetry = telemetry
        self.events = events
        self.tracer = tracer
        # the session clock trace hops are stamped on, set while a
        # session is open (tracing is inert without it)
        self._trace_now: Optional[Callable[[], float]] = None
        self._session_span = None
        # params cast once, device-resident across every step
        self.dmodel = cast_params(decode_model(model, cfg.decode_kernel),
                                  mcfg.dtype)
        self._casts = 1
        self._table = self.dmodel.wte.weight
        S = cfg.slots
        self.scheduler = Scheduler(cfg.chunk_buckets, mcfg.max_len,
                                   admit_lookahead=cfg.admit_lookahead,
                                   reserve=self.RESERVE)
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
            # one row more than the slots: the trash row that a verify
            # step's padded columns write into (models/transformer.py)
            self.cache = self.dmodel.new_cache(S, trash_row=True)
        self._cache_builds = 1
        if telemetry is not None:
            telemetry.slots.set(S)
            if cfg.paged:
                telemetry.pages_total.set(self.page_allocator.usable)
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
        # each verify width's static outputs (targets int64, logprobs
        # f32, [S, W]) and their pinned host copies, made with its first
        # program
        self._verify_bufs: Dict[int, Tuple[torch.Tensor, ...]] = {}
        self._steps_dispatched = 0
        self._session: Optional[Dict] = None
        # push-based load reporting (set_heartbeat): (hook, interval)
        self._heartbeat = None
        self._heartbeat_last: Optional[float] = None
        # high-water marks over a run: paged mode sustains more slots
        # than contiguous at equal cache bytes exactly when
        # pages_in_use_peak stays under the pool while occupancy_peak
        # exceeds the contiguous slot count
        self.occupancy_peak = 0
        self.pages_in_use_peak = 0
        self._reset_spec_counters()

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
                                   .admit_lookahead, reserve=self.RESERVE)
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
        self._session_span = None
        self._trace_now = None
        self.occupancy_peak = 0
        self.pages_in_use_peak = 0
        self._reset_spec_counters()

    def _reset_spec_counters(self) -> None:
        # speculation run counters (spec_stats() derives the rates)
        self.spec_proposed = 0       # draft tokens sent to verify
        self.spec_accepted = 0       # draft tokens that matched argmax
        self.spec_steps = 0          # verify steps run
        self.spec_rows = 0           # consumer rows across verify steps
        self.spec_tokens = 0         # tokens emitted by verify steps

    def compile_counts(self) -> Dict[str, int]:
        """Programs built, keyed as the reference's executable caches:
        the contract is `step <= 3` (one program per sample_slots mode),
        `prefill <= len(chunk_buckets)` (one per bucket) and `verify <=
        len(_verify_buckets)` per sampling mode whatever trace ran, and
        no growth across reset(); the cache and the cast params are
        built once (`init_cache`, `cast`)."""
        kinds = [key[0] for key in self._programs]
        return {"step": kinds.count("step"),
                "prefill": kinds.count("prefill"),
                "verify": kinds.count("verify"),
                "init_cache": self._cache_builds, "cast": self._casts}

    def capture_counts(self) -> Dict[str, int]:
        """CUDA graphs captured, by program kind: equal to
        compile_counts()' on the card with cuda_graphs on, 0 otherwise."""
        kinds = [key[0] for key, p in self._programs.items()
                 if p.graph is not None]
        return {k: kinds.count(k) for k in ("step", "prefill", "verify")}

    def spec_stats(self) -> Dict[str, float]:
        """Speculation accounting since construction/reset().
        effective_tokens_per_step is tokens emitted PER ROW per verify
        step: 1.0 means drafts never helped, > 1.0 is sequential
        forwards saved."""
        return {
            "proposed": self.spec_proposed,
            "accepted": self.spec_accepted,
            "verify_steps": self.spec_steps,
            "spec_tokens": self.spec_tokens,
            "acceptance_rate": (self.spec_accepted / self.spec_proposed
                                if self.spec_proposed else 0.0),
            "effective_tokens_per_step": (self.spec_tokens / self.spec_rows
                                          if self.spec_rows else 0.0),
        }

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

    # -- tracing ----------------------------------------------------------

    def _trace(self, rid: int):
        """The open RequestTrace of request `rid`, or None (no tracer,
        id sampled out, or no session clock)."""
        if self.tracer is None or self._trace_now is None:
            return None
        return self.tracer.active(rid)

    def trace_abandon(self, now: float) -> None:
        """The engine is dropped mid-session: close its session span so
        the batch spans already recorded keep a parent."""
        if self._session_span is not None:
            self._session_span.abandon(now)
            self._session_span = None
        self._trace_now = None

    # -- device work: the programs ----------------------------------------

    def _program(self, kind: str, arg) -> Program:
        """The program ("step", mode), ("prefill", bucket) or ("verify",
        (mode, width)), built at its first use and kept for the engine's
        life."""
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
        elif kind == "verify":
            mode, W = arg
            layout = [("toks", (S, W), i32), ("pos", (S, W), i32),
                      ("top_ks", (S,), i32), ("temps", (S,), f32),
                      ("top_ps", (S,), f32)] + table
            if W not in self._verify_bufs:
                pin = self.device.type == "cuda"
                self._verify_bufs[W] = (
                    torch.zeros((S, W), dtype=torch.int64,
                                device=self.device),
                    torch.zeros((S, W), dtype=torch.float32,
                                device=self.device),
                    torch.zeros((S, W), dtype=torch.int64, pin_memory=pin),
                    torch.zeros((S, W), dtype=torch.float32,
                                pin_memory=pin))
            fn = functools.partial(self._verify, mode, W)
        elif self.config.paged:
            layout = [("tokens", (S, arg), i32), ("starts", (S,), i32)] \
                + table
            fn = self._prefill_paged_program
        else:
            layout = [("tokens", (1, arg), i32), ("slot", (1,), i32),
                      ("start", (1,), i32)]
            fn = self._prefill_program
        sampled = ((kind == "step" and arg != "greedy")
                   or (kind == "verify" and arg[0] != "greedy"))
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

    def _verify(self, mode: str, W: int, x) -> None:
        """ONE pass over [S, W] tokens at explicit [S, W] cursors (through
        the page tables in paged mode): column 0 is each row's real next
        input, columns 1.. its drafts, padded columns sit at max_len and
        write into the trash row or page. Every column's K/V is written
        before attention reads it and each query attends to positions <=
        its own, so a rejected tail never reaches an accepted position.
        One tied-head GEMM over S * W rows; column 0 through sample_slots
        (a sampled row draws as in a plain step), columns 1.. through an
        f32 argmax and log_softmax, the reduction sample_slots' greedy
        branch runs, which token exactness rests on. Targets and
        logprobs go into this width's static [S, W] buffers."""
        h = self.dmodel.forward_device(x["toks"].long(), x["pos"].long(),
                                       self.cache, x.get("pages"))
        Sv, Wv, E = h.shape
        logits = head_logits(h.reshape(Sv * Wv, E), self._table,
                             self.model_config.dtype).reshape(Sv, Wv, -1)
        tok0, lp0 = sample_slots(logits[:, 0], self._generator, x["temps"],
                                 x["top_ks"], x["top_ps"], mode=mode)
        f32 = logits.float()
        greedy = torch.argmax(f32, dim=-1)
        glp = torch.log_softmax(f32, dim=-1).gather(
            -1, greedy[..., None])[..., 0]
        targets, logprobs = self._verify_bufs[W][:2]
        targets.copy_(greedy)
        targets[:, 0].copy_(tok0)
        logprobs.copy_(glp)
        logprobs[:, 0].copy_(lp0)

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
        t0 = time.perf_counter()
        with span("serve.prefill"):
            self._prefill(st.slot, window, w)
        if self.telemetry is not None:
            # the host's dispatch time: the next step's sync absorbs the
            # device work still queued
            self.telemetry.prefill_seconds.observe(time.perf_counter() - t0)
        st.pos = min(p1, w + size)
        if not st.chunks:
            rt = self._trace(st.req.id)
            if rt is not None:
                rt.begin_hop(self.POST_PREFILL_HOP, self._trace_now())

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
        t0 = time.perf_counter()
        with span("serve.prefill"):
            self._prefill_batched(toks, starts, self._page_table_array())
        if self.telemetry is not None:
            self.telemetry.prefill_seconds.observe(time.perf_counter() - t0)
        for st, w, p1 in done:
            st.pos = max(st.pos, min(p1, w + size))
            if not st.chunks:
                rt = self._trace(st.req.id)
                if rt is not None:
                    rt.begin_hop(self.POST_PREFILL_HOP, self._trace_now())
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

    def _launch(self, name: str, prog: Program, inputs: Dict,
                copies) -> Optional["torch.cuda.Event"]:
        """Stage `inputs`, run `prog`, queue the copies of its outputs
        into pinned host buffers (`copies`: (host, device) pairs) and
        return the event behind them (None on the CPU, where they are
        done)."""
        with span(name):
            self._staging.upload(prog, inputs)
            prog()
            for host, dev in copies:
                host.copy_(dev, non_blocking=True)
            if self.device.type != "cuda":
                return None
            # on this engine's card, which need not be the current one
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            return event

    def _wait(self, event, step_t0: float, *host: torch.Tensor):
        """The loop's one blocking device wait: block on `event`, read
        the `host` buffers (copies, as the buffers are reused), and feed
        the telemetry how long the host was blocked and the step's
        dispatch-to-sync time (in async mode it spans the iteration
        hidden under the step). Returns the arrays and the sync time."""
        gap_t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        arrays = [h.numpy().copy() for h in host]
        t_sync = time.perf_counter()
        tel = self.telemetry
        if tel is not None:
            tel.host_gap_seconds.observe(t_sync - gap_t0)
            tel.decode_step_seconds.observe(t_sync - step_t0)
        return (*arrays, t_sync)

    @staticmethod
    def _mode(consumers: List[RequestState]) -> str:
        """The cheapest sample_slots mode the consuming rows allow."""
        sampling = [st.req for st in consumers if st.req.temperature > 0.0]
        if not sampling:
            return "greedy"
        if all(1 <= r.top_k <= SAMPLE_POOL for r in sampling):
            return "bounded"
        return "full"

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
        mode = self._mode(consumers)
        self._steps_dispatched += 1
        step_t0 = time.perf_counter()
        inputs = dict(toks=toks, use_prev=use_prev, pos=pos, top_ks=top_ks,
                      temps=temps, top_ps=top_ps)
        if self.config.paged:
            inputs["pages"] = self._page_table_array()
        buf_tok, buf_lp = self._host_bufs[self._buf_i]
        self._buf_i ^= 1
        event = self._launch("serve.decode_step", self._program("step", mode),
                             inputs, ((buf_tok, self._prev_tok),
                                      (buf_lp, self._out_logp)))
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

    def _plan_drafts(self) -> Dict[int, List[int]]:
        """{slot: draft tokens} for every row that can speculate this
        step: decoding, temperature 0 (a sampled row's next token is a
        draw, so there is nothing to verify), and >= 2 tokens of budget
        left. Drafts are clamped to the budget, so a verify step's writes
        stay inside the span the scheduler reserved, and cut at the first
        id outside the vocabulary. The caller has synced any step in
        flight: drafting reads the request's whole host history."""
        cfg = self.config
        planned: Dict[int, List[int]] = {}
        vocab = self.model_config.vocab_size
        for st in self.slots.states:
            if st is None or st.prefilling or st.done:
                continue
            if st.req.temperature > 0.0:
                continue
            budget = st.req.max_new_tokens - st.dispatched - 1
            if budget < 1:
                continue
            k = min(cfg.draft_k, budget)
            hist = list(st.req.prompt) + st.generated
            if cfg.speculative == "ngram":
                raw = propose_ngram(hist, k, cfg.spec_ngram)
            else:
                raw = self._drafter(hist, k)
            draft: List[int] = []
            for t in raw[:k]:
                t = int(t)
                if not 0 <= t < vocab:
                    break          # a garbage id: keep the prefix
                draft.append(t)
            if draft:
                planned[st.slot] = draft
        return planned

    @staticmethod
    def _accepted(draft: Sequence[int], targets: np.ndarray) -> int:
        """Greedy acceptance: how many leading draft tokens equal the
        verify step's targets (draft[j] is checked against the target of
        the column before it, targets[j])."""
        n = 0
        while n < len(draft) and draft[n] == int(targets[n]):
            n += 1
        return n

    def _spec_step(self, planned: Dict[int, List[int]], now_fn,
                   on_token=None) -> List[RequestState]:
        """Run ONE verify step over every decoding row and sync it:
        drafting rows carry [next_input, drafts...] at consecutive
        cursors, the other rows ride along in column 0, padded columns
        sit at max_len. Greedy acceptance a row: the longest draft prefix
        equal to the previous column's target, then the model's own next
        token (every verify step emits >= 1 token a row), cut at an EOS.
        The cursor advances over every written column and the rejected
        tail is rewound (pure host bookkeeping: the dead K/V lies past
        the cursor and the next write overwrites it). Synchronous:
        acceptance decides the next step's inputs; host_next makes the
        next plain step read the host token, not the device chain."""
        cfg = self.config
        Sn = cfg.slots
        L = self.model_config.max_len
        max_k = max((len(d) for d in planned.values()), default=0)
        W = next(b for b in self._verify_buckets if b >= max_k + 1)
        toks = np.zeros((Sn, W), np.int32)
        posn = np.full((Sn, W), L, np.int32)   # max_len: a dropped write
        temps = np.zeros((Sn,), np.float32)
        top_ks = np.zeros((Sn,), np.int32)
        top_ps = np.ones((Sn,), np.float32)
        consumers: List[RequestState] = []
        for st in self.slots.states:
            if st is None or st.prefilling or st.done:
                continue
            if st.dispatched >= st.req.max_new_tokens:
                continue                       # drained: final sync only
            toks[st.slot, 0] = st.next_input
            posn[st.slot, 0] = st.pos
            temps[st.slot] = st.req.temperature
            top_ks[st.slot] = st.req.top_k
            top_ps[st.slot] = st.req.top_p
            d = planned.get(st.slot, ())
            if d:
                toks[st.slot, 1:1 + len(d)] = d
                posn[st.slot, 1:1 + len(d)] = \
                    st.pos + 1 + np.arange(len(d))
            consumers.append(st)
        if not consumers:
            return []
        mode = self._mode(consumers)
        self._steps_dispatched += 1
        step_t0 = time.perf_counter()
        inputs = dict(toks=toks, pos=posn, top_ks=top_ks, temps=temps,
                      top_ps=top_ps)
        if cfg.paged:
            inputs["pages"] = self._page_table_array()
        prog = self._program("verify", (mode, W))
        dev_tg, dev_lp, host_tg, host_lp = self._verify_bufs[W]
        event = self._launch("serve.verify_step", prog, inputs,
                             ((host_tg, dev_tg), (host_lp, dev_lp)))
        tg, lp, t_sync = self._wait(event, step_t0, host_tg, host_lp)
        tel = self.telemetry
        now = now_fn()
        ps = cfg.page_size if cfg.paged else None
        finished: List[RequestState] = []
        self.spec_steps += 1
        spec_p0, spec_a0 = self.spec_proposed, self.spec_accepted
        for st in consumers:
            d = planned.get(st.slot, [])
            row_t, row_l = tg[st.slot], lp[st.slot]
            accepted = self._accepted(d, row_t)
            emit = accepted + 1          # the model's own token is free
            eos = st.req.eos_id
            if eos is not None:
                for j in range(emit):    # nothing streams past an EOS
                    if int(row_t[j]) == eos:
                        emit = j + 1
                        break
            written = len(d) + 1         # columns this row really wrote
            st.pos += written
            if written > emit:
                self.slots.rewind(st.slot, written - emit, page_size=ps)
            st.dispatched += emit
            if d:
                self.spec_proposed += len(d)
                self.spec_accepted += accepted
                if tel is not None:
                    tel.spec_proposed_total.inc(len(d))
                    tel.spec_accepted_total.inc(accepted)
                    tel.spec_acceptance_ratio.observe(accepted / len(d))
            self.spec_rows += 1
            self.spec_tokens += emit
            if tel is not None:
                tel.spec_tokens_per_step.observe(emit)
            for j in range(emit):
                t = int(row_t[j])
                if tel is not None:
                    if st.token_times:
                        tel.tpot_seconds.observe(now - st.token_times[-1])
                    else:
                        tel.ttft_seconds.observe(now - st.req.arrival)
                    tel.tokens_total.inc()
                st.generated.append(t)
                st.logprobs.append(float(row_l[j]))
                st.token_times.append(now)
                if on_token is not None:
                    on_token(st.req, t)
            st.next_input = int(row_t[emit - 1])
            st.host_next = True          # the device chain token is stale
            if (eos is not None and st.generated
                    and st.generated[-1] == eos):
                st.finish_reason = "eos"
            elif len(st.generated) >= st.req.max_new_tokens:
                st.finish_reason = "length"
            if st.done:
                finished.append(st)
        if self._session_span is not None:
            # a batch span under the session root, stamped at the sync
            dur = t_sync - step_t0
            self._session_span.child(
                "serve.verify_step", now - dur, dur,
                batch=len(consumers),
                proposed=self.spec_proposed - spec_p0,
                accepted=self.spec_accepted - spec_a0)
        return finished

    def _sync_decode_step(self, pending, now_fn, on_token=None) \
            -> List[RequestState]:
        """Host-sync a dispatched step: wait for its event (the only
        blocking device wait in the loop), stream its tokens, mark
        EOS/length retirements. A consumer already done at sync time took
        its one post-EOS junk step; its junk token is discarded here."""
        buf_tok, buf_lp, event, consumers, step_t0 = pending
        out_tok, out_logp, t_sync = self._wait(event, step_t0, buf_tok,
                                               buf_lp)
        tel = self.telemetry
        now = now_fn()
        if self._session_span is not None:
            dur = t_sync - step_t0
            self._session_span.child("serve.decode_step", now - dur, dur,
                                     batch=len(consumers))
        finished = []
        for st in consumers:
            if st.done:
                continue
            t = int(out_tok[st.slot])
            if tel is not None:
                if st.token_times:
                    tel.tpot_seconds.observe(now - st.token_times[-1])
                else:
                    tel.ttft_seconds.observe(now - st.req.arrival)
                tel.tokens_total.inc()
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
        """Bind newly admitted states to their rows and record the
        admission: the trace's hop, the slot_admit event and the prefix
        cache's page counters."""
        alloc = self.page_allocator
        tel = self.telemetry
        timeout = self.config.request_timeout
        for st in admitted:
            if timeout is not None:
                st.deadline = st.admitted_at + timeout
            self.slots.bind(st)
            rt = self._trace(st.req.id)
            if rt is not None:
                # admission ends where the scheduler stamped it; a fully
                # cached prompt skips straight to the post-prefill hop
                rt.begin_hop("serve.prefill" if st.chunks
                             else self.POST_PREFILL_HOP,
                             st.admitted_at,
                             cached_tokens=st.cached_tokens)
            if self.events is not None:
                self.events.emit(ev.SLOT_ADMIT, request=st.req.id,
                                 slot=st.slot,
                                 prompt_len=len(st.req.prompt),
                                 cached_tokens=st.cached_tokens)
            if tel is not None and alloc is not None:
                ps = alloc.page_size
                full = (len(st.req.prompt) - 1) // ps
                hit = st.cached_tokens // ps
                tel.prefix_hit_pages.inc(hit)
                tel.prefix_miss_pages.inc(full - hit)

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
        if self.events is not None:
            self.events.emit(
                ev.SLOT_RETIRE, request=st.req.id, slot=st.slot,
                finish_reason=st.finish_reason,
                new_tokens=len(st.generated))
        if self.telemetry is not None:
            self.telemetry.requests_total.inc()
        rt = self._trace(st.req.id)
        if rt is not None:
            rt.attrs.update(finish_reason=st.finish_reason,
                            new_tokens=len(st.generated),
                            cached_tokens=st.cached_tokens)
            rt.finish("timeout" if st.finish_reason == "timeout"
                      else "ok", self._trace_now())
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
            if self.events is not None:
                self.events.emit(ev.REQUEST_TIMEOUT, request=st.req.id,
                                 slot=st.slot,
                                 new_tokens=len(st.generated),
                                 deadline_seconds=self.config
                                 .request_timeout,
                                 trace=st.req.id)
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
        self._trace_now = now_fn
        if self.tracer is not None:
            self._session_span = self.tracer.begin_session(
                now_fn(), slots=self.config.slots)

    def set_heartbeat(self, hook: Callable[..., None],
                      interval: float) -> None:
        """Install a push-based load reporter: at most once per
        `interval` seconds of session time, tick() calls
        ``hook(now=..., queue_depth=..., free_slots=..., free_pages=...)``
        with this engine's load."""
        if interval <= 0:
            raise ValueError(f"heartbeat interval must be > 0, got "
                             f"{interval}")
        self._heartbeat = (hook, float(interval))
        self._heartbeat_last = None

    def _maybe_heartbeat(self, now: float) -> None:
        """The rate-limited report of set_heartbeat, if one is set."""
        if self._heartbeat is None:
            return
        hook, interval = self._heartbeat
        last = self._heartbeat_last
        if last is not None and now - last < interval:
            return
        self._heartbeat_last = now
        alloc = self.page_allocator
        hook(now=now,
             queue_depth=len(self.scheduler.queue),
             free_slots=len(self.slots.free),
             free_pages=alloc.available if alloc is not None else 0)

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
        if self.tracer is not None:
            # open (or join) this request's trace; admission begins now
            rt = self.tracer.begin_request(
                req.id, t0=req.arrival, prompt_len=len(req.prompt),
                max_new_tokens=req.max_new_tokens)
            if rt is not None:
                rt.begin_hop("serve.admission",
                             max(req.arrival, self._session["now_fn"]()))

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
        tel = self.telemetry
        with span("serve.schedule"):
            self._note_admissions(self.scheduler.admit(
                self.slots.free, now, allocator=alloc))
        self.occupancy_peak = max(self.occupancy_peak, self.slots.occupied)
        if alloc is not None:
            self.pages_in_use_peak = max(self.pages_in_use_peak,
                                         alloc.in_use)
        if tel is not None:
            tel.queue_depth.set(len(self.scheduler.queue))
            tel.slot_occupancy.set(self.slots.occupied)
            if alloc is not None:
                tel.pages_in_use.set(alloc.in_use)
                tel.pages_cached.set(alloc.cached_pages)
        # after admission: the queue that still waits behind the slots
        self._maybe_heartbeat(now)
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
        planned = {}
        if (self.config.speculative is not None
                and self.scheduler.decoding()):
            # drafting reads the host-known history and acceptance decides
            # the next step's inputs: drain the step in flight first
            if pending is not None:
                retire(self._sync_decode_step(pending, now_fn, on_token))
                pending = None
            planned = self._plan_drafts()
        if planned:
            retire(self._spec_step(planned, now_fn, on_token))
            new_pending = None
        else:
            # no row drafted (novel text, sampled rows, spent budgets):
            # a plain step, its dispatch overlap intact
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

    def session_results(self) -> Dict[int, RequestResult]:
        """The open session's retired results so far (a live view): the
        router fans these in after each tick()."""
        if self._session is None:
            raise RuntimeError("session_results() outside a session")
        return self._session["results"]

    def finish(self) -> Dict[int, RequestResult]:
        """Close the session and return {request.id: RequestResult}."""
        sess = self._session
        if sess is None:
            raise RuntimeError("finish() outside a session")
        tel = self.telemetry
        if tel is not None:
            counts = self.compile_counts()
            tel.step_compiles.set(counts["step"])
            tel.prefill_compiles.set(counts["prefill"])
            tel.queue_depth.set(len(self.scheduler.queue))
            tel.slot_occupancy.set(self.slots.occupied)
        if self._session_span is not None:
            self._session_span.end(sess["now_fn"]())
            self._session_span = None
        self._trace_now = None
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
            if self._session is not None:
                self.trace_abandon(self._session["now_fn"]())
            self._session = None
            raise
        return self.finish()


def _on_device(model: CausalLM, device: torch.device) -> CausalLM:
    """`model` itself when it lives on `device`, else a copy of its
    parameters there (the decode pool on a second card)."""
    if model.device == device:
        return model
    return build_lm(model.config, model.state_dict(), device=device)


class PrefillEngine(ServingEngine):
    """The prefill half of a disaggregated pair (DisaggEngine drives
    it): admits requests and runs batched chunked prefill, but never
    dispatches a decode step — so its programs are prefill only
    (`prefill <= len(chunk_buckets)`, `step == 0`). Page reservations
    cover the PROMPT span only (Scheduler reserve="prompt"): the decode
    span lives in the decode pool, so at equal bytes this pool keeps
    more prompts in flight than a colocated engine could."""

    RESERVE = "prompt"

    #: a prefilled prompt's next hop in this pool is the page handoff,
    #: not decode — trace hop names follow the disaggregated flow
    POST_PREFILL_HOP = "serve.kv_handoff"

    def __init__(self, model: CausalLM, config: Optional[EngineConfig] = None,
                 device=None, telemetry=None, events=None, tracer=None):
        cfg = config or EngineConfig()
        if not cfg.paged:
            raise ValueError("disaggregated serving requires paged=True "
                             "(the handoff unit is a page list)")
        # the prefill pool never decodes, so it never drafts either
        if cfg.speculative is not None:
            cfg = dataclasses.replace(cfg, speculative=None)
        super().__init__(model, cfg, device=device, telemetry=telemetry,
                         events=events, tracer=tracer)

    def take_prefilled(self) -> List[RequestState]:
        """Pop every state whose prefill just completed: it leaves the
        scheduler and frees its slot row (the next prompt starts at
        once) but KEEPS its page references — the handoff still reads
        those pages; DisaggEngine releases them once the copy is
        enqueued. Nothing writes the kept pages meanwhile: writes go
        through slot page tables, and the freed row's table is rebuilt
        from its next occupant's pages."""
        done = [st for st in self.scheduler.active if not st.prefilling]
        for st in done:
            self.scheduler.retire(st)
            self.slots.release(st)
            st.slot_released = True
        return done


class DecodeEngine(ServingEngine):
    """The decode half: requests arrive prefilled through
    `install_handoff` and flow through the shared decode step; this pool
    never builds a prefill program (`step <= 3`, `prefill == 0`). Its
    PageAllocator runs the same prefix cache as a colocated engine — a
    handed-off prompt whose prefix is already resident here needs no
    bytes moved for those pages (DisaggEngine moves only the misses)."""

    def __init__(self, model: CausalLM, config: Optional[EngineConfig] = None,
                 device=None, telemetry=None, events=None, drafter=None,
                 tracer=None):
        cfg = config or EngineConfig()
        if not cfg.paged:
            raise ValueError("disaggregated serving requires paged=True "
                             "(the handoff unit is a page list)")
        super().__init__(model, cfg, device=device, telemetry=telemetry,
                         events=events, drafter=drafter, tracer=tracer)

    def install_handoff(self, req: Request, reserved, now: float,
                        cached_tokens: int = 0,
                        ) -> Tuple[RequestState, List[Tuple[int, int]]]:
        """Bind a prefill-complete request into a slot of THIS pool.
        `reserved` is this pool's full-span page reservation (chain,
        private, table) from Scheduler._reserve_pages — the chain pages
        are decode-side prefix-cache hits whose KV is already resident.
        Returns (state, fill): fill lists (prompt-page index, physical
        page here) for every page whose contents must still be copied in
        from the prefill pool; full prompt pages among them are published
        into this pool's prefix cache at once, so the NEXT handoff
        sharing the prefix skips their copy too.

        The caller must have checked `self.slots.free` first."""
        chain, private, table = reserved
        alloc = self.page_allocator
        ps = alloc.page_size
        p1 = len(req.prompt) - 1
        full = p1 // ps                   # complete PROMPT pages
        # pages prefill actually wrote: positions [0, p1)
        written = 0 if p1 < 1 else (p1 - 1) // ps + 1
        slot = self.slots.free.pop(0)
        st = RequestState(req=req, slot=slot, pos=p1, chunks=[],
                          next_input=int(req.prompt[-1]), admitted_at=now)
        if self.config.request_timeout is not None:
            # the decode pool stamps its OWN window — the prefill-side
            # deadline was consumed getting the request this far
            st.deadline = now + self.config.request_timeout
        st.page_table = table
        st.owned_pages = chain + private
        st.cached_tokens = cached_tokens
        st.published_pages = full         # published below or inherited —
        st.publish_parent = -1            # the engine never re-publishes
        self.slots.bind(st)
        self.scheduler.active.append(st)
        fill = [(k, table[k]) for k in range(len(chain), written)]
        if self.config.prefix_cache:
            parent = chain[-1] if chain else -1
            for k in range(len(chain), full):
                if not alloc.publish(table[k], parent,
                                     req.prompt[k * ps:(k + 1) * ps]):
                    break
                parent = table[k]
        if self.telemetry is not None:
            # decode-side hit/miss = handoff pages saved/moved — the
            # same instruments a colocated engine feeds at admission
            self.telemetry.prefix_hit_pages.inc(len(chain))
            self.telemetry.prefix_miss_pages.inc(written - len(chain))
        if self.events is not None:
            self.events.emit(ev.SLOT_ADMIT, request=req.id, slot=slot,
                             prompt_len=len(req.prompt),
                             cached_tokens=len(chain) * ps)
        return st, fill


def disagg_devices(devices=None) -> Tuple[torch.device, ...]:
    """The (prefill, decode) devices of a DisaggEngine: `devices` as
    given (`("cpu", "cpu")` only when asked), or by default (cuda:0,
    cuda:1) with two cards and (cuda:0, cuda:0) with one; raises without
    a card."""
    if devices is not None:
        out = tuple(resolve_device(d) for d in devices)
        if len(out) != 2:
            raise ValueError(f"devices= names {len(out)} devices; expected "
                             f"(prefill, decode)")
        return out
    resolve_device(None)                   # raises without a card
    if torch.cuda.device_count() > 1:
        return torch.device("cuda", 0), torch.device("cuda", 1)
    return torch.device("cuda", 0), torch.device("cuda", 0)


class DisaggEngine:
    """Disaggregated prefill/decode serving: a PrefillEngine and a
    DecodeEngine, bridged by the paged-KV handoff (serve/transfer.py).
    A long prompt saturates the prefill pool while in-flight decodes
    keep stepping in the decode pool, and each pool builds only its own
    programs.

    Flow per request: admit → prefill pool (prompt-span page
    reservation, batched chunked prefill) → handoff (decode-side
    full-span reservation; a copy of exactly the prompt pages the decode
    pool's prefix cache does NOT already hold) → decode pool (the shared
    double-buffered step) → retire (pages park in the decode pool's
    prefix cache). Admission is backpressured when the decode pool's
    free pages cannot absorb the in-flight handoffs (Scheduler.gate), so
    a handoff can stall on slots, never deadlock on pages.

    Devices: `devices=(prefill, decode)`, or by default cuda:0 and cuda:1 with two cards, cuda:0 for both with one
    (see `disagg_devices`). The weights are cast to the compute dtype
    once: on one card the pools are two engines over those same
    read-only weights, each with its own cache, programs, CUDA graphs,
    staging buffers and generator, all on the card's current stream; on
    two cards the decode pool gets its own copy.

    Token parity: at temperature 0 the facade is token for token the
    colocated paged ServingEngine over the same trace
    (tests/test_torch_disagg.py): per-slot prefill and step rows are
    computed independently, the handoff copies those exact bytes (int8
    pages with their scale planes), and the decode step is the same
    program. Sampled rows match in distribution only: each pool has its
    own generator."""

    def __init__(self, model: CausalLM, config: Optional[EngineConfig] = None,
                 *, prefill_config: Optional[EngineConfig] = None,
                 registry=None, events=None, devices=None,
                 drafter=None, tracer=None):
        cfg = config or EngineConfig(paged=True)
        pcfg = prefill_config or cfg
        if not cfg.paged or not pcfg.paged:
            raise ValueError("disaggregated serving requires paged=True")
        if pcfg.page_size != cfg.page_size:
            raise ValueError(
                f"prefill/decode page_size disagree "
                f"({pcfg.page_size} vs {cfg.page_size}) — the handoff "
                f"moves pages verbatim")
        self.devices = disagg_devices(devices)
        pre_tel = dec_tel = None
        if registry is not None:
            from ..telemetry.worker import ServeTelemetry
            pre_tel = ServeTelemetry(registry, labels={"pool": "prefill"})
            dec_tel = ServeTelemetry(registry, labels={"pool": "decode"})
        self.events = events
        pre_ev = events.bind(pool="prefill") if events is not None else None
        dec_ev = events.bind(pool="decode") if events is not None else None
        self.tracer = tracer
        # one cast for both pools: on one card they read the same weights
        shared = cast_params(decode_model(model, cfg.decode_kernel),
                             model.config.dtype)
        self.prefill = PrefillEngine(
            _on_device(shared, self.devices[0]), pcfg,
            device=self.devices[0], telemetry=pre_tel, events=pre_ev,
            tracer=tracer)
        self.decode = DecodeEngine(
            _on_device(shared, self.devices[1]), cfg,
            device=self.devices[1], telemetry=dec_tel, events=dec_ev,
            drafter=drafter, tracer=tracer)
        self.transfer = PageTransfer(self.prefill.page_allocator.num_pages,
                                     self.decode.page_allocator.num_pages)
        self.config = cfg
        self._handoff_q: List[RequestState] = []
        # handoff trace for the bench: (seconds, pages moved, pages
        # skipped via the decode-side prefix cache) per handoff
        self.handoff_log: List[Tuple[float, int, int]] = []
        self._install_gate()

    def _install_gate(self) -> None:
        """Decode-capacity backpressure on PREFILL admission: a request
        enters the prefill pool only while the decode pool's available
        pages cover every in-flight request's worst-case span plus this
        one — so prefill cannot fill with prompts the decode pool cannot
        absorb, and handoffs drain as decode capacity frees (the
        scheduler's lookahead still packs smaller requests past a gated
        head)."""
        ps = self.config.page_size
        dec_alloc = self.decode.page_allocator

        def gate(req: Request) -> bool:
            inflight = sum(Scheduler.pages_needed(s.req, ps)
                           for s in self.prefill.scheduler.active)
            inflight += sum(Scheduler.pages_needed(s.req, ps)
                            for s in self._handoff_q)
            return (dec_alloc.available
                    >= inflight + Scheduler.pages_needed(req, ps))

        self.prefill.scheduler.gate = gate

    def reset(self) -> None:
        """Reset both pools (queues, caches, allocators) keeping every
        program and CUDA graph, so a warmed DisaggEngine replays a trace
        with identical tokens and identical program counts."""
        self.prefill.reset()
        self.decode.reset()
        self._handoff_q = []
        self.handoff_log = []
        self.transfer.pages_moved = 0
        self._install_gate()              # reset() rebuilt the scheduler

    def compile_counts(self) -> Dict[str, Dict[str, int]]:
        """Per-pool program counts plus the transfer's widths. The
        disaggregation pins: prefill pool `step == 0`, decode pool
        `prefill == 0` — neither pool ever builds the other's
        programs."""
        return {"prefill_pool": self.prefill.compile_counts(),
                "decode_pool": self.decode.compile_counts(),
                "transfer": self.transfer.compile_counts()}

    def capture_counts(self) -> Dict[str, Dict[str, int]]:
        """CUDA graphs captured by each pool (serve/programs.py)."""
        return {"prefill_pool": self.prefill.capture_counts(),
                "decode_pool": self.decode.capture_counts()}

    @property
    def steps_dispatched(self) -> int:
        """Decode steps the decode pool dispatched since reset()."""
        return self.decode.steps_dispatched

    def _handoff(self, st: RequestState, reserved, now: float) -> None:
        """Move one prefill-complete request into the decode pool:
        install it there (decode-side reservation already made), copy
        exactly the non-cached written prompt pages, then drop the
        prefill pool's page references — its published prompt pages
        park in the prefill prefix cache (a repeat prompt skips the
        recompute), the private tail returns to its free list. The copy
        is enqueued before the release, and the next prefill that may
        rewrite a released page is enqueued after it on the same stream
        (serve/transfer.py)."""
        pre, dec = self.prefill, self.decode
        t0 = time.perf_counter()
        chain_hits = len(reserved[0])
        new_st, fill = dec.install_handoff(st.req, reserved, now,
                                           cached_tokens=st.cached_tokens)
        src_ids = [st.page_table[k] for k, _ in fill]
        dst_ids = [p for _, p in fill]
        with span("serve.kv_handoff"):
            moved = self.transfer.move(pre.cache, dec.cache, src_ids,
                                       dst_ids)
        for p in st.owned_pages:
            pre.page_allocator.release(p)
        st.owned_pages = []
        dt = time.perf_counter() - t0     # host wall: the copy is async
        self.handoff_log.append((dt, moved, chain_hits))
        rt = dec._trace(st.req.id)
        if rt is not None:
            # page counts land on the kv_handoff hop (prefill done ->
            # installed here, queue wait included), then decode opens
            rt.hop_attrs(pages=moved, cached_pages=chain_hits,
                         move_seconds=dt)
            rt.begin_hop("serve.decode", now)
        if dec.telemetry is not None:
            dec.telemetry.kv_handoff_seconds.observe(dt)
            dec.telemetry.kv_handoff_pages.inc(moved)
        if self.events is not None:
            self.events.emit(ev.KV_HANDOFF, request=st.req.id,
                             pages=moved, cached_pages=chain_hits,
                             seconds=dt)

    def _sweep_handoff_timeouts(self, now: float,
                                results: Dict[int, RequestResult]) -> None:
        """Expire past-deadline requests parked in the handoff queue.
        These left the prefill scheduler already (take_prefilled) but
        still hold prefill-pool page references for the pending copy —
        the one resident claim _sweep_timeouts cannot see — so the drop
        happens here, against the prefill allocator, before the decode
        pool ever reserves for them."""
        pre = self.prefill
        still: List[RequestState] = []
        for st in self._handoff_q:
            if st.deadline is None or now < st.deadline:
                still.append(st)
                continue
            st.finish_reason = "timeout"
            for p in st.owned_pages:
                pre.page_allocator.release(p)
            st.owned_pages = []
            if self.events is not None:
                self.events.emit(ev.REQUEST_TIMEOUT, request=st.req.id,
                                 slot=st.slot, new_tokens=0,
                                 deadline_seconds=pre.config
                                 .request_timeout,
                                 trace=st.req.id)
            if pre.telemetry is not None:
                pre.telemetry.requests_total.inc()
            rt = pre._trace(st.req.id)
            if rt is not None:
                rt.attrs.update(finish_reason="timeout", new_tokens=0)
                rt.finish("timeout", now)
            results[st.req.id] = RequestResult(
                id=st.req.id, tokens=[], logprobs=[],
                finish_reason="timeout", ttft=-1.0, token_times=[],
                cached_tokens=st.cached_tokens,
                admitted_at=st.admitted_at)
        self._handoff_q = still

    def _drain_handoffs(self, now_fn) -> None:
        """Install every queued handoff the decode pool can take right
        now (a free slot + a full-span page reservation); the rest stay
        queued — backpressure keeps this queue short, and decode-side
        retirements free the capacity that drains it."""
        dec = self.decode
        still: List[RequestState] = []
        for st in self._handoff_q:
            reserved = None
            if dec.slots.free:
                reserved = dec.scheduler._reserve_pages(
                    st.req, dec.page_allocator)
            if reserved is None:
                still.append(st)
                continue
            self._handoff(st, reserved, now_fn())
        self._handoff_q = still

    def run(self, requests: Sequence[Request] = (),
            on_token: Optional[Callable[[Request, int], None]] = None,
            ) -> Dict[int, RequestResult]:
        """Drive both pools to completion over `requests` — the contract
        of ServingEngine.run (future arrivals, on_token streaming,
        {id: RequestResult})."""
        pre, dec = self.prefill, self.decode
        ps = self.config.page_size
        for r in requests:
            need = Scheduler.pages_needed(r, ps)
            if need > dec.page_allocator.usable:
                raise ValueError(
                    f"request {r.id}: worst-case span needs {need} KV "
                    f"pages but the decode pool has "
                    f"{dec.page_allocator.usable} usable")
            pneed = Scheduler.prompt_pages_needed(r, ps)
            if pneed > pre.page_allocator.usable:
                raise ValueError(
                    f"request {r.id}: prompt span needs {pneed} KV pages "
                    f"but the prefill pool has "
                    f"{pre.page_allocator.usable} usable")
            pre.scheduler.submit(r)
            if self.tracer is not None:
                rt = self.tracer.begin_request(
                    r.id, t0=r.arrival, prompt_len=len(r.prompt),
                    max_new_tokens=r.max_new_tokens, disagg=True)
                if rt is not None:
                    # no front door queue: admission starts at arrival
                    rt.begin_hop("serve.admission", r.arrival)
        t0 = time.perf_counter()
        now_fn = lambda: time.perf_counter() - t0   # noqa: E731
        # both pools stamp trace hops on the SAME run clock, so a
        # request's prefill/handoff/decode hops stay contiguous across
        # the pool boundary
        pre._trace_now = dec._trace_now = now_fn
        if self.tracer is not None:
            dec._session_span = self.tracer.begin_session(
                now_fn(), slots=dec.config.slots, pool="decode")
        results: Dict[int, RequestResult] = {}
        pending = None

        def retire(finished: List[RequestState]) -> None:
            for st in finished:
                dec._retire_state(st, results)

        while not (pre.scheduler.idle and not self._handoff_q
                   and dec.scheduler.idle and pending is None):
            now = now_fn()
            # per-pool deadline sweeps plus the handoff queue (a request
            # parked between pools holds prefill-side pages)
            pre._sweep_timeouts(now, results)
            dec._sweep_timeouts(now, results)
            self._sweep_handoff_timeouts(now, results)
            with span("serve.schedule"):
                pre._note_admissions(
                    pre.scheduler.admit(pre.slots.free, now,
                                        allocator=pre.page_allocator))
            for eng, qdepth in ((pre, len(pre.scheduler.queue)),
                                (dec, len(self._handoff_q))):
                eng.occupancy_peak = max(eng.occupancy_peak,
                                         eng.slots.occupied)
                eng.pages_in_use_peak = max(eng.pages_in_use_peak,
                                            eng.page_allocator.in_use)
                if eng.telemetry is not None:
                    # the decode pool's "queue" is the handoff queue —
                    # prompts prefilled but not yet installed
                    eng.telemetry.queue_depth.set(qdepth)
                    eng.telemetry.slot_occupancy.set(eng.slots.occupied)
                    eng.telemetry.pages_in_use.set(
                        eng.page_allocator.in_use)
                    eng.telemetry.pages_cached.set(
                        eng.page_allocator.cached_pages)
            if (pre.slots.occupied == 0 and not self._handoff_q
                    and dec.slots.occupied == 0 and pending is None):
                nxt = pre.scheduler.next_arrival()
                if nxt is not None and nxt > now_fn():
                    time.sleep(min(nxt - now_fn(), 0.05))
                continue
            lead = pre.scheduler.next_prefill()
            if lead is not None:
                pre._run_prefill_batched(lead)
            self._handoff_q.extend(pre.take_prefilled())
            self._drain_handoffs(now_fn)
            planned = {}
            if (dec.config.speculative is not None
                    and dec.scheduler.decoding()):
                # the decode pool verifies; drafting reads host history,
                # so the step in flight is synced first
                if pending is not None:
                    retire(dec._sync_decode_step(pending, now_fn, on_token))
                    pending = None
                planned = dec._plan_drafts()
            if planned:
                retire(dec._spec_step(planned, now_fn, on_token))
                new_pending = None
            else:
                new_pending = (dec._dispatch_decode_step()
                               if dec.scheduler.decoding() else None)
            if pending is not None:
                retire(dec._sync_decode_step(pending, now_fn, on_token))
                pending = None
            if self.config.async_decode:
                pending = new_pending
            elif new_pending is not None:
                retire(dec._sync_decode_step(new_pending, now_fn, on_token))
        for eng in (pre, dec):
            if eng.telemetry is not None:
                counts = eng.compile_counts()
                eng.telemetry.step_compiles.set(counts["step"])
                eng.telemetry.prefill_compiles.set(counts["prefill"])
                eng.telemetry.queue_depth.set(0)
                eng.telemetry.slot_occupancy.set(eng.slots.occupied)
        if dec._session_span is not None:
            dec._session_span.end(now_fn())
            dec._session_span = None
        pre._trace_now = dec._trace_now = None
        return results


__all__ = ["DecodeEngine", "DisaggEngine", "EngineConfig", "PrefillEngine",
           "RequestResult", "SAMPLE_POOL", "ServingEngine", "disagg_devices",
           "propose_ngram", "sample_slots"]
