"""Serving front door: prefix-affinity routing over an engine fleet
(PyTorch).

The PyTorch port's own copy of mpi_operator_tpu/serve/router.py, kept
in its logic: the port imports nothing of the JAX package. The replicas
are the port's ServingEngines (serve/engine.py), on one card or several;
each has its own cache, programs, CUDA graphs and generator, and the
router ticks them in turn on one thread, so one replica may capture a
graph while another's decode step is still in flight on the card.

One engine is HBM-bound; the fleet answer is N replicas behind a router.
This module is that router: a single-threaded dispatcher that drives N
in-process ServingEngine replicas through their steppable session API
(engine.start/submit/tick/finish) on ONE shared clock, deciding for each
arriving request

  1. whether to admit it at all (per-replica in-flight caps — the shed
     path rejects at the front door BEFORE a request strands pages or
     slots on a saturated replica), and
  2. WHICH replica serves it, by prefix-cache affinity first: the
     replica whose PageAllocator holds the deepest warm chain for the
     prompt's page-aligned prefix windows (the same
     `(parent_page, token_window)` keying slots.py uses — probed via
     PageAllocator.probe, so router and replica can never key
     differently), load-aware dispatch (queue depth x free slots x free
     pages) breaking ties and taking over entirely when affinity is off
     or cold.

Affinity NEVER overrides load saturation: a replica at its in-flight
cap is ineligible no matter how warm its cache is — a hit on a full
replica would queue behind its whole backlog and lose more TTFT than
the prefill it saves.

Failover: a replica whose submit/tick raises is marked dead, and every
request it still held in flight is resubmitted to the survivors
(idempotent at the front door — results key by request id and the
replay is a fresh Request, so the caller sees exactly one result per
request; greedy tokens are engine-independent, so the replay is
token-identical). Streamed tokens for a request that later failed over
restart from the replayed prefill.

LIVE topology changes (the autoscaler's surgical path — no other
replica pauses, nothing recompiles):

  * attach_replica() joins a PRE-WARMED engine to the open session —
    warmup (the compile pin) happens out-of-band, which is the whole
    point: the router is single-threaded, so warming in-band would
    stall exactly the goodput the new replica is supposed to buy. A
    cold engine is refused loudly.
  * detach_replica() runs a graceful drain: admission closes
    immediately (draining replicas are never picked), requests still
    in the engine's queue (submitted, not yet admitted to slots) are
    pulled back and FAILED OVER to survivors through the same
    idempotent replay path failover uses — never shed — and requests
    already decoding finish in place. Teardown only happens once the
    replica is idle, with pages/slots verified reclaimed
    (PageAllocator.check()).
  * schedule_attach()/schedule_detach() arm either action at a session
    time, executed inside run() — the bench/chaos shape for mid-trace
    ±1 steps. Completed steps land in `live_scale_log` with their
    drain/warmup phase split (the data side of the resize ledger's
    live_scale entries).

Load visibility is push-first: with heartbeats on
(RouterConfig.heartbeat_interval), every engine publishes queue depth /
free slots / free pages into RouterTelemetry on a session-clock
heartbeat, and dispatch scoring prefers a FRESH heartbeat over probing
engine state in-process — falling back when the report is older than
the staleness threshold (the collector's scrape-staleness convention:
age since last successful report, default twice the publish interval).
In-process both sources agree; the heartbeat path is what a cross-host
router would actually see.

Every decision is observable through RouterTelemetry
(telemetry/worker.py): per-replica dispatch counters, affinity
hit/miss pages, shed count, queue-wait histograms, per-replica
heartbeat gauges, attach/detach counters — `tpu_router_*` series the
controller's collector federates into `tpu_job_router_*`.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from ..telemetry import span
from .engine import Request, RequestResult, ServingEngine
from .scheduler import Scheduler

logger = logging.getLogger("mpi_operator_tpu_torch.serve.router")

__all__ = ["ReplicaHandle", "Router", "RouterConfig"]


@dataclass
class RouterConfig:
    """Front-door policy knobs.

    max_inflight: per-replica in-flight cap (dispatched, not yet
    retired). The shed path fires when EVERY live replica is at its
    cap — a bounded fleet-wide backlog, so a burst degrades to fast
    rejections instead of unbounded queueing.
    affinity: prefix-affinity scoring on/off (off = pure load-aware
    dispatch; the bench's A/B switch).
    heartbeat_interval: > 0 turns on push-based replica load reports —
    every engine publishes queue depth / free slots / free pages into
    RouterTelemetry at most once per interval of session time, and
    dispatch scoring PREFERS a fresh report over probing the engine
    in-process. 0 (default) keeps the probing path.
    heartbeat_staleness: maximum report age (seconds of session time)
    before dispatch falls back to probing — the collector's
    scrape-staleness convention, age since the last successful report.
    None = 2x heartbeat_interval (one missed beat tolerated, two is a
    silent replica).
    """
    max_inflight: int = 8
    affinity: bool = True
    heartbeat_interval: float = 0.0
    heartbeat_staleness: Optional[float] = None


@dataclass
class ReplicaHandle:
    """One engine replica as the router sees it: the engine itself plus
    the front door's own bookkeeping (which request ids it holds, and
    whether it is still alive).

    Lifecycle: alive -> (draining) -> detached | dead. `draining` means
    admission is closed but resident requests are still finishing;
    `detached` marks a VOLUNTARY exit (graceful drain completed, pages
    and slots verified reclaimed) — distinct from a failover death, so
    a scaled-down fleet is not mistaken for a crashed one."""
    index: int
    engine: ServingEngine
    alive: bool = True
    draining: bool = False
    detached: bool = False
    drain_started: float = 0.0
    inflight: Dict[int, Request] = field(default_factory=dict)
    dispatched_total: int = 0

    # -- scoring inputs ---------------------------------------------------

    def affinity_pages(self, prompt: Sequence[int]) -> int:
        """Warm-chain depth (pages) this replica's prefix cache holds
        for `prompt` — PageAllocator.probe, i.e. EXACTLY the keying its
        own admission lookup will walk. 0 without paging."""
        alloc = self.engine.page_allocator
        if alloc is None:
            return 0
        return alloc.probe(prompt)

    def load(self) -> tuple:
        """Load-aware dispatch key, ascending = less loaded: in-flight
        requests and queued-behind-slots depth first, then fewer free
        slots, then fewer available pages. Mirrors the
        `tpu_worker_queue_depth` / `tpu_worker_slot` /
        `tpu_worker_kv_pages_*` gauges an out-of-process router would
        scrape; in-process it reads the same state directly."""
        eng = self.engine
        alloc = eng.page_allocator
        free_pages = alloc.available if alloc is not None else 0
        return (len(self.inflight) + len(eng.scheduler.queue),
                -len(eng.slots.free),
                -free_pages)

    def fits(self, req: Request) -> bool:
        """Whether this replica could EVER hold the request's worst-case
        page span — a span the pool can't cover is submit()-rejected, so
        it is not a routing candidate."""
        alloc = self.engine.page_allocator
        if alloc is None:
            return True
        return Scheduler.pages_needed(req, alloc.page_size) <= alloc.usable


class Router:
    """Front-door dispatcher over N in-process engine replicas.

    Usage (the serve_benchmark / tier1 --router shape):
        router = Router([engine0, engine1], RouterConfig())
        results = router.run(requests)          # same contract as
                                                # ServingEngine.run()

    The loop is cooperative round-robin: each iteration admits every
    due arrival (route or shed), then ticks each live replica once.
    Replicas that raise are failed over (see module docstring). All
    replicas share one session clock, so `arrival` offsets and TTFTs
    are fleet-consistent.
    """

    def __init__(self, engines: Sequence[ServingEngine],
                 config: Optional[RouterConfig] = None,
                 telemetry=None, tracer=None):
        """telemetry: a telemetry.RouterTelemetry (optional,
        None-cost when absent). tracer: a telemetry.Tracer — the router
        opens each request's ROOT span at intake (queue-wait hop,
        dispatch/shed/failover span events) and shares the tracer with
        every replica engine that doesn't have its own, so one request
        keeps ONE trace no matter how many replicas serve it."""
        if not engines:
            raise ValueError("router needs at least one engine replica")
        cfg = config or RouterConfig()
        if cfg.max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got "
                             f"{cfg.max_inflight}")
        self.config = cfg
        self.replicas = [ReplicaHandle(i, e) for i, e in enumerate(engines)]
        self.telemetry = telemetry
        self.tracer = tracer
        for rep in self.replicas:
            self._share_tracer(rep.engine)
        self.results: Dict[int, RequestResult] = {}
        self.shed: Dict[int, RequestResult] = {}
        self.resubmitted_total = 0
        self.affinity_hit_pages = 0
        self.affinity_miss_pages = 0
        # completed live topology steps, in order: one dict per
        # attach/detach with its drain/warmup phase split — the data
        # side of the resize ledger's live_scale entries (the bench
        # emits these as LIVE_SCALE events)
        self.live_scale_log: List[Dict] = []
        self._scale_plan: List[Dict] = []   # armed schedule_* steps
        self._backlog: List[Request] = []   # live only inside run()
        self._on_token: Optional[Callable[[Request, int], None]] = None
        self._now_fn: Optional[Callable[[], float]] = None

    # -- routing policy ---------------------------------------------------

    def _share_tracer(self, engine) -> None:
        """Hand the router's tracer to a replica engine that has none —
        the engine-side hops (admission/prefill/decode) land in the
        SAME trace registry the router's root spans live in. Tolerates
        engines (test fakes) that don't carry the attribute."""
        if self.tracer is None \
                or getattr(engine, "tracer", None) is not None:
            return
        try:
            engine.tracer = self.tracer
        except AttributeError:
            pass

    def _trace(self, rid: int):
        return self.tracer.active(rid) if self.tracer is not None else None

    def _live(self) -> List[ReplicaHandle]:
        return [r for r in self.replicas if r.alive]

    def _now(self, now: Optional[float] = None) -> float:
        return now if now is not None \
            else (self._now_fn() if self._now_fn is not None else 0.0)

    def _load_key(self, rep: ReplicaHandle, now: float) -> tuple:
        """Load key for dispatch scoring: a FRESH heartbeat report when
        push-based load reporting is on (plus the router's own in-flight
        count, which the replica cannot know), falling back to probing
        engine state in-process when the report is stale — age since
        last publish beyond the staleness threshold, the collector's
        scrape-staleness convention."""
        cfg = self.config
        tel = self.telemetry
        if tel is not None and cfg.heartbeat_interval > 0:
            get = getattr(tel, "heartbeat", None)
            hb = get(rep.index) if get is not None else None
            if hb is not None:
                staleness = cfg.heartbeat_staleness
                if staleness is None:
                    staleness = 2.0 * cfg.heartbeat_interval
                if now - hb["now"] <= staleness:
                    return (len(rep.inflight) + int(hb["queue_depth"]),
                            -int(hb["free_slots"]),
                            -int(hb["free_pages"]))
        return rep.load()

    def _pick(self, req: Request,
              now: Optional[float] = None) -> Optional[ReplicaHandle]:
        """The dispatch decision. Eligible = alive, NOT draining (a
        detach closes admission the instant it is requested), under the
        in-flight cap, and able to ever fit the span; among those,
        deepest warm prefix chain wins (affinity on), load key breaks
        ties, lowest index makes it deterministic. Returns None =
        shed."""
        now = self._now(now)
        eligible = [r for r in self._live()
                    if not r.draining
                    and len(r.inflight) < self.config.max_inflight
                    and r.fits(req)]
        if not eligible:
            return None
        if self.config.affinity:
            scored = [(-r.affinity_pages(req.prompt),
                       self._load_key(r, now), r.index, r)
                      for r in eligible]
        else:
            scored = [(0, self._load_key(r, now), r.index, r)
                      for r in eligible]
        scored.sort(key=lambda s: s[:3])
        return scored[0][3]

    def _shed(self, req: Request, now: float) -> None:
        """Front-door rejection: a result with finish_reason "shed" and
        no tokens — the request never touched a replica, so no pages or
        slots were stranded."""
        self.shed[req.id] = RequestResult(
            id=req.id, tokens=[], logprobs=[], finish_reason="shed",
            ttft=-1.0, token_times=[], cached_tokens=0, admitted_at=now)
        if self.telemetry is not None:
            self.telemetry.shed_total.inc()
        rt = self._trace(req.id)
        if rt is not None:
            rt.event("shed")
            rt.finish("shed", now)

    def _dispatch(self, req: Request, now: float) -> bool:
        """Route one due request: pick a replica (or shed), record the
        affinity prediction, submit. Returns False when shed."""
        rep = self._pick(req, now)
        if rep is None:
            self._shed(req, now)
            return False
        # measured in BOTH modes (affinity off still records how warm the
        # load-chosen replica happened to be) so the A/B hit-rate
        # comparison is honest, not affinity-counting-itself
        warm = rep.affinity_pages(req.prompt)
        alloc = rep.engine.page_allocator
        full = (max(0, (len(req.prompt) - 1) // alloc.page_size)
                if alloc is not None else 0)
        self.affinity_hit_pages += warm
        self.affinity_miss_pages += full - warm
        tel = self.telemetry
        if tel is not None:
            tel.dispatch_for(rep.index).inc()
            tel.affinity_hit_pages.inc(warm)
            tel.affinity_miss_pages.inc(full - warm)
            if now >= req.arrival:
                tel.queue_wait_seconds.observe(now - req.arrival)
        rt = self._trace(req.id)
        if rt is not None:
            # the dispatch decision as a span event on the root; the
            # engine's submit() closes the queue-wait hop where its
            # admission hop begins
            rt.event("dispatch", replica=rep.index, warm_pages=warm)
        rep.engine.submit(req)
        rep.inflight[req.id] = req
        rep.dispatched_total += 1
        return True

    def _fail_replica(self, rep: ReplicaHandle, now: float,
                      backlog: List[Request],
                      exc: Optional[BaseException] = None) -> None:
        """Mark a replica dead and push its in-flight requests back on
        the dispatch backlog as fresh arrivals. The dead engine's
        partial results are DISCARDED (results key by id; the replay
        produces the authoritative — and for greedy traffic identical —
        tokens). A DRAINING replica that dies mid-drain takes this same
        path: its residents fail over instead of finishing in place.
        `exc`, the error the replica raised, is logged with its
        traceback, so a failover never hides a fault."""
        if exc is not None:
            logger.error("replica %d failed with %d request(s) in flight; "
                         "failing them over", rep.index, len(rep.inflight),
                         exc_info=exc)
        rep.alive = False
        rep.draining = False
        if self.telemetry is not None:
            self.telemetry.replica_deaths.inc()
        # the dead engine's per-session trace root closes as a failover
        # casualty so its batch spans keep a parent (zero orphans)
        abandon = getattr(rep.engine, "trace_abandon", None)
        if abandon is not None:
            abandon(now)
        for req in rep.inflight.values():
            replay = Request(
                id=req.id, prompt=list(req.prompt),
                max_new_tokens=req.max_new_tokens,
                temperature=req.temperature, top_k=req.top_k,
                top_p=req.top_p, eos_id=req.eos_id, arrival=now)
            backlog.append(replay)
            self.resubmitted_total += 1
            if self.telemetry is not None:
                self.telemetry.resubmits_total.inc()
            rt = self._trace(req.id)
            if rt is not None:
                # ONE trace across replicas: the open hop dies with the
                # replica, the root survives into the replay's fresh
                # queue-wait hop
                rt.event("failover", replica=rep.index)
                rt.abandon(now)
                rt.begin_hop("router.queue_wait", now)
        rep.inflight.clear()

    # -- live topology (the autoscaler's surgical ±1 path) -----------------

    def active_count(self) -> int:
        """Replicas currently accepting new work (alive, not
        draining)."""
        return sum(1 for r in self.replicas
                   if r.alive and not r.draining)

    def _require_warm(self, engine) -> None:
        """The warmup pin: an attaching engine must have its decode step
        built BEFORE it joins (compile_counts()['step'] >= 1: on the card
        the step's CUDA graph is captured at that first call). Warming
        in-band would stall the single-threaded router —
        exactly the goodput the new replica is supposed to buy — so a
        cold engine is refused loudly and the caller warms it
        out-of-band (a pinned-shape request through engine.run()).
        Engines that do not expose compile_counts (test fakes) pass."""
        counts_fn = getattr(engine, "compile_counts", None)
        if counts_fn is None:
            return
        counts = counts_fn()
        if counts.get("step", 0) < 1:
            raise ValueError(
                "attach_replica needs a PRE-WARMED engine (zero step "
                "compiles seen) — run a pinned-shape warmup request "
                "through it out-of-band first")

    def _wire_heartbeat(self, rep: ReplicaHandle) -> None:
        """Install the push-based load reporter on one replica (no-op
        when heartbeats are off, telemetry is absent, or the engine
        does not support it)."""
        cfg = self.config
        tel = self.telemetry
        if tel is None or cfg.heartbeat_interval <= 0:
            return
        setter = getattr(rep.engine, "set_heartbeat", None)
        note = getattr(tel, "note_heartbeat", None)
        if setter is None or note is None:
            return
        idx = rep.index
        setter(lambda **kw: note(idx, **kw), cfg.heartbeat_interval)

    def attach_replica(self, engine: ServingEngine,
                       now: Optional[float] = None,
                       warmup_seconds: float = 0.0) -> ReplicaHandle:
        """Join one PRE-WARMED engine to the fleet — the +1 step. No
        other replica pauses: mid-session the newcomer starts on the
        SHARED session clock and becomes dispatch-eligible immediately
        (the compile pin already happened out-of-band; `warmup_seconds`
        records how long it took, for the live_scale ledger entry).
        Outside a session the handle simply joins the roster and run()
        starts it with the rest."""
        # host-span coverage for the attach path: live-scale stalls
        # (warm check + session join) show up in XProf captures
        with span("router.attach_replica"):
            self._require_warm(engine)
            now = self._now(now)
            idx = max(r.index for r in self.replicas) + 1
            rep = ReplicaHandle(idx, engine)
            self.replicas.append(rep)
            self._share_tracer(engine)
            if self._now_fn is not None:
                engine.start(self._on_token, now_fn=self._now_fn)
                self._wire_heartbeat(rep)
        self.live_scale_log.append({
            "action": "attach", "replica": idx,
            "ts": round(now, 6),
            "drain_seconds": 0.0,
            "warmup_seconds": round(float(warmup_seconds), 6),
            "total_seconds": round(float(warmup_seconds), 6),
            "replicas": self.active_count()})
        if self.telemetry is not None:
            self.telemetry.attach_total.inc()
        return rep

    def detach_replica(self, index: int,
                       now: Optional[float] = None) -> None:
        """Begin the graceful drain of one replica — the -1 step.
        Admission closes IMMEDIATELY (draining replicas are never
        picked); requests the replica had queued behind its slots
        (submitted, not yet admitted) are pulled back and FAILED OVER
        to the survivors through the idempotent replay path — never
        shed — and residents finish in place. Teardown happens in
        _service_drains once the replica goes idle."""
        rep = next((r for r in self.replicas if r.index == index), None)
        if rep is None or not rep.alive:
            raise ValueError(f"no live replica with index {index}")
        if rep.draining:
            return
        if self.active_count() <= 1:
            raise ValueError(
                "cannot detach the last active replica (the autoscaler's "
                "minDecodeReplicas floor exists for the same reason)")
        now = self._now(now)
        rep.draining = True
        rep.drain_started = now
        # pull back everything still queued behind the slots: those
        # requests never touched pages, so re-routing them is pure
        # bookkeeping — the same fresh-Request replay failover uses
        queue = rep.engine.scheduler.queue
        pulled = [q for q in list(queue) if q.id in rep.inflight]
        for q in pulled:
            queue.remove(q)
            del rep.inflight[q.id]
            replay = Request(
                id=q.id, prompt=list(q.prompt),
                max_new_tokens=q.max_new_tokens,
                temperature=q.temperature, top_k=q.top_k,
                top_p=q.top_p, eos_id=q.eos_id,
                arrival=max(q.arrival, now))
            self._backlog.append(replay)
            self.resubmitted_total += 1
            if self.telemetry is not None:
                self.telemetry.resubmits_total.inc()
            rt = self._trace(q.id)
            if rt is not None:
                rt.event("drain_requeue", replica=rep.index)
                rt.abandon(now)
                rt.begin_hop("router.queue_wait", replay.arrival)
        self._backlog.sort(key=lambda r: r.arrival)

    def schedule_attach(self, at: float, engine,
                        warmup_seconds: float = 0.0) -> None:
        """Arm a +1 step at session time `at`. `engine` is the
        pre-warmed engine, or a zero-arg factory returning one (built
        out-of-band — construction cost must not land on the trace
        clock, that is gang-restart's failure mode, not live
        scaling's)."""
        self._scale_plan.append({"at": float(at), "kind": "attach",
                                 "engine": engine,
                                 "warmup_seconds": float(warmup_seconds)})
        self._scale_plan.sort(key=lambda s: s["at"])

    def schedule_detach(self, at: float, index: int) -> None:
        """Arm a -1 step (graceful drain of `index`) at session time
        `at`."""
        self._scale_plan.append({"at": float(at), "kind": "detach",
                                 "index": index})
        self._scale_plan.sort(key=lambda s: s["at"])

    def _execute_scale(self, step: Dict, now: float) -> None:
        if step["kind"] == "attach":
            engine = step["engine"]
            if callable(engine) and not hasattr(engine, "submit"):
                engine = engine()
            self.attach_replica(engine, now=now,
                                warmup_seconds=step["warmup_seconds"])
        else:
            self.detach_replica(step["index"], now=now)

    def _service_drains(self, now: float) -> None:
        """Finish any drain whose replica has gone idle: close its
        session, fan in the last results, VERIFY pages and slots came
        back (PageAllocator.check() plus zero pinned pages and a full
        free-slot list — a leak here is a correctness bug, not a
        capacity nit), and mark it detached."""
        for rep in self.replicas:
            if not (rep.alive and rep.draining):
                continue
            if rep.inflight or rep.engine.active:
                continue
            # host-span coverage for the drain finalize (session close
            # + reclaim audit) — the other half of a live-scale stall
            with span("router.service_drain"):
                self._collect(rep, final=rep.engine.finish())
                self._verify_reclaim(rep)
            rep.alive = False
            rep.draining = False
            rep.detached = True
            drain = max(0.0, now - rep.drain_started)
            self.live_scale_log.append({
                "action": "detach", "replica": rep.index,
                "ts": round(now, 6),
                "drain_seconds": round(drain, 6),
                "warmup_seconds": 0.0,
                "total_seconds": round(drain, 6),
                "replicas": self.active_count()})
            if self.telemetry is not None:
                self.telemetry.detach_total.inc()

    @staticmethod
    def _verify_reclaim(rep: ReplicaHandle) -> None:
        eng = rep.engine
        alloc = getattr(eng, "page_allocator", None)
        if alloc is not None:
            alloc.check()
            if alloc.in_use != 0:
                raise RuntimeError(
                    f"detach leak: replica {rep.index} still pins "
                    f"{alloc.in_use} KV page(s) after drain")
        slots = getattr(eng, "slots", None)
        total = getattr(slots, "n", None)
        if total is not None and len(slots.free) != total:
            raise RuntimeError(
                f"detach leak: replica {rep.index} drained with "
                f"{total - len(slots.free)} slot(s) still bound")

    # -- the loop ---------------------------------------------------------

    def run(self, requests: Sequence[Request] = (),
            on_token: Optional[Callable[[Request, int], None]] = None,
            ) -> Dict[int, RequestResult]:
        """Drive the fleet until every request completes or sheds AND
        every armed scale step has executed (drains included). Same
        contract as ServingEngine.run(): returns
        {request.id: RequestResult}; shed requests appear with
        finish_reason "shed" and no tokens. Replicas that exited by
        graceful detach do NOT poison the router the way failover
        deaths do."""
        if any(not r.alive and not r.detached for r in self.replicas):
            raise RuntimeError("router already consumed (dead replicas)")
        t0 = time.perf_counter()
        now_fn = lambda: time.perf_counter() - t0   # noqa: E731
        self._now_fn = now_fn
        self._on_token = on_token
        for rep in self.replicas:
            if rep.alive:
                rep.engine.start(on_token, now_fn=now_fn)
                self._wire_heartbeat(rep)
        # FCFS dispatch backlog; failover/drain replays append at the
        # tail (held on self so detach_replica can reach it mid-loop)
        backlog = self._backlog = sorted(requests, key=lambda r: r.arrival)
        seen = set()
        for r in backlog:
            if r.id in seen:
                raise ValueError(f"duplicate request id {r.id}")
            seen.add(r.id)
            if self.tracer is not None:
                # ROOT span at the front door, t0 = arrival; the
                # queue-wait hop runs until dispatch closes it
                rt = self.tracer.begin_request(
                    r.id, t0=r.arrival, prompt_len=len(r.prompt),
                    max_new_tokens=r.max_new_tokens)
                if rt is not None:
                    rt.begin_hop("router.queue_wait", r.arrival)
        try:
            while True:
                now = now_fn()
                # due scale steps FIRST: an arrival racing a detach must
                # see the post-step fleet (route to survivors — the
                # failover path's job, not the shed path's)
                while self._scale_plan and self._scale_plan[0]["at"] <= now:
                    self._execute_scale(self._scale_plan.pop(0), now)
                # admit every due arrival this pass (route or shed) —
                # sheds happen at ARRIVAL, never after queueing on a
                # replica
                while backlog and backlog[0].arrival <= now:
                    self._dispatch(backlog.pop(0), now)
                progressed = False
                for rep in self._live():
                    try:
                        progressed |= rep.engine.tick()
                    except Exception as exc:
                        self._fail_replica(rep, now_fn(), backlog, exc)
                        backlog.sort(key=lambda r: r.arrival)
                        continue
                    self._collect(rep)
                self._service_drains(now_fn())
                live = self._live()
                if not live:
                    raise RuntimeError(
                        f"every replica died with {len(backlog)} "
                        f"request(s) outstanding")
                if (not backlog and not self._scale_plan
                        and all(not r.engine.active for r in live)):
                    break
                if not progressed:
                    # everything is waiting on a future arrival or a
                    # future scale step
                    nxt = backlog[0].arrival if backlog else None
                    if self._scale_plan:
                        at = self._scale_plan[0]["at"]
                        nxt = at if nxt is None else min(nxt, at)
                    for rep in live:
                        rn = rep.engine.scheduler.next_arrival()
                        if rn is not None:
                            nxt = rn if nxt is None else min(nxt, rn)
                    now = now_fn()
                    if nxt is not None and nxt > now:
                        time.sleep(min(nxt - now, 0.05))
        finally:
            self._now_fn = None
            self._on_token = None
            self._backlog = []
        out: Dict[int, RequestResult] = {}
        for rep in self.replicas:
            if rep.alive:
                self._collect(rep, final=rep.engine.finish())
        out.update(self.results)
        out.update(self.shed)
        if self.telemetry is not None:
            self.telemetry.requests_total.inc(len(self.results))
        return out

    def _collect(self, rep: ReplicaHandle,
                 final: Optional[Dict[int, RequestResult]] = None) -> None:
        """Fan in newly retired results from one replica. Results key by
        request id — the idempotence point for failover replays (a dead
        replica's partials were dropped with it, so each id lands here
        exactly once)."""
        done = final if final is not None \
            else rep.engine.session_results()
        for rid in [r for r in rep.inflight if r in done]:
            self.results[rid] = done[rid]
            del rep.inflight[rid]

    # -- reporting --------------------------------------------------------

    def affinity_hit_rate(self) -> float:
        """Warm pages / full prompt pages over every dispatched request
        (the prediction made AT dispatch; replica-side
        prefix_hit_pages counters confirm it at admission)."""
        total = self.affinity_hit_pages + self.affinity_miss_pages
        return self.affinity_hit_pages / total if total else 0.0

    def dispatch_counts(self) -> List[int]:
        return [r.dispatched_total for r in self.replicas]

    def shed_count(self) -> int:
        return len(self.shed)

    def dead_replicas(self) -> List[int]:
        """Replicas lost to FAILOVER — voluntary detaches are not
        deaths."""
        return [r.index for r in self.replicas
                if not r.alive and not r.detached]

    def detached_replicas(self) -> List[int]:
        """Replicas that exited by graceful drain (scale-down steps)."""
        return [r.index for r in self.replicas if r.detached]
