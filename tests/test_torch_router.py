"""The port's serving router (serve/router.py) and its RouterTelemetry
against the JAX package's.

Two kinds of replica, both on a fake clock (each router module's `time`
replaced: `perf_counter` reads it, `sleep` advances it, and each replica
tick advances it by a fixed step), so a run's decisions depend on ticks,
never on this machine's speed:

- duck-typed fake engines (each side's own PageAllocator, so affinity
  probes walk each side's keying): every routing decision — which
  replica took each request, sheds, failover replays, drains, attaches,
  heartbeat-driven picks — and every RouterTelemetry series must equal
  the JAX Router's on the same trace;
- real engines at test size (gpt2-test, f32, vocab 64, max_len 64, pages
  of 8, two slots a replica): the port's Router over port engines
  against the JAX Router over JAX engines (same dispatch, same predicted
  and replica-measured prefix hits) and against one port engine (the
  same greedy tokens); affinity beats load-only dispatch on a
  multi-tenant trace; a live attach and a graceful drain lose no request
  and leak no page; a cold engine is refused.
"""
import functools
import logging

import numpy as np
import pytest
import torch
from test_torch_serve import _pair

from mpi_operator_tpu.serve import EngineConfig as JEngineConfig
from mpi_operator_tpu.serve import Router as JRouter
from mpi_operator_tpu.serve import RouterConfig as JRouterConfig
from mpi_operator_tpu.serve import ServingEngine as JServingEngine
from mpi_operator_tpu.serve import router as jrouter_mod
from mpi_operator_tpu.serve.engine import RequestResult as JResult
from mpi_operator_tpu.serve.scheduler import Request as JRequest
from mpi_operator_tpu.serve.slots import PageAllocator as JAllocator
from mpi_operator_tpu.serve.slots import prefix_chain_windows as j_windows
from mpi_operator_tpu.telemetry.prometheus import render_registry as j_render
from mpi_operator_tpu.telemetry.worker import RouterTelemetry as JRouterTel
from mpi_operator_tpu_torch.serve import (EngineConfig, Request, Router,
                                          RouterConfig, ServingEngine)
from mpi_operator_tpu_torch.serve import router as trouter_mod
from mpi_operator_tpu_torch.serve.engine import RequestResult
from mpi_operator_tpu_torch.serve.slots import PageAllocator
from mpi_operator_tpu_torch.serve.slots import prefix_chain_windows
from mpi_operator_tpu_torch.telemetry import RouterTelemetry
from mpi_operator_tpu_torch.telemetry.prometheus import render_registry

torch.set_num_threads(1)   # six test processes share the CPU (xdist -n 6)

V = 64

#: each side's router module, types and telemetry
SIDES = {
    "jax": dict(mod=jrouter_mod, Router=JRouter, Config=JRouterConfig,
                Request=JRequest, Result=JResult, Alloc=JAllocator,
                windows=j_windows, Tel=JRouterTel, render=j_render),
    "torch": dict(mod=trouter_mod, Router=Router, Config=RouterConfig,
                  Request=Request, Result=RequestResult, Alloc=PageAllocator,
                  windows=prefix_chain_windows, Tel=RouterTelemetry,
                  render=render_registry),
}


class FakeTime:
    """A router module's `time`: perf_counter reads the clock, sleep
    advances it; replica ticks advance it by `advance`."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t

    def sleep(self, d):
        self.t += max(d, 1e-3)

    def advance(self, d):
        self.t += d


@pytest.fixture
def clock(monkeypatch):
    fake = FakeTime()
    for side in SIDES.values():
        monkeypatch.setattr(side["mod"], "time", fake)
    return fake


def _publish_chain(side, alloc, prompt):
    """Publish `prompt`'s complete pages the way prefill does."""
    parent = -1
    for window in side["windows"](prompt, alloc.page_size):
        key = (parent, window)
        page = alloc._cache.get(key)
        if page is None:
            page = alloc.alloc()
            assert alloc.publish(page, parent, window)
            alloc.release(page)
        parent = alloc._cache[key]


class _Scheduler:
    def __init__(self):
        self.queue = []

    def next_arrival(self):
        return None


class _Slots:
    def __init__(self, n):
        self.n = n
        self.free = list(range(n))


class FakeEngine:
    """The steppable session surface of a ServingEngine: submissions
    queue until one of `concurrent` lanes frees, retire after
    `service_ticks` ticks with a deterministic token, and publish their
    prompt pages as a prefill would. `step_compiles` is what
    compile_counts() reports; after `die_after` ticks, tick raises (a
    replica death); set_heartbeat reports load on the fake clock."""

    def __init__(self, side, clock, service_ticks=2, concurrent=2,
                 step_compiles=1, die_after=None, dt=0.01):
        self.side, self.clock, self.dt = SIDES[side], clock, dt
        self.page_allocator = self.side["Alloc"](65, 8)
        self.scheduler = _Scheduler()
        self.slots = _Slots(4)
        self.service_ticks, self.concurrent = service_ticks, concurrent
        self.step_compiles, self.die_after = step_compiles, die_after
        self.submitted, self.ticks = [], 0
        self._work, self._results, self._hb = {}, {}, None

    def compile_counts(self):
        return {"step": self.step_compiles, "prefill": 0}

    def start(self, on_token=None, now_fn=None):
        self._results = {}

    def submit(self, req):
        self.submitted.append(req.id)
        self.scheduler.queue.append(req)

    def set_heartbeat(self, hook, interval):
        self._hb = [hook, interval, None]

    @property
    def active(self):
        return bool(self._work or self.scheduler.queue)

    def tick(self):
        self.ticks += 1
        if self.die_after is not None and self.ticks > self.die_after:
            raise IOError("injected replica death")
        self.clock.advance(self.dt)
        if self._hb is not None:
            hook, interval, last = self._hb
            if last is None or self.clock.t - last >= interval:
                self._hb[2] = self.clock.t
                hook(now=self.clock.t, queue_depth=len(self.scheduler.queue),
                     free_slots=self.concurrent - len(self._work),
                     free_pages=self.page_allocator.available)
        q = self.scheduler.queue
        while q and len(self._work) < self.concurrent:
            req = q.pop(0)
            self._work[req.id] = [req, self.service_ticks]
        if not self._work:
            return False
        for rid in list(self._work):
            self._work[rid][1] -= 1
            if self._work[rid][1] <= 0:
                req, _ = self._work.pop(rid)
                _publish_chain(self.side, self.page_allocator, req.prompt)
                self._results[rid] = self.side["Result"](
                    id=rid, tokens=[sum(req.prompt) % 97], logprobs=[],
                    finish_reason="eos", ttft=0.0,
                    token_times=[self.clock.t], cached_tokens=0,
                    admitted_at=0.0)
        return True

    def session_results(self):
        return self._results

    def finish(self):
        return self._results


def _fake_without_counts(side, clock):
    """A replica with no compile_counts: the warm-up pin lets it pass."""
    eng = FakeEngine(side, clock)
    eng.compile_counts = None
    return eng


def _tenant_trace(side, n=12, tenants=3, gap=0.05, seed=0, prefix=16,
                  tails=(3, 6), news=(3, 5)):
    """Round-robin tenants, each a seeded `prefix`-token system prompt,
    plus a per-request tail; arrivals `gap` apart."""
    rs = np.random.RandomState(seed)
    heads = [[int(t) for t in rs.randint(1, V, (prefix,))]
             for _ in range(tenants)]
    out = []
    for i in range(n):
        tail = [int(t) for t in rs.randint(1, V, (int(rs.choice(tails)),))]
        out.append(SIDES[side]["Request"](
            id=i, prompt=heads[i % tenants] + tail,
            max_new_tokens=int(rs.choice(news)), arrival=i * gap))
    return out


def _decisions(router, fakes, out):
    """Everything a routing run decided, comparable across the sides."""
    return dict(
        dispatch=router.dispatch_counts(), shed=router.shed_count(),
        submitted=[list(f.submitted) for f in fakes],
        resubmitted=router.resubmitted_total,
        dead=router.dead_replicas(), detached=router.detached_replicas(),
        live_scale=[{k: v for k, v in e.items()} for e in
                    router.live_scale_log],
        hit_pages=router.affinity_hit_pages,
        miss_pages=router.affinity_miss_pages,
        results={rid: (r.finish_reason, list(r.tokens))
                 for rid, r in sorted(out.items())})


def _scenario(name, side, clock):
    """(router, fakes, requests) of a named routing scenario on `side`."""
    S = SIDES[side]

    def req(i, prompt, arrival=0.0):
        return S["Request"](id=i, prompt=list(prompt), max_new_tokens=4,
                            arrival=arrival)

    tel = S["Tel"]()
    if name == "affinity":
        fakes = [FakeEngine(side, clock) for _ in range(2)]
        router = S["Router"](fakes, S["Config"](), telemetry=tel)
        reqs = _tenant_trace(side)
    elif name == "load-only":
        fakes = [FakeEngine(side, clock) for _ in range(2)]
        router = S["Router"](fakes, S["Config"](affinity=False),
                             telemetry=tel)
        reqs = _tenant_trace(side)
    elif name == "shed-burst":
        fakes = [FakeEngine(side, clock, concurrent=1) for _ in range(2)]
        router = S["Router"](fakes, S["Config"](max_inflight=1),
                             telemetry=tel)
        reqs = ([req(i, [10 + i, 11 + i, 12 + i]) for i in range(5)]
                + [req(100 + i, [50 + i, 51 + i], 1.0) for i in range(2)])
    elif name == "too-large":
        fakes = [FakeEngine(side, clock)]
        fakes[0].page_allocator = S["Alloc"](3, 8)
        router = S["Router"](fakes, S["Config"](), telemetry=tel)
        reqs = [req(0, list(range(40))), req(1, [1, 2, 3])]
    elif name == "failover":
        fakes = [FakeEngine(side, clock, service_ticks=3, die_after=2),
                 FakeEngine(side, clock, service_ticks=3)]
        router = S["Router"](fakes, S["Config"](), telemetry=tel)
        reqs = [req(i, [20 + i, 21 + i, 22 + i], 0.01 * i) for i in range(6)]
    elif name == "heartbeat-failover":
        fakes = [FakeEngine(side, clock, concurrent=1, die_after=6),
                 FakeEngine(side, clock, concurrent=1),
                 FakeEngine(side, clock, concurrent=1)]
        router = S["Router"](fakes, S["Config"](
            affinity=False, heartbeat_interval=0.02), telemetry=tel)
        reqs = [req(i, [30 + i, 31 + i], 0.015 * i) for i in range(9)]
    elif name == "drain":
        fakes = [FakeEngine(side, clock, concurrent=1) for _ in range(2)]
        router = S["Router"](fakes, S["Config"](), telemetry=tel)
        router.schedule_detach(0.02, 0)
        reqs = [req(i, [30 + i, 31 + i, 32 + i]) for i in range(6)]
    elif name == "attach":
        fakes = [FakeEngine(side, clock)]
        newcomer = FakeEngine(side, clock)
        router = S["Router"](fakes, S["Config"](max_inflight=2),
                             telemetry=tel)
        router.schedule_attach(0.0, newcomer, warmup_seconds=0.125)
        fakes.append(newcomer)
        reqs = [req(i, [40 + i, 41 + i]) for i in range(4)]
    elif name == "scale-cycle":
        fakes = [FakeEngine(side, clock) for _ in range(2)]
        newcomer = FakeEngine(side, clock)
        router = S["Router"](fakes, S["Config"](), telemetry=tel)
        router.schedule_attach(0.1, lambda: newcomer, warmup_seconds=0.25)
        router.schedule_detach(0.3, 0)
        fakes.append(newcomer)
        reqs = _tenant_trace(side, n=12, gap=0.04)
    else:
        raise KeyError(name)
    return router, fakes, reqs, tel


SCENARIOS = ["affinity", "load-only", "shed-burst", "too-large", "failover",
             "heartbeat-failover", "drain", "attach", "scale-cycle"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_decisions_and_telemetry_equal_jax(name, clock):
    """Every decision of the same scenario, and every RouterTelemetry
    series it fed (names, labels and values, rendered), equal the JAX
    Router's."""
    seen = {}
    for side in ("jax", "torch"):
        clock.t = 0.0
        router, fakes, reqs, tel = _scenario(name, side, clock)
        out = router.run(reqs)
        assert set(out) == {r.id for r in reqs}
        seen[side] = (_decisions(router, fakes, out),
                      SIDES[side]["render"](tel.registry))
    assert seen["torch"][0] == seen["jax"][0]
    assert seen["torch"][1] == seen["jax"][1]


@pytest.mark.parametrize("name", ["failover", "heartbeat-failover"])
def test_failover_logs_the_error_it_absorbed(name, clock, caplog):
    """A replica whose tick raised is failed over and its requests
    replayed, and the error is logged with its traceback, not
    swallowed."""
    clock.t = 0.0
    router, _, reqs, _ = _scenario(name, "torch", clock)
    with caplog.at_level(logging.ERROR,
                         logger="mpi_operator_tpu_torch.serve.router"):
        router.run(reqs)
    recs = [r for r in caplog.records
            if r.name == "mpi_operator_tpu_torch.serve.router"]
    assert router.dead_replicas() == [0]
    assert len(recs) == 1 and recs[0].exc_info is not None
    assert recs[0].getMessage().startswith("replica 0 failed")


def test_scenarios_exercise_their_paths(clock):
    """The scenarios above reach what they are named for."""
    def run(name):
        clock.t = 0.0
        router, fakes, reqs, _ = _scenario(name, "torch", clock)
        return router, router.run(reqs)

    r, out = run("shed-burst")
    assert r.shed_count() >= 1
    assert all(out[i].finish_reason == "eos" for i in (100, 101))
    r, _ = run("failover")
    assert r.dead_replicas() == [0] and r.resubmitted_total >= 1
    r, _ = run("heartbeat-failover")
    assert r.dead_replicas() == [0]
    r, out = run("drain")
    assert r.detached_replicas() == [0] and r.shed_count() == 0
    assert r.resubmitted_total >= 1
    r, _ = run("scale-cycle")
    assert [e["action"] for e in r.live_scale_log] == ["attach", "detach"]
    aff, _ = run("affinity")
    assert aff.affinity_hit_pages > 0


def test_router_telemetry_series_equal_jax():
    """Every RouterTelemetry instrument, fed the same values, renders to
    the same exposition text (series names, help, labels, values)."""
    texts = []
    for side in ("jax", "torch"):
        tel = SIDES[side]["Tel"](labels={"job": "fleet"})
        tel.shed_total.inc(2)
        tel.requests_total.inc(7)
        tel.resubmits_total.inc()
        tel.replica_deaths.inc()
        tel.affinity_hit_pages.inc(5)
        tel.affinity_miss_pages.inc(3)
        tel.attach_total.inc()
        tel.detach_total.inc()
        for v in (1e-4, 2e-3, 0.5):
            tel.queue_wait_seconds.observe(v)
        tel.dispatch_for(0).inc(4)
        tel.dispatch_for(2).inc(3)
        tel.note_heartbeat(1, now=0.25, queue_depth=2, free_slots=1,
                           free_pages=17)
        assert tel.heartbeat(1) == {"now": 0.25, "queue_depth": 2.0,
                                    "free_slots": 1.0, "free_pages": 17.0}
        assert tel.heartbeat(0) is None
        texts.append(SIDES[side]["render"](tel.registry))
    assert texts[0] == texts[1]
    assert "tpu_router_dispatch_total" in texts[1]


def test_policy_edges(clock):
    """The router's guards, as the reference's."""
    with pytest.raises(ValueError):
        Router([], RouterConfig())
    with pytest.raises(ValueError):
        Router([FakeEngine("torch", clock)], RouterConfig(max_inflight=0))
    router = Router([FakeEngine("torch", clock)], RouterConfig())
    with pytest.raises(ValueError, match="duplicate request id"):
        router.run([Request(7, [1, 2], 2), Request(7, [3, 4], 2)])
    router = Router([FakeEngine("torch", clock), FakeEngine("torch", clock)])
    with pytest.raises(ValueError, match="no live replica"):
        router.detach_replica(7)
    router.replicas[1].alive = False
    with pytest.raises(ValueError, match="last active replica"):
        router.detach_replica(0)
    with pytest.raises(ValueError, match="PRE-WARMED"):
        router.attach_replica(FakeEngine("torch", clock, step_compiles=0))
    router.attach_replica(_fake_without_counts("torch", clock))
    dead = [FakeEngine("torch", clock, die_after=0) for _ in range(2)]
    with pytest.raises(RuntimeError, match="every replica died"):
        Router(dead).run([Request(0, [1, 2, 3], 2)])


# ---------------------------------------------------------------------------
# real engines (test size)
# ---------------------------------------------------------------------------

ECFG = dict(slots=2, chunk_buckets=(8, 32), paged=True, page_size=8)
DT = 0.01


@functools.lru_cache(maxsize=None)
def _models():
    return _pair("gpt2")


def _ticking(engine, clock):
    """Each tick of `engine` advances the fake clock by DT."""
    real = engine.tick

    def tick():
        out = real()
        clock.advance(DT)
        return out
    engine.tick = tick
    return engine


def _port_engine(clock, warm=True):
    _, _, tm = _models()
    eng = ServingEngine(tm, EngineConfig(**ECFG), device="cpu")
    if warm:
        eng.run([Request(10_000, list(range(1, 18)), 2)])
        eng.reset()
    return _ticking(eng, clock)


def _jax_engine(clock):
    jm, params, _ = _models()
    eng = JServingEngine(jm, params, JEngineConfig(**ECFG))
    return _ticking(eng, clock)


def _oracle(trace):
    """One port engine over the whole trace, all requests waiting."""
    _, _, tm = _models()
    eng = ServingEngine(tm, EngineConfig(**ECFG), device="cpu")
    return {rid: r.tokens for rid, r in eng.run(
        [Request(r.id, list(r.prompt), r.max_new_tokens)
         for r in trace]).items()}


def _fresh(side, trace):
    return [SIDES[side]["Request"](r.id, list(r.prompt), r.max_new_tokens,
                                   arrival=r.arrival) for r in trace]


def _hits(router):
    a = [rep.engine.page_allocator for rep in router.replicas]
    hits, miss = sum(x.hits for x in a), sum(x.misses for x in a)
    return hits, hits / max(hits + miss, 1)


def _audit(router):
    for rep in router.replicas:
        alloc = rep.engine.page_allocator
        alloc.check()
        assert alloc.in_use == 0
        assert len(rep.engine.slots.free) == rep.engine.slots.n


def test_real_fleet_equals_jax_router_and_one_engine(clock):
    """Two port replicas behind the port's Router against two JAX
    replicas behind the JAX Router on the same multi-tenant trace and
    clock: the same dispatch, the same predicted and replica-measured
    prefix hits, the same greedy tokens — equal to one port engine's.
    Affinity then beats load-only dispatch on replica-measured hits."""
    trace = _tenant_trace("torch", n=10, tenants=3, gap=0.05)
    runs = {}
    for side, mk in (("jax", _jax_engine), ("torch", _port_engine)):
        clock.t = 0.0
        S = SIDES[side]
        router = S["Router"]([mk(clock) for _ in range(2)], S["Config"]())
        out = router.run(_fresh(side, trace))
        runs[side] = (router, out)
    (jr, jout), (tr, tout) = runs["jax"], runs["torch"]
    assert tr.dispatch_counts() == jr.dispatch_counts()
    assert tr.affinity_hit_pages == jr.affinity_hit_pages > 0
    assert _hits(tr) == _hits(jr)
    assert tr.affinity_hit_pages == _hits(tr)[0]
    oracle = _oracle(trace)
    for r in trace:
        assert tout[r.id].tokens == oracle[r.id] == jout[r.id].tokens
    _audit(tr)
    clock.t = 0.0
    off = Router([_port_engine(clock) for _ in range(2)],
                 RouterConfig(affinity=False))
    off_out = off.run(_fresh("torch", trace))
    assert all(off_out[r.id].tokens == oracle[r.id] for r in trace)
    assert _hits(tr)[1] > _hits(off)[1]


def test_live_attach_and_drain_lose_nothing(clock):
    """A +1 step (a warm engine attaches mid-trace) and a -1 step
    (replica 0 drains) on real engines: no request dropped or shed,
    tokens equal to one engine's, every replica's pages and slots back
    (the router audits the drained one; the test audits the rest). A
    cold engine is refused, and a draining replica takes no new
    request."""
    trace = _tenant_trace("torch", n=12, tenants=3, gap=0.04)
    router = Router([_port_engine(clock) for _ in range(2)], RouterConfig())
    with pytest.raises(ValueError, match="PRE-WARMED"):
        router.attach_replica(_port_engine(clock, warm=False))
    newcomer = _port_engine(clock)
    router.schedule_attach(0.1, newcomer, warmup_seconds=0.5)
    router.schedule_detach(0.25, 0)
    dispatched_at_drain = {}
    real = router.detach_replica

    def detach(index, now=None):
        real(index, now=now)
        dispatched_at_drain[index] = router.replicas[index].dispatched_total
    router.detach_replica = detach
    clock.t = 0.0
    out = router.run(_fresh("torch", trace))
    assert set(out) == {r.id for r in trace}
    assert router.shed_count() == 0
    assert all(out[r.id].finish_reason == "length" for r in trace)
    oracle = _oracle(trace)
    assert all(out[r.id].tokens == oracle[r.id] for r in trace)
    assert router.detached_replicas() == [0] and router.dead_replicas() == []
    assert [e["action"] for e in router.live_scale_log] == ["attach",
                                                            "detach"]
    assert router.replicas[0].dispatched_total == dispatched_at_drain[0]
    assert newcomer.compile_counts()["step"] == 1     # nothing new built
    assert router.replicas[2].dispatched_total > 0
    _audit(router)
