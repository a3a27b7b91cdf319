"""Per-request distributed tracing: span trees from front door to
final token.

The PyTorch port's own copy of mpi_operator_tpu/telemetry/trace.py:
the port imports nothing of the JAX package, not even its
framework-free modules. Its logic and names are the reference's,
held to it by tests/test_torch_telemetry.py.

Every other telemetry signal in this repo is an aggregate — federated
`tpu_job_*` histograms, counters, the merged timeline. When the
`DecodeAutoscaler` sees a TTFT p99 breach, aggregates cannot answer
"which requests were slow, and in which hop". This module adds the
missing per-request layer: a lightweight tracer whose span records
thread through the whole serving path (router queue → admission →
prefill → KV handoff → decode), federate like everything else, and
attach to SLO-breach incidents as exemplars.

Design constraints, in order:

1. **Off-path when sampled out.** `begin_request` on an unsampled
   trace id is ONE integer hash against a precomputed threshold and
   returns None before any allocation — pinned by a unit test. Serving
   hot loops pay nothing for traces they don't keep.
2. **Hop durations sum to end-to-end latency.** A request trace is a
   chain of contiguous "hops": `begin_hop(name, t0)` closes the
   currently-open hop AT `t0` and opens the next, so there are no gaps
   or overlaps by construction and `sum(hop.seconds) == retire - t0`
   exactly on the session clock. The router benchmark gates on this.
3. **One root per request id, across replicas.** The tracer owns the
   registry of open request traces keyed by trace id (= request id);
   `begin_request` returns the existing trace when the id is already
   open, so a failover replay — a fresh `Request` object with the SAME
   id dispatched to a different replica — continues the ONE trace it
   already has. Failovers/sheds land as span events on that root.
4. **Crash-durable sink.** Span records reuse the events.EventLog
   discipline: one fsync'd JSON line per completed span, tolerant
   torn-tail reads, size-based rotation. A mid-kill loses at most the
   last line; everything already retired is attributable post-mortem.

Record schema (one line per COMPLETED span in `traces.jsonl`):

    {"ts": <wall clock at write>, "event": "span",
     "trace": <trace id = request id; negative for engine sessions>,
     "span": <span id, unique per tracer>, "parent": <span id|null>,
     "name": "serve.prefill", "t0": <session-clock start>,
     "seconds": <duration>, "status": "ok|timeout|shed|failover",
     "attrs": {...}, "events": [{"name": "failover", ...}, ...]}

`t0`/`seconds` are session-clock (monotonic, shared by the router and
every replica it drives) so durations and intra-pod ordering are
exact; `ts` is wall clock so the collector's ClockSync correction can
order spans across pods the same way it orders events.

Span taxonomy (the profiler and NVTX ranges of telemetry/spans.py use the
same names from the same call sites, so host traces and span trees
agree):

    serve.request            root, t0 = arrival, status terminal
      router.queue_wait      arrival → router dispatch decision
      serve.admission        dispatch → scheduler admits (slot bound)
      serve.prefill          admission → last prompt chunk landed
      serve.kv_handoff       disagg only: prefill done → pages moved
                             into the decode pool (attrs: pages,
                             cached_pages)
      serve.decode           first decode-eligible moment → retire
    serve.session            per-engine root (negative trace id)
      serve.decode_step      one dispatched decode batch (attr: batch)
      serve.verify_step      one spec-decode verify batch (attrs:
                             accepted, proposed)
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Deque, Dict, Iterable, List, Optional, Tuple

from .events import EventLog, read_events

# Event kind for span records: trace sinks ARE event logs, so the
# torn-tail-tolerant reader, rotation, and shell greps all apply.
SPAN = "span"

# Root span names. Request roots are per-request (trace id >= 0);
# session roots are per-engine-session (negative synthetic trace id)
# and parent the batch-level decode/verify spans, which have no single
# owning request.
REQUEST_ROOT = "serve.request"
SESSION_ROOT = "serve.session"

# Histogram buckets for the federated per-hop latency breakdown
# (`tpu_job_trace_hop_seconds{hop=...}`): serving hops span ~100us
# page copies to multi-second decode tails.
TRACE_HOP_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer: a deterministic 64-bit mix of the trace
    id. Used instead of hash() so head-sampling decisions are stable
    across processes/PYTHONHASHSEED — every pod keeps the SAME subset
    of trace ids, which is what makes cross-pod trees reconstructable
    for sampled traces."""
    x &= _MASK64
    x = ((x ^ (x >> 33)) * 0xFF51AFD7ED558CCD) & _MASK64
    x = ((x ^ (x >> 33)) * 0xC4CEB9FE1A85EC53) & _MASK64
    return x ^ (x >> 33)


class RequestTrace:
    """The open span tree of ONE in-flight request.

    A chain of contiguous hops under a single root: `begin_hop` closes
    the open hop at the new hop's t0 (no gaps, no overlaps — durations
    sum to end-to-end), `finish` closes the last hop and the root with
    the terminal status, `abandon` closes the open hop as a failover
    casualty while leaving the root open for the replay. Completed
    hops are emitted to the sink immediately; the root is emitted at
    finish, which is also when the tracer registry forgets the id.
    """

    __slots__ = ("_tracer", "trace", "root_id", "t0", "attrs",
                 "_events", "_hop", "_edge", "done", "status")

    def __init__(self, tracer: "Tracer", trace: int, t0: float,
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.trace = trace
        self.root_id = tracer._next_span_id()
        self.t0 = t0
        self.attrs = attrs
        self._events: List[Dict[str, Any]] = []
        # open hop: [name, t0, attrs] or None
        self._hop: Optional[List[Any]] = None
        # the trailing edge of the hop chain: where the last hop closed
        # (= where an implicit next hop begins); starts at arrival
        self._edge = t0
        self.done = False
        self.status: Optional[str] = None

    def event(self, name: str, **attrs) -> None:
        """Attach a point-in-time event (shed/failover/dispatch/...)
        to the root span."""
        self._events.append({"name": name, **attrs})

    def hop_attrs(self, **attrs) -> None:
        """Merge attributes into the currently open hop (e.g. page
        counts onto serve.kv_handoff before the decode hop opens)."""
        if self._hop is not None:
            self._hop[2].update(attrs)

    def _close_hop(self, t1: float, status: str) -> None:
        if self._hop is None:
            self._edge = max(self._edge, t1)
            return
        name, h0, attrs = self._hop
        self._hop = None
        self._edge = max(h0, t1)
        self._tracer._record(self.trace, self._tracer._next_span_id(),
                             self.root_id, name, h0,
                             max(0.0, t1 - h0), status, attrs)

    def begin_hop(self, name: str, t0: Optional[float] = None,
                  **attrs) -> None:
        """Open the next hop at `t0`, closing the open one there.

        t0=None means "wherever the previous hop ended" (or the root
        t0 when this is the first hop) — the contiguity default used
        when the caller has no better clock reading than "immediately
        after the previous stage"."""
        if self.done:
            return
        if t0 is None:
            t0 = self._hop[1] if self._hop is not None else self._edge
        self._close_hop(t0, "ok")
        self._hop = [name, t0, dict(attrs)]

    def abandon(self, now: float, status: str = "failover") -> None:
        """The replica serving this request died (or drained): close
        the open hop with `status`, keep the root open — the router's
        replay continues THIS trace on the surviving replica."""
        self._close_hop(now, status)

    def finish(self, status: str, t1: float) -> None:
        """Terminal: close the open hop and the root with `status`
        (ok / timeout / shed / failover) and emit the root record.
        Idempotent — the first terminal status wins, matching the
        router's collect-once-per-request-id discipline."""
        if self.done:
            return
        self.done = True
        self.status = status
        self._close_hop(t1, status)
        self._tracer._record(self.trace, self.root_id, None,
                             REQUEST_ROOT, self.t0,
                             max(0.0, t1 - self.t0), status, self.attrs,
                             self._events or None)
        self._tracer._requests.pop(self.trace, None)


class SessionSpan:
    """Per-engine-session root for batch-level spans.

    Decode steps and spec-verify batches serve MANY requests at once,
    so they cannot parent under any single request root. Each engine
    session instead opens one synthetic root (negative trace id, so it
    can never collide with a request id) and records each dispatched
    batch as a child at sync time. `end` closes it normally; `abandon`
    closes it as a failover casualty when the router kills the replica
    mid-session — either way the root is always emitted, so batch
    children are never orphaned."""

    __slots__ = ("_tracer", "trace", "span_id", "t0", "attrs", "done")

    def __init__(self, tracer: "Tracer", t0: float,
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.trace = -tracer._next_session_id()
        self.span_id = tracer._next_span_id()
        self.t0 = t0
        self.attrs = attrs
        self.done = False

    def child(self, name: str, t0: float, seconds: float,
              **attrs) -> None:
        if not self.done:
            self._tracer._record(self.trace,
                                 self._tracer._next_span_id(),
                                 self.span_id, name, t0,
                                 max(0.0, seconds), "ok", attrs)

    def end(self, t1: float, status: str = "ok") -> None:
        if self.done:
            return
        self.done = True
        self._tracer._record(self.trace, self.span_id, None,
                             SESSION_ROOT, self.t0,
                             max(0.0, t1 - self.t0), status, self.attrs)

    def abandon(self, t1: float) -> None:
        self.end(t1, status="failover")


class Tracer:
    """Head-sampling request tracer with a bounded ring and an
    optional fsync'd JSONL sink.

    `sample` is the head-sampling rate, decided PER TRACE ID by a
    deterministic 64-bit hash against a precomputed threshold: the
    sampled-out path is one integer mix + compare, no allocation, and
    every process keeping rate-p traces keeps the SAME ids.
    `force_sample(id)` overrides the hash for ids a breach handler
    wants kept regardless of rate. `path=None` keeps spans only in the
    in-memory ring (bench percentiles); with a path, every completed
    span is one fsync'd line in `traces.jsonl`."""

    def __init__(self, path: Optional[str] = None, sample: float = 1.0,
                 ring: int = 8192, clock=None):
        self.sample = sample
        # threshold in hash space: sample=1.0 keeps everything without
        # ever consulting the hash; 0.0 keeps only forced ids
        self._threshold = int(min(max(sample, 0.0), 1.0) * (_MASK64 + 1))
        self._forced: set = set()
        self._log: Optional[EventLog] = \
            EventLog(path, **({"clock": clock} if clock else {})) \
            if path else None
        self.ring: Deque[Dict[str, Any]] = collections.deque(maxlen=ring)
        self._lock = threading.Lock()
        self._span_seq = 0
        self._session_seq = 0
        self._requests: Dict[int, RequestTrace] = {}

    # -- sampling ---------------------------------------------------------
    def sampled(self, trace_id: int) -> bool:
        """The off-path check: hash + compare, nothing else."""
        if self._threshold > _MASK64:
            return True
        return (trace_id in self._forced
                or _mix64(trace_id) < self._threshold)

    def force_sample(self, trace_id: int) -> None:
        """Keep this id regardless of the sampling rate — the hook a
        breach handler uses to guarantee its exemplar exists next
        window."""
        self._forced.add(trace_id)

    # -- request traces ---------------------------------------------------
    def begin_request(self, trace_id: int, t0: float,
                      **attrs) -> Optional[RequestTrace]:
        """Open (or join) the trace for `trace_id`.

        Returns the EXISTING open trace when the id is already live —
        the router opened it at intake, or this is a failover replay —
        so root ownership is simply "whoever asked first". Returns
        None without allocating when the id is sampled out."""
        rt = self._requests.get(trace_id)
        if rt is not None:
            return rt
        if not self.sampled(trace_id):
            return None
        rt = RequestTrace(self, trace_id, t0, dict(attrs))
        self._requests[trace_id] = rt
        return rt

    def active(self, trace_id: int) -> Optional[RequestTrace]:
        """The open trace for `trace_id`, or None (finished, sampled
        out, or never begun)."""
        return self._requests.get(trace_id)

    def begin_session(self, t0: float, **attrs) -> SessionSpan:
        """Open a per-engine-session root for batch-level spans."""
        return SessionSpan(self, t0, dict(attrs))

    # -- plumbing ---------------------------------------------------------
    def _next_span_id(self) -> int:
        with self._lock:
            self._span_seq += 1
            return self._span_seq

    def _next_session_id(self) -> int:
        with self._lock:
            self._session_seq += 1
            return self._session_seq

    def _record(self, trace: int, span: int, parent: Optional[int],
                name: str, t0: float, seconds: float, status: str,
                attrs: Dict[str, Any],
                events: Optional[List[Dict[str, Any]]] = None) -> None:
        rec: Dict[str, Any] = {
            "trace": trace, "span": span, "parent": parent,
            "name": name, "t0": round(t0, 6),
            "seconds": round(seconds, 6), "status": status,
        }
        if attrs:
            rec["attrs"] = attrs
        if events:
            rec["events"] = events
        self.ring.append(rec)
        if self._log is not None:
            self._log.emit(SPAN, **rec)

    @property
    def path(self) -> Optional[str]:
        return self._log.path if self._log is not None else None

    def open_requests(self) -> List[int]:
        """Trace ids begun but not yet finished — the completeness
        invariant the chaos leg asserts drains to empty."""
        return list(self._requests)

    def close(self) -> None:
        if self._log is not None:
            self._log.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# A shared do-nothing check for "is tracing even on": call sites guard
# with `if tracer is not None and (rt := tracer.begin_request(...))`.


# -- reading + analysis ---------------------------------------------------

def read_trace_spans(path: str) -> List[Dict[str, Any]]:
    """All span records from a traces.jsonl chain (rotated generations
    included), torn tails skipped — the same tolerant read discipline
    as the event log, because it IS an event log."""
    return read_events(path, kind=SPAN)


def build_trees(spans: Iterable[Dict[str, Any]]
                ) -> Dict[int, Dict[str, Any]]:
    """Group spans into {trace_id: {"root": span|None, "spans": [...]}}.

    Duplicate (trace, span) records — a file re-read, a federated
    re-ingest — keep the first occurrence only, which is also the
    failover-dedup guarantee: one root record per request id no matter
    how many replicas touched it."""
    trees: Dict[int, Dict[str, Any]] = {}
    seen: set = set()
    for s in spans:
        key = (s.get("trace"), s.get("span"))
        if key in seen:
            continue
        seen.add(key)
        t = trees.setdefault(s["trace"], {"root": None, "spans": []})
        t["spans"].append(s)
        if s.get("parent") is None:
            t["root"] = s
    for t in trees.values():
        t["spans"].sort(key=lambda s: (s.get("t0", 0.0), s.get("span", 0)))
    return trees


def hop_spans(spans: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Request hops only: children of request roots (trace >= 0),
    excluding session batch spans and the roots themselves."""
    return [s for s in spans
            if s.get("trace", -1) >= 0 and s.get("parent") is not None]


def hop_name(span: Dict[str, Any]) -> str:
    """Short hop label for metric dimensions: the span name minus its
    component prefix ("router.queue_wait" -> "queue_wait")."""
    return span.get("name", "").rsplit(".", 1)[-1]


def trace_sum_gap(tree: Dict[str, Any]) -> Optional[float]:
    """|sum(hop seconds) - root seconds| for one trace, or None when
    the tree has no root. Contiguous hops make this ~0 (float noise)
    on a single clock; cross-pod it is bounded by the clock-correction
    tolerance."""
    root = tree.get("root")
    if root is None:
        return None
    hops = [s for s in tree["spans"] if s.get("parent") is not None]
    return abs(sum(s.get("seconds", 0.0) for s in hops)
               - root.get("seconds", 0.0))


def orphan_spans(spans: Iterable[Dict[str, Any]]
                 ) -> List[Dict[str, Any]]:
    """Spans whose trace never recorded a root — the invariant the
    mid-trace replica-kill chaos leg drives to zero."""
    out: List[Dict[str, Any]] = []
    for tree in build_trees(spans).values():
        if tree["root"] is None:
            out.extend(tree["spans"])
    return out


def hop_percentiles(spans: Iterable[Dict[str, Any]],
                    ps: Tuple[int, ...] = (50, 99)
                    ) -> Dict[str, float]:
    """{"<hop>_p50_ms": ..., "<hop>_p99_ms": ...} across all request
    hops — the per-hop breakdown bench.py folds into its serving-leg
    JSONL records."""
    by_hop: Dict[str, List[float]] = {}
    for s in hop_spans(spans):
        by_hop.setdefault(hop_name(s), []).append(s.get("seconds", 0.0))
    out: Dict[str, float] = {}
    for hop, xs in sorted(by_hop.items()):
        xs.sort()
        for p in ps:
            idx = min(len(xs) - 1, max(0, int(round(
                (p / 100.0) * (len(xs) - 1)))))
            out[f"{hop}_p{p}_ms"] = round(xs[idx] * 1e3, 3)
    return out


def render_tree(tree: Dict[str, Any], indent: str = "  ") -> List[str]:
    """One trace as indented hop lines with durations — the postmortem
    "slow traces:" rendering.

        serve.request 812.4ms status=timeout
          router.queue_wait 3.1ms
          serve.admission 0.4ms
          ...
    """
    lines: List[str] = []
    root = tree.get("root")
    spans = tree.get("spans", [])

    def fmt(s: Dict[str, Any]) -> str:
        ms = s.get("seconds", 0.0) * 1e3
        extra = ""
        attrs = s.get("attrs")
        if attrs:
            extra = " " + " ".join(f"{k}={v}"
                                   for k, v in sorted(attrs.items()))
        status = s.get("status", "ok")
        tag = f" status={status}" if status != "ok" else ""
        return f"{s.get('name')} {ms:.1f}ms{tag}{extra}"

    if root is not None:
        lines.append(fmt(root))
        for ev in root.get("events") or []:
            kv = " ".join(f"{k}={v}" for k, v in sorted(ev.items())
                          if k != "name")
            lines.append(f"{indent}@ {ev.get('name')}"
                         + (f" {kv}" if kv else ""))
    for s in spans:
        if s.get("parent") is None:
            continue
        lines.append(indent + fmt(s))
    return lines


__all__ = [
    "REQUEST_ROOT", "SESSION_ROOT", "SPAN", "TRACE_HOP_BUCKETS",
    "RequestTrace", "SessionSpan", "Tracer", "build_trees",
    "hop_name", "hop_percentiles", "hop_spans", "orphan_spans",
    "read_trace_spans", "render_tree", "trace_sum_gap",
]
