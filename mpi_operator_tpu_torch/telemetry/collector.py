"""Controller-side observability collector: metrics federation, merged
event timelines, and restart-aware goodput — the job-level view.

The PyTorch port's own copy of mpi_operator_tpu/telemetry/collector.py:
the port imports nothing of the JAX package, not even its
framework-free modules, and its operator (controller/controller.py)
builds a JobObservatory from this module when it is given an events
directory or a worker metrics port. Its logic and names are the
reference's, held to it by tests/test_torch_collector.py. It imports
neither torch nor jax.

The worker telemetry gives every *process* a `/metrics` endpoint and
an fsync'd events.jsonl; a gang is N pods plus a controller. This
module is the operator-side half that turns N per-process views into
one per-job view:

* `parse_prometheus` / `MetricsFederation` — scrape each worker pod's
  exposition text and re-export aggregated ``tpu_job_*`` series
  (counters summed, gauges max'd or summed by semantics, histograms
  bucket-merged at the shared log-spaced edges) with ``job`` labels,
  plus per-pod ``tpu_job_up`` / ``tpu_job_scrape_staleness_seconds`` /
  ``tpu_job_scrape_failures_total`` meta-series so a dead worker is
  visible, not invisible.

* `ClockSync` / `merge_timeline` — merge controller + worker event
  records by ``ts`` with per-host clock-offset correction. The offset
  is anchored at bootstrap: each worker emits a `clock_anchor` event
  with a fresh ``boot_id``, and the /events pull ships a server-side
  ``now`` stamp; offset = controller_now − worker_now is pinned once
  per boot_id so a mid-run scrape hiccup cannot re-skew history.

* `goodput_ledger` — every executed step is either useful or lost.
  A `checkpoint_restore` after which work had already advanced past
  the restored step charges ``last observed step − restore step`` to
  the lost column (the gang re-executes them); divergence rollbacks
  charge ``from_step − to_step`` (same rule, intra-process). Goodput
  is useful / (useful + lost).

* `JobObservatory` — the stateful controller attachment: its own
  EventLog (job_created, gang_restart, pods_ready, packed/resize,
  first_step_observed, terminal), the scrape loop, and
  ``<job>/timeline.jsonl`` writing.

Also a CLI for harness use (a drill that plays the controller's role
out-of-process, as tests/test_torch_resilience.py does):

    python -m mpi_operator_tpu_torch.telemetry.collector emit  --log L --job J EVENT [k=v ...]
    python -m mpi_operator_tpu_torch.telemetry.collector merge --job J --controller L \
        [--worker HOST=PATH ...] [--offset HOST=SECS ...] \
        --out timeline.jsonl [--metrics-out federated.prom]
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import re
import sys
import time
import urllib.parse
import urllib.request
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from . import events as ev
from .events import EventLog, _env_int, read_events, rotate_chain
from .prometheus import escape_label_value, format_value
from .trace import (REQUEST_ROOT, SPAN, TRACE_HOP_BUCKETS, build_trees,
                    hop_name)

logger = logging.getLogger("mpi_operator_tpu_torch.telemetry.collector")

WORKER_PREFIX = "tpu_worker_"
ROUTER_PREFIX = "tpu_router_"
JOB_PREFIX = "tpu_job_"

# timeline.jsonl size cap (0/unset = the historical full-rewrite mode).
# Capped mode switches write_timeline to incremental appends rotated
# through the SAME .N chain events.py uses, so event_files/read_events
# (and postmortem.read_timeline) span the generations transparently.
ENV_TIMELINE_MAX_BYTES = "TPU_TIMELINE_MAX_BYTES"
ENV_TIMELINE_KEEP = "TPU_TIMELINE_KEEP"

# Fields that carry a global-step position; the running max across a
# merged timeline is "the furthest the gang has ever trained" — the
# useful-step frontier the goodput ledger charges restores against.
STEP_FIELDS = ("step", "from_step", "to_step", "last_observed_step")


# ---------------------------------------------------------------------------
# exposition-format parsing
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)\s*$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(v: str) -> str:
    return v.replace('\\"', '"').replace("\\n", "\n").replace("\\\\", "\\")


def parse_prometheus(text: str) -> Tuple[List[Tuple[str, Dict[str, str],
                                                    float]],
                                         Dict[str, str]]:
    """Parse exposition 0.0.4 text into (samples, types).

    samples: [(name, labels, value)]; types: metric name -> kind from
    the ``# TYPE`` comments (histogram base names, not _bucket/_sum).
    Unparseable lines are skipped — federation of a half-written scrape
    should degrade, not abort."""
    samples: List[Tuple[str, Dict[str, str], float]] = []
    types: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, labelblob, raw = m.groups()
        labels = ({k: _unescape(v) for k, v in _LABEL_RE.findall(labelblob)}
                  if labelblob else {})
        try:
            value = float(raw)
        except ValueError:
            continue
        samples.append((name, labels, value))
    return samples, types


# ---------------------------------------------------------------------------
# federation
# ---------------------------------------------------------------------------

# Gauges whose job-level meaning is a SUM across pods (rates, occupancy);
# everything else federates as MAX (steps, ratios, watermarks).
_SUM_GAUGE_SUFFIXES = ("_per_sec",)
_SUM_GAUGE_MARKERS = ("queue_depth", "slot", "kv_pages", "batch_size")


def _gauge_is_summed(name: str) -> bool:
    return (name.endswith(_SUM_GAUGE_SUFFIXES)
            or any(m in name for m in _SUM_GAUGE_MARKERS))


def _fed_out(name: str) -> Optional[str]:
    """Federated output name for a scraped series, or None when the
    series does not federate. ``tpu_worker_X`` → ``tpu_job_X``;
    ``tpu_router_X`` → ``tpu_job_router_X`` (the front door is one
    process, not a gang member — keeping its series in their own
    ``router_`` namespace means a fleet's queue_wait can never collide
    with a worker series of the same name)."""
    if name.startswith(WORKER_PREFIX):
        return JOB_PREFIX + name[len(WORKER_PREFIX):]
    if name.startswith(ROUTER_PREFIX):
        return JOB_PREFIX + "router_" + name[len(ROUTER_PREFIX):]
    return None


def _lkey(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, v) for k, v in labels.items() if k != "le"))


def _hist_base(name: str, types: Dict[str, str]) -> Optional[str]:
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            base = name[:-len(suffix)]
            if types.get(base) == "histogram":
                return base
    return None


class MetricsFederation:
    """Aggregate per-pod scrapes of one job into ``tpu_job_*`` series.

    Feed the latest scrape per replica_rank via ingest(); render() emits
    the aggregate plus per-pod scrape-health meta-series. Only
    ``tpu_worker_*`` and ``tpu_router_*`` names federate (the latter as
    ``tpu_job_router_*``) — operator and meta series are not
    re-aggregated."""

    def __init__(self, job: str, clock: Callable[[], float] = time.time,
                 extra_labels: Optional[Dict[str, str]] = None):
        self.job = job
        self.clock = clock
        self.extra_labels = dict(extra_labels or {})
        # rank -> {"samples", "types", "last_success", "first_attempt",
        #          "failures", "ok"}
        self.pods: Dict[int, Dict] = {}

    def _pod(self, rank: int) -> Dict:
        return self.pods.setdefault(rank, {
            "samples": [], "types": {}, "last_success": None,
            "first_attempt": self.clock(), "failures": 0, "ok": False})

    def ingest(self, rank: int, text: str) -> None:
        pod = self._pod(rank)
        samples, types = parse_prometheus(text)
        pod["samples"], pod["types"] = samples, types
        pod["last_success"] = self.clock()
        pod["ok"] = True

    def scrape_failed(self, rank: int) -> None:
        pod = self._pod(rank)
        pod["failures"] += 1
        pod["ok"] = False

    def observed_step(self) -> int:
        """Max step frontier visible in the latest scrapes (live step
        gauge or last checkpointed step, whichever is further)."""
        best = 0
        for pod in self.pods.values():
            for name, _labels, value in pod["samples"]:
                if name in (WORKER_PREFIX + "step",
                            WORKER_PREFIX + "last_checkpoint_step"):
                    best = max(best, int(value))
        return best

    def observed_tokens(self) -> int:
        """Serving progress frontier: retired requests + emitted tokens
        (ServeTelemetry counters) summed across pods and label sets
        (per-pool labels included). Counters only grow per pod and a
        partitioned pod's last-known counts are RETAINED, so a partial
        partition can never move this frontier backward — and pure
        scrape flakiness can never advance it."""
        total = 0.0
        for pod in self.pods.values():
            for name, _labels, value in pod["samples"]:
                if name in (WORKER_PREFIX + "requests_total",
                            WORKER_PREFIX + "tokens_total"):
                    total += value
        return int(total)

    def unreachable_ranks(self) -> List[int]:
        """Ranks whose LATEST scrape attempt failed — the partial-
        partition evidence. A rank that has never been scraped at all
        is absent (no attempt, no verdict)."""
        return sorted(r for r, p in self.pods.items() if not p["ok"])

    def histogram_quantile(self, base: str, q: float) -> Optional[float]:
        """Bucket-walk quantile over the federated histogram `base`
        (scraped-side name, e.g. ``tpu_worker_ttft_seconds``), label
        sets merged. Returns the upper bound of the first cumulative
        bucket covering the target rank — the conservative (over-)
        estimate an SLO comparison wants — or None when the histogram
        is empty or every observation landed in +Inf."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        _counters, _gauges, hists, _kinds = self._aggregate()
        buckets: Dict[str, float] = {}
        for (name, _lk), h in hists.items():
            if name != base:
                continue
            for le, v in h["buckets"].items():
                buckets[le] = buckets.get(le, 0.0) + v
        total = buckets.get("+Inf", 0.0)
        if total <= 0:
            return None
        target = q * total
        for le in sorted(buckets, key=self._le_sort_key):
            if buckets[le] >= target and le != "+Inf":
                return float(le)
        return None

    def gauge_value(self, name: str) -> Optional[float]:
        """The federated value of one gauge (scraped-side name), label
        sets folded with the same SUM/MAX rule _aggregate applies
        across pods. None when no pod reported it."""
        _counters, gauges, _hists, _kinds = self._aggregate()
        vals = [v for (n, _lk), v in gauges.items() if n == name]
        if not vals:
            return None
        return sum(vals) if _gauge_is_summed(name) else max(vals)

    def _aggregate(self):
        counters: Dict[Tuple, float] = {}
        gauges: Dict[Tuple, float] = {}
        hists: Dict[Tuple, Dict] = {}
        kinds: Dict[str, str] = {}
        for pod in self.pods.values():
            types = pod["types"]
            for name, labels, value in pod["samples"]:
                base = _hist_base(name, types)
                if base is not None:
                    if _fed_out(base) is None:
                        continue
                    key = (base, _lkey(labels))
                    h = hists.setdefault(key, {"buckets": {}, "sum": 0.0,
                                               "count": 0.0})
                    if name.endswith("_bucket"):
                        le = labels.get("le", "+Inf")
                        h["buckets"][le] = h["buckets"].get(le, 0.0) + value
                    elif name.endswith("_sum"):
                        h["sum"] += value
                    else:
                        h["count"] += value
                    kinds[base] = "histogram"
                    continue
                if _fed_out(name) is None:
                    continue
                kind = types.get(name, "gauge")
                key = (name, _lkey(labels))
                if kind == "counter":
                    counters[key] = counters.get(key, 0.0) + value
                    kinds[name] = "counter"
                else:
                    if _gauge_is_summed(name):
                        gauges[key] = gauges.get(key, 0.0) + value
                    else:
                        gauges[key] = max(gauges.get(key, float("-inf")),
                                          value)
                    kinds[name] = "gauge"
        return counters, gauges, hists, kinds

    def _out_labels(self, lkey: Tuple,
                    extra: Optional[Dict] = None) -> str:
        merged = {"job": self.job, **self.extra_labels, **dict(lkey)}
        if extra:
            merged.update(extra)
        inner = ",".join(f'{k}="{escape_label_value(v)}"'
                         for k, v in merged.items())
        return "{" + inner + "}"

    @staticmethod
    def _le_sort_key(le: str) -> float:
        return float("inf") if le == "+Inf" else float(le)

    def render_lines(self) -> List[str]:
        counters, gauges, hists, kinds = self._aggregate()
        lines: List[str] = []
        seen = set()

        def head(out_name: str, kind: str, src: str):
            if out_name not in seen:
                seen.add(out_name)
                lines.append(f"# HELP {out_name} federated from "
                             f"{src} across the gang")
                lines.append(f"# TYPE {out_name} {kind}")

        for (name, lkey), value in sorted(counters.items()):
            out = _fed_out(name)
            head(out, "counter", name)
            lines.append(f"{out}{self._out_labels(lkey)} "
                         f"{format_value(value)}")
        for (name, lkey), value in sorted(gauges.items()):
            out = _fed_out(name)
            head(out, "gauge", name)
            lines.append(f"{out}{self._out_labels(lkey)} "
                         f"{format_value(value)}")
        for (base, lkey), h in sorted(hists.items()):
            out = _fed_out(base)
            head(out, "histogram", base)
            for le in sorted(h["buckets"], key=self._le_sort_key):
                lines.append(f"{out}_bucket"
                             f"{self._out_labels(lkey, {'le': le})} "
                             f"{format_value(h['buckets'][le])}")
            lines.append(f"{out}_sum{self._out_labels(lkey)} "
                         f"{format_value(h['sum'])}")
            lines.append(f"{out}_count{self._out_labels(lkey)} "
                         f"{format_value(h['count'])}")

        # per-pod scrape health: a dead worker must be VISIBLE
        meta = [("tpu_job_up",
                 "gauge", "last scrape of this pod succeeded",
                 lambda p: 1 if p["ok"] else 0),
                ("tpu_job_scrape_staleness_seconds",
                 "gauge", "seconds since this pod was last scraped ok",
                 lambda p: round(self.clock() - (p["last_success"]
                                                 or p["first_attempt"]), 3)),
                ("tpu_job_scrape_failures_total",
                 "counter", "failed scrapes of this pod",
                 lambda p: p["failures"])]
        for name, kind, help_text, fn in meta:
            if not self.pods:
                continue
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {kind}")
            for rank in sorted(self.pods):
                lines.append(
                    f"{name}"
                    f"{self._out_labels((), {'replica_rank': str(rank)})}"
                    f" {format_value(fn(self.pods[rank]))}")
        if self.pods:
            # job-level partition gauge: how many ranks the collector
            # currently cannot reach (0 = fully connected). The per-rank
            # tpu_job_up series above names WHICH; this is the one number
            # an alert rule wants.
            down = len(self.unreachable_ranks())
            lines.append("# HELP tpu_job_partitioned_ranks worker ranks "
                         "currently unreachable to the collector")
            lines.append("# TYPE tpu_job_partitioned_ranks gauge")
            lines.append(f"tpu_job_partitioned_ranks{self._out_labels(())}"
                         f" {down}")
        return lines


# ---------------------------------------------------------------------------
# clock-offset correction + timeline merge
# ---------------------------------------------------------------------------

class ClockSync:
    """Per-host clock offsets, pinned once per worker boot.

    note() is called on every successful /events pull with the pull's
    local receive time, the worker's self-reported ``now``, and the
    boot_id of the newest `clock_anchor` record in the payload. The
    offset (local − remote) is (re)pinned only when the boot_id changes
    — a restarted pod gets a fresh anchor; a jittery scrape does not
    re-skew already-merged history."""

    def __init__(self):
        self.offsets: Dict[str, float] = {}
        self.boot_ids: Dict[str, Optional[str]] = {}

    def note(self, host: str, local_now: float, remote_now: float,
             boot_id: Optional[str] = None) -> float:
        if host not in self.offsets or self.boot_ids.get(host) != boot_id:
            self.offsets[host] = local_now - remote_now
            self.boot_ids[host] = boot_id
        return self.offsets[host]

    def offset(self, host: str) -> float:
        return self.offsets.get(host, 0.0)


def latest_boot_id(records: Iterable[Dict]) -> Optional[str]:
    boot = None
    for rec in records:
        if rec.get("event") == ev.CLOCK_ANCHOR and "boot_id" in rec:
            boot = rec["boot_id"]
    return boot


def merge_timeline(sources: List[Tuple[Optional[str], List[Dict]]],
                   offsets: Optional[Dict[str, float]] = None,
                   out_path: Optional[str] = None) -> List[Dict]:
    """Merge per-source event records into one ts-ordered timeline.

    ``sources`` is [(host, records)]; host None/"controller" records are
    the reference clock and pass through unshifted. Worker records get
    their host's offset added; the original stamp is preserved as
    ``ts_raw`` (plus ``clock_offset``) so a postmortem can always see
    what the host itself believed. Every record gains a ``host`` field.
    Returns the merged list; optionally writes it as JSONL."""
    offsets = offsets or {}
    merged: List[Dict] = []
    for host, records in sources:
        off = offsets.get(host, 0.0) if host else 0.0
        for rec in records:
            out = dict(rec)
            out["host"] = host or "controller"
            if off and "ts" in out:
                out["ts_raw"] = out["ts"]
                out["clock_offset"] = round(off, 3)
                out["ts"] = round(out["ts"] + off, 3)
            merged.append(out)
    merged.sort(key=lambda r: (r.get("ts", 0.0)))
    if out_path:
        parent = os.path.dirname(out_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = out_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            for rec in merged:
                fh.write(json.dumps(rec) + "\n")
        os.replace(tmp, out_path)
    return merged


# ---------------------------------------------------------------------------
# cross-pod request-trace federation
# ---------------------------------------------------------------------------

class TraceFederation:
    """Per-job span-record federation: cross-pod trace trees, hop-latency
    histograms, and slowest-trace exemplars.

    ingest() takes one pod's batch of span records (telemetry/trace.py
    schema, straight from traces.jsonl / a /traces pull / a push report)
    plus that pod's clock offset from the SAME ClockSync the event
    timeline uses, so a span's wall ``ts`` lands on the controller clock.
    Re-ingesting a file every scrape is the normal mode — dedup is by
    (pod, trace, span), so repeated pulls are idempotent and a replayed
    failover span (same ids, emitted once by construction) can never
    double-count a hop.

    Hop durations come from the span's own ``seconds`` (one monotonic
    session clock per pod — no correction needed); only cross-pod
    ORDERING uses the corrected wall stamp. Aggregates:

    * ``tpu_job_trace_hop_seconds{hop=...}`` histograms over the shared
      TRACE_HOP_BUCKETS edges, one label set per hop name
    * slowest-K completed request traces in the trailing ``window``
      seconds, the SLO-breach exemplar pool (``slowest_trace()``)
    """

    EXEMPLAR_K = 5

    def __init__(self, job: str, clock: Callable[[], float] = time.time,
                 window: float = 600.0,
                 extra_labels: Optional[Dict[str, str]] = None):
        self.job = job
        self.clock = clock
        self.window = float(window)
        self.extra_labels = dict(extra_labels or {})
        self._seen: set = set()
        #: trace id -> every span record federated for it (pod-stamped)
        self.spans: Dict[int, List[Dict]] = {}
        #: hop name -> {"buckets": [per TRACE_HOP_BUCKETS edge], "sum",
        #: "count"} — cumulative render happens at render_lines time
        self.hops: Dict[str, Dict] = {}
        #: [(root seconds, trace id, arrival wall ts)] slowest-first
        self._exemplars: List[Tuple[float, int, float]] = []

    def ingest(self, pod: str, records: Iterable[Dict],
               offset: float = 0.0) -> int:
        """Fold one pod's span batch in; returns the count of NEW spans
        (already-seen ids skip everything, including the histograms)."""
        fresh = 0
        for rec in records:
            if rec.get("event") != SPAN:
                continue
            trace, span_id = rec.get("trace"), rec.get("span")
            key = (pod, trace, span_id)
            if trace is None or span_id is None or key in self._seen:
                continue
            self._seen.add(key)
            fresh += 1
            out = dict(rec)
            out["pod"] = pod
            if offset and "ts" in out:
                out["ts_raw"] = out["ts"]
                out["ts"] = round(out["ts"] + offset, 3)
            self.spans.setdefault(trace, []).append(out)
            if trace < 0:           # session spans carry no request hops
                continue
            if out.get("parent") is not None:
                self._observe_hop(hop_name(out), float(out["seconds"]))
            elif out.get("name") == REQUEST_ROOT:
                self._note_exemplar(trace, float(out["seconds"]),
                                    float(out.get("ts", self.clock())))
        return fresh

    def _observe_hop(self, hop: str, seconds: float) -> None:
        h = self.hops.setdefault(hop, {
            "buckets": [0] * len(TRACE_HOP_BUCKETS), "sum": 0.0,
            "count": 0})
        for i, edge in enumerate(TRACE_HOP_BUCKETS):
            if seconds <= edge:
                h["buckets"][i] += 1
                break
        h["sum"] += seconds
        h["count"] += 1

    def _note_exemplar(self, trace: int, seconds: float, ts: float) -> None:
        self._exemplars.append((seconds, trace, ts))
        self._exemplars.sort(key=lambda e: -e[0])
        self._prune(self.clock())

    def _prune(self, now: float) -> None:
        live = [e for e in self._exemplars if now - e[2] <= self.window]
        del self._exemplars[:]
        self._exemplars.extend(live[:self.EXEMPLAR_K])

    # -- accessors --------------------------------------------------------

    def exemplars(self) -> List[Tuple[float, int]]:
        """[(root seconds, trace id)] slowest-first, window-pruned."""
        self._prune(self.clock())
        return [(s, t) for s, t, _ts in self._exemplars]

    def slowest_trace(self) -> Optional[int]:
        """Trace id of the slowest completed request in the window —
        what an SLO-breach record attaches as its exemplar."""
        ex = self.exemplars()
        return ex[0][1] if ex else None

    def tree(self, trace: int) -> Optional[Dict]:
        """build_trees-shaped {"root", "spans"} for one trace id, or
        None when no span of it has federated yet."""
        spans = self.spans.get(trace)
        if not spans:
            return None
        return build_trees(spans).get(trace)

    def trees(self) -> Dict[int, Dict]:
        """Every federated trace reconstructed (sessions included)."""
        return build_trees(s for lst in self.spans.values() for s in lst)

    # -- rendering --------------------------------------------------------

    def _labels(self, extra: Optional[Dict] = None) -> str:
        merged = {"job": self.job, **self.extra_labels}
        if extra:
            merged.update(extra)
        inner = ",".join(f'{k}="{escape_label_value(v)}"'
                         for k, v in merged.items())
        return "{" + inner + "}"

    def render_lines(self) -> List[str]:
        if not self.hops:
            return []
        name = "tpu_job_trace_hop_seconds"
        lines = [f"# HELP {name} request-trace hop duration by hop name, "
                 f"federated across pods",
                 f"# TYPE {name} histogram"]
        for hop in sorted(self.hops):
            h = self.hops[hop]
            cum = 0
            for edge, c in zip(TRACE_HOP_BUCKETS, h["buckets"]):
                cum += c
                lines.append(
                    f"{name}_bucket"
                    f"{self._labels({'hop': hop, 'le': format_value(edge)})}"
                    f" {cum}")
            lines.append(f"{name}_bucket"
                         f"{self._labels({'hop': hop, 'le': '+Inf'})}"
                         f" {h['count']}")
            lines.append(f"{name}_sum{self._labels({'hop': hop})} "
                         f"{format_value(round(h['sum'], 6))}")
            lines.append(f"{name}_count{self._labels({'hop': hop})} "
                         f"{h['count']}")
        return lines


# ---------------------------------------------------------------------------
# restart-aware goodput
# ---------------------------------------------------------------------------

def goodput_ledger(records: Iterable[Dict]) -> Dict:
    """Fold a (merged) timeline into the job goodput ledger.

    Every executed step is useful or lost. The useful frontier is the
    running max over step-carrying fields; a `checkpoint_restore` to a
    step behind that frontier charges the gap to the lost column (the
    gang re-executes those steps), and a `divergence_rollback` charges
    from_step − to_step. goodput = useful / (useful + lost)."""
    observed = 0
    lost = 0
    restarts = 0
    restores = 0
    rollbacks = 0
    for rec in sorted(records, key=lambda r: r.get("ts", 0.0)):
        kind = rec.get("event")
        if kind == ev.CHECKPOINT_RESTORE:
            restores += 1
            try:
                lost += max(0, observed - int(rec.get("step", 0)))
            except (TypeError, ValueError):
                pass
        elif kind == ev.DIVERGENCE_ROLLBACK:
            rollbacks += 1
            try:
                lost += max(0, int(rec.get("from_step", 0))
                            - int(rec.get("to_step", 0)))
            except (TypeError, ValueError):
                pass
        elif kind == ev.GANG_RESTART:
            restarts += 1
        for field in STEP_FIELDS:
            if field in rec:
                try:
                    observed = max(observed, int(rec[field]))
                except (TypeError, ValueError):
                    pass
    total = observed + lost
    return {"useful_steps": observed, "lost_steps": lost,
            "total_steps": total,
            "goodput": (observed / total) if total else 1.0,
            "restarts": restarts, "restores": restores,
            "rollbacks": rollbacks}


def resize_ledger(records: Iterable[Dict]) -> List[Dict]:
    """Split each ``gang_resize`` into drain / restore / recompile phases.

    drain     = the preemption_drain -> emergency_checkpoint wall time of
                the drain that handed the gang over to the resize;
    restore   = the first post-resize checkpoint_restore's ``seconds``
                (shard read + assembly, resharded or not);
    recompile = the first post-resume step's ``seconds``
                (first_resume_step: restore-done -> step completion, i.e.
                jit recompilation at the new world size plus one step);
    total     = drain start -> first post-resume step completion — the
                goodput hole the resize punched into the run.
    Entries missing a phase (job died mid-resize) keep whatever phases
    were observed; ``total_seconds`` is only set once the gang stepped.

    Every entry carries ``kind``: ``"gang_resize"`` for the phase-pair
    machinery above, ``"live_scale"`` for surgical decode-pool steps.
    A ``live_scale`` record is SELF-CONTAINED (the survivors never
    paused, so there is no checkpoint/restore/recompile to pair): its
    entry copies the record's drain_seconds (graceful detach drain) /
    warmup_seconds (attach compile pin) and total_seconds (defaulting
    to drain + warmup when the emitter measured only the phases).
    Cooldown readers MUST filter on kind — pricing a live step off a
    gang total (or a gang preemption off a live step) inverts the
    whole point of the split."""
    resizes: List[Dict] = []
    drain_open: Optional[float] = None
    last_drain: Optional[Tuple[float, float]] = None
    current: Optional[Dict] = None
    for rec in sorted(records, key=lambda r: r.get("ts", 0.0)):
        kind = rec.get("event")
        ts = rec.get("ts", 0.0)
        if kind == ev.PREEMPTION_DRAIN:
            drain_open = ts
        elif kind == ev.EMERGENCY_CHECKPOINT and drain_open is not None:
            last_drain = (drain_open, round(ts - drain_open, 3))
            drain_open = None
        elif kind == ev.LIVE_SCALE:
            entry = {"ts": ts, "kind": ev.LIVE_SCALE}
            for key in ("action", "replicas", "decode_replicas", "reason",
                        "token"):
                if key in rec:
                    entry[key] = rec[key]
            phases = 0.0
            for key in ("drain_seconds", "warmup_seconds"):
                try:
                    entry[key] = float(rec[key])
                    phases += entry[key]
                except (KeyError, TypeError, ValueError):
                    pass
            try:
                entry["total_seconds"] = float(rec["total_seconds"])
            except (KeyError, TypeError, ValueError):
                if "drain_seconds" in entry or "warmup_seconds" in entry:
                    entry["total_seconds"] = round(phases, 3)
            resizes.append(entry)
        elif kind == ev.GANG_RESIZE:
            if current is not None:
                resizes.append(current)
            current = {"ts": ts, "kind": ev.GANG_RESIZE}
            for key in ("workers", "tpus", "replicas", "num_slices",
                        "reason"):
                if key in rec:
                    current[key] = rec[key]
            if last_drain is not None:
                current["drain_start_ts"] = last_drain[0]
                current["drain_seconds"] = last_drain[1]
                last_drain = None
        elif (current is not None and kind == ev.CHECKPOINT_RESTORE
              and "restore_seconds" not in current):
            try:
                current["restore_seconds"] = float(rec["seconds"])
            except (KeyError, TypeError, ValueError):
                pass
        elif current is not None and kind == ev.FIRST_RESUME_STEP:
            try:
                current["recompile_seconds"] = float(rec["seconds"])
            except (KeyError, TypeError, ValueError):
                pass
            start = current.get("drain_start_ts", current["ts"])
            current["total_seconds"] = round(ts - start, 3)
            resizes.append(current)
            current = None
    if current is not None:
        resizes.append(current)
    return resizes


#: log-spaced upper bounds for tpu_job_resize_seconds. A resize is drain
#: + restore + recompile: sub-second on toy runs, minutes when a large
#: model recompiles, so the buckets span both regimes.
RESIZE_BUCKETS = (1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0)


def resize_lines(job: str, resizes: List[Dict],
                 extra_labels: Optional[Dict[str, str]] = None) -> List[str]:
    """Render the resize ledger as Prometheus text: one
    tpu_job_resize_seconds histogram over completed resizes plus
    per-phase gauges for the most recent one."""
    labels = {"job": job, **(extra_labels or {})}

    def ls(extra: Optional[Dict[str, str]] = None) -> str:
        merged = {**labels, **(extra or {})}
        inner = ",".join(f'{k}="{escape_label_value(v)}"'
                         for k, v in merged.items())
        return "{" + inner + "}"

    # the histogram prices GANG resizes only: mixing sub-second live
    # scale steps into the same series would drag the p99 an alert rule
    # reads off the distribution it is actually alarming on (entries
    # predating the kind field are all gang — live_scale always stamps)
    gang = [r for r in resizes
            if r.get("kind", ev.GANG_RESIZE) == ev.GANG_RESIZE]
    live = [r for r in resizes if r.get("kind") == ev.LIVE_SCALE]
    totals = sorted(float(r["total_seconds"]) for r in gang
                    if "total_seconds" in r)
    lines = [
        "# HELP tpu_job_resize_seconds wall time of a gang resize, drain "
        "start to first post-resume step",
        "# TYPE tpu_job_resize_seconds histogram",
    ]
    for bound in RESIZE_BUCKETS:
        count = sum(1 for t in totals if t <= bound)
        lines.append(f'tpu_job_resize_seconds_bucket{ls({"le": repr(bound)})}'
                     f" {count}")
    lines.append(f'tpu_job_resize_seconds_bucket{ls({"le": "+Inf"})}'
                 f" {len(totals)}")
    lines.append(f"tpu_job_resize_seconds_sum{ls()}"
                 f" {format_value(round(sum(totals), 3))}")
    lines.append(f"tpu_job_resize_seconds_count{ls()} {len(totals)}")
    lines += [
        "# HELP tpu_job_resizes_total gang resizes observed",
        "# TYPE tpu_job_resizes_total counter",
        f"tpu_job_resizes_total{ls()} {len(gang)}",
    ]
    for phase in ("drain", "restore", "recompile"):
        key = f"{phase}_seconds"
        value = next((r[key] for r in reversed(gang) if key in r), None)
        if value is None:
            continue
        lines += [
            f"# HELP tpu_job_resize_{key} {phase} phase of the most "
            "recent gang resize",
            f"# TYPE tpu_job_resize_{key} gauge",
            f"tpu_job_resize_{key}{ls()} "
            f"{format_value(round(float(value), 3))}",
        ]
    if live:
        lines += [
            "# HELP tpu_job_live_scales_total surgical decode-pool "
            "scale steps (no gang restart)",
            "# TYPE tpu_job_live_scales_total counter",
            f"tpu_job_live_scales_total{ls()} {len(live)}",
        ]
        value = next((r["total_seconds"] for r in reversed(live)
                      if "total_seconds" in r), None)
        if value is not None:
            lines += [
                "# HELP tpu_job_live_scale_seconds drain+warmup of the "
                "most recent live scale step",
                "# TYPE tpu_job_live_scale_seconds gauge",
                f"tpu_job_live_scale_seconds{ls()} "
                f"{format_value(round(float(value), 3))}",
            ]
    return lines


def ledger_lines(job: str, ledger: Dict,
                 extra_labels: Optional[Dict[str, str]] = None) -> List[str]:
    labels = {"job": job, **(extra_labels or {})}
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in labels.items())
    ls = "{" + inner + "}"
    return [
        "# HELP tpu_job_goodput useful steps over total steps "
        "including restart- and rollback-lost work",
        "# TYPE tpu_job_goodput gauge",
        f"tpu_job_goodput{ls} {format_value(round(ledger['goodput'], 6))}",
        "# HELP tpu_job_steps_lost_total steps re-executed after gang "
        "restarts and rollbacks",
        "# TYPE tpu_job_steps_lost_total counter",
        f"tpu_job_steps_lost_total{ls} {ledger['lost_steps']}",
        "# HELP tpu_job_useful_steps furthest step frontier reached",
        "# TYPE tpu_job_useful_steps gauge",
        f"tpu_job_useful_steps{ls} {ledger['useful_steps']}",
        "# HELP tpu_job_restarts_total gang restarts observed",
        "# TYPE tpu_job_restarts_total counter",
        f"tpu_job_restarts_total{ls} {ledger['restarts']}",
    ]


# ---------------------------------------------------------------------------
# the controller attachment
# ---------------------------------------------------------------------------

def _http_get(url: str, timeout: float = 2.0) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode("utf-8", "replace")


class JobObservatory:
    """Per-job observability state the controller carries.

    One controller-side EventLog (each record stamped with its ``job``),
    one MetricsFederation + ClockSync + worker-record cache per job, and
    the scrape loop. All note_* methods are idempotent where the event
    is once-per-lifecycle (created, pods_ready per incarnation,
    first_step, terminal)."""

    def __init__(self, events_dir: Optional[str] = None,
                 events: Optional[EventLog] = None,
                 clock: Callable[[], float] = time.time,
                 fetch: Callable[[str], str] = _http_get,
                 scrape_interval: float = 10.0,
                 scrape_injector=None,
                 serving_rate_floor: Optional[float] = None):
        self.events_dir = events_dir
        if events is None and events_dir:
            events = EventLog(os.path.join(events_dir,
                                           "controller-events.jsonl"),
                              clock=clock)
        self.events = events
        self.clock = clock
        self.fetch = fetch
        self.scrape_interval = scrape_interval
        #: telemetry.chaos.ScrapeFaultInjector — when set, every per-pod
        #: fetch routes through it (data-plane chaos). Rank-aware by
        #: construction: URL→rank parsing is ambiguous for serving pools
        #: (prefill-0 and decode-0 both exist), so the injector is fed
        #: the rank the observe loop already knows.
        self.scrape_injector = scrape_injector
        #: TPOT-slope floor for SERVING jobs (observed tokens+requests
        #: per second, measured between frontier advances). None keeps
        #: the lease purely wall-clock. With a floor set, a frontier
        #: that advances but below the floor does NOT slide progress_ts:
        #: an engine degraded to a trickle (per-token rate collapsed)
        #: arms the lease exactly like a frozen one, instead of buying
        #: itself an indefinite lease one token at a time.
        self.serving_rate_floor = serving_rate_floor
        self.jobs: Dict[str, Dict] = {}

    def view(self, job: str) -> Dict:
        return self.jobs.setdefault(job, {
            "created": False, "pods_ready": False, "first_step": False,
            "terminal": False, "labels": {},
            "federation": MetricsFederation(job, clock=self.clock),
            "traces": TraceFederation(job, clock=self.clock),
            "clock_sync": ClockSync(),
            "controller_records": [], "worker_records": {},
            "last_scrape": 0.0,
            # progress lease (stuck-gang detection): the highest step
            # frontier ever observed for this gang incarnation and WHEN it
            # last moved. progress_ts None = lease disarmed (not observed
            # yet, or reset by a gang restart).
            "progress_step": -1, "progress_ts": None,
            # TPOT-slope tracking (serving_rate_floor): the frontier and
            # wall time of the last frontier ADVANCE, regardless of
            # whether that advance was fast enough to renew the lease —
            # consecutive advances measure the between-advance rate
            "rate_step": -1, "rate_ts": None,
            # serving gangs watch the retired-request/token frontier
            # instead of the step frontier (observe(serving=True))
            "serving": False,
            # open partial-partition window: the unreachable rank set the
            # last gang_degraded record named, None when fully connected
            "degraded_ranks": None})

    # -- controller lifecycle events ------------------------------------
    def record(self, job: str, event: str, **fields) -> Dict:
        view = self.view(job)
        fields = {**view["labels"], **fields}
        if self.events is not None:
            rec = self.events.emit(event, job=job, **fields)
        else:
            rec = {"ts": round(self.clock(), 3), "event": event,
                   "job": job, **fields}
        view["controller_records"].append(rec)
        return rec

    def note_created(self, job: str, **fields) -> None:
        view = self.view(job)
        if not view["created"]:
            view["created"] = True
            self.record(job, ev.JOB_CREATED, **fields)

    def note_pods_ready(self, job: str, **fields) -> None:
        view = self.view(job)
        if not view["pods_ready"]:
            view["pods_ready"] = True
            self.record(job, ev.PODS_READY, **fields)

    def note_restart(self, job: str, exit_code: Optional[int],
                     restart: int) -> None:
        view = self.view(job)
        view["pods_ready"] = False      # next readiness is a new event
        self.record(job, ev.GANG_RESTART, exit_code=exit_code,
                    restart=restart,
                    last_observed_step=view["federation"].observed_step())
        # the restarted gang re-executes from its checkpoint: the old
        # frontier must not keep an expired lease armed against it
        self.reset_progress_lease(job)

    def reset_progress_lease(self, job: str) -> None:
        """Disarm the progress lease; the next observe() re-arms it at
        whatever frontier the restarted gang actually reports. Idempotent
        — crash-replayed restart syncs call this again harmlessly."""
        view = self.view(job)
        view["progress_step"] = -1
        view["progress_ts"] = None
        view["rate_step"] = -1
        view["rate_ts"] = None

    def stall_seconds(self, job: str) -> Optional[float]:
        """Seconds since this job's observed step frontier last advanced
        (all scrapes failing keeps the frontier frozen, so a dead metrics
        plane reads as a stall too — by design: an unobservable gang
        cannot prove liveness). None while the lease is disarmed."""
        view = self.jobs.get(job)
        if view is None or view.get("progress_ts") is None:
            return None
        return max(0.0, self.clock() - view["progress_ts"])

    def note_stuck(self, job: str, stall_seconds: float,
                   deadline: int) -> None:
        """Record the gang_stuck verdict on the timeline with its stall
        window — the postmortem renders stuck -> restart as an incident."""
        view = self.view(job)
        self.record(job, ev.GANG_STUCK, stall_seconds=stall_seconds,
                    progress_deadline_seconds=deadline,
                    last_observed_step=self._observed_step(view))

    def partition_state(self, job: str) -> Tuple[List[int], int]:
        """(unreachable ranks, total ranks attempted) — the controller's
        partial-partition evidence after a scrape pass."""
        view = self.jobs.get(job)
        if view is None:
            return [], 0
        fed = view["federation"]
        return fed.unreachable_ranks(), len(fed.pods)

    def note_degraded(self, job: str, ranks: List[int],
                      total: int) -> None:
        """Open (or update) a partial-partition window: some ranks dark,
        the rest still reporting. Idempotent per rank set — re-observing
        the same dark set does not re-emit; a CHANGED set does (the
        window's shape is part of the incident)."""
        view = self.view(job)
        key = tuple(ranks)
        if view.get("degraded_ranks") == key:
            return
        view["degraded_ranks"] = key
        self.record(job, ev.GANG_DEGRADED, ranks=list(ranks),
                    partitioned_ranks=len(ranks), total_ranks=total,
                    last_observed_step=self._observed_step(view))

    def note_degraded_healed(self, job: str) -> None:
        """Close an open partial-partition window (every rank scraped
        again). No-op when no window is open."""
        view = self.view(job)
        if view.get("degraded_ranks"):
            view["degraded_ranks"] = None
            self.record(job, ev.GANG_DEGRADED, healed=True, ranks=[],
                        partitioned_ranks=0,
                        last_observed_step=self._observed_step(view))

    def note_packed(self, job: str, group: str, members: List[str],
                    k: int,
                    labels: Optional[Dict[str, str]] = None) -> None:
        view = self.view(job)
        if view["labels"].get("pack_group") != group:
            # PackPlan.labels() when the controller drives this; every
            # later timeline record and federated series carries them
            view["labels"].update(labels or {"pack_group": group})
            view["federation"].extra_labels.update(view["labels"])
            self.record(job, ev.JOB_PACKED, members=members, k=k)

    def note_resize(self, job: str, gang: bool = False, **fields) -> None:
        # gang=True is a user-driven spec.resize (a deliberate gang
        # resize: drain -> rescale -> resharded resume); False is the
        # elastic controller shrinking/growing around capacity.
        self.record(job, ev.GANG_RESIZE if gang else ev.JOB_RESIZED,
                    **fields)

    def note_sched(self, job: str, event: str, token: str,
                   **fields) -> None:
        """Record one fleet-scheduler decision (a sched_* event kind),
        idempotent per (event, token): the controller replays syncs
        after every crash, and each decision's status write carries the
        same token the replay re-derives — so the timeline shows each
        preempt/grow-back/migration exactly once however many times the
        sync re-runs. sched_skip is the exception (token "" = always
        emit is wrong — skips also dedupe, the hysteresis would spam one
        per sync otherwise)."""
        view = self.view(job)
        seen = view.setdefault("sched_tokens", set())
        mark = (event, token)
        if mark in seen:
            return
        seen.add(mark)
        self.record(job, event, **fields)

    def note_live_scale(self, job: str, token: str, **fields) -> None:
        """Record one surgical decode-pool scale step (LIVE_SCALE),
        idempotent per token — the note_sched discipline applied to
        live scaling: the controller writes the ``scalingReplica``
        status marker BEFORE touching the decode StatefulSet and emits
        with that marker as the token, so a crash replay (marker still
        set, replicas already landed) re-emits at most once however
        many times the sync re-runs."""
        view = self.view(job)
        seen = view.setdefault("live_scale_tokens", set())
        if token in seen:
            return
        seen.add(token)
        self.record(job, ev.LIVE_SCALE, token=token, **fields)

    def note_terminal(self, job: str, succeeded: bool, **fields) -> None:
        view = self.view(job)
        if view["terminal"]:
            return
        view["terminal"] = True
        self.record(job, ev.JOB_SUCCEEDED if succeeded else ev.JOB_FAILED,
                    **fields)
        try:
            self.write_timeline(job)
        except OSError:
            logger.warning("timeline write failed for job %s", job,
                           exc_info=True)

    # -- scraping -------------------------------------------------------
    def _scrape(self, rank: int, url: str) -> str:
        """One per-pod fetch, routed through the scrape-fault injector
        when one is installed (telemetry/chaos.py)."""
        if self.scrape_injector is not None:
            return self.scrape_injector.fetch(rank, url, self.fetch)
        return self.fetch(url)

    def observe(self, job: str, targets: Dict[int, str],
                force: bool = False, serving: bool = False) -> None:
        """Scrape each pod's /metrics and /events. ``targets`` maps
        replica_rank -> base URL (http://host:port). Rate-limited by
        scrape_interval unless forced. ``serving=True`` switches the
        job's progress frontier from the step counter to the
        retired-request/token counters (the serving progress lease)."""
        view = self.view(job)
        view["serving"] = bool(serving)
        now = self.clock()
        if not force and now - view["last_scrape"] < self.scrape_interval:
            return
        view["last_scrape"] = now
        fed = view["federation"]
        for rank, base in sorted(targets.items()):
            # netloc, not hostname: local test gangs share an IP and
            # differ only by port, and each listener is its own clock
            host = urllib.parse.urlparse(base).netloc or str(rank)
            try:
                fed.ingest(rank, self._scrape(rank, base + "/metrics"))
            except Exception:
                fed.scrape_failed(rank)
                continue
            try:
                payload = json.loads(
                    self._scrape(rank, base + "/events"))
            except Exception:
                # metrics landed; treat the events pull as best-effort
                continue
            records = payload.get("records", [])
            view["clock_sync"].note(host, self.clock(),
                                    payload.get("now", self.clock()),
                                    latest_boot_id(records))
            view["worker_records"][host] = records
            try:
                tpayload = json.loads(
                    self._scrape(rank, base + "/traces"))
            except Exception:
                # best-effort like /events: a pod without a trace sink
                # 404s here and its metrics still count
                continue
            view["traces"].ingest(host, tpayload.get("records", []),
                                  offset=view["clock_sync"].offset(host))
        self._advance_frontier(job, view, now)

    def _advance_frontier(self, job: str, view: Dict, now: float) -> None:
        """Post-ingest progress bookkeeping, shared by the scrape loop
        and ingest_push so a pushed report renews the progress lease
        exactly like a scraped one."""
        step = self._observed_step(view)
        if step > 0 and not view["first_step"]:
            view["first_step"] = True
            self.record(job, ev.FIRST_STEP_OBSERVED, step=step)
        # progress lease: (re-)arm on the first scrape of an incarnation,
        # then slide forward only when the frontier actually moves — zero
        # advance (or every scrape failing) leaves progress_ts frozen and
        # stall_seconds() growing
        if step > view["progress_step"]:
            # TPOT-slope check (serving + serving_rate_floor): an
            # advance only renews the lease when the frontier moved at
            # >= floor tokens/sec since its LAST advance. A degraded
            # engine emitting a trickle keeps advancing rate_step (so
            # the measurement window stays honest) while progress_ts
            # stays frozen — it goes stuck by the same wall-clock
            # deadline as a fully wedged one. The first advance of an
            # incarnation (rate_ts None) always arms: there is no
            # window to measure yet.
            slope_ok = True
            if (view.get("serving") and self.serving_rate_floor is not None
                    and view["rate_ts"] is not None
                    and now > view["rate_ts"]):
                rate = (step - view["rate_step"]) / (now - view["rate_ts"])
                slope_ok = rate >= self.serving_rate_floor
            view["rate_step"] = step
            view["rate_ts"] = now
            if slope_ok:
                view["progress_step"] = step
                view["progress_ts"] = now

    def ingest_push(self, job: str, rank: int, payload: Dict,
                    host: Optional[str] = None,
                    serving: Optional[bool] = None) -> bool:
        """Accept one pushed worker report (WorkerTelemetry.push_report())
        with scrape-identical bookkeeping: the metrics text feeds the
        same federation, the ``now`` stamp anchors the same clock
        correction, event records land in the same per-host cache (same
        staleness convention — a pod that stops pushing goes stale just
        like one that stops answering scrapes), and trace spans federate
        the same way. The payload is routed through the scrape-fault
        injector when one is installed, so --chaos drops/replays pushes
        on the exact surface it drops scrapes. Returns False when the
        report was lost or unparseable (counted as a failed scrape)."""
        view = self.view(job)
        if serving is not None:
            view["serving"] = bool(serving)
        now = self.clock()
        host = host or f"push-{rank}"
        fed = view["federation"]
        body = json.dumps(payload)
        try:
            if self.scrape_injector is not None:
                body = self.scrape_injector.fetch(
                    rank, f"push://{host}/report", lambda _url: body)
            report = json.loads(body)
            fed.ingest(rank, report.get("metrics", ""))
        except Exception:
            fed.scrape_failed(rank)
            return False
        records = report.get("events") or []
        view["clock_sync"].note(host, now, report.get("now", now),
                                latest_boot_id(records))
        if records:
            view["worker_records"][host] = records
        traces = report.get("traces") or []
        if traces:
            view["traces"].ingest(host, traces,
                                  offset=view["clock_sync"].offset(host))
        self._advance_frontier(job, view, now)
        return True

    def slowest_trace(self, job: str) -> Optional[int]:
        """The job's slowest completed request trace in the exemplar
        window — what an SLO-breach record attaches as its exemplar."""
        return self.view(job)["traces"].slowest_trace()

    def _observed_step(self, view: Dict) -> int:
        if view.get("serving"):
            # serving gangs have no training step: the progress frontier
            # is the retired-request/token counter sum — a wedged engine
            # stops retiring and the frontier freezes exactly like a
            # stalled step counter would
            return view["federation"].observed_tokens()
        best = view["federation"].observed_step()
        for records in view["worker_records"].values():
            for rec in records:
                for field in STEP_FIELDS:
                    if field in rec:
                        try:
                            best = max(best, int(rec[field]))
                        except (TypeError, ValueError):
                            pass
        return best

    # -- outputs --------------------------------------------------------
    def merged_records(self, job: str) -> List[Dict]:
        view = self.view(job)
        sources: List[Tuple[Optional[str], List[Dict]]] = [
            (None, view["controller_records"])]
        sources += [(host, recs)
                    for host, recs in sorted(view["worker_records"].items())]
        return merge_timeline(sources, offsets=view["clock_sync"].offsets)

    def write_timeline(self, job: str,
                       out_path: Optional[str] = None) -> str:
        if out_path is None:
            root = self.events_dir or "."
            out_path = os.path.join(root, job, "timeline.jsonl")
        view = self.view(job)
        sources = ([(None, view["controller_records"])] +
                   [(host, recs) for host, recs
                    in sorted(view["worker_records"].items())])
        max_bytes = _env_int(ENV_TIMELINE_MAX_BYTES, 0)
        if not max_bytes:
            merge_timeline(sources, offsets=view["clock_sync"].offsets,
                           out_path=out_path)
            return out_path
        # Size-capped mode: a long-lived job's full rewrite grows without
        # bound, so instead append only records not yet persisted and
        # shift the chain (events.py rotate_chain — same .N layout) when
        # the live file would blow the cap. Per-source high-water marks
        # make the append duplicate-free: the pull loop only ever extends
        # each source's record list. The batch is ts-sorted within
        # itself; cross-batch ordering is arrival order, and every
        # chain-spanning reader (postmortem.read_timeline, read_events)
        # re-sorts by ts anyway.
        keep = max(1, _env_int(ENV_TIMELINE_KEEP, 1))
        consumed: Dict[str, int] = view.setdefault("timeline_consumed", {})
        fresh = [(host, recs[consumed.get(host or "controller", 0):])
                 for host, recs in sources]
        batch = merge_timeline([(h, r) for h, r in fresh if r],
                               offsets=view["clock_sync"].offsets)
        for host, recs in sources:
            consumed[host or "controller"] = len(recs)
        parent = os.path.dirname(out_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        payload = "".join(json.dumps(rec) + "\n" for rec in batch)
        try:
            size = os.path.getsize(out_path)
        except OSError:
            size = 0
        if size and size + len(payload) > max_bytes:
            try:
                rotate_chain(out_path, keep)
            except OSError:
                logger.warning("timeline rotation failed for %s", out_path,
                               exc_info=True)
        with open(out_path, "a", encoding="utf-8") as fh:
            fh.write(payload)
        return out_path

    def render_lines(self) -> List[str]:
        lines: List[str] = []
        for job in sorted(self.jobs):
            view = self.jobs[job]
            merged = self.merged_records(job)
            lines += view["federation"].render_lines()
            lines += view["traces"].render_lines()
            lines += ledger_lines(job, goodput_ledger(merged),
                                  extra_labels=view["labels"])
            resizes = resize_ledger(merged)
            if resizes:
                lines += resize_lines(job, resizes,
                                      extra_labels=view["labels"])
        return lines

    def render(self) -> str:
        lines = self.render_lines()
        return ("\n".join(lines) + "\n") if lines else ""

    def close(self) -> None:
        if self.events is not None:
            self.events.close()


# ---------------------------------------------------------------------------
# CLI — the harness-side controller stand-in
# ---------------------------------------------------------------------------

def _parse_kv(pairs: List[str]) -> Dict:
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"expected k=v, got {pair!r}")
        k, v = pair.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpi_operator_tpu_torch.telemetry.collector",
        description="job-level event collection: emit controller events, "
                    "merge timelines, compute the goodput ledger")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_emit = sub.add_parser("emit", help="append one controller event")
    p_emit.add_argument("--log", required=True)
    p_emit.add_argument("--job", required=True)
    p_emit.add_argument("event")
    p_emit.add_argument("fields", nargs="*", help="k=v extra fields")

    p_merge = sub.add_parser("merge", help="merge controller + worker "
                             "event logs into one timeline")
    p_merge.add_argument("--job", required=True)
    p_merge.add_argument("--controller", required=True,
                         help="controller events.jsonl")
    p_merge.add_argument("--worker", action="append", default=[],
                         metavar="HOST=PATH", help="worker event log")
    p_merge.add_argument("--offset", action="append", default=[],
                         metavar="HOST=SECONDS",
                         help="clock offset to ADD to that host's ts")
    p_merge.add_argument("--out", required=True, help="timeline.jsonl")
    p_merge.add_argument("--metrics-out", default=None,
                         help="write federated goodput series here")

    args = parser.parse_args(argv)
    if args.cmd == "emit":
        with EventLog(args.log) as log:
            log.emit(args.event, job=args.job, **_parse_kv(args.fields))
        return 0

    # merge
    controller = [r for r in read_events(args.controller)
                  if r.get("job", args.job) == args.job]
    sources: List[Tuple[Optional[str], List[Dict]]] = [(None, controller)]
    for spec in args.worker:
        if "=" not in spec:
            raise SystemExit(f"--worker expects HOST=PATH, got {spec!r}")
        host, path = spec.split("=", 1)
        sources.append((host, read_events(path)))
    offsets = {k: float(v) for k, v in _parse_kv(args.offset).items()}
    merged = merge_timeline(sources, offsets=offsets, out_path=args.out)
    ledger = goodput_ledger(merged)
    resizes = resize_ledger(merged)
    if args.metrics_out:
        lines = ledger_lines(args.job, ledger)
        if resizes:
            lines += resize_lines(args.job, resizes)
        with open(args.metrics_out, "w", encoding="utf-8") as fh:
            fh.write("\n".join(lines) + "\n")
    print(json.dumps({"job": args.job, "records": len(merged),
                      "timeline": args.out, "resizes": resizes, **ledger}))
    return 0


if __name__ == "__main__":
    sys.exit(main())


__all__ = ["parse_prometheus", "MetricsFederation", "ClockSync",
           "TraceFederation", "merge_timeline", "goodput_ledger",
           "ledger_lines", "resize_ledger", "resize_lines",
           "RESIZE_BUCKETS", "JobObservatory", "latest_boot_id", "main",
           "WORKER_PREFIX", "ROUTER_PREFIX", "JOB_PREFIX"]
