"""Deterministic data-plane fault injection for collector scrapes.

The PyTorch port's own copy of mpi_operator_tpu/telemetry/chaos.py: the
port imports nothing of the JAX package, not even its framework-free
modules. Its logic and names are the reference's, held to it by
tests/test_torch_data_plane_chaos.py.

cluster/chaos.py injects faults into the CONTROL plane (API-server
verbs); this module injects them into the DATA plane: the per-pod
/metrics + /events fetches the JobObservatory makes each scrape pass.
The failure taxonomy follows what pod-scale operation actually sees
(PAPERS.md, "Exploring the limits of Concurrency in ML Training on
Google TPUs"): partial-host degradation — stragglers, flaky links,
asymmetric partitions — dominates over clean whole-job deaths.

Rule syntax mirrors cluster/chaos.py (`<verb>/<kind>=<rate>:<error>`
there): here a rule is ``<rank>/<kind>=<rate>`` where `<rank>` is a
worker rank or ``*`` and `<kind>` is one of

  fail              the fetch raises (one flaky scrape; the collector's
                    existing scrape_failed path absorbs it)
  delay             the fetch returns the PREVIOUS fetch's payload and
                    stashes the fresh one for next time (a slow link:
                    data arrives, one cycle late; the first delayed
                    fetch has nothing lagged yet and times out instead)
  stale-replay      the fetch replays the last payload this url ever
                    returned (a stuck proxy/cache: the frontier reads
                    the same step twice — must NOT look like progress)
  partition-window  the fetch raises AND opens a window: the next
                    `partition_fetches` fetches of this rank all raise
                    too (an asymmetric network partition — one rank
                    dark for a stretch while its peers keep reporting)

A rule may carry a time-varying **burst** modifier —
``<rank>/<kind>=<rate>:burst:<period>/<duty>`` — which turns the flat
rate into a square wave over the rank's own fetch count: within every
window of ``period`` fetches the rule is live for the first
``duty * period`` fetches (rate applies) and silent for the rest (rate
0). A soak under ``*/fail=0.6:burst:8/0.25`` therefore oscillates
between fault storms and calm stretches, which is exactly the shape
that exercises lease re-arm paths: a lease must survive the storm
without a false-positive expiry AND re-arm promptly in the calm.

Determinism: one seeded random.Random, rolled once per matching live
rule in the collector's sorted-rank fetch order, plus per-rank fetch
counters that advance on every fetch — a given (seed, rules, lifecycle
sequence) replays the identical fault sequence AND burst phasing, which
is what lets the chaos soak print a reproducer seed that actually
reproduces.

Like FaultingAPIServer, the first matching rule wins and every injected
error message carries ``(seed=N)`` so a failure in a larger harness is
attributable to its soak at a glance. Burst-windowed injections
additionally name their window index — ``(seed=N, burst=W)`` — because
a seed alone pins the roll sequence but not WHICH oscillation the fault
landed in; with the index a reproducer can fast-forward straight to the
offending burst instead of replaying the whole soak.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

#: the data-plane fault taxonomy (see module docstring)
SCRAPE_FAULT_KINDS = ("fail", "delay", "stale-replay", "partition-window")

#: fetches a partition-window fault keeps a rank dark for, by default —
#: long enough to span several scrape passes, short enough that a soak
#: sees the heal
DEFAULT_PARTITION_FETCHES = 3


@dataclasses.dataclass(frozen=True)
class ScrapeFaultRule:
    """``<rank>/<kind>=<rate>[:burst:<period>/<duty>]`` — rank ``*``
    matches every rank. With a burst modifier the rule is only live
    during the leading ``duty`` fraction of every ``period``-fetch
    window of the rank's own fetch count (a square wave; see module
    docstring)."""
    rank: str
    kind: str
    rate: float
    burst_period: Optional[int] = None
    burst_duty: Optional[float] = None

    def __post_init__(self):
        if self.kind not in SCRAPE_FAULT_KINDS:
            raise ValueError(
                f"unknown scrape fault kind {self.kind!r}; known: "
                f"{', '.join(SCRAPE_FAULT_KINDS)}")
        if not (self.rank == "*" or self.rank.isdigit()):
            raise ValueError(
                f"rank must be '*' or a non-negative integer, "
                f"got {self.rank!r}")
        if not (0.0 < self.rate <= 1.0):
            raise ValueError(
                f"rate must be in (0, 1], got {self.rate}")
        if (self.burst_period is None) != (self.burst_duty is None):
            raise ValueError(
                "burst_period and burst_duty must be set together")
        if self.burst_period is not None:
            if self.burst_period < 2:
                raise ValueError(
                    f"burst period must be >= 2 fetches, "
                    f"got {self.burst_period}")
            if not (0.0 < self.burst_duty < 1.0):
                raise ValueError(
                    f"burst duty must be in (0, 1), got {self.burst_duty} "
                    f"(duty 1 is just a flat rate — drop the modifier)")

    @classmethod
    def parse(cls, text: str) -> "ScrapeFaultRule":
        head, sep, tail = text.partition("=")
        rank, sep2, kind = head.partition("/")
        rate, _, modifier = tail.partition(":")
        if not sep or not sep2 or not rank or not kind or not rate:
            raise ValueError(
                f"bad scrape fault rule {text!r}; want "
                f"'<rank>/<kind>=<rate>[:burst:<period>/<duty>]' "
                f"(e.g. '*/fail=0.2', '3/partition-window=0.05', "
                f"'*/fail=0.6:burst:8/0.25')")
        try:
            rate_f = float(rate)
        except ValueError:
            raise ValueError(f"bad rate in scrape fault rule {text!r}")
        period = duty = None
        if modifier:
            mkind, _, spec = modifier.partition(":")
            p_s, psep, d_s = spec.partition("/")
            if mkind != "burst" or not psep or not p_s or not d_s:
                raise ValueError(
                    f"bad modifier in scrape fault rule {text!r}; want "
                    f":burst:<period>/<duty> (e.g. ':burst:8/0.25')")
            try:
                period, duty = int(p_s), float(d_s)
            except ValueError:
                raise ValueError(
                    f"bad burst period/duty in scrape fault rule {text!r}")
        return cls(rank=rank.strip(), kind=kind.strip(), rate=rate_f,
                   burst_period=period, burst_duty=duty)

    def matches(self, rank: int) -> bool:
        return self.rank == "*" or int(self.rank) == rank

    # -- burst phasing ----------------------------------------------------

    def burst_index(self, fetch_index: int) -> Optional[int]:
        """Which oscillation window a fetch lands in (None: no burst)."""
        if self.burst_period is None:
            return None
        return fetch_index // self.burst_period

    def live(self, fetch_index: int) -> bool:
        """Whether the rule's rate applies at this fetch of the rank.
        Rules without a burst modifier are always live; burst rules are
        live for the leading ceil-free ``duty * period`` fetches of each
        window (at least one fetch per window, by the duty bounds)."""
        if self.burst_period is None:
            return True
        phase = fetch_index % self.burst_period
        return phase < self.burst_duty * self.burst_period


class ScrapeFaultInjector:
    """Seeded fault layer between the JobObservatory and its fetcher.

    The observatory calls ``fetch(rank, url, real_fetch)`` for every
    per-pod fetch; this either passes through to ``real_fetch(url)``,
    raises an injected IOError, or returns a delayed/replayed payload,
    per the rules. State (last payloads, open partition windows) is per
    injector — one injector per soak, like one FaultingAPIServer per
    harness.
    """

    def __init__(self, rules: Sequence[Union[str, ScrapeFaultRule]] = (),
                 seed: int = 0,
                 partition_fetches: int = DEFAULT_PARTITION_FETCHES):
        self.rules: Tuple[ScrapeFaultRule, ...] = tuple(
            r if isinstance(r, ScrapeFaultRule) else ScrapeFaultRule.parse(r)
            for r in rules)
        self.seed = seed
        self.rng = random.Random(seed)
        self.partition_fetches = int(partition_fetches)
        #: url -> last payload actually handed to the collector
        self._last: Dict[str, str] = {}
        #: url -> fresh payload held back by a delay fault
        self._lag: Dict[str, str] = {}
        #: rank -> failing fetches remaining in its partition window
        self._partition: Dict[int, int] = {}
        #: rank -> fetches seen, the clock burst phasing runs on
        self._fetches: Dict[int, int] = {}
        #: (rank, kind) -> injections, the soak-report evidence that the
        #: configured mix actually fired (mirrors FaultingAPIServer)
        self.faults_injected: Dict[Tuple[int, str], int] = {}
        #: (rank, burst window index) pairs that actually injected — a
        #: soak asserts len(set of windows) >= 2 to prove the oscillation
        #: spanned storms, not one lucky streak
        self.bursts_fired: List[Tuple[int, int]] = []

    # -- bookkeeping ------------------------------------------------------

    def _count(self, rank: int, kind: str) -> None:
        key = (rank, kind)
        self.faults_injected[key] = self.faults_injected.get(key, 0) + 1

    def fault_count(self, kind: Optional[str] = None) -> int:
        """Total injections, optionally restricted to one kind."""
        return sum(n for (_, k), n in self.faults_injected.items()
                   if kind is None or k == kind)

    def partitioned_ranks(self) -> List[int]:
        """Ranks whose partition window is currently open."""
        return sorted(r for r, n in self._partition.items() if n > 0)

    def burst_windows_hit(self) -> int:
        """Distinct (rank, window index) bursts that actually injected."""
        return len(set(self.bursts_fired))

    def _roll(self, rank: int,
              fetch_index: int) -> Tuple[Optional[str], Optional[int]]:
        """(kind, burst window index) of the first rule that fires, or
        (None, None). The rng is only rolled for LIVE rules so a burst
        rule's silent phase consumes no randomness — phasing and rolls
        stay independently reproducible."""
        for rule in self.rules:
            if not (rule.matches(rank) and rule.live(fetch_index)):
                continue
            if self.rng.random() < rule.rate:
                burst = rule.burst_index(fetch_index)
                if burst is not None:
                    self.bursts_fired.append((rank, burst))
                return rule.kind, burst
        return None, None

    def _tag(self, burst: Optional[int]) -> str:
        """The reproducer suffix every injected message carries: the
        seed always, plus the burst window index when the fault came
        from an oscillating rule (a seed pins the roll sequence; the
        index pins WHICH storm, so a reproducer can skip straight
        there)."""
        if burst is None:
            return f"(seed={self.seed})"
        return f"(seed={self.seed}, burst={burst})"

    # -- the fetch wrapper ------------------------------------------------

    def fetch(self, rank: int, url: str,
              real_fetch: Callable[[str], str]) -> str:
        """One per-pod fetch, faults applied. An OPEN partition window
        dominates any roll (the rank is dark, full stop); otherwise the
        first matching live rule that fires decides the fault."""
        fetch_index = self._fetches.get(rank, 0)
        self._fetches[rank] = fetch_index + 1
        left = self._partition.get(rank, 0)
        if left > 0:
            self._partition[rank] = left - 1
            self._count(rank, "partition-window")
            raise IOError(
                f"injected: rank {rank} partitioned, {url} unreachable "
                f"{self._tag(None)}")
        kind, burst = self._roll(rank, fetch_index)
        if kind == "fail":
            self._count(rank, "fail")
            raise IOError(
                f"injected: scrape of rank {rank} failed ({url}) "
                f"{self._tag(burst)}")
        if kind == "partition-window":
            self._partition[rank] = self.partition_fetches
            self._count(rank, "partition-window")
            raise IOError(
                f"injected: rank {rank} partition window opened "
                f"({self.partition_fetches} fetches dark) "
                f"{self._tag(burst)}")
        if kind == "stale-replay" and url in self._last:
            # replay WITHOUT refreshing _last: consecutive stale-replays
            # keep serving the same snapshot, like a genuinely stuck
            # cache would
            self._count(rank, "stale-replay")
            return self._last[url]
        if kind == "delay":
            # the slow link still delivers: hold the fresh payload back
            # one cycle and serve the previously held one. First delay
            # on a url has nothing held yet — that one times out.
            fresh = real_fetch(url)
            lagged = self._lag.pop(url, None)
            self._lag[url] = fresh
            self._count(rank, "delay")
            if lagged is None:
                raise IOError(
                    f"injected: scrape of rank {rank} timed out ({url}) "
                    f"{self._tag(burst)}")
            self._last[url] = lagged
            return lagged
        text = real_fetch(url)
        self._last[url] = text
        return text


__all__ = ["DEFAULT_PARTITION_FETCHES", "SCRAPE_FAULT_KINDS",
           "ScrapeFaultInjector", "ScrapeFaultRule"]
