"""Seeded API fault injection: the failures Kubernetes actually throws.

A controller that only ever sees a healthy API server is untested where
it matters. The real control plane serves transient 500s under etcd
pressure, 409 Conflicts on stale resourceVersions, list responses from a
lagging watch cache, and silently drops watch events across apiserver
restarts. `FaultingAPIServer` wraps the in-memory server and injects all
four, per verb/kind rule, from a seeded RNG — so every chaos failure is
replayable from its seed alone.

Fault-rule syntax (one rule per string, first matching rule rolls)::

    <verb>/<kind>=<rate>:<error>

    update-status/TPUJob=0.3:conflict    30% of TPUJob status PUTs 409
    mutate/*=0.1:transient               10% of all writes time out
    get/*=0.05:stale                     5% of reads return the prior RV
    watch/*=0.05:drop                    5% of watch events vanish

Verbs: create | update | update-status | delete | get | list | watch,
plus the alias ``mutate`` (all four write verbs) and ``*``. Errors:
``transient`` (retryable TransientApiError, write NOT applied),
``conflict`` (ConflictError, write NOT applied), ``stale`` (get returns
the previous version of the object), ``drop`` (watch handler never sees
the event — the informer cache stays stale until the next event or a
full re-list).

The same wrapper doubles as the crash-consistency instrument: arm_crash(n)
raises ControllerCrash — a BaseException, so no ``except Exception`` in
the controller can absorb it, exactly like SIGKILL — after the next n
recorded write actions LAND. The write persists; the controller never
sees the response. A harness (controller/chaos.py) restarts a fresh
controller against the same store and asserts convergence.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .apiserver import ConflictError, NotFoundError, TransientApiError
from .resources import deepcopy_resource

MUTATING_VERBS = ("create", "update", "update-status", "delete")
FAULT_KINDS = ("transient", "conflict", "stale", "drop")


class ControllerCrash(BaseException):
    """The controller process dying mid-sync. BaseException on purpose:
    best-effort ``except Exception`` guards (event posting, pod-delete
    sweeps, the workqueue requeue path) must NOT survive it, the same way
    they don't survive SIGKILL."""


@dataclass(frozen=True)
class FaultRule:
    verb: str = "*"        # verb, "mutate" (all write verbs), or "*"
    kind: str = "*"        # resource kind or "*"
    rate: float = 0.0      # probability per matching call, [0, 1]
    error: str = "transient"

    def __post_init__(self):
        if self.error not in FAULT_KINDS:
            raise ValueError(f"unknown fault error {self.error!r}; "
                             f"expected one of {FAULT_KINDS}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"fault rate must be in [0,1], got {self.rate}")

    @classmethod
    def parse(cls, text: str) -> "FaultRule":
        """Parse ``<verb>/<kind>=<rate>:<error>`` (see module docstring)."""
        try:
            match, _, error = text.partition(":")
            target, _, rate = match.partition("=")
            verb, _, kind = target.partition("/")
            return cls(verb=verb.strip(), kind=kind.strip() or "*",
                       rate=float(rate), error=error.strip() or "transient")
        except (ValueError, TypeError) as exc:
            if isinstance(exc, ValueError) and "fault" in str(exc):
                raise
            raise ValueError(
                f"bad fault rule {text!r}; expected "
                f"'<verb>/<kind>=<rate>:<error>'") from exc

    def matches(self, verb: str, kind: str) -> bool:
        if self.verb == "mutate":
            verb_ok = verb in MUTATING_VERBS
        else:
            verb_ok = self.verb in ("*", verb)
        return verb_ok and self.kind in ("*", kind)


class FaultingAPIServer:
    """InMemoryAPIServer wrapper injecting seeded faults per FaultRule.

    Interface-compatible with InMemoryAPIServer at every surface the
    controller and tests use (CRUD, watch, admission, actions). Faults on
    mutating verbs fire BEFORE the write applies — the request never
    reached the store, the client must retry. Stale reads serve the
    previous version of the object (a lagging watch cache). Dropped watch
    events are swallowed between the server and ONE subscriber, so
    different informers can diverge, like real per-connection drops.
    """

    def __init__(self, inner, rules: Sequence[Union[FaultRule, str]] = (),
                 seed: int = 0):
        self.inner = inner
        self.seed = seed
        self.rng = random.Random(seed)
        self.rules: List[FaultRule] = [
            r if isinstance(r, FaultRule) else FaultRule.parse(r)
            for r in rules
        ]
        #: (verb, error) -> count of injected faults, for assertions and
        #: the soak report
        self.faults_injected: Dict[Tuple[str, str], int] = {}
        # previous stored version per key, maintained at write time so a
        # "stale" read can serve what a lagging watch cache would
        self._stale: Dict[Tuple[str, str, str], object] = {}
        self._crash_after: Optional[int] = None
        self.writes = 0
        self.crashes = 0

    # -- fault machinery ----------------------------------------------------

    def _roll(self, verb: str, kind: str) -> Optional[str]:
        for rule in self.rules:
            if rule.matches(verb, kind) and self.rng.random() < rule.rate:
                return rule.error
        return None

    def _count(self, verb: str, error: str) -> None:
        key = (verb, error)
        self.faults_injected[key] = self.faults_injected.get(key, 0) + 1

    def _maybe_fail_write(self, verb: str, kind: str, key: str) -> None:
        error = self._roll(verb, kind)
        if error == "transient":
            self._count(verb, error)
            raise TransientApiError(
                "ServerTimeout",
                f"injected: {verb} {kind} {key!r} timed out (seed={self.seed})")
        if error == "conflict":
            self._count(verb, error)
            raise ConflictError(
                kind, key,
                "injected: the object has been modified; please apply your "
                "changes to the latest version and try again")
        # "stale"/"drop" rules never match write verbs meaningfully; a
        # match is simply ignored rather than misapplied.

    def _note_write(self, kind: str, store_key: Tuple[str, str, str]) -> None:
        """Bookkeeping AFTER a write landed: stale-read history and the
        crash countdown. Event posts are excluded from crash boundaries —
        write_actions() (the oracle) filters them too."""
        if kind == "Event":
            return
        self.writes += 1
        if self._crash_after is not None:
            self._crash_after -= 1
            if self._crash_after <= 0:
                self._crash_after = None
                self.crashes += 1
                raise ControllerCrash(
                    f"injected crash after write #{self.writes}")

    def _snapshot_prev(self, kind: str, namespace: str, name: str) -> None:
        prev = self.inner.try_get(kind, namespace, name)
        if prev is not None:
            self._stale[(kind, namespace, name)] = prev

    def arm_crash(self, after_writes: int = 1) -> None:
        """Raise ControllerCrash after the next `after_writes` non-Event
        writes land. One-shot: the crash disarms itself when it fires."""
        self._crash_after = after_writes

    def disarm_crash(self) -> None:
        self._crash_after = None

    def fault_count(self, error: Optional[str] = None) -> int:
        return sum(n for (_, e), n in self.faults_injected.items()
                   if error is None or e == error)

    # -- pass-throughs ------------------------------------------------------

    @property
    def actions(self):
        return self.inner.actions

    def clear_actions(self) -> None:
        self.inner.clear_actions()

    def write_actions(self):
        return self.inner.write_actions()

    def register_admission_validator(self, kind, validator) -> None:
        self.inner.register_admission_validator(kind, validator)

    def cascade_delete(self, owner_uid: str):
        # GC is the cluster's job, not a controller request — no faults.
        return self.inner.cascade_delete(owner_uid)

    def drop_watchers(self) -> None:
        self.inner.drop_watchers()

    # -- faulted verbs ------------------------------------------------------

    def create(self, obj):
        ns, name = obj.metadata.namespace, obj.metadata.name
        self._maybe_fail_write("create", obj.kind, f"{ns}/{name}")
        out = self.inner.create(obj)
        self._note_write(obj.kind, (obj.kind, ns, name))
        return out

    def update(self, obj, *, subresource: Optional[str] = None):
        verb = "update-status" if subresource == "status" else "update"
        ns, name = obj.metadata.namespace, obj.metadata.name
        self._maybe_fail_write(verb, obj.kind, f"{ns}/{name}")
        self._snapshot_prev(obj.kind, ns, name)
        out = self.inner.update(obj, subresource=subresource)
        self._note_write(obj.kind, (obj.kind, ns, name))
        return out

    def update_status(self, obj):
        return self.update(obj, subresource="status")

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self._maybe_fail_write("delete", kind, f"{namespace}/{name}")
        self._snapshot_prev(kind, namespace, name)
        self.inner.delete(kind, namespace, name)
        self._note_write(kind, (kind, namespace, name))

    def get(self, kind: str, namespace: str, name: str):
        if self._roll("get", kind) == "stale":
            prev = self._stale.get((kind, namespace, name))
            if prev is not None:
                self._count("get", "stale")
                return deepcopy_resource(prev)
        return self.inner.get(kind, namespace, name)

    def try_get(self, kind: str, namespace: str, name: str):
        try:
            return self.get(kind, namespace, name)
        except NotFoundError:
            return None

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[str] = None):
        # list-level staleness would need a full store history; the rule
        # machinery accepts list rules but only transient errors fire here
        error = self._roll("list", kind)
        if error == "transient":
            self._count("list", error)
            raise TransientApiError(
                "ServerTimeout",
                f"injected: list {kind} timed out (seed={self.seed})")
        return self.inner.list(kind, namespace=namespace,
                               label_selector=label_selector)

    def watch(self, kind: str, handler, namespace: Optional[str] = None) -> None:
        def chaotic(event: str, obj, old=None):
            if self._roll("watch", kind) == "drop":
                self._count("watch", "drop")
                return
            handler(event, obj, old)

        self.inner.watch(kind, chaotic, namespace=namespace)


__all__ = ["FaultingAPIServer", "FaultRule", "ControllerCrash",
           "MUTATING_VERBS", "FAULT_KINDS"]
