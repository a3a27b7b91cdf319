"""In-memory API server: the state layer the controller converges against.

This plays the role of the Kubernetes API server plus the generated clientset
(reference pkg/client/clientset/versioned/typed/kubeflow/v1alpha1/mpijob.go:
37-48 — Create/Update/UpdateStatus/Delete/Get/List/Watch/Patch) and doubles
as the *fake* used by tests: like k8s.io/client-go/testing's object tracker
(reference test usage at mpi_job_controller_test.go:145-146), every mutation
is recorded as an Action so tests can assert the exact ordered write set
(the reference's oracle, mpi_job_controller_test.go:271-311).

Semantics mirrored from the real API server where the controller depends on
them:
  - resourceVersion monotonically increases per object on every write
    (informer UpdateFunc compares RVs to skip resyncs,
    mpi_job_controller.go:221-227);
  - Create of an existing name fails AlreadyExists; Get of a missing name
    fails NotFound (lister Get returns typed NotFound,
    pkg/client/listers/.../mpijob.go:80-90);
  - watch events fan out synchronously to subscribers (informers).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .resources import deepcopy_resource


class ApiError(Exception):
    def __init__(self, reason: str, message: str):
        self.reason = reason
        super().__init__(message)


class NotFoundError(ApiError):
    def __init__(self, kind: str, key: str):
        super().__init__("NotFound", f"{kind} {key!r} not found")


class AlreadyExistsError(ApiError):
    def __init__(self, kind: str, key: str):
        super().__init__("AlreadyExists", f"{kind} {key!r} already exists")


class ConflictError(ApiError):
    def __init__(self, kind: str, key: str, msg: str = ""):
        super().__init__("Conflict", f"{kind} {key!r} conflict: {msg}")


#: reasons the real API server hands back for failures that are safe to
#: retry verbatim (apimachinery errors.SuggestsClientDelay /
#: IsServerTimeout / IsTooManyRequests / IsServiceUnavailable): nothing
#: about the request was wrong, the server just couldn't take it now.
TRANSIENT_REASONS = ("ServerTimeout", "TooManyRequests", "ServiceUnavailable")


class TransientApiError(ApiError):
    """A retryable server-side failure (timeout / overload / unavailable).

    The chaos layer (cluster/chaos.py) raises these; the controller's
    discipline is client-go's: never give up the key, requeue it via
    RateLimitingQueue.add_rate_limited and let backoff absorb the storm.
    """

    def __init__(self, reason: str, message: str):
        if reason not in TRANSIENT_REASONS:
            raise ValueError(f"not a transient reason: {reason!r}")
        super().__init__(reason, message)


def is_transient(err: BaseException) -> bool:
    """True when `err` is a retry-verbatim API failure (see TRANSIENT_REASONS).
    Classification helper for requeue metrics and retry loops."""
    return isinstance(err, ApiError) and err.reason in TRANSIENT_REASONS


@dataclass(frozen=True)
class Action:
    """ref: k8stesting.Action — verbs observed by checkAction
    (mpi_job_controller_test.go:271-311)."""
    verb: str              # create | update | update-status | delete | get | list
    kind: str
    namespace: str
    name: str
    obj: object = None

    def matches(self, verb: str, kind: str) -> bool:
        return self.verb == verb and self.kind == kind


WatchHandler = Callable[[str, object, Optional[object]], None]
# signature: (event_type in {"ADDED","MODIFIED","DELETED"}, obj, old_obj)


class InMemoryAPIServer:
    """Typed object store with actions + watch, one instance per test/process."""

    #: verbs that are reads — filtered out of recorded actions by default,
    #: mirroring filterInformerActions (mpi_job_controller_test.go:316-344)
    READ_VERBS = ("get", "list", "watch")

    #: bound on recorded actions so a long-running controller doesn't leak
    #: memory linearly with write count (tests clear_actions() between
    #: phases anyway, so a generous ring buffer is invisible to them)
    MAX_RECORDED_ACTIONS = 10_000

    def __init__(self):
        self._lock = threading.RLock()
        # (kind, namespace, name) -> object
        self._store: Dict[Tuple[str, str, str], object] = {}
        self._rv = itertools.count(1)
        self._uid = itertools.count(1)
        self.actions: "deque[Action]" = deque(maxlen=self.MAX_RECORDED_ACTIONS)
        self._watchers: Dict[str, List[WatchHandler]] = {}
        # admission validators per kind — the analogue of the reference CRD's
        # openAPIV3 schema (deploy/0-crd.yaml:16-99): invalid objects are
        # rejected at create/update time, before any controller sees them.
        self._admission: Dict[str, Callable[[object], None]] = {}

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def _key(obj) -> Tuple[str, str, str]:
        return (obj.kind, obj.metadata.namespace, obj.metadata.name)

    def _record(self, verb: str, obj) -> None:
        self.actions.append(
            Action(
                verb=verb,
                kind=obj.kind,
                namespace=obj.metadata.namespace,
                name=obj.metadata.name,
                obj=deepcopy_resource(obj),
            )
        )

    def _notify(self, kind: str, event: str, obj, old=None) -> None:
        for handler in self._watchers.get(kind, []):
            handler(event, deepcopy_resource(obj), deepcopy_resource(old) if old else None)

    def clear_actions(self) -> None:
        with self._lock:
            self.actions.clear()

    def write_actions(self) -> List[Action]:
        """Actions excluding reads AND Event posts — the test oracle's view.
        The reference tests never see events because they swap in a
        record.FakeRecorder (mpi_job_controller_test.go:177); here the
        recorder posts through this same server, so the oracle filters the
        Event kind instead (the filterInformerActions analogue). Tests that
        assert on events read them via list("Event") or recorder.events."""
        return [a for a in self.actions
                if a.verb not in self.READ_VERBS and a.kind != "Event"]

    # -- admission ----------------------------------------------------------

    class AdmissionError(ApiError):
        def __init__(self, kind: str, message: str):
            super(InMemoryAPIServer.AdmissionError, self).__init__(
                "Invalid", f"{kind} admission denied: {message}")

    def register_admission_validator(
        self, kind: str, validator: Callable[[object], None]
    ) -> None:
        """Register a per-kind validator called on create/update; it raises
        to reject (the CRD-schema analogue, ref deploy/0-crd.yaml:16-99)."""
        with self._lock:
            self._admission[kind] = validator

    def _admit(self, obj) -> None:
        validator = self._admission.get(obj.kind)
        if validator is not None:
            try:
                validator(obj)
            except Exception as exc:   # noqa: BLE001 — wrap into typed error
                raise InMemoryAPIServer.AdmissionError(obj.kind, str(exc)) from exc

    # -- watch --------------------------------------------------------------

    def watch(self, kind: str, handler: WatchHandler,
              namespace: Optional[str] = None) -> None:
        # namespace accepted for interface parity with KubeAPIServer.watch;
        # events fan out unfiltered and the Informer filters by namespace.
        del namespace
        with self._lock:
            self._watchers.setdefault(kind, []).append(handler)

    def drop_watchers(self) -> None:
        """Sever every watch connection — the analogue of the watching
        client dying (or the API server restarting its watch streams).
        Nothing is delivered to dropped handlers afterwards; informers
        recover by re-listing. The chaos harness calls this when it kills
        a controller so zombie informers stop receiving fan-out."""
        with self._lock:
            self._watchers.clear()

    # -- CRUD (ref clientset verbs, mpijob.go:37-48) ------------------------

    def create(self, obj):
        with self._lock:
            key = self._key(obj)
            if key in self._store:
                raise AlreadyExistsError(obj.kind, f"{key[1]}/{key[2]}")
            self._admit(obj)
            obj = deepcopy_resource(obj)
            obj.metadata.resource_version = next(self._rv)
            if not obj.metadata.uid:
                obj.metadata.uid = f"uid-{next(self._uid)}"
            if obj.metadata.creation_timestamp is None:
                # real API servers stamp this; the fleet scheduler's
                # creation-order tie-breaking depends on it
                obj.metadata.creation_timestamp = time.time()
            self._store[key] = obj
            self._record("create", obj)
            self._notify(obj.kind, "ADDED", obj)
            return deepcopy_resource(obj)

    def update(self, obj, *, subresource: Optional[str] = None):
        with self._lock:
            key = self._key(obj)
            old = self._store.get(key)
            if old is None:
                raise NotFoundError(obj.kind, f"{key[1]}/{key[2]}")
            self._admit(obj)
            obj = deepcopy_resource(obj)
            if subresource == "status" and hasattr(old, "spec"):
                # real /status semantics: only .status changes; the caller's
                # spec/metadata edits are discarded (mirrors an API server
                # with the status subresource enabled, deploy/0-crd.yaml)
                merged = deepcopy_resource(old)
                merged.status = obj.status
                obj = merged
            obj.metadata.resource_version = next(self._rv)
            obj.metadata.uid = old.metadata.uid
            self._store[key] = obj
            self._record("update-status" if subresource == "status" else "update", obj)
            self._notify(obj.kind, "MODIFIED", obj, old)
            return deepcopy_resource(obj)

    def update_status(self, obj):
        """ref: UpdateStatus (mpijob.go:41). The v1alpha1 controller actually
        uses full-object Update (mpi_job_controller.go:789); we expose both."""
        return self.update(obj, subresource="status")

    def get(self, kind: str, namespace: str, name: str):
        with self._lock:
            obj = self._store.get((kind, namespace, name))
            if obj is None:
                raise NotFoundError(kind, f"{namespace}/{name}")
            return deepcopy_resource(obj)

    def try_get(self, kind: str, namespace: str, name: str):
        try:
            return self.get(kind, namespace, name)
        except NotFoundError:
            return None

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[str] = None) -> List[object]:
        selector = {}
        for clause in (label_selector or "").split(","):
            if "=" in clause:
                k, _, v = clause.partition("=")
                selector[k.strip()] = v.strip()
        with self._lock:
            return [
                deepcopy_resource(o)
                for (k, ns, _), o in sorted(self._store.items())
                if k == kind and (namespace is None or ns == namespace)
                and all(o.metadata.labels.get(sk) == sv
                        for sk, sv in selector.items())
            ]

    def delete(self, kind: str, namespace: str, name: str) -> None:
        with self._lock:
            key = (kind, namespace, name)
            obj = self._store.get(key)
            if obj is None:
                raise NotFoundError(kind, f"{namespace}/{name}")
            del self._store[key]
            self._record("delete", obj)
            self._notify(kind, "DELETED", obj)

    # -- garbage collection (ref SURVEY §3.4: K8s GC cascades via
    #    ownerReferences; the controller has no delete logic of its own) ----

    def cascade_delete(self, owner_uid: str) -> List[Tuple[str, str, str]]:
        """Delete every object whose controller ownerReference has owner_uid.
        The real cluster's GC does this; tests call it to simulate."""
        with self._lock:
            doomed = [
                key
                for key, obj in self._store.items()
                if any(
                    ref.controller and ref.uid == owner_uid
                    for ref in obj.metadata.owner_references
                )
            ]
            for kind, ns, name in doomed:
                self.delete(kind, ns, name)
            return doomed


__all__ = [
    "InMemoryAPIServer", "Action",
    "ApiError", "NotFoundError", "AlreadyExistsError", "ConflictError",
    "TransientApiError", "is_transient", "TRANSIENT_REASONS",
]
