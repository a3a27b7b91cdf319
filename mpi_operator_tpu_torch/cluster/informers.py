"""Shared informers + listers over the in-memory API server.

ref: generated informer/lister machinery
(pkg/client/informers/externalversions/kubeflow/v1alpha1/mpijob.go:34-87,
 pkg/client/listers/kubeflow/v1alpha1/mpijob.go:27-92).

An Informer keeps a local indexer cache fed by watch events and dispatches
add/update/delete handlers; a Lister is the read-only view of that cache.
The reference registers 8 informers (mpi_job_controller.go:204-321); update
handlers skip pure resyncs by comparing resourceVersions (:221-227) — we
preserve that contract so controller logic can rely on it.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from .apiserver import InMemoryAPIServer, NotFoundError
from .resources import deepcopy_resource


class Lister:
    """Read-only indexed cache access; Get raises typed NotFound
    (ref pkg/client/listers/.../mpijob.go:80-90)."""

    def __init__(self, informer: "Informer"):
        self._informer = informer

    def get(self, namespace: str, name: str):
        obj = self._informer.cache_get(namespace, name)
        if obj is None:
            raise NotFoundError(self._informer.kind, f"{namespace}/{name}")
        return obj

    def try_get(self, namespace: str, name: str):
        return self._informer.cache_get(namespace, name)

    def list(self, namespace: Optional[str] = None) -> List[object]:
        return self._informer.cache_list(namespace)


class Informer:
    """List/watch cache with event handlers, namespace-scoped optionally
    (ref cmd/mpi-operator/main.go:63-71 WithNamespace)."""

    def __init__(self, api: InMemoryAPIServer, kind: str,
                 namespace: Optional[str] = None):
        self.api = api
        self.kind = kind
        self.namespace = namespace
        self._lock = threading.RLock()
        self._cache: Dict[Tuple[str, str], object] = {}
        self._add_handlers: List[Callable[[object], None]] = []
        self._update_handlers: List[Callable[[object, object], None]] = []
        self._delete_handlers: List[Callable[[object], None]] = []
        self._synced = False
        # Namespace-scoped watch keeps the real-cluster backend within a
        # namespaced Role's RBAC (ref main.go:63-71 WithNamespace).
        api.watch(kind, self._on_event, namespace=namespace)

    # -- handler registration (ref AddEventHandler, :204-321) ---------------

    def add_event_handler(self, on_add=None, on_update=None, on_delete=None):
        if on_add:
            self._add_handlers.append(on_add)
        if on_update:
            self._update_handlers.append(on_update)
        if on_delete:
            self._delete_handlers.append(on_delete)

    # -- cache --------------------------------------------------------------

    def cache_get(self, namespace: str, name: str):
        with self._lock:
            obj = self._cache.get((namespace, name))
            return deepcopy_resource(obj) if obj is not None else None

    def cache_list(self, namespace: Optional[str] = None) -> List[object]:
        with self._lock:
            return [
                deepcopy_resource(o)
                for (ns, _), o in sorted(self._cache.items())
                if namespace is None or ns == namespace
            ]

    def lister(self) -> Lister:
        return Lister(self)

    # -- sync (ref cache.WaitForCacheSync, mpi_job_controller.go:339) -------

    def start(self) -> None:
        """Full re-list: REPLACE the cache with the server's current state
        (client-go Reflector relist + store Replace). Called at startup and
        as the periodic resync that heals dropped watch events: an object
        whose DELETED event was lost would otherwise linger in the cache
        forever (and keep getting reconciled back into existence), so
        evicted objects fire their delete handlers — the owning job is
        re-queued and per-job controller state released."""
        with self._lock:
            fresh = {
                (obj.metadata.namespace, obj.metadata.name): obj
                for obj in self.api.list(self.kind, self.namespace)
            }
            evicted = [obj for key, obj in self._cache.items()
                       if key not in fresh]
            self._cache = fresh
            self._synced = True
        for obj in evicted:
            for h in self._delete_handlers:
                h(obj)

    def has_synced(self) -> bool:
        return self._synced

    # -- watch plumbing ------------------------------------------------------

    def _on_event(self, event: str, obj, old) -> None:
        if self.namespace is not None and obj.metadata.namespace != self.namespace:
            return
        key = (obj.metadata.namespace, obj.metadata.name)
        with self._lock:
            if event == "ADDED":
                self._cache[key] = obj
            elif event == "MODIFIED":
                old = self._cache.get(key, old)
                self._cache[key] = obj
            elif event == "DELETED":
                self._cache.pop(key, None)
        if event == "ADDED":
            for h in self._add_handlers:
                h(obj)
        elif event == "MODIFIED":
            # RV-compare to skip resyncs (ref :221-227)
            if old is not None and (
                old.metadata.resource_version == obj.metadata.resource_version
            ):
                return
            for h in self._update_handlers:
                h(old, obj)
        elif event == "DELETED":
            for h in self._delete_handlers:
                h(obj)


class InformerFactory:
    """ref: SharedInformerFactory (cmd/mpi-operator/main.go:63-71). One
    informer per kind, shared across consumers."""

    def __init__(self, api: InMemoryAPIServer, namespace: Optional[str] = None):
        self.api = api
        self.namespace = namespace
        self._informers: Dict[str, Informer] = {}

    def informer(self, kind: str) -> Informer:
        if kind not in self._informers:
            self._informers[kind] = Informer(self.api, kind, self.namespace)
        return self._informers[kind]

    def start_all(self) -> None:
        for inf in self._informers.values():
            inf.start()

    def wait_for_cache_sync(self) -> bool:
        return all(inf.has_synced() for inf in self._informers.values())


__all__ = ["Informer", "Lister", "InformerFactory"]
