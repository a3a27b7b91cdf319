"""Rate-limited, deduplicating work queue keyed by "namespace/name".

ref: k8s.io/client-go/util/workqueue as used by the controller
(mpi_job_controller.go:125-130, :366-415). The contract the controller
depends on:

  - a key being processed is never handed to a second worker concurrently
    (dirty/processing set semantics) — this is the reference's entire
    concurrency-safety story (SURVEY §5 "Race detection");
  - Add while processing marks dirty → key is re-queued on Done;
  - AddRateLimited implements per-item exponential backoff;
  - Forget resets the backoff counter (ref :399-404);
  - duplicate delayed adds for one key coalesce to the EARLIEST
    deadline (ref delaying_queue.go waitingEntryByData): the scheduler's
    hysteresis arms a wake-up on almost every sync, and without
    coalescing each re-sync would stack another heap entry per key.
"""
from __future__ import annotations

import heapq
import threading
import time
from typing import Dict, List, Optional, Set


class RateLimitingQueue:
    def __init__(self, base_delay: float = 0.005, max_delay: float = 1000.0):
        self._lock = threading.Condition()
        self._queue: List[str] = []
        self._dirty: Set[str] = set()
        self._processing: Set[str] = set()
        self._failures: Dict[str, int] = {}
        self._base_delay = base_delay
        self._max_delay = max_delay
        # delayed items: heap of (ready_time, key) plus the authoritative
        # per-key deadline. The heap may hold superseded entries for a
        # key (lazy invalidation); only an entry matching
        # _waiting_deadlines[key] is live.
        self._waiting: List[tuple] = []
        self._waiting_deadlines: Dict[str, float] = {}
        self._shutting_down = False

    # -- core queue (workqueue.Interface) -----------------------------------

    def add(self, key: str) -> None:
        with self._lock:
            if self._shutting_down or key in self._dirty:
                return
            self._dirty.add(key)
            if key not in self._processing:
                self._queue.append(key)
                self._lock.notify()

    def get(self, timeout: Optional[float] = None) -> Optional[str]:
        """Blocks until an item is available; returns None on shutdown or
        timeout. The caller MUST call done(key) afterwards."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                self._drain_waiting_locked()
                if self._queue:
                    key = self._queue.pop(0)
                    self._processing.add(key)
                    self._dirty.discard(key)
                    return key
                if self._shutting_down:
                    return None
                # Return None only when the CALLER's deadline expired; a due
                # rate-limited item instead loops back to re-drain.
                now = time.monotonic()
                if deadline is not None and now >= deadline:
                    return None
                waits = []
                if self._waiting:
                    waits.append(self._waiting[0][0] - now)
                if deadline is not None:
                    waits.append(deadline - now)
                wait = min(waits) if waits else None
                if wait is not None and wait <= 0:
                    continue
                self._lock.wait(wait)

    def done(self, key: str) -> None:
        with self._lock:
            self._processing.discard(key)
            if key in self._dirty:
                self._queue.append(key)
                self._lock.notify()

    # -- rate limiting (workqueue.RateLimitingInterface) --------------------

    def add_rate_limited(self, key: str) -> None:
        with self._lock:
            n = self._failures.get(key, 0)
            self._failures[key] = n + 1
            delay = min(self._base_delay * (2 ** n), self._max_delay)
            self._arm_locked(key, time.monotonic() + delay)

    def add_after(self, key: str, delay: float) -> None:
        """Enqueue `key` after `delay` seconds WITHOUT touching the
        failure counter (workqueue.AddAfter): for scheduled re-syncs —
        timeout checks, retry windows — not error backoff. Duplicate
        calls for one key coalesce to the earliest deadline."""
        if delay <= 0:
            self.add(key)
            return
        with self._lock:
            if self._shutting_down:
                return
            self._arm_locked(key, time.monotonic() + delay)

    def forget(self, key: str) -> None:
        with self._lock:
            self._failures.pop(key, None)

    def num_requeues(self, key: str) -> int:
        with self._lock:
            return self._failures.get(key, 0)

    def snapshot(self) -> Dict[str, object]:
        """Introspection for the chaos soak's wedge detector: a key is
        permanently wedged when it sits in `failures` (backoff still
        growing, never forgotten) or `processing` (done() never called)
        after the controller has gone quiet. Returns copies; safe to
        inspect without holding up workers."""
        with self._lock:
            return {
                "queue": list(self._queue),
                "waiting": sorted(self._waiting_deadlines),
                "processing": set(self._processing),
                "dirty": set(self._dirty),
                "failures": dict(self._failures),
            }

    # -- lifecycle ----------------------------------------------------------

    def shut_down(self) -> None:
        with self._lock:
            self._shutting_down = True
            self._lock.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue) + len(self._waiting_deadlines)

    # -- internal -----------------------------------------------------------

    def _arm_locked(self, key: str, deadline: float) -> None:
        """Coalesce: one live deadline per waiting key, the earliest
        wins. A later-deadline duplicate is a no-op; an earlier one
        pushes a new heap entry and retargets the live deadline (the
        superseded entry is skipped lazily at drain time)."""
        current = self._waiting_deadlines.get(key)
        if current is not None and current <= deadline:
            return
        self._waiting_deadlines[key] = deadline
        heapq.heappush(self._waiting, (deadline, key))
        self._lock.notify()

    def _drain_waiting_locked(self) -> None:
        now = time.monotonic()
        while self._waiting and self._waiting[0][0] <= now:
            ready, key = heapq.heappop(self._waiting)
            if self._waiting_deadlines.get(key) != ready:
                continue                     # superseded by an earlier arm
            del self._waiting_deadlines[key]
            if key not in self._dirty:
                self._dirty.add(key)
                if key not in self._processing:
                    self._queue.append(key)


def split_key(key: str):
    """ref: cache.SplitMetaNamespaceKey (mpi_job_controller.go:422)."""
    parts = key.split("/")
    if len(parts) != 2 or not parts[0] or not parts[1]:
        raise ValueError(f"invalid resource key: {key!r}")
    return parts[0], parts[1]


def meta_namespace_key(obj) -> str:
    """ref: cache.MetaNamespaceKeyFunc (mpi_job_controller.go:798-801)."""
    return f"{obj.metadata.namespace}/{obj.metadata.name}"


__all__ = ["RateLimitingQueue", "split_key", "meta_namespace_key"]
