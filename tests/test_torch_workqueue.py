"""Workqueue edge cases the controller's safety story leans on.

ref contract (k8s.io/client-go/util/workqueue, SURVEY §5):
- a key being processed is never handed to a second worker; an add()
  during processing marks it dirty and done() re-queues it exactly once;
- add_rate_limited backs off exponentially per item; forget() resets;
- shut_down() wakes every blocked get(), which drains to None.

The scenarios of tests/test_workqueue.py against the PyTorch port's copy
(mpi_operator_tpu_torch.cluster.workqueue).
"""
import threading
import time

import pytest

from mpi_operator_tpu_torch.cluster.workqueue import (
    RateLimitingQueue,
    meta_namespace_key,
    split_key,
)


# ---------------------------------------------------------------------------
# add-while-processing: dirty/processing set semantics
# ---------------------------------------------------------------------------

def test_add_while_processing_requeues_on_done():
    q = RateLimitingQueue()
    q.add("ns/a")
    key = q.get(timeout=0.1)
    assert key == "ns/a"
    # the informer saw another event mid-sync: the key must not be handed
    # to a second worker NOW...
    q.add("ns/a")
    assert q.get(timeout=0.02) is None
    # ...but done() must hand it straight back (the re-sync the event
    # demanded), exactly once
    q.done("ns/a")
    assert q.get(timeout=0.1) == "ns/a"
    q.done("ns/a")
    assert q.get(timeout=0.02) is None


def test_duplicate_adds_coalesce_while_queued():
    q = RateLimitingQueue()
    for _ in range(5):
        q.add("ns/a")
    assert q.get(timeout=0.1) == "ns/a"
    q.done("ns/a")
    assert q.get(timeout=0.02) is None


def test_done_without_pending_add_does_not_requeue():
    q = RateLimitingQueue()
    q.add("ns/a")
    assert q.get(timeout=0.1) == "ns/a"
    q.done("ns/a")
    assert q.get(timeout=0.02) is None


# ---------------------------------------------------------------------------
# per-item exponential backoff + forget
# ---------------------------------------------------------------------------

def test_backoff_grows_exponentially_and_caps():
    q = RateLimitingQueue(base_delay=0.01, max_delay=0.04)
    delays = []
    for _ in range(4):
        before = time.monotonic()
        q.add_rate_limited("ns/a")
        got = q.get(timeout=2.0)        # blocks until the delay elapses
        delays.append(time.monotonic() - before)
        assert got == "ns/a"
        q.done("ns/a")
    # 0.01, 0.02, 0.04, then capped at max_delay 0.04
    assert delays[0] >= 0.01
    assert delays[1] >= 0.02
    assert delays[2] >= 0.04
    assert delays[3] >= 0.04
    assert delays[3] < 0.08 + 0.05      # cap held (scheduling slack)
    assert q.num_requeues("ns/a") == 4


def test_backoff_is_per_item():
    q = RateLimitingQueue(base_delay=0.01)
    for _ in range(3):
        q.add_rate_limited("ns/flaky")
    q.add_rate_limited("ns/fresh")
    assert q.num_requeues("ns/flaky") == 3
    assert q.num_requeues("ns/fresh") == 1


def test_forget_resets_the_backoff_counter():
    q = RateLimitingQueue(base_delay=0.005)
    for _ in range(6):
        q.add_rate_limited("ns/a")
    assert q.num_requeues("ns/a") == 6
    q.forget("ns/a")
    assert q.num_requeues("ns/a") == 0
    # the next failure starts the ladder from the bottom again
    before = time.monotonic()
    q.add_rate_limited("ns/a")
    # drain the earlier queued copies first, then the fresh one
    while q.get(timeout=1.0) is not None:
        q.done("ns/a")
        if time.monotonic() - before > 1.0:
            pytest.fail("queue never drained")
    assert q.num_requeues("ns/a") == 1


def test_add_after_does_not_touch_failures():
    q = RateLimitingQueue()
    q.add_after("ns/a", 0.01)
    assert q.num_requeues("ns/a") == 0
    assert q.get(timeout=1.0) == "ns/a"
    q.done("ns/a")
    # and a non-positive delay enqueues immediately
    q.add_after("ns/a", 0)
    assert q.get(timeout=0.1) == "ns/a"


# ---------------------------------------------------------------------------
# shutdown drains blocked getters
# ---------------------------------------------------------------------------

def test_shutdown_wakes_every_blocked_getter():
    q = RateLimitingQueue()
    results = []
    barrier = threading.Barrier(4)

    def worker():
        barrier.wait()
        results.append(q.get(timeout=5.0))   # blocks: queue is empty

    threads = [threading.Thread(target=worker) for _ in range(3)]
    for t in threads:
        t.start()
    barrier.wait()
    time.sleep(0.05)                         # let all three block in get()
    q.shut_down()
    for t in threads:
        t.join(timeout=2.0)
        assert not t.is_alive(), "getter still blocked after shut_down"
    assert results == [None, None, None]


def test_shutdown_rejects_new_work():
    q = RateLimitingQueue()
    q.shut_down()
    q.add("ns/a")
    q.add_after("ns/b", 0.001)
    assert len(q) == 0
    assert q.get(timeout=0.05) is None


def test_snapshot_reports_wedge_evidence():
    q = RateLimitingQueue()
    q.add("ns/queued")
    q.add("ns/stuck")
    assert q.get(timeout=0.1) in ("ns/queued", "ns/stuck")
    q.add_rate_limited("ns/angry")
    snap = q.snapshot()
    assert len(snap["processing"]) == 1      # done() never called: wedged
    assert snap["failures"] == {"ns/angry": 1}
    assert "ns/angry" in snap["waiting"] or "ns/angry" in snap["queue"]


# ---------------------------------------------------------------------------
# add_after coalescing: duplicate wake-ups collapse to the EARLIEST
# deadline (the fleet scheduler arms a wake per skip decision every
# sync — without coalescing each sync would stack another timer)
# ---------------------------------------------------------------------------

def test_add_after_duplicates_coalesce_to_earliest():
    q = RateLimitingQueue()
    q.add_after("ns/a", 0.2)
    q.add_after("ns/a", 0.02)       # earlier deadline must win
    before = time.monotonic()
    assert q.get(timeout=1.0) == "ns/a"
    assert time.monotonic() - before < 0.15
    q.done("ns/a")
    # ONE delivery total: the superseded 0.2s timer must not fire again
    assert q.get(timeout=0.3) is None
    assert len(q) == 0


def test_add_after_later_deadline_is_a_noop():
    q = RateLimitingQueue()
    q.add_after("ns/a", 0.02)
    q.add_after("ns/a", 30.0)       # must NOT push the wake out
    before = time.monotonic()
    assert q.get(timeout=1.0) == "ns/a"
    assert time.monotonic() - before < 0.5
    q.done("ns/a")
    assert q.get(timeout=0.1) is None
    assert len(q) == 0              # no ghost waiting entry left behind


def test_add_after_waiting_len_and_snapshot_truthful():
    q = RateLimitingQueue()
    q.add_after("ns/a", 30.0)
    q.add_after("ns/a", 60.0)
    q.add_after("ns/b", 30.0)
    # two keys waiting, however many timers were armed
    assert len(q) == 2
    snap = q.snapshot()
    assert snap["waiting"] == ["ns/a", "ns/b"]
    # re-arming one of them to (almost) now delivers it without
    # disturbing the other key's pending wake
    q.add_after("ns/a", 0.001)
    assert q.get(timeout=0.5) == "ns/a"
    q.done("ns/a")
    assert len(q) == 1
    assert q.snapshot()["waiting"] == ["ns/b"]


# ---------------------------------------------------------------------------
# key helpers
# ---------------------------------------------------------------------------

def test_split_key_roundtrip_and_validation():
    class Meta:
        namespace, name = "ns", "job"

    class Obj:
        metadata = Meta()

    key = meta_namespace_key(Obj())
    assert key == "ns/job"
    assert split_key(key) == ("ns", "job")
    for bad in ("no-slash", "a/b/c", "/name", "ns/"):
        with pytest.raises(ValueError):
            split_key(bad)
