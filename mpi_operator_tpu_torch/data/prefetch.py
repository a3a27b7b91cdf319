"""Shared host-to-device prefetch machinery for the real-data pipelines.

The PyTorch port's own copy of mpi_operator_tpu/data/prefetch.py (pure
Python: the port imports nothing of the JAX package). One background
feeder thread produces batches into a bounded queue so the feed
overlaps the train step (tf.data's `prefetch(AUTOTUNE)`: keep host work
off the timed path). Subclasses implement `_produce()` — a generator of
batches — and the base owns the queue, the thread lifecycle, error
surfacing (a feeder exception re-raises in `__next__` instead of
hanging the consumer), and responsive shutdown.
"""
from __future__ import annotations

import threading
from queue import Full, Queue
from typing import Iterator


#: end-of-stream marker the feeder enqueues when `_produce()` returns;
#: `__next__` re-enqueues it so exhaustion is sticky (every subsequent
#: next() raises StopIteration instead of blocking on an empty queue)
_DONE = object()


class PrefetchDataset:
    """Iterator with N-batch prefetch. Subclasses must set up all
    state their `_produce()` needs BEFORE calling `_start_feeder()` (the
    thread starts immediately). The iterator ends (StopIteration) when
    `_produce()` returns; the shipped pipelines produce forever."""

    def _start_feeder(self, prefetch: int = 2) -> None:
        self._queue: Queue = Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._feeder, daemon=True)
        self._thread.start()

    def _produce(self):
        """Generator of batches; runs on the feeder thread."""
        raise NotImplementedError

    def _put(self, item) -> bool:
        """put that stays responsive to close(); False once stopped."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.2)
                return True
            except Full:
                continue
        return False

    def _feeder(self):
        try:
            for batch in self._produce():
                if self._stop.is_set():
                    return
                if not self._put(batch):
                    return
            self._put(_DONE)                # finite producer: end cleanly
        except BaseException as e:          # surface in __next__, don't hang
            self._put(e)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._queue.get()
        if item is _DONE:
            # just freed a queue slot, so this put never blocks
            self._queue.put(_DONE)
            raise StopIteration
        if isinstance(item, BaseException):
            raise RuntimeError("data feeder thread failed") from item
        return item

    def close(self):
        self._stop.set()
        # unblock a feeder stuck in put() and let the thread exit
        try:
            while True:
                self._queue.get_nowait()
        except Exception:  # noqa: BLE001 — queue drained
            pass
        self._thread.join(timeout=2.0)


__all__ = ["PrefetchDataset"]
