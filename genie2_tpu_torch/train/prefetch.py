"""Asynchronous input prefetch (a copy of genie2_tpu/train/prefetch.py;
the standard library and the port's spans only).

One background thread runs the whole host side of the input pipeline
(epoch iteration: augment, pad, stack; then the placement on the device) a
fixed depth of batches ahead of the training step. Order is preserved (one
worker, one FIFO queue), so the data order and step-granular resume of
Trainer.fit are the same with prefetch on or off.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, TypeVar

from genie2_tpu_torch.utils.profiling import span

T = TypeVar("T")
U = TypeVar("U")


class PrefetchIterator(Iterator[U]):
    """Iterate `place_fn(item) for item in iterable` computed `depth` items
    ahead on a background thread.

    Exceptions raised by the iterable or by `place_fn` are re-raised in the
    consumer thread at the matching position. Early termination (``close()``
    or garbage collection of an exhausted consumer) stops the worker.
    """

    _DONE = object()

    def __init__(
        self,
        iterable: Iterable[T],
        place_fn: Optional[Callable[[T], U]] = None,
        depth: int = 2,
    ):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._place = place_fn if place_fn is not None else (lambda x: x)
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(iter(iterable),), daemon=True
        )
        self._thread.start()

    def _worker(self, it: Iterator[T]):
        try:
            for item in it:
                if self._stop.is_set():
                    return
                out = self._place(item)
                while not self._stop.is_set():
                    try:
                        self._queue.put(out, timeout=0.1)
                        break
                    except queue.Full:
                        continue
            self._put_final(self._DONE)
        except BaseException as exc:  # noqa: BLE001 — forwarded to consumer
            self._put_final(exc)

    def _put_final(self, obj):
        while not self._stop.is_set():
            try:
                self._queue.put(obj, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self) -> U:
        if self._stop.is_set():
            raise StopIteration
        with span("prefetch_wait"):
            out = self._queue.get()
        if out is self._DONE:
            self._stop.set()
            raise StopIteration
        if isinstance(out, BaseException):
            self._stop.set()
            raise out
        return out

    def close(self):
        self._stop.set()
        # Unblock a worker waiting on a full queue.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):
        self.close()


def prefetch(
    iterable: Iterable[T],
    place_fn: Optional[Callable[[T], U]] = None,
    depth: int = 2,
) -> Iterator[U]:
    """Functional wrapper: `depth=0` disables prefetching (synchronous map,
    identical semantics), `depth>=1` returns a PrefetchIterator."""
    if depth == 0:
        fn = place_fn if place_fn is not None else (lambda x: x)
        return (fn(item) for item in iterable)
    return PrefetchIterator(iterable, place_fn, depth)
