"""Prefetchable chunk/source streams: the host half of the gather/compute
pipeline.

The cold read path is a chain of host stages (disk read -> block decode ->
series filter -> remap -> pad -> H2D transfer) feeding device kernel
execution.  Run strictly serially, the device idles during every decode
and the host idles during every kernel.  This module provides the two
overlap primitives the query layers build on:

- ``prefetched(thunks)``: evaluate thunks IN ORDER on one background
  thread, a bounded ``depth`` ahead of the consumer — while the consumer
  processes item *k* (e.g. the device executes chunk *k*), the worker
  decodes item *k+1*.  Order, and therefore every downstream
  concatenation/accumulation, is identical to the serial loop, which is
  what makes pipelined and serial results byte-identical.
- ``parallel_map(thunks, workers)``: order-preserving concurrent map for
  INDEPENDENT units (per-node source gathers in the mesh plane) where
  pipelining alone leaves workers idle.

``BYDB_PIPELINE=0`` forces the strict-serial fallback everywhere (the
flag is read per call so tests and operators can flip it live), and a
thunk that raises mid-stream re-raises the original exception at the
consumer exactly where the serial loop would have.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterator, Sequence

from banyandb_tpu_torch.utils.envflag import env_flag, env_int


def pipeline_enabled() -> bool:
    """Strict-serial fallback flag; default on."""
    return env_flag("BYDB_PIPELINE", default=True)


def default_depth() -> int:
    return max(1, env_int("BYDB_PREFETCH_DEPTH", 2))


class PrefetchIterator:
    """Evaluate ``thunks`` in order on ONE background thread, ``depth``
    items ahead of the consumer.

    Single-worker by design: evaluation order is the list order, so any
    order-sensitive consumer (concatenation, f64 accumulation) sees
    exactly the serial sequence.  A thunk exception is delivered to the
    consumer at that position and ends the stream; ``close()`` stops the
    worker early (the consumer broke out of the loop)."""

    _DONE = object()

    def __init__(
        self,
        thunks: Sequence[Callable[[], object]],
        depth: int = 2,
        name: str = "bydb-prefetch",
    ):
        self._q: queue.Queue = queue.Queue(maxsize=max(int(depth), 1))
        self._stop = threading.Event()
        self._thunks = list(thunks)
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        for t in self._thunks:
            if self._stop.is_set():
                return
            try:
                item = (None, t())
            except BaseException as e:  # noqa: BLE001 — delivered to consumer
                self._put((e, None))
                return
            if not self._put(item):
                return
        self._put((None, self._DONE))

    def _put(self, item) -> bool:
        # bounded-blocking put that still honors close(): the consumer
        # may stop reading mid-stream, and the worker must not wedge on
        # a full queue forever
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        exc, value = self._q.get()
        if exc is not None:
            self.close()
            raise exc
        if value is self._DONE:
            self._stop.set()
            raise StopIteration
        return value

    def close(self) -> None:
        """Stop the worker (early consumer exit / error)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10)


def prefetched(
    thunks: Sequence[Callable[[], object]],
    depth: int | None = None,
    enabled: bool | None = None,
    name: str = "bydb-prefetch",
) -> Iterator:
    """Yield ``t()`` for each thunk in order, prefetching in the
    background when pipelining is on and there is more than one thunk;
    plain serial evaluation otherwise (no thread for the common
    single-source case)."""
    thunks = list(thunks)
    if enabled is None:
        enabled = pipeline_enabled()
    if not enabled or len(thunks) <= 1:
        for t in thunks:
            yield t()
        return
    it = PrefetchIterator(thunks, depth=depth or default_depth(), name=name)
    try:
        yield from it
    finally:
        it.close()


def parallel_map(
    thunks: Sequence[Callable[[], object]],
    workers: int | None = None,
    enabled: bool | None = None,
) -> list:
    """Evaluate independent thunks concurrently, results in list order.

    For units with no shared mutable state between them (per-node source
    gathers); falls back to the serial loop under ``BYDB_PIPELINE=0`` or
    when there is nothing to overlap.  The first exception (by position,
    matching the serial loop) propagates after all workers finish."""
    thunks = list(thunks)
    if enabled is None:
        enabled = pipeline_enabled()
    if not enabled or len(thunks) <= 1:
        return [t() for t in thunks]
    from concurrent.futures import ThreadPoolExecutor

    w = workers or min(4, len(thunks))
    with ThreadPoolExecutor(max_workers=w, thread_name_prefix="bydb-pmap") as ex:
        futures = [ex.submit(t) for t in thunks]
        out = []
        first_exc = None
        for f in futures:
            try:
                out.append(f.result())
            except BaseException as e:  # noqa: BLE001 — re-raised below
                if first_exc is None:
                    first_exc = e
                out.append(None)
        if first_exc is not None:
            raise first_exc
        return out
