"""Background lifecycle loops.

The reference runs four channel-connected goroutine loops per shard
(introducer/flusher/merger/syncer, banyand/measure/tstable.go:250).  The
introducer's role (snapshot epoch ownership) is folded into the shard
lock here; the remaining stages run as CONCURRENT daemon threads wired
by a queue, so a long merge never delays flushes (and vice versa):

  flusher thread   memtable -> parts; enqueues flushed shards (flusher.go:28)
  merger thread    drains the queue: size-tiered compaction of exactly
                   the shards that grew, plus a periodic full sweep
                   (merger.go:39)
  retention thread retention sweeps + index persistence + engine extras
                   (rotation.go retentionTask)

``tick()`` still runs every stage once synchronously — the test/manual
entry point and the unit of each thread's work.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

from banyandb_tpu_torch.obs import metrics as obs_metrics
from banyandb_tpu_torch.storage.tsdb import TSDB

# per-stage lifecycle latency (flush/merge/merge-sweep/retention/
# rotation), observed in _guard AFTER the stage returns — no instrument
# lock is ever taken while storage locks are held
_H_LIFECYCLE: dict[str, obs_metrics.Histogram] = {
    stage: obs_metrics.global_meter().histogram(
        "lifecycle_stage_ms", {"stage": stage}
    )
    for stage in ("flush", "merge", "merge-sweep", "retention", "rotation")
}


class _RWLock:
    """Tiny readers-writer lock: flush/merge stages run concurrently
    (readers), retention's segment deletion is exclusive (writer) — a
    sweep must never rmtree a segment an in-flight flush/merge is about
    to write into (zombie seg-* dirs resurrected on restart)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self):
        with self._cond:
            # writer preference: new readers queue behind a waiting
            # writer, or the 1s flusher/merger cadence starves retention
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True

    def release_write(self):
        with self._cond:
            self._writer = False
            self._cond.notify_all()


class LifecycleLoops:
    """Concurrent stage threads driving flush/merge/retention."""

    def __init__(
        self,
        tsdbs: Callable[[], list[TSDB]],
        *,
        flush_interval_s: float = 1.0,
        flush_min_rows: int = 1,
        retention_interval_s: float = 60.0,
        merge_sweep_interval_s: float = 10.0,
        idle_timeout_s: float = 600.0,
        clock: Callable[[], float] = time.time,
        extra_tick: Optional[Callable[[], None]] = None,
        pre_flush: Optional[Callable[[], None]] = None,
    ):
        self._tsdbs = tsdbs
        self._pre_flush = pre_flush
        self.flush_interval_s = flush_interval_s
        self.flush_min_rows = flush_min_rows
        self.retention_interval_s = retention_interval_s
        self.merge_sweep_interval_s = merge_sweep_interval_s
        self.idle_timeout_s = idle_timeout_s
        self._last_idle_check = 0.0
        self._clock = clock
        self._extra_tick = extra_tick
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._merge_q: "queue.Queue" = queue.Queue()
        self._last_retention = 0.0
        self._rw = _RWLock()

    # -- stage bodies (each also usable synchronously via tick()) -----------
    def flush_stage(self) -> int:
        flushed = 0
        self._rw.acquire_read()
        try:
            if self._pre_flush is not None:
                # ordering hook: e.g. trace sidx ordered keys must publish
                # BEFORE span memtables flush (trace._flush_sidx_first).
                # Inside the read lock: sidx part writes must not
                # interleave with retention's exclusive segment rmtree.
                self._pre_flush()
            for db in self._tsdbs():
                for seg in db.segments:
                    for shard in seg.shards:
                        if len(shard.mem) >= self.flush_min_rows:
                            names = shard.flush()
                            if names:
                                flushed += len(names)
                                self._merge_q.put(shard)
                    # the sidx file is the only store for index-mode
                    # measures: persist at FLUSH cadence (a crash loses at
                    # most one flush interval of docs, not a retention one)
                    seg.persist_index()
        finally:
            self._rw.release_read()
        if self._extra_tick is not None:  # e.g. property-lease GC: same
            # tight cadence the single-thread loop gave it
            self._extra_tick()
        return flushed

    def merge_shard(self, shard) -> int:
        merged = 0
        self._rw.acquire_read()
        try:
            # a queued shard may belong to a segment retention deleted
            # between enqueue and dequeue: merging it would recreate the
            # deleted directory (zombie segment) — skip dead shards
            if not shard.root.exists():
                return 0
            # segments under tier migration are merge-frozen: compaction
            # would rewrite the part names migration uses as resume keys,
            # re-shipping already-installed rows under new names
            from banyandb_tpu_torch.storage.tsdb import MIGRATING_MARKER

            if (shard.root.parent / MIGRATING_MARKER).exists():
                return 0
            while True:
                if not shard.merge():
                    break
                merged += 1
        finally:
            self._rw.release_read()
        return merged

    def merge_sweep(self) -> int:
        merged = 0
        for db in self._tsdbs():
            for seg in db.segments:
                for shard in seg.shards:
                    merged += self.merge_shard(shard)
        return merged

    def retention_stage(self, force: bool = False) -> int:
        retired = 0
        now = self._clock()
        due = force or (now - self._last_retention >= self.retention_interval_s)
        if not due:
            return 0
        # exclusive: segment deletion must not interleave with in-flight
        # flush/merge writes (zombie segment dirs)
        self._rw.acquire_write()
        try:
            for db in self._tsdbs():
                retired += len(db.retention_sweep(int(now * 1000)))
        finally:
            self._rw.release_write()
        self._last_retention = now
        return retired

    def rotation_stage(self) -> int:
        """Pre-create upcoming segments + reclaim idle ones
        (rotation.go:52 startRotationTask body).

        Runs on the retainer thread each pass: ticks are driven by each
        TSDB's write-event high-water mark — NOT wall clock — matching the
        reference (rotation.go Tick fires from write timestamps), so a
        write-idle group stops accreting empty segments.  TSDB.tick
        throttles itself (tick_snap); the idle check fires at most once
        per timeout interval (the 10-minute idleCheckTicker analog)."""
        now = self._clock()
        created = 0
        for db in self._tsdbs():
            if db.tick(db.max_event_ms):
                created += 1
        if self.idle_timeout_s > 0 and (
            now - self._last_idle_check >= self.idle_timeout_s
        ):
            self._last_idle_check = now
            for db in self._tsdbs():
                # no now_s: each TSDB compares against its own clock, the
                # same domain its segments' touch() timestamps come from
                db.close_idle_segments(self.idle_timeout_s)
        return created

    def tick(self) -> dict:
        """One synchronous round of every stage (tests/manual driving)."""
        stats = {"flushed": 0, "merged": 0, "retired": 0}
        stats["flushed"] = self.flush_stage()
        # drain what the flush enqueued, then sweep for anything else
        while True:
            try:
                shard = self._merge_q.get_nowait()
            except queue.Empty:
                break
            stats["merged"] += self.merge_shard(shard)
        stats["merged"] += self.merge_sweep()
        stats["retired"] = self.retention_stage(force=False)
        stats["precreated"] = self.rotation_stage()
        return stats

    # -- threads ------------------------------------------------------------
    def _guard(self, fn: Callable[[], None], name: str) -> None:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # pragma: no cover - keep the loop alive
            import logging

            logging.getLogger(__name__).exception("%s stage failed", name)
        finally:
            h = _H_LIFECYCLE.get(name)
            if h is not None:
                h.observe((time.perf_counter() - t0) * 1000)

    def _flusher(self) -> None:
        while not self._stop.wait(self.flush_interval_s):
            self._guard(self.flush_stage, "flush")

    def _merger(self) -> None:
        last_sweep = 0.0
        while not self._stop.is_set():
            try:
                shard = self._merge_q.get(timeout=self.flush_interval_s)
                self._guard(lambda: self.merge_shard(shard), "merge")
            except queue.Empty:
                pass
            now = self._clock()
            if now - last_sweep >= self.merge_sweep_interval_s:
                last_sweep = now
                self._guard(lambda: self.merge_sweep(), "merge-sweep")

    def _retainer(self) -> None:
        while not self._stop.wait(min(self.retention_interval_s, 5.0)):
            self._guard(lambda: self.retention_stage(False), "retention")
            self._guard(lambda: self.rotation_stage(), "rotation")

    def start(self) -> None:
        if self._threads:
            return
        self._stop.clear()  # allow stop() -> start() restart
        # first retention waits a FULL interval (an immediate first-fire
        # would race fresh test/startup data whose timestamps predate TTL)
        self._last_retention = self._clock()
        for target, name in (
            (self._flusher, "bydb-flusher"),
            (self._merger, "bydb-merger"),
            (self._retainer, "bydb-retention"),
        ):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30)
        self._threads = []
