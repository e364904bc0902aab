"""TSDB: group -> time segments -> shards -> (memtable + parts + snapshot).

Analog of banyand/internal/storage (TSDBOpts tsdb.go:55, segment naming
storage.go:46-50, snapshot MVCC snapshot.go, shard tree shard.go) rebuilt
host-side:

    <root>/<group>/
      seg-<YYYYMMDD[HH]>/
        shard-<i>/
          part-<016x>/...
          snapshot.snp        # JSON: {"epoch": N, "parts": [names]}

Readers only see parts listed in the shard's current snapshot; writers
flush memtables into new parts then atomically publish a new snapshot —
the same MVCC contract as the reference's .snp manifests.
"""

from __future__ import annotations

import datetime as dt
import os
import threading
import time
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np

from banyandb_tpu_torch.api.schema import ResourceOpts
from banyandb_tpu_torch.storage.memtable import MemTable
from banyandb_tpu_torch.storage.part import ColumnData, Part, PartWriter
from banyandb_tpu_torch.utils import fs

SNAPSHOT = "snapshot.snp"
# Segment-level marker: tier migration is shipping this segment's parts.
# Background merges skip marked segments (part names are the resumable
# progress keys, so compaction must not rewrite them mid-migration); the
# marker persists across crashes and leaves with the migrated segment.
MIGRATING_MARKER = ".migrating"


def segment_name(start_millis: int, interval_unit: str) -> str:
    t = dt.datetime.fromtimestamp(start_millis / 1000, tz=dt.timezone.utc)
    if interval_unit == "hour":
        return f"seg-{t:%Y%m%d%H}"
    return f"seg-{t:%Y%m%d}"


def segment_start(ts_millis: int, interval_millis: int) -> int:
    return ts_millis - (ts_millis % interval_millis)


class Shard:
    """One shard of one segment: a memtable + immutable parts + snapshot."""

    def __init__(
        self,
        root: Path,
        mem_factory: Callable[[], MemTable],
        merge_filter_provider: Optional[Callable] = None,
        part_built_provider: Optional[Callable] = None,
    ):
        self.root = root
        self.root.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._mem_factory = mem_factory
        self._merge_filter_provider = merge_filter_provider
        self._part_built_provider = part_built_provider
        self.mem = mem_factory()
        self._epoch = 0
        self._parts: dict[str, Part] = {}
        # in-flight flush snapshot ((resource name, ColumnData), ...):
        # drained memtable rows stay queryable while their part encodes
        # OUTSIDE the lock (see flush()).  Immutable tuple rebinds only.
        self._flushing: tuple = ()
        # serializes whole flush() invocations: the lifecycle loop and
        # the operator flush/snapshot surface may race, and _flushing is
        # a single slot — a second concurrent flush would overwrite the
        # first's in-flight snapshot and hide its rows mid-encode
        self._flush_mutex = threading.Lock()
        self._load_snapshot()

    def _notify_part_built(self, part_dir, extra_meta) -> None:
        """Engine hook (element-index/bloom sidecar build): sidecars
        are a pruning optimization, so a failing sidecar build must never fail
        the flush/merge that produced the part."""
        if self._part_built_provider is None:
            return
        cb = self._part_built_provider()
        if cb is None:
            return
        try:
            cb(part_dir, extra_meta)
        except Exception:  # noqa: BLE001
            import logging

            logging.getLogger(__name__).exception(
                "part index build failed; part serves unpruned"
            )

    FAILED_PARTS_DIR = "failed-parts"
    FAILED_PARTS_CAP = 16  # quarantined dirs kept (oldest evicted)

    def _load_snapshot(self) -> None:
        snp = self.root / SNAPSHOT
        listed: set[str] = set()
        quarantined = []
        if snp.exists():
            data = fs.read_json(snp)
            self._epoch = data["epoch"]
            listed = set(data["parts"])
            for name in data["parts"]:
                pdir = self.root / name
                if not pdir.exists():
                    continue
                try:
                    self._parts[name] = Part(pdir)
                except Exception:  # noqa: BLE001 - one bad part must not
                    # brick the shard: quarantine and keep serving
                    # (storage/failed_parts_handler.go analog)
                    quarantined.append(name)
        if quarantined:
            import shutil

            fp = self.root / self.FAILED_PARTS_DIR
            fp.mkdir(exist_ok=True)
            for name in quarantined:
                dest = fp / name
                if dest.exists():
                    shutil.rmtree(dest, ignore_errors=True)
                (self.root / name).rename(dest)
                listed.discard(name)
            # size cap: evict oldest quarantined dirs
            kept = sorted(fp.iterdir(), key=lambda p: p.name)
            for old in kept[: max(0, len(kept) - self.FAILED_PARTS_CAP)]:
                shutil.rmtree(old, ignore_errors=True)
            self._publish()
        # GC orphans: part dirs written but never published (crash between
        # PartWriter.write and _publish), and dirs dropped by a merge whose
        # deletion didn't complete.  Without this, a crash mid-flush would
        # permanently collide on the next epoch's part name.
        import shutil

        for pdir in self.root.glob("part-*"):
            if pdir.name not in listed:
                shutil.rmtree(pdir, ignore_errors=True)
        for pdir in self.root.glob(".tmp-merge-*"):
            shutil.rmtree(pdir, ignore_errors=True)
        for pdir in self.root.glob(".tmp-flush-*"):
            shutil.rmtree(pdir, ignore_errors=True)

    def _publish(self) -> None:
        fs.atomic_write_json(
            self.root / SNAPSHOT,
            {"epoch": self._epoch, "parts": sorted(self._parts.keys())},
        )

    @property
    def parts(self) -> list[Part]:
        with self._lock:
            return list(self._parts.values())

    def ingest(self, fn) -> None:
        """Run `fn(memtable)` under the shard lock.

        All writers MUST go through this: it excludes flush()'s memtable
        swap, which would otherwise strand a racing append in the drained
        table (write lost silently).
        """
        with self._lock:
            fn(self.mem)

    def flush(self) -> Optional[list[str]]:
        """Memtable -> new part(s) + snapshot publish. Returns part names.

        Multi-resource memtables (measure engines) drain to one part per
        resource.  The shard lock is held only for the two O(1) commit
        points — the memtable swap and the rename+publish — NEVER across
        the part encode/write: at sustained ingest a whole-memtable
        encode is hundreds of ms, and holding the lock there stalled
        every concurrent append AND every query's ``parts`` snapshot
        behind the flush (the streamagg load run measured multi-second
        query tails from exactly this).  Between the two commit points
        the drained rows stay queryable through the ``_flushing``
        snapshot (``hot_columns``); a reader racing the second commit
        may see a row in BOTH the flushing snapshot and the new part,
        which the (series, ts) max-version dedup every query path
        already applies collapses to one — rows are never invisible.
        """
        import shutil
        import uuid as _uuid

        with self._flush_mutex:
            return self._flush_serialized(shutil, _uuid)

    def _flush_serialized(self, shutil, _uuid) -> Optional[list[str]]:
        with self._lock:
            if len(self.mem) == 0:
                return None
            drained = self.mem.drain()
            # publish the flushing snapshot BEFORE swapping the memtable:
            # hot_columns reads (mem, _flushing) lock-free in that order,
            # so rows must appear in _flushing before they vanish from
            # mem — the transient double-expose dedups, a gap would not
            self._flushing = tuple(
                (name, cols) for name, cols, _m in drained
            )
            self.mem = self._mem_factory()
        tmp_dirs: list[tuple[Path, dict]] = []
        try:
            for _suffix, cols, extra_meta in drained:
                if cols.ts.size == 0:
                    continue
                tmp = self.root / f".tmp-flush-{_uuid.uuid4().hex}"
                PartWriter.write(
                    tmp,
                    ts=cols.ts,
                    series=cols.series,
                    version=cols.version,
                    tag_codes=dict(cols.tags),
                    tag_dicts=dict(cols.dicts),
                    fields=dict(cols.fields),
                    extra_meta=extra_meta,
                    payloads=cols.payloads,
                )
                tmp_dirs.append((tmp, extra_meta))
            names = []
            built = []
            with self._lock:
                for tmp, extra_meta in tmp_dirs:
                    self._epoch += 1
                    name = f"part-{self._epoch:016x}"
                    os.rename(tmp, self.root / name)
                    self._parts[name] = Part(self.root / name)
                    names.append(name)
                    built.append((self.root / name, extra_meta))
                self._publish()
                self._flushing = ()
        except BaseException:
            # failed encode: same contract as before (rows in a failed
            # flush are lost with the exception surfaced), but the
            # flushing snapshot must not keep serving rows that will
            # never become a part
            with self._lock:
                self._flushing = ()
            for tmp, _m in tmp_dirs:
                shutil.rmtree(tmp, ignore_errors=True)
            raise
        # sidecar builds decode whole parts — outside the lock so appends
        # and publishes don't stall (queries before sidecars exist simply
        # scan unpruned; pruning is optional)
        for part_dir, extra_meta in built:
            self._notify_part_built(part_dir, extra_meta)
        return names

    @property
    def has_unflushed(self) -> bool:
        """Rows not yet committed to a published part: live memtable OR
        an in-flight flush snapshot (tier migration's quiescence gate
        must count both, or it could drop a segment whose last rows are
        mid-encode)."""
        return len(self.mem) > 0 or bool(self._flushing)

    def hot_columns(self, resource: str) -> list:
        """Unflushed sources for one resource: the live memtable plus
        any in-flight flush snapshot (rows between flush's two commit
        points).  Read lock-free — ``mem`` and ``_flushing`` are
        immutable-snapshot rebinds, and the memtable-first read order
        plus version dedup downstream makes every interleaving with
        flush() exact (see flush())."""
        out = []
        mem_cols = self.mem.columns_for(resource)
        if mem_cols is not None and mem_cols.ts.size:
            out.append(mem_cols)
        for rname, cols in self._flushing:
            if rname == resource and cols.ts.size:
                out.append(cols)
        return out

    def merge(
        self,
        min_merge: Optional[int] = None,
        max_parts: Optional[int] = None,
    ) -> Optional[str]:
        """One merge round (merger.go:39 analog). Returns new part name.

        Column reads AND the merged-part encode/write happen outside the
        lock (victim parts are immutable; the merged part lands in a temp
        dir).  Under the lock only: re-check victims, rename temp dir to
        its epoch name, swap the part set, publish — the atomic commit
        (introducer.go:114 mergedIntroduction analog).  Old dirs are
        removed after publish — an in-flight reader that snapshotted the
        old part list can hit a vanished dir, a retryable snapshot miss
        (same contract as the reference's epoch-based part GC).
        """
        import shutil

        from banyandb_tpu_torch.storage import merge as merge_mod

        kwargs = {}
        if min_merge is not None:
            kwargs["min_merge"] = min_merge
        if max_parts is not None:
            kwargs["max_parts"] = max_parts
        victims = merge_mod.pick_merge_victims(self.parts, **kwargs)
        if not victims:
            return None
        cols, extra_meta = merge_mod.merge_columns(victims)
        # Sampler-chain gating at merge (trace/merger.go:318-342 analog):
        # an engine-installed filter returns a keep-mask over merged rows.
        if self._merge_filter_provider is not None:
            fn = self._merge_filter_provider()
            if fn is not None:
                import numpy as _np

                kind, name = merge_mod.resource_key(victims[0])
                try:
                    keep = fn(kind, name, cols)
                    if keep is not None:
                        keep = _np.asarray(keep, dtype=bool)
                        if keep.shape != cols.ts.shape:
                            raise ValueError(
                                f"sampler mask {keep.shape} != rows {cols.ts.shape}"
                            )
                except Exception:  # noqa: BLE001 - a buggy plugin must
                    # degrade to keep-all, never wedge the merge loop
                    import logging

                    logging.getLogger(__name__).exception(
                        "merge filter failed; keeping all rows"
                    )
                    keep = None
                if keep is not None:
                    cols = ColumnData(
                        ts=cols.ts[keep],
                        series=cols.series[keep],
                        version=cols.version[keep],
                        tags={t: c[keep] for t, c in cols.tags.items()},
                        fields={f: v[keep] for f, v in cols.fields.items()},
                        dicts=cols.dicts,
                        payloads=(
                            [p for p, k in zip(cols.payloads, keep) if k]
                            if cols.payloads is not None
                            else None
                        ),
                    )
        tmp_dir = self.root / f".tmp-merge-{os.getpid()}-{id(cols):x}"
        PartWriter.write(
            tmp_dir,
            ts=cols.ts,
            series=cols.series,
            version=cols.version,
            tag_codes=dict(cols.tags),
            tag_dicts=dict(cols.dicts),
            fields=dict(cols.fields),
            extra_meta=extra_meta,
            payloads=cols.payloads,
        )
        self._notify_part_built(tmp_dir, extra_meta)
        with self._lock:
            if any(v.name not in self._parts for v in victims):
                shutil.rmtree(tmp_dir, ignore_errors=True)
                return None  # lost a race with another merge round
            self._epoch += 1
            name = f"part-{self._epoch:016x}"
            os.rename(tmp_dir, self.root / name)
            for v in victims:
                del self._parts[v.name]
            self._parts[name] = Part(self.root / name)
            self._publish()
        for v in victims:
            shutil.rmtree(v.dir, ignore_errors=True)
        return name


class Segment:
    """One time bucket: a shard list + [start, end) bounds + series index
    (the per-segment sidx of the reference, segment.go:540)."""

    def __init__(
        self,
        root: Path,
        start_millis: int,
        interval_millis: int,
        shard_num: int,
        mem_factory: Callable[[], MemTable],
        merge_filter_provider: Optional[Callable] = None,
        part_built_provider: Optional[Callable] = None,
        clock: Callable[[], float] = time.time,
    ):
        self.root = root
        self.start = start_millis
        self.end = start_millis + interval_millis
        self._clock = clock
        self.shards = [
            Shard(
                root / f"shard-{i}",
                mem_factory,
                merge_filter_provider=merge_filter_provider,
                part_built_provider=part_built_provider,
            )
            for i in range(shard_num)
        ]
        self._sidx = None
        self._sidx_lock = threading.Lock()
        # idle-reclaim clock (segment.go:81 lastAccessed analog): bumped by
        # real read/write touches, NOT by background loops walking segments
        self.last_accessed = clock()
        self._reclaimed = False

    def touch(self) -> None:
        self.last_accessed = self._clock()
        # caches may repopulate from here on: eligible for reclaim again
        self._reclaimed = False

    def reset_index(self) -> None:
        """Persist + release the series index's memory and per-part
        dictionary caches (segmentController.closeIdleSegments /
        segment.resetIndex analog, rotation.go:134, segment.go:334).

        The reference's motivation transfers directly: without reclaim,
        per-segment index writers accumulate across rotations.  `_sidx`
        keeps its identity (never reset to None) — concurrent holders see
        the same object, whose internal lock serializes reclaim against
        in-flight inserts/searches and lazily reloads on next use."""
        # flag FIRST: a touch() racing with the release below clears it,
        # keeping a just-repopulated segment eligible for the next idle
        # pass (flag-last would clobber the touch and exempt it forever)
        self._reclaimed = True
        with self._sidx_lock:
            sidx = self._sidx
        if sidx is not None:
            sidx.reclaim()
        for shard in self.shards:
            for part in shard.parts:
                part.release_cached()

    @property
    def series_index(self):
        if self._sidx is None:
            with self._sidx_lock:
                if self._sidx is None:
                    from banyandb_tpu_torch.index.series import SeriesIndex

                    self._sidx = SeriesIndex(self.root / "sidx.idx")
        return self._sidx

    def persist_index(self) -> None:
        if self._sidx is not None:
            self._sidx.persist()

    def overlaps(self, begin: int, end: int) -> bool:
        return self.start < end and begin < self.end


class TSDB:
    """Per-(group, engine) database: segment map + routing (tsdb.go:145)."""

    def __init__(
        self,
        root: str | Path,
        group: str,
        opts: ResourceOpts,
        mem_factory: Callable[[], MemTable],
        clock: Callable[[], float] = time.time,
    ):
        self.root = Path(root) / group
        self.opts = opts
        self.mem_factory = mem_factory
        self._clock = clock
        self._lock = threading.Lock()
        self._segments: dict[int, Segment] = {}
        # Optional merge-time row filter: fn(kind, name, ColumnData) ->
        # keep-mask (bool array) or None.  The trace engine's sampler
        # pipeline hook (PIPELINE_EVENT_MERGE analog) — engines set it;
        # Shard.merge applies it after column combine.
        self.merge_filter = None
        # Optional engine hook: fn(part_dir, extra_meta) called after any
        # part is fully written (flush and merge) — the stream engine's
        # element-index/bloom sidecar build (index/element.py).
        self.on_part_built = None
        # rotation scheduler state (rotation.go:31-47 analog): ticks are
        # throttled to one per snap window; pre-creation fires only inside
        # the creation gap before the latest segment's end.
        self.tick_snap_ms = 600_000  # timeEventSnapDuration (10 min)
        self.creation_gap_ms = 3_600_000  # creationGap (1 h)
        self._latest_tick_ms = 0
        # high-water mark of write-event timestamps: rotation ticks derive
        # from it (rotation.go Tick is fed by write events, NOT wall clock),
        # so a write-idle group stops pre-creating segments
        self.max_event_ms = 0
        self._reopen()

    def _reopen(self) -> None:
        """Rediscover existing segments from disk (restart path)."""
        if not self.root.exists():
            return
        iv = self.opts.segment_interval
        for seg_dir in sorted(self.root.glob("seg-*")):
            stamp = seg_dir.name[4:]
            if iv.unit == "hour":
                t = dt.datetime.strptime(stamp, "%Y%m%d%H")
            else:
                t = dt.datetime.strptime(stamp, "%Y%m%d")
            start = int(t.replace(tzinfo=dt.timezone.utc).timestamp() * 1000)
            self._segments[start] = Segment(
                seg_dir, start, iv.millis, self.opts.shard_num,
                self.mem_factory, lambda: self.merge_filter,
                lambda: self.on_part_built, clock=self._clock,
            )

    def segment_for(
        self, ts_millis: int, create: bool = True, event: bool = True
    ) -> Optional[Segment]:
        """event=False marks non-write callers (tick's own pre-creation):
        they must not advance the write high-water mark, or a pre-created
        segment's start would itself count as a "write" and chain into
        runaway pre-creation on hour-interval segments."""
        iv = self.opts.segment_interval
        start = segment_start(ts_millis, iv.millis)
        with self._lock:
            seg = self._segments.get(start)
            if seg is None and create:
                seg = Segment(
                    self.root / segment_name(start, iv.unit),
                    start,
                    iv.millis,
                    self.opts.shard_num,
                    self.mem_factory,
                    lambda: self.merge_filter,
                    lambda: self.on_part_built,
                    clock=self._clock,
                )
                self._segments[start] = seg
            if seg is not None:
                seg.touch()
                if create and event and ts_millis > self.max_event_ms:
                    self.max_event_ms = ts_millis
            return seg

    def tick(self, ts_millis: int) -> bool:
        """Rotation tick (rotation.go:36 Tick + :52 startRotationTask).

        Pre-creates the NEXT time segment once `ts` enters the creation
        gap before the latest segment's end, so the first write landing in
        a fresh time bucket never pays segment mkdir + shard + index-open
        latency inline.  Ticks are throttled to one per `tick_snap_ms`.
        Returns True when a segment was pre-created.
        """
        if ts_millis <= 0:
            return False
        if ts_millis - self.tick_snap_ms < self._latest_tick_ms:
            return False
        self._latest_tick_ms = ts_millis
        with self._lock:
            if not self._segments:
                return False
            latest = self._segments[max(self._segments)]
            gap = latest.end - ts_millis
        # gap <= 0: the event is from the future — the write path itself
        # creates that segment directly (rotation.go:115 comment).  Once a
        # pre-creation fires, `latest` advances to the new segment, so
        # follow-up ticks in the same window see gap > interval and are
        # no-ops: True really does mean "a segment was created".
        if gap <= 0 or gap > min(self.creation_gap_ms, self.opts.segment_interval.millis):
            return False
        self.segment_for(latest.end, event=False)
        return True

    def close_idle_segments(self, idle_timeout_s: float, now_s: Optional[float] = None) -> int:
        """Release index + cache memory of segments idle past the timeout
        (segmentController.closeIdleSegments, segment.go:334 analog).

        Reclaim is memory-only: parts and the persisted series index stay
        on disk and reopen lazily, so reclaiming a segment a query is
        about to touch costs a reload, never correctness."""
        if idle_timeout_s <= 0:
            return 0
        # same clock domain as Segment.touch — callers normally omit now_s
        now = self._clock() if now_s is None else now_s
        closed = 0
        for seg in self.segments:
            # _reclaimed: nothing repopulated since the last reclaim (only
            # a touch clears it) — skip, so a permanently idle segment is
            # neither re-walked nor re-counted every pass
            if not seg._reclaimed and now - seg.last_accessed >= idle_timeout_s:
                seg.reset_index()
                closed += 1
        return closed

    def close(self) -> None:
        """Deterministic shutdown: persist + release every segment's
        index memory and mmap'd files (the explicit analog of
        close_idle_segments — without it, sidx segment handles outlive
        the database and fail the bdsan fd-leak gate).  Reopen stays
        lazy, so a closed TSDB that is touched again just reloads."""
        for seg in self.segments:
            seg.reset_index()

    def select_segments(self, begin: int, end: int) -> list[Segment]:
        """Segments overlapping [begin, end) (storage.go:118 analog)."""
        with self._lock:
            hit = [
                s
                for _, s in sorted(self._segments.items())
                if s.overlaps(begin, end)
            ]
        for s in hit:
            s.touch()
        return hit

    @property
    def segments(self) -> list[Segment]:
        with self._lock:
            return [s for _, s in sorted(self._segments.items())]

    def flush_all(self) -> list[str]:
        flushed = []
        for seg in self.segments:
            for shard in seg.shards:
                names = shard.flush()
                for name in names or []:
                    flushed.append(f"{seg.root.name}/{shard.root.name}/{name}")
            seg.persist_index()
        return flushed

    def retention_sweep(self, now_millis: int) -> list[str]:
        """Delete segments past TTL (rotation.go retentionTask analog)."""
        import shutil

        cutoff = now_millis - self.opts.ttl.millis
        removed = []
        with self._lock:
            for start in list(self._segments.keys()):
                seg = self._segments[start]
                if seg.end <= cutoff:
                    shutil.rmtree(seg.root, ignore_errors=True)
                    removed.append(seg.root.name)
                    del self._segments[start]
        return removed
