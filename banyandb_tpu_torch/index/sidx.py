"""sidx: ordered secondary index as a part-based store.

Analog of the reference's sidx subsystem
(the reference's banyand/internal/sidx/interfaces.go:58 — a store with
its own mem -> flush -> merge part lifecycle keyed by a user-provided
int64 ordering key).
Elements are (key, payload) pairs; parts reuse the columnar part format
with the ordering key in the timestamp column (PartWriter sorts rows by
(series=0, key) and records per-block [min, max] key bounds), so
range queries prune whole blocks by key range and stream the survivors
in key order via a k-way merge across parts.

Durability mirrors a TSDB shard: immutable part dirs + a snapshot file
listing live parts; flush is the commit point; merge rewrites victims
into one part (pure concatenation — no version dedup: equal keys are
distinct elements).
"""

from __future__ import annotations

import heapq
import json
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from banyandb_tpu_torch.storage.part import Part, PartWriter
from banyandb_tpu_torch.utils import fs

SNAPSHOT = "sidx-snapshot.snp"


class SidxStore:
    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._merge_lock = threading.Lock()  # one merge at a time
        self._flush_lock = threading.Lock()  # one flush at a time (two
        # concurrent flushes would duplicate the mem prefix, then the
        # double trim deletes elements that reached no part)
        self._mem_keys: list[int] = []
        self._mem_payloads: list[bytes] = []
        self._epoch = 0
        self._parts: dict[str, Part] = {}
        self.last_blocks_read = 0  # query instrumentation (tests/bench)
        self._load_snapshot()

    # -- lifecycle ----------------------------------------------------------
    def _load_snapshot(self) -> None:
        import shutil

        snp = self.root / SNAPSHOT
        listed: set[str] = set()
        if snp.exists():
            data = fs.read_json(snp)
            self._epoch = data["epoch"]
            listed = set(data["parts"])
            for name in data["parts"]:
                pdir = self.root / name
                if pdir.exists():
                    self._parts[name] = Part(pdir)
        # a part dir NOT in the snapshot is a crash-orphan (staged flush
        # never committed, or interrupted merge temp): remove it so the
        # store reopens exactly at its last published snapshot
        for pdir in self.root.iterdir():
            if pdir.is_dir() and pdir.name not in listed:
                shutil.rmtree(pdir, ignore_errors=True)

    def _publish(self) -> None:
        fs.atomic_write_json(
            self.root / SNAPSHOT,
            {"epoch": self._epoch, "parts": sorted(self._parts)},
        )

    def insert(self, key: int, payload: bytes) -> None:
        with self._lock:
            self._mem_keys.append(int(key))
            self._mem_payloads.append(payload)

    def __len__(self) -> int:
        with self._lock:
            n = len(self._mem_keys)
        return n + sum(p.total_count for p in self._parts.values())

    def flush(self) -> Optional[str]:
        txn = self.prepare_flush()
        if txn is None:
            return None
        return txn.commit()

    def prepare_flush(self) -> Optional["SidxFlushTxn"]:
        """Stage a flush WITHOUT publishing (PrepareFlushed analog,
        the reference's banyand/internal/sidx/interfaces.go:37): the part
        is written to disk but the snapshot is untouched until commit(),
        so a host engine can order the sidx commit point relative to its
        own store's publish.  Holds the flush lock until commit/abort —
        exactly one staged flush can be outstanding.

        Crash semantics: an unpublished part dir is an orphan; reopen
        removes it (not listed in the snapshot), as if the flush never
        happened."""
        self._flush_lock.acquire()
        try:
            # mem is only TRIMMED at commit (same lock), so a concurrent
            # range_query always sees every element in exactly one of
            # (mem prefix, new part) — no invisible window mid-flush.
            with self._lock:
                if not self._mem_keys:
                    self._flush_lock.release()
                    return None
                keys = list(self._mem_keys)
                payloads = list(self._mem_payloads)
                self._epoch += 1
                name = f"part-{self._epoch:016x}"
            n = len(keys)
            PartWriter.write(
                self.root / name,
                ts=np.asarray(keys, dtype=np.int64),
                series=np.zeros(n, dtype=np.int64),
                version=np.zeros(n, dtype=np.int64),
                tag_codes={},
                tag_dicts={},
                fields={},
                extra_meta={"sidx": True},
                payloads=payloads,
            )
            return SidxFlushTxn(self, name, n)
        except BaseException:
            import shutil

            # a half-written part dir is garbage now, not just at the
            # next reopen's orphan sweep
            try:
                shutil.rmtree(self.root / name, ignore_errors=True)
            except NameError:
                pass  # failed before the part name existed
            self._flush_lock.release()
            raise

    def _commit_staged(self, name: str, n: int) -> str:
        try:
            with self._lock:
                # Open + publish the part BEFORE trimming the mem prefix:
                # if either raises (bad metadata, disk full on publish) the
                # elements are still mem-resident and the staged dir is
                # just an orphan for the reopen sweep — nothing is lost.
                part = Part(self.root / name)
                self._parts[name] = part
                try:
                    self._publish()
                except BaseException:
                    del self._parts[name]
                    raise
                del self._mem_keys[:n]
                del self._mem_payloads[:n]
            return name
        finally:
            self._flush_lock.release()

    def _abort_staged(self, name: str) -> None:
        import shutil

        try:
            shutil.rmtree(self.root / name, ignore_errors=True)
            # the epoch bump is NOT rolled back: part names stay unique
        finally:
            self._flush_lock.release()

    def merge(self, max_parts: int = 8) -> Optional[str]:
        """Rewrite all parts into one when the count passes max_parts.
        Pure concatenation (the part writer re-sorts by key): equal keys
        are distinct elements and are all preserved."""
        if not self._merge_lock.acquire(blocking=False):
            return None  # another merge round is running
        try:
            return self._merge_locked(max_parts)
        finally:
            self._merge_lock.release()

    def _merge_locked(self, max_parts: int) -> Optional[str]:
        import os
        import shutil
        import uuid

        with self._lock:
            victims = list(self._parts.values())
        if len(victims) < max_parts:
            return None
        keys_l, payloads = [], []
        for p in victims:
            cols = p.read(
                range(len(p.blocks)), want_payload=True, cached=False
            )
            keys_l.append(cols.ts)
            payloads.extend(cols.payloads or [])
        keys = np.concatenate(keys_l)
        tmp = self.root / f".tmp-merge-{uuid.uuid4().hex}"
        shutil.rmtree(tmp, ignore_errors=True)
        PartWriter.write(
            tmp,
            ts=keys,
            series=np.zeros(len(keys), dtype=np.int64),
            version=np.zeros(len(keys), dtype=np.int64),
            tag_codes={},
            tag_dicts={},
            fields={},
            extra_meta={"sidx": True},
            payloads=payloads,
        )
        with self._lock:
            if any(v.name not in self._parts for v in victims):
                shutil.rmtree(tmp, ignore_errors=True)
                return None
            self._epoch += 1
            name = f"part-{self._epoch:016x}"
            os.rename(tmp, self.root / name)
            for v in victims:
                del self._parts[v.name]
            self._parts[name] = Part(self.root / name)
            self._publish()
        for v in victims:
            shutil.rmtree(v.dir, ignore_errors=True)
        return name

    # -- query --------------------------------------------------------------
    def _part_iter(
        self, part: Part, lo: Optional[int], hi: Optional[int], asc: bool
    ) -> Iterator[tuple[int, bytes]]:
        """Stream (key, payload) from one part in key order, reading one
        block at a time; blocks outside [lo, hi] are never read."""
        blocks = part.select_blocks(
            lo if lo is not None else -(1 << 62),
            (hi + 1) if hi is not None else (1 << 62),
        )
        if not asc:
            blocks = list(reversed(blocks))
        for bid in blocks:
            self.last_blocks_read += 1
            cols = part.read([bid], want_payload=True)
            keys = cols.ts
            order = range(len(keys)) if asc else range(len(keys) - 1, -1, -1)
            for i in order:
                k = int(keys[i])
                if lo is not None and k < lo:
                    continue
                if hi is not None and k > hi:
                    continue
                yield k, (cols.payloads[i] if cols.payloads else b"")

    def range_query(
        self,
        lo: Optional[int] = None,
        hi: Optional[int] = None,
        *,
        asc: bool = True,
        limit: Optional[int] = None,
    ) -> list[tuple[int, bytes]]:
        """Elements with key in [lo, hi], globally key-ordered across mem
        + all parts (k-way heap merge of per-part block streams).

        A concurrent merge can GC a victim part dir mid-stream; that
        read raises FileNotFoundError and the query retries against the
        fresh snapshot (the repo's standard retryable-snapshot-miss
        contract)."""
        for attempt in range(3):
            try:
                return self._range_query_once(lo, hi, asc=asc, limit=limit)
            except FileNotFoundError:
                if attempt == 2:
                    raise
        raise AssertionError("unreachable")

    def _range_query_once(
        self,
        lo: Optional[int],
        hi: Optional[int],
        *,
        asc: bool,
        limit: Optional[int],
    ) -> list[tuple[int, bytes]]:
        self.last_blocks_read = 0
        with self._lock:
            parts = list(self._parts.values())
            mem = sorted(
                (
                    (k, p)
                    for k, p in zip(self._mem_keys, self._mem_payloads)
                    if (lo is None or k >= lo) and (hi is None or k <= hi)
                ),
                reverse=not asc,
            )
        streams = [self._part_iter(p, lo, hi, asc) for p in parts]
        streams.append(iter(mem))
        merged = heapq.merge(
            *streams, key=lambda kp: kp[0] if asc else -kp[0]
        )
        out = []
        for kp in merged:
            out.append(kp)
            if limit is not None and len(out) >= limit:
                break
        return out


class SidxFlushTxn:
    """One staged sidx flush.  commit() publishes the part in the
    snapshot and trims the flushed mem prefix; abort() deletes the
    unpublished part dir.  Exactly one of the two must be called."""

    def __init__(self, store: SidxStore, name: str, n: int):
        self._store = store
        self.name = name
        self._n = n
        self._done = False

    def commit(self) -> str:
        assert not self._done, "txn already finished"
        self._done = True
        return self._store._commit_staged(self.name, self._n)

    def abort(self) -> None:
        assert not self._done, "txn already finished"
        self._done = True
        self._store._abort_staged(self.name)


def encode_ref(trace_id: str, ts_millis: int) -> bytes:
    """Payload for trace ordered queries: id + timestamp."""
    return json.dumps([trace_id, ts_millis]).encode()


def decode_ref(payload: bytes) -> tuple[str, int]:
    tid, ts = json.loads(payload)
    return tid, int(ts)
