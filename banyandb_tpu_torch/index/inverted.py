"""Inverted index: memtable + immutable on-disk posting segments.

Design (vs the reference's Bluge wrapper, pkg/index/index.go:64,479,824;
segment store pkg/index/inverted/inverted.go:1-655 — FST dictionary +
roaring postings in immutable ICE segments):

- A document is (doc_id:int64, keyword fields: bytes values, numeric
  fields: int64 values, stored payload: bytes).
- Fresh docs land in a memtable dict; queries evaluate it with direct
  predicate checks (small, bounded by flush cadence).
- persist() flushes the memtable to a NEW immutable segment file
  (index/segment.py: CSR postings per field, memmap-at-rest) and
  atomically commits a manifest — incremental: O(memtable), never a
  whole-store rewrite.
- Overwrites and deletes mark *delete bitmaps* on older segments
  (mutable sidecars, versioned per commit, referenced by the manifest)
  so at most one live copy of a doc_id exists anywhere.
- When the segment count passes MERGE_FANOUT, persist() folds the
  smallest half into one segment (size-tiered background merge; the
  same part-lifecycle discipline the TSDB uses).
- Restart opens the manifest + segment headers only: O(segments), not
  O(docs); searches ride memmapped postings without materialising docs.

Mutability follows the reference's Property/series model: updates are
re-inserts of the same doc_id (last write wins), deletes are tombstones;
physical removal happens at merge.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Mapping, Optional, Sequence, Union

import numpy as np

from banyandb_tpu_torch.index.segment import Segment, build_segment
from banyandb_tpu_torch.utils import compress as zst
from banyandb_tpu_torch.utils import encoding as enc
from banyandb_tpu_torch.utils import fs


@dataclass(frozen=True)
class Doc:
    doc_id: int
    keywords: Mapping[str, bytes] = field(default_factory=dict)
    numerics: Mapping[str, int] = field(default_factory=dict)
    payload: bytes = b""


@dataclass(frozen=True)
class TermQuery:
    field: str
    value: bytes


@dataclass(frozen=True)
class RangeQuery:
    field: str
    lo: Optional[int] = None  # inclusive
    hi: Optional[int] = None  # inclusive


@dataclass(frozen=True)
class And:
    clauses: tuple


@dataclass(frozen=True)
class Or:
    clauses: tuple


@dataclass(frozen=True)
class Not:
    clause: object


Query = Union[TermQuery, RangeQuery, And, Or, Not, None]


def _match_doc(d: Doc, q: Query) -> bool:
    """Direct predicate evaluation for memtable docs."""
    if q is None:
        return True
    if isinstance(q, TermQuery):
        return d.keywords.get(q.field) == q.value
    if isinstance(q, RangeQuery):
        v = d.numerics.get(q.field)
        if v is None:
            return False
        return (q.lo is None or v >= q.lo) and (q.hi is None or v <= q.hi)
    if isinstance(q, And):
        return all(_match_doc(d, c) for c in q.clauses)
    if isinstance(q, Or):
        return any(_match_doc(d, c) for c in q.clauses)
    if isinstance(q, Not):
        return not _match_doc(d, q.clause)
    raise TypeError(f"unknown query {type(q)}")


_EMPTY = np.zeros(0, dtype=np.int64)


class InvertedIndex:
    """One mutable index instance (a per-segment / per-shard store)."""

    MERGE_FANOUT = 8

    def __init__(self, path: Optional[str | Path] = None):
        self._lock = threading.RLock()
        self.path = Path(path) if path else None
        self._mem: dict[int, Doc] = {}
        # oldest..newest; Segment owns its tombstone bitmap
        self._segs: list[tuple[str, Segment]] = []
        self._tomb_gens: dict[str, int] = {}
        self._next_seg = 1
        self._released = False
        if self.path is not None:
            tmpdir = self._tmpdir_path()
            if not self.path.exists() and tmpdir.exists():
                # crash between legacy-file unlink and dir rename
                tmpdir.rename(self.path)
            if self.path.exists():
                self._open()

    # -- lifecycle ---------------------------------------------------------
    def _tmpdir_path(self) -> Path:
        return self.path.parent / f".{self.path.name}.migrating"

    def _open(self) -> None:
        if self.path.is_file():
            self._load_legacy(self.path)
            return
        man_path = self.path / "manifest.json"
        if not man_path.exists():
            return  # fresh/empty dir: nothing committed yet
        man = fs.read_json(man_path)
        for ent in man["segments"]:
            name, gen = ent["name"], ent.get("tomb_gen", 0)
            tomb = self.path / f"{name}.tomb-{gen}" if gen else None
            seg = Segment(self.path / f"{name}.seg", tomb_path=tomb)
            self._segs.append((name, seg))
            self._tomb_gens[name] = gen
        self._next_seg = int(man.get("next_seg", len(self._segs) + 1))

    def reclaim(self) -> None:
        """Persist, then release all in-memory state (idle-segment memory
        reclaim, segment.go:334 closeIdleSegments analog).  The instance
        stays valid: every operation lazily reopens the manifest."""
        with self._lock:
            if not self.path or self._released:
                return
            self.persist()
            for _, seg in self._segs:
                seg.close()
            self._segs = []
            self._tomb_gens = {}
            self._mem = {}
            self._released = True

    def _ensure_loaded(self) -> None:
        """Reopen after reclaim(). Caller holds self._lock."""
        if self._released:
            self._released = False
            if self.path.exists():
                self._open()

    # -- mutation ----------------------------------------------------------
    def insert(self, docs: Iterable[Doc]) -> None:
        """Insert or overwrite by doc_id (ModRevision-style last-write-wins).
        Overwrites tombstone any older on-disk copy immediately so at most
        one live copy of a doc exists."""
        with self._lock:
            self._ensure_loaded()
            ids = []
            for d in docs:
                self._mem[d.doc_id] = d
                ids.append(d.doc_id)
            if self._segs and ids:
                arr = np.asarray(sorted(ids), dtype=np.int64)
                for _, seg in self._segs:
                    seg.tombstone_ids(arr)

    def insert_if_newer(
        self, doc: Doc, version_field: str = "@version"
    ) -> bool:
        """Atomic check-and-insert: keep the doc with the higher version."""
        with self._lock:
            self._ensure_loaded()
            old_v = self.get_numeric(doc.doc_id, version_field)
            if old_v is None and self.contains(doc.doc_id):
                old_v = 0  # doc exists but carries no version field
            if old_v is not None and old_v >= doc.numerics.get(version_field, 0):
                return False
            self.insert([doc])
            return True

    def delete(self, doc_ids: Iterable[int]) -> None:
        with self._lock:
            self._ensure_loaded()
            ids = list(doc_ids)
            for i in ids:
                self._mem.pop(i, None)
            if self._segs and ids:
                arr = np.asarray(sorted(ids), dtype=np.int64)
                for _, seg in self._segs:
                    seg.tombstone_ids(arr)

    def __len__(self) -> int:
        with self._lock:
            self._ensure_loaded()
            return len(self._mem) + sum(s.alive_count for _, s in self._segs)

    # -- query -------------------------------------------------------------
    def search(self, query: Query = None, limit: Optional[int] = None) -> np.ndarray:
        """-> sorted doc_id array matching the query (None = all docs)."""
        with self._lock:
            self._ensure_loaded()
            parts = [self._eval_segment(seg, query) for _, seg in self._segs]
            if self._mem:
                extra = [
                    d.doc_id for d in self._mem.values() if _match_doc(d, query)
                ]
                if extra:
                    parts.append(np.asarray(extra, dtype=np.int64))
            parts = [p for p in parts if p.size]
            if not parts:
                return _EMPTY
            out = (
                np.sort(parts[0])
                if len(parts) == 1
                else np.unique(np.concatenate(parts))
            )
            return out[:limit] if limit is not None else out

    def _eval_segment(self, seg: Segment, q: Query) -> np.ndarray:
        if q is None:
            return seg.alive_ids()
        if isinstance(q, TermQuery):
            return seg.eval_term(q.field, q.value)
        if isinstance(q, RangeQuery):
            return seg.eval_range(q.field, q.lo, q.hi)
        if isinstance(q, And):
            out = None
            for c in q.clauses:
                ids = self._eval_segment(seg, c)
                out = ids if out is None else np.intersect1d(out, ids)
                if out.size == 0:
                    break
            return out if out is not None else seg.alive_ids()
        if isinstance(q, Or):
            out = _EMPTY
            for c in q.clauses:
                out = np.union1d(out, self._eval_segment(seg, c))
            return out
        if isinstance(q, Not):
            # per-segment complement composes globally because tombstones
            # guarantee exactly one live copy of any doc across the store
            return np.setdiff1d(seg.alive_ids(), self._eval_segment(seg, q.clause))
        raise TypeError(f"unknown query {type(q)}")

    def range_ordered(
        self,
        field: str,
        lo: Optional[int] = None,
        hi: Optional[int] = None,
        *,
        asc: bool = True,
        limit: Optional[int] = None,
    ) -> np.ndarray:
        """doc_ids with lo <= numeric field <= hi, ORDERED by field value
        (the sidx analog: key-ordered retrieval, e.g. traces by duration).
        Merges the per-segment sorted projections + memtable extras."""
        with self._lock:
            self._ensure_loaded()
            vals_parts, ids_parts = [], []
            for _, seg in self._segs:
                v, i = seg.range_pairs(field, lo, hi)
                if v.size:
                    vals_parts.append(v)
                    ids_parts.append(i)
            if self._mem:
                extra = [
                    (d.numerics[field], d.doc_id)
                    for d in self._mem.values()
                    if field in d.numerics
                    and (lo is None or d.numerics[field] >= lo)
                    and (hi is None or d.numerics[field] <= hi)
                ]
                if extra:
                    vals_parts.append(np.asarray([e[0] for e in extra], dtype=np.int64))
                    ids_parts.append(np.asarray([e[1] for e in extra], dtype=np.int64))
            if not vals_parts:
                return _EMPTY
            vals = np.concatenate(vals_parts)
            ids = np.concatenate(ids_parts)
            order = np.argsort(vals, kind="stable")
            out = ids[order]
            if not asc:
                out = out[::-1]
            return out[:limit] if limit is not None else out

    def contains(self, doc_id: int) -> bool:
        """Existence probe without materialising the doc: memtable dict
        hit or a per-segment binary search — no column/payload reads.
        The measure write hot path (SeriesIndex.insert_series idempotency
        check) rides this on every data point."""
        with self._lock:
            self._ensure_loaded()
            if doc_id in self._mem:
                return True
            return any(seg.slot_of(doc_id) >= 0 for _, seg in self._segs)

    def get_numeric(self, doc_id: int, field: str) -> Optional[int]:
        """Read ONE numeric field of a doc without decoding keywords or
        payload (insert_if_newer's version probe)."""
        with self._lock:
            self._ensure_loaded()
            d = self._mem.get(doc_id)
            if d is not None:
                return d.numerics.get(field)
            for _, seg in reversed(self._segs):
                slot = seg.slot_of(doc_id)
                if slot >= 0:
                    return seg.numeric_at(slot, field)
            return None

    def get(self, doc_id: int) -> Optional[Doc]:
        with self._lock:
            self._ensure_loaded()
            d = self._mem.get(doc_id)
            if d is not None:
                return d
            for _, seg in reversed(self._segs):
                slot = seg.slot_of(doc_id)
                if slot >= 0:
                    kws, nums, payload = seg.doc_fields(slot)
                    return Doc(doc_id, kws, nums, payload)
            return None

    def get_many(self, doc_ids: Sequence[int]) -> list[Doc]:
        with self._lock:
            self._ensure_loaded()
            out = []
            for i in doc_ids:
                d = self.get(i)
                if d is not None:
                    out.append(d)
            return out

    # -- persistence -------------------------------------------------------
    def persist(self) -> None:
        """Commit pending state: flush the memtable to a new immutable
        segment, write updated delete bitmaps, atomically publish the
        manifest, then GC unreferenced files.  O(pending changes), not
        O(total docs) — plus an amortised size-tiered merge."""
        if not self.path:
            return
        with self._lock:
            if self._released:
                return  # state already on disk
            dirty_tombs = [
                (name, seg) for name, seg in self._segs if seg._tomb_dirty
            ]
            # Legacy single-file store: build the segmented dir next to it,
            # then unlink + rename (the whole legacy doc set is already in
            # the memtable, so nothing else needs carrying over).  Never
            # short-circuit while migrating — an all-docs-deleted legacy
            # store has an empty memtable but MUST still replace the file,
            # or the deleted docs resurrect on reopen.
            migrating = self.path.exists() and self.path.is_file()
            if not self._mem and not dirty_tombs and not migrating:
                return
            root = self._tmpdir_path() if migrating else self.path
            root.mkdir(parents=True, exist_ok=True)

            new_entries = []
            if self._mem:
                name = f"seg-{self._next_seg:06d}"
                self._next_seg += 1
                blob = build_segment(*self._columns_from_mem())
                fs.atomic_write(root / f"{name}.seg", blob)
                new_entries.append(name)
            # delete bitmaps: versioned sidecars, committed by the manifest
            for name, seg in dirty_tombs:
                gen = self._tomb_gens.get(name, 0) + 1
                fs.atomic_write(
                    root / f"{name}.tomb-{gen}",
                    np.ascontiguousarray(seg._tomb, dtype=np.uint8).tobytes(),
                )
                self._tomb_gens[name] = gen
                seg._tomb_dirty = False

            self._write_manifest(root, extra=new_entries)
            if migrating:
                self.path.unlink()
                root.rename(self.path)
            for name in new_entries:
                self._segs.append(
                    (name, Segment(self.path / f"{name}.seg"))
                )
            self._mem = {}
            self._maybe_merge()
            self._gc()

    def _columns_from_mem(self):
        ids = np.asarray(sorted(self._mem), dtype=np.int64)
        docs = [self._mem[int(i)] for i in ids]
        n = len(docs)
        kw_names = sorted({f for d in docs for f in d.keywords})
        num_names = sorted({f for d in docs for f in d.numerics})
        kw = {}
        for f in kw_names:
            kw[f] = (
                [d.keywords.get(f, b"") for d in docs],
                np.asarray([f in d.keywords for d in docs], dtype=np.uint8),
            )
        num = {}
        for f in num_names:
            num[f] = (
                np.asarray([d.numerics.get(f, 0) for d in docs], dtype=np.int64),
                np.asarray([f in d.numerics for d in docs], dtype=np.uint8),
            )
        return ids, kw, num, [d.payload for d in docs]

    def _write_manifest(self, root: Path, extra: Sequence[str] = ()) -> None:
        fs.atomic_write_json(
            root / "manifest.json",
            {
                "version": 1,
                "segments": [
                    {"name": name, "tomb_gen": self._tomb_gens.get(name, 0)}
                    for name, _ in self._segs
                ]
                + [{"name": n, "tomb_gen": 0} for n in extra],
                "next_seg": self._next_seg,
            },
        )

    def _maybe_merge(self) -> None:
        """Size-tiered compaction: fold the smallest half of the segments
        into one when the count passes MERGE_FANOUT.  Amortised log-
        structured cost; drops tombstoned docs physically."""
        if len(self._segs) < self.MERGE_FANOUT:
            return
        by_size = sorted(self._segs, key=lambda t: t[1].alive_count)
        victims = by_size[: max(2, len(self._segs) // 2)]
        victim_names = {name for name, _ in victims}

        # Columnar merge: concatenate the victims' alive columns and
        # re-sort by doc id — no per-doc Python objects.  Tombstones
        # guarantee doc ids are disjoint across segments.
        cols = [seg.alive_columns() for _, seg in victims]
        cols = [c for c in cols if len(c[0])]
        name = f"seg-{self._next_seg:06d}"
        self._next_seg += 1
        merged_n = 0
        if cols:
            all_ids = np.concatenate([c[0] for c in cols])
            order = np.argsort(all_ids, kind="stable")
            merged_n = len(all_ids)
            kw_names = sorted({f for c in cols for f in c[1]})
            num_names = sorted({f for c in cols for f in c[2]})
            kw = {}
            for f in kw_names:
                vals: list[bytes] = []
                pres_parts = []
                for c in cols:
                    n_c = len(c[0])
                    if f in c[1]:
                        vals.extend(c[1][f][0])
                        pres_parts.append(c[1][f][1])
                    else:
                        vals.extend([b""] * n_c)
                        pres_parts.append(np.zeros(n_c, dtype=np.uint8))
                kw[f] = (
                    [vals[i] for i in order.tolist()],
                    np.concatenate(pres_parts)[order],
                )
            num = {}
            for f in num_names:
                v_parts, p_parts = [], []
                for c in cols:
                    n_c = len(c[0])
                    if f in c[2]:
                        v_parts.append(c[2][f][0])
                        p_parts.append(c[2][f][1])
                    else:
                        v_parts.append(np.zeros(n_c, dtype=np.int64))
                        p_parts.append(np.zeros(n_c, dtype=np.uint8))
                num[f] = (
                    np.concatenate(v_parts)[order],
                    np.concatenate(p_parts)[order],
                )
            payloads_flat: list[bytes] = []
            for c in cols:
                payloads_flat.extend(c[3])
            payloads = [payloads_flat[i] for i in order.tolist()]
            blob = build_segment(all_ids[order], kw, num, payloads)
            fs.atomic_write(self.path / f"{name}.seg", blob)
        survivors = [t for t in self._segs if t[0] not in victim_names]
        if merged_n:
            survivors.append((name, Segment(self.path / f"{name}.seg")))
        for vname, vseg in victims:
            vseg.close()
            self._tomb_gens.pop(vname, None)
        self._segs = survivors
        self._write_manifest(self.path)

    def _gc(self) -> None:
        """Remove files no longer referenced by the manifest."""
        live = set()
        for name, _ in self._segs:
            live.add(f"{name}.seg")
            gen = self._tomb_gens.get(name, 0)
            if gen:
                live.add(f"{name}.tomb-{gen}")
        live.add("manifest.json")
        try:
            for p in self.path.iterdir():
                if p.name not in live and (
                    p.name.endswith(".seg")
                    or ".tomb-" in p.name
                ):
                    p.unlink(missing_ok=True)
        except OSError:
            pass  # GC is advisory; next persist retries

    # -- legacy single-file format (pre-segment stores) --------------------
    _MAGIC = b"BTIX2\n"
    _MAGIC_V1 = b"BTIX1\n"

    def _load_legacy(self, path: Path) -> None:
        """Read a v1/v2 whole-store file into the memtable; the next
        persist() migrates it to the segmented layout in place."""
        blob = path.read_bytes()
        magic = blob[: len(self._MAGIC)]
        if magic not in (self._MAGIC, self._MAGIC_V1):
            raise ValueError(f"bad index file magic {magic!r}: {path}")
        v1 = magic == self._MAGIC_V1
        raw = zst.decompress(blob[len(self._MAGIC) :])
        off = 0
        blobs: list[bytes] = []
        while off < len(raw):
            ln = int.from_bytes(raw[off : off + 4], "little")
            off += 4
            blobs.append(raw[off : off + ln])
            off += ln
        it = iter(blobs)
        first = next(it)
        kw_names = [b.decode() for b in enc.decode_strings(next(it))]
        num_names = [b.decode() for b in enc.decode_strings(next(it))]
        kw_cols = {}
        kw_present = {}
        for f in kw_names:
            kw_cols[f] = enc.decode_strings(next(it))
            if v1:
                kw_present[f] = [1 if v != b"" else 0 for v in kw_cols[f]]
            else:
                kw_present[f] = enc.decode_int64(next(it), len(kw_cols[f]))
        n = len(next(iter(kw_cols.values()))) if kw_cols else None
        num_cols = {}
        num_present = {}
        for f in num_names:
            vals_blob = next(it)
            pres_blob = next(it)
            if n is None:
                raise ValueError("index file with numeric-only docs needs n")
            num_cols[f] = enc.decode_int64(vals_blob, n)
            num_present[f] = enc.decode_int64(pres_blob, n)
        payloads = enc.decode_strings(next(it))
        if n is None:
            n = len(payloads)
        ids = enc.decode_int64(first, n)
        for i in range(n):
            self._mem[int(ids[i])] = Doc(
                doc_id=int(ids[i]),
                keywords={
                    f: kw_cols[f][i] for f in kw_names if kw_present[f][i]
                },
                numerics={
                    f: int(num_cols[f][i])
                    for f in num_names
                    if num_present[f][i]
                },
                payload=payloads[i],
            )
