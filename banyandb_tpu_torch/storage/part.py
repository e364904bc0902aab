"""On-disk columnar part format.

Layout analog of the reference's measure part
(banyand/measure/part.go:48-52 — meta.bin, primary.bin, timestamps.bin,
fv.bin, per-family tag files, metadata.json) redesigned so decoded columns
land directly in device-feedable dense arrays:

    part-<id>/
      metadata.json        # part-level stats + column inventory
      primary.bin          # zstd(JSON block index: per-block column extents)
      timestamps.bin       # per-block encoded int64 columns, concatenated
      series.bin           # per-block encoded series ids
      versions.bin         # per-block encoded write versions
      tag_<name>.bin       # per-block encoded dictionary codes
      tag_<name>.dict      # part-level dictionary (string table)
      field_<name>.bin     # per-block encoded numeric values

Rows are sorted by (series_id, ts); blocks cap at 8192 rows
(ops.blocks.MAX_ROWS, mirroring banyand/measure/measure.go:46).  Every
block records (offset, size) per column plus min/max ts + series for
pruning, so a query reads only the byte ranges its time range needs.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np

from banyandb_tpu_torch.ops.blocks import MAX_ROWS
from banyandb_tpu_torch.utils import compress as zst
from banyandb_tpu_torch.utils import encoding as enc
from banyandb_tpu_torch.utils import fs

_TS = "timestamps"
_SERIES = "series"
_VERSIONS = "versions"


@dataclass(frozen=True)
class ColumnData:
    """Decoded columns for a run of selected blocks (host numpy)."""

    ts: np.ndarray  # int64 [n]
    series: np.ndarray  # int64 [n]
    version: np.ndarray  # int64 [n]
    tags: Mapping[str, np.ndarray]  # int codes [n] (i32; narrow i8/i16
    # at stored width when read with narrow_codes=True — device decode)
    fields: Mapping[str, np.ndarray]  # float64 [n]
    dicts: Mapping[str, list[bytes]]  # per-tag dictionary
    # opaque per-row payloads (stream element ids / trace span bytes,
    # spans.bin analog); None for measure parts
    payloads: "Optional[list[bytes]]" = None
    # immutable identity for serving-cache layers (set for part-backed
    # sources; None for memtable/index sources, which mutate)
    cache_key: "Optional[tuple]" = None


@dataclass(frozen=True)
class KeyInterval:
    """The (series, ts) key coverage of one block/source, used by the
    zone-skip dedup-safety check (see Part.select_blocks).

    Rows are sorted by (series, ts), so a block's true key set is a
    contiguous LEX range [``lo``, ``hi``]; every key also lies in the
    series x ts rect (series range = the lex endpoints' series,
    ``ts_lo``/``ts_hi`` the block-wide ts bounds).  Two sources can
    share a key only if BOTH the lex ranges and the rects intersect —
    the conjunction prunes the two common false-overlap shapes: blocks
    of one part (lex-disjoint but rect-overlapping) and time-disjoint
    parts (lex-overlapping via series order but ts-disjoint).
    Conservative endpoints (rect corners, used for memtable sources and
    pre-upgrade parts) only ever widen the interval — safe."""

    lo: tuple  # (series, ts) lex lower bound
    hi: tuple  # (series, ts) lex upper bound
    ts_lo: int
    ts_hi: int

    @staticmethod
    def conservative(
        min_series: int, max_series: int, min_ts: int, max_ts: int
    ) -> "KeyInterval":
        return KeyInterval(
            (int(min_series), int(min_ts)),
            (int(max_series), int(max_ts)),
            int(min_ts),
            int(max_ts),
        )

    def intersects(self, other: "KeyInterval") -> bool:
        lex = self.lo <= other.hi and other.lo <= self.hi
        rect = self.ts_lo <= other.ts_hi and other.ts_lo <= self.ts_hi
        return lex and rect


def _col_file(name: str) -> str:
    if name in (_TS, _SERIES, _VERSIONS):
        return f"{name}.bin"
    return f"{name}.bin"


class PartWriter:
    """Builds one immutable part from sorted columnar data."""

    @staticmethod
    def write(
        part_dir: str | Path,
        *,
        ts: np.ndarray,
        series: np.ndarray,
        version: np.ndarray,
        tag_codes: Mapping[str, np.ndarray],
        tag_dicts: Mapping[str, list[bytes]],
        fields: Mapping[str, np.ndarray],
        extra_meta: Optional[Mapping] = None,
        payloads: Optional[Sequence[bytes]] = None,
    ) -> None:
        part_dir = Path(part_dir)
        part_dir.mkdir(parents=True, exist_ok=False)
        n = len(ts)
        order = np.lexsort((ts, series))
        ts, series, version = ts[order], series[order], version[order]
        tag_codes = {k: v[order] for k, v in tag_codes.items()}
        fields = {k: v[order] for k, v in fields.items()}
        if payloads is not None:
            payloads = [payloads[i] for i in order]

        blocks = []
        buffers: dict[str, bytearray] = {}

        def append(col: str, blob: bytes) -> tuple[int, int]:
            buf = buffers.setdefault(col, bytearray())
            off = len(buf)
            buf.extend(blob)
            return off, len(blob)

        for start in range(0, max(n, 1), MAX_ROWS):
            end = min(start + MAX_ROWS, n)
            if end <= start:
                break
            sl = slice(start, end)
            extents = {
                _TS: append(_TS, enc.encode_int64(ts[sl])),
                _SERIES: append(_SERIES, enc.encode_int64(series[sl])),
                _VERSIONS: append(_VERSIONS, enc.encode_int64(version[sl])),
            }
            for name, codes in tag_codes.items():
                extents[f"tag_{name}"] = append(
                    f"tag_{name}", enc.encode_dict_codes(codes[sl])
                )
            for name, vals in fields.items():
                extents[f"field_{name}"] = append(
                    f"field_{name}", enc.encode_float64(vals[sl])
                )
            if payloads is not None:
                extents["payload"] = append(
                    "payload", enc.encode_strings(payloads[start:end])
                )
            # Per-block zone maps (provenance-style block skipping, arXiv
            # 2104.12815): local-code min/max per tag and value min/max
            # per field, written at flush AND merge (both go through this
            # writer).  The planner intersects query predicates with
            # these so non-matching blocks are skipped before any extent
            # read (select_blocks zone_preds).  Parts written before this
            # key existed simply never skip (back-compat).
            # `key_lo`/`key_hi` are the EXACT first/last (series, ts)
            # keys of the (sorted) block — the block's contiguous key
            # range, which the dedup-safety overlap check uses: a
            # non-matching block may only be skipped when it cannot
            # share a (series, ts) key with a kept source, else its
            # newer write-versions could be what supersedes a kept,
            # matching row.
            zones: dict[str, list] = {
                "key_lo": [int(series[start]), int(ts[start])],
                "key_hi": [int(series[end - 1]), int(ts[end - 1])],
            }
            for name, codes in tag_codes.items():
                zones[f"tag_{name}"] = [
                    int(codes[sl].min()),
                    int(codes[sl].max()),
                ]
            for name, vals in fields.items():
                blk_vals = vals[sl]
                finite = blk_vals[np.isfinite(blk_vals)]
                if finite.size:
                    zones[f"field_{name}"] = [
                        float(finite.min()),
                        float(finite.max()),
                    ]
            blocks.append(
                {
                    "count": end - start,
                    "min_ts": int(ts[sl].min()),
                    "max_ts": int(ts[sl].max()),
                    "min_series": int(series[sl].min()),
                    "max_series": int(series[sl].max()),
                    "zones": zones,
                    "extents": {k: list(v) for k, v in extents.items()},
                }
            )

        for col, buf in buffers.items():
            fs.atomic_write(part_dir / _col_file(col), bytes(buf))
        for name, d in tag_dicts.items():
            fs.atomic_write(part_dir / f"tag_{name}.dict", enc.encode_strings(d))
        fs.atomic_write(part_dir / "primary.bin", zst.compress(json.dumps(blocks).encode()))
        meta = {
            "total_count": int(n),
            "blocks": len(blocks),
            "min_ts": int(ts.min()) if n else 0,
            "max_ts": int(ts.max()) if n else 0,
            "tags": sorted(tag_codes.keys()),
            "fields": sorted(fields.keys()),
            "has_payload": payloads is not None,
        }
        if extra_meta:
            meta.update(extra_meta)
        fs.atomic_write_json(part_dir / "metadata.json", meta)


class Part:
    """Immutable on-disk part: block pruning + selective column reads."""

    def __init__(self, part_dir: str | Path):
        self.dir = Path(part_dir)
        self.meta = fs.read_json(self.dir / "metadata.json")
        with open(self.dir / "primary.bin", "rb") as f:
            self.blocks = json.loads(zst.decompress(f.read()))
        self._dicts: dict[str, list[bytes]] = {}
        self._dict_idx: dict[str, dict[bytes, int]] = {}

    @property
    def name(self) -> str:
        return self.dir.name

    @property
    def total_count(self) -> int:
        return self.meta["total_count"]

    @property
    def min_ts(self) -> int:
        return self.meta["min_ts"]

    @property
    def max_ts(self) -> int:
        return self.meta["max_ts"]

    def release_cached(self) -> None:
        """Drop lazily-decoded dictionaries (idle-segment reclaim).

        Decoded column blocks live in the byte-budgeted serving cache and
        age out on their own; the per-part dict cache is the only unbounded
        in-object state, so it is what segment reclaim releases."""
        self._dicts.clear()
        self._dict_idx.clear()

    def dict_for(self, tag: str) -> list[bytes]:
        # single dict.get / dict.set ops only (atomic under the GIL):
        # a concurrent release_cached() clear between them just costs a
        # reload, never a KeyError for the in-flight reader
        d = self._dicts.get(tag)
        if d is None:
            path = self.dir / f"tag_{tag}.dict"
            if not path.exists():
                d = []
            else:
                with open(path, "rb") as f:
                    d = enc.decode_strings(f.read())
            self._dicts[tag] = d
        return d

    def has_zone_maps(self) -> bool:
        """True when every block carries the per-column zone maps
        (`zones` block meta); pre-upgrade parts return False and are
        never zone-skipped."""
        return bool(self.blocks) and all("zones" in b for b in self.blocks)

    def block_interval(self, i: int) -> "KeyInterval":
        """The (series, ts) key coverage of block `i` — exact from the
        zone meta's first/last keys when present, else the conservative
        rect bounds (always available)."""
        b = self.blocks[i]
        z = b.get("zones", {})
        lo, hi = z.get("key_lo"), z.get("key_hi")
        if lo is not None and hi is not None:
            return KeyInterval(
                tuple(lo), tuple(hi), b["min_ts"], b["max_ts"]
            )
        return KeyInterval(
            (b["min_series"], b["min_ts"]),
            (b["max_series"], b["max_ts"]),
            b["min_ts"],
            b["max_ts"],
        )

    def dict_index(self, tag: str) -> Mapping[bytes, int]:
        """value -> local code reverse map, cached (the zone planner
        resolves a handful of predicate values per query; rebuilding the
        reverse map over a large dictionary each time is planner-path
        waste).  Same atomicity discipline as dict_for; released by
        release_cached."""
        idx = self._dict_idx.get(tag)
        if idx is None:
            idx = {v: i for i, v in enumerate(self.dict_for(tag))}
            self._dict_idx[tag] = idx
        return idx

    def zone_marked(
        self,
        block_ids: Sequence[int],
        zone_preds: Sequence[tuple[str, np.ndarray]],
    ) -> set[int]:
        """Blocks of `block_ids` whose zone maps prove NO row matches
        the conjunctive predicates (an empty allowed set = dictionary
        miss = every block).  Pure necessity check — dedup safety
        (select_blocks) decides which marked blocks actually skip."""
        out: set[int] = set()
        for i in block_ids:
            zones = self.blocks[i].get("zones")
            if not zones:
                continue
            for col, allowed in zone_preds:
                if not len(allowed):
                    out.add(i)
                    break
                z = zones.get(col)
                if z is None:
                    continue
                lo, hi = z
                j = int(np.searchsorted(allowed, lo))
                if j >= len(allowed) or allowed[j] > hi:
                    out.add(i)
                    break
        return out

    def select_blocks(
        self,
        begin_ms: int,
        end_ms: int,
        series_ids: Optional[np.ndarray] = None,
        zone_preds: Optional[Sequence[tuple[str, np.ndarray]]] = None,
        extra_intervals: Sequence["KeyInterval"] = (),
    ) -> list[int]:
        """Block ids overlapping the half-open [begin, end) time range.

        `series_ids` (sorted int64 candidates from the series index) prunes
        further: rows are part-sorted by series, so a block whose
        [min_series, max_series] contains no candidate cannot match.

        `zone_preds` ([(zone column key, sorted allowed int64 values)])
        prunes on the per-block zone maps: a block whose `zones[col]`
        [lo, hi] contains none of the allowed values cannot match a
        conjunctive eq/in predicate on that column (an EMPTY allowed set
        means "no value of this part can match" — dictionary miss — and
        marks every block).  Blocks without zone meta — pre-upgrade
        parts — are never marked.

        Marking is necessary but NOT sufficient to skip: version dedup
        is global over the gathered sources, so a non-matching block may
        hold the newest version of a (series, ts) row whose older,
        matching copy lives in a kept block — skipping it would
        resurrect the stale row.  A marked block is therefore dropped
        only when its key coverage (`block_interval`) cannot intersect
        any KEPT block of this part nor any of the caller's
        `extra_intervals` (other parts' kept blocks, the memtable).
        Marked blocks may freely overlap EACH OTHER: whichever version
        wins dedup among non-matching rows still fails the predicate.
        Actual skips increment ``blocks_skipped_total{reason=zone}``.
        """
        cands = []
        for i, b in enumerate(self.blocks):
            if not (b["min_ts"] < end_ms and begin_ms <= b["max_ts"]):
                continue
            if series_ids is not None:
                j = int(np.searchsorted(series_ids, b["min_series"]))
                if j >= len(series_ids) or series_ids[j] > b["max_series"]:
                    continue
            cands.append(i)
        if not zone_preds:
            return cands

        prunable = self.zone_marked(cands, zone_preds)
        kept_intervals = [
            self.block_interval(i) for i in cands if i not in prunable
        ]
        kept_intervals.extend(extra_intervals)
        return self.finalize_zone_skip(cands, prunable, kept_intervals)

    def finalize_zone_skip(
        self,
        cands: Sequence[int],
        marked: set[int],
        kept_intervals: Sequence["KeyInterval"],
    ) -> list[int]:
        """The dedup-safety drop (see select_blocks): marked blocks skip
        only when overlap-free against every kept interval.  Split out
        so the shard planner (models/measure) can reuse its pre-pass's
        candidate/marked sets instead of recomputing selection per
        part.  Increments ``blocks_skipped_total{reason=zone}``."""
        out = []
        zone_skipped = 0
        for i in cands:
            if i in marked:
                iv = self.block_interval(i)
                if not any(iv.intersects(k) for k in kept_intervals):
                    zone_skipped += 1
                    continue
            out.append(i)
        if zone_skipped:
            from banyandb_tpu_torch.obs.metrics import global_meter

            global_meter().counter_add(
                "blocks_skipped",
                float(zone_skipped),
                labels={"reason": "zone"},
            )
        return out

    def read(
        self,
        block_ids: Sequence[int],
        *,
        tags: Iterable[str] = (),
        fields: Iterable[str] = (),
        want_payload: bool = False,
        cached: bool = True,
        narrow_codes: bool = False,
    ) -> ColumnData:
        """Decode the selected blocks' columns into host arrays.

        Served through the process serving cache
        (banyand/internal/storage/cache.go:125 analog): parts are
        immutable, so (part_dir, blocks, columns) fully identifies the
        decoded result.  Callers must not mutate returned arrays.
        One-shot bulk readers (merge, migration, sync) pass cached=False
        so their full-part sweeps don't evict the query working set.

        ``narrow_codes=True`` (the device-decode gather path,
        storage/encoded.py) keeps tag code columns at their STORED
        narrow width (i8/i16/i32) instead of widening to i32 — the
        widen + dictionary remap then run on device as the first stage
        of the plan kernel (ops.decode).  Code VALUES are identical
        either way; only the dtype differs.
        """
        from banyandb_tpu_torch.storage.cache import global_cache

        key = (
            "part_read",
            str(self.dir),
            tuple(block_ids),
            tuple(tags),
            tuple(fields),
            bool(want_payload),
            bool(narrow_codes),
        )
        if not cached:
            return self._read_uncached(
                key, block_ids, tags=tags, fields=fields,
                want_payload=want_payload, narrow_codes=narrow_codes,
            )
        return global_cache().get_or_load(
            key,
            lambda: self._read_uncached(
                key, block_ids, tags=tags, fields=fields,
                want_payload=want_payload, narrow_codes=narrow_codes,
            ),
        )

    def _read_uncached(
        self,
        key: tuple,
        block_ids: Sequence[int],
        *,
        tags: Iterable[str] = (),
        fields: Iterable[str] = (),
        want_payload: bool = False,
        narrow_codes: bool = False,
    ) -> ColumnData:
        tags, fields = list(tags), list(fields)
        payloads: Optional[list[bytes]] = (
            [] if (want_payload and self.meta.get("has_payload")) else None
        )
        cols: dict[str, list[np.ndarray]] = {}
        handles: dict[str, object] = {}

        def read_extent(col: str, block: dict) -> bytes:
            off, size = block["extents"][col]
            f = handles.get(col)
            if f is None:
                # bdlint: disable=resource-hygiene -- per-column handle
                # cache for the block loop; closed in the finally below
                f = handles[col] = open(self.dir / _col_file(col), "rb")
            f.seek(off)
            return f.read(size)

        try:
            for bid in block_ids:
                blk = self.blocks[bid]
                cnt = blk["count"]
                cols.setdefault(_TS, []).append(
                    enc.decode_int64(read_extent(_TS, blk), cnt)
                )
                cols.setdefault(_SERIES, []).append(
                    enc.decode_int64(read_extent(_SERIES, blk), cnt)
                )
                cols.setdefault(_VERSIONS, []).append(
                    enc.decode_int64(read_extent(_VERSIONS, blk), cnt)
                )
                decode_codes = (
                    enc.decode_dict_codes_narrow
                    if narrow_codes
                    else enc.decode_dict_codes
                )
                for t in tags:
                    cols.setdefault(f"tag_{t}", []).append(
                        decode_codes(read_extent(f"tag_{t}", blk), cnt)
                    )
                for fl in fields:
                    cols.setdefault(f"field_{fl}", []).append(
                        enc.decode_float64(read_extent(f"field_{fl}", blk), cnt)
                    )
                if payloads is not None:
                    payloads.extend(
                        enc.decode_strings(read_extent("payload", blk))
                    )
        finally:
            for f in handles.values():
                f.close()

        def cat(key: str, dtype) -> np.ndarray:
            parts = cols.get(key, [])
            if not parts:
                return np.zeros(0, dtype=dtype)
            return np.concatenate(parts).astype(dtype, copy=False)

        def cat_codes(t: str) -> np.ndarray:
            if not narrow_codes:
                return cat(f"tag_{t}", np.int32)
            # keep the widest stored width across the selected blocks
            # (per-block downcast can differ within one part)
            parts = cols.get(f"tag_{t}", [])
            if not parts:
                return np.zeros(0, dtype=np.int8)
            return np.concatenate(parts)

        return ColumnData(
            ts=cat(_TS, np.int64),
            series=cat(_SERIES, np.int64),
            version=cat(_VERSIONS, np.int64),
            tags={t: cat_codes(t) for t in tags},
            fields={fl: cat(f"field_{fl}", np.float64) for fl in fields},
            dicts={t: self.dict_for(t) for t in tags},
            payloads=payloads,
            cache_key=key,
        )
