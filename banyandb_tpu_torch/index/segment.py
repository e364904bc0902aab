"""Immutable on-disk index segments (the Bluge/ICE-segment analog).

One segment = one file of raw little-endian array sections behind a JSON
TOC, opened with O(1) header reads and accessed via np.memmap — nothing
is parsed or materialised at open time, so a restart over S segments
costs O(S) header reads, not O(docs) (VERDICT r3 #3; reference:
pkg/index/inverted/inverted.go — FST dictionary + roaring postings in
immutable ICE segments).

Layout per keyword field (CSR postings):
    kw:<f>:terms_bytes / kw:<f>:terms_offs   sorted unique terms
    kw:<f>:toff                              CSR offsets into postings
    kw:<f>:post                              doc ids per term (sorted)
    kw:<f>:docterm                           per-doc term index (-1 absent)
per numeric field:
    num:<f>:docvals / num:<f>:present        per-doc value + presence
    num:<f>:svals / num:<f>:sids             (value, doc_id) sorted by value
plus "docids" (sorted int64) and "payload_offs"/"payload_bytes".

Term lookup is a binary search over the memmapped term dictionary
(O(log T) slice reads); postings come back as a memmap slice.  Deleted /
overwritten docs live in a *mutable sidecar* bitmap (`<seg>.tomb-<gen>`),
versioned per commit and referenced from the store manifest so segment
files themselves stay immutable (delete bitmaps, Lucene-style).
"""

from __future__ import annotations

import io
import json
from pathlib import Path
from typing import Mapping, Optional, Sequence

import numpy as np

_MAGIC = b"BTSEG1\n"
_ALIGN = 8


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def build_segment(
    ids: np.ndarray,
    kw: Mapping[str, tuple[Sequence[bytes], np.ndarray]],
    num: Mapping[str, tuple[np.ndarray, np.ndarray]],
    payloads: Sequence[bytes],
) -> bytes:
    """Serialize one immutable segment.

    ids: sorted unique int64 doc ids (n).
    kw: field -> (per-doc value bytes list, present uint8[n]).
    num: field -> (per-doc int64 values, present uint8[n]).
    payloads: per-doc payload bytes.
    """
    n = len(ids)
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    if n > 1 and not (ids[1:] > ids[:-1]).all():
        raise ValueError("segment doc ids must be sorted unique")

    sections: dict[str, np.ndarray] = {"docids": ids}

    for f in sorted(kw):
        values, present = kw[f]
        present = np.ascontiguousarray(present, dtype=np.uint8)
        pres_idx = np.nonzero(present)[0]
        vals_present = [values[i] for i in pres_idx.tolist()]
        if vals_present:
            uniq_terms, inv = np.unique(
                np.asarray(vals_present, dtype=object), return_inverse=True
            )
            terms = [bytes(t) for t in uniq_terms.tolist()]
        else:
            terms, inv = [], np.zeros(0, dtype=np.int64)
        docterm = np.full(n, -1, dtype=np.int32)
        docterm[pres_idx] = inv.astype(np.int32)
        # CSR postings: doc ids per term, sorted within each term (the
        # docs are already id-sorted, so a stable sort by term keeps it)
        order = np.argsort(inv, kind="stable")
        post = ids[pres_idx][order]
        toff = np.zeros(len(terms) + 1, dtype=np.int64)
        if len(terms):
            counts = np.bincount(inv, minlength=len(terms))
            np.cumsum(counts, out=toff[1:])
        terms_bytes, terms_offs = _pack_bytes(terms)
        sections[f"kw:{f}:terms_bytes"] = terms_bytes
        sections[f"kw:{f}:terms_offs"] = terms_offs
        sections[f"kw:{f}:toff"] = toff
        sections[f"kw:{f}:post"] = post
        sections[f"kw:{f}:docterm"] = docterm

    for f in sorted(num):
        vals, present = num[f]
        vals = np.ascontiguousarray(vals, dtype=np.int64)
        present = np.ascontiguousarray(present, dtype=np.uint8)
        pres_idx = np.nonzero(present)[0]
        pvals = vals[pres_idx]
        order = np.argsort(pvals, kind="stable")
        sections[f"num:{f}:docvals"] = vals
        sections[f"num:{f}:present"] = present
        sections[f"num:{f}:svals"] = pvals[order]
        sections[f"num:{f}:sids"] = ids[pres_idx][order]

    pay_bytes, pay_offs = _pack_bytes(list(payloads))
    sections["payload_bytes"] = pay_bytes
    sections["payload_offs"] = pay_offs

    # ---- TOC + body ----
    toc: dict[str, list] = {}
    body = io.BytesIO()
    for name, arr in sections.items():
        off = body.tell()
        pad = (-off) % _ALIGN
        body.write(b"\x00" * pad)
        off += pad
        raw = arr.tobytes()
        body.write(raw)
        toc[name] = [off, str(arr.dtype), list(arr.shape)]
    header = json.dumps(
        {
            "n": n,
            "kw": sorted(kw),
            "num": sorted(num),
            "sections": toc,
        }
    ).encode()
    out = io.BytesIO()
    out.write(_MAGIC)
    out.write(len(header).to_bytes(4, "little"))
    out.write(header)
    base = out.tell()
    pad = (-base) % _ALIGN
    out.write(b"\x00" * pad)
    out.write(body.getvalue())
    return out.getvalue()


def _pack_bytes(values: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    offs = np.zeros(len(values) + 1, dtype=np.int64)
    np.cumsum([len(v) for v in values], out=offs[1:])
    blob = b"".join(values)
    return np.frombuffer(blob, dtype=np.uint8).copy(), offs


# ---------------------------------------------------------------------------
# open / read
# ---------------------------------------------------------------------------


class Segment:
    """Read-only view over one segment file + its mutable tombstone bitmap.

    All array access is lazy memmap; term dictionaries are searched with
    O(log T) slice reads, never fully decoded.
    """

    def __init__(self, path: Path, tomb_path: Optional[Path] = None):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"bad segment magic {magic!r}: {path}")
            hlen = int.from_bytes(f.read(4), "little")
            hdr = json.loads(f.read(hlen))
            base = f.tell()
        base += (-base) % _ALIGN
        self._base = base
        self.n = int(hdr["n"])
        self.kw_fields: list[str] = hdr["kw"]
        self.num_fields: list[str] = hdr["num"]
        self._toc = hdr["sections"]
        self._maps: dict[str, np.ndarray] = {}
        # tombstones: memmapped read-only until first mutation
        self._tomb_dirty = False
        if tomb_path is not None and tomb_path.exists():
            self._tomb = np.memmap(tomb_path, dtype=np.uint8, mode="r")
            self._alive = self.n - int(self._tomb.sum())
        else:
            self._tomb = None  # all alive
            self._alive = self.n

    # -- sections ----------------------------------------------------------
    def _sec(self, name: str) -> np.ndarray:
        arr = self._maps.get(name)
        if arr is None:
            off, dtype, shape = self._toc[name]
            count = int(np.prod(shape)) if shape else 0
            if count == 0:
                arr = np.zeros(shape, dtype=dtype)
            else:
                arr = np.memmap(
                    self.path,
                    dtype=dtype,
                    mode="r",
                    offset=self._base + off,
                    shape=tuple(shape),
                )
            self._maps[name] = arr
        return arr

    @property
    def docids(self) -> np.ndarray:
        return self._sec("docids")

    # -- tombstones --------------------------------------------------------
    @property
    def alive_count(self) -> int:
        return self._alive

    def _tomb_writable(self) -> np.ndarray:
        if self._tomb is None:
            self._tomb = np.zeros(self.n, dtype=np.uint8)
        elif isinstance(self._tomb, np.memmap):
            self._tomb = np.asarray(self._tomb).copy()
        return self._tomb

    def tombstone_ids(self, ids: np.ndarray) -> int:
        """Mark any of `ids` present+alive in this segment as deleted.
        Returns the number of newly-dead docs."""
        if self.n == 0 or len(ids) == 0:
            return 0
        # dedupe: a doc_id repeated in one batch must decrement _alive once
        ids = np.unique(np.asarray(ids, dtype=np.int64))
        docids = self.docids
        slots = np.searchsorted(docids, ids)
        ok = (slots < self.n) & (docids[np.minimum(slots, self.n - 1)] == ids)
        slots = slots[ok]
        if slots.size == 0:
            return 0
        tomb = self._tomb if self._tomb is not None else None
        if tomb is not None:
            slots = slots[tomb[slots] == 0]
            if slots.size == 0:
                return 0
        t = self._tomb_writable()
        t[slots] = 1
        self._tomb_dirty = True
        self._alive -= int(slots.size)
        return int(slots.size)

    def _alive_mask_for(self, post_ids: np.ndarray) -> np.ndarray:
        """Boolean mask of alive docs for an array of doc ids known to be
        members of this segment."""
        if self._tomb is None:
            return np.ones(len(post_ids), dtype=bool)
        slots = np.searchsorted(self.docids, post_ids)
        return np.asarray(self._tomb)[slots] == 0

    def alive_ids(self) -> np.ndarray:
        if self._tomb is None:
            return np.asarray(self.docids)
        return np.asarray(self.docids)[np.asarray(self._tomb) == 0]

    # -- term dictionary ---------------------------------------------------
    def _term_at(self, f: str, i: int) -> bytes:
        offs = self._sec(f"kw:{f}:terms_offs")
        tb = self._sec(f"kw:{f}:terms_bytes")
        return tb[int(offs[i]) : int(offs[i + 1])].tobytes()

    def term_index(self, f: str, value: bytes) -> int:
        """Binary search the memmapped term dict; -1 when absent."""
        if f not in self.kw_fields:
            return -1
        offs = self._sec(f"kw:{f}:terms_offs")
        lo, hi = 0, len(offs) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if self._term_at(f, mid) < value:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(offs) - 1 and self._term_at(f, lo) == value:
            return lo
        return -1

    def term_count(self, f: str) -> int:
        return len(self._sec(f"kw:{f}:terms_offs")) - 1 if f in self.kw_fields else 0

    # -- query eval --------------------------------------------------------
    def eval_term(self, f: str, value: bytes) -> np.ndarray:
        i = self.term_index(f, value)
        if i < 0:
            return np.zeros(0, dtype=np.int64)
        toff = self._sec(f"kw:{f}:toff")
        post = np.asarray(self._sec(f"kw:{f}:post")[int(toff[i]) : int(toff[i + 1])])
        return post[self._alive_mask_for(post)]

    def eval_range(self, f: str, lo, hi) -> np.ndarray:
        """Sorted doc ids with lo <= value <= hi (inclusive, None = open)."""
        if f not in self.num_fields:
            return np.zeros(0, dtype=np.int64)
        svals = self._sec(f"num:{f}:svals")
        a = int(np.searchsorted(svals, lo, "left")) if lo is not None else 0
        b = int(np.searchsorted(svals, hi, "right")) if hi is not None else len(svals)
        ids = np.asarray(self._sec(f"num:{f}:sids")[a:b])
        ids = ids[self._alive_mask_for(ids)]
        return np.sort(ids)

    def range_pairs(self, f: str, lo, hi) -> tuple[np.ndarray, np.ndarray]:
        """(values, doc_ids) in [lo, hi], ordered by value (sidx analog)."""
        if f not in self.num_fields:
            z = np.zeros(0, dtype=np.int64)
            return z, z
        svals = self._sec(f"num:{f}:svals")
        a = int(np.searchsorted(svals, lo, "left")) if lo is not None else 0
        b = int(np.searchsorted(svals, hi, "right")) if hi is not None else len(svals)
        vals = np.asarray(svals[a:b])
        ids = np.asarray(self._sec(f"num:{f}:sids")[a:b])
        keep = self._alive_mask_for(ids)
        return vals[keep], ids[keep]

    # -- doc materialisation ----------------------------------------------
    def slot_of(self, doc_id: int) -> int:
        """Slot index of doc_id if present AND alive, else -1."""
        docids = self.docids
        s = int(np.searchsorted(docids, doc_id))
        if s >= self.n or int(docids[s]) != doc_id:
            return -1
        if self._tomb is not None and self._tomb[s]:
            return -1
        return s

    def numeric_at(self, slot: int, f: str) -> Optional[int]:
        """One numeric field at one slot — two memmap reads, no decode."""
        if f not in self.num_fields:
            return None
        if not self._sec(f"num:{f}:present")[slot]:
            return None
        return int(self._sec(f"num:{f}:docvals")[slot])

    def doc_fields(self, slot: int) -> tuple[dict, dict, bytes]:
        """(keywords, numerics, payload) for one slot."""
        kws: dict[str, bytes] = {}
        for f in self.kw_fields:
            ti = int(self._sec(f"kw:{f}:docterm")[slot])
            if ti >= 0:
                kws[f] = self._term_at(f, ti)
        nums: dict[str, int] = {}
        for f in self.num_fields:
            if self._sec(f"num:{f}:present")[slot]:
                nums[f] = int(self._sec(f"num:{f}:docvals")[slot])
        offs = self._sec("payload_offs")
        payload = (
            self._sec("payload_bytes")[int(offs[slot]) : int(offs[slot + 1])]
            .tobytes()
        )
        return kws, nums, payload

    # -- columnar dump (for merge) ----------------------------------------
    def alive_columns(self):
        """(ids, kw {f: (values list, present)}, num {f: (vals, present)},
        payloads) restricted to alive docs — build_segment's input shape."""
        alive = (
            np.ones(self.n, dtype=bool)
            if self._tomb is None
            else np.asarray(self._tomb) == 0
        )
        idx = np.nonzero(alive)[0]
        ids = np.asarray(self.docids)[idx]
        kw = {}
        for f in self.kw_fields:
            docterm = np.asarray(self._sec(f"kw:{f}:docterm"))[idx]
            present = (docterm >= 0).astype(np.uint8)
            # decode this segment's term dict once (O(T), merge-time only)
            offs = self._sec(f"kw:{f}:terms_offs")
            tb = self._sec(f"kw:{f}:terms_bytes")
            terms = [
                tb[int(offs[i]) : int(offs[i + 1])].tobytes()
                for i in range(len(offs) - 1)
            ]
            values = [terms[t] if t >= 0 else b"" for t in docterm.tolist()]
            kw[f] = (values, present)
        num = {
            f: (
                np.asarray(self._sec(f"num:{f}:docvals"))[idx],
                np.asarray(self._sec(f"num:{f}:present"))[idx],
            )
            for f in self.num_fields
        }
        offs = self._sec("payload_offs")
        pb = self._sec("payload_bytes")
        payloads = [
            pb[int(offs[i]) : int(offs[i + 1])].tobytes() for i in idx.tolist()
        ]
        return ids, kw, num, payloads

    def close(self) -> None:
        self._maps.clear()
