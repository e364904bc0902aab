"""Per-part element index + skipping blooms for streams.

Analog of the reference's stream element index and .tff bloom files
(the reference's banyand/stream/index.go + banyand/internal/storage's
tagFamilyFilter): index rules (database/v1 IndexRule) of type

- ``inverted``: a per-part value -> block-ids posting sidecar
  (``eidx_<tag>.bin``) so equality/IN predicates read only blocks that
  contain a matching element;
- ``skipping``: a per-block Bloom filter sidecar (``tff_<tag>.bin``)
  testing membership per block — smaller than postings, probabilistic.

Sidecars are built right after a part is written (flush AND merge) and
read lazily at query time; a part without sidecars (older part, failed
build) simply scans all time-selected blocks — pruning is strictly an
optimization, never a correctness dependency.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

from banyandb_tpu_torch.storage.part import Part
from banyandb_tpu_torch.utils import compress as zst
from banyandb_tpu_torch.utils import fs
from banyandb_tpu_torch.utils.bloom import Bloom


def build_part_index(
    part_dir: str | Path,
    inverted_tags: Iterable[str] = (),
    skipping_tags: Iterable[str] = (),
) -> list[str]:
    """Build sidecars for one immutable part; -> sidecar filenames."""
    part_dir = Path(part_dir)
    part = Part(part_dir)
    tags_present = set(part.meta.get("tags", ()))
    inv = [t for t in inverted_tags if t in tags_present]
    skp = [t for t in skipping_tags if t in tags_present]
    need = sorted(set(inv) | set(skp))
    if not need:
        return []
    # one decode pass per block covering ALL indexed tags (not per-tag)
    postings: dict[str, dict[int, set[int]]] = {t: {} for t in inv}
    blooms: dict[str, list[bytes]] = {t: [] for t in skp}
    dicts = {t: part.dict_for(t) for t in skp}
    for bid in range(len(part.blocks)):
        cols = part.read([bid], tags=need, cached=False)
        for t in inv:
            for code in np.unique(cols.tags[t]).tolist():
                postings[t].setdefault(code, set()).add(bid)
        for t in skp:
            codes = np.unique(cols.tags[t])
            bl = Bloom(max(len(codes), 1))
            d = dicts[t]
            for code in codes.tolist():
                if 0 <= code < len(d):
                    bl.add(d[code])
            blooms[t].append(bl.to_bytes())

    built: list[str] = []
    for t in inv:
        payload = {str(code): sorted(bids) for code, bids in postings[t].items()}
        fname = f"eidx_{t}.bin"
        fs.atomic_write(
            part_dir / fname, zst.compress(json.dumps(payload).encode())
        )
        built.append(fname)
    for t in skp:
        fname = f"tff_{t}.bin"
        blob = bytearray()
        blob.extend(struct.pack("<I", len(blooms[t])))
        for b in blooms[t]:
            blob.extend(struct.pack("<I", len(b)))
            blob.extend(b)
        fs.atomic_write(part_dir / fname, bytes(blob))
        built.append(fname)
    return built


def _sidecar_cache(part: Part) -> dict:
    """Decoded sidecars cached on the (immutable, long-lived) Part —
    postings/blooms/LUTs decode once per part, not once per query.
    A missing sidecar is NOT cached: flush builds sidecars after publish,
    so an early query must not pin 'absent' forever."""
    return part.__dict__.setdefault("_element_sidecars", {})


def _load_postings(part: Part, tag: str) -> Optional[dict[int, list[int]]]:
    cache = _sidecar_cache(part)
    key = ("eidx", tag)
    if key in cache:
        return cache[key]
    path = part.dir / f"eidx_{tag}.bin"
    if not path.exists():
        return None
    try:
        raw = json.loads(zst.decompress(path.read_bytes()))
        out = {int(k): v for k, v in raw.items()}
    except (OSError, ValueError):
        return None
    cache[key] = out
    return out


def _value_lut(part: Part, tag: str) -> dict[bytes, int]:
    cache = _sidecar_cache(part)
    key = ("lut", tag)
    lut = cache.get(key)
    if lut is None:
        lut = cache[key] = {v: i for i, v in enumerate(part.dict_for(tag))}
    return lut


def _load_blooms(part: Part, tag: str) -> Optional[list[Bloom]]:
    cache = _sidecar_cache(part)
    key = ("tff", tag)
    if key in cache:
        return cache[key]
    path = part.dir / f"tff_{tag}.bin"
    if not path.exists():
        return None
    try:
        blob = path.read_bytes()
        (n,) = struct.unpack_from("<I", blob, 0)
        off = 4
        out = []
        for _ in range(n):
            (size,) = struct.unpack_from("<I", blob, off)
            off += 4
            out.append(Bloom.from_bytes(blob[off : off + size]))
            off += size
    except (OSError, ValueError, struct.error):
        return None
    cache[key] = out
    return out


def prune_blocks(
    part: Part,
    conds,
    inverted_tags: set[str],
    skipping_tags: set[str],
) -> Optional[set[int]]:
    """-> allowed block ids, or None when no sidecar constrains the query.

    Only eq/in conditions prune (ne/not_in can't exclude a block).  The
    intersection over all prunable conditions is returned; an empty set
    means no block can match.
    """
    from banyandb_tpu_torch.query.filter import tag_value_bytes

    allowed: Optional[set[int]] = None
    for c in conds:
        if c.op not in ("eq", "in"):
            continue
        values = [c.value] if c.op == "eq" else list(c.value)
        want = {tag_value_bytes(v) for v in values}
        cand: Optional[set[int]] = None
        if c.name in inverted_tags:
            postings = _load_postings(part, c.name)
            if postings is not None:
                lut = _value_lut(part, c.name)
                cand = set()
                for v in want:
                    code = lut.get(v)
                    if code is not None:
                        cand.update(postings.get(code, ()))
        if cand is None and c.name in skipping_tags:
            blooms = _load_blooms(part, c.name)
            if blooms is not None:
                cand = {
                    bid
                    for bid, bl in enumerate(blooms)
                    if any(v in bl for v in want)
                }
        if cand is not None:
            allowed = cand if allowed is None else (allowed & cand)
    return allowed
