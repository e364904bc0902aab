"""Offline format migration tool (banyand/cmd/migration analyze/plan/
copy/verify + banyand/internal/migration analog).

Four phases over a server root:
  analyze -> inventory of parts + format versions + sizes
  plan    -> which parts a target format version requires rewriting
  copy    -> rewrite planned parts into a NEW root (source untouched)
  verify  -> row-count + column-checksum comparison source vs target

The current on-disk format is version 1; the tool is the harness future
format bumps plug into (rewrite = decode with the old reader, re-encode
with the current writer).
"""

from __future__ import annotations

import hashlib
import shutil
from pathlib import Path

from banyandb_tpu_torch.storage.part import Part, PartWriter

FORMAT_VERSION = 1


def _iter_parts(root: Path):
    for part_dir in sorted((root / "data").glob("*/*/seg-*/shard-*/part-*")):
        yield part_dir


def analyze(root: str | Path) -> dict:
    root = Path(root)
    parts = []
    for pd in _iter_parts(root):
        try:
            p = Part(pd)
            parts.append(
                {
                    "dir": str(pd.relative_to(root)),
                    "rows": p.total_count,
                    "version": p.meta.get("format_version", 1),
                    "bytes": sum(f.stat().st_size for f in pd.iterdir()),
                }
            )
        except Exception as e:  # noqa: BLE001 - analysis must not abort
            parts.append({"dir": str(pd.relative_to(root)), "error": str(e)})
    return {"format_version": FORMAT_VERSION, "parts": parts}


def plan(root: str | Path, target_version: int = FORMAT_VERSION) -> dict:
    info = analyze(root)
    rewrite = [
        p["dir"]
        for p in info["parts"]
        if "error" not in p and p["version"] != target_version
    ]
    return {
        "target_version": target_version,
        "rewrite": rewrite,
        "unreadable": [p["dir"] for p in info["parts"] if "error" in p],
        "unchanged": [
            p["dir"]
            for p in info["parts"]
            if "error" not in p and p["version"] == target_version
        ],
    }


def copy(root: str | Path, dest: str | Path, migration_plan: dict) -> dict:
    """Materialize `dest`: planned parts re-encoded, the rest (and all
    non-part files: schema, snapshots, indexes) copied verbatim."""
    root, dest = Path(root), Path(dest)
    if dest.exists() and any(dest.iterdir()):
        raise FileExistsError(f"copy target {dest} not empty")
    rewrite = set(migration_plan["rewrite"])
    copied = rewritten = 0
    for src in sorted(root.rglob("*")):
        rel = src.relative_to(root)
        out = dest / rel
        if src.is_dir():
            continue
        part_rel = _enclosing_part(rel)
        if part_rel is not None and part_rel in rewrite:
            continue  # handled below, whole-part
        out.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(src, out)
        copied += 1
    for part_rel in sorted(rewrite):
        p = Part(root / part_rel)
        cols = p.read(
            range(len(p.blocks)),
            tags=p.meta["tags"],
            fields=p.meta["fields"],
            want_payload=bool(p.meta.get("has_payload")),
            cached=False,  # one-shot migration sweep
        )
        extra = {
            k: p.meta[k]
            for k in ("measure", "stream", "trace")
            if k in p.meta
        }
        PartWriter.write(
            dest / part_rel,
            ts=cols.ts,
            series=cols.series,
            version=cols.version,
            tag_codes=dict(cols.tags),
            tag_dicts=dict(cols.dicts),
            fields=dict(cols.fields),
            extra_meta=extra,
            payloads=cols.payloads,
        )
        rewritten += 1
    return {"copied_files": copied, "rewritten_parts": rewritten}


def _enclosing_part(rel: Path):
    for i, part in enumerate(rel.parts):
        if part.startswith("part-"):
            return str(Path(*rel.parts[: i + 1]))
    return None


def _part_fingerprint(pd: Path) -> tuple[int, dict[str, str]]:
    """(rows, per-column content hash of DECODED data) — encoding may
    legally differ between versions; the decoded values must not."""
    p = Part(pd)
    cols = p.read(
        range(len(p.blocks)),
        tags=p.meta["tags"],
        fields=p.meta["fields"],
        want_payload=bool(p.meta.get("has_payload")),
        cached=False,  # one-shot migration sweep
    )
    sums = {
        "ts": hashlib.blake2b(cols.ts.tobytes(), digest_size=8).hexdigest(),
        "series": hashlib.blake2b(cols.series.tobytes(), digest_size=8).hexdigest(),
    }
    for t, codes in sorted(cols.tags.items()):
        vals = b"\x00".join(cols.dicts[t][c] for c in codes.tolist())
        sums[f"tag:{t}"] = hashlib.blake2b(vals, digest_size=8).hexdigest()
    for f, v in sorted(cols.fields.items()):
        sums[f"field:{f}"] = hashlib.blake2b(v.tobytes(), digest_size=8).hexdigest()
    if cols.payloads is not None:
        sums["payload"] = hashlib.blake2b(
            b"\x00".join(cols.payloads), digest_size=8
        ).hexdigest()
    return p.total_count, sums


def verify(root: str | Path, dest: str | Path) -> dict:
    """Decoded-content equality for every part present in both trees."""
    root, dest = Path(root), Path(dest)
    mismatches = []
    checked = 0
    for pd in _iter_parts(root):
        rel = pd.relative_to(root)
        other = dest / rel
        if not other.exists():
            mismatches.append({"part": str(rel), "error": "missing in target"})
            continue
        try:
            a = _part_fingerprint(pd)
            b = _part_fingerprint(other)
        except Exception as e:  # noqa: BLE001
            mismatches.append({"part": str(rel), "error": str(e)})
            continue
        if a != b:
            mismatches.append({"part": str(rel), "error": "content diverged"})
        checked += 1
    return {"checked": checked, "mismatches": mismatches, "ok": not mismatches}
