"""On-disk inspection tools (banyand/cmd/dump + bydbctl analyze analog).

Read-only walkers over a server root: groups -> segments -> shards ->
parts with block stats, plus column-level detail for one part.
"""

from __future__ import annotations

from pathlib import Path

from banyandb_tpu_torch.storage.part import Part


def inspect_root(root: str | Path) -> dict:
    """Summarize every engine tree under <root>/data."""
    root = Path(root)
    out: dict = {"engines": {}}
    for engine_dir in sorted((root / "data").glob("*")):
        if not engine_dir.is_dir():
            continue
        groups = {}
        for group_dir in sorted(engine_dir.glob("*")):
            if not group_dir.is_dir():
                continue
            segments = {}
            for seg_dir in sorted(group_dir.glob("seg-*")):
                shards = {}
                for shard_dir in sorted(seg_dir.glob("shard-*")):
                    parts = []
                    for part_dir in sorted(shard_dir.glob("part-*")):
                        try:
                            p = Part(part_dir)
                        except Exception:
                            parts.append({"name": part_dir.name, "error": "unreadable"})
                            continue
                        parts.append(
                            {
                                "name": p.name,
                                "rows": p.total_count,
                                "blocks": len(p.blocks),
                                "min_ts": p.min_ts,
                                "max_ts": p.max_ts,
                                "resource": p.meta.get("measure")
                                or p.meta.get("stream")
                                or p.meta.get("trace"),
                                "bytes": sum(
                                    f.stat().st_size for f in part_dir.iterdir()
                                ),
                            }
                        )
                    shards[shard_dir.name] = {
                        "parts": parts,
                        "rows": sum(x.get("rows", 0) for x in parts),
                    }
                segments[seg_dir.name] = shards
            groups[group_dir.name] = segments
        out["engines"][engine_dir.name] = groups
    return out


def inspect_property_index(idx_dir: str | Path) -> dict:
    """Segment-level stats for one property shard index
    (``<root>/data/property/<group>/shard-N.idx`` — cmd/dump property
    analog).  Read-only: manifest + per-segment headers and tombstone
    counts, never a doc materialization."""
    from banyandb_tpu_torch.index.segment import Segment
    from banyandb_tpu_torch.utils import fs

    idx_dir = Path(idx_dir)
    man_path = idx_dir / "manifest.json"
    if not man_path.exists():
        raise ValueError(
            f"dump: {idx_dir} has no manifest.json — not a property "
            "shard index (expected <root>/data/property/<group>/"
            "shard-N.idx)"
        )
    man = fs.read_json(man_path)
    segments = []
    for ent in man.get("segments", []):
        name, gen = ent["name"], ent.get("tomb_gen", 0)
        tomb = idx_dir / f"{name}.tomb-{gen}" if gen else None
        seg = Segment(idx_dir / f"{name}.seg", tomb_path=tomb)
        try:
            segments.append(
                {
                    "name": name,
                    "docs": seg.n,
                    "alive": seg.alive_count,
                    "tomb_gen": gen,
                    "keyword_fields": list(seg.kw_fields),
                    "numeric_fields": list(seg.num_fields),
                    "bytes": (idx_dir / f"{name}.seg").stat().st_size,
                }
            )
        finally:
            seg.close()
    return {
        "manifest": man,
        "segments": segments,
        "docs": sum(s["docs"] for s in segments),
        "alive": sum(s["alive"] for s in segments),
    }


def inspect_part(part_dir: str | Path) -> dict:
    """Column-level stats for one part (cmd/dump measure analog).

    ``zone_maps`` reports whether every block carries the per-column
    zone maps the planner skips on (parts written before the zone-map
    format upgrade load and scan fine, they just never skip — this is
    how an operator tells the two apart)."""
    p = Part(part_dir)
    part_dir = Path(part_dir)
    cols = {}
    for f in sorted(part_dir.iterdir()):
        cols[f.name] = f.stat().st_size
    return {
        "meta": p.meta,
        "files": cols,
        "zone_maps": p.has_zone_maps(),
        "blocks": [
            {
                "count": b["count"],
                "ts": [b["min_ts"], b["max_ts"]],
                "series": [b["min_series"], b["max_series"]],
                **(
                    {"zones": sorted(b["zones"])}
                    if "zones" in b
                    else {}
                ),
            }
            for b in p.blocks
        ],
    }
