"""Part merging (the reference's merger loop, banyand/measure/merger.go:39
+ merger_policy.go, rebuilt host-side).

A merge reads the victim parts' full columns, re-sorts by (series, ts),
drops superseded versions (max write-version wins — the same contract the
device dedup applies at query time), re-encodes into one new part, and
swaps the part set under the shard's snapshot lock.  Merged parts make
query-time dedup cheap: within one part, (series, ts) is unique.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from banyandb_tpu_torch.storage.part import ColumnData, Part
from banyandb_tpu_torch.utils import hostops

# Reference merge trigger shape: wait until enough small parts accumulate.
DEFAULT_MIN_MERGE_PARTS = 4
DEFAULT_MAX_PARTS = 8


_RESOURCE_KINDS = ("measure", "stream", "trace")


def resource_key(p: Part) -> tuple[str, str]:
    """(kind, name) identity of a part — parts of different resources (or
    different kinds sharing a name) must never cross-merge."""
    for kind in _RESOURCE_KINDS:
        name = p.meta.get(kind)
        if name:
            return (kind, name)
    return ("", "")


def pick_merge_victims(
    parts: Sequence[Part],
    *,
    min_merge: int = DEFAULT_MIN_MERGE_PARTS,
    max_parts: int = DEFAULT_MAX_PARTS,
) -> list[Part]:
    """Size-tiered selection: when a resource's part count passes
    max_parts, merge its min_merge smallest parts (merger_policy.go
    analog)."""
    by_resource: dict[tuple[str, str], list[Part]] = {}
    for p in parts:
        by_resource.setdefault(resource_key(p), []).append(p)
    for group in by_resource.values():
        if len(group) >= max_parts:
            group.sort(key=lambda p: p.total_count)
            return group[:min_merge]
    return []


def merge_columns(parts: Sequence[Part]) -> tuple[ColumnData, dict]:
    """Read + combine the victims' rows with version dedup.

    Tag sets are unioned (schema evolution: a part written before a tag
    existed contributes the empty value for it).
    """
    all_tags = sorted({t for p in parts for t in p.meta["tags"]})
    all_fields = sorted({f for p in parts for f in p.meta["fields"]})

    ts_l, series_l, ver_l = [], [], []
    codes_l: dict[str, list[np.ndarray]] = {t: [] for t in all_tags}
    fields_l: dict[str, list[np.ndarray]] = {f: [] for f in all_fields}
    merged_dicts: dict[str, dict[bytes, int]] = {t: {} for t in all_tags}

    want_payload = any(p.meta.get("has_payload") for p in parts)
    payloads_l: list[bytes] = []
    for p in parts:
        cols = p.read(
            range(len(p.blocks)),
            tags=[t for t in all_tags if t in p.meta["tags"]],
            fields=[f for f in all_fields if f in p.meta["fields"]],
            want_payload=want_payload,
            cached=False,  # one-shot merge sweep: keep the query working set
        )
        n = cols.ts.size
        if want_payload:
            payloads_l.extend(cols.payloads or [b""] * n)
        ts_l.append(cols.ts)
        series_l.append(cols.series)
        ver_l.append(cols.version)
        for t in all_tags:
            md = merged_dicts[t]
            if t in cols.tags:
                lut = np.empty(max(len(cols.dicts[t]), 1), dtype=np.int32)
                for i, v in enumerate(cols.dicts[t]):
                    lut[i] = md.setdefault(v, len(md))
                codes_l[t].append(
                    lut[cols.tags[t]] if len(cols.dicts[t]) else np.full(n, md.setdefault(b"", len(md)), np.int32)
                )
            else:
                codes_l[t].append(
                    np.full(n, md.setdefault(b"", len(md)), dtype=np.int32)
                )
        for f in all_fields:
            fields_l[f].append(
                cols.fields.get(f, np.zeros(n, dtype=np.float64))
            )

    ts = np.concatenate(ts_l)
    series = np.concatenate(series_l)
    version = np.concatenate(ver_l)
    if want_payload:
        # Stream/trace rows are immutable appends with no version
        # semantics; (series, ts) is NOT unique (spans of one trace in the
        # same millisecond) — dedup here would destroy data.
        keep = np.arange(len(ts))
    else:
        keep = hostops.dedup_max_version(series, ts, version)

    dicts = {
        t: [v for v, _ in sorted(md.items(), key=lambda kv: kv[1])]
        for t, md in merged_dicts.items()
    }
    out = ColumnData(
        ts=ts[keep],
        series=series[keep],
        version=version[keep],
        tags={t: np.concatenate(codes_l[t])[keep] for t in all_tags},
        fields={f: np.concatenate(fields_l[f])[keep] for f in all_fields},
        dicts=dicts,
        payloads=[payloads_l[i] for i in keep] if want_payload else None,
    )
    kind, name = resource_key(parts[0])
    extra_meta = {kind: name} if kind else {}
    return out, extra_meta
