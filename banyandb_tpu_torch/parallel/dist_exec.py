"""Distributed measure aggregation over a mesh of device slots.

Map-reduce with a collective instead of proto exchange:

  per slot:    mask -> group key -> segment reduce  (the "map" on one
               shard/segment slice, same kernel family as
               query/measure_exec._kernel_body), on the slot's device
  collective:  sum(count/sums/hist), amin/amax over ('shard','seg') —
               replacing the liaison's partial-merge loop
               (banyand/dquery/measure.go:156) — a fixed-order
               reduction of the slots' partials, in slot order, on the
               first slot's device
  post:        top-k on the reduced group vector, still on the device

Inputs are per-slot row tensors (``stack_shard_chunks``); slots that
share a device take row views of one shipped ``[k, R]`` tensor.  The
JAX package runs the same step as one ``shard_map`` program with
``psum``/``pmin``/``pmax``; a reduction in slot order gives the same
counts, extremes and histograms, and sums within the precision
contract.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch

from banyandb_tpu_torch import ops

_NUM_HIST_BUCKETS = 512


@dataclass(frozen=True)
class DistPlan:
    """Static signature of the distributed aggregation step."""

    tags_code: tuple[str, ...]
    fields: tuple[str, ...]
    group_tags: tuple[str, ...]
    radices: tuple[int, ...]
    num_groups: int
    eq_preds: tuple[str, ...] = ()  # tag names with eq-code predicates
    topn: int = 0
    want_hist: str = ""  # field name for percentile histograms


def map_chunk(plan: DistPlan, chunk: dict, pred_codes: dict):
    """The map half of one slot's chunk: mask -> group key -> segment
    reduce.  -> (GroupReduceResult, key, mask).  Shared verbatim by the
    legacy single-width step below and the fused chunked-scan step
    (query/fused_exec.build_fused_dist_step), so the two mesh steps
    cannot drift on predicate/key/reduction semantics.  The group
    reduce resolves its method from the group count: the hand kernel
    (``fused_group_multi``) for G <= 8192 on a CUDA slot."""
    valid = chunk["valid"]
    masks = [valid]
    for t in plan.eq_preds:
        masks.append(chunk["tags"][t] == pred_codes[t])
    mask = ops.mask_and(*masks)

    key_cols = [chunk["tags"][t] for t in plan.group_tags]
    if key_cols:
        key, _ = ops.mixed_radix_key(key_cols, plan.radices)
    else:
        key = torch.zeros_like(valid, dtype=torch.int32)

    res = ops.group_reduce(
        key, mask, chunk["fields"], plan.num_groups, want_minmax=True
    )
    return res, key, mask


def slot_chunks(plan: DistPlan, chunks: dict) -> list[dict]:
    """Per-slot leaves of a packed chunk tree -> one chunk dict a slot."""
    return [
        {
            "valid": chunks["valid"][i],
            "tags": {t: chunks["tags"][t][i] for t in plan.tags_code},
            "fields": {f: chunks["fields"][f][i] for f in plan.fields},
        }
        for i in range(len(chunks["valid"]))
    ]


def reduce_slots(plan: DistPlan, parts: list[dict]) -> dict:
    """The collective: each slot's partials {count, sums, mins, maxs[,
    hist]} summed (amin/amax for the extremes) in slot order on the
    first slot's device, then top-k on the reduced vector."""
    dev = parts[0]["count"].device

    def fold(get, op):
        acc = get(parts[0])
        for p in parts[1:]:
            acc = op(acc, get(p).to(dev, non_blocking=True))
        return acc

    out = {
        "count": fold(lambda p: p["count"], torch.add),
        "sums": {
            f: fold(lambda p, f=f: p["sums"][f], torch.add)
            for f in plan.fields
        },
        "mins": {
            f: fold(lambda p, f=f: p["mins"][f], torch.minimum)
            for f in plan.fields
        },
        "maxs": {
            f: fold(lambda p, f=f: p["maxs"][f], torch.maximum)
            for f in plan.fields
        },
    }
    if plan.want_hist:
        out["hist"] = fold(lambda p: p["hist"], torch.add)
    if plan.topn:
        mean = out["sums"][plan.fields[0]] / torch.clamp(out["count"], min=1.0)
        vals, idx = ops.topk_groups(mean, out["count"] > 0, plan.topn)
        out["top_vals"], out["top_idx"] = vals, idx
    return out


def _slot_partials(plan: DistPlan, chunk: dict, pred_codes: dict,
                   hist_lo, hist_span) -> dict:
    """One slot's slice -> its partials (the map half plus the
    percentile histogram)."""
    res, key, mask = map_chunk(plan, chunk, pred_codes)
    out = {
        "count": res.count,
        "sums": dict(res.sums),
        "mins": dict(res.mins),
        "maxs": dict(res.maxs),
    }
    if plan.want_hist:
        out["hist"] = ops.group_histogram(
            key,
            mask,
            chunk["fields"][plan.want_hist],
            plan.num_groups,
            hist_lo,
            hist_span,
            _NUM_HIST_BUCKETS,
        )
    return out


_STEP_CACHE: dict[tuple, object] = {}


def _mesh_key(mesh) -> tuple:
    return (tuple(str(d) for d in mesh.devices), mesh.axis_names)


def build_distributed_step(mesh, plan: DistPlan):
    """-> f(chunks, pred_codes, hist_lo, hist_span) over the mesh.

    `chunks` leaves are per-slot [R] tensors on the slots' devices
    (``stack_shard_chunks``); outputs are tensors on the first slot's
    device.  Steps are memoized per (slot devices, plan)."""
    cache_key = (_mesh_key(mesh), plan)
    cached = _STEP_CACHE.get(cache_key)
    if cached is not None:
        return cached

    def step(chunks, pred_codes, hist_lo, hist_span):
        return reduce_slots(
            plan,
            [
                _slot_partials(plan, c, pred_codes, hist_lo, hist_span)
                for c in slot_chunks(plan, chunks)
            ],
        )

    _STEP_CACHE[cache_key] = step
    return step


def stack_shard_chunks(
    mesh,
    per_shard_rows: list[dict],
    tags: tuple[str, ...],
    fields: tuple[str, ...],
    nrows: int,
) -> dict:
    """Pack per-shard host rows into per-slot [nrows] tensors.

    Each entry of per_shard_rows: {"tags": {t: int32[n]}, "fields":
    {f: f32[n]}} for one device slot; rows beyond nrows are dropped by the
    caller's chunking loop, rows short of nrows are padded invalid.
    -> {"valid": [slot tensor], "tags": {t: [...]}, "fields": {f: [...]}};
    each column ships once per distinct device as one [k, nrows] tensor
    whose rows are the slots' views.
    """
    d = mesh.size
    if len(per_shard_rows) != d:
        raise ValueError(f"{len(per_shard_rows)} slot row sets for {d} slots")
    valid = np.zeros((d, nrows), dtype=bool)
    tag_arrs = {t: np.zeros((d, nrows), dtype=np.int32) for t in tags}
    field_arrs = {f: np.zeros((d, nrows), dtype=np.float32) for f in fields}
    for i, rows in enumerate(per_shard_rows):
        n = min(len(next(iter(rows["tags"].values()))) if rows["tags"] else 0, nrows)
        if rows["fields"]:
            n = min(
                n if rows["tags"] else nrows,
                *(len(v) for v in rows["fields"].values()),
            )
        valid[i, :n] = True
        for t in tags:
            tag_arrs[t][i, :n] = rows["tags"][t][:n]
        for f in fields:
            field_arrs[f][i, :n] = rows["fields"][f][:n]

    # slot indices per distinct device, in slot order
    by_dev: dict[torch.device, list[int]] = {}
    for i, dev in enumerate(mesh.devices):
        by_dev.setdefault(dev, []).append(i)

    def ship(arr: np.ndarray) -> list[torch.Tensor]:
        out: list = [None] * d
        for dev, idx in by_dev.items():
            rows = arr if len(idx) == d else arr[idx]
            on_dev = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
            for k, i in enumerate(idx):
                out[i] = on_dev[k]
        return out

    return {
        "valid": ship(valid),
        "tags": {t: ship(a) for t, a in tag_arrs.items()},
        "fields": {f: ship(a) for f, a in field_arrs.items()},
    }


def distributed_aggregate(
    mesh,
    plan: DistPlan,
    chunks: dict,
    pred_codes: Optional[Mapping[str, int]] = None,
    hist_lo: float = 0.0,
    hist_span: float = 1.0,
):
    """Convenience wrapper: build (cached) + run one step."""
    step = build_distributed_step(mesh, plan)
    codes = {t: int((pred_codes or {}).get(t, -1)) for t in plan.eq_preds}
    return step(chunks, codes, float(hist_lo), float(hist_span))
