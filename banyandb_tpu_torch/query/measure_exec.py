"""Device executor for measure aggregation queries, on torch tensors.

Pipeline (SURVEY.md §3.3 data-node hot loop):

  host:   sources (memtable + part blocks) -> global tag dictionaries ->
          code remap -> version dedup (lexsort) -> scan chunks
  device: one per-chunk plan body per plan signature: decode -> time/tag
          masks -> mixed-radix group key -> segment reduce
          (count/sum/min/max, the Hopper kernel) -> [+ histogram for
          percentile] ... executed per chunk (staged) or looped over a
          stacked part-batch (query/fused_exec)
  host:   combine tiny per-chunk partials, invert histograms, top-N, limit

Predicate *values* are tensors shipped once per query, not part of the
plan signature, so repeated queries with the same shape share it.

Precision contract: device kernels produce f32 partials whose f32
accumulation span is bounded (Kahan-compensated across tiles — see
ops/groupby.py); this host loop merges per-chunk partials in f64. Net
effect: per-group sums stay within ~1e-5 relative of exact f64 at any
row count.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from banyandb_tpu_torch import ops
from banyandb_tpu_torch.api.model import (
    Aggregation,
    Condition,
    Criteria,
    LogicalExpression,
    QueryRequest,
    QueryResult,
)
from banyandb_tpu_torch.api.schema import Measure, TagType
from banyandb_tpu_torch.backend import resolve_device
from banyandb_tpu_torch.obs import metrics as obs_metrics
from banyandb_tpu_torch.storage.part import ColumnData
from banyandb_tpu_torch.utils import hostops
from banyandb_tpu_torch.utils.envflag import env_int

# stage latency instruments (always on, spans or not): the attribution
# plane ROADMAP item 1's bench reads back as stage_breakdown.  Handles
# resolved once at import — observe() never touches the registry lock.
_H_GATHER = obs_metrics.stage_histogram("gather")
_H_DEVICE = obs_metrics.stage_histogram("device_execute")
_H_MERGE = obs_metrics.stage_histogram("merge")
# the pad/pack/ship half of the decode stage (ROADMAP item 3): host-side
# narrow packing + H2D transfer time; the device half (widen/remap/f32
# convert) is fused INSIDE the plan kernel and shows up in
# device_execute, which is exactly the point
_H_DECODE = obs_metrics.stage_histogram("decode")

CHUNK = 8192
# Scan chunks are much larger than storage blocks (8192 rows,
# banyand/measure/measure.go:46): per-chunk launches + [G]-sized host
# accumulation dominate at small chunks.  Power-of-two buckets up to
# SCAN_CHUNK keep the set of chunk shapes finite.
SCAN_CHUNK = env_int("BYDB_SCAN_CHUNK", 1 << 20)
_NUM_HIST_BUCKETS = 512


def _scan_bucket(n: int) -> int:
    b = 64
    while b < n:
        b <<= 1
    return min(b, SCAN_CHUNK)


@dataclass(frozen=True)
class _PredSpec:
    """Static shape of one predicate; its value(s) arrive as traced args.

    kinds:
    - "code": compare against a global dictionary code (eq/ne) or a padded
      code set (in/not_in).
    - "lut":  a bool lookup table over global codes — how numeric range
      predicates on INT tags evaluate without shipping 64-bit tag values
      to the device (the host computes op(dict_value, literal) per code).
    """

    kind: str  # "code" | "lut"
    name: str  # tag name
    op: str  # eq/ne/in/not_in (code) | lt/le/gt/ge (lut)
    nvals: int = 1  # in/not_in set size or LUT length (static shape)


@dataclass(frozen=True)
class PlanSpec:
    """Static plan signature: everything that shapes the device work."""

    tags_code: tuple[str, ...]  # tag columns shipped as global codes
    fields: tuple[str, ...]
    preds: tuple[_PredSpec, ...]
    group_tags: tuple[str, ...]
    radices: tuple[int, ...]  # global dict size per group tag
    num_groups: int
    want_minmax: bool
    hist_field: str = ""  # non-empty -> also emit histogram partials
    nrows: int = CHUNK
    group_method: str = "auto"  # ops.group_reduce method override
    # scan-order tracking: emit per-group min (scan asc) or max (desc)
    # of (ts<<32 | row) — drives first-appearance group ordering AND the
    # representative row for projected-but-not-grouped tags
    want_rep: bool = False
    rep_desc: bool = False
    # predicate expression tree over `preds`: ("p", i) leaves combined by
    # ("and", l, r) / ("or", l, r) nodes — the device lowering of a full
    # model/v1 Criteria tree (pkg/query/logical analog). () = AND of all
    # preds (the common flat case keeps its original plan signature).
    expr: tuple = ()


_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1


def _segment(reduce: str, values, idx, num_segments: int, init):
    """Segment min/max of int32 ``values`` by int64 ``idx``; segments no
    row reaches keep ``init`` (the identity of the reduction, as in the
    JAX executor)."""
    out = torch.full(
        (num_segments,), init, dtype=values.dtype, device=values.device
    )
    return out.scatter_reduce_(0, idx, values, reduce)


def _kernel_body(spec: PlanSpec):
    """The per-chunk partial computation for `spec`.

    Shared verbatim between the staged executor (`_build_kernel`, one
    call per chunk) and the fused executor (query/fused_exec loops it
    over a stacked chunk batch on the device) — the same computation per
    chunk either way, which is what makes the staged/fused A/B
    byte-identical."""

    def kernel(chunk: dict, pred_vals: dict, hist_lo, hist_span):
        valid = chunk["valid"]

        def pred_mask(i: int):
            p = spec.preds[i]
            col = chunk["tags_code"][p.name]
            v = pred_vals[f"p{i}"]
            if p.kind == "lut":
                # clamped gather: the JAX package's take(mode="clip")
                return v[col.long().clamp(0, v.shape[0] - 1)]
            if p.op in ("in", "not_in"):
                m = ops.in_set_mask(col, v)
                return ~m if p.op == "not_in" else m
            return ops.cmp_mask(col, p.op, v)

        def eval_expr(node):
            if node[0] == "p":
                return pred_mask(node[1])
            left = eval_expr(node[1])
            right = eval_expr(node[2])
            return (left & right) if node[0] == "and" else (left | right)

        if spec.expr:
            mask = valid & eval_expr(spec.expr)
        else:  # flat AND of all preds (original plan shape)
            mask = ops.mask_and(
                valid, *[pred_mask(i) for i in range(len(spec.preds))]
            )

        key_cols = [chunk["tags_code"][t] for t in spec.group_tags]
        if key_cols:
            key, _ = ops.mixed_radix_key(key_cols, spec.radices)
        else:
            key = torch.zeros_like(chunk["series"])

        res = ops.group_reduce(
            key,
            mask,
            chunk["fields"],
            spec.num_groups,
            want_minmax=spec.want_minmax,
            method=spec.group_method,
        )
        out = {
            "count": res.count,
            "sums": res.sums,
            "mins": res.mins,
            "maxs": res.maxs,
        }
        if spec.hist_field:
            out["hist"] = ops.group_histogram(
                key,
                mask,
                chunk["fields"][spec.hist_field],
                spec.num_groups,
                hist_lo,
                hist_span,
                _NUM_HIST_BUCKETS,
            )
        if spec.want_rep:
            # scan-order tracking, 32-bit: per-group min/max ts, then
            # min/max row among rows AT that ts — the first row of each
            # group under a ts ASC scan (DESC under ORDER BY time DESC),
            # which drives both group emission order and the
            # representative row (reference measure_plan_groupby.go
            # first-appearance + aggregation first-fed row semantics)
            ts32 = chunk["ts"]
            row32 = chunk["row"]
            G1 = spec.num_groups + 1
            skey = torch.where(mask, key, spec.num_groups).long()
            if spec.rep_desc:
                gts = _segment(
                    "amax", torch.where(mask, ts32, _I32_MIN + 1), skey, G1,
                    _I32_MIN,
                )
                at = mask & (ts32 == gts[skey])
                grow = _segment(
                    "amax", torch.where(at, row32, -1), skey, G1, _I32_MIN
                )
            else:
                gts = _segment(
                    "amin", torch.where(mask, ts32, _I32_MAX), skey, G1,
                    _I32_MAX,
                )
                at = mask & (ts32 == gts[skey])
                grow = _segment(
                    "amin", torch.where(at, row32, _I32_MAX), skey, G1,
                    _I32_MAX,
                )
            out["rep_ts"] = gts[: spec.num_groups]
            out["rep_row"] = grow[: spec.num_groups]
        return out

    return kernel


def _build_kernel(spec: PlanSpec):
    """The staged executor's per-chunk function for `spec`.

    The device-side decode stage (ops.decode.decode_chunk) runs FIRST:
    chunks arriving in the compressed ship form (narrow dict codes +
    [S, L] remap LUTs + narrow int fields, ``BYDB_DEVICE_DECODE``)
    widen/remap on the device (the widen through the Hopper kernel);
    canonical (pre-decoded) chunks pass through untouched."""
    body = _kernel_body(spec)

    def kernel(chunk: dict, pred_vals: dict, hist_lo, hist_span):
        return body(ops.decode_chunk(chunk), pred_vals, hist_lo, hist_span)

    return kernel


def ship(a, device) -> torch.Tensor:
    """Host array (or numpy scalar) -> tensor on `device`.  Every
    host->device copy of the measure executors goes through here, and
    every device->host copy through ``device_get``: the two boundaries
    the kernel audit counts (lint/kernel/dispatch.py)."""
    return torch.as_tensor(a).to(device)


def device_get(tree):
    """Move a nested dict of tensors to host numpy in one batch: every
    device tensor is copied into pinned memory without blocking, then
    the stream is synchronized once."""
    pending = []

    def issue(x):
        if isinstance(x, dict):
            return {k: issue(v) for k, v in x.items()}
        if x.is_cuda:
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(x, non_blocking=True)
            pending.append(x.device)
            return h
        return x

    moved = issue(tree)
    for dev in set(pending):
        torch.cuda.current_stream(dev).synchronize()

    def to_np(x):
        if isinstance(x, dict):
            return {k: to_np(v) for k, v in x.items()}
        return x.numpy()

    return to_np(moved)


class GlobalDicts:
    """Union of per-source tag dictionaries -> stable global codes.

    Codes are append-only: once a value has a code it keeps it forever,
    which is what lets DictState persist dictionaries (and cached
    per-part remap LUTs) across queries.
    """

    def __init__(self, tag_names: Sequence[str]):
        self.maps: dict[str, dict[bytes, int]] = {t: {} for t in tag_names}

    def ensure(self, tag: str) -> None:
        self.maps.setdefault(tag, {})

    def add_source(self, tag: str, d: list[bytes]) -> np.ndarray:
        """-> LUT local_code -> global_code for one source."""
        m = self.maps[tag]
        return np.fromiter(
            (m.setdefault(v, len(m)) for v in d), dtype=np.int32, count=len(d)
        )

    def size(self, tag: str) -> int:
        return max(len(self.maps[tag]), 1)

    def code_of(self, tag: str, value: bytes) -> int:
        return self.maps[tag].get(value, -1)

    def absent_code(self, tag: str) -> int:
        """Global code for the empty value (rows from sources that predate
        the tag)."""
        m = self.maps[tag]
        return m.setdefault(b"", len(m))

    def values(self, tag: str) -> list[bytes]:
        m = self.maps[tag]
        out = [b""] * len(m)
        for v, c in m.items():
            out[c] = v
        return out


class DictState:
    """Per-(engine, measure) persistent dictionary + remap state.

    The serving-cache companion (VERDICT r1 weak #5): global tag
    dictionaries grow monotonically across queries, per-part remap LUTs
    are cached by immutable part identity, and the token keys gathered
    chunks in the process serving cache so a repeat query skips
    _gather_rows entirely.  All access to `dicts` (reads included — dict
    iteration during insert raises) happens under `lock`; queries run
    concurrently on server threads.

    Growth bound: group cardinality is the product of all-time dict
    sizes, so tag churn under retention would inflate kernels without
    bound.  reset() discards the state (new token orphans old cache
    entries, which simply LRU out) — compute_partials calls it when the
    group space exceeds BYDB_MAX_PERSISTENT_GROUPS, rebounding
    cardinality to the live data on the next gather.
    """

    def __init__(self):
        import threading

        self.lock = threading.Lock()
        self._reset_locked()

    def _reset_locked(self):
        import uuid

        self.dicts = GlobalDicts(())
        self.remaps: dict[tuple, np.ndarray] = {}
        self.token = uuid.uuid4().hex
        # snapshot caches, valid while their length still covers the
        # (append-only) dict: values = code -> bytes list; ranks = code ->
        # lexicographic position among dict values (canonical group order
        # without a per-query Python sort over 100k groups)
        self.values_cache: dict[str, list] = {}
        self.rank_cache: dict[str, np.ndarray] = {}

    def reset(self):
        with self.lock:
            self._reset_locked()

    def values_snapshot(self, tag: str) -> list:
        """code -> value list for `tag`; cached, caller holds self.lock.
        The returned list is immutable by convention (shared across
        queries): dict growth rebuilds a fresh list."""
        m = self.dicts.maps.get(tag, {})
        cached = self.values_cache.get(tag)
        if cached is None or len(cached) != len(m):
            cached = self.dicts.values(tag)
            self.values_cache[tag] = cached
        return cached

    def rank_lut(self, tag: str, values: list) -> np.ndarray:
        """code -> bytes-lexicographic rank over at least `values`.

        Ranks from a larger (append-only) snapshot stay order-preserving
        over any older snapshot's codes, so a cached superset is reusable;
        callers only need relative order, not density.  The cache is
        guarded by snapshot identity — `values` must be the object
        values_snapshot currently hands out — so a query holding a
        pre-reset snapshot can neither reuse nor poison the post-reset
        cache (codes from the old dict generation rank differently).
        Takes self.lock.
        """
        with self.lock:
            current = self.values_cache.get(tag)
            if values is not current:
                return _build_rank_lut(values)  # stale/foreign: uncached
            lut = self.rank_cache.get(tag)
            if lut is None or len(lut) < len(values):
                lut = self.rank_cache[tag] = _build_rank_lut(values)
            return lut


def _build_rank_lut(values: list) -> np.ndarray:
    """code -> bytes-lexicographic rank among `values` (inverse argsort)."""
    order = sorted(range(len(values)), key=values.__getitem__)
    lut = np.empty(len(values), dtype=np.int64)
    lut[np.asarray(order, dtype=np.int64)] = np.arange(
        len(values), dtype=np.int64
    )
    return lut


_MAX_PERSISTENT_GROUPS = env_int("BYDB_MAX_PERSISTENT_GROUPS", 1 << 18)


def _tag_value_bytes(v) -> bytes:
    if isinstance(v, bytes):
        return v
    if isinstance(v, str):
        return v.encode()
    if isinstance(v, int):
        return v.to_bytes(8, "little", signed=True)
    raise TypeError(f"unsupported tag literal {type(v)}")


def _collect_conditions(c: Optional[Criteria]) -> list[Condition]:
    """Flatten an AND-tree; callers needing OR use _lower_criteria."""
    if c is None:
        return []
    if isinstance(c, Condition):
        return [c]
    assert isinstance(c, LogicalExpression)
    if c.op != "and":
        raise NotImplementedError(
            "AND-only path; OR criteria lower via _lower_criteria"
        )
    return _collect_conditions(c.left) + _collect_conditions(c.right)


def _lower_criteria(c: Optional[Criteria]) -> tuple[list[Condition], tuple]:
    """Full Criteria tree -> (predicate leaves, index expression tree).

    Pure-AND trees return expr=() so the common flat case keeps its
    original plan signature (signature stability); OR anywhere produces
    a nested ("and"|"or", left, right) tree over ("p", i) leaves that
    the kernel evaluates as mask algebra (union of in-set masks — the
    device lowering of pkg/query/logical's OR nodes)."""
    conds: list[Condition] = []

    def walk(node):
        if isinstance(node, Condition):
            conds.append(node)
            return ("p", len(conds) - 1)
        assert isinstance(node, LogicalExpression), node
        if node.op not in ("and", "or"):
            raise ValueError(f"unknown logical op {node.op!r}")
        return (node.op, walk(node.left), walk(node.right))

    if c is None:
        return [], ()
    expr = walk(c)

    def pure_and(n) -> bool:
        return n[0] == "p" or (
            n[0] == "and" and pure_and(n[1]) and pure_and(n[2])
        )

    return conds, (() if pure_and(expr) else expr)


class Partials:
    """Per-node partial aggregates keyed by decoded tag-value tuples.

    The wire unit of distributed map-reduce aggregation (the reference's
    agg_return_partial InternalQueryResponse,
    docs/concept/distributed-measure-aggregation.md): nodes return these,
    the liaison combines by group tuple and finalizes.  Arrays cover only
    nonempty groups (dense [G] layouts never cross nodes).

    Group identity is dual-representation: either materialized value
    tuples (`groups`, the wire/combine form) or dense global-code rows
    (`codes` [K, T] + `group_values` dict snapshots, the standalone hot
    path).  Tuples materialize lazily on first `.groups` access — a
    standalone TopN over 100k groups never builds 100k Python tuples
    (profiled at ~130ms/query before this split).
    """

    __slots__ = (
        "group_tags", "count", "sums", "mins", "maxs", "hist", "hist_lo",
        "hist_span", "field_stats", "_groups", "codes", "group_values",
        "rep_key", "rep_desc", "rep_vals",
    )

    def __init__(
        self,
        group_tags: tuple[str, ...],
        groups: Optional[list] = None,  # tag-value tuple per nonempty group
        count: np.ndarray = None,  # f64 [K]
        sums: dict = None,  # field -> f64 [K]
        mins: dict = None,
        maxs: dict = None,
        hist: Optional[np.ndarray] = None,  # [K, B]
        hist_lo: float = 0.0,
        hist_span: float = 1.0,
        field_stats: dict = None,  # f -> (min, max)
        codes: Optional[np.ndarray] = None,  # int32 [K, T] global codes
        group_values: Optional[dict] = None,  # tag -> list[bytes] snapshot
        rep_key: Optional[np.ndarray] = None,  # int64 [K] scan-order key
        rep_desc: bool = False,
        rep_vals: Optional[dict] = None,  # tag -> list[bytes] [K] rep row
    ):
        if groups is None and codes is None:
            raise TypeError("Partials needs groups or codes+group_values")
        self.group_tags = group_tags
        self._groups = groups
        self.codes = codes
        self.group_values = group_values
        self.count = count
        self.sums = sums
        self.mins = mins
        self.maxs = maxs
        self.hist = hist
        self.hist_lo = hist_lo
        self.hist_span = hist_span
        self.field_stats = {} if field_stats is None else field_stats
        self.rep_key = rep_key
        self.rep_desc = rep_desc
        self.rep_vals = rep_vals

    @property
    def groups(self) -> list[tuple[bytes, ...]]:
        if self._groups is None:
            k = self.codes.shape[0]
            if not self.group_tags:
                self._groups = [()] * k
            elif k == 0:
                self._groups = []
            else:
                cols = [
                    np.asarray(self.group_values[t], dtype=object)[
                        self.codes[:, i]
                    ]
                    for i, t in enumerate(self.group_tags)
                ]
                self._groups = list(zip(*cols))
        return self._groups

    @groups.setter
    def groups(self, v: list) -> None:
        self._groups = v

    def group_key(self, i: int) -> tuple[bytes, ...]:
        """Decode ONE group's value tuple without materializing the rest."""
        if self._groups is not None:
            return self._groups[i]
        return tuple(
            self.group_values[t][int(self.codes[i, j])]
            for j, t in enumerate(self.group_tags)
        )

    def content_bytes(self) -> bytes:
        """Canonical byte serialization of every numeric/representative
        component — THE byte-parity oracle the A/B contracts
        (``BYDB_FUSED``, ``BYDB_DEVICE_DECODE``, ``BYDB_PIPELINE``)
        are asserted against (tests/test_fused_exec.py,
        tests/test_decode.py, scripts/decode_smoke.py all compare this
        one serialization, so a new Partials field added here is
        parity-pinned everywhere at once)."""
        parts = [
            self.count.tobytes(),
            self.codes.tobytes() if self.codes is not None else b"",
        ]
        for d in (self.sums, self.mins, self.maxs):
            for k in sorted(d):
                parts.append(d[k].tobytes())
        if self.hist is not None:
            parts.append(self.hist.tobytes())
        if self.rep_key is not None:
            parts.append(self.rep_key.tobytes())
        if self.rep_vals is not None:
            parts.append(repr(sorted(self.rep_vals.items())).encode())
        return b"".join(parts)


def execute_aggregate(
    measure: Measure,
    request: QueryRequest,
    sources: list[ColumnData],
    dict_state: Optional[DictState] = None,
    analyzers: Optional[dict] = None,
    span=None,
    plan_hints=None,
    device=None,
) -> QueryResult:
    """Run a group-by/aggregate/top-N/percentile query over decoded sources.

    `device`: where the scan runs (``backend.resolve_device``; the CUDA
    device by default, ``"cpu"`` only when asked for)."""
    partial = compute_partials(
        measure, request, sources, dict_state=dict_state, analyzers=analyzers,
        span=span, plan_hints=plan_hints, device=device,
    )
    return finalize_partials(
        measure, request, [partial], dict_state=dict_state, span=span
    )


def compute_partials(
    measure: Measure,
    request: QueryRequest,
    sources: list[ColumnData],
    hist_range: Optional[tuple[float, float]] = None,
    dict_state: Optional[DictState] = None,
    analyzers: Optional[dict] = None,
    span=None,
    plan_hints=None,
    device=None,
) -> Partials:
    """The 'map' phase: device scan+reduce over local sources.

    `device` (``backend.resolve_device``): the CUDA device by default;
    without CUDA the call raises unless ``"cpu"`` was asked for.

    `hist_range` fixes the percentile histogram range (distributed
    two-pass: the liaison first combines field_stats, then re-requests
    with the global range so node histograms are combinable).

    `dict_state` (engine-owned) turns on the serving-cache fast path:
    persistent global dictionaries, cached per-part remaps, and cached
    gathered chunks keyed by part identities — repeat queries skip the
    whole host gather.

    `span` (obs.tracer.Span or None): tracing sink — gather/reduce child
    spans with cache hit/miss tags and device/host attribution.  None
    keeps the path span-free; the stage histograms observe either way.

    `plan_hints` (query/planner.PlanDecision or None): the cost-based
    planner's result-preserving refinements — a group-method override
    when the estimated distinct group count crosses the hash/sort
    crossover on the other side of the static radix product, a minimum
    fused chunk-count bucket (signature stability), and a
    prefer-staged routing when the estimated footprint exceeds the
    fused budget.  ``actual_rows`` is written back for the planner
    span's est-vs-actual tag.
    """
    import time as _time
    device = resolve_device(device)
    conds, expr = _lower_criteria(request.criteria)
    group_tags = tuple(request.group_by.tag_names) if request.group_by else ()
    agg = request.agg

    # --- which columns ride to the device ---------------------------------
    range_ops = {"lt", "le", "gt", "ge"}
    tags_code: set[str] = set(group_tags)
    for c in conds:
        measure.tag(c.name)  # validate against schema (KeyError on typo)
        tags_code.add(c.name)
    # Representative tags: projected but not grouped — each output group
    # carries the first-scanned row's values for these (reference
    # aggregation copies the first fed row's TagFamilies).  Unknown
    # projected tags are schema errors (ref WantErr cases).
    rep_tags: tuple[str, ...] = ()
    if group_tags or agg is not None:
        schema_fields = {f.name for f in measure.fields}
        rep_list = []
        for t in request.tag_projection:
            if t in group_tags:
                continue
            if t in schema_fields:
                # bydbql puts the SELECT list into BOTH projections, so a
                # grouped `SELECT svc, value ...` names the field here;
                # fields are never representative tags
                continue
            measure.tag(t)  # KeyError -> INVALID_ARGUMENT on the wire
            rep_list.append(t)
            tags_code.add(t)
        rep_tags = tuple(dict.fromkeys(rep_list))
    rep_desc = request.order_by_ts == "desc"
    # scan-order tracking serves grouped ordering AND the global-agg
    # representative row (a no-group aggregate's output row carries the
    # first scanned row's projected tags)
    want_rep = bool(group_tags) or bool(rep_tags)
    # Projection names that aren't schema fields (e.g. tags from a QL
    # SELECT list) are dropped — they'd only materialize zero columns.
    # Raw (string/binary) fields never ride the device path either: they
    # are stored as '@f:' tag columns and only the raw-row path serves
    # them (models/measure._raw_fields).
    from banyandb_tpu_torch.api.schema import FieldType as _FT

    known = {
        f.name
        for f in measure.fields
        if f.type not in (_FT.STRING, _FT.DATA_BINARY)
    }
    fields = {f for f in request.field_projection if f in known}
    if agg:
        fields.add(agg.field_name)
    if request.top:
        fields.add(request.top.field_name)

    # --- global dictionaries + remapped concatenated columns --------------
    # gd and token are captured atomically under the lock: a concurrent
    # cap-triggered reset swaps dict_state.dicts/token together, and all
    # cache writes below guard on `dict_state.dicts is gd` so an in-flight
    # query can never poison the post-reset caches with old codes.
    if dict_state is None:
        gd = GlobalDicts(sorted(tags_code))
        token = None
    else:
        with dict_state.lock:
            # Growth bound: reset bloated state (tag churn under
            # retention) so cardinality re-bounds to live data.
            prod = 1
            for t in group_tags:
                prod *= max(len(dict_state.dicts.maps.get(t, ())), 1)
            if prod > _MAX_PERSISTENT_GROUPS:
                dict_state._reset_locked()
            gd = dict_state.dicts
            token = dict_state.token
            for t in tags_code:
                gd.ensure(t)

    # the compressed-ship flag is read ONCE per query and pinned into the
    # gather cache key: the two ship forms produce differently-shaped
    # gathered snapshots, and a live flag flip must never serve one
    # mode's cache entry to the other
    from banyandb_tpu_torch.storage import encoded as enc_mod

    device_decode = enc_mod.device_decode_enabled()
    gather_key = None
    if dict_state is not None and sources and all(
        s.cache_key is not None for s in sources
    ):
        gather_key = (
            "gather",
            token,
            tuple(s.cache_key for s in sources),
            request.time_range.begin_millis,
            request.time_range.end_millis,
            tuple(sorted(tags_code)),
            tuple(sorted(fields)),
            device_decode,
        )

    def _do_gather():
        return _gather_rows(
            sources,
            sorted(tags_code),
            sorted(fields),
            gd,
            request.time_range.begin_millis,
            request.time_range.end_millis,
            dict_state=dict_state,
            device_decode=device_decode,
        )

    t_gather0 = _time.perf_counter()
    gather_loaded: list = []  # loader ran -> serving-cache miss
    if gather_key is not None:
        from banyandb_tpu_torch.storage.cache import global_cache

        def _loader():
            gather_loaded.append(1)
            return _do_gather()

        chunks_np = global_cache().get_or_load(gather_key, _loader)
    else:
        gather_loaded.append(1)
        chunks_np = _do_gather()
    gather_ms = (_time.perf_counter() - t_gather0) * 1000
    _H_GATHER.observe(gather_ms)
    n = chunks_np["ts"].shape[0]
    if span is not None:
        g = span.child("gather").tag("rows", int(n)).tag(
            "sources", len(sources)
        ).tag(
            "serving_cache",
            ("off" if gather_key is None else "miss")
            if gather_loaded
            else "hit",
        )
        g.t0 = t_gather0  # span covers the gather that already ran
        g.finish()
    # epoch = global min ts keeps chunk-relative int32 offsets
    # nonnegative for the scan-order key; spans >= 2^31 ms (~24.8 days)
    # would wrap the int32 cast, so rep tracking degrades to canonical
    # ordering there instead of silently corrupting
    epoch = int(chunks_np["ts"].min()) if n else 0
    if n and int(chunks_np["ts"].max()) - epoch >= 2**31:
        want_rep = False
        rep_tags = ()

    # --- plan signature ---------------------------------------------------
    # All gd reads happen under the DictState lock (concurrent queries
    # mutate the same dicts); group value lists are snapshotted here for
    # the decode step below.
    import contextlib

    pred_specs = []
    pred_np: dict[str, np.ndarray] = {}
    with dict_state.lock if dict_state is not None else contextlib.nullcontext():
        for i, c in enumerate(conds):
            if c.op in range_ops or c.op == "match":
                # LUT predicates (range / MATCH): op(dict_value, literal)
                # evaluated host-side per global code -> bool LUT gathered
                # on device (64-bit tag values and analyzer tokenization
                # never reach the int32 kernel).  Shared with the raw row
                # path (query/filter.py) so host and device semantics
                # cannot drift.
                from banyandb_tpu_torch.query.filter import match_lut, range_lut

                vals = gd.values(c.name)
                if c.op == "match":
                    lut = match_lut(c, analyzers, vals)
                else:
                    lut = range_lut(
                        c.op, c.value, vals, measure.tag(c.name).type
                    )
                if not len(lut):
                    lut = np.zeros(1, dtype=bool)
                pred_specs.append(_PredSpec("lut", c.name, c.op, nvals=len(lut)))
                pred_np[f"p{i}"] = np.asarray(lut, dtype=bool)
            elif c.op in ("in", "not_in"):
                vals = [gd.code_of(c.name, _tag_value_bytes(v)) for v in c.value]
                arr = np.asarray(vals or [-1], dtype=np.int32)
                pred_specs.append(_PredSpec("code", c.name, c.op, nvals=len(arr)))
                pred_np[f"p{i}"] = arr
            else:
                code = gd.code_of(c.name, _tag_value_bytes(c.value))
                pred_specs.append(_PredSpec("code", c.name, c.op))
                pred_np[f"p{i}"] = np.int32(code)

        radices = tuple(gd.size(t) for t in group_tags)
        if dict_state is not None and dict_state.dicts is gd:
            group_values = {
                t: dict_state.values_snapshot(t) for t in group_tags
            }
        else:
            group_values = {t: gd.values(t) for t in group_tags}
    num_groups = 1
    for r in radices:
        num_groups *= r

    want_percentile = bool(agg and agg.function == "percentile")
    hist_field = agg.field_name if want_percentile else ""
    # min/max always computed when percentile (field_stats feed the
    # distributed two-pass range agreement).
    want_minmax = not agg or agg.function in ("min", "max") or want_percentile

    nrows = SCAN_CHUNK if n > SCAN_CHUNK else _scan_bucket(max(n, 1))
    # planner group-method override (query/planner): applied ONLY when
    # the estimate lands on the other side of the hash/sort crossover
    # from the static radix product — the common case keeps "auto" so
    # the plan signature (precompile store, kernel budgets)
    # is exactly the pre-planner one.  Methods are bit-identical within
    # the span bound (ops/groupby contract), so BYDB_PLANNER=0/1 result
    # JSON stays byte-identical.
    group_method = "auto"
    if plan_hints is not None and plan_hints.group_method:
        group_method = plan_hints.group_method
    if plan_hints is not None:
        plan_hints.actual_rows = int(n)
    spec = PlanSpec(
        tags_code=tuple(sorted(tags_code)),
        fields=tuple(sorted(fields)),
        preds=tuple(pred_specs),
        group_tags=group_tags,
        radices=radices,
        num_groups=max(num_groups, 1),
        want_minmax=want_minmax,
        hist_field=hist_field,
        nrows=nrows,
        group_method=group_method,
        expr=expr,
        want_rep=want_rep,
        rep_desc=rep_desc,
    )
    kernel = _build_kernel(spec)
    # function-local import: precompile imports this module's builders
    from banyandb_tpu_torch.query.precompile import default_registry

    # the (group, measure) context turns this anonymous signature into
    # autoreg evidence (query/planner.signature_from_spec)
    default_registry().record(
        "measure", spec, context=(measure.group, measure.name)
    )

    # --- histogram range from host stats (two-pass percentile) ------------
    if hist_range is not None:
        hist_lo, hist_span = hist_range
    elif want_percentile and n:
        fv = chunks_np["fields"][hist_field]
        hist_lo = float(fv.min())
        hist_span = max(float(fv.max()) - hist_lo, 1e-6)
    else:
        hist_lo, hist_span = 0.0, 1.0

    # --- partials-level serving cache -------------------------------------
    # Repeat queries over unchanged sources (the dashboard pattern) skip
    # the whole reduction: the cache key pins the gathered snapshot
    # (gather_key covers source identities + time range + dict token),
    # the compiled plan signature, and every predicate VALUE.
    partials_key = None
    if gather_key is not None:
        import hashlib as _hl

        h = _hl.blake2b(digest_size=16)
        for pk in sorted(pred_np):
            h.update(pk.encode())
            h.update(np.asarray(pred_np[pk]).tobytes())
        partials_key = (
            "partials",
            gather_key,
            spec,
            # rep_tags are NOT part of the kernel signature (the kernel
            # only tracks the representative ROW; decode happens host-
            # side), so they must pin the cache entry separately — a
            # projection-free query must never serve a projecting one
            # cached partials with rep_vals=None
            rep_tags,
            round(hist_lo, 9),
            round(hist_span, 9),
            h.hexdigest(),
        )

    rspan = span.child("reduce") if span is not None else None
    reduce_loaded: list = []

    def _reduce() -> Partials:
        reduce_loaded.append(1)
        return _reduce_partials(
            measure, chunks_np, conds, expr, pred_np, spec, kernel,
            group_values, rep_tags, rep_desc, want_rep, gd, dict_state,
            hist_lo, hist_span, want_percentile, epoch, gather_key, agg,
            device, span=rspan, plan_hints=plan_hints,
        )

    try:
        if partials_key is not None:
            from banyandb_tpu_torch.storage.cache import global_cache

            return global_cache().get_or_load(partials_key, _reduce)
        return _reduce()
    finally:
        if rspan is not None:
            rspan.tag(
                "partials_cache",
                ("off" if partials_key is None else "miss")
                if reduce_loaded
                else "hit",
            )
            if not reduce_loaded:  # replayed: no device leg ran
                rspan.tag("device_ms", 0.0).tag(
                    "host_ms", round(rspan.duration_ms, 3)
                )
            rspan.finish()


def _reduce_partials(
    measure,
    chunks_np,
    conds,
    expr,
    pred_np,
    spec,
    kernel,
    group_values,
    rep_tags,
    rep_desc,
    want_rep,
    gd,
    dict_state,
    hist_lo,
    hist_span,
    want_percentile,
    epoch,
    gather_key,
    agg,
    device,
    span=None,
    plan_hints=None,
):
    """The reduction tail of compute_partials (cacheable unit).

    `span` gets the device/host attribution tags: device_ms is the time
    spent at the two accelerator boundaries (kernel dispatch + the
    batched device_get), host_ms the rest of the reduction; pad_ship_ms
    is the prefetch thread's chunk pad+transfer work (overlapped, so it
    is NOT a subset of the wall duration)."""
    import contextlib
    import time as _time

    t_reduce0 = _time.perf_counter()
    n = chunks_np["ts"].shape[0]
    group_tags = spec.group_tags
    radices = spec.radices
    want_minmax = spec.want_minmax
    # --- exact-f64 host path for FLOAT-field aggregation ------------------
    # The reference aggregates float64 fields in full f64 and its goldens
    # compare exactly (852.0409999999999 etc.); the device kernel's f32
    # partials cannot reproduce that.  Float aggregates therefore reduce
    # on host in f64 (vectorized bincount — still columnar, just not on
    # the accelerator); INT fields keep the device path (f32 partials
    # are exact to 2^24 per chunk and merge in f64).
    agg_is_float = False
    if agg and agg.function != "percentile":
        try:
            agg_is_float = measure.field(agg.field_name).type.name == "FLOAT"
        except KeyError:
            agg_is_float = False
    if agg_is_float and n:
        out = _host_float_partials(
            measure, None, _materialize_tag_codes(chunks_np, spec.tags_code),
            conds, expr, pred_np, spec,
            group_values, rep_tags, rep_desc, want_rep, gd, dict_state,
        )
        if span is not None:
            # exact-f64 host reduction: no device leg by design
            span.tag("path", "host_f64").tag("device_ms", 0.0).tag(
                "host_ms",
                round((_time.perf_counter() - t_reduce0) * 1000, 3),
            )
        return out

    # --- run chunks, combine partials ------------------------------------
    G = spec.num_groups
    count = np.zeros(G, dtype=np.float64)
    sums = {f: np.zeros(G, dtype=np.float64) for f in spec.fields}
    mins = {f: np.full(G, np.inf, dtype=np.float64) for f in spec.fields}
    maxs = {f: np.full(G, -np.inf, dtype=np.float64) for f in spec.fields}
    hist = np.zeros((G, _NUM_HIST_BUCKETS), dtype=np.float64) if want_percentile else None
    rep_ts_acc = rep_row_acc = None
    if want_rep:
        sentinel = -(2**62) if rep_desc else 2**62
        rep_ts_acc = np.full(G, sentinel, dtype=np.int64)
        rep_row_acc = np.full(G, sentinel, dtype=np.int64)

    # predicate values and histogram scalars ship once per reduction,
    # not once per chunk
    pred_vals = {k: ship(v, device) for k, v in pred_np.items()}
    hist_lo_dev = ship(np.float32(hist_lo), device)
    hist_span_dev = ship(np.float32(hist_span), device)
    dev_cache = None
    if gather_key is not None:
        from banyandb_tpu_torch.storage.cache import device_cache

        dev_cache = device_cache()

    def _absorb(out: dict) -> None:
        """Fold ONE chunk's partials (already on host) into the f64
        accumulators — the host half of the precision contract."""
        nonlocal count, hist, rep_ts_acc, rep_row_acc
        count += out["count"].astype(np.float64)
        for f in spec.fields:
            sums[f] += out["sums"][f].astype(np.float64)
            if want_minmax:
                mins[f] = np.minimum(mins[f], out["mins"][f])
                maxs[f] = np.maximum(maxs[f], out["maxs"][f])
        if hist is not None:
            hist += out["hist"].astype(np.float64)
        if rep_ts_acc is not None:
            rts = out["rep_ts"].astype(np.int64) + epoch
            rrow = out["rep_row"].astype(np.int64)
            if rep_desc:
                better = (rts > rep_ts_acc) | (
                    (rts == rep_ts_acc) & (rrow > rep_row_acc)
                )
            else:
                better = (rts < rep_ts_acc) | (
                    (rts == rep_ts_acc) & (rrow < rep_row_acc)
                )
            rep_ts_acc = np.where(better, rts, rep_ts_acc)
            rep_row_acc = np.where(better, rrow, rep_row_acc)

    # Gather/compute pipeline, two overlaps stacked per chunk:
    # (1) while the device executes chunk k, a prefetch thread pads and
    #     ships chunk k+1 (storage/chunk_stream; BYDB_PIPELINE=0 forces
    #     the strict-serial path — results are byte-identical either
    #     way because chunks are absorbed in scan order regardless);
    # (2) chunk k's device->host transfer happens AFTER chunk k+1's
    #     kernel is dispatched, so transfer overlaps compute.  The whole
    #     result dict moves in a single batched device_get per chunk
    #     instead of one blocking copy per column.
    from banyandb_tpu_torch.storage.chunk_stream import prefetched

    # pad/ship accumulation crosses into the prefetch worker thread:
    # plain list appends (GIL-atomic), summed by the owner below — Span
    # objects themselves are single-owner and never touched off-thread
    pad_ship_s: list = []
    chunks_built: list = []
    # (shipped, dense) bytes per built chunk: the decode span's
    # compression evidence (dense = what the decoded i32/f32 ship form
    # would have moved for the same columns)
    ship_stats: list = []

    lut_cache: dict = {}  # remap LUTs ship once per reduction

    def _build_chunk(start: int, end: int):
        t0 = _time.perf_counter()
        chunks_built.append(1)
        try:
            return _device_chunk(
                chunks_np, start, end, spec, epoch, device,
                ship_stats=ship_stats, lut_cache=lut_cache,
            )
        finally:
            pad_ship_s.append(_time.perf_counter() - t0)

    def _make_chunk(start: int, end: int):
        if dev_cache is not None:
            # Chunks depend only on (gathered data, shape, columns): keep
            # the padded device tensors resident so repeat queries skip
            # the host->device transfer too.
            ck = (
                "device_chunk",
                str(device),
                gather_key,
                start,
                end,
                spec.nrows,
                spec.tags_code,
                spec.fields,
            )
            return dev_cache.get_or_load(
                ck, lambda: _build_chunk(start, end)
            )
        return _build_chunk(start, end)

    chunk_spans = []
    for start in range(0, max(n, 1), spec.nrows):
        end = min(start + spec.nrows, n)
        if end <= start:
            break
        chunk_spans.append((start, end))

    # Fused whole-plan path (query/fused_exec, BYDB_FUSED=0 restores
    # the staged loop below): the SAME per-chunk body runs over a
    # stacked [C, nrows] batch on the device — one batched device_get
    # out per part-batch — and the per-chunk partials come back stacked
    # for the identical f64 absorb loop.
    from banyandb_tpu_torch.query import fused_exec

    device_s = 0.0  # time at the accelerator boundaries (dispatch + get)
    dispatches = 0
    fused_cache_tag = None
    # planner hints (query/planner): prefer_staged routes an estimated-
    # over-budget batch straight to the staged loop; min_bucket rounds
    # the chunk-count bucket UP to the estimate's bucket (padding chunks
    # are fully invalid — byte-identical, one compiled program for a
    # part population oscillating around a bucket boundary)
    min_bucket = None
    hinted_staged = False
    if plan_hints is not None:
        min_bucket = plan_hints.chunk_bucket
        hinted_staged = plan_hints.prefer_staged
    if not hinted_staged and fused_exec.eligible(
        spec, len(chunk_spans), min_bucket=min_bucket
    ):
        path = "fused"
        moved_chunks, device_s, fused_cache_tag = fused_exec.run_fused(
            chunks_np,
            chunk_spans,
            spec,
            pred_vals,
            hist_lo_dev,
            hist_span_dev,
            epoch,
            device,
            gather_key=gather_key,
            dev_cache=dev_cache,
            pad_ship_s=pad_ship_s,
            ship_stats=ship_stats,
            min_bucket=min_bucket,
        )
        dispatches = 1
        for moved in moved_chunks:
            _absorb(moved)
    else:
        path = "staged"
        pending = None
        for chunk in prefetched(
            [lambda s=s, e=e: _make_chunk(s, e) for s, e in chunk_spans],
            name="bydb-chunk-prefetch",
        ):
            t_d = _time.perf_counter()
            out = kernel(chunk, pred_vals, hist_lo_dev, hist_span_dev)
            device_s += _time.perf_counter() - t_d
            dispatches += 1
            if pending is not None:
                t_d = _time.perf_counter()
                # the result boundary: one batched transfer per chunk,
                # issued after the next chunk's dispatch above
                moved = device_get(pending)
                device_s += _time.perf_counter() - t_d
                _absorb(moved)
            pending = out
        if pending is not None:
            t_d = _time.perf_counter()
            # final chunk's result boundary
            moved = device_get(pending)
            device_s += _time.perf_counter() - t_d
            _absorb(moved)
    _H_DEVICE.observe(device_s * 1000)
    # -- decode stage attribution (ROADMAP item 3) ------------------------
    # host half = narrow pack + pad + H2D ship (pad_ship_s, overlapped
    # with device execution under BYDB_PIPELINE); the device half
    # (widen/remap/f32 convert) is fused into the plan dispatch and is
    # deliberately part of device_execute.  Byte counters make the
    # compression win attributable even on a cpu-fallback bench run.
    decode_ms = sum(pad_ship_s) * 1000
    shipped_bytes = sum(s for s, _ in ship_stats)
    dense_bytes = sum(d for _, d in ship_stats)
    decode_mode = "device" if "src_ord" in chunks_np else "host"
    _H_DECODE.observe(decode_ms)
    if ship_stats:
        meter = obs_metrics.global_meter()
        meter.counter_add(
            "decode_ship_bytes", float(shipped_bytes), labels={"form": "shipped"}
        )
        meter.counter_add(
            "decode_ship_bytes", float(dense_bytes), labels={"form": "dense"}
        )
    if span is not None:
        dspan = span.child("decode")
        dspan.tag("mode", decode_mode).tag(
            "host_ms", round(decode_ms, 3)
        ).tag("shipped_bytes", shipped_bytes).tag(
            "dense_bytes", dense_bytes
        ).tag(
            "ratio",
            round(dense_bytes / shipped_bytes, 2) if shipped_bytes else 1.0,
        )
        dspan.finish()
    if span is not None:
        total_ms = (_time.perf_counter() - t_reduce0) * 1000
        span.tag("device_ms", round(device_s * 1000, 3)).tag(
            "host_ms", round(max(total_ms - device_s * 1000, 0.0), 3)
        ).tag("chunks", len(chunk_spans)).tag(
            "pad_ship_ms", round(sum(pad_ship_s) * 1000, 3)
        ).tag("path", path).tag("dispatches", dispatches)
        if dev_cache is not None:
            if fused_cache_tag is not None:
                span.tag("device_cache", fused_cache_tag)
            else:
                span.tag(
                    "device_cache",
                    f"{len(chunk_spans) - len(chunks_built)} hit / "
                    f"{len(chunks_built)} built",
                )

    # --- dense [G] arrays -> nonempty-group records (codes stay dense
    # int32 rows; value tuples materialize lazily, Partials.groups) -------
    if group_tags:
        nz = np.nonzero(count > 0)[0]
        codes = (
            np.stack(np.unravel_index(nz, radices), axis=1).astype(np.int32)
            if len(nz)
            else np.zeros((0, len(group_tags)), np.int32)
        )
    else:
        nz = np.asarray([0])
        codes = np.zeros((1, 0), np.int32)
    rep_key = None
    if rep_ts_acc is not None:
        # [K, 2] (absolute ts, row) scan-order key, compared
        # lexicographically; row is only a local tie-break (cross-node
        # combines compare ts first, which is what first-appearance
        # ordering needs)
        rep_key = np.stack([rep_ts_acc[nz], rep_row_acc[nz]], axis=1)
    rep_vals = None
    if rep_tags and rep_key is not None and len(nz):
        # decode each group's representative row into the gathered cols
        rows = np.clip(rep_key[:, 1], 0, max(n - 1, 0))
        with dict_state.lock if dict_state is not None else contextlib.nullcontext():
            rep_vals = {}
            for t in rep_tags:
                vals_list = gd.values(t)
                varr = np.asarray(vals_list, dtype=object)
                rep_codes_t = _host_tag_codes(chunks_np, t, rows)
                rep_vals[t] = varr[rep_codes_t].tolist()
    elif rep_tags:
        rep_vals = {t: [] for t in rep_tags}
    field_stats = {}
    if want_minmax:
        for f in spec.fields:
            valid_groups = count > 0
            if valid_groups.any():
                field_stats[f] = (
                    float(mins[f][valid_groups].min()),
                    float(maxs[f][valid_groups].max()),
                )
    return Partials(
        group_tags=group_tags,
        codes=codes,
        group_values=group_values,
        count=count[nz],
        sums={f: sums[f][nz] for f in spec.fields},
        mins={f: mins[f][nz] for f in spec.fields},
        maxs={f: maxs[f][nz] for f in spec.fields},
        hist=hist[nz] if hist is not None else None,
        hist_lo=hist_lo,
        hist_span=hist_span,
        field_stats=field_stats,
        rep_key=rep_key,
        rep_desc=rep_desc,
        rep_vals=rep_vals,
    )


def _host_float_partials(
    measure,
    request,
    chunks: dict,
    conds,
    expr,
    pred_vals: dict,
    spec: PlanSpec,
    group_values: dict,
    rep_tags: tuple,
    rep_desc: bool,
    want_rep: bool,
    gd: GlobalDicts,
    dict_state,
) -> Partials:
    """Exact-f64 reduction over the gathered columns (float agg fields).

    Mirrors the device kernel's semantics — same predicate LUT/code
    masks, same mixed-radix group keys, same scan-order representative —
    with numpy f64 arithmetic so float goldens compare exactly."""
    n = chunks["ts"].shape[0]
    G = spec.num_groups

    def pred_mask(i: int) -> np.ndarray:
        p = spec.preds[i]
        col = chunks["tags_code"][p.name]
        v = np.asarray(pred_vals[f"p{i}"])
        if p.kind == "lut":
            m = len(v)
            ok = (col >= 0) & (col < m)
            return np.where(ok, v[np.clip(col, 0, m - 1)], False)
        if p.op in ("in", "not_in"):
            m = np.isin(col, v)
            return ~m if p.op == "not_in" else m
        return (col == v) if p.op == "eq" else (col != v)

    def eval_expr(node) -> np.ndarray:
        if node[0] == "p":
            return pred_mask(node[1])
        left, right = eval_expr(node[1]), eval_expr(node[2])
        return (left & right) if node[0] == "and" else (left | right)

    if spec.expr:
        mask = eval_expr(spec.expr)
    else:
        mask = np.ones(n, dtype=bool)
        for i in range(len(spec.preds)):
            mask &= pred_mask(i)

    if spec.group_tags:
        key = np.zeros(n, dtype=np.int64)
        for t, r in zip(spec.group_tags, spec.radices):
            key = key * r + chunks["tags_code"][t].astype(np.int64)
    else:
        key = np.zeros(n, dtype=np.int64)

    sel = np.nonzero(mask)[0]
    k = key[sel]
    count = np.bincount(k, minlength=G).astype(np.float64)
    sums = {}
    mins = {}
    maxs = {}
    for f in spec.fields:
        vals = chunks["fields"][f][sel].astype(np.float64)
        sums[f] = np.bincount(k, weights=vals, minlength=G)
        mn = np.full(G, np.inf, dtype=np.float64)
        mx = np.full(G, -np.inf, dtype=np.float64)
        np.minimum.at(mn, k, vals)
        np.maximum.at(mx, k, vals)
        mins[f] = mn
        maxs[f] = mx

    rep_ts_acc = rep_row_acc = None
    if want_rep:
        # sentinels ALWAYS initialized when rep is on — a zero-match
        # node must still ship rep arrays or combine_partials would
        # drop rep for the whole cluster result
        sentinel = -(2**62) if rep_desc else 2**62
        rep_ts_acc = np.full(G, sentinel, dtype=np.int64)
        rep_row_acc = np.full(G, sentinel, dtype=np.int64)
        if sel.size:
            ts_sel = chunks["ts"][sel]
            order = (
                np.lexsort((-sel, -ts_sel))
                if rep_desc
                else np.lexsort((sel, ts_sel))
            )
            uk, first = np.unique(k[order], return_index=True)
            rep_ts_acc[uk] = ts_sel[order][first]
            rep_row_acc[uk] = sel[order][first]

    if spec.group_tags:
        nz = np.nonzero(count > 0)[0]
        codes = (
            np.stack(np.unravel_index(nz, spec.radices), axis=1).astype(np.int32)
            if len(nz)
            else np.zeros((0, len(spec.group_tags)), np.int32)
        )
    else:
        nz = np.asarray([0])
        codes = np.zeros((1, 0), np.int32)
    rep_key = None
    if rep_ts_acc is not None:
        rep_key = np.stack([rep_ts_acc[nz], rep_row_acc[nz]], axis=1)
    rep_vals = None
    if rep_tags and rep_key is not None and len(nz):
        rows = np.clip(rep_key[:, 1], 0, max(n - 1, 0))
        import contextlib as _cl

        with dict_state.lock if dict_state is not None else _cl.nullcontext():
            rep_vals = {}
            for t in rep_tags:
                varr = np.asarray(gd.values(t), dtype=object)
                rep_vals[t] = varr[chunks["tags_code"][t][rows]].tolist()
    elif rep_tags:
        rep_vals = {t: [] for t in rep_tags}

    field_stats = {}
    nonempty = count > 0
    if nonempty.any():
        for f in spec.fields:
            field_stats[f] = (
                float(mins[f][nonempty].min()),
                float(maxs[f][nonempty].max()),
            )
    return Partials(
        group_tags=spec.group_tags,
        codes=codes,
        group_values=group_values,
        count=count[nz],
        sums={f: sums[f][nz] for f in spec.fields},
        mins={f: mins[f][nz] for f in spec.fields},
        maxs={f: maxs[f][nz] for f in spec.fields},
        hist=None,
        field_stats=field_stats,
        rep_key=rep_key,
        rep_desc=rep_desc,
        rep_vals=rep_vals,
    )


def _source_lut(
    src: ColumnData, tag: str, gd: GlobalDicts, dict_state: Optional[DictState]
) -> np.ndarray:
    """local-code -> global-code LUT, cached by immutable part identity."""
    if dict_state is None:
        return gd.add_source(tag, list(src.dicts.get(tag, [])))
    if src.cache_key is None:
        with dict_state.lock:
            return gd.add_source(tag, list(src.dicts.get(tag, [])))
    # (source identity, tag, dict length): part dicts are immutable, but
    # memtable snapshots reuse one generation id while their dict grows
    # append-only — the length pins WHICH prefix this LUT covers, so a
    # grown dict gets a fresh (longer) LUT instead of a stale short one
    rk = (src.cache_key[1], tag, len(src.dicts.get(tag, ())))
    with dict_state.lock:
        if dict_state.dicts is not gd:
            # state was reset mid-query: codes from the old gd must not
            # enter the new remap cache
            return gd.add_source(tag, list(src.dicts.get(tag, [])))
        lut = dict_state.remaps.get(rk)
        if lut is None:
            lut = gd.add_source(tag, list(src.dicts.get(tag, [])))
            dict_state.remaps[rk] = lut
        return lut


def _gather_rows(
    sources: list[ColumnData],
    tags_code: list[str],
    fields: list[str],
    gd: GlobalDicts,
    begin_millis: int,
    end_millis: int,
    dict_state: Optional[DictState] = None,
    device_decode: bool = False,
) -> dict:
    """Concatenate sources with row-exact time filtering, global-code remap
    and version dedup (block pruning upstream is only block-granular).

    ``device_decode`` (ROADMAP item 3, ``BYDB_DEVICE_DECODE``): the
    gathered snapshot keeps tag columns in the COMPRESSED ship form —
    per-row narrow LOCAL codes (``tags_enc``), the per-source
    local->global LUTs (``tags_lut``) and a per-row source ordinal
    (``src_ord``) — instead of materializing the remapped i32 columns;
    the widen + remap run on device inside the plan kernel
    (ops.decode.decode_chunk).  Fields stay host-f64 (the exact host
    paths need them) but carry a ``fields_narrow`` dtype decision so the
    pad/ship stage can ship exact-int columns at i8/i16."""
    from banyandb_tpu_torch.storage import encoded as enc_mod

    ts_l, series_l, ver_l = [], [], []
    tc_l: dict[str, list] = {t: [] for t in tags_code}
    lut_l: dict[str, list] = {t: [] for t in tags_code}
    ord_l: list = []
    f_l: dict[str, list] = {f: [] for f in fields}
    n_src = 0
    for src in sources:
        if src.ts.size == 0:
            continue
        rng = (src.ts >= begin_millis) & (src.ts < end_millis)
        if not rng.any():
            continue
        nsel = int(rng.sum())
        ts_l.append(src.ts[rng])
        series_l.append(src.series[rng])
        ver_l.append(src.version[rng])
        if device_decode:
            ord_l.append(np.full(nsel, n_src, dtype=enc_mod.SRC_ORD_DTYPE))
        n_src += 1
        for t in tags_code:
            col = src.tags.get(t)
            if col is None:
                # Source predates this tag (schema evolution): its rows all
                # carry the empty value, same convention as merge/raw paths.
                if dict_state is not None:
                    with dict_state.lock:
                        absent = gd.absent_code(t)
                else:
                    absent = gd.absent_code(t)
                if device_decode:
                    # compressed form: a one-entry LUT row and local
                    # code 0 everywhere — the device remap lands the
                    # same global absent code the dense path bakes in
                    tc_l[t].append(np.zeros(nsel, dtype=np.int8))
                    lut_l[t].append(np.asarray([absent], dtype=np.int32))
                else:
                    tc_l[t].append(np.full(nsel, absent, dtype=np.int32))
            else:
                lut = _source_lut(src, t, gd, dict_state)
                codes = col[rng]
                if device_decode:
                    if lut.size:
                        w = enc_mod.code_dtype(lut.size)
                        tc_l[t].append(codes.astype(w, copy=False))
                        lut_l[t].append(lut)
                    else:
                        tc_l[t].append(np.zeros(nsel, dtype=np.int8))
                        lut_l[t].append(np.zeros(1, dtype=np.int32))
                else:
                    tc_l[t].append(
                        lut[codes] if lut.size else np.zeros(nsel, np.int32)
                    )
        for f in fields:
            col = src.fields.get(f)
            if col is None:
                f_l[f].append(np.zeros(nsel, dtype=np.float64))
            else:
                f_l[f].append(col[rng])

    if not ts_l:
        empty = dict(
            ts=np.zeros(0, np.int64),
            series=np.zeros(0, np.int64),
            fields={f: np.zeros(0, np.float64) for f in fields},
        )
        if device_decode:
            empty["tags_enc"] = {t: np.zeros(0, np.int8) for t in tags_code}
            empty["tags_lut"] = {t: () for t in tags_code}
            empty["src_ord"] = np.zeros(0, enc_mod.SRC_ORD_DTYPE)
            empty["fields_narrow"] = {f: np.dtype(np.int8) for f in fields}
        else:
            empty["tags_code"] = {
                t: np.zeros(0, np.int32) for t in tags_code
            }
        return empty

    ts = np.concatenate(ts_l)
    series = np.concatenate(series_l)
    version = np.concatenate(ver_l)
    # Global version dedup: keep the max-version row per (series, ts).
    keep = hostops.dedup_max_version(series, ts, version)

    out = dict(
        ts=ts[keep],
        series=series[keep],
        fields={f: np.concatenate(f_l[f])[keep] for f in fields},
    )
    if device_decode:
        # narrow gather: mixed per-source widths promote to the widest
        # (np.concatenate's int promotion), values untouched
        out["tags_enc"] = {
            t: np.concatenate(tc_l[t])[keep] for t in tags_code
        }
        out["tags_lut"] = {t: tuple(lut_l[t]) for t in tags_code}
        out["src_ord"] = np.concatenate(ord_l)[keep]
        out["fields_narrow"] = {
            f: enc_mod.narrow_int_dtype(out["fields"][f]) for f in fields
        }
    else:
        out["tags_code"] = {
            t: np.concatenate(tc_l[t])[keep] for t in tags_code
        }
    return out


def _host_tag_codes(
    cols: dict, tag: str, rows: Optional[np.ndarray] = None
) -> np.ndarray:
    """Global i32 codes for `tag` from a gathered snapshot, either ship
    form.  The compressed form (device_decode) materializes host-side
    only where the host genuinely needs values — the exact-f64 float
    path and per-group representative rows — via the same
    local->global LUT composition the device kernel applies."""
    if "tags_code" in cols:
        col = cols["tags_code"][tag]
        return col if rows is None else col[rows]
    codes = cols["tags_enc"][tag]
    src_ord = cols["src_ord"]
    if rows is not None:
        codes = codes[rows]
        src_ord = src_ord[rows]
    luts = cols["tags_lut"][tag]
    if not luts:
        return np.zeros(codes.shape[0], dtype=np.int32)
    offs = np.zeros(len(luts), dtype=np.int64)
    np.cumsum([len(lu) for lu in luts[:-1]], out=offs[1:])
    flat = np.concatenate([np.asarray(lu, np.int32) for lu in luts])
    return flat[offs[src_ord] + codes].astype(np.int32)


def _materialize_tag_codes(cols: dict, tags: Sequence[str]) -> dict:
    """Snapshot with dense i32 ``tags_code`` present (host-path input)."""
    if "tags_code" in cols:
        return cols
    out = dict(cols)
    out["tags_code"] = {t: _host_tag_codes(cols, t) for t in tags}
    return out


def _device_chunk(
    cols: dict,
    start: int,
    end: int,
    spec: PlanSpec,
    epoch: int,
    device: torch.device,
    ship_stats: Optional[list] = None,
    lut_cache: Optional[dict] = None,
) -> dict:
    """Pad one row range into the fixed chunk shape, ship to `device`.

    Compressed-form snapshots (``src_ord`` present, BYDB_DEVICE_DECODE)
    ship tag columns at their narrow local width plus the small [S, L]
    remap LUTs, and exact-int fields at i8/i16 — the device decode
    stage (ops.decode.decode_chunk, fused into the plan kernel) widens
    them back; PCIe traffic shrinks by the width ratio.
    ``ship_stats`` (list, GIL-atomic appends from the prefetch worker)
    collects (shipped_bytes, dense_bytes) per chunk for the decode span
    and the ``decode_ship_bytes_total`` counters — dense is what the
    decoded i32/f32 form would have shipped for the same columns.
    """
    n = end - start
    nb = spec.nrows
    compressed = "src_ord" in cols

    def pad(a: np.ndarray, dtype):
        out = np.zeros((nb,), dtype=dtype)
        out[:n] = a[start:end]
        return ship(out, device)

    valid = np.zeros((nb,), dtype=bool)
    valid[:n] = True
    # ts offsets relative to the global-min epoch keep int32 exact; range
    # masks are applied on absolute millis host-side during block pruning,
    # so the residual in-chunk mask only needs relative comparisons.
    ts_off = cols["ts"][start:end] - epoch
    ts = np.zeros((nb,), dtype=np.int64)
    ts[:n] = ts_off
    chunk = {
        "ts": ship(ts.astype(np.int32), device),
        "series": pad(cols["series"] % (2**31), np.int32),
        "valid": ship(valid, device),
    }
    shipped = dense = 0
    if compressed:
        from banyandb_tpu_torch.storage import encoded as enc_mod

        if spec.tags_code:
            chunk["tags_enc"] = {
                t: pad(cols["tags_enc"][t], cols["tags_enc"][t].dtype)
                for t in spec.tags_code
            }
            # the [S, L] remap LUTs are per part-batch, not per chunk:
            # pack + ship once and share the device buffer across the
            # staged loop's chunks (lut_cache lives for one reduction;
            # the single prefetch worker builds chunks sequentially)
            luts = {}
            for t in spec.tags_code:
                dev = None if lut_cache is None else lut_cache.get(t)
                if dev is None:
                    dev = ship(enc_mod.pack_luts(cols["tags_lut"][t]), device)
                    if lut_cache is not None:
                        lut_cache[t] = dev
                    shipped += dev.nbytes
                luts[t] = dev
            chunk["tags_lut"] = luts
            chunk["src_ord"] = pad(cols["src_ord"], enc_mod.SRC_ORD_DTYPE)
            shipped += chunk["src_ord"].nbytes
            for t in spec.tags_code:
                shipped += chunk["tags_enc"][t].nbytes
                dense += nb * 4
        fields_enc = {}
        fields_f32 = {}
        for f in spec.fields:
            ndt = cols["fields_narrow"].get(f)
            if ndt is not None:
                fields_enc[f] = pad(cols["fields"][f], ndt)
                shipped += fields_enc[f].nbytes
            else:
                fields_f32[f] = pad(cols["fields"][f], np.float32)
                shipped += fields_f32[f].nbytes
            dense += nb * 4
        if fields_enc:
            chunk["fields_enc"] = fields_enc
        chunk["fields"] = fields_f32
    else:
        chunk["tags_code"] = {
            t: pad(cols["tags_code"][t], np.int32) for t in spec.tags_code
        }
        chunk["fields"] = {
            f: pad(cols["fields"][f], np.float32) for f in spec.fields
        }
        dense = (len(spec.tags_code) + len(spec.fields)) * nb * 4
        shipped = dense
    # always present: the device-chunk cache is keyed by (gather, shape,
    # columns) and shared across plan variants — a chunk built for a
    # rep-less plan must still serve a rep-tracking one
    row = np.zeros((nb,), dtype=np.int32)
    row[:n] = np.arange(start, end, dtype=np.int32)
    chunk["row"] = ship(row, device)
    if ship_stats is not None:
        ship_stats.append((shipped, dense))
    return chunk


def combine_partials(partials: list[Partials]) -> Partials:
    """The 'reduce' phase: merge node partials by group tuple.

    Vectorized (VERDICT r1 weak #4): the only per-group Python work is
    the group-tuple -> union-index dict build (one dict op per incoming
    group); all numeric accumulation is ufunc scatter (np.add.at /
    minimum.at / maximum.at) over whole arrays — at 100k groups this is
    C-speed instead of 5+ Python float ops per group per field per node.

    Histograms only combine when every contributing partial used the same
    (hist_lo, hist_span) — the distributed two-pass guarantees this.
    """
    base = partials[0]
    want_hist = base.hist is not None
    want_rep = all(p.rep_key is not None for p in partials)
    rep_desc = base.rep_desc
    rep_tags = (
        sorted(base.rep_vals.keys())
        if all(p.rep_vals is not None for p in partials)
        else None
    )
    fields = sorted(base.sums.keys())

    index: dict[tuple, int] = {}
    maps: list[np.ndarray] = []
    for p in partials:
        if want_hist and (p.hist_lo != base.hist_lo or p.hist_span != base.hist_span):
            raise ValueError("histogram partials with mismatched ranges")
        idx = np.empty(len(p.groups), dtype=np.int64)
        for k, g in enumerate(p.groups):
            i = index.get(g)
            if i is None:
                i = index[g] = len(index)
            idx[k] = i
        maps.append(idx)

    K = len(index)
    count = np.zeros(K, dtype=np.float64)
    sums = {f: np.zeros(K, dtype=np.float64) for f in fields}
    mins = {f: np.full(K, np.inf, dtype=np.float64) for f in fields}
    maxs = {f: np.full(K, -np.inf, dtype=np.float64) for f in fields}
    hist = (
        np.zeros((K, _NUM_HIST_BUCKETS), dtype=np.float64)
        if want_hist
        else None
    )
    field_stats: dict[str, tuple[float, float]] = {}
    rep_key = (
        np.full((K, 2), -(2**62) if rep_desc else 2**62, dtype=np.int64)
        if want_rep
        else None
    )
    rep_vals = (
        {t: [None] * K for t in rep_tags} if rep_tags is not None else None
    )

    for p, idx in zip(partials, maps):
        np.add.at(count, idx, p.count)
        for f in fields:
            np.add.at(sums[f], idx, p.sums[f])
            np.minimum.at(mins[f], idx, p.mins[f])
            np.maximum.at(maxs[f], idx, p.maxs[f])
        if want_hist and p.hist is not None:
            np.add.at(hist, idx, p.hist)
        if rep_key is not None and p.rep_key is not None:
            # the scan-order winner's representative values follow its key
            for k, i in enumerate(idx.tolist()):
                pk = (int(p.rep_key[k, 0]), int(p.rep_key[k, 1]))
                cur = (int(rep_key[i, 0]), int(rep_key[i, 1]))
                better = pk > cur if rep_desc else pk < cur
                if better:
                    rep_key[i] = pk
                    if rep_vals is not None:
                        for t in rep_tags:
                            rep_vals[t][i] = p.rep_vals[t][k]
        for f, (lo, hi) in p.field_stats.items():
            old = field_stats.get(f)
            field_stats[f] = (
                min(lo, old[0]) if old else lo,
                max(hi, old[1]) if old else hi,
            )

    return Partials(
        group_tags=base.group_tags,
        groups=list(index.keys()),
        count=count,
        sums=sums,
        mins=mins,
        maxs=maxs,
        hist=hist,
        hist_lo=base.hist_lo,
        hist_span=base.hist_span,
        field_stats=field_stats,
        rep_key=rep_key,
        rep_desc=rep_desc,
        rep_vals=rep_vals,
    )


def finalize_partials(
    measure: Measure,
    request: QueryRequest,
    partials: list[Partials],
    dict_state: Optional[DictState] = None,
    span=None,
) -> QueryResult:
    """Combine + select + decode: the liaison-side tail of the query.

    `dict_state` (standalone fast path only) caches the per-tag rank LUTs
    that vectorize canonical group ordering."""
    import time as _time

    t_merge0 = _time.perf_counter()
    mspan = span.child("merge") if span is not None else None
    try:
        return _finalize_partials_inner(
            measure, request, partials, dict_state, mspan
        )
    finally:
        _H_MERGE.observe((_time.perf_counter() - t_merge0) * 1000)
        if mspan is not None:
            mspan.tag("partials", len(partials)).finish()


def _finalize_partials_inner(
    measure: Measure,
    request: QueryRequest,
    partials: list[Partials],
    dict_state: Optional[DictState],
    mspan,
) -> QueryResult:
    p = combine_partials(partials) if len(partials) != 1 else partials[0]
    if mspan is not None:
        mspan.tag("groups", len(p.count) if p.count is not None else 0)
    agg = request.agg
    group_tags = p.group_tags
    count = p.count
    nonempty = count > 0

    def agg_values(fn: str, field: str) -> np.ndarray:
        if fn == "count":
            return count
        if fn == "sum":
            return p.sums[field]
        if fn == "mean":
            return p.sums[field] / np.maximum(count, 1)
        if fn == "min":
            return p.mins[field]
        if fn == "max":
            return p.maxs[field]
        raise ValueError(f"unknown aggregate {fn}")

    result = QueryResult()
    if not group_tags:
        # One logical group, reported even when empty (global count == 0).
        group_ids = np.asarray([0]) if len(p.groups) else np.zeros(0, int)
        if not len(p.groups):
            p.groups = [()]
            count = np.zeros(1, dtype=np.float64)
            group_ids = np.asarray([0])
    else:
        # Canonical lexicographic order for group lists.  The dense
        # group-id layout is topology-dependent (dict-code order
        # standalone vs combine order in the cluster), so positional
        # order would (a) keep different groups per topology once LIMIT
        # truncates and (b) break prefix-stability between pages issued
        # with different limits.  A total order fixes both.  Top-N
        # queries skip it outright — selection below rebuilds group_ids
        # from the ranking metric.  The standalone codes path orders via
        # per-tag rank LUTs + np.lexsort (identical bytes order, no
        # O(G log G) Python compares); combined tuple partials keep the
        # Python key sort (the distributed combine plane's group count
        # crossed the wire already).
        group_ids = np.nonzero(nonempty)[0]
        if request.top:
            pass  # order irrelevant: Top-N selection replaces group_ids
        elif p.rep_key is not None and group_ids.size:
            # First-appearance scan order (the reference's groupLst:
            # groups emit in the order their first row appears in the
            # ts-asc — or ts-desc under ORDER BY time DESC — scan, i.e.
            # by per-group min/max (ts, row) key).
            k = p.rep_key[group_ids]
            if p.rep_desc:
                order = np.lexsort((-k[:, 1], -k[:, 0]))
            else:
                order = np.lexsort((k[:, 1], k[:, 0]))
            group_ids = group_ids[order]
        elif p.codes is not None and group_ids.size:
            keys = []
            for i, t in enumerate(group_tags):
                vals = p.group_values[t]
                lut = (
                    dict_state.rank_lut(t, vals)
                    if dict_state is not None
                    else _build_rank_lut(vals)
                )
                keys.append(lut[p.codes[group_ids, i]])
            group_ids = group_ids[np.lexsort(tuple(reversed(keys)))]
        else:
            group_ids = np.asarray(
                sorted(group_ids.tolist(), key=lambda i: p.groups[i]),
                dtype=int,
            )

    # Top-N selection narrows the group id set.  Ranking field is
    # top.field_name; the ranking function is the request's aggregate when
    # it composes (sum/count/min/max/mean), else mean (percentile ranks
    # don't compose across groups — reference TopN is mean-of-field too).
    if request.top:
        fn = (
            agg.function
            if agg and agg.function != "percentile" and agg.field_name == request.top.field_name
            else "mean"
        )
        metric = agg_values(fn, request.top.field_name)
        k = min(request.top.number, int(nonempty.sum()))
        if k <= 0 or metric.size == 0:
            group_ids = np.zeros(0, dtype=int)
        else:
            asc = request.top.field_value_sort == "asc"
            metric = np.where(nonempty, metric, np.inf if asc else -np.inf)
            order = np.argsort(metric if asc else -metric, kind="stable")[:k]
            # Only the k-th-value boundary ties decide MEMBERSHIP of the
            # top set; resolve exactly those by group key so selection is
            # replay-identical across topologies without paying a Python
            # sort over all G groups (vectorized argsort does the bulk).
            kth_val = metric[order[k - 1]]
            head = [int(i) for i in order if metric[i] != kth_val]
            tied = sorted(
                (
                    int(i)
                    for i in np.nonzero((metric == kth_val) & nonempty)[0]
                ),
                key=p.group_key,
            )
            group_ids = np.asarray(head + tied[: k - len(head)], dtype=int)

    # offset/limit paging over the (possibly top-N-ranked) group list —
    # offset semantics match the reference's QueryRequest.offset
    off = request.offset or 0
    if off:
        group_ids = group_ids[off:]
    group_ids = group_ids[: request.limit] if request.limit else group_ids

    # Decode group tuples (bytes) to client values via the schema types.
    from banyandb_tpu_torch.query import filter as qfilter

    for g in group_ids:
        raw = p.group_key(int(g))
        result.groups.append(
            tuple(
                qfilter.decode_tag_value(v, measure.tag(t).type)
                for t, v in zip(group_tags, raw)
            )
        )
    if p.rep_vals:
        # representative (first-scanned row) values for projected-but-
        # not-grouped tags, aligned with result.groups
        for t, vals in p.rep_vals.items():
            result.rep_tags[t] = [
                (
                    qfilter.decode_tag_value(vals[int(g)], measure.tag(t).type)
                    if vals[int(g)] is not None
                    else None
                )
                for g in group_ids
            ]

    if agg:
        if agg.function == "percentile":
            qs = list(agg.quantiles or (0.5,))
            result.values[f"percentile({agg.field_name})"] = _invert_histogram(
                p.hist, group_ids, qs, p.hist_lo, p.hist_span
            )
        else:
            v = agg_values(agg.function, agg.field_name)[group_ids]
            result.values[f"{agg.function}({agg.field_name})"] = v.tolist()
    result.values["count"] = count[group_ids].tolist()
    return result


def _invert_histogram(
    hist: Optional[np.ndarray],
    group_ids: np.ndarray,
    qs: list[float],
    lo: float,
    span: float,
) -> list[list[float]]:
    """Vectorized CDF inversion over all selected groups at once — the
    same interpolation the device kernel uses
    (ops/percentile.py group_percentile_histogram), on [G, B] arrays
    instead of a per-group per-quantile Python loop."""
    width = span / _NUM_HIST_BUCKETS
    ids = np.asarray(group_ids, dtype=np.int64)
    if ids.size == 0:
        return []
    if hist is None:
        return [[lo] * len(qs) for _ in range(ids.size)]
    valid = ids < len(hist)
    counts = np.zeros((ids.size, hist.shape[1]), dtype=np.float64)
    counts[valid] = hist[ids[valid]]
    cdf = np.cumsum(counts, axis=1)  # [G, B]
    total = cdf[:, -1:]  # [G, 1]
    q = np.asarray(qs, dtype=np.float64)[None, :]  # [1, Q]
    target = np.clip(np.ceil(q * total), 1.0, np.maximum(total, 1.0))
    hit = np.argmax(cdf[:, None, :] >= target[:, :, None], axis=2)  # [G, Q]
    cdf_at = np.take_along_axis(cdf, hit, axis=1)
    cnt_at = np.take_along_axis(counts, hit, axis=1)
    prev = cdf_at - cnt_at
    frac = np.where(cnt_at > 0, (target - prev) / np.maximum(cnt_at, 1.0), 0.0)
    est = lo + (hit + np.clip(frac, 0.0, 1.0)) * width
    est = np.where(total > 0, est, lo)
    return est.tolist()
