"""Logical plan trees over the fused-kernel executors.

Analog of the reference's logical planner (pkg/query/logical:
Plan/UnresolvedPlan interfaces, per-model analyzers building
IndexScan -> GroupBy/Agg -> Top -> Merge/Limit trees,
measure_analyzer.go:70 local / :170 distributed).  Execution stays
fused — one per-chunk device body per PlanSpec (measure_exec) is the
whole point — so the plan tree is the *decision and explanation* layer
above it:

- analyzers own the routing decisions that used to live inline in the
  engines (index-mode short-circuit, aggregate vs raw scan, order-by-
  index fork, TopN re-rank, distributed merge shape);
- every node renders into the in-band query trace (the reference
  returns plan strings in QueryResponse the same way);
- the leaves name the exact executor entry they lower onto, so the
  explain output is an honest description of what will run.

The tree deliberately does NOT re-implement row-operator execution: a
plan node's execute() calls the fused executor seam it describes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from banyandb_tpu_torch.api.model import QueryRequest


@dataclasses.dataclass
class PlanNode:
    """One node: kind + human-readable props + children (logical/interface.go
    Plan analog; Children()/Schema() collapsed into this dataclass)."""

    kind: str
    props: dict = dataclasses.field(default_factory=dict)
    children: list["PlanNode"] = dataclasses.field(default_factory=list)
    # the executor closure this subtree lowers onto (leaf-bound; inner
    # nodes usually delegate to their child's executor)
    _execute: Optional[Callable] = None

    def explain(self, indent: int = 0) -> str:
        """Render the subtree (the reference's plan String() — these
        strings ride the in-band query trace)."""
        pad = "  " * indent
        props = ", ".join(
            f"{k}={v}" for k, v in self.props.items() if v not in ("", None, ())
        )
        line = f"{pad}{self.kind}" + (f" [{props}]" if props else "")
        return "\n".join(
            [line] + [c.explain(indent + 1) for c in self.children]
        )

    def execute(self, *a, **kw):
        node = self
        while node._execute is None:
            if not node.children:
                raise RuntimeError(f"plan node {self.kind} has no executor")
            node = node.children[0]
        return node._execute(*a, **kw)

    def find(self, kind: str) -> Optional["PlanNode"]:
        if self.kind == kind:
            return self
        for c in self.children:
            hit = c.find(kind)
            if hit is not None:
                return hit
        return None

    def leaf(self) -> "PlanNode":
        node = self
        while node.children:
            node = node.children[0]
        return node


def _time_props(req: QueryRequest) -> dict:
    tr = req.time_range
    return {"range": f"[{tr.begin_millis},{tr.end_millis})"}


def _criteria_summary(criteria) -> str:
    """Compact criteria rendering for explain output."""
    if criteria is None:
        return ""
    if hasattr(criteria, "op") and hasattr(criteria, "left"):  # LogicalExpression
        return (
            f"({_criteria_summary(criteria.left)} {criteria.op.upper()} "
            f"{_criteria_summary(criteria.right)})"
        )
    val = criteria.value
    if isinstance(val, (list, tuple)) and len(val) > 3:
        val = f"[{len(val)} values]"
    return f"{criteria.name} {criteria.op} {val!r}"


# -- measure ----------------------------------------------------------------


class _Conflict:
    """Sentinel: a criteria subtree whose entity-literal combinations
    are unsatisfiable (parseEntities nil in the reference)."""


_CONFLICT = _Conflict()


def check_entity_combinations(measure, criteria) -> None:
    """Reject criteria whose ENTITY-tag literal algebra is
    unsatisfiable (pkg/query/logical/parser.go parseEntities analog:
    the reference returns nil for conflicting AND-of-OR entity
    literals and fails the query; evaluating such a tree as plain mask
    algebra would instead scan and return rows).

    The algebra per subtree is a map {entity tag -> possible value
    set} (absent = unconstrained):

    - a leaf ``eq``/``in`` on an entity tag constrains that tag to its
      literal set; every other leaf is unconstrained;
    - AND intersects per-tag sets — an EMPTY intersection makes the
      subtree a conflict;
    - OR unions per-tag sets when both branches constrain a tag and
      drops the constraint otherwise; a conflicting branch poisons the
      OR (the reference's nil propagates up).

    Raises ValueError (→ INVALID_ARGUMENT on the wire) on conflict.
    """
    from banyandb_tpu_torch.api.model import Condition, LogicalExpression

    entity = set(
        getattr(getattr(measure, "entity", None), "tag_names", ()) or ()
    )
    if criteria is None or not entity:
        return

    def lit_bytes(v):
        from banyandb_tpu_torch.query.measure_exec import _tag_value_bytes

        try:
            return _tag_value_bytes(v)
        except TypeError:
            return None

    def walk(node):
        if node is None:
            return {}
        if isinstance(node, Condition):
            if node.name in entity and node.op == "eq":
                b = lit_bytes(node.value)
                return {} if b is None else {node.name: {b}}
            if node.name in entity and node.op == "in":
                vals = {lit_bytes(v) for v in node.value}
                vals.discard(None)
                return {node.name: vals} if vals else {}
            return {}
        assert isinstance(node, LogicalExpression), node
        left, right = walk(node.left), walk(node.right)
        if node.op == "and":
            if left is _CONFLICT or right is _CONFLICT:
                return _CONFLICT
            out = dict(left)
            for tag, vals in right.items():
                if tag in out:
                    inter = out[tag] & vals
                    if not inter:
                        return _CONFLICT
                    out[tag] = inter
                else:
                    out[tag] = vals
            return out
        # or
        if left is _CONFLICT or right is _CONFLICT:
            return _CONFLICT
        out = {}
        for tag in set(left) & set(right):
            out[tag] = left[tag] | right[tag]
        return out

    if walk(criteria) is _CONFLICT:
        raise ValueError(
            "unsatisfiable entity criteria: conflicting entity-tag "
            "literals under AND (no entity combination can match)"
        )


def analyze_measure(measure, req: QueryRequest, *, execute=None) -> PlanNode:
    """Local measure plan (measure_analyzer.go:70 Analyze analog).

    Owns the routing decisions: index-mode short-circuit (query.go:506),
    aggregate pipeline vs raw projection scan, TopN re-rank — and the
    reference's entity-combination rejection (conflicting entity
    literals raise before anything executes).
    execute: closure the leaf lowers onto (engine-provided).
    """
    check_entity_combinations(measure, req.criteria)
    if getattr(measure, "index_mode", False):
        scan = PlanNode(
            "IndexModeScan",
            {
                "measure": f"{measure.group}.{measure.name}",
                **_time_props(req),
                "criteria": _criteria_summary(req.criteria),
                "via": "series_index.SearchWithoutSeries",
            },
            _execute=execute,
        )
    else:
        scan = PlanNode(
            "IndexScan",
            {
                "measure": f"{measure.group}.{measure.name}",
                **_time_props(req),
                "criteria": _criteria_summary(req.criteria),
                "projection": ",".join(
                    (*req.tag_projection, *req.field_projection)
                ),
                "via": "parts+memtables -> device chunk",
            },
            _execute=execute,
        )
    root = scan
    # top WITHOUT group-by/agg ranks raw data points by field value
    # (measure_top.go row-level top) — a raw scan concern, not the
    # grouped kernel's
    if req.agg or req.group_by:
        root = PlanNode(
            "GroupByAggregate",
            {
                "group_by": ",".join(req.group_by.tag_names)
                if req.group_by
                else "",
                "agg": f"{req.agg.function}({req.agg.field_name})"
                if req.agg
                else "",
                "kernel": "fused PlanSpec (mixed-radix keys, "
                "group_reduce auto)",
            },
            children=[root],
        )
        if req.top:
            root = PlanNode(
                "Top",
                {
                    "n": req.top.number,
                    "field": req.top.field_name,
                    "sort": req.top.field_value_sort,
                    "kernel": "device top-k",
                },
                children=[root],
            )
    else:
        order = (
            f"index:{req.order_by_tag} {req.order_by_dir}"
            if req.order_by_tag
            else (f"ts {req.order_by_ts}" if req.order_by_ts else "")
        )
        if order:
            root = PlanNode("Sort", {"order": order}, children=[root])
    if req.offset or req.limit:
        root = PlanNode(
            "OffsetLimit",
            {"offset": req.offset, "limit": req.limit},
            children=[root],
        )
    return root


def analyze_measure_distributed(
    measure, req: QueryRequest, nodes: list[str], *, execute=None
) -> PlanNode:
    """Distributed plan (measure_analyzer.go:170 DistributedAnalyze +
    measure_plan_distributed.go:296 Broadcast): scatter the local plan to
    every data node, combine partials at the liaison."""
    local = analyze_measure(measure, req)
    return PlanNode(
        "DistributedMerge",
        {
            "nodes": len(nodes),
            "fan_out": ",".join(sorted(nodes)[:8]),
            "combine": "host combine_partials (f64 Kahan)",
            "replica_dedup": "version-max per (series, ts)",
        },
        children=[local],
        _execute=execute,
    )


# -- stream -----------------------------------------------------------------


def analyze_stream(stream, req: QueryRequest, *, execute=None) -> PlanNode:
    """Stream plan (stream_analyzer.go:50,103): the analyzer picks the
    element-index path vs the order-by-index fork."""
    scan = PlanNode(
        "ElementScan",
        {
            "stream": f"{stream.group}.{stream.name}",
            **_time_props(req),
            "criteria": _criteria_summary(req.criteria),
            "via": "element index (TYPE_INVERTED) + skipping blooms "
            "(TYPE_SKIPPING) -> device mask",
        },
        _execute=execute,
    )
    if req.order_by_tag:
        root = PlanNode(
            "SortByIndex",
            {"tag": req.order_by_tag, "dir": req.order_by_dir},
            children=[scan],
        )
    else:
        root = PlanNode(
            "Sort", {"order": f"ts {req.order_by_ts or 'desc'}"}, children=[scan]
        )
    return PlanNode(
        "OffsetLimit",
        {"offset": req.offset, "limit": req.limit},
        children=[root],
    )


# -- trace ------------------------------------------------------------------


def analyze_trace(
    trace_schema,
    *,
    trace_id: str = "",
    order_by_key: bool = False,
    limit: int = 0,
    execute=None,
) -> PlanNode:
    """Trace plan (trace_analyzer.go:35,104): trace-id point lookup rides
    the part-level bloom; ordered retrieval rides the sidx key ranges."""
    if trace_id:
        scan = PlanNode(
            "TraceIDScan",
            {
                "trace": f"{trace_schema.group}.{trace_schema.name}",
                "trace_id": trace_id,
                "via": "traceID.filter bloom -> span store",
            },
            _execute=execute,
        )
    else:
        scan = PlanNode(
            "SidxScan",
            {
                "trace": f"{trace_schema.group}.{trace_schema.name}",
                "order": "sidx key " + ("asc" if order_by_key else "desc"),
                "via": "sidx parts k-way merge (key-bound pruning)",
            },
            _execute=execute,
        )
    if limit:
        return PlanNode("Limit", {"n": limit}, children=[scan])
    return scan
