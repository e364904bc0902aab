"""Query & write request/response models.

Parity with measure/v1 QueryRequest + model/v1 Criteria/Condition/TimeRange
(api/proto/banyandb/measure/v1/query.proto, model/v1/query.proto), plus a
first-class ``percentile`` aggregate (SURVEY.md §7 step 1 — the reference
only post-processes percentiles client-side).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Union


@dataclass(frozen=True)
class TimeRange:
    """Half-open [begin, end) in epoch millis (model/v1 TimeRange analog)."""

    begin_millis: int
    end_millis: int

    def overlaps(self, lo: int, hi: int) -> bool:
        return self.begin_millis < hi and lo < self.end_millis


@dataclass(frozen=True)
class Condition:
    """model/v1 Condition: one tag predicate."""

    name: str
    op: str  # eq | ne | lt | le | gt | ge | in | not_in | having | match
    value: object
    # MATCH options (model/v1 Condition.MatchOption): "and" requires
    # every analyzed query token to hit; analyzer overrides the index
    # rule's analyzer
    match_op: str = "or"
    match_analyzer: str = ""


@dataclass(frozen=True)
class LogicalExpression:
    op: str  # and | or
    left: "Criteria"
    right: "Criteria"


Criteria = Union[Condition, LogicalExpression]


@dataclass(frozen=True)
class GroupBy:
    tag_names: tuple[str, ...]
    field_name: str = ""


@dataclass(frozen=True)
class Aggregation:
    function: str  # sum | count | min | max | mean | percentile
    field_name: str
    # percentile-only extras
    quantiles: tuple[float, ...] = ()


@dataclass(frozen=True)
class Top:
    number: int
    field_name: str
    field_value_sort: str = "desc"  # desc | asc


@dataclass(frozen=True)
class QueryRequest:
    """measure/v1 QueryRequest analog."""

    groups: tuple[str, ...]
    name: str
    time_range: TimeRange
    criteria: Optional[Criteria] = None
    tag_projection: tuple[str, ...] = ()
    field_projection: tuple[str, ...] = ()
    group_by: Optional[GroupBy] = None
    agg: Optional[Aggregation] = None
    top: Optional[Top] = None
    limit: int = 100
    offset: int = 0
    order_by_ts: str = ""  # "" | asc | desc
    # order-by-index for retrieval paths (model/v1 QueryOrder with an
    # index rule naming a tag): sort rows by this tag's value instead of
    # the timestamp; direction in order_by_dir
    order_by_tag: str = ""
    order_by_dir: str = "asc"  # asc | desc (applies to order_by_tag)
    trace: bool = False  # in-band query tracing
    stages: tuple[str, ...] = ()
    # family-structured tag projection from the wire ((family, (tags..)),
    # ...): responses group projected tags under the REQUESTED family
    # names (a measure can declare non-"default" families, e.g.
    # storage_only in service_latency_minute)
    tag_families_projection: tuple = ()


@dataclass(frozen=True)
class DataPointValue:
    """One ingested data point (measure/v1 DataPointValue analog)."""

    ts_millis: int
    tags: dict[str, object]
    fields: dict[str, object]
    version: int = 0


@dataclass(frozen=True)
class WriteRequest:
    group: str
    name: str
    points: tuple[DataPointValue, ...]


@dataclass
class QueryResult:
    """Aggregated response: either grouped aggregates or raw data points."""

    # group tuples (tag values) aligned with per-agg value arrays
    groups: list[tuple] = field(default_factory=list)
    values: dict[str, list] = field(default_factory=dict)
    data_points: list[dict] = field(default_factory=list)
    # representative values for projected-but-not-grouped tags: each
    # grouped output row carries the tag values of the group's FIRST row
    # in scan order (the reference's aggGroupIterator copies the first
    # fed data point's TagFamilies, measure_plan_aggregation.go:286)
    rep_tags: dict[str, list] = field(default_factory=dict)
    trace: Optional[dict] = None
    # graceful degradation markers (docs/robustness.md): True when the
    # liaison answered from a PARTIAL replica set — rows covered by the
    # named unreachable nodes are missing, everything present is exact
    degraded: bool = False
    unavailable_nodes: list = field(default_factory=list)
