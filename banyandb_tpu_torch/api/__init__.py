"""API surface: schema objects, query/write models, and the registry.

Dataclass mirror of the reference's proto API (api/proto/banyandb/**) —
same vocabulary (Group/ResourceOpts, Measure/TagSpec/FieldSpec/Entity,
IndexRule, QueryRequest/Criteria/Condition), new wire (in-process now,
gRPC liaison later).
"""

from banyandb_tpu_torch.api.schema import (
    Catalog,
    TagType,
    FieldType,
    TagSpec,
    FieldSpec,
    Entity,
    Group,
    ResourceOpts,
    IntervalRule,
    Measure,
    Stream,
    Trace,
    PropertySchema,
    IndexRule,
    TopNAggregation,
    SchemaRegistry,
)
from banyandb_tpu_torch.api.model import (
    TimeRange,
    Condition,
    Criteria,
    LogicalExpression,
    QueryRequest,
    Aggregation,
    GroupBy,
    Top,
    DataPointValue,
    WriteRequest,
)
