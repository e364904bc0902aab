"""Distributed execution over a grid of device slots.

The reference scales queries by scatter-gather over data nodes with proto
partial-aggregate exchange (pkg/query/logical/measure/measure_plan_distributed.go:296,
docs/concept/distributed-measure-aggregation.md).  Here the same map-reduce
shape rides a ('shard', 'seg') mesh of device slots: each slot scans its
slice of the rows on its device and the partials combine in one
fixed-order reduction (sum, amin, amax) on the first slot's device, not
a proto hop.
"""

from banyandb_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_axis_size
from banyandb_tpu_torch.parallel.dist_exec import (
    DistPlan,
    distributed_aggregate,
    stack_shard_chunks,
)
