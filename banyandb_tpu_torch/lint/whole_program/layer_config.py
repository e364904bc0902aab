"""The checked-in layer policy for banyandb_tpu_torch (SURVEY.md §1, L0-L6).

The port's own total map: the reference's (banyandb_tpu/lint/
whole_program/layer_config.py) plus the modules only the port has.

This file IS the architecture decision record the layering analyzer
enforces.  Three tables:

- ``CONFIG.layers`` / ``CONFIG.may_import``: the bottom-up layer order
  and, per layer, exactly which lower layers it may import.  Anything
  else is an upward or skip-layer violation.
- ``CONFIG.layer_of``: dotted module-prefix -> layer, longest prefix
  wins.  The map is TOTAL: a module no prefix covers fails the gate
  (tests/test_whole_program.py pins this as a golden test), so adding a
  top-level module forces a layering decision in this file.
- ``BASELINE``: the ratchet.  Pre-existing violations, tolerated until
  fixed; new violations fail immediately, and entries whose violation
  disappeared fail as stale so the list only shrinks.

Mapping notes (where the build deviates from a naive directory map):

- ``api/model.py`` + ``api/schema.py`` are the shared data-model and
  schema-registry *types* (SURVEY's api/proto model plane) — imported by
  storage, engines and query alike, so they live in L1-substrate, not in
  the L5 entry surface.  Generated ``api/pb`` protos are leaf data: L1.
- ``ops/blocks.py`` is the padded columnar block model the storage
  substrate builds on (the 8192-row part-block analog); it sits in
  L1-substrate while the rest of ops/ (kernels) is L3-exec.
- ``server.py``/``cluster_server.py``/``mcp_server.py``/``run.py``/
  ``cli.py`` are role *composition*: they wire admin units, engines and
  the API surface into one process (pkg/cmdsetup analog) and therefore
  live in the top L6-adminops layer with admin/ and lint/.
- The port's own modules: ``backend`` (device resolution, the one place
  an entry point picks CUDA or the CPU) is platform, L0;
  ``ops/hopper_kernels.py`` (the CUDA kernels' build, load and
  wrappers) is exec with the rest of ops/, L3, while ``ops/blocks.py``
  stays in L1; ``lint/kernel/op_audit.py`` (the ATen-op walk, the
  reference's jaxpr audit) is tooling, L6.
- Function-local and ``if TYPE_CHECKING:`` imports are deliberate lazy
  boundaries and create no edges (e.g. cluster/data_node reaching up to
  admin diagnostics at runtime, cluster/schema_plane reaching the
  grpc_server barrier kinds).
"""

from __future__ import annotations

from banyandb_tpu_torch.lint.whole_program.layers import LayerConfig

PACKAGE = "banyandb_tpu_torch"

L0 = "L0-platform"
L1 = "L1-substrate"
L2 = "L2-engines"
L3 = "L3-exec"
L4 = "L4-fabric"
L5 = "L5-api"
L6 = "L6-adminops"

CONFIG = LayerConfig(
    layers=(L0, L1, L2, L3, L4, L5, L6),
    # Per-layer import policy (SURVEY §1 "Below it" column).  Every layer
    # may reach L0 (platform) and L1 (substrate + model types); query
    # deliberately skips the engines layer (it consumes decoded
    # ColumnData, not engine objects), and the fabric deliberately skips
    # nothing below it — it ships engine parts, runs device plans and
    # serializes model types.
    may_import={
        L0: (),
        L1: (L0,),
        L2: (L1, L0),
        L3: (L1, L0),  # exec consumes substrate directly, never engines
        L4: (L3, L2, L1, L0),
        L5: (L4, L3, L2, L1, L0),
        L6: (L5, L4, L3, L2, L1, L0),
    },
    layer_of={
        # L0 — platform utilities
        "": L0,  # package root __init__
        "utils": L0,
        "config": L0,
        # device resolution: every entry point's CUDA-or-CPU choice
        "backend": L0,
        # self-observability primitives (tracer/metrics/recorder/prom):
        # dependency-free by design so storage, engines, query and the
        # fabric can all instrument themselves without upward edges
        "obs": L0,
        # multi-tenant QoS plane: tenancy + admission primitives consulted
        # by storage (cache partitions), query (streamagg caps) and the
        # serving roles alike — platform, like obs (its ServerBusy shed
        # exception is reached lazily, so no upward edge to admin/)
        "qos": L0,
        # L1 — storage substrate + shared model/schema types
        "storage": L1,
        "index": L1,
        "api.model": L1,
        "api.schema": L1,
        "api.pb": L1,
        "ops.blocks": L1,
        # L2 — data-model engines
        "models": L2,
        # L3 — device execution (query plans, kernels, mesh)
        "query": L3,
        "ops": L3,
        # the CUDA kernels' build, load and wrappers (explicit: the
        # device path's only hand-written kernels)
        "ops.hopper_kernels": L3,
        "parallel": L3,
        "bydbql": L3,
        "flow": L3,
        # L4 — cluster fabric
        "cluster": L4,
        # L5 — API surface (wire codecs, gRPC/HTTP servers, auth)
        "api": L5,
        # L6 — admin/ops + process composition + tooling
        "admin": L6,
        "server": L6,
        "cluster_server": L6,
        "mcp_server": L6,
        "run": L6,
        "cli": L6,
        # the driver entry point and the operating harnesses (load/SLO,
        # replay soak, chaos): they compose servers, clusters and meshes
        "entry": L6,
        "harness": L6,
        "lint": L6,
        # the ATen-op walk of the kernel audit (the jaxpr audit's
        # counterpart)
        "lint.kernel.op_audit": L6,
        # bdsan runtime sanitizers: tooling like lint/ (its static lock
        # model loads lint.whole_program lazily — no import-time edge)
        "sanitize": L6,
    },
)

# The ratchet: every entry is a pre-existing, known upward edge.  Do not
# add entries for new code — fix the layering instead.  Removing the
# violation requires removing the entry (a lingering entry fails as
# stale).
#
# models -> query: the engines call the device executors directly
# (engine.query() builds ColumnData then runs the plan).  The clean shape
# is an executor interface the engines depend on downward — tracked as a
# refactor, not re-baselined.
BASELINE = frozenset(
    {
        "banyandb_tpu_torch.models.measure -> banyandb_tpu_torch.query.filter",
        "banyandb_tpu_torch.models.measure -> banyandb_tpu_torch.query.measure_exec",
        "banyandb_tpu_torch.models.stream -> banyandb_tpu_torch.query.filter",
        "banyandb_tpu_torch.models.stream -> banyandb_tpu_torch.query.measure_exec",
        "banyandb_tpu_torch.models.trace -> banyandb_tpu_torch.query.measure_exec",
    }
)
