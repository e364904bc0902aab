"""Multi-tenant QoS plane (docs/robustness.md "Multi-tenant QoS").

Tenant identity derives from the group namespace (``tenancy``); the
admission plane (``plane``) enforces per-tenant ingest token buckets and
weighted query concurrency caps, shedding with the existing retryable
``ServerBusy`` wire kind.  Sits at the platform layer (like ``obs``) so
storage, query and the fabric can all consult it without upward edges.
"""

from banyandb_tpu_torch.qos.plane import QosPlane, TenantLimits, global_qos, reset_qos
from banyandb_tpu_torch.qos.tenancy import (
    DEFAULT_TENANT,
    current_tenant,
    tenant_of_group,
    tenant_scope,
)

__all__ = [
    "DEFAULT_TENANT",
    "QosPlane",
    "TenantLimits",
    "current_tenant",
    "global_qos",
    "reset_qos",
    "tenant_of_group",
    "tenant_scope",
]
