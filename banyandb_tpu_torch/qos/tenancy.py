"""Tenant identity: the group namespace is the tenant dimension.

The reference's model already scopes every resource by group; multi-
tenant deployments name groups ``<tenant><sep><rest>`` (default
separator ``.``: ``acme.metrics`` belongs to tenant ``acme``).  A group
without the separator — every group this repo ever created before the
QoS plane — maps to the ``default`` tenant, so untenanted traffic is
byte-identical to pre-QoS behavior (the parity pin in tests/test_qos.py).

``tenant_scope``/``current_tenant`` carry the active tenant down the
query/ingest call stack on a contextvar, so layers that must partition
per tenant (the serving cache) need no signature changes.
"""

from __future__ import annotations

import contextlib
import contextvars
import os

DEFAULT_TENANT = "default"

_current: contextvars.ContextVar[str] = contextvars.ContextVar(
    "bydb_tenant", default=DEFAULT_TENANT
)


def tenant_separator() -> str:
    from banyandb_tpu_torch.utils.envflag import env_str

    return env_str("BYDB_QOS_TENANT_SEP", ".") or "."


def tenant_of_group(group: str) -> str:
    """Group name -> tenant: the namespace prefix before the separator;
    groups without one (all pre-QoS groups) are the default tenant."""
    if not group:
        return DEFAULT_TENANT
    sep = tenant_separator()
    head, found, _rest = group.partition(sep)
    if not found or not head:
        return DEFAULT_TENANT
    return head


def current_tenant() -> str:
    return _current.get()


@contextlib.contextmanager
def tenant_scope(tenant: str):
    """Bind the active tenant for the enclosed work (thread-local via
    contextvars; restored on exit even across exceptions)."""
    token = _current.set(tenant or DEFAULT_TENANT)
    try:
        yield tenant
    finally:
        _current.reset(token)
