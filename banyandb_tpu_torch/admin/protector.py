"""Memory admission control (banyand/protector/protector.go:55,97,108
analog).

Writes acquire resources against a memory budget derived from the cgroup
limit (pkg/cgroups analog) or an explicit cap; over-budget acquisition
raises ServerBusy after a bounded backoff — ingestion sheds load instead
of OOMing the node.  The same gate can also track a logical
device-memory budget for device-resident query state.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Optional


class ServerBusy(RuntimeError):
    """ErrServerBusy (banyand/queue/queue.go:45 analog)."""


def cgroup_memory_limit() -> Optional[int]:
    """Read the v2 (then v1) cgroup memory limit, None when unlimited."""
    for path, parse in (
        ("/sys/fs/cgroup/memory.max", lambda s: None if s == "max" else int(s)),
        (
            "/sys/fs/cgroup/memory/memory.limit_in_bytes",
            lambda s: None if int(s) >= 2**60 else int(s),
        ),
    ):
        try:
            return parse(Path(path).read_text().strip())
        except (OSError, ValueError):
            continue
    return None


def process_rss() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * 4096


class MemoryProtector:
    def __init__(
        self,
        *,
        limit_bytes: Optional[int] = None,
        limit_ratio: float = 0.8,
        hbm_limit_bytes: Optional[int] = None,
        max_wait_s: float = 2.0,
        tenant_limit_fn=None,
    ):
        cg = cgroup_memory_limit()
        self.limit = limit_bytes or (int(cg * limit_ratio) if cg else None)
        self.hbm_limit = hbm_limit_bytes
        self.max_wait_s = max_wait_s
        # per-tenant in-flight write-byte budgets (docs/robustness.md
        # "Multi-tenant QoS"): tenant -> byte cap, 0/None = unlimited.
        # Injected (usually qos.QosPlane.inflight_limit) so the gate has
        # no upward config dependency.
        self.tenant_limit_fn = tenant_limit_fn
        self._lock = threading.Lock()
        self._reserved = 0
        self._hbm_reserved = 0
        self._tenant_reserved: dict[str, int] = {}

    def _tenant_limit(self, tenant: Optional[str]) -> int:
        if tenant is None or self.tenant_limit_fn is None:
            return 0
        try:
            return int(self.tenant_limit_fn(tenant) or 0)
        except Exception:  # noqa: BLE001 - a config error must not gate writes
            return 0

    def acquire(
        self, size_bytes: int, *, hbm: bool = False,
        tenant: Optional[str] = None,
    ) -> None:
        """Block (with backoff) until the budget admits `size_bytes`,
        else raise ServerBusy (AcquireResource analog).  `tenant`
        additionally charges the per-tenant in-flight budget: one
        tenant's write burst sheds against its OWN cap while the node's
        global budget still has room for everyone else."""
        t_limit = self._tenant_limit(tenant)
        if t_limit and size_bytes > t_limit:
            # no amount of draining admits this acquisition: shed NOW
            # instead of pinning a handler thread through the whole
            # backoff window on every doomed retry
            from banyandb_tpu_torch.obs.metrics import global_meter

            global_meter().counter_add(
                "qos_inflight_shed", 1.0, {"tenant": tenant}
            )
            raise ServerBusy(
                f"tenant {tenant!r} write of {size_bytes}B exceeds its "
                f"whole in-flight budget ({t_limit}B)"
            )
        deadline = time.monotonic() + self.max_wait_s
        wait = 0.01
        while True:
            tenant_over = False
            with self._lock:
                if t_limit and (
                    self._tenant_reserved.get(tenant, 0) + size_bytes
                    > t_limit
                ):
                    tenant_over = True
                elif hbm:
                    if self.hbm_limit is None or self._hbm_reserved + size_bytes <= self.hbm_limit:
                        self._hbm_reserved += size_bytes
                        return
                else:
                    admit = False
                    if self.limit is None:
                        admit = True
                    else:
                        used = process_rss() + self._reserved
                        admit = used + size_bytes <= self.limit
                    if admit:
                        self._reserved += size_bytes
                        if tenant is not None:
                            self._tenant_reserved[tenant] = (
                                self._tenant_reserved.get(tenant, 0)
                                + size_bytes
                            )
                        return
            if time.monotonic() >= deadline:
                if tenant_over:
                    from banyandb_tpu_torch.obs.metrics import global_meter

                    global_meter().counter_add(
                        "qos_inflight_shed", 1.0, {"tenant": tenant}
                    )
                    raise ServerBusy(
                        f"tenant {tenant!r} over in-flight write budget "
                        f"({t_limit}B) acquiring {size_bytes}B"
                    )
                raise ServerBusy(
                    f"memory budget exceeded acquiring {size_bytes}B"
                )
            time.sleep(wait)
            wait = min(wait * 2, 0.25)

    def release(
        self, size_bytes: int, *, hbm: bool = False,
        tenant: Optional[str] = None,
    ) -> None:
        with self._lock:
            if hbm:
                self._hbm_reserved = max(0, self._hbm_reserved - size_bytes)
            else:
                self._reserved = max(0, self._reserved - size_bytes)
                if tenant is not None:
                    left = self._tenant_reserved.get(tenant, 0) - size_bytes
                    if left > 0:
                        self._tenant_reserved[tenant] = left
                    else:
                        self._tenant_reserved.pop(tenant, None)

    def tenant_usage(self) -> dict[str, int]:
        """Current per-tenant in-flight reserved bytes (obs export)."""
        with self._lock:
            return dict(self._tenant_reserved)
