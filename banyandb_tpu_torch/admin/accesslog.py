"""Access + slow-query logging (pkg/accesslog analog).

JSON-lines access records for writes and queries, with a separate
slow-query threshold mirroring the reference's slow-query capture
(banyand/dquery/measure.go:169-174).  Files rotate by size.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Optional


class AccessLog:
    # one default for every surface that marks queries slow (access log,
    # flight recorder); overridable per instance, via the server config
    # flag --slow-query-ms, or the BYDB_SLOW_QUERY_MS env
    DEFAULT_SLOW_QUERY_MS = 500.0

    def __init__(
        self,
        path: str | Path,
        *,
        slow_query_ms: Optional[float] = None,
        max_bytes: int = 64 << 20,
    ):
        from banyandb_tpu_torch.utils.envflag import env_float

        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if slow_query_ms is None:
            slow_query_ms = env_float(
                "BYDB_SLOW_QUERY_MS", self.DEFAULT_SLOW_QUERY_MS
            )
        self.slow_query_ms = slow_query_ms
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        # bdlint: disable=resource-hygiene -- log handle lives as long as
        # the AccessLog; closed by close() and across rotation in _emit
        self._f = open(self.path, "a", buffering=1)

    def _emit(self, record: dict) -> None:
        record["ts"] = int(time.time() * 1000)
        with self._lock:
            if self._f.tell() > self.max_bytes:
                # single-generation rotation: access.log -> access.log.1
                self._f.close()
                rotated = self.path.with_name(self.path.name + ".1")
                self.path.replace(rotated)
                # bdlint: disable=resource-hygiene -- rotation replaces
                # the owned handle just closed above
                self._f = open(self.path, "a", buffering=1)
            self._f.write(json.dumps(record) + "\n")

    def log_write(
        self, group: str, name: str, points: int, duration_ms: float,
        *, tenant: str = "",
    ) -> None:
        self._emit(
            {"kind": "write", "group": group, "name": name,
             "tenant": tenant or self._tenant(group),
             "points": points, "ms": round(duration_ms, 3)}
        )

    @staticmethod
    def _tenant(group: str) -> str:
        from banyandb_tpu_torch.qos.tenancy import tenant_of_group

        return tenant_of_group(group)

    def log_query(
        self,
        group: str,
        name: str,
        duration_ms: float,
        *,
        ql: Optional[str] = None,
        rows: int = 0,
        tenant: str = "",
    ) -> None:
        rec = {
            "kind": "query", "group": group, "name": name,
            "tenant": tenant or self._tenant(group),
            "ms": round(duration_ms, 3), "rows": rows,
        }
        if ql:
            rec["ql"] = ql
        if duration_ms >= self.slow_query_ms:
            rec["slow"] = True
        self._emit(rec)

    def close(self) -> None:
        with self._lock:
            self._f.close()
