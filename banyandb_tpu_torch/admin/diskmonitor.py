"""Disk-usage write gates.

Analog of the reference's disk monitor
(banyand/internal/storage/disk_monitor.go:86): the data
path's filesystem usage is sampled periodically; when it crosses the
high watermark, writes are rejected with a retryable DiskFull error
until usage falls back below the low watermark (hysteresis, so the
gate doesn't flap around one threshold).  Queries are never gated.

The usage probe is injectable for tests (and for exotic mounts where
shutil.disk_usage lies).
"""

from __future__ import annotations

import shutil
import threading
import time
from pathlib import Path
from typing import Callable, Optional


class DiskFull(RuntimeError):
    """Write rejected: data filesystem above the high watermark."""


def _default_probe(path: Path) -> float:
    u = shutil.disk_usage(path)
    return u.used / u.total * 100.0


class DiskMonitor:
    def __init__(
        self,
        path: str | Path,
        *,
        high_pct: float = 95.0,
        low_pct: float = 90.0,
        interval_s: float = 10.0,
        probe: Optional[Callable[[Path], float]] = None,
    ):
        assert low_pct <= high_pct
        self.path = Path(path)
        self.high_pct = high_pct
        self.low_pct = low_pct
        self.interval_s = interval_s
        self._probe = probe or _default_probe
        self._lock = threading.Lock()
        self._gated = False
        self._last_check = 0.0
        self._last_pct = 0.0
        self.rejected = 0  # metrics counter

    def _refresh_locked(self) -> None:
        now = time.monotonic()
        if now - self._last_check < self.interval_s:
            return
        self._last_check = now
        try:
            self._last_pct = float(self._probe(self.path))
        except OSError:
            return  # keep the previous verdict on probe failure
        if self._gated:
            if self._last_pct < self.low_pct:
                self._gated = False
        elif self._last_pct >= self.high_pct:
            self._gated = True

    def check_write(self) -> None:
        """Raises DiskFull when the gate is closed (call on every write
        admission, alongside the memory protector).  Deliberately takes
        no size: the probe is percentage-based, and a byte argument
        would imply projected-usage admission this gate doesn't do."""
        with self._lock:
            self._refresh_locked()
            if self._gated:
                self.rejected += 1
                raise DiskFull(
                    f"disk usage {self._last_pct:.1f}% >= "
                    f"{self.high_pct:.0f}% high watermark on {self.path}"
                )

    def status(self) -> dict:
        with self._lock:
            return {
                "gated": self._gated,
                "usage_pct": round(self._last_pct, 2),
                "high_pct": self.high_pct,
                "low_pct": self.low_pct,
                "rejected": self.rejected,
            }
