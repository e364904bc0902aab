"""Node diagnostics collector (FODC agent analog, re-scoped to host
telemetry per SURVEY.md §2 — the reference's eBPF kernel probes become
/proc readings; on-demand pprof capture becomes a Python thread dump).

collect() returns one self-contained snapshot: runtime parameters,
process/memory stats, storage inventory, thread stacks, and the meter
snapshot — served over the bus ("diagnostics" topic) and dumpable to a
crash-artifact file (pkg/panicdiag analog).
"""

from __future__ import annotations

import json
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Optional


# the one definition of the diagnostics bus topic (fodc proxy polls it;
# standalone server + data nodes subscribe it)
DIAG_TOPIC = "diagnostics"


def runtime_params() -> dict:
    import torch

    cuda = torch.cuda.is_available()
    return {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "pid": __import__("os").getpid(),
    }


def read_self_io() -> "tuple[int, int] | None":
    """(read_bytes, write_bytes) of this process from /proc/self/io —
    the one parser shared by diagnostics snapshots and the FODC agent's
    IO telemetry source."""
    try:
        vals = {}
        with open("/proc/self/io") as f:
            for line in f:
                k, _, v = line.partition(":")
                if k in ("read_bytes", "write_bytes"):
                    vals[k] = int(v)
        return (vals.get("read_bytes", 0), vals.get("write_bytes", 0))
    except (OSError, ValueError):
        return None


def process_stats() -> dict:
    out = {"uptime_s": time.monotonic()}
    try:
        with open("/proc/self/statm") as f:
            pages = f.read().split()
        out["rss_bytes"] = int(pages[1]) * 4096
        out["vsz_bytes"] = int(pages[0]) * 4096
    except OSError:
        pass
    io = read_self_io()
    if io is not None:
        out["io_read_bytes"], out["io_write_bytes"] = io
    out["threads"] = threading.active_count()
    return out


def thread_dump() -> dict:
    """Stacks of every live thread (pprof goroutine-dump analog)."""
    frames = sys._current_frames()
    out = {}
    for t in threading.enumerate():
        frame = frames.get(t.ident)
        out[t.name] = (
            traceback.format_stack(frame) if frame is not None else []
        )
    return out


def storage_inventory(root: str | Path) -> dict:
    from banyandb_tpu_torch.admin.inspect import inspect_root

    try:
        info = inspect_root(root)
    except OSError:
        return {}
    totals = {"parts": 0, "rows": 0, "bytes": 0}
    for groups in info["engines"].values():
        for segs in groups.values():
            for shards in segs.values():
                for shard in shards.values():
                    for p in shard["parts"]:
                        totals["parts"] += 1
                        totals["rows"] += p.get("rows", 0)
                        totals["bytes"] += p.get("bytes", 0)
    return totals


class DiagnosticsCollector:
    """Bundles one node's full diagnostic snapshot (FODC agent collect)."""

    def __init__(self, root: str | Path, meter=None):
        self.root = Path(root)
        self.meter = meter

    def collect(self, *, include_threads: bool = False) -> dict:
        snap = {
            "ts_millis": int(time.time() * 1000),
            "runtime": runtime_params(),
            "process": process_stats(),
            "storage": storage_inventory(self.root),
        }
        if self.meter is not None:
            m = self.meter.snapshot()
            snap["metrics"] = {
                "counters": {str(k): v for k, v in m["counters"].items()},
                "gauges": {str(k): v for k, v in m["gauges"].items()},
            }
        if include_threads:
            snap["threads"] = thread_dump()
        return snap

    def write_crash_artifact(self, reason: str, dest: Optional[str | Path] = None) -> Path:
        """Persist a full snapshot incl. stacks (pkg/panicdiag analog).
        Filenames carry a uuid suffix: two crashes in the same
        millisecond (e.g. a shared resource breaking several threads at
        once) must not overwrite each other's evidence."""
        import uuid

        dest = Path(dest) if dest else self.root / "diagnostics"
        dest.mkdir(parents=True, exist_ok=True)
        snap = self.collect(include_threads=True)
        snap["reason"] = reason
        path = dest / f"crash-{snap['ts_millis']}-{uuid.uuid4().hex[:8]}.json"
        path.write_text(json.dumps(snap, indent=1, default=str))
        return path
