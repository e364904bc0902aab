"""Hinted handoff: per-down-node write spools with replay on recovery.

Analog of banyand/trace/handoff_controller.go:42,82 + handoff_storage.go,
generalized to any write envelope: when a replica is unreachable, its
envelopes spool to disk (JSON lines, size-capped, oldest-dropped); when
the node comes back (probe), the spool replays in order.
"""

from __future__ import annotations

import json
import logging
import threading
from pathlib import Path
from typing import Callable

from banyandb_tpu_torch.cluster import faults

log = logging.getLogger("banyandb.handoff")


class HandoffController:
    def __init__(
        self,
        root: str | Path,
        *,
        max_bytes_per_node: int = 256 << 20,
    ):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_bytes = max_bytes_per_node
        self._lock = threading.Lock()

    def _spool_path(self, node: str) -> Path:
        return self.root / f"{node}.spool"

    def spool(self, node: str, topic: str, envelope: dict) -> None:
        """Append one missed delivery for `node` (size-capped)."""
        line = json.dumps({"topic": topic, "envelope": envelope}) + "\n"
        # disk-fault boundary (cluster/faults.py): ENOSPC raises before
        # the append; a "short" decision tears the write mid-line — the
        # corrupt trailing record is skipped at replay, never a crash
        torn = faults.check_disk("handoff-spool")
        with self._lock:
            path = self._spool_path(node)
            self._repair_torn_tail(path)
            size = path.stat().st_size if path.exists() else 0
            if size + len(line) > self.max_bytes:
                # cap by dropping the oldest half (the reference drops
                # oldest entries when its spool cap is hit)
                lines = path.read_text().splitlines(keepends=True)
                keep = lines[len(lines) // 2 :]
                path.write_text("".join(keep))
            with open(path, "a") as f:
                if torn:
                    f.write(line[: max(len(line) // 2, 1)])
                    raise OSError("injected short write at handoff spool")
                f.write(line)

    @staticmethod
    def _repair_torn_tail(path: Path) -> None:
        """Terminate a torn final record (crash/short write mid-line) so
        the next append starts a FRESH line — otherwise one torn byte
        would merge with the next record and corrupt it too.  The torn
        record itself is dropped at replay (it was never acked)."""
        try:
            if not path.exists() or path.stat().st_size == 0:
                return
            with open(path, "rb") as f:
                f.seek(-1, 2)
                torn_tail = f.read(1) != b"\n"
            if torn_tail:
                with open(path, "ab") as f:
                    f.write(b"\n")
        except OSError:
            pass

    def pending(self, node: str) -> int:
        path = self._spool_path(node)
        if not path.exists():
            return 0
        with open(path) as f:
            return sum(1 for _ in f)

    def replay(self, node: str, deliver: Callable[[str, dict], None]) -> int:
        """Drain the spool through `deliver(topic, envelope)`.

        Entries that fail again stay spooled (delivery stops at the first
        failure to preserve order). Returns replayed count.
        """
        with self._lock:
            path = self._spool_path(node)
            if not path.exists():
                return 0
            lines = path.read_text().splitlines()
        done = 0
        for line in lines:
            try:
                rec = json.loads(line)
            except ValueError:
                # a torn append (crash/short write mid-line) leaves one
                # corrupt record; it was never acked as spooled, so it
                # drops instead of wedging every replay after it
                log.warning("handoff spool for %s: dropping corrupt line", node)
                done += 1
                continue
            try:
                deliver(rec["topic"], rec["envelope"])
            except Exception:
                break
            done += 1
        from collections import Counter

        with self._lock:
            # the spool may have grown (or been cap-trimmed) while
            # deliveries ran outside the lock: rewrite from the CURRENT
            # file, removing one occurrence per delivered entry, so a
            # concurrently spooled copy is never silently dropped
            current = (
                path.read_text().splitlines() if path.exists() else []
            )
            consumed = Counter(lines[:done])
            rest = []
            for ln in current:
                if consumed.get(ln, 0):
                    consumed[ln] -= 1
                    continue
                rest.append(ln)
            if rest:
                # same disk-fault boundary as spool(): an ENOSPC on the
                # rewrite raises with the spool file intact — delivered
                # entries replay again, and every handler on this plane
                # is an idempotent repair, so over-delivery is safe
                faults.check_disk("handoff-spool")
                self._spool_path(node).write_text("\n".join(rest) + "\n")
            else:
                self._spool_path(node).unlink(missing_ok=True)
        return done
