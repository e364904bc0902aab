"""Cluster tier migration: ship expired-from-hot segments to the next
stage's node over the chunked-sync wire.

Analog of the reference's lifecycle agent (banyand/backup/lifecycle/
service.go steps: snapshot -> per-model visitors copy segments to the
target tier -> verify -> delete from source; progress.go makes every
step resumable).  This package's form:

  TierMigrator(data_node, transport, target).run(older_than_millis)

- seals each expired segment (flush + index persist; trace sidx first),
- ships every part via the SYNC_PART chunked protocol with a metadata
  patch stamping catalog + ordered_tags so the receiver routes it to the
  right engine and rebuilds trace blooms/sidx (data_node._on_sync_part),
- records progress per part in `.tier-migration.json` — an interrupted
  run resumes where it stopped, and receiver-side content digests make
  re-ships of already-installed parts no-ops,
- drops the local segment only after every shipped part is acknowledged
  (copy -> verify -> swap, lifecycle/steps.go ordering).

Stage routing composes: once the hot node drops the segment, queries
naming stages=('warm',) resolve to the target node (pub/stage.go
ResolveStage analog in cluster.liaison._shard_assignment).
"""

from __future__ import annotations

import shutil
from typing import Optional

from banyandb_tpu_torch.cluster.liaison import ChunkedSyncClient
from banyandb_tpu_torch.utils import fs

PROGRESS_FILE = ".tier-migration.json"


class TierMigrator:
    def __init__(self, node, transport, target_addr: str):
        """node: the hot-tier cluster DataNode; target_addr: transport
        address of the warm/cold-tier node receiving the segments."""
        self.node = node
        self.client = ChunkedSyncClient(transport, target_addr)
        self.progress_path = node.root / PROGRESS_FILE

    # -- progress ----------------------------------------------------------
    def _load_progress(self) -> dict:
        if self.progress_path.exists():
            return fs.read_json(self.progress_path)
        return {"shipped": [], "migrated_segments": []}

    def _save_progress(self, progress: dict) -> None:
        fs.atomic_write_json(self.progress_path, progress)

    # -- engine walk -------------------------------------------------------
    def _engines(self):
        return (
            ("measure", self.node.measure),
            ("stream", self.node.stream),
            ("trace", self.node.trace),
        )

    def _attach_disk_groups(self, engine) -> None:
        """Engines open group TSDBs lazily on first write/query; an
        offline agent (the lifecycle CLI) sees an empty map until the
        on-disk groups are attached explicitly."""
        root = getattr(engine, "root", None)
        if root is None or not root.exists():
            return
        for gdir in root.iterdir():
            if not gdir.is_dir():
                continue
            try:
                engine._tsdb(gdir.name)
            except KeyError:
                continue  # directory for a group the registry dropped

    def _seal(self, catalog: str, engine, db) -> None:
        """Everything in memtables/mem-sidx must be on disk before the
        directory tree is shipped (lifecycle takes a snapshot first)."""
        if catalog == "trace":
            # ordered keys first, the engine's own flush-ordering contract
            engine._flush_sidx_first()
        db.flush_all()

    def _trace_ordered_tags(self, seg) -> list[str]:
        """Tree-indexed tags of a segment, recovered from its on-disk
        sidx stores — shipped in the metadata patch so the receiver
        rebuilds ordered indexes for the migrated spans."""
        return sorted(
            p.name[len("sidx-"):]
            for p in seg.root.glob("sidx-*")
            if p.is_dir()
        )

    # -- run ---------------------------------------------------------------
    def _ship_segment(
        self, catalog, group, seg, meta_patch, done, progress, resumed_keys
    ) -> int:
        """Ship every part of the segment until it is quiescent: each pass
        flushes late memtable rows into new parts and ships anything not
        yet recorded; done when a pass ships nothing and memtables are
        empty.  Merge-freeze (MIGRATING_MARKER) keeps part names stable,
        so the progress keys survive a crash + resume."""
        seg_name = seg.root.name
        shipped = 0
        while True:
            new_this_pass = 0
            for shard in seg.shards:
                shard.flush()
                for part in shard.parts:
                    key = "/".join(
                        (catalog, group, seg_name, shard.root.name, part.name)
                    )
                    if key in done:
                        if key in resumed_keys:
                            resumed_keys[key] = True
                        continue
                    self.client.sync_part(
                        part.dir,
                        group=group,
                        segment=seg_name,
                        segment_start_millis=seg.start,
                        shard=shard.root.name,
                        meta_patch=meta_patch,
                    )
                    new_this_pass += 1
                    done.add(key)
                    progress["shipped"] = sorted(done)
                    self._save_progress(progress)
            if new_this_pass == 0 and all(
                not sh.has_unflushed for sh in seg.shards
            ):
                return shipped
            shipped += new_this_pass

    def run(self, older_than_millis: int, catalogs: Optional[tuple] = None) -> dict:
        """Migrate every sealed segment with end <= cutoff. Returns
        {"shipped_parts": N, "migrated_segments": [...], "resumed": N}."""
        from contextlib import ExitStack

        from banyandb_tpu_torch.storage.tsdb import MIGRATING_MARKER

        progress = self._load_progress()
        done = set(progress["shipped"])
        # keys recorded by a PREVIOUS (interrupted) run; flipped True when
        # this run actually skips a re-ship because of them
        resumed_keys = {k: False for k in done}
        shipped = 0
        for catalog, engine in self._engines():
            if catalogs is not None and catalog not in catalogs:
                continue
            self._attach_disk_groups(engine)
            for group, db in list(engine._tsdbs.items()):
                expired = [
                    seg for seg in db.segments if seg.end <= older_than_millis
                ]
                if not expired:
                    continue
                self._seal(catalog, engine, db)  # once per db, not per seg
                for seg in expired:
                    # merge-freeze FIRST: progress keys are part names
                    (seg.root / MIGRATING_MARKER).touch()
                    meta_patch = {"catalog": catalog, "group": group}
                    if catalog == "trace":
                        ordered = self._trace_ordered_tags(seg)
                        if ordered:
                            meta_patch["ordered_tags"] = ordered
                    seg_name = seg.root.name
                    shipped += self._ship_segment(
                        catalog, group, seg, meta_patch, done, progress,
                        resumed_keys,
                    )
                    # swap phase: drop from the hot tier only after every
                    # part is acknowledged.  All shard locks + db lock are
                    # held so no in-flight ingest/flush interleaves with
                    # the removal; a write that enters after the pop gets
                    # a fresh segment object (stays hot — safe, re-ships
                    # on the next migration pass).
                    with ExitStack() as stack:
                        stack.enter_context(db._lock)
                        for sh in seg.shards:
                            stack.enter_context(sh._lock)
                        if any(sh.has_unflushed for sh in seg.shards):
                            # a write slipped in after the quiesce pass:
                            # leave the segment in place for the next run
                            # rather than dropping unshipped rows
                            continue
                        db._segments.pop(seg.start, None)
                    shutil.rmtree(seg.root, ignore_errors=True)
                    progress["migrated_segments"].append(
                        f"{catalog}/{group}/{seg_name}"
                    )
                    # shipped-part records for a dropped segment are dead
                    # weight (part names are epoch-unique per shard dir)
                    prefix = f"{catalog}/{group}/{seg_name}/"
                    done = {k for k in done if not k.startswith(prefix)}
                    progress["shipped"] = sorted(done)
                    self._save_progress(progress)
        return {
            "shipped_parts": shipped,
            "resumed": sum(1 for hit in resumed_keys.values() if hit),
            "migrated_segments": progress["migrated_segments"],
        }
