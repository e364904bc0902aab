"""Hot -> cold segment migration (banyand/backup/lifecycle analog).

The reference's lifecycle agent moves expired-from-hot segments between
node tiers with resumable progress (lifecycle/service.go, progress.go).
This single-node form migrates whole segment dirs into an archive root
with copy -> verify -> swap semantics and a JSON progress file so an
interrupted run resumes instead of restarting:

    migrate(db, archive_root, older_than_millis)
    restore_segment(archive_root, db, segment_name)

Multi-node tier routing (stage-aware node selectors,
banyand/queue/pub/stage.go) composes on top: the archive root of a hot
node is the data root of a warm/cold node shipped via chunked sync.
"""

from __future__ import annotations

import shutil
from pathlib import Path

from banyandb_tpu_torch.storage.tsdb import TSDB
from banyandb_tpu_torch.utils import fs


def _dir_signature(root: Path) -> list[tuple[str, int]]:
    return sorted(
        (str(p.relative_to(root)), p.stat().st_size)
        for p in root.rglob("*")
        if p.is_file()
    )


def migrate(
    db: TSDB, archive_root: str | Path, older_than_millis: int
) -> list[str]:
    """Move segments whose window ended before the cutoff. Returns names."""
    archive_root = Path(archive_root)
    progress_path = archive_root / ".migration-progress.json"
    done: dict = (
        fs.read_json(progress_path) if progress_path.exists() else {"copied": []}
    )
    moved = []
    for seg in db.segments:
        if seg.end > older_than_millis:
            continue
        # Seal the segment first: memtable rows must reach disk before the
        # directory is copied, or they'd exist in neither tier.
        for shard in seg.shards:
            shard.flush()
        seg.persist_index()
        name = seg.root.name
        dest = archive_root / name
        # A "copied" marker from a previous run is only trusted if the
        # archived copy still matches the (possibly since-written) hot dir;
        # any divergence re-runs the copy before the destructive swap.
        up_to_date = (
            name in done["copied"]
            and dest.exists()
            and _dir_signature(dest) == _dir_signature(seg.root)
        )
        if not up_to_date:
            if dest.exists():
                shutil.rmtree(dest)
            shutil.copytree(seg.root, dest)
            if _dir_signature(dest) != _dir_signature(seg.root):
                raise IOError(f"verification failed migrating {name}")
            if name not in done["copied"]:
                done["copied"].append(name)
            fs.atomic_write_json(progress_path, done)
        # swap phase: drop from the hot tier only after a verified copy
        with db._lock:
            start = seg.start
            if start in db._segments:
                del db._segments[start]
        shutil.rmtree(seg.root, ignore_errors=True)
        moved.append(name)
    live = {seg.root.name for seg in db.segments}
    done["copied"] = [n for n in done["copied"] if n in live]
    fs.atomic_write_json(progress_path, done)
    return moved


def list_archived(archive_root: str | Path) -> list[str]:
    return sorted(
        p.name for p in Path(archive_root).glob("seg-*") if p.is_dir()
    )


def restore_segment(
    archive_root: str | Path, db: TSDB, segment_name: str
) -> None:
    """Bring an archived segment back into the hot tier.

    Only the one segment is attached (under the db lock) — a full
    _reopen would replace every live Segment object and drop their
    unflushed memtables.
    """
    import datetime as dt

    from banyandb_tpu_torch.storage.tsdb import Segment

    src = Path(archive_root) / segment_name
    dest = db.root / segment_name
    if dest.exists():
        raise FileExistsError(f"segment {segment_name} already live")
    shutil.copytree(src, dest)
    stamp = segment_name[4:]
    iv = db.opts.segment_interval
    fmt = "%Y%m%d%H" if iv.unit == "hour" else "%Y%m%d"
    t = dt.datetime.strptime(stamp, fmt).replace(tzinfo=dt.timezone.utc)
    start = int(t.timestamp() * 1000)
    with db._lock:
        if start in db._segments:
            raise FileExistsError(f"segment {segment_name} already attached")
        db._segments[start] = Segment(
            dest, start, iv.millis, db.opts.shard_num, db.mem_factory
        )
