"""Backup & restore (banyand/backup/backup.go + restore.go analog).

Backups are time-dirs of the snapshot-consistent data tree:

    <dest>/<YYYYMMDDHHMMSS>/
        schema/...        # registry JSON
        data/...          # part dirs + snapshots + indexes

The remote-FS abstraction mirrors pkg/fs/remote: a tiny put/get/list
interface with a local-directory implementation; S3/GCS/Azure drivers
plug in behind the same surface (cloud SDKs aren't in this image, so
they're gated imports for deployments that have them).
"""

from __future__ import annotations

import datetime as dt
import shutil
from pathlib import Path
from typing import Optional, Protocol


class RemoteFS(Protocol):  # pkg/fs/remote FS interface analog
    def put(self, rel: str, local: Path) -> None: ...
    def get(self, rel: str, local: Path) -> None: ...
    def list(self, prefix: str) -> list[str]: ...


class LocalDirFS:
    """Local-directory RemoteFS (the dockertest/minio stand-in)."""

    def __init__(self, root: str | Path):
        self.root = Path(root)

    def put(self, rel: str, local: Path) -> None:
        dest = self.root / rel
        dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(local, dest)

    def get(self, rel: str, local: Path) -> None:
        local.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(self.root / rel, local)

    def list(self, prefix: str) -> list[str]:
        base = self.root / prefix
        if not base.exists():
            return []
        return sorted(
            str(p.relative_to(self.root))
            for p in base.rglob("*")
            if p.is_file()
        )


# the shared prefix/key base lives with the platform-level drivers
# (utils/object_store.py) so this L6 module depends strictly downward
from banyandb_tpu_torch.utils.object_store import _PrefixedCloudFS


class S3FS(_PrefixedCloudFS):
    """S3 RemoteFS driver (pkg/fs/remote/aws analog). Gated import: boto3
    is not in the base image; deployments that have it get the driver."""

    def __init__(self, bucket: str, prefix: str = "", client=None):
        if client is None:
            try:
                import boto3  # noqa: PLC0415 - gated optional dependency
            except ImportError as e:  # pragma: no cover
                raise RuntimeError(
                    "S3FS needs boto3 (not in the base image)"
                ) from e
            client = boto3.client("s3")
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self.client = client

    def put(self, rel: str, local: Path) -> None:
        self.client.upload_file(str(local), self.bucket, self._key(rel))

    def get(self, rel: str, local: Path) -> None:
        local.parent.mkdir(parents=True, exist_ok=True)
        self.client.download_file(self.bucket, self._key(rel), str(local))

    def _iter_keys(self, probe: str):
        paginator = self.client.get_paginator("list_objects_v2")
        for page in paginator.paginate(Bucket=self.bucket, Prefix=probe):
            for obj in page.get("Contents", []):
                yield obj["Key"]


class GcsFS(_PrefixedCloudFS):
    """GCS RemoteFS driver (pkg/fs/remote/gcp analog). Gated import."""

    def __init__(self, bucket: str, prefix: str = "", client=None):
        if client is None:
            try:
                from google.cloud import storage  # noqa: PLC0415
            except ImportError as e:  # pragma: no cover
                raise RuntimeError(
                    "GcsFS needs google-cloud-storage (not in the base image)"
                ) from e
            client = storage.Client()
        if not hasattr(client, "bucket"):
            raise TypeError("GcsFS client must expose .bucket(name)")
        self.bucket = client.bucket(bucket)
        self.prefix = prefix.strip("/")

    def put(self, rel: str, local: Path) -> None:
        self.bucket.blob(self._key(rel)).upload_from_filename(str(local))

    def get(self, rel: str, local: Path) -> None:
        local.parent.mkdir(parents=True, exist_ok=True)
        self.bucket.blob(self._key(rel)).download_to_filename(str(local))

    def _iter_keys(self, probe: str):
        for blob in self.bucket.list_blobs(prefix=probe):
            yield blob.name


def _walk_files(root: Path):
    for p in sorted(root.rglob("*")):
        if p.is_file() and not p.name.startswith(".tmp"):
            yield p


def backup(
    server_root: str | Path,
    remote: RemoteFS,
    *,
    time_dir: Optional[str] = None,
    flush: Optional[callable] = None,
) -> str:
    """Snapshot (via the provided flush hook) then copy the tree.

    Returns the time-dir name (backup/timedir.go analog).
    """
    server_root = Path(server_root)
    if flush:
        flush()
    stamp = time_dir or dt.datetime.now(dt.timezone.utc).strftime("%Y%m%d%H%M%S")
    for f in _walk_files(server_root):
        rel = f.relative_to(server_root)
        remote.put(f"{stamp}/{rel}", f)
    return stamp


def list_backups(remote: RemoteFS) -> list[str]:
    stamps = {r.split("/", 1)[0] for r in remote.list("")}
    return sorted(stamps)


def restore(
    remote: RemoteFS, time_dir: str, server_root: str | Path
) -> int:
    """Materialize a backup into an empty server root. Returns file count."""
    server_root = Path(server_root)
    if server_root.exists() and any(server_root.iterdir()):
        raise FileExistsError(f"restore target {server_root} not empty")
    files = remote.list(time_dir)
    for rel in files:
        local_rel = rel.split("/", 1)[1]
        remote.get(rel, server_root / local_rel)
    return len(files)
