"""Filesystem helpers: atomic writes and dir scanning.

Analog of pkg/fs/file_system.go:55 (atomic write = temp file + fsync +
rename) — crash mid-write never leaves a torn file visible.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path


def atomic_write(path: str | Path, data: bytes) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str | Path, obj) -> None:
    atomic_write(path, json.dumps(obj, indent=1, sort_keys=True).encode())


def read_json(path: str | Path):
    with open(path, "rb") as f:
        return json.loads(f.read())
