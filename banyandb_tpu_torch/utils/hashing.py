"""Series identity and shard routing.

The reference routes entity -> seriesID -> shard with xxhash
(pkg/partition/route.go:30, pkg/convert). Here series ids are 63-bit
blake2b digests of the entity tuple (deterministic across processes,
no external dep); shard = seriesID % shard_num, same contract.
"""

from __future__ import annotations

import hashlib

_SEP = b"\x00\x01"


def series_id(entity_values: list[bytes]) -> int:
    """63-bit stable hash of the entity tag tuple (non-negative int64)."""
    h = hashlib.blake2b(_SEP.join(entity_values), digest_size=8).digest()
    return int.from_bytes(h, "little") & 0x7FFF_FFFF_FFFF_FFFF


def shard_id(sid: int, shard_num: int) -> int:
    """shardID = seriesID % shard_num (pkg/partition/route.go:30 contract)."""
    return sid % shard_num


def entity_bytes(value) -> bytes:
    """Canonical byte form of one entity tag value."""
    if isinstance(value, bytes):
        return value
    if isinstance(value, str):
        return value.encode()
    if isinstance(value, bool):
        return b"\x01" if value else b"\x00"
    if isinstance(value, int):
        return value.to_bytes(8, "little", signed=True)
    raise TypeError(f"unsupported entity tag type {type(value)}")
