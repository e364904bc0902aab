"""Bloom filter (pkg/filter analog — the reference's .tff skipping-index
and per-part traceID.filter).

NumPy bit array + k blake2b-derived hash functions; serialized form is
versioned and endian-stable.
"""

from __future__ import annotations

import hashlib

import numpy as np

_MAGIC = b"BLF1"


class Bloom:
    def __init__(self, n_items: int, bits_per_item: int = 10, k: int = 7):
        self.m = max(64, n_items * bits_per_item)
        self.k = k
        self.bits = np.zeros((self.m + 63) // 64, dtype=np.uint64)

    @staticmethod
    def _hashes(value: bytes, k: int, m: int) -> list[int]:
        h = hashlib.blake2b(value, digest_size=16).digest()
        a = int.from_bytes(h[:8], "little")
        b = int.from_bytes(h[8:], "little") | 1
        return [((a + i * b) % (1 << 64)) % m for i in range(k)]

    def add(self, value: bytes) -> None:
        for pos in self._hashes(value, self.k, self.m):
            # bdlint: disable=wp-shared-state -- a Bloom under
            # construction is function-local to one part build
            # (write_trace_bloom / flush); it crosses threads only after
            # serialization, as immutable bytes on disk
            self.bits[pos >> 6] |= np.uint64(1 << (pos & 63))

    def __contains__(self, value: bytes) -> bool:
        for pos in self._hashes(value, self.k, self.m):
            if not (int(self.bits[pos >> 6]) >> (pos & 63)) & 1:
                return False
        return True

    def to_bytes(self) -> bytes:
        head = _MAGIC + self.m.to_bytes(8, "little") + self.k.to_bytes(1, "little")
        return head + self.bits.tobytes()

    @classmethod
    def from_bytes(cls, blob: bytes) -> "Bloom":
        assert blob[:4] == _MAGIC, "bad bloom frame"
        out = cls.__new__(cls)
        out.m = int.from_bytes(blob[4:12], "little")
        out.k = blob[12]
        out.bits = np.frombuffer(blob[13:], dtype=np.uint64).copy()
        return out
