"""zstd block compression via ctypes on the system libzstd.

Mirrors pkg/compress (level-1 zstd on meta/primary/large payloads,
pkg/compress/zstd.go) without a Go/py dependency: the container ships
libzstd.so.1. Falls back to zlib if libzstd is missing so the format
stays readable anywhere (the frame is tagged with a 1-byte codec id).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import zlib

_CODEC_ZSTD = b"\x01"
_CODEC_ZLIB = b"\x02"

_zstd = None
try:  # pragma: no cover - environment probe
    _name = ctypes.util.find_library("zstd") or "libzstd.so.1"
    _lib = ctypes.CDLL(_name)
    _lib.ZSTD_compressBound.restype = ctypes.c_size_t
    _lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    _lib.ZSTD_compress.restype = ctypes.c_size_t
    _lib.ZSTD_compress.argtypes = [
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_int,
    ]
    _lib.ZSTD_decompress.restype = ctypes.c_size_t
    _lib.ZSTD_decompress.argtypes = [
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_void_p,
        ctypes.c_size_t,
    ]
    _lib.ZSTD_isError.restype = ctypes.c_uint
    _lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    _zstd = _lib
except OSError:
    _zstd = None

# The reference compresses at level 1 (pkg/compress): speed over ratio for
# the flush/merge hot path.
LEVEL = 1


def compress(data: bytes) -> bytes:
    """-> tagged frame: codec byte + uncompressed length (u32 LE) + payload."""
    header = len(data).to_bytes(4, "little")
    if _zstd is not None:
        bound = _zstd.ZSTD_compressBound(len(data))
        out = ctypes.create_string_buffer(bound)
        n = _zstd.ZSTD_compress(out, bound, data, len(data), LEVEL)
        if not _zstd.ZSTD_isError(n):
            return _CODEC_ZSTD + header + out.raw[:n]
    return _CODEC_ZLIB + header + zlib.compress(data, LEVEL)


def decompress(frame: bytes) -> bytes:
    codec, raw_len = frame[:1], int.from_bytes(frame[1:5], "little")
    payload = frame[5:]
    if codec == _CODEC_ZSTD:
        if _zstd is None:
            raise RuntimeError("zstd frame but libzstd unavailable")
        out = ctypes.create_string_buffer(raw_len)
        n = _zstd.ZSTD_decompress(out, raw_len, payload, len(payload))
        if _zstd.ZSTD_isError(n) or n != raw_len:
            raise ValueError("corrupt zstd frame")
        return out.raw
    if codec == _CODEC_ZLIB:
        return zlib.decompress(payload)
    raise ValueError(f"unknown codec id {codec!r}")
