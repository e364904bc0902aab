"""ctypes bindings to cpp/libbydb_native.so (the native hot-loop module).

Loaded lazily and optional: every caller has a NumPy fallback, so the
framework runs pure-Python when the .so hasn't been built (`make -C cpp`).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

_SO_PATHS = [
    Path(__file__).resolve().parents[2] / "cpp" / "libbydb_native.so",
    Path("libbydb_native.so"),
]

_lib = None
_tried = False


def lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    for p in _SO_PATHS:
        try:
            L = ctypes.CDLL(str(p))
        except OSError:
            continue
        L.bydb_delta_encode.restype = ctypes.c_int
        L.bydb_delta_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
        ]
        L.bydb_delta_decode.restype = ctypes.c_int
        L.bydb_delta_decode.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_void_p,
        ]
        L.bydb_zigzag_varint_encode.restype = ctypes.c_int64
        L.bydb_zigzag_varint_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        L.bydb_zigzag_varint_decode.restype = ctypes.c_int64
        L.bydb_zigzag_varint_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
        L.bydb_crc32.restype = ctypes.c_uint32
        L.bydb_crc32.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32]
        _lib = L
        break
    return _lib


def delta_encode(values: np.ndarray) -> Optional[tuple[bytes, int]]:
    """-> (packed deltas, width) or None when the native lib is absent."""
    L = lib()
    if L is None:
        return None
    v = np.ascontiguousarray(values, dtype=np.int64)
    out = np.empty(max(v.size - 1, 1) * 8, dtype=np.uint8)
    out_len = ctypes.c_int64()
    width = ctypes.c_int()
    rc = L.bydb_delta_encode(
        v.ctypes.data, v.size, out.ctypes.data,
        ctypes.byref(out_len), ctypes.byref(width),
    )
    if rc != 0:
        return None
    return out[: out_len.value].tobytes(), width.value


def delta_decode(first: int, payload: bytes, count: int, width: int) -> Optional[np.ndarray]:
    L = lib()
    if L is None:
        return None
    # Validate before touching C: corrupt blobs must become Python errors,
    # not out-of-bounds reads.
    if width not in (1, 2, 4, 8):
        raise ValueError(f"bad delta width {width}")
    if count < 1:
        raise ValueError(f"bad row count {count}")
    if len(payload) != (count - 1) * width:
        raise ValueError(
            f"delta payload {len(payload)}B != (count-1)*width {(count - 1) * width}B"
        )
    buf = np.frombuffer(payload, dtype=np.uint8)
    out = np.empty(count, dtype=np.int64)
    L.bydb_delta_decode(
        first, buf.ctypes.data if buf.size else None, count, width, out.ctypes.data
    )
    return out


def zigzag_varint_encode(values: np.ndarray) -> Optional[bytes]:
    L = lib()
    if L is None:
        return None
    v = np.ascontiguousarray(values, dtype=np.int64)
    out = np.empty(v.size * 10 + 1, dtype=np.uint8)
    n = L.bydb_zigzag_varint_encode(v.ctypes.data, v.size, out.ctypes.data)
    return out[:n].tobytes()


def zigzag_varint_decode(payload: bytes, count: int) -> Optional[np.ndarray]:
    L = lib()
    if L is None:
        return None
    buf = np.frombuffer(payload, dtype=np.uint8)
    out = np.empty(count, dtype=np.int64)
    got = L.bydb_zigzag_varint_decode(
        buf.ctypes.data if buf.size else None, buf.size, out.ctypes.data, count
    )
    return out[:got]


def crc32(data: bytes, seed: int = 0) -> Optional[int]:
    L = lib()
    if L is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    return int(L.bydb_crc32(buf.ctypes.data if buf.size else None, buf.size, seed))
