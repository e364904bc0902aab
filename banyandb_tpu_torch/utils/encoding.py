"""Host-side column codecs (NumPy-vectorized).

The reference encodes int64 columns with const/delta/delta-of-delta + zigzag
varint picked per block (pkg/encoding/int_list.go:27,33-74) and dictionary-
encodes low-cardinality byte columns (pkg/encoding/dictionary.go).  Varint
is a sequential decode — hostile both to NumPy and to the TPU — so this
format keeps the same *compression ideas* but with fixed-width outputs:

    int64 column -> mode (const | delta | raw)
                 -> deltas downcast to the smallest width (i8/i16/i32/i64)
                 -> zstd level-1 frame

Decode is a widen + cumsum (vectorizable on host, or on device via
ops.decode.delta_decode).  Floats ride the same path via the reference's
decimal-mantissa idea (float.go): value * 10^p as int64 when exact, else
raw float64 bytes.
"""

from __future__ import annotations

import numpy as np

from banyandb_tpu_torch.utils import compress as zst
from banyandb_tpu_torch.utils import native

_MODE_CONST = 0
_MODE_DELTA = 1
_MODE_RAW = 2
_MODE_FLOAT_RAW = 3
_MODE_FLOAT_INT = 4  # float encoded as scaled int64 (decimal mantissa)

_WIDTHS = ((np.int8, 1), (np.int16, 2), (np.int32, 4), (np.int64, 8))


def _downcast(a: np.ndarray) -> tuple[np.ndarray, int]:
    lo, hi = (int(a.min()), int(a.max())) if a.size else (0, 0)
    for dt, code in _WIDTHS:
        info = np.iinfo(dt)
        if lo >= info.min and hi <= info.max:
            return a.astype(dt), code
    raise AssertionError("int64 always fits")


def encode_int64(values: np.ndarray) -> bytes:
    """-> mode byte + width byte + first (i64 LE) + zstd(deltas)."""
    v = np.ascontiguousarray(values, dtype=np.int64)
    n = v.size
    if n == 0:
        return bytes([_MODE_CONST, 8]) + (0).to_bytes(8, "little", signed=True)
    first = int(v[0])
    if n == 1 or (v == first).all():
        return bytes([_MODE_CONST, 8]) + first.to_bytes(8, "little", signed=True)
    # Delta overflow check: int64 diff can wrap; fall back to raw.
    ok = True
    if abs(first) > 2**62:
        deltas = np.diff(v)
        ok = (v[1:].astype(object) - v[:-1].astype(object) == deltas).all()
    if ok:
        # Native single-pass encode (cpp/bydb_native.cpp) when built; the
        # payload layout is identical to the NumPy path.
        nat = native.delta_encode(v)
        if nat is not None:
            payload, width = nat
        else:
            packed, width = _downcast(np.diff(v))
            payload = packed.tobytes()
        return (
            bytes([_MODE_DELTA, width])
            + first.to_bytes(8, "little", signed=True)
            + zst.compress(payload)
        )
    return (
        bytes([_MODE_RAW, 8])
        + first.to_bytes(8, "little", signed=True)
        + zst.compress(v.tobytes())
    )


def decode_int64(blob: bytes, count: int) -> np.ndarray:
    mode, width = blob[0], blob[1]
    first = int.from_bytes(blob[2:10], "little", signed=True)
    if mode == _MODE_CONST:
        return np.full(count, first, dtype=np.int64)
    payload = zst.decompress(blob[10:])
    if mode == _MODE_RAW:
        return np.frombuffer(payload, dtype=np.int64).copy()
    nat = native.delta_decode(first, payload, count, width)
    if nat is not None:
        return nat
    dtype = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[width]
    deltas = np.frombuffer(payload, dtype=dtype).astype(np.int64)
    out = np.empty(count, dtype=np.int64)
    out[0] = first
    np.cumsum(deltas, out=out[1:])
    out[1:] += first
    return out


def encode_float64(values: np.ndarray) -> bytes:
    """Decimal-mantissa trick (pkg/encoding/float.go analog): if v * 10^p is
    integral for small p, ship ints through the delta path."""
    v = np.ascontiguousarray(values, dtype=np.float64)
    if np.isfinite(v).all():
        for p in (0, 1, 2, 3):
            as_int = np.round(v * (10.0**p))
            # The only requirement is bit-exact round trip of the decode
            # expression (int / 10^p), not exactness of the scaling itself.
            if (np.abs(as_int) < 2**53).all() and (
                as_int.astype(np.int64) / (10.0**p) == v
            ).all():
                return bytes([_MODE_FLOAT_INT, p]) + encode_int64(
                    as_int.astype(np.int64)
                )
    return bytes([_MODE_FLOAT_RAW, 0]) + zst.compress(v.tobytes())


def decode_float64(blob: bytes, count: int) -> np.ndarray:
    mode, p = blob[0], blob[1]
    if mode == _MODE_FLOAT_INT:
        return decode_int64(blob[2:], count).astype(np.float64) / (10.0**p)
    if mode == _MODE_FLOAT_RAW:
        return np.frombuffer(zst.decompress(blob[2:]), dtype=np.float64).copy()
    raise ValueError(f"bad float mode {mode}")


def encode_dict_codes(codes: np.ndarray) -> bytes:
    """Dictionary code column: downcast + zstd (codes are small ints)."""
    packed, width = _downcast(np.ascontiguousarray(codes, dtype=np.int64))
    return bytes([width]) + zst.compress(packed.tobytes())


def _dict_codes_view(blob: bytes) -> np.ndarray:
    """Read-only frombuffer view of the stored code payload."""
    width = blob[0]
    dtype = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[width]
    return np.frombuffer(zst.decompress(blob[1:]), dtype=dtype)


def decode_dict_codes(blob: bytes, count: int) -> np.ndarray:
    return _dict_codes_view(blob).astype(np.int32)  # astype = one copy


def decode_dict_codes_narrow(blob: bytes, count: int) -> np.ndarray:
    """Dict codes at their STORED narrow width (i8/i16/i32) — the
    device-decode ship form (ROADMAP item 3): the widen-to-i32 happens
    on device (ops.decode), so a code column crosses PCIe at 1/4 or 1/2
    of the dense width.  i64-stored codes (never produced by
    encode_dict_codes' downcast, but tolerated) widen here."""
    out = _dict_codes_view(blob)
    if out.dtype == np.int64:
        return out.astype(np.int32)
    return out.copy()  # writable (frombuffer views are read-only)


def encode_strings(values: list[bytes]) -> bytes:
    """Length-prefixed byte blocks + zstd (pkg/encoding/bytes.go analog).
    Used for dictionaries and raw payload columns (trace spans)."""
    lens = np.fromiter((len(x) for x in values), dtype=np.int64, count=len(values))
    body = b"".join(values)
    head = len(values).to_bytes(4, "little") + encode_int64(lens)
    return len(head).to_bytes(4, "little") + head + zst.compress(body)


def decode_strings(blob: bytes) -> list[bytes]:
    head_len = int.from_bytes(blob[:4], "little")
    head = blob[4 : 4 + head_len]
    n = int.from_bytes(head[:4], "little")
    lens = decode_int64(head[4:], n)
    body = zst.decompress(blob[4 + head_len :])
    out: list[bytes] = []
    off = 0
    for ln in lens.tolist():
        out.append(body[off : off + ln])
        off += ln
    return out
