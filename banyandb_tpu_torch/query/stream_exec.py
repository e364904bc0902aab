"""Device scan path for retrieval-shaped (stream/raw) tag filtering.

The aggregate path fuses filtering into the reduce kernel
(measure_exec); retrieval queries only need the boolean row mask — but
at stream scale (millions of log elements) evaluating many tag
predicates per row is still vector work the device does better than
row-at-a-time host code.  This module ships the dictionary-code columns
of one source to the engine's device, builds the mask there with
``ops.cmp_mask`` / ``ops.in_set_mask``, and returns a host bool mask in
one copy; the host keeps the cheap parts (time range, gather of the few
selected rows).

Semantics match query/filter.row_mask exactly (-1 = literal not in
dictionary, -2 = column absent); tests/test_torch_stream.py holds the
two, and this module against banyandb_tpu's, on random data.  PyTorch
runs eagerly, so there is no per-shape kernel to compile: rows are not
padded and no kernel cache is kept.  The plan signature still names the
power-of-two row bucket (``_pad_bucket``), as the reference's does, so
the precompile registry's population stays O(log max_rows).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from banyandb_tpu_torch.api.model import Condition
from banyandb_tpu_torch.query.filter import tag_value_bytes
from banyandb_tpu_torch.storage.part import ColumnData

# below this, launch and copy overhead beats the vector win — host numpy
DEVICE_MIN_ROWS = 32_768

_SUPPORTED = {"eq", "ne", "in", "not_in"}

# masks built by each route of row_mask, and the bytes the device masks
# shipped (columns at their stored width, in-sets), since reset_stats():
# what a run reads to show that its large sources took the device
STATS = {"device_masks": 0, "host_masks": 0, "h2d_bytes": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def _pad_bucket(n: int) -> int:
    """Next power-of-two row bucket: the ``nrows`` of a mask signature."""
    return 1 << max(n - 1, 1).bit_length()


@dataclass(frozen=True)
class _MaskSpec:
    preds: tuple[tuple[str, int], ...]  # (op, padded set size)
    nrows: int


def _ship(col: np.ndarray, device):
    """Host column -> tensor on `device` at its stored width."""
    from banyandb_tpu_torch.query import measure_exec

    STATS["h2d_bytes"] += col.nbytes
    return measure_exec.ship(col, device)


def _build_kernel(spec: _MaskSpec):
    """The mask function of `spec`: (cols, pred_vals) -> bool mask on the
    columns' device.  Columns arrive at their stored width (the
    device-side decode stage widens narrow i8/i16 codes first); an eq/ne
    value is an int or a 0-d i32 tensor, an in/not_in value a padded i32
    code set."""
    from banyandb_tpu_torch import ops

    def kernel(cols, pred_vals):
        mask = None
        for (op, _nv), col, v in zip(spec.preds, cols, pred_vals):
            col = ops.widen_codes(col)
            if op in ("in", "not_in"):
                m = ops.in_set_mask(col, v)
                m = ~m if op == "not_in" else m
            else:
                m = ops.cmp_mask(col, op, v)
            mask = m if mask is None else mask & m
        return mask

    return kernel


def device_tag_mask(src: ColumnData, conds: list[Condition], device):
    """bool[n] tag-predicate mask built on `device`, moved to the host
    in one copy; None when the predicate set is unsupported (the caller
    takes the host path)."""
    import torch

    from banyandb_tpu_torch.query import measure_exec
    from banyandb_tpu_torch.query.precompile import default_registry

    n = src.ts.size
    if not conds or any(c.op not in _SUPPORTED for c in conds):
        return None
    device = torch.device(device)
    cols = []
    vals = []
    preds = []
    for c in conds:
        col = src.tags.get(c.name)
        # device-side decode stage: columns arrive at their stored narrow
        # width when the source was read with narrow_codes (every signed
        # width holds the -1/-2 sentinels), cross to the device
        # compressed and widen there before any compare — predicate codes
        # are i32, so the mask math is identical either way
        if col is None:
            cols.append(torch.full((n,), -2, dtype=torch.int32, device=device))
        else:
            cols.append(_ship(col, device))
        d = src.dicts.get(c.name, [])
        lut = {v: i for i, v in enumerate(d)}
        if c.op in ("in", "not_in"):
            codes = sorted({lut.get(tag_value_bytes(v), -1) for v in c.value})
            # pad the set to the next power of two with the -1 sentinel
            # (matches no real code, codes are dict indices >= 0), as the
            # reference keys its kernels by O(log) set sizes
            padded_len = 1 << max(0, (len(codes) - 1)).bit_length() if codes else 1
            arr = np.full(padded_len, -1, dtype=np.int32)
            arr[: len(codes)] = codes
            preds.append((c.op, padded_len))
            vals.append(_ship(arr, device))
        else:
            preds.append((c.op, 1))
            vals.append(lut.get(tag_value_bytes(c.value), -1))
    spec = _MaskSpec(preds=tuple(preds), nrows=_pad_bucket(n))
    mask = _build_kernel(spec)(cols, vals)
    default_registry().record("stream_mask", spec)
    STATS["device_masks"] += 1
    # the retrieval result boundary: the whole bool mask moves in one
    # transfer; the host gather needs it
    return measure_exec.device_get(mask)


def row_mask(
    src: ColumnData,
    conds: list[Condition],
    begin_millis: int,
    end_millis: int,
    device,
) -> np.ndarray:
    """Time+tag mask: the tag mask on `device` for sources of
    DEVICE_MIN_ROWS rows or more with only eq/ne/in/not_in predicates,
    the host path otherwise (by size and op, as the reference routes)."""
    from banyandb_tpu_torch.query import filter as qfilter

    if src.ts.size >= DEVICE_MIN_ROWS:
        tag_mask = device_tag_mask(src, conds, device)
        if tag_mask is not None:
            return (
                (src.ts >= begin_millis) & (src.ts < end_millis) & tag_mask
            )
    STATS["host_masks"] += 1
    return qfilter.row_mask(src, conds, begin_millis, end_millis)
