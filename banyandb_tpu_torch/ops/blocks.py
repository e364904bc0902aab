"""Device-friendly columnar block model, on torch tensors.

The reference stores measure data as per-series columnar blocks capped at
8192 rows / 2 MiB (banyand/measure/measure.go:41-46) and scans them row by
row in Go.  Here a *batch* of blocks is a set of padded dense tensors
with a validity mask — the shape every scan/filter/aggregate op
consumes.  storage/part.py cuts parts into blocks of ``MAX_ROWS``.

Rows are padded to bucketed sizes (powers of two up to MAX_ROWS) so the
set of batch shapes stays small and finite, as in banyandb_tpu/ops/
blocks.py.  ``ColumnBatch`` is registered as a ``torch.utils._pytree``
node, so functions that map over tensor trees take it whole.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.utils._pytree as pytree

from banyandb_tpu_torch.backend import resolve_device

# The reference caps blocks at 8192 rows (banyand/measure/measure.go:46).
MAX_ROWS = 8192
_BUCKETS = tuple(2**i for i in range(6, 14))  # 64 .. 8192


def pad_rows_bucket(n: int) -> int:
    """Smallest shape bucket >= n. Keeps the set of batch shapes finite."""
    for b in _BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"row count {n} exceeds MAX_ROWS={MAX_ROWS}")


@dataclasses.dataclass(frozen=True)
class ColumnBatch:
    """A flattened batch of rows drawn from one or more storage blocks.

    All tensors share the leading dimension N (padded row count) and
    one device.

    - ``ts``: int32 timestamp offsets from ``epoch_millis`` (host-side int64).
      A segment spans at most a day, so millisecond offsets fit int32; this
      keeps the device hot path free of int64.
    - ``series``: int32 *local* series ordinals (dense ids assigned at batch
      build time; the host keeps the ordinal -> seriesID int64 mapping).
    - ``valid``: bool row-validity mask (padding and filtered rows are 0).
    - ``fields``: float32 measure field columns (int fields are cast; exact
      int aggregation is handled by the i64 host fallback when requested).
    - ``tags``: int32 dictionary codes per tag column.
    - ``version``: int32 write-version offsets for dedup-by-version.
    """

    ts: torch.Tensor
    series: torch.Tensor
    valid: torch.Tensor
    fields: Mapping[str, torch.Tensor]
    tags: Mapping[str, torch.Tensor]
    version: torch.Tensor

    @property
    def nrows(self) -> int:
        return self.ts.shape[0]

    @property
    def device(self) -> torch.device:
        return self.ts.device

    @staticmethod
    def build(
        *,
        ts_millis: np.ndarray,
        epoch_millis: int,
        series_ordinal: np.ndarray,
        fields: Mapping[str, np.ndarray],
        tag_codes: Mapping[str, np.ndarray],
        version: np.ndarray | None = None,
        device=None,
    ) -> "ColumnBatch":
        """Pack host numpy columns into a padded batch on `device`
        (``backend.resolve_device``: CUDA by default, ``"cpu"`` only
        when asked)."""
        device = resolve_device(device)
        n = int(ts_millis.shape[0])
        nb = pad_rows_bucket(max(n, 1))
        if n:
            off_lo = int(ts_millis.min()) - epoch_millis
            off_hi = int(ts_millis.max()) - epoch_millis
            if off_lo < -(2**31) or off_hi >= 2**31:
                raise ValueError(
                    f"timestamp offsets [{off_lo}, {off_hi}] exceed int32; "
                    "epoch_millis must come from the enclosing segment"
                )

        def pad(a: np.ndarray, dtype) -> torch.Tensor:
            out = np.zeros((nb,), dtype=dtype)
            out[:n] = a.astype(dtype, copy=False)
            return torch.from_numpy(out).to(device)

        valid = np.zeros((nb,), dtype=bool)
        valid[:n] = True
        if version is None:
            version = np.zeros((n,), dtype=np.int32)
        elif n:
            # Dedup only needs relative version order; rebase epoch-style
            # int64 versions to offsets so they survive the int32 cast.
            version = np.asarray(version, dtype=np.int64)
            version = version - int(version.min())
            if int(version.max()) >= 2**31:
                raise ValueError("version spread exceeds int32 offsets")
        return ColumnBatch(
            ts=pad(ts_millis - epoch_millis, np.int32),
            series=pad(series_ordinal, np.int32),
            valid=torch.from_numpy(valid).to(device),
            fields={k: pad(v, np.float32) for k, v in fields.items()},
            tags={k: pad(v, np.int32) for k, v in tag_codes.items()},
            version=pad(version, np.int32),
        )


_CHILDREN = ("ts", "series", "valid", "fields", "tags", "version")

pytree.register_pytree_node(
    ColumnBatch,
    lambda b: ([getattr(b, k) for k in _CHILDREN], None),
    lambda children, _ctx: ColumnBatch(*children),
)
