"""Group-by + aggregation kernels on torch tensors.

Tags are dictionary codes, so a group key is a *mixed-radix* int32
composed from the code columns, bounded by the product of dictionary
sizes.  Aggregation is then a dense segment reduction:

- ``scatter``: segment sums by ``index_put_(accumulate=True)``
  (Kahan-tiled past 65536 rows).
- ``matmul``: one-hot(keys) @ values in one shot, in full f32 (TF32 is
  off, backend.py).
- ``matmul_tiled``: one-hot contractions over 8192-row tiles, the tile
  partials Kahan-combined.
- ``kernel``: the hand-written Hopper kernel
  (ops.hopper_kernels.fused_group_multi) for count and all field sums in
  one pass; on a CPU tensor, its plain version.
- ``sort``: segment-sort grouping — stable sort by key, then the same
  bounded-span reduction as ``scatter`` over now-contiguous group runs.

min/max ride ``scatter_reduce_`` with +inf/-inf initial values, so
empty groups come back as +inf/-inf.  ``method="auto"`` resolves through
``select_group_method``.

Precision contract: per-group sums accumulate in f32 within a bounded
row tile (<= 65536 rows for scatter, 8192 for matmul_tiled, 2048 for
the kernel); tile partials combine across tiles with Kahan-compensated
f32, so the cross-tile error is O(eps) independent of the row count.
The host merges partials across chunks in f64.  Counts and sums of
integer-valued fields are exact up to 2^24 per tile.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from banyandb_tpu_torch.ops import hopper_kernels


def mixed_radix_key(
    columns: Sequence[torch.Tensor], radices: Sequence[int]
) -> tuple[torch.Tensor, int]:
    """Compose dictionary-code columns into a single dense int32 group key.

    key = ((c0*r1 + c1)*r2 + c2)... ; group count = prod(radices).
    Host code recovers per-tag codes with np.unravel_index(key, radices).
    """
    assert len(columns) == len(radices) and columns
    total = 1
    for r in radices:
        total *= int(r)
    if total >= 2**31:
        # int32 keys would wrap and silently merge groups; callers must
        # pre-reduce cardinality (hash-bucket tags) before grouping
        raise ValueError(
            f"group cardinality {total} overflows int32 keys; "
            "bucket the tag dictionaries first"
        )
    key = columns[0].to(torch.int32)
    for c, r in zip(columns[1:], radices[1:]):
        key = key * int(r) + c.to(torch.int32)
    return key, total


@dataclasses.dataclass(frozen=True)
class GroupReduceResult:
    """Per-group aggregates; tensors have leading dim num_groups."""

    count: torch.Tensor  # f32 [G] — valid-row count per group
    sums: Mapping[str, torch.Tensor]  # f32 [G] per field
    mins: Mapping[str, torch.Tensor]  # f32 [G] per field (+inf when empty)
    maxs: Mapping[str, torch.Tensor]  # f32 [G] per field (-inf when empty)

    def mean(self, field: str) -> torch.Tensor:
        return self.sums[field] / torch.clamp(self.count, min=1.0)

    @property
    def nonempty(self) -> torch.Tensor:
        return self.count > 0


def _kahan_fold(parts: torch.Tensor) -> torch.Tensor:
    """Fold tile partials [..., T, X] over T in order with
    Kahan-compensated f32; -> [..., X]."""
    s = torch.zeros_like(parts[..., 0, :])
    c = torch.zeros_like(s)
    for t in range(parts.shape[-2]):
        y = parts[..., t, :] - c
        u = s + y
        c = (u - s) - y
        s = u
    return s - c


def _pad_rows(x: torch.Tensor, pad: int, value) -> torch.Tensor:
    if not pad:
        return x
    return torch.cat([x, torch.full((pad,), value, dtype=x.dtype, device=x.device)])


def _kahan_tiled_reduce(
    safe_key: torch.Tensor,
    validf: torch.Tensor,
    masked_fields: Mapping[str, torch.Tensor],
    num_groups: int,
    tile: int,
    partial_fn,
):
    """Bounded-span accumulation: pad rows to a tile multiple, compute
    the per-tile [G+1] partials with ``partial_fn(key_t, valid_t,
    fields_t)`` (tile-major tensors; -> [1 + F, T, G+1], ordered
    [count, field_0, ...] with fields pre-masked by validf), and
    Kahan-fold them over tiles.  -> (count [G], sums {name: [G]})."""
    names = sorted(masked_fields.keys())
    n = safe_key.shape[-1]
    pad = (-n) % tile
    kp = _pad_rows(safe_key, pad, num_groups).view(-1, tile)
    vp = _pad_rows(validf, pad, 0.0).view(-1, tile)
    if names:
        fp = torch.stack(
            [_pad_rows(masked_fields[nm], pad, 0.0).view(-1, tile) for nm in names]
        )
    else:
        fp = torch.zeros((0,) + kp.shape, dtype=torch.float32, device=kp.device)
    out = _kahan_fold(partial_fn(kp, vp, fp))[:, :num_groups]
    return out[0], {nm: out[1 + i] for i, nm in enumerate(names)}


def _tiled_segment_sums(kp, vp, fp, num_groups: int) -> torch.Tensor:
    """Per-tile segment sums of [count, fields...] -> [1 + F, T, G+1]."""
    g1 = num_groups + 1
    tiles = kp.shape[0]
    slot = (
        kp.long()
        + torch.arange(tiles, device=kp.device)[:, None] * g1
    ).reshape(-1)
    rows = torch.cat([vp[None], fp]) if fp.shape[0] else vp[None]
    out = torch.zeros(
        (rows.shape[0], tiles * g1), dtype=torch.float32, device=kp.device
    )
    for i in range(rows.shape[0]):
        out[i].index_put_((slot,), rows[i].reshape(-1), accumulate=True)
    return out.view(rows.shape[0], tiles, g1)


# High-radix crossover for hash- vs sort-based grouping (arXiv 2411.13245):
# hash-style scatter wins while the per-group table stays cache resident,
# segment-sort grouping once it spills.
SORT_GROUPS_THRESHOLD = 1 << 16
# largest group count the kernel path takes: the bound under which the
# JAX package took its Pallas kernel
KERNEL_MAX_GROUPS = 4 * 2048


def select_group_method(num_groups: int) -> str:
    """Per-signature group-by strategy (the ``method="auto"`` policy).

    Both the staged and the fused executor resolve through this ONE
    function from the same signature, so an A/B flip can never pair
    different reduction orders.  The hand kernel takes bounded group
    counts, segment-sort the high-radix regime, scatter what lies
    between.  The policy does not depend on the device: a CPU run takes
    the kernel's plain version, so the tests exercise the card's path.
    """
    if num_groups > SORT_GROUPS_THRESHOLD:
        return "sort"
    if num_groups <= KERNEL_MAX_GROUPS:
        return "kernel"
    return "scatter"


def _scatter_reduce(
    safe_key: torch.Tensor,
    validf: torch.Tensor,
    masked_fields: Mapping[str, torch.Tensor],
    num_groups: int,
):
    """count/sums via ``index_put_(accumulate=True)``, Kahan-tiled
    beyond the span bound.

    Shared by the hash (``scatter``) and segment-sort (``sort``) paths:
    fields arrive pre-masked (col * validf).  No float atomics: on a
    CUDA tensor ``index_put_`` with ``accumulate=True`` stable-sorts the
    slots and sums each slot's rows one after another in row order (on
    the CPU it adds the rows in order), so every run gives the same bits
    — the JAX package's contract that ``sort`` keeps per-group
    accumulation in row order, bit-identical to ``scatter``.
    (``index_add_`` would add atomically on the card, in an order that
    changes from run to run.)
    """
    CHUNK = 65536
    if safe_key.shape[-1] <= CHUNK:
        idx = safe_key.long()
        dev = safe_key.device

        def seg(v):
            out = torch.zeros(num_groups + 1, dtype=torch.float32, device=dev)
            return out.index_put_((idx,), v, accumulate=True)[:num_groups]

        return seg(validf), {nm: seg(col) for nm, col in masked_fields.items()}

    return _kahan_tiled_reduce(
        safe_key, validf, masked_fields, num_groups, CHUNK,
        lambda kp, vp, fp: _tiled_segment_sums(kp, vp, fp, num_groups),
    )


def group_reduce(
    key: torch.Tensor,
    valid: torch.Tensor,
    fields: Mapping[str, torch.Tensor],
    num_groups: int,
    *,
    want_minmax: bool = True,
    method: str = "auto",
) -> GroupReduceResult:
    """Segment-reduce rows into per-group count/sum/min/max.

    Invalid rows are routed to a spill group (index num_groups) and
    dropped, so padding never pollutes real groups.
    """
    if method == "auto":
        method = select_group_method(num_groups)

    dev = key.device
    validf = valid.to(torch.float32)
    safe_key = torch.where(valid, key, num_groups)

    if method == "matmul":
        # [N, G+1] one-hot contraction in full f32: integer-valued fields
        # stay exact up to 2^24 per group partial
        groups = torch.arange(num_groups + 1, dtype=torch.int32, device=dev)
        onehot = (safe_key[:, None] == groups[None, :]).to(torch.float32)
        count = (validf @ onehot)[:num_groups]
        sums = {
            name: ((col * validf) @ onehot)[:num_groups]
            for name, col in fields.items()
        }
    elif method == "matmul_tiled":
        groups = torch.arange(num_groups + 1, dtype=torch.int32, device=dev)

        def mm_partial(kp, vp, fp):
            rows = torch.cat([vp[None], fp]) if fp.shape[0] else vp[None]
            # one [R, G+1] one-hot at a time keeps the operand tile-sized
            return torch.stack(
                [
                    rows[:, t] @ (kp[t, :, None] == groups).to(torch.float32)
                    for t in range(kp.shape[0])
                ],
                dim=1,
            )

        count, sums = _kahan_tiled_reduce(
            safe_key,
            validf,
            {nm: col * validf for nm, col in fields.items()},
            num_groups,
            8192,
            mm_partial,
        )
    elif method == "scatter":
        count, sums = _scatter_reduce(
            safe_key,
            validf,
            {nm: col * validf for nm, col in fields.items()},
            num_groups,
        )
    elif method == "sort":
        # a STABLE sort by group key makes every group a contiguous run
        # and keeps per-group accumulation in row order
        order = torch.argsort(safe_key, stable=True)
        count, sums = _scatter_reduce(
            safe_key[order],
            validf[order],
            {nm: (col * validf)[order] for nm, col in fields.items()},
            num_groups,
        )
    elif method == "kernel":
        # one pass computes count + ALL field sums; min/max below ride
        # scatter_reduce_
        n = safe_key.shape[-1]
        pad = (-n) % hopper_kernels.TILE
        kp = _pad_rows(safe_key, pad, num_groups)
        vp = _pad_rows(valid, pad, False)
        names = sorted(fields.keys())
        vals = (
            torch.stack([_pad_rows(fields[nm].to(torch.float32), pad, 0.0) for nm in names])
            if names
            else torch.zeros((0, kp.shape[0]), dtype=torch.float32, device=dev)
        )
        count, sums_arr = hopper_kernels.fused_group_multi(
            kp,
            torch.ones_like(kp, dtype=torch.bool),
            vals,
            vp,
            num_groups=num_groups,
        )
        sums = {nm: sums_arr[i] for i, nm in enumerate(names)}
    else:
        raise ValueError(f"unknown group_reduce method {method!r}")

    mins: dict[str, torch.Tensor] = {}
    maxs: dict[str, torch.Tensor] = {}
    if want_minmax:
        # invalid rows are already routed to the sliced-off spill segment
        # by safe_key; the explicit +-inf start is what empty groups keep
        idx = safe_key.long()
        for name, col in fields.items():
            col = col.to(torch.float32)
            lo = torch.full((num_groups + 1,), float("inf"), device=dev)
            hi = torch.full((num_groups + 1,), float("-inf"), device=dev)
            mins[name] = lo.scatter_reduce_(0, idx, col, "amin")[:num_groups]
            maxs[name] = hi.scatter_reduce_(0, idx, col, "amax")[:num_groups]

    return GroupReduceResult(count=count, sums=sums, mins=mins, maxs=maxs)
