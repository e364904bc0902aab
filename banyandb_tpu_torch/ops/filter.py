"""Predicate-mask kernels on torch tensors.

Predicates are dense vector compares producing bool masks.  String
predicates never see raw bytes on the device: equality/IN lower to
dictionary-code compares (the host resolves the literal to its code, or
to an always-false mask when absent), mirroring the reference's
dictionary-as-exact-filter trick (docs/concept/storage-and-format.md§7.3).
"""

from __future__ import annotations

import torch

_OPS = {
    "eq": lambda c, v: c == v,
    "ne": lambda c, v: c != v,
    "lt": lambda c, v: c < v,
    "le": lambda c, v: c <= v,
    "gt": lambda c, v: c > v,
    "ge": lambda c, v: c >= v,
}


def cmp_mask(column, op: str, value):
    """Elementwise compare mask. `op` in eq/ne/lt/le/gt/ge."""
    return _OPS[op](column, value)


def in_set_mask(column, values):
    """mask[i] = column[i] in values.  `values` is a small 1-D tensor;
    lowered to a broadcast compare + any-reduce."""
    vals = torch.as_tensor(values, device=column.device)
    return (column[..., None] == vals).any(dim=-1)


def time_range_mask(ts, lo, hi):
    """Half-open [lo, hi) time-range mask over int32 ts offsets."""
    return (ts >= lo) & (ts < hi)


def mask_and(*masks):
    out = masks[0]
    for m in masks[1:]:
        out = out & m
    return out


def mask_or(*masks):
    out = masks[0]
    for m in masks[1:]:
        out = out | m
    return out


def mask_not(mask):
    return ~mask
