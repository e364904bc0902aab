"""Top-N over group aggregates.

Replaces the reference's Go heap flow (pkg/flow/streaming/topn_heap.go and
the query-side re-rank in banyand/measure/topn_post_processor.go) with
one stable descending sort over the dense per-group aggregate vector.
"""

from __future__ import annotations

import torch

_SENTINEL = torch.finfo(torch.float32).max


def topk_groups(
    metric: torch.Tensor,
    nonempty: torch.Tensor,
    n: int,
    *,
    descending: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, group_indices) of the top-n (or bottom-n) non-empty groups.

    Empty groups sort last in either direction; callers drop entries whose
    returned value is +/-inf-sentinel by checking nonempty[indices].
    Among equal values the lower group index comes first, as with
    ``lax.top_k``: ``torch.topk`` promises no order among ties on CUDA,
    so this is a stable descending sort.
    """
    m = metric if descending else -metric
    m = torch.where(nonempty, m, torch.full_like(m, -_SENTINEL))
    vals, idx = torch.sort(m, descending=True, stable=True)
    vals, idx = vals[:n], idx[:n]
    return (vals if descending else -vals), idx.to(torch.int32)
