"""Per-group percentile/quantile kernels on torch tensors.

Device strategy: fixed-bucket histogram per group via one segment sum
over the combined (group, bucket) id, then vectorized CDF inversion with
linear interpolation inside the hit bucket.  Exactness contract: within
one bucket width over [lo, hi].
"""

from __future__ import annotations

import torch


def group_histogram(
    key: torch.Tensor,
    valid: torch.Tensor,
    values: torch.Tensor,
    num_groups: int,
    lo,
    span,
    num_buckets: int = 512,
) -> torch.Tensor:
    """-> f32 [num_groups, num_buckets] per-group counts over [lo, lo+span].

    `lo`/`span` are f32 scalars (0-d tensors or Python floats); the bucket
    arithmetic runs in f32 exactly as the JAX kernel's does.  Counts are
    integer-valued f32, so the order of the segment sum does not matter
    below 2^24 rows per bucket."""
    if (num_groups + 1) * num_buckets >= 2**31:
        # the combined (group, bucket) id must fit int32
        raise ValueError(
            f"num_groups={num_groups} x num_buckets={num_buckets} "
            "overflows int32 segment ids"
        )
    dev = values.device
    lo = torch.as_tensor(lo, dtype=torch.float32, device=dev)
    span = torch.as_tensor(span, dtype=torch.float32, device=dev)
    width = span / num_buckets
    bucket = torch.clamp(
        ((values - lo) / width).to(torch.int32), 0, num_buckets - 1
    )
    safe_key = torch.where(valid, key, num_groups)
    combined = safe_key * num_buckets + bucket
    out = torch.zeros(
        (num_groups + 1) * num_buckets, dtype=torch.float32, device=dev
    )
    out.index_add_(0, combined.long(), valid.float())
    return out.view(num_groups + 1, num_buckets)[:num_groups]


def group_percentile_histogram(
    key: torch.Tensor,
    valid: torch.Tensor,
    values: torch.Tensor,
    num_groups: int,
    quantiles,
    *,
    lo: float,
    hi: float,
    num_buckets: int = 512,
) -> torch.Tensor:
    """-> f32 [num_groups, len(quantiles)] interpolated quantile estimates.

    Values are clamped into [lo, hi]; empty groups return lo."""
    dev = values.device
    q = torch.as_tensor(quantiles, dtype=torch.float32, device=dev)
    width = (hi - lo) / num_buckets
    counts = group_histogram(
        key, valid, values, num_groups, lo, hi - lo, num_buckets
    )
    cdf = torch.cumsum(counts, dim=-1)  # [G, B]
    total = cdf[:, -1:]  # [G, 1]
    # rank of the q-quantile: ceil(q*N) clamped to [1, N] so q=0 lands on
    # the min-value bucket rather than degenerating to `lo`
    target = torch.minimum(
        torch.clamp(torch.ceil(q[None, :] * total), min=1.0),
        torch.clamp(total, min=1.0),
    )
    # first bucket whose cumulative count reaches the target rank
    hit = torch.argmax(
        (cdf[:, None, :] >= target[:, :, None]).to(torch.uint8), dim=-1
    )  # [G, Q]
    cdf_at = torch.gather(cdf, 1, hit)
    cnt_at = torch.gather(counts, 1, hit)
    prev_cdf = cdf_at - cnt_at
    frac = torch.where(
        cnt_at > 0, (target - prev_cdf) / torch.clamp(cnt_at, min=1.0), 0.0
    )
    est = lo + (hit.to(torch.float32) + torch.clamp(frac, 0.0, 1.0)) * width
    return torch.where(total > 0, est, torch.tensor(lo, dtype=torch.float32, device=dev))
