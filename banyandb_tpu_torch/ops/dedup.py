"""Version dedup inside a parallel scan.

The reference dedups measure rows by keeping the max write-version per
(seriesID, timestamp) during its sequential merge-sort scan
(banyand/measure columnar read path).  Here dedup is a multi-key sort:
order rows by (series, ts, -version) and invalidate every row that
shares (series, ts) with its sorted predecessor — the survivor is
exactly the max-version row.  All operands stay int32.
"""

from __future__ import annotations

import torch

_BIG = 2147483647


def latest_by_version(
    series: torch.Tensor,
    ts: torch.Tensor,
    version: torch.Tensor,
    valid: torch.Tensor,
) -> torch.Tensor:
    """-> refined bool validity mask keeping one max-version row per key.

    Rows equal in all three keys keep their row order (the lower row
    survives), as ``lax.sort(..., num_keys=3)``, which is stable, keeps
    them: the keys are applied least significant first, each by a
    stable sort."""
    n = series.shape[-1]
    big = torch.full_like(series, _BIG)
    # invalid rows sort last (series = INT32_MAX) and stay invalid
    s = torch.where(valid, series, big)
    t = torch.where(valid, ts, big)
    negv = torch.where(valid, -version, big)
    order = torch.arange(n, device=series.device)
    for key in (negv, t, s):
        order = order[torch.argsort(key[order], stable=True)]
    s_s, t_s = s[order], t[order]
    first = torch.ones(n, dtype=torch.bool, device=series.device)
    first[1:] = (s_s[1:] != s_s[:-1]) | (t_s[1:] != t_s[:-1])
    keep = torch.zeros(n, dtype=torch.bool, device=series.device)
    keep[order] = first
    return keep & valid
