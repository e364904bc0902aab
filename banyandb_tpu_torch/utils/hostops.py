"""Host-side (NumPy) shared algorithms used by both the storage and query
layers."""

from __future__ import annotations

import numpy as np


def dedup_max_version(
    series: np.ndarray, ts: np.ndarray, version: np.ndarray
) -> np.ndarray:
    """-> sorted row indices keeping the max-version row per (series, ts).

    The write-version contract of the measure model (reference dedups at
    merge-sort time; we dedup here at merge and at query gather).  lexsort
    is ascending, so -version puts each key run's winner first.
    """
    if series.size == 0:
        return np.zeros(0, dtype=np.int64)
    order = np.lexsort((-version, ts, series))
    s_s, t_s = series[order], ts[order]
    first = np.empty(len(order), dtype=bool)
    first[0] = True
    first[1:] = (s_s[1:] != s_s[:-1]) | (t_s[1:] != t_s[:-1])
    return np.sort(order[first])
