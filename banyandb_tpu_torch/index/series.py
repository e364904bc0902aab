"""Per-segment series index: entity tags -> seriesID.

Analog of the reference's seg-.../sidx Bluge store
(banyand/internal/storage/index.go, IndexDB surface storage.go:101:
Insert/Update/Search/SearchWithoutSeries).  Each series is one doc keyed
by seriesID whose keyword fields are the *indexed* tag values; index-mode
measures additionally store whole data points here (one doc per point,
SearchWithoutSeries short-circuit at query, measure/query.go:506).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Mapping, Optional

import numpy as np

from banyandb_tpu_torch.index.inverted import (
    And,
    Doc,
    InvertedIndex,
    Query,
    TermQuery,
)


class SeriesIndex:
    """entity/tag docs for one (group, segment)."""

    def __init__(self, path: Optional[str | Path] = None):
        self._idx = InvertedIndex(path)

    def insert_series(
        self, series_id: int, tag_values: Mapping[str, bytes]
    ) -> None:
        """Register (idempotently) a series with its indexed tag values.
        The existence probe is contains() — no doc materialisation on
        the per-data-point write hot path."""
        if not self._idx.contains(series_id):
            self._idx.insert([Doc(doc_id=series_id, keywords=dict(tag_values))])

    def update_series(
        self, series_id: int, tag_values: Mapping[str, bytes]
    ) -> None:
        self._idx.insert([Doc(doc_id=series_id, keywords=dict(tag_values))])

    def search(self, query: Query = None, limit: Optional[int] = None) -> np.ndarray:
        """-> matching seriesID array (storage.go IndexDB.Search analog)."""
        return self._idx.search(query, limit)

    def search_entity(self, entity: Mapping[str, bytes]) -> np.ndarray:
        """Exact entity lookup via an AND of term queries."""
        q = And(tuple(TermQuery(k, v) for k, v in entity.items()))
        return self._idx.search(q)

    def tags_of(self, series_id: int) -> Optional[Mapping[str, bytes]]:
        doc = self._idx.get(series_id)
        return doc.keywords if doc else None

    def persist(self) -> None:
        self._idx.persist()

    def reclaim(self) -> None:
        """Persist + release memory; reloads lazily on next access."""
        self._idx.reclaim()

    def __len__(self) -> int:
        return len(self._idx)
