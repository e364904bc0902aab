"""Index subsystem: inverted index + per-segment series index.

The reference embeds Bluge (FST term dict + roaring postings,
pkg/index/inverted/inverted.go) for four stores: the per-segment series
index, index-mode measures, the Property engine, and the Stream element
index.  The engines only ever issue exact-term and numeric-range queries
(SURVEY.md §7), so this build implements exactly that contract with
sorted-array postings — NumPy-vectorized set algebra host-side (the scan
plane stays on the device).
"""

from banyandb_tpu_torch.index.inverted import Doc, InvertedIndex, TermQuery, RangeQuery, And, Or, Not
from banyandb_tpu_torch.index.series import SeriesIndex
