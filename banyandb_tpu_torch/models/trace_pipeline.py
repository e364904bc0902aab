"""Post-trace pipeline: tail-sampling chains gating storage events.

Analog of the reference's native-plugin trace pipeline
(docs/design/post-trace-pipeline.md, banyand/trace/pipeline_registry.go,
pipeline_chain.go, pkg/pipeline/sdk): sampler stages receive a columnar
batch of spans and return keep-masks; chains gate rows at LSM merge
(PIPELINE_EVENT_MERGE).  Instead of Go `.so` plugins (a loader the
reference itself flags as unsafe), samplers here are plain callables
registered in-process — the same vectorized contract, a safer plugin
surface (out-of-process plugins can ride the bus later).

A sampler: fn(batch: TraceBatch) -> bool mask (True = keep) or None
(= keep all).  Stages AND together, so any stage can only narrow.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from banyandb_tpu_torch.storage.part import ColumnData

EVENT_MERGE = "merge"


@dataclass
class TraceBatch:
    """Columnar span view handed to samplers (vectorized TraceBatch +
    column projection of the reference SDK)."""

    trace_name: str
    cols: ColumnData

    def __len__(self) -> int:
        return int(self.cols.ts.size)

    @property
    def ts(self) -> np.ndarray:
        return self.cols.ts

    def tag_values(self, tag: str) -> list[bytes]:
        """Decoded per-row byte values of one tag column."""
        codes = self.cols.tags.get(tag)
        if codes is None:
            return [b""] * len(self)
        d = self.cols.dicts[tag]
        return [d[c] for c in codes.tolist()]

    def tag_ints(self, tag: str) -> np.ndarray:
        """Per-row int64 view of an INT tag column."""
        codes = self.cols.tags.get(tag)
        if codes is None:
            return np.zeros(len(self), dtype=np.int64)
        d = self.cols.dicts[tag]
        vals = np.asarray(
            [int.from_bytes(v, "little", signed=True) if v else 0 for v in d],
            dtype=np.int64,
        )
        return vals[codes]


Sampler = Callable[[TraceBatch], Optional[np.ndarray]]


class TracePipelineRegistry:
    """Per-(group, trace) sampler chains (pipeline_registry.go analog)."""

    def __init__(self):
        self._chains: dict[tuple[str, str], list[Sampler]] = {}

    def register(self, group: str, trace_name: str, sampler: Sampler) -> None:
        self._chains.setdefault((group, trace_name), []).append(sampler)

    def chain(self, group: str, trace_name: str) -> list[Sampler]:
        return list(self._chains.get((group, trace_name), []))

    def merge_filter_for(self, group: str):
        """-> TSDB merge_filter callable applying this group's chains."""

        def merge_filter(kind: str, name: str, cols: ColumnData):
            if kind != "trace":
                return None
            chain = self._chains.get((group, name))
            if not chain:
                return None
            batch = TraceBatch(trace_name=name, cols=cols)
            keep = np.ones(len(batch), dtype=bool)
            for sampler in chain:
                mask = sampler(batch)
                if mask is not None:
                    keep &= np.asarray(mask, dtype=bool)
            return keep

        return merge_filter


# -- stock samplers (plugins/skywalking analog building blocks) -------------


def keep_slow_traces(duration_tag: str, threshold: int) -> Sampler:
    """Keep every span of any trace containing a span >= threshold.

    Whole-trace decisions need visibility of the whole trace: the keep
    set is remembered across batches (a slow span seen in ANY earlier
    batch protects later merges), and for a strict guarantee run the
    chain at finalize (TraceEngine.finalize_segments merges each shard
    in one pass, so the batch holds the complete segment — the
    PIPELINE_EVENT_FINALIZE analog).  Incremental merges before the
    qualifying span has been observed are best-effort.
    """
    seen_slow: set[int] = set()

    def sampler(batch: TraceBatch) -> np.ndarray:
        dur = batch.tag_ints(duration_tag)
        slow = dur >= threshold
        seen_slow.update(np.unique(batch.cols.series[slow]).tolist())
        keep_series = np.asarray(sorted(seen_slow), dtype=np.int64)
        return np.isin(batch.cols.series, keep_series)

    return sampler


def keep_tag_values(tag: str, values: set[bytes]) -> Sampler:
    """Keep spans whose tag is in the value set (error-status keeps)."""

    def sampler(batch: TraceBatch) -> np.ndarray:
        vals = batch.tag_values(tag)
        return np.asarray([v in values for v in vals], dtype=bool)

    return sampler
