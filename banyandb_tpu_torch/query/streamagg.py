"""Continuous streaming aggregation: materialized rolling windows at ingest.

The Enthuse-style (PAPERS.md, arXiv 2405.18168) ingest-side twin of the
fused whole-plan executor: instead of making every dashboard query
rescan parts, the signatures dashboards re-ask — exactly the PlanSpec
population the precompile registry enumerates — are *registered* here,
and each registration maintains rolling pre-aggregated windows
(count / per-field sum / min / max in exact f64 host accumulators,
keyed by the signature's tag tuple, per shard, per tumbling window
aligned to the segment clock) updated **at ingest**:

- standalone / data-node direct writes feed windows from
  ``MeasureEngine.write`` / ``write_columns`` (the same hook point as
  TopN pre-aggregation, which keeps its own window machinery in
  ``models/topn.py`` — TopN heaps stay materialized there);
- parts drained from the liaison write queue feed windows when the data
  node installs them (``cluster/data_node.py``) — the install-digest
  idempotence means an ack-lost re-ship never double-counts;
- registration (and registry reload after a restart) *backfills* from a
  parts+memtable snapshot, deduplicated by ``(series, ts)`` max version
  against any batches that raced the snapshot, so windows are rebuilt
  deterministically from part replay.

The measure planner rewrite (``MeasureEngine.query`` /
``query_partials``) answers a covered query by FOLDING window states
into a ``measure_exec.Partials`` — partial head/tail windows fall back
to a *bounded rescan of only the uncovered range* and combine through
the ordinary ``combine_partials``/``finalize_partials`` machinery, so
materialized windows merge across shards and across cluster nodes
exactly like scan partials do.  ``BYDB_STREAMAGG=0`` (A/B flag, default
on) restores the full rescan live.

Exactness contract (docs/performance.md "Continuous streaming
aggregation"): count/min/max fold exactly; sums accumulate in f64, so
the fold is byte-identical to the rescan whenever per-group sums are
exactly representable (integer-valued fields below 2^53 — the dashboard
metric shape; arbitrary-real sums may differ in the last ulp because
f64 addition is order-sensitive).  Windows assume append-only ingest:
a same-(series, ts) version REWRITE inside the horizon is the one
workload shape that diverges from the deduplicating rescan — register
signatures only on append-only measures.

Everything here is host-side numpy — the ingest update path dispatches
ZERO device kernels by design (the documented host-only kernel-budget
exemption, docs/linting.md), so the write path's dispatch budget cannot
creep through this module.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from banyandb_tpu_torch.api.model import QueryRequest, TimeRange
from banyandb_tpu_torch.obs import metrics as obs_metrics
from banyandb_tpu_torch.utils import fs, hostops
from banyandb_tpu_torch.utils.envflag import env_flag, env_int

log = logging.getLogger("banyandb.streamagg")

# the streamagg stage rides the same instrument scheme as gather /
# device_execute / merge: bench + load artifacts pick it up via
# obs/prom.stage_breakdown with no extra wiring
_H_STREAMAGG = obs_metrics.stage_histogram("streamagg")

_NEG_INF_TS = -(2**62)
_POS_INF_TS = 2**62


def _now_ms() -> int:
    import time as _time

    return int(_time.time() * 1000)


def enabled() -> bool:
    """The read-path A/B flag.  Ingest-side window maintenance always
    runs for registered signatures (a live flag flip must not leave
    gaps); the flag gates whether queries are ANSWERED from windows."""
    return env_flag("BYDB_STREAMAGG", default=True)


def default_window_ms() -> int:
    return env_int("BYDB_STREAMAGG_WINDOW_MS", 60_000)


def default_max_windows() -> int:
    return env_int("BYDB_STREAMAGG_MAX_WINDOWS", 4096)


@dataclass(frozen=True)
class SigSpec:
    """One materialized plan signature: the (group, measure) plus the
    tag tuple its window states are keyed by and the fields they
    accumulate.  A query is covered when its group-by tags AND its
    predicate tags are a subset of ``key_tags`` (the fold projects /
    filters over state keys) and its aggregate/top fields are a subset
    of ``fields``."""

    group: str
    measure: str
    key_tags: tuple[str, ...]  # sorted
    fields: tuple[str, ...]  # sorted
    window_millis: int

    def label(self) -> str:
        return (
            f"{self.group}/{self.measure}"
            f"[{','.join(self.key_tags)}]@{self.window_millis}ms"
        )


# acc layout inside one window state (per interned key id):
# [count, min_ts, max_ts, seq_first, seq_last, (sum, min, max) per field]
_ACC_FIXED = 5


class _Sig:
    """Mutable window state for one registered signature.  All fields
    are owned by the registry's lock; no method of this class exists —
    mutation happens only inside StreamAggRegistry under ``_lock``.

    Key tuples are INTERNED once per signature (``key_index`` /
    ``keys_rev``, append-only like measure_exec.GlobalDicts): window
    states key on the dense int id, closed windows freeze into numpy
    ``snapshots`` ([K] ids + [K, C] acc matrix, invalidated on touch),
    and predicate / group-projection evaluation caches per-id LUTs —
    which is what makes the fold a handful of ufunc reductions instead
    of per-state Python (the ops.groupby shape, host-side)."""

    __slots__ = (
        "spec", "windows", "covered_from", "watermark", "building",
        "pending", "max_windows", "rows", "late", "evicted",
        "key_index", "keys_rev", "snapshots", "cond_luts", "proj_luts",
        "backfill_parts", "origin", "hits", "last_hit_ms",
    )

    def __init__(self, spec: SigSpec, max_windows: int):
        self.spec = spec
        # window_start -> shard -> {key id -> acc list}
        self.windows: dict[int, dict[int, dict[int, list]]] = {}
        # every acked row with ts >= covered_from has been applied; the
        # fold may answer any window-aligned range at/after it
        self.covered_from = _POS_INF_TS  # until backfill completes
        self.watermark = _NEG_INF_TS  # max event ts applied
        self.building = True  # backfill in flight: buffer, don't serve
        self.pending: list[tuple] = []  # batches raced during backfill
        self.max_windows = max_windows
        self.rows = 0
        self.late = 0
        self.evicted = 0
        # key interning + fold caches (all append-only / invalidate-on-
        # touch, rebuilt lazily)
        self.key_index: dict[tuple, int] = {}
        self.keys_rev: list[tuple] = []
        self.snapshots: dict[tuple, tuple] = {}  # (w, shard) -> (ids, mat)
        self.cond_luts: dict[tuple, np.ndarray] = {}  # (op, val) -> bool[n]
        # group_tags -> (proj_index, proj_rev, id->gid int64 LUT)
        self.proj_luts: dict[tuple, tuple] = {}
        # part identities the registration backfill consumed: a part
        # introduced before the source snapshot whose install hook only
        # fires AFTER building flips off must not apply twice
        self.backfill_parts: frozenset = frozenset()
        # provenance + serve-hit stats (the autoreg eviction evidence:
        # least-recently-HIT auto signatures evict first, manual
        # registrations are never auto-evicted)
        self.origin = "manual"
        self.hits = 0
        self.last_hit_ms = 0


@dataclass
class Cover:
    """A resolved coverage plan for one query (``plan_cover`` output)."""

    sig: _Sig
    group_tags: tuple[str, ...]
    fields: tuple[str, ...]  # sorted, mirrors compute_partials' set
    conds: list  # [(key_index, op, value bytes | frozenset[bytes])]
    want_minmax: bool
    want_rep: bool
    rep_desc: bool
    cov_lo: int  # folded window range [cov_lo, cov_hi)
    cov_hi: int
    head: Optional[tuple[int, int]]  # uncovered [begin, cov_lo)
    tail: Optional[tuple[int, int]]  # uncovered [cov_hi, end)

    @property
    def kind(self) -> str:
        return "partial" if (self.head or self.tail) else "covered"


_COVERED_OPS = ("eq", "ne", "in", "not_in")


class CoverageLost(Exception):
    """Raised by the fold when the planned window range was evicted (or
    reset) between plan_cover and the fold's locked read — the caller
    falls back to the full rescan instead of answering with a gap."""


def coldata_tag_col(src, tag: str, n: int) -> np.ndarray:
    """Canonical per-row tag bytes from a ColumnData source (absent
    column = the empty value, same convention as merge/gather)."""
    codes = src.tags.get(tag)
    if codes is None:
        return np.full(n, b"", dtype=object)
    return np.asarray(src.dicts[tag], dtype=object)[np.asarray(codes)]


def coldata_field_col(src, field: str, n: int) -> np.ndarray:
    """f64 field column from a ColumnData source (absent = zeros)."""
    col = src.fields.get(field)
    if col is None:
        return np.zeros(n, dtype=np.float64)
    return np.asarray(col, dtype=np.float64)


class StreamAggRegistry:
    """Per-MeasureEngine registry of materialized signatures.

    Lock discipline: ``_lock`` is a LEAF lock — nothing else is ever
    acquired while holding it (backfill gathers its source snapshot
    before taking it; the fold is pure dict work), so it can never
    participate in a lock-order cycle with the storage/engine lock
    families.  ``_active`` / ``_by_measure`` are immutable snapshots
    rebound under the lock and read lock-free on the ingest hot path
    (the Liaison.alive idiom)."""

    def __init__(self, engine):
        self.engine = engine
        self._lock = threading.Lock()
        self._sigs: dict[SigSpec, _Sig] = {}
        # ingest drain gate: write paths ticket in before appending to
        # the memtable and out after their observe() — register() waits
        # for pre-snapshot writers to drain before leaving `building`,
        # so a write in flight across the whole backfill cannot re-apply
        # rows the snapshot already consumed (see register())
        self._ingest_enter = 0
        self._ingest_exit = 0
        # lock-free fast-path snapshots (rebound, never mutated)
        self._active: frozenset = frozenset()  # {(group, measure)}
        self._by_measure: dict[tuple, tuple] = {}  # (g, m) -> (_Sig, ...)
        self._needs: dict[tuple, tuple] = {}  # (g, m) -> (tags, fields)
        self._seq = 0
        self._store = Path(engine.root) / "streamagg-registry.json"
        self._meter = obs_metrics.global_meter()
        # BYDB_STREAMAGG_AUTOLOAD=0 defers the persisted-registry reload
        # to an explicit load_persisted() call.  Shard-owning worker
        # processes (cluster/workers.py) boot with it off: the parent
        # replays its write journal into the fresh memtable FIRST, then
        # triggers the load — so the registration backfill's
        # (series, ts, version) dedup sees replayed rows and parts in
        # ONE snapshot instead of double-folding rows that are in both.
        from banyandb_tpu_torch.utils.envflag import env_flag

        if env_flag("BYDB_STREAMAGG_AUTOLOAD", True):
            self._load()

    # -- registration / persistence -----------------------------------------
    def active(self, group: str, measure: str) -> bool:
        return (group, measure) in self._active

    def ingest_enter(self) -> None:
        """Write-path ticket (taken BEFORE the memtable append, released
        after observe()): lets register() drain in-flight writers before
        it stops buffering — see register()."""
        with self._lock:
            self._ingest_enter += 1

    def ingest_exit(self) -> None:
        with self._lock:
            self._ingest_exit += 1

    def _drain_ingest(self, timeout_s: float = 10.0) -> None:
        """Wait until every writer ticketed in before NOW has exited.
        Writers entering later observe into `pending` (the signature
        already exists), so they need no wait."""
        import time as _time

        with self._lock:
            target = self._ingest_enter
        end = _time.monotonic() + timeout_s
        while _time.monotonic() < end:
            with self._lock:
                if self._ingest_exit >= target:
                    return
            _time.sleep(0.005)
        log.warning(
            "streamagg: ingest drain timed out before backfill apply "
            "(a wedged writer may double-apply pre-snapshot rows)"
        )

    def needs(self, group: str, measure: str) -> Optional[tuple]:
        """(key tag union, field union) across this measure's signatures,
        or None — the data node's install hook checks this before paying
        a part read."""
        return self._needs.get((group, measure))

    def register(
        self,
        group: str,
        measure: str,
        key_tags,
        fields,
        window_millis: Optional[int] = None,
        max_windows: Optional[int] = None,
        origin: str = "manual",
    ) -> dict:
        """Register (idempotent) one materialized signature and backfill
        its windows from the engine's current parts + memtables.

        Backfill is linearizable with concurrent ingest: the signature
        is installed (``building``) BEFORE the source snapshot is taken,
        racing ingest batches buffer into ``pending``, and the final
        apply deduplicates snapshot+pending rows by (series, ts) max
        version — a row seen by both counts once, a row seen by neither
        cannot exist (it either landed before the snapshot or after the
        signature was installed)."""
        m = self.engine.registry.get_measure(group, measure)
        if m.index_mode:
            raise ValueError(
                f"streamagg: index-mode measure {group}/{measure} has no "
                "scan path to materialize"
            )
        tag_names = {t.name for t in m.tags}
        key_tags = tuple(sorted(dict.fromkeys(key_tags)))
        for t in key_tags:
            if t not in tag_names:
                raise KeyError(f"streamagg: unknown tag {t!r} on {measure}")
        from banyandb_tpu_torch.api.schema import FieldType as _FT

        numeric = {
            f.name
            for f in m.fields
            if f.type not in (_FT.STRING, _FT.DATA_BINARY)
        }
        fields = tuple(sorted(dict.fromkeys(fields)))
        for f in fields:
            if f not in numeric:
                raise KeyError(
                    f"streamagg: {f!r} is not a numeric field of {measure}"
                )
        opts = self.engine.registry.get_group(group).resource_opts
        w = int(window_millis or default_window_ms())
        if w <= 0 or opts.segment_interval.millis % w != 0:
            # window rotation must align to the segment clock: a window
            # spanning a segment boundary would fold rows a segment-
            # pruned rescan could not see
            raise ValueError(
                f"streamagg: window {w}ms must divide the segment "
                f"interval ({opts.segment_interval.millis}ms)"
            )
        spec = SigSpec(group, measure, key_tags, fields, w)
        sig = _Sig(spec, int(max_windows or default_max_windows()))
        sig.origin = origin if origin in ("manual", "auto") else "manual"
        # registration grace stamp: the autoreg LRU evictor compares a
        # candidate's evidence time against this — a just-registered
        # signature must not be displaced by the NEXT candidate of the
        # same mining cycle before it ever had a chance to serve
        sig.last_hit_ms = _now_ms()
        existing_out = None
        promoted = False
        with self._lock:
            existing = self._sigs.get(spec)
            if existing is not None:
                if origin == "manual" and existing.origin == "auto":
                    # an operator re-registering an auto signature
                    # PROMOTES it: manual registrations never auto-evict
                    existing.origin = "manual"
                    promoted = True
                existing_out = self._stats_one_locked(existing)
        if existing_out is not None:
            if promoted:
                self._persist()
            return existing_out
        # per-tenant registration cap (docs/robustness.md "Multi-tenant
        # QoS"): a NEW signature must fit its tenant's quota — one
        # tenant registering signatures cannot grow another tenant's
        # node state (generous default: unlimited).  Idempotent
        # re-registration returned above and is never gated.
        from banyandb_tpu_torch.qos.plane import global_qos as _global_qos
        from banyandb_tpu_torch.qos.tenancy import tenant_of_group as _tenant_of

        _tenant = _tenant_of(group)
        with self._lock:
            if spec in self._sigs:  # raced a concurrent register
                return self._stats_one_locked(self._sigs[spec])
            # count + admit + install under ONE critical section, or
            # two concurrent registrations could both squeeze past the
            # cap (the plane's lock nests under this one; nothing takes
            # them in the opposite order)
            _existing_n = sum(
                1 for s in self._sigs if _tenant_of(s.group) == _tenant
            )
            _global_qos().admit_streamagg(group, _existing_n)
            self._sigs[spec] = sig
            self._rebind_snapshots_locked()
        try:
            batches, part_ids = self._backfill_snapshot(spec)
            # writers that began before the snapshot may still be
            # between their memtable append (in the snapshot) and their
            # observe() call — wait them out so those observes land in
            # `pending`, where the (series, ts, version) dedup collapses
            # the overlap, instead of re-applying after building flips
            self._drain_ingest()
        except Exception:
            with self._lock:
                self._sigs.pop(spec, None)
                self._rebind_snapshots_locked()
            raise
        with self._lock:
            batches.extend(sig.pending)
            sig.pending = []
            sig.backfill_parts = frozenset(part_ids)
            # coverage opens BEFORE the apply: backfill rows land in
            # their (pre-horizon) windows instead of dropping as late
            sig.covered_from = _NEG_INF_TS
            self._apply_deduped_locked(sig, batches)
            sig.building = False
            self._evict_locked(sig)
            out = self._stats_one_locked(sig)
        self._persist()
        return out

    def _rebind_snapshots_locked(self) -> None:
        self._active = frozenset(
            (s.group, s.measure) for s in self._sigs
        )
        by: dict[tuple, list] = {}
        needs: dict[tuple, tuple] = {}
        for spec, sig in self._sigs.items():
            key = (spec.group, spec.measure)
            by.setdefault(key, []).append(sig)
            tags, flds = needs.get(key, ((), ()))
            needs[key] = (
                tuple(sorted(set(tags) | set(spec.key_tags))),
                tuple(sorted(set(flds) | set(spec.fields))),
            )
        self._by_measure = {k: tuple(v) for k, v in by.items()}
        self._needs = needs

    def _persist(self) -> None:
        with self._lock:
            doc = {
                "signatures": [
                    {
                        "group": s.group,
                        "measure": s.measure,
                        "key_tags": list(s.key_tags),
                        "fields": list(s.fields),
                        "window_millis": s.window_millis,
                        "origin": sig.origin,
                    }
                    for s, sig in self._sigs.items()
                ]
            }
        try:
            self._store.parent.mkdir(parents=True, exist_ok=True)
            fs.atomic_write_json(self._store, doc)
        except OSError:
            log.exception("streamagg registry persist failed (state kept)")

    def unregister(
        self,
        group: str,
        measure: str,
        key_tags,
        fields,
        window_millis: Optional[int] = None,
    ) -> bool:
        """Drop one materialized signature (the autoreg eviction path;
        also an operator surface via the ``streamagg`` topic).  All
        window state is released; queries it covered fall back to the
        scan path on their next plan_cover.  -> True when a signature
        was actually removed."""
        key_tags = tuple(sorted(dict.fromkeys(key_tags)))
        fields = tuple(sorted(dict.fromkeys(fields)))
        w = int(window_millis or 0)
        with self._lock:
            match = None
            for spec in self._sigs:
                if (
                    spec.group == group
                    and spec.measure == measure
                    and spec.key_tags == key_tags
                    and spec.fields == fields
                    and (w == 0 or spec.window_millis == w)
                ):
                    match = spec
                    break
            if match is None:
                return False
            self._sigs.pop(match)
            self._rebind_snapshots_locked()
        self._persist()
        log.info(
            "streamagg: unregistered %s/%s[%s]",
            group, measure, ",".join(key_tags),
        )
        return True

    def load_persisted(self) -> int:
        """Explicit persisted-registry reload for deferred-autoload
        processes (the worker-restart sequence: replay, THEN load).
        Idempotent — register() returns existing state for known
        signatures.  -> number of persisted records processed."""
        return self._load()

    def _load(self) -> int:
        """Reload persisted registrations (engine restart): each one
        re-registers with a fresh backfill, rebuilding windows
        deterministically from whatever parts survived on disk — the
        wqueue replay then installs (and window-feeds) anything that was
        in flight, and install-digest dedup keeps re-ships single."""
        try:
            if not self._store.exists():
                return 0
            doc = fs.read_json(self._store)
        except (OSError, ValueError):
            return 0
        recs = doc.get("signatures", [])
        for rec in recs:
            try:
                self.register(
                    rec["group"], rec["measure"],
                    key_tags=rec.get("key_tags", ()),
                    fields=rec.get("fields", ()),
                    window_millis=rec.get("window_millis"),
                    origin=rec.get("origin", "manual"),
                )
            except Exception:  # noqa: BLE001 — a stale entry (dropped
                # measure, renamed tag) must not take the engine down
                log.exception("streamagg: stale registration %r skipped", rec)
        return len(recs)

    # -- backfill ------------------------------------------------------------
    def _backfill_snapshot(self, spec: SigSpec) -> tuple[list, set]:
        """(batches, consumed part ids): one batch (ts, series, version,
        shards, keycols, fieldcols) per source the engine currently
        holds — parts and memtables, per shard (windows are shard-keyed
        so distributed folds can honor the scatter's shard subset) —
        plus the part-dir identities the snapshot consumed, so a raced
        install hook for one of THESE parts can be skipped instead of
        applied twice.  Takes NO registry lock: storage locks are
        acquired inside the engine, and the leaf-lock discipline
        forbids nesting them under ours."""
        shard_num = self.engine.registry.get_group(
            spec.group
        ).resource_opts.shard_num
        req = QueryRequest(
            groups=(spec.group,),
            name=spec.measure,
            time_range=TimeRange(0, _POS_INF_TS),
        )
        batches: list[tuple] = []
        part_ids: set = set()
        for shard in range(shard_num):
            sources = self.engine.gather_query_sources(
                req, shard_ids={shard}
            )
            for src in sources or ():
                n = int(src.ts.size)
                if n == 0:
                    continue
                ck = src.cache_key
                if ck and ck[0] == "part_read":
                    part_ids.add(ck[1])  # str(part dir)
                batches.append((
                    np.asarray(src.ts, dtype=np.int64),
                    np.asarray(src.series, dtype=np.int64),
                    np.asarray(src.version, dtype=np.int64),
                    np.full(n, shard, dtype=np.int64),
                    [coldata_tag_col(src, t, n) for t in spec.key_tags],
                    [coldata_field_col(src, f, n) for f in spec.fields],
                ))
        return batches, part_ids

    def _apply_deduped_locked(self, sig: _Sig, batches: list[tuple]) -> None:
        """Concatenate batches, dedup by (series, ts) keeping the max
        version — the rescan's own dedup contract — then apply.  Exact
        duplicates (a part in the snapshot AND its raced install hook)
        collapse to one row here."""
        if not batches:
            return
        ts = np.concatenate([b[0] for b in batches])
        series = np.concatenate([b[1] for b in batches])
        version = np.concatenate([b[2] for b in batches])
        shards = np.concatenate([b[3] for b in batches])
        nk = len(sig.spec.key_tags)
        nf = len(sig.spec.fields)
        keycols = [
            np.concatenate([b[4][i] for b in batches]) for i in range(nk)
        ]
        fcols = [
            np.concatenate([b[5][i] for b in batches]) for i in range(nf)
        ]
        keep = hostops.dedup_max_version(series, ts, version)
        self._apply_locked(
            sig,
            ts[keep],
            shards[keep],
            [c[keep] for c in keycols],
            [c[keep] for c in fcols],
        )

    # -- ingest --------------------------------------------------------------
    def observe(
        self,
        group: str,
        measure: str,
        *,
        ts,
        series,
        versions,
        shards,
        tag_col: Callable[[str], np.ndarray],
        field_col: Callable[[str], np.ndarray],
        part_id: Optional[str] = None,
    ) -> None:
        """Feed one ingest batch through every signature of (group,
        measure).  ``tag_col(tag)`` -> object array of canonical bytes
        per row; ``field_col(field)`` -> f64 array — callables so only
        registered columns pay materialization.  ``shards`` is an int
        array or a scalar shard id.  ``part_id`` (install hooks) names
        the part dir: a part the registration backfill already consumed
        is skipped here — its hook raced past ``building`` — while a
        batch arriving DURING backfill buffers into ``pending``, where
        the (series, ts, version) dedup collapses it."""
        if (group, measure) not in self._active:
            return
        ts = np.asarray(ts, dtype=np.int64)
        n = int(ts.size)
        if n == 0:
            return
        if np.isscalar(shards) or getattr(shards, "ndim", 1) == 0:
            shards = np.full(n, int(shards), dtype=np.int64)
        else:
            shards = np.asarray(shards, dtype=np.int64)
        tag_cache: dict[str, np.ndarray] = {}
        field_cache: dict[str, np.ndarray] = {}

        def _tag(t: str) -> np.ndarray:
            c = tag_cache.get(t)
            if c is None:
                c = tag_cache[t] = np.asarray(tag_col(t), dtype=object)
            return c

        def _field(f: str) -> np.ndarray:
            c = field_cache.get(f)
            if c is None:
                c = field_cache[f] = np.asarray(
                    field_col(f), dtype=np.float64
                )
            return c

        with self._lock:
            for sig in self._by_measure.get((group, measure), ()):
                if (
                    part_id is not None
                    and not sig.building
                    and part_id in sig.backfill_parts
                ):
                    continue  # backfill already folded this part's rows
                keycols = [_tag(t) for t in sig.spec.key_tags]
                fcols = [_field(f) for f in sig.spec.fields]
                if sig.building:
                    sig.pending.append((
                        ts,
                        np.asarray(series, dtype=np.int64),
                        np.asarray(versions, dtype=np.int64)
                        if versions is not None
                        else np.zeros(n, dtype=np.int64),
                        shards,
                        keycols,
                        fcols,
                    ))
                else:
                    self._apply_locked(sig, ts, shards, keycols, fcols)
                    self._evict_locked(sig)

    def _apply_locked(
        self,
        sig: _Sig,
        ts: np.ndarray,
        shards: np.ndarray,
        keycols: list[np.ndarray],
        fcols: list[np.ndarray],
    ) -> None:
        """Vectorized window accumulation: rows collapse to their
        distinct (window, shard, key-tuple) combos via chained
        np.unique factorization, then each combo folds with bincount /
        ufunc-at reductions — per-row Python never runs."""
        n = int(ts.size)
        if n == 0:
            return
        W = sig.spec.window_millis
        win = ts - (ts % W)
        # chained pairing: after each step the code domain re-compacts
        # to <= n, so the int64 pair key never overflows
        _, codes = np.unique(win, return_inverse=True)
        domain = int(codes.max()) + 1 if n else 1
        for col in (shards, *keycols):
            _, c = np.unique(col, return_inverse=True)
            d = int(c.max()) + 1
            pair = codes.astype(np.int64) * d + c
            _, codes = np.unique(pair, return_inverse=True)
            domain = int(codes.max()) + 1
        uniq, first_idx = np.unique(codes, return_index=True)
        k = int(uniq.size)
        counts = np.bincount(codes, minlength=k).astype(np.float64)
        tmin = np.full(k, _POS_INF_TS, dtype=np.int64)
        tmax = np.full(k, _NEG_INF_TS, dtype=np.int64)
        np.minimum.at(tmin, codes, ts)
        np.maximum.at(tmax, codes, ts)
        fsums, fmins, fmaxs = [], [], []
        for col in fcols:
            fsums.append(np.bincount(codes, weights=col, minlength=k))
            mn = np.full(k, np.inf, dtype=np.float64)
            mx = np.full(k, -np.inf, dtype=np.float64)
            np.minimum.at(mn, codes, col)
            np.maximum.at(mx, codes, col)
            fmins.append(mn)
            fmaxs.append(mx)
        self._seq += 1
        batch_seq = self._seq
        applied = 0
        key_index = sig.key_index
        # combos process in FIRST-ROW order (np.unique returns them in
        # sorted-key order): new accs then take their seq in batch
        # arrival order, which is the same tie-break the rescan's row
        # index applies for rows sharing a timestamp — and makes the
        # registration backfill (one batch in gather order) reproduce
        # the rescan's first-appearance order exactly.  Ties across
        # separately-ingested batches/shards remain implementation-
        # defined on BOTH paths (a flush re-sorts part rows by
        # (series, ts), so the rescan itself reorders such ties).
        for j in np.argsort(first_idx, kind="stable").tolist():
            i = int(first_idx[j])
            w = int(win[i])
            if w < sig.covered_from:
                # window already evicted: the fold never reads below
                # covered_from, so applying would only leak memory —
                # the uncovered range falls back to rescan regardless
                sig.late += int(counts[j])
                self._meter.counter_add(
                    "streamagg_late_dropped", float(counts[j])
                )
                continue
            shard = int(shards[i])
            key = tuple(c[i] for c in keycols)
            kid = key_index.get(key)
            if kid is None:
                kid = key_index[key] = len(sig.keys_rev)
                sig.keys_rev.append(key)
            states = sig.windows.setdefault(w, {}).setdefault(shard, {})
            # the frozen fold snapshot of this window-shard is stale now
            sig.snapshots.pop((w, shard), None)
            acc = states.get(kid)
            if acc is None:
                self._seq += 1
                acc = states[kid] = [
                    0.0, _POS_INF_TS, _NEG_INF_TS, self._seq, self._seq,
                ] + [0.0, np.inf, -np.inf] * len(fcols)
            acc[0] += float(counts[j])
            acc[1] = min(acc[1], int(tmin[j]))
            acc[2] = max(acc[2], int(tmax[j]))
            acc[4] = batch_seq
            for fi in range(len(fcols)):
                base = _ACC_FIXED + 3 * fi
                acc[base] += float(fsums[fi][j])
                acc[base + 1] = min(acc[base + 1], float(fmins[fi][j]))
                acc[base + 2] = max(acc[base + 2], float(fmaxs[fi][j]))
            applied += int(counts[j])
        sig.rows += applied
        hw = int(ts.max())
        if hw > sig.watermark:
            sig.watermark = hw
        if applied:
            self._meter.counter_add("streamagg_rows", float(applied))

    def invalidate(
        self,
        group: str,
        measure: str,
        reason: str = "",
        up_to: Optional[int] = None,
    ) -> None:
        """Poison coverage after a failed ingest-side update (e.g. an
        install hook that could not read its part): rows may be missing
        from the windows, so serving them would silently under-count.
        Every window at/below max(watermark, ``up_to``) drops and
        ``covered_from`` jumps past it — queries over the gap fall back
        to rescan, and coverage resumes from the next full window of
        NEW data.  ``up_to`` is the failed data's max event ts (the
        part meta's max_ts — it may lie ABOVE the watermark); None =
        unknown extent, which disables coverage entirely until the
        signature is re-registered."""
        with self._lock:
            for sig in self._by_measure.get((group, measure), ()):
                W = sig.spec.window_millis
                basis = max(
                    sig.watermark,
                    up_to if up_to is not None else _POS_INF_TS,
                )
                horizon = (
                    basis - (basis % W) + 2 * W
                    if _NEG_INF_TS < basis < _POS_INF_TS
                    else _POS_INF_TS
                )
                sig.covered_from = max(sig.covered_from, horizon)
                for w in [x for x in sig.windows if x < sig.covered_from]:
                    dropped = sig.windows.pop(w)
                    for shard in dropped:
                        sig.snapshots.pop((w, shard), None)
                self._meter.counter_add(
                    "streamagg_invalidated", 1.0
                )
        log.warning(
            "streamagg: coverage invalidated for %s/%s (%s); affected "
            "ranges rescan until fresh windows accumulate",
            group, measure, reason,
        )

    def _evict_locked(self, sig: _Sig) -> None:
        """Rolling horizon: past ``max_windows`` the OLDEST window is
        dropped and ``covered_from`` advances past it — queries into the
        evicted range fall back to (head) rescan, never read a gap."""
        while len(sig.windows) > sig.max_windows:
            oldest = min(sig.windows)
            dropped = sig.windows.pop(oldest)
            for shard in dropped:
                sig.snapshots.pop((oldest, shard), None)
            sig.evicted += sum(len(s) for s in dropped.values())
            sig.covered_from = max(
                sig.covered_from, oldest + sig.spec.window_millis
            )
            self._meter.counter_add("streamagg_windows_evicted", 1.0)
        if len(sig.keys_rev) > (1 << 20):
            # tag-churn guard (the measure_exec persistent-group cap
            # analog): an unbounded intern table means unbounded LUTs —
            # drop ALL window state and restart coverage at the next
            # window boundary; queries over the gap rescan
            sig.windows.clear()
            sig.snapshots.clear()
            sig.cond_luts.clear()
            sig.proj_luts.clear()
            sig.key_index.clear()
            sig.keys_rev.clear()
            W = sig.spec.window_millis
            sig.covered_from = (
                sig.watermark - (sig.watermark % W) + 2 * W
                if sig.watermark > _NEG_INF_TS
                else _POS_INF_TS
            )

    # -- query rewrite -------------------------------------------------------
    def plan_cover(self, m, req: QueryRequest) -> Optional[Cover]:
        """Coverage decision for one aggregate query: the Cover names
        the signature to fold, the folded window range, and the
        uncovered head/tail ranges the caller must rescan.  None =
        answer by full rescan (shape not materializable, no signature,
        flag off, or no usable full window in range)."""
        if not enabled():
            return None
        key = (m.group, m.name)
        if key not in self._active:
            return None
        cover = self._plan_cover_inner(m, req)
        self._meter.counter_add(
            "streamagg_reads", 1.0,
            {"kind": cover.kind if cover is not None else "fallback"},
        )
        return cover

    def _plan_cover_inner(self, m, req: QueryRequest) -> Optional[Cover]:
        from banyandb_tpu_torch.query import measure_exec

        if req.group_by is not None and req.group_by.field_name:
            return None
        group_tags = (
            tuple(req.group_by.tag_names) if req.group_by else ()
        )
        agg = req.agg
        if agg is not None and agg.function not in (
            "count", "sum", "mean", "min", "max",
        ):
            return None  # percentile histograms are range-dependent
        try:
            conds, expr = measure_exec._lower_criteria(req.criteria)
        except ValueError:
            return None
        if expr:
            return None  # OR trees: disjuncts cannot filter state keys
        tag_names = {t.name for t in m.tags}
        for c in conds:
            if c.op not in _COVERED_OPS or c.name not in tag_names:
                return None
        # representative (projected-but-not-grouped) tags need the first
        # scanned ROW's values — windows keep no rows, so fall back
        from banyandb_tpu_torch.api.schema import FieldType as _FT

        schema_fields = {f.name for f in m.fields}
        known = {
            f.name
            for f in m.fields
            if f.type not in (_FT.STRING, _FT.DATA_BINARY)
        }
        for t in req.tag_projection:
            if t in group_tags or t in schema_fields:
                continue
            return None
        fields = {f for f in req.field_projection if f in known}
        if agg:
            fields.add(agg.field_name)
        if req.top:
            fields.add(req.top.field_name)
        b = req.time_range.begin_millis
        e = req.time_range.end_millis
        want_rep = bool(group_tags)
        if want_rep and e - b >= 2**31:
            # the rescan drops scan-order tracking past an int32 ts span
            # and orders canonically instead — don't try to mirror that
            return None
        needed_tags = set(group_tags) | {c.name for c in conds}
        try:
            lits = [
                (
                    c.name,
                    c.op,
                    frozenset(
                        measure_exec._tag_value_bytes(v) for v in c.value
                    )
                    if c.op in ("in", "not_in")
                    else measure_exec._tag_value_bytes(c.value),
                )
                for c in conds
            ]
        except TypeError:
            return None
        with self._lock:
            best: Optional[_Sig] = None
            for sig in self._by_measure.get((m.group, m.name), ()):
                if sig.building:
                    continue
                if not needed_tags <= set(sig.spec.key_tags):
                    continue
                if not fields <= set(sig.spec.fields):
                    continue
                if best is None or len(sig.spec.key_tags) < len(
                    best.spec.key_tags
                ):
                    best = sig
            if best is None:
                return None
            W = best.spec.window_millis
            c0 = -(-b // W) * W
            c1 = (e // W) * W
            cov_lo = max(c0, best.covered_from)
            if cov_lo >= c1:
                return None  # no full covered window in range
            key_index = {t: i for i, t in enumerate(best.spec.key_tags)}
            return Cover(
                sig=best,
                group_tags=group_tags,
                fields=tuple(sorted(fields)),
                conds=[(key_index[nm], op, v) for nm, op, v in lits],
                want_minmax=(
                    not agg
                    or agg.function in ("min", "max")
                ),
                want_rep=want_rep,
                rep_desc=req.order_by_ts == "desc",
                cov_lo=cov_lo,
                cov_hi=c1,
                head=(b, cov_lo) if b < cov_lo else None,
                tail=(c1, e) if c1 < e else None,
            )

    def answer(
        self,
        cover: Cover,
        *,
        shard_ids=None,
        rescan: Callable[[int, int], object],
        span=None,
    ) -> Optional[list]:
        """Materialized partials for a covered query: fold the window
        states, rescan only the uncovered head/tail sub-ranges, return
        the partials list (head, fold, tail) for the ordinary
        combine/finalize tail.  ``rescan(begin, end)`` -> Partials over
        exactly that sub-range through the caller's normal scan path.

        The fold runs FIRST: if eviction (or the intern-cap reset)
        advanced the covered horizon past the planned range between
        plan_cover and here, the fold raises CoverageLost and this
        returns None — the caller falls back to the full rescan rather
        than answering with a window-shaped gap.  The partials keep the
        (head, fold, tail) order regardless of execution order."""
        import time as _time

        t0 = _time.perf_counter()
        head_ms = tail_ms = 0.0
        try:
            fold = self._fold(cover, shard_ids)
        except CoverageLost:
            self._meter.counter_add(
                "streamagg_reads", 1.0, {"kind": "lost"}
            )
            if span is not None:
                span.tag("coverage", "lost")
            return None
        parts = []
        if cover.head is not None:
            th = _time.perf_counter()
            parts.append(rescan(*cover.head))
            head_ms = (_time.perf_counter() - th) * 1000
        parts.append(fold)
        if cover.tail is not None:
            tt = _time.perf_counter()
            parts.append(rescan(*cover.tail))
            tail_ms = (_time.perf_counter() - tt) * 1000
        total_ms = (_time.perf_counter() - t0) * 1000
        _H_STREAMAGG.observe(total_ms)
        if span is not None:
            span.tag("signature", cover.sig.spec.label()).tag(
                "coverage", cover.kind
            ).tag(
                "windows",
                int((cover.cov_hi - cover.cov_lo)
                    // cover.sig.spec.window_millis),
            ).tag("groups", int(fold.count.size)).tag(
                "head_rescan_ms", round(head_ms, 3)
            ).tag("tail_rescan_ms", round(tail_ms, 3))
        return parts

    def _snapshot_locked(self, sig: _Sig, w: int, shard: int, states) -> tuple:
        """Frozen ([K] key ids, [K, C] acc matrix) for one window-shard,
        cached until the next apply touches it.  Covered windows are
        CLOSED windows, so in steady state every fold reuses these and
        the per-state Python cost is paid once per window, not per
        query.  The arrays are never mutated after construction (touch
        pops the cache entry; a rebuild makes new arrays), so readers
        may use them outside the lock."""
        snap = sig.snapshots.get((w, shard))
        if snap is None:
            k = len(states)
            ids = np.fromiter(states.keys(), np.int64, count=k)
            mat = np.asarray(
                list(states.values()), dtype=np.float64
            ).reshape(k, _ACC_FIXED + 3 * len(sig.spec.fields))
            snap = sig.snapshots[(w, shard)] = (ids, mat)
        return snap

    def _cond_mask_locked(self, sig: _Sig, conds: list):
        """AND-combined bool LUT over interned key ids for the covered
        predicate set; per-condition LUTs cache append-only (extension
        rebinds a NEW array, so captured references stay frozen).
        Bytes equality over the same canonical entity-bytes domain the
        rescan's global-code comparison resolves to."""
        if not conds:
            return None
        n = len(sig.keys_rev)
        rev = sig.keys_rev
        out = None
        for idx, op, val in conds:
            ck = (idx, op, val)
            lut = sig.cond_luts.get(ck)
            start = 0 if lut is None else len(lut)
            if start < n:
                tail = np.empty(n - start, dtype=bool)
                if op == "eq":
                    for i in range(start, n):
                        tail[i - start] = rev[i][idx] == val
                elif op == "ne":
                    for i in range(start, n):
                        tail[i - start] = rev[i][idx] != val
                elif op == "in":
                    for i in range(start, n):
                        tail[i - start] = rev[i][idx] in val
                else:  # not_in
                    for i in range(start, n):
                        tail[i - start] = rev[i][idx] not in val
                lut = tail if lut is None else np.concatenate([lut, tail])
                sig.cond_luts[ck] = lut
            out = lut if out is None else (out & lut)
        return out

    def _proj_lut_locked(self, sig: _Sig, group_tags: tuple) -> tuple:
        """key id -> group id LUT for one group-by projection, plus the
        group-tuple intern table (append-only, extended lazily as new
        key tuples appear)."""
        entry = sig.proj_luts.get(group_tags)
        if entry is None:
            entry = ({}, [], np.zeros(0, dtype=np.int64))
        proj_index, proj_rev, lut = entry
        n = len(sig.keys_rev)
        if len(lut) < n:
            proj = [sig.spec.key_tags.index(t) for t in group_tags]
            tail = np.empty(n - len(lut), dtype=np.int64)
            for i in range(len(lut), n):
                g = tuple(sig.keys_rev[i][j] for j in proj)
                gid = proj_index.get(g)
                if gid is None:
                    gid = proj_index[g] = len(proj_rev)
                    proj_rev.append(g)
                tail[i - len(lut)] = gid
            lut = np.concatenate([lut, tail]) if len(lut) else tail
            sig.proj_luts[group_tags] = (proj_index, proj_rev, lut)
        return proj_index, proj_rev, lut

    def _fold(self, cover: Cover, shard_ids=None):
        """Window states -> one Partials, mirroring the rescan's shape:
        per-group f64 count/sums (+ real min/max when the aggregate
        needs them, untouched ±inf otherwise, exactly like the device
        path), first-appearance rep keys (group min/max event ts; the
        acc seq is the row-order tie-break the rescan's local row index
        plays), field_stats for the percentile range round.

        Vectorized end-to-end: frozen window snapshots concatenate,
        predicates gather through cached id LUTs, and the cross-window
        group merge is np.unique + bincount / ufunc-at — the host-side
        shape of ops.group_reduce, never per-state Python in the query
        path."""
        from banyandb_tpu_torch.query.measure_exec import Partials

        sig = cover.sig
        spec = sig.spec
        flds = cover.fields
        desc = cover.rep_desc
        with self._lock:
            if sig.building or sig.covered_from > cover.cov_lo:
                # the planned range was evicted/reset since plan_cover:
                # folding now would silently drop the missing windows
                raise CoverageLost(cover.sig.spec.label())
            # serve-hit bookkeeping: the autoreg budget evicts the
            # least-recently-HIT auto signature first
            sig.hits += 1
            sig.last_hit_ms = int(_now_ms())
            snaps = []
            for w in sig.windows:
                if not (cover.cov_lo <= w < cover.cov_hi):
                    continue
                for shard, states in sig.windows[w].items():
                    if shard_ids is not None and shard not in shard_ids:
                        continue
                    if states:
                        snaps.append(
                            self._snapshot_locked(sig, w, shard, states)
                        )
            cond_lut = self._cond_mask_locked(sig, cover.conds)
            proj_index, proj_rev, proj_lut = self._proj_lut_locked(
                sig, cover.group_tags
            )
        # below needs no lock: snapshots/LUTs are frozen-at-capture
        C = _ACC_FIXED + 3 * len(spec.fields)
        if snaps:
            ids = np.concatenate([s[0] for s in snaps])
            mat = np.concatenate([s[1] for s in snaps], axis=0)
        else:
            ids = np.zeros(0, dtype=np.int64)
            mat = np.zeros((0, C), dtype=np.float64)
        if cond_lut is not None and ids.size:
            keep = cond_lut[ids]
            ids = ids[keep]
            mat = mat[keep]
        gids = proj_lut[ids] if ids.size else ids
        uniq, inv = np.unique(gids, return_inverse=True)
        K = int(uniq.size)
        glist = [proj_rev[int(g)] for g in uniq]
        count = np.bincount(inv, weights=mat[:, 0], minlength=K)
        sums, mins, maxs = {}, {}, {}
        for f in flds:
            base = _ACC_FIXED + 3 * spec.fields.index(f)
            sums[f] = np.bincount(inv, weights=mat[:, base], minlength=K)
            if cover.want_minmax:
                mn = np.full(K, np.inf, dtype=np.float64)
                mx = np.full(K, -np.inf, dtype=np.float64)
                np.minimum.at(mn, inv, mat[:, base + 1])
                np.maximum.at(mx, inv, mat[:, base + 2])
                mins[f], maxs[f] = mn, mx
            else:
                # mirror the rescan: min/max untouched when the plan
                # does not compute them
                mins[f] = np.full(K, np.inf, dtype=np.float64)
                maxs[f] = np.full(K, -np.inf, dtype=np.float64)
        rep_key = None
        if cover.want_rep:
            # acc ts/seq live in the f64 matrix: exact to 2^53, far past
            # epoch-millis and the seq counter
            ts_col = mat[:, 2] if desc else mat[:, 1]
            seq_col = mat[:, 4] if desc else mat[:, 3]
            if desc:
                gts = np.full(K, -np.inf, dtype=np.float64)
                np.maximum.at(gts, inv, ts_col)
                tie = ts_col == gts[inv] if ids.size else np.zeros(0, bool)
                gseq = np.full(K, -np.inf, dtype=np.float64)
                np.maximum.at(gseq, inv[tie], seq_col[tie])
            else:
                gts = np.full(K, np.inf, dtype=np.float64)
                np.minimum.at(gts, inv, ts_col)
                tie = ts_col == gts[inv] if ids.size else np.zeros(0, bool)
                gseq = np.full(K, np.inf, dtype=np.float64)
                np.minimum.at(gseq, inv[tie], seq_col[tie])
            rep_key = np.stack([gts, gseq], axis=1).astype(np.int64)
        field_stats = {}
        if cover.want_minmax and K:
            nonempty = count > 0
            if nonempty.any():
                for f in flds:
                    field_stats[f] = (
                        float(mins[f][nonempty].min()),
                        float(maxs[f][nonempty].max()),
                    )
        if not cover.group_tags and K == 0:
            # the rescan always reports the single logical flat group,
            # matching _reduce_partials' nz=[0] shape
            glist = [()]
            count = np.zeros(1, dtype=np.float64)
            sums = {f: np.zeros(1, dtype=np.float64) for f in flds}
            mins = {f: np.full(1, np.inf, dtype=np.float64) for f in flds}
            maxs = {f: np.full(1, -np.inf, dtype=np.float64) for f in flds}
        return Partials(
            group_tags=cover.group_tags,
            groups=glist,
            count=count,
            sums=sums,
            mins=mins,
            maxs=maxs,
            hist=None,
            field_stats=field_stats,
            rep_key=rep_key,
            rep_desc=cover.rep_desc,
            rep_vals=None,
        )

    # -- introspection -------------------------------------------------------
    def _stats_one_locked(self, sig: _Sig) -> dict:
        return {
            "signature": sig.spec.label(),
            "group": sig.spec.group,
            "measure": sig.spec.measure,
            "key_tags": list(sig.spec.key_tags),
            "fields": list(sig.spec.fields),
            "window_millis": sig.spec.window_millis,
            "origin": sig.origin,
            "hits": sig.hits,
            "last_hit_ms": sig.last_hit_ms or None,
            "windows": len(sig.windows),
            "states": sum(
                len(s)
                for by in sig.windows.values()
                for s in by.values()
            ),
            "rows": sig.rows,
            "late_dropped": sig.late,
            "evicted_states": sig.evicted,
            "covered_from": (
                None if sig.covered_from == _NEG_INF_TS
                else sig.covered_from
            ),
            "watermark": (
                None if sig.watermark == _NEG_INF_TS else sig.watermark
            ),
            "building": sig.building,
        }

    def stats(self) -> dict:
        with self._lock:
            sigs = [self._stats_one_locked(s) for s in self._sigs.values()]
        return {
            "enabled": enabled(),
            "signatures": sigs,
            "windows": sum(s["windows"] for s in sigs),
            "states": sum(s["states"] for s in sigs),
            "rows": sum(s["rows"] for s in sigs),
            "late_dropped": sum(s["late_dropped"] for s in sigs),
        }

    def export_gauges(self) -> None:
        """Window/read/staleness gauges for the /metrics scrape."""
        st = self.stats()
        self._meter.gauge_set(
            "streamagg_signatures", float(len(st["signatures"]))
        )
        self._meter.gauge_set("streamagg_windows", float(st["windows"]))
        self._meter.gauge_set("streamagg_states", float(st["states"]))
        for s in st["signatures"]:
            if s["watermark"] is not None:
                self._meter.gauge_set(
                    "streamagg_watermark_ms",
                    float(s["watermark"]),
                    {"signature": s["signature"]},
                )
