"""TopN pre-aggregation: ingest-time streaming top/bottom-N.

Analog of banyand/measure/topn.go (topNProcessorManager :94, streaming
processor :340): measure writes flow through per-rule tumbling time
windows; on window close the per-group aggregates are ranked and the
winners land as data points in the shared ``_top_n_result`` measure,
which the normal device query path then serves; TopN queries re-rank
across windows (topn_post_processor.go analog).

Windows are tiny (counters_number bounded), so window accumulation is a
dict of float sums host-side; the heavy path — querying the result
measure — rides the standard device executor.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

from banyandb_tpu_torch.api.model import (
    DataPointValue,
    QueryRequest,
    TimeRange,
    WriteRequest,
)
from banyandb_tpu_torch.api.schema import (
    Entity,
    FieldSpec,
    FieldType,
    Measure,
    TagSpec,
    TagType,
    TopNAggregation,
)

if TYPE_CHECKING:  # pragma: no cover
    from banyandb_tpu_torch.models.measure import MeasureEngine

RESULT_MEASURE = "_top_n_result"
_SEP = "\x01"


def rule_key_tags(rule: TopNAggregation, m: Measure) -> tuple[str, ...]:
    """Counter-key dimensions: the source measure's entity tags plus any
    rule group-by tags beyond them.  Results DISPLAY the entity prefix;
    the extra dims exist so query conditions (e.g. http.uri = null) can
    filter counters (ref null_group/eq goldens)."""
    ent = tuple(m.entity.tag_names)
    extras = tuple(
        t for t in rule.group_by_tag_names if t not in ent
    )
    return ent + extras


def _key_str(v) -> str:
    """Canonical STRING domain for counter keys, criteria literals and
    query conditions alike: None (absent/null) -> "", bytes decode,
    everything else str() — one domain so the row path, the columnar
    path and query-time filters can never disagree on a value."""
    if v is None:
        return ""
    if isinstance(v, bytes):
        return v.decode(errors="replace")
    return str(v)


def _canon_cond_value(v):
    if isinstance(v, (list, tuple)):
        return tuple(_key_str(x) for x in v)
    return _key_str(v)


def _rule_criteria(rule: TopNAggregation):
    """Parsed ingest-time Criteria for the rule (None = no filter), with
    condition literals canonicalized into the string key domain."""
    if not rule.criteria:
        return None
    # protobuf and the wire codec load here, not at import: the TopN
    # path of rules without criteria never needs them
    from google.protobuf import json_format

    from banyandb_tpu_torch.api import pb, wire
    from banyandb_tpu_torch.api.model import Condition as _C
    from banyandb_tpu_torch.api.model import LogicalExpression as _LE

    crit = pb.model_query_pb2.Criteria()
    json_format.ParseDict(rule.criteria, crit)

    def canon(node):
        if node is None:
            return None
        if isinstance(node, _C):
            return _C(node.name, node.op, _canon_cond_value(node.value))
        assert isinstance(node, _LE)
        return _LE(node.op, canon(node.left), canon(node.right))

    return canon(wire.criteria_to_internal(crit))


def _crit_tag_names(crit) -> set:
    """Tag names referenced by a (canonicalized) criteria tree."""
    from banyandb_tpu_torch.api.model import Condition as _C

    out: set = set()

    def walk(node):
        if node is None:
            return
        if isinstance(node, _C):
            out.add(node.name)
        else:
            walk(node.left)
            walk(node.right)

    walk(crit)
    return out


def _row_matches(tags: dict, crit) -> bool:
    """Evaluate a canonicalized Criteria tree over string-domain tag
    values (tags values already through _key_str)."""
    from banyandb_tpu_torch.api.model import Condition as _C
    from banyandb_tpu_torch.api.model import LogicalExpression as _LE

    if crit is None:
        return True
    if isinstance(crit, _C):
        v = tags.get(crit.name, "")
        if crit.op == "eq":
            return v == crit.value
        if crit.op == "ne":
            return v != crit.value
        if crit.op == "in":
            return v in crit.value
        if crit.op == "not_in":
            return v not in crit.value
        raise ValueError(f"topn rule criteria op {crit.op!r} not supported")
    assert isinstance(crit, _LE)
    left = _row_matches(tags, crit.left)
    right = _row_matches(tags, crit.right)
    return (left and right) if crit.op == "and" else (left or right)


def result_measure_schema(group: str) -> Measure:
    """The shared result measure (storage-and-format.md §3.5 analog)."""
    return Measure(
        group=group,
        name=RESULT_MEASURE,
        tags=(
            TagSpec("topn_name", TagType.STRING),
            TagSpec("sort", TagType.STRING),
            TagSpec("entity", TagType.STRING),
        ),
        fields=(FieldSpec("value", FieldType.FLOAT),),
        entity=Entity(("topn_name", "sort", "entity")),
    )


_VERSION_ROWS_CAP_DEFAULT = 1 << 18


def _version_rows_cap() -> int:
    """Per-window bound on the (series, ts) -> last-version tracking
    table (version-merge exactness, see _Window.rows).  0 disables."""
    from banyandb_tpu_torch.utils.envflag import env_int

    return env_int("BYDB_TOPN_VERSION_ROWS", _VERSION_ROWS_CAP_DEFAULT)


@dataclass
class _Window:
    start: int
    sums: dict  # entity tuple -> [sum, count]
    dirty: bool = True  # has un-emitted accumulation
    # (series, ts) -> (version, entity tuple, value): last-version
    # tracking so a REWRITE of the same (series, ts) REPLACES its
    # earlier contribution instead of adding (the reference
    # version-merges rows before feeding counters).  Bounded by
    # BYDB_TOPN_VERSION_ROWS per window; past the cap the table drops
    # (rows=None) and accumulation degrades to additive — exactness
    # for the dashboard-scale windows goldens exercise, bounded memory
    # under firehose ingest.
    rows: "Optional[dict]" = None


class TopNProcessorManager:
    """Per-engine manager: routes measure writes into rule windows.

    Window lifecycle follows the reference's streaming processor: a
    window whose close time the watermark passed EMITS its ranked
    counters, but its state is KEPT so late rows keep accumulating and
    re-emit the window with a higher version — the result measure's
    (series, window-start) dedup replaces the earlier emission.  Memory
    is bounded per rule by lru_size windows (TopNAggregation.lru_size):
    the oldest window is finally emitted and evicted when the bound is
    exceeded — only data older than the eviction horizon is dropped."""

    def __init__(
        self,
        engine: "MeasureEngine",
        *,
        window_millis: int = 60_000,
        lateness_millis: int = 0,
    ):
        self.engine = engine
        self.window_millis = window_millis
        self.lateness_millis = lateness_millis
        # (group, rule name) -> {window_start -> _Window}
        self._windows: dict[tuple, dict[int, _Window]] = defaultdict(dict)
        self._watermark: dict[tuple, int] = {}
        self._emit_seq = 0
        # parsed rule-criteria cache: (group, rule) -> (criteria_dict, tree)
        self._crit_cache: dict[tuple, tuple] = {}
        # One manager serves every write thread of the engine (gRPC pool
        # workers, the bus executor, bulk columnar ingest): window sums
        # are read-modify-write and _flush_closed iterates _windows, so
        # ALL accumulation state is guarded by one reentrant lock
        # (reentrant: flush_all_windows and observe share _emit).
        self._obs_lock = threading.RLock()
        # ranked emissions queue here UNDER the lock and are written to
        # the result measure AFTER it is released (_drain_emits): holding
        # _obs_lock across engine.write would nest it over the whole
        # storage/registry lock family for no benefit — result-measure
        # (series, window) version dedup makes drain order irrelevant
        self._pending_emits: list[tuple[str, tuple]] = []
        # read ONCE: _accumulate runs per ingested row under _obs_lock —
        # an env parse there would be pure hot-loop overhead
        self._version_rows_cap = _version_rows_cap()

    def _cached_criteria(self, key: tuple, rule: TopNAggregation):
        hit = self._crit_cache.get(key)
        if hit is not None and hit[0] == rule.criteria:
            return hit[1]
        parsed = _rule_criteria(rule)
        self._crit_cache[key] = (rule.criteria, parsed)
        return parsed

    def _accumulate(
        self, win: _Window, rule: TopNAggregation, ent: tuple,
        value: float, sid, ts_millis: int, version,
    ) -> bool:
        """Version-merged window accumulation: a REWRITE of the same
        (series, ts) with a higher version REPLACES its earlier
        contribution (the reference version-merges rows before feeding
        counters); an older/equal version loses, matching the storage
        plane's max-version dedup.  The superseded contribution is
        retracted even when the NEW entity cannot claim a counter slot
        (bounded counters) — the dead version must never keep ranking;
        the row record then carries ent=None so a later rewrite has
        nothing further to retract.  Tracking is per-window bounded
        (BYDB_TOPN_VERSION_ROWS) — past the cap the table drops and
        accumulation degrades to additive.  -> True when window state
        changed."""
        rkey = prev = None
        if sid is not None and win.rows is not None:
            rkey = (sid, ts_millis)
            prev = win.rows.get(rkey)
            if (
                prev is not None
                and version is not None
                and version <= prev[0]
            ):
                return False  # stale rewrite loses
        if prev is not None and prev[1] is not None:
            pacc = win.sums.get(prev[1])
            if pacc is not None:
                # retract the superseded version's contribution (the
                # acc may reach count 0: _emit skips empty counters)
                pacc[0] -= prev[2]
                pacc[1] -= 1
        acc = win.sums.get(ent)
        if acc is None:
            if len(win.sums) >= rule.counters_number:
                # bounded counters (heap-capacity analog): the new
                # version is uncounted, but the retraction above stands
                if rkey is not None:
                    win.rows[rkey] = (version or 0, None, 0.0)
                return prev is not None
            acc = win.sums[ent] = [0.0, 0]
        acc[0] += value
        acc[1] += 1
        if rkey is not None:
            win.rows[rkey] = (version or 0, ent, value)
            if len(win.rows) > self._version_rows_cap:
                win.rows = None  # cap: additive from here on
        return True

    def _new_window(self, start: int) -> _Window:
        return _Window(
            start, {}, rows={} if self._version_rows_cap > 0 else None
        )

    def observe(
        self, m: Measure, p: DataPointValue, sid=None, version=None
    ) -> None:
        """Feed one written point through all TopN rules of its measure."""
        with self._obs_lock:
            self._observe_locked(m, p, sid, version)
        self._drain_emits()

    def _observe_locked(
        self, m: Measure, p: DataPointValue, sid=None, version=None
    ) -> None:
        for rule in self.engine.registry.list_topn(m.group):
            if rule.source_measure != m.name:
                continue
            key = (m.group, rule.name)
            # criteria filter runs BEFORE any window allocation: rejected
            # rows must not create empty windows (they would prematurely
            # LRU-evict real ones)
            crit = self._cached_criteria(key, rule)
            if crit is not None and not _row_matches(
                {
                    t: _key_str(p.tags.get(t))
                    for t in _crit_tag_names(crit)
                },
                crit,
            ):
                continue
            start = p.ts_millis - (p.ts_millis % self.window_millis)
            wins = self._windows[key]
            win = wins.get(start)
            if win is None:
                win = wins[start] = self._new_window(start)
                self._evict_over_lru(key, rule)
            # counters key = entity tags + extra group-by dims (results
            # display the entity prefix; extras serve conditions)
            ent = tuple(
                _key_str(p.tags.get(t)) for t in rule_key_tags(rule, m)
            )
            if self._accumulate(
                win, rule, ent,
                float(p.fields.get(rule.field_name, 0)),
                sid, p.ts_millis, version,
            ):
                win.dirty = True
            wm = self._watermark.get(key, 0)
            if p.ts_millis > wm:
                self._watermark[key] = p.ts_millis
            self._flush_closed(key, rule)

    def _evict_over_lru(self, key: tuple, rule: TopNAggregation) -> None:
        wins = self._windows[key]
        bound = max(int(rule.lru_size or 10), 2)
        while len(wins) > bound:
            oldest = min(wins)
            win = wins.pop(oldest)
            if win.dirty:
                self._emit(key[0], rule, win)

    def observe_columns(
        self, m: Measure, ts_millis, tags, fields, sids=None, versions=None
    ) -> None:
        """Columnar twin of observe(): feed a bulk write's columns through
        all TopN rules of its measure (closes the row-vs-bulk semantic
        split, ref one-write-path banyand/measure/write_standalone.go:348).

        Measures with no rules pay one registry scan and return; rule
        accumulation matches observe() row-for-row (same window routing,
        late-drop, counters bound, watermark and flush behavior).
        ``sids``/``versions`` enable version-merged accumulation
        (_accumulate): rewrites of the same (series, ts) replace."""
        with self._obs_lock:
            self._observe_columns_locked(
                m, ts_millis, tags, fields, sids, versions
            )
        self._drain_emits()

    def _observe_columns_locked(
        self, m: Measure, ts_millis, tags, fields, sids=None, versions=None
    ) -> None:
        import numpy as np

        rules = [
            r
            for r in self.engine.registry.list_topn(m.group)
            if r.source_measure == m.name
        ]
        if not rules:
            return
        ts = np.asarray(ts_millis, dtype=np.int64)
        n = ts.shape[0]
        if n == 0:
            return

        as_str = _key_str  # one canonical string domain (module helper)

        # batch-level decode, shared across rules (starts/ts once; tag
        # string columns memoized per tag)
        starts_all = (ts - (ts % self.window_millis)).tolist()
        tsl = ts.tolist()
        sidl = (
            np.asarray(sids, dtype=np.int64).tolist()
            if sids is not None
            else None
        )
        verl = (
            np.asarray(versions, dtype=np.int64).tolist()
            if versions is not None
            else None
        )
        str_cols: dict[str, list] = {}

        def col_of(t: str) -> list:
            col = str_cols.get(t)
            if col is None:
                tv = tags.get(t)
                if tv is None:
                    col = [""] * n
                elif hasattr(tv, "codes"):  # dictionary-encoded column
                    sd = np.asarray(
                        [as_str(v) for v in tv.values], dtype=object
                    )
                    col = sd[np.asarray(tv.codes)].tolist()
                else:
                    col = [as_str(v) for v in tv]
                str_cols[t] = col
            return col

        for rule in rules:
            key = (m.group, rule.name)
            starts = starts_all
            fvals = fields.get(rule.field_name)
            fvals = (
                np.asarray(fvals, dtype=np.float64).tolist()
                if fvals is not None
                else [0.0] * n
            )
            # per-source-series counters + extra group-by dims
            gtags = rule_key_tags(rule, m)
            cols = [col_of(t) for t in gtags]
            crit = self._cached_criteria(key, rule)
            crit_tags = None
            if crit is not None:
                # string-domain columns for every referenced tag (the
                # same _key_str domain the canonicalized tree carries)
                crit_tags = {t: col_of(t) for t in _crit_tag_names(crit)}
            wins = self._windows[key]
            wm = self._watermark.get(key, 0)
            for i in range(n):
                if crit_tags is not None and not _row_matches(
                    {t: col[i] for t, col in crit_tags.items()}, crit
                ):
                    continue
                start = starts[i]
                win = wins.get(start)
                if win is None:
                    win = wins[start] = self._new_window(start)
                    self._evict_over_lru(key, rule)
                ent = tuple(c[i] for c in cols)
                if self._accumulate(
                    win, rule, ent, fvals[i],
                    sidl[i] if sidl is not None else None,
                    tsl[i],
                    verl[i] if verl is not None else None,
                ):
                    win.dirty = True
                if tsl[i] > wm:
                    wm = tsl[i]
            self._watermark[key] = wm
            self._flush_closed(key, rule)

    def _flush_closed(self, key: tuple, rule: TopNAggregation) -> None:
        """Emit every DIRTY window the watermark has passed, KEEPING its
        state: a late row re-dirties the window and the next flush
        re-emits it with a higher version (the result measure's
        (series, window) dedup replaces the earlier rows)."""
        wm = self._watermark.get(key, 0)
        for start, win in self._windows[key].items():
            if (
                win.dirty
                and start + self.window_millis + self.lateness_millis <= wm
            ):
                win.dirty = False
                self._emit(key[0], rule, win)

    def flush_all_windows(self) -> None:
        """Emit every dirty window (shutdown / test hook); state kept."""
        with self._obs_lock:
            for (group, rname), wins in list(self._windows.items()):
                rule = next(
                    (r for r in self.engine.registry.list_topn(group) if r.name == rname),
                    None,
                )
                if rule is None:
                    continue
                for win in wins.values():
                    if win.dirty:
                        win.dirty = False
                        self._emit(group, rule, win)
        self._drain_emits()

    def _emit(self, group: str, rule: TopNAggregation, win: _Window) -> None:
        """Rank + QUEUE one window's counters (called with _obs_lock
        held); the actual result-measure write happens lock-free in
        _drain_emits."""
        if not win.sums:
            return
        directions = (
            ("desc", "asc")
            if rule.field_value_sort == "all"
            else (rule.field_value_sort,)
        )
        points = []
        # count-0 counters are fully-retracted version-merge residue:
        # an entity with no surviving rows must not rank (its earlier
        # emission, if any, is replaced by nothing — acceptable residue,
        # the re-emit path only covers entities that still exist)
        ranked = sorted(
            (kv for kv in win.sums.items() if kv[1][1] > 0),
            key=lambda kv: kv[1][0],
        )
        for direction in directions:
            chosen = (
                ranked[-rule.counters_number :][::-1]
                if direction == "desc"
                else ranked[: rule.counters_number]
            )
            # store up to counters_number; final N is applied at query
            self._emit_seq += 1
            for ent, (total, _cnt) in chosen:
                points.append(
                    DataPointValue(
                        ts_millis=win.start,
                        tags={
                            "topn_name": rule.name,
                            "sort": direction,
                            "entity": _SEP.join(ent),
                        },
                        fields={"value": total},
                        version=self._emit_seq,
                    )
                )
        self._pending_emits.append((group, tuple(points)))

    def _drain_emits(self) -> None:
        """Write queued emissions with NO manager lock held.  Concurrent
        drainers may interleave batches; the result measure's (series,
        window-start) max-version dedup makes arrival order irrelevant."""
        while True:
            with self._obs_lock:
                if not self._pending_emits:
                    return
                group, points = self._pending_emits.pop(0)
            self.engine.ensure_result_measure(group)
            self.engine.write(
                WriteRequest(group, RESULT_MEASURE, points),
                _internal=True,
            )


def query_topn(
    engine: "MeasureEngine",
    group: str,
    rule_name: str,
    time_range: TimeRange,
    *,
    n: int = 10,
    direction: str = "desc",
    agg: str = "sum",
    conditions: tuple = (),
) -> list[tuple[tuple, float]]:
    """Re-rank across windows (topn_post_processor.go analog).

    conditions: (tag, op, value) filters over the counter key dims
    (entity tags + rule group-by extras); "" counters compare as None.
    Distinct-best step (topn_plan_distinct.go): each DISPLAYED entity
    (the source measure's entity prefix) keeps its extreme surviving
    window value in the query direction; the aggregation then applies
    over that single distinct item — sum/max/min/mean all equal it,
    count is 1."""
    from banyandb_tpu_torch.api.model import Aggregation, Condition, GroupBy, LogicalExpression

    rule = next(
        (r for r in engine.registry.list_topn(group) if r.name == rule_name),
        None,
    )
    if rule is None:
        raise KeyError(f"topn rule {rule_name} not found")
    src = engine.registry.get_measure(
        rule.source_group or group, rule.source_measure
    )
    key_tags = rule_key_tags(rule, src)
    ent_n = len(src.entity.tag_names)
    for name, _op, _v in conditions:
        if name not in key_tags:
            raise ValueError(f"TopN condition on unknown tag {name!r}")

    extreme = "max" if direction == "desc" else "min"
    req = QueryRequest(
        groups=(group,),
        name=RESULT_MEASURE,
        time_range=time_range,
        criteria=LogicalExpression(
            "and",
            Condition("topn_name", "eq", rule_name),
            Condition("sort", "eq", direction),
        ),
        group_by=GroupBy(("entity",)),
        agg=Aggregation(extreme, "value"),
        limit=0,
    )
    res = engine.query(req)
    key = f"{extreme}(value)"

    # conditions evaluate through the SAME canonical string domain and
    # evaluator as ingest-time rule criteria (no second implementation)
    conds_canon = tuple(
        Condition(nm, op, _canon_cond_value(v)) for nm, op, v in conditions
    )

    def cond_ok(full: tuple) -> bool:
        by = dict(zip(key_tags, full))
        return all(_row_matches(by, c) for c in conds_canon)

    best: dict[tuple, float] = {}
    for g, v in zip(res.groups, res.values[key]):
        full = tuple(g[0].split(_SEP))
        if not cond_ok(full):
            continue
        disp = full[:ent_n]
        cur = best.get(disp)
        if cur is None or (v > cur if direction == "desc" else v < cur):
            best[disp] = v
    # entity tie-break: equal values must rank identically here and in
    # the worker pool's concat re-rank (cluster/workers.py), where ties
    # would otherwise follow worker index instead of engine group order
    pairs = sorted(
        best.items(),
        key=lambda kv: (kv[1], kv[0]),
        reverse=(direction == "desc"),
    )
    if agg == "count":  # one distinct item per entity reaches the agg
        return [(ent, 1.0) for ent, _ in pairs[:n]]
    return pairs[:n]
