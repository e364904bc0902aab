"""Live shard rebalancing + replica repair (docs/robustness.md
"Elastic cluster").

Three layers, smallest first:

1. ``plan_rebalance`` — a PURE function (target topology -> minimal
   move list, golden-testable): keeps every current chain member that
   survives in the target node set (up to its fair-share cap), fills
   deficits with the least-loaded target nodes, and emits one
   ``ShardMove`` per shard whose chain changes.  The plan carries the
   base epoch it was computed against; applying a plan whose base
   epoch no longer matches is refused (stale plan).

2. ``Rebalancer`` — the mover.  Executes a plan with zero acked-write
   loss under live ingest:

   - opens the liaison's DUAL-ROUTE window (writes fan to the old
     chain AND the shard's new owners),
   - flushes source memtables, pulls each source part over the bus in
     1 MiB CRC'd chunks and re-ships it to the new owner through the
     existing chunked part-sync install path (``Topic.SYNC_PART``) —
     receiver installs are digest/uuid idempotent, so a re-ship after
     a mid-move crash is a free no-op,
   - runs a second DELTA round (flush + manifest diff) to catch rows
     sealed while the bulk round ran,
   - CUTS OVER: atomically swaps the liaison's placement to the plan's
     map (epoch+1), persists it, closes the dual-route window, and
     broadcasts the new epoch so every data node fences stale writers.

   Old owners keep their (now-unreachable-by-routing) part copies;
   retention ages them out.  Queries route on the OLD placement until
   cutover and the NEW placement after — both views hold every row, so
   results are byte-identical before/during/after the move.

   On the card, moved parts are files: the receiving data node scans
   them with its own kernels after the cutover.

3. ``ReplicaRepairer`` — anti-entropy.  Per shard, compares part-digest
   manifests across the replica chain and re-ships parts a replica is
   missing (node restored from disk loss, missed wqueue ship, ...);
   converges to digest-identical manifests because installs dedupe on
   the same keys the manifests carry.
"""

from __future__ import annotations

import base64
import threading
import time
import uuid
import zlib
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from banyandb_tpu_torch.cluster.bus import Topic
from banyandb_tpu_torch.cluster.node import NodeInfo
from banyandb_tpu_torch.cluster.placement import PlacementMap
from banyandb_tpu_torch.cluster.rpc import TransportError

# bulk part moves ride the sync tier (whole files over the bus)
_RPC_SYNC_S = 120.0
_RPC_CONTROL_S = 10.0
_PULL_CHUNK = 1 << 20


@dataclass(frozen=True)
class ShardMove:
    """One shard's chain change: which nodes gain the shard (and must
    receive its parts before cutover) and which lose it."""

    shard: int
    add: tuple[str, ...]
    remove: tuple[str, ...]

    def to_json(self) -> dict:
        return {
            "shard": self.shard,
            "add": list(self.add),
            "remove": list(self.remove),
        }


@dataclass(frozen=True)
class RebalancePlan:
    base_epoch: int  # epoch the plan was computed against (fence)
    target_nodes: tuple[str, ...]
    replicas: int
    chains: tuple[tuple[str, ...], ...]
    moves: tuple[ShardMove, ...] = field(default=())

    @property
    def new_epoch(self) -> int:
        return self.base_epoch + 1

    def placement(self) -> PlacementMap:
        return PlacementMap(
            epoch=self.new_epoch,
            nodes=tuple(sorted(self.target_nodes)),
            replicas=self.replicas,
            chains=self.chains,
        )

    def to_json(self) -> dict:
        return {
            "base_epoch": self.base_epoch,
            "new_epoch": self.new_epoch,
            "target_nodes": list(self.target_nodes),
            "replicas": self.replicas,
            "chains": [list(c) for c in self.chains],
            "moves": [m.to_json() for m in self.moves],
        }

    @classmethod
    def from_json(cls, d: dict) -> "RebalancePlan":
        return cls(
            base_epoch=int(d["base_epoch"]),
            target_nodes=tuple(d["target_nodes"]),
            replicas=int(d["replicas"]),
            chains=tuple(tuple(c) for c in d["chains"]),
            moves=tuple(
                ShardMove(int(m["shard"]), tuple(m["add"]), tuple(m["remove"]))
                for m in d.get("moves", ())
            ),
        )


def plan_rebalance(
    placement: PlacementMap,
    target_nodes: Sequence[str],
    *,
    num_shards: int,
    replicas: Optional[int] = None,
) -> RebalancePlan:
    """Pure plan: current placement + target topology -> explicit chains
    for shards ``0..num_shards-1`` and the minimal move list.

    Stability first, then exact balance: every current chain member
    that survives in the target set is kept in place (chain order
    preserved, so surviving primaries stay primaries), then over-quota
    nodes shed slots one swap per shard per sweep — the LAST chain
    position first, replaced by the most-under-quota node — until every
    node is at its fair share (``total_slots // n`` with the remainder
    spread by name order).  A join therefore takes exactly its quota,
    from distinct shards, with the minimal number of slot moves; a
    leave frees exactly its chain slots.  Deterministic: same inputs ->
    same plan, pinned by the golden in tests/test_rebalance.py.
    """
    target = sorted(dict.fromkeys(target_nodes))
    if not target:
        raise ValueError("rebalance target is empty")
    if num_shards <= 0:
        raise ValueError("num_shards must be positive")
    reps = placement.replicas if replicas is None else int(replicas)
    want_n = min(reps + 1, len(target))
    total = num_shards * want_n
    fair_lo, n_hi = divmod(total, len(target))
    quota = {
        n: fair_lo + (1 if i < n_hi else 0)
        for i, n in enumerate(target)
    }
    load = {n: 0 for n in target}
    kept: list[list[str]] = []
    for shard in range(num_shards):
        keep: list[str] = []
        for nm in placement.chain(shard):
            if nm in load and len(keep) < want_n:
                keep.append(nm)
                load[nm] += 1
        kept.append(keep)
    # shed overload: one swap per shard per sweep spreads the churn so
    # a joiner's slots come from DISTINCT shards (it can hold only one
    # slot per chain)
    changed = True
    while changed:
        changed = False
        for keep in kept:
            for pos in range(len(keep) - 1, -1, -1):
                nm = keep[pos]
                if load[nm] <= quota[nm]:
                    continue
                under = [
                    n for n in target
                    if n not in keep and load[n] < quota[n]
                ]
                if not under:
                    continue
                repl = min(under, key=lambda n: (load[n] - quota[n], n))
                keep[pos] = repl
                load[nm] -= 1
                load[repl] += 1
                changed = True
                break
    for keep in kept:  # fill deficits (e.g. replicas raised / node left)
        while len(keep) < want_n:
            nm = min(
                (n for n in target if n not in keep),
                key=lambda n: (load[n] - quota[n], n),
            )
            keep.append(nm)
            load[nm] += 1
    moves = []
    for shard, chain in enumerate(kept):
        old = placement.chain(shard)
        add = tuple(n for n in chain if n not in old)
        remove = tuple(n for n in old if n not in chain)
        if add or remove:
            moves.append(ShardMove(shard, add, remove))
    return RebalancePlan(
        base_epoch=placement.epoch,
        target_nodes=tuple(target),
        replicas=reps,
        chains=tuple(tuple(c) for c in kept),
        moves=tuple(moves),
    )


# -- part movement over the existing sync wire --------------------------------


def shard_manifest(
    transport, node: NodeInfo, shard: int, timeout: float = _RPC_SYNC_S
) -> "tuple[dict[str, dict], int]":
    """One node's per-shard part manifest -> ({digest_key: entry},
    skipped) — `skipped` counts parts the node's merge loop rewrote
    mid-listing (the mover re-runs with a fresh manifest, exactly like
    a gone pull)."""
    r = transport.call(
        node.addr, "rebalance", {"op": "manifest", "shard": shard},
        timeout=timeout,
    )
    return {e["key"]: e for e in r["parts"]}, int(r.get("skipped", 0))


def ship_part(
    transport,
    src: NodeInfo,
    dst: NodeInfo,
    entry: dict,
    *,
    epoch: int,
    chunk: int = _PULL_CHUNK,
) -> str:
    """Pull one part from `src` (whole-part bundle when small, 1 MiB
    CRC'd chunks otherwise) and install it on `dst` through the chunked
    part-sync topic.  -> "moved" when `dst` actually introduced it,
    "deduped" when the install deduped (the part was already there —
    the free re-ship), "gone" when the source's merge loop rewrote the
    part between manifest and pull (its rows live on in the merged
    part; the caller re-manifests and ships that instead)."""
    session = uuid.uuid4().hex
    base = {
        "session": session,
        "group": entry["group"],
        "segment": entry["segment"],
        "segment_start_millis": int(entry["segment_start"]),
        "shard": f"shard-{int(entry['shard'])}",
        "placement_epoch": epoch,
    }
    pull_base = {
        "op": "pull",
        "catalog": entry["catalog"],
        "group": entry["group"],
        "segment_start": int(entry["segment_start"]),
        "shard": int(entry["shard"]),
        "part": entry["part"],
    }
    # fast path: whole-part bundle (1 pull + 1 push) — per-RPC latency,
    # not bandwidth, dominates small-part moves; oversize parts fall
    # back to the per-file 1 MiB chunk loop below.  Pulled BEFORE the
    # receiver session opens so a merged-away part costs nothing there.
    bundle = transport.call(
        src.addr, "rebalance", dict(pull_base, op="pull_all"),
        timeout=_RPC_SYNC_S,
    )
    if bundle.get("gone"):
        return "gone"
    transport.call(
        dst.addr, Topic.SYNC_PART.value, dict(base, phase="begin"),
        timeout=_RPC_SYNC_S,
    )
    if not bundle.get("truncated"):
        # forward the pulled base64 VERBATIM (decode once for the CRCs
        # only — re-encoding identical bytes would double the work and
        # the transient memory per part)
        transport.call(
            dst.addr,
            Topic.SYNC_PART.value,
            dict(
                base,
                phase="files",
                files=bundle["files"],
                crc32s={
                    f: zlib.crc32(base64.b64decode(data))
                    for f, data in bundle["files"].items()
                },
            ),
            timeout=_RPC_SYNC_S,
        )
    else:
        for fname in sorted(entry["files"]):
            size = int(entry["files"][fname])
            off = 0
            while True:
                r = transport.call(
                    src.addr,
                    "rebalance",
                    dict(pull_base, file=fname, offset=off, length=chunk),
                    timeout=_RPC_SYNC_S,
                )
                if r.get("gone"):
                    # merged away mid-stream: drop the receiver session
                    transport.call(
                        dst.addr, Topic.SYNC_PART.value,
                        dict(base, phase="abort"), timeout=_RPC_SYNC_S,
                    )
                    return "gone"
                blob = base64.b64decode(r["data"])
                transport.call(
                    dst.addr,
                    Topic.SYNC_PART.value,
                    dict(
                        base,
                        phase="chunk",
                        file=fname,
                        offset=off,
                        data=base64.b64encode(blob).decode(),
                        crc32=zlib.crc32(blob),
                    ),
                    timeout=_RPC_SYNC_S,
                )
                off += len(blob)
                if r.get("eof", True) or off >= size:
                    break
    r = transport.call(
        dst.addr, Topic.SYNC_PART.value, dict(base, phase="finish"),
        timeout=_RPC_SYNC_S,
    )
    return "deduped" if r.get("duplicate") else "moved"


class Rebalancer:
    """Plan + execute live shard moves against a Liaison."""

    def __init__(self, liaison):
        self.liaison = liaison
        self._lock = threading.Lock()  # one move at a time
        self._state_lock = threading.Lock()  # guards _last/_active
        self._last: dict = {}
        self._active = False

    # -- planning ------------------------------------------------------------
    def num_shards(self) -> int:
        """Widest shard count over the registry's groups: the explicit
        chain range a plan must cover."""
        widest = 0
        for g in self.liaison.registry.list_groups():
            widest = max(widest, g.resource_opts.shard_num)
        return widest

    def plan(
        self,
        target_nodes: Optional[Sequence[str]] = None,
        replicas: Optional[int] = None,
    ) -> RebalancePlan:
        """Target defaults to the liaison's CURRENT addr book — after a
        discovery membership change, that is exactly the joined/left
        topology ``refresh_nodes`` recorded without re-placing."""
        if target_nodes is None:
            target_nodes = [n.name for n in self.liaison.selector.nodes]
        n = self.num_shards()
        if n == 0:
            raise RuntimeError("no groups registered; nothing to place")
        plan = plan_rebalance(
            self.liaison.placement, target_nodes,
            num_shards=n, replicas=replicas,
        )
        from banyandb_tpu_torch.obs.metrics import global_meter

        global_meter().gauge_set(
            "rebalance_shards_to_move", float(len(plan.moves))
        )
        return plan

    # -- execution -----------------------------------------------------------
    def apply(
        self,
        plan: RebalancePlan,
        *,
        mid_move: Optional[Callable[[], None]] = None,
        tracer=None,
    ) -> dict:
        """Execute `plan` to cutover.  ``mid_move`` (tests/chaos): called
        between the bulk and delta ship rounds — the window where a
        crash/kill must be survivable.  Raises on unrecoverable failure
        with the dual-route window CLOSED and the old placement intact;
        already-shipped parts are harmless (installs dedupe) and a
        retried apply re-ships only what is missing."""
        from banyandb_tpu_torch.obs.metrics import global_meter
        from banyandb_tpu_torch.obs.tracer import Tracer

        # wait out a background repair tick holding the mover lock (the
        # liaison's bydb-repair loop); only a genuinely concurrent APPLY
        # should refuse
        if not self._lock.acquire(timeout=120):
            raise RuntimeError("a rebalance is already in progress")
        t = tracer or Tracer("rebalance")
        meter = global_meter()
        stats = {
            "base_epoch": plan.base_epoch,
            "new_epoch": plan.new_epoch,
            "shards_moved": len(plan.moves),
            "parts_planned": 0,
            "parts_moved": 0,
            "parts_deduped": 0,
            "parts_vanished": 0,
            "rounds": 0,
        }
        try:
            with self._state_lock:
                self._active = True
            if plan.base_epoch != self.liaison.placement.epoch:
                raise RuntimeError(
                    f"stale plan: base epoch {plan.base_epoch} != current "
                    f"{self.liaison.placement.epoch}; re-plan and retry"
                )
            with t.span("rebalance") as rs:
                rs.tag("moves", len(plan.moves))
                rs.tag("new_epoch", plan.new_epoch)
                adds = {
                    m.shard: m.add for m in plan.moves if m.add
                }
                # late joiners need the schema BEFORE parts/writes land
                with t.span("schema_sync"):
                    self._sync_schema_to_new_owners(plan)
                with t.span("dual_route"):
                    self.liaison.begin_dual_route(adds)
                try:
                    with t.span("ship:bulk"):
                        self._ship_round(plan, stats)
                        stats["rounds"] += 1
                    if mid_move is not None:
                        mid_move()
                    # delta round: rows sealed while the bulk round ran
                    # (and anything a mid-move crash interrupted).  A
                    # round where a source's merge loop rewrote parts
                    # under the manifest ("gone" pulls) is re-run with a
                    # fresh manifest — cutover only happens after a
                    # round in which nothing vanished, so merged-away
                    # rows always ship via their merged part.
                    for extra in range(5):
                        vanished_before = stats["parts_vanished"]
                        with t.span("ship:delta"):
                            self._ship_round(plan, stats)
                            stats["rounds"] += 1
                        if stats["parts_vanished"] == vanished_before:
                            break
                    else:
                        raise TransportError(
                            "rebalance could not converge: parts kept "
                            "vanishing under merge churn across 5 delta "
                            "rounds"
                        )
                    # the liaison's own write queue, when enabled, may
                    # hold sealed-but-unshipped parts routed at the old
                    # placement: drain before the epoch fence goes up
                    # (this package's liaison has none until the write
                    # queue and its gRPC chunked sync are ported, so the
                    # move goes on without it, as with none enabled)
                    wq = getattr(self.liaison, "wqueue", None)
                    if wq is not None:
                        wq.flush(force=True)
                except BaseException:
                    self.liaison.end_dual_route()
                    raise
                with t.span("cutover") as cs:
                    new_epoch = self.liaison.cutover(plan)
                    cs.tag("epoch", new_epoch)
                # fence every node (outside all locks: RPC fan-out);
                # nodes missed here learn the epoch from the next fenced
                # envelope that reaches them
                self.liaison.broadcast_placement()
            stats["ok"] = True
            return stats
        finally:
            with self._state_lock:
                self._active = False
                self._last = stats
            meter.gauge_set("placement_epoch", float(self.liaison.placement.epoch))
            self._lock.release()

    def _sync_schema_to_new_owners(self, plan: RebalancePlan) -> None:
        """A node that JOINED after schema creation has an empty
        registry — installing a shipped part (or serving its shards
        post-cutover) needs the group/measure/stream/trace specs.  Push
        the liaison's full schema store to every node that gains a
        shard, groups first (everything references its group).
        Idempotent: SCHEMA_SYNC is a put."""
        from banyandb_tpu_torch.api.schema import _to_jsonable

        liaison = self.liaison
        store = liaison.registry._store
        kinds = ["group"] + [k for k in store if k != "group"]
        gaining = sorted({nm for m in plan.moves for nm in m.add})
        for nm in gaining:
            node = liaison.selector.node_by_name(nm)
            if node is None or nm not in liaison.alive:
                continue
            for kind in kinds:
                for obj in store.get(kind, {}).values():
                    liaison.transport.call(
                        node.addr,
                        Topic.SCHEMA_SYNC.value,
                        {"kind": kind, "item": _to_jsonable(obj)},
                        timeout=_RPC_CONTROL_S,
                    )

    def _ship_round(self, plan: RebalancePlan, stats: dict) -> None:
        """One flush + manifest + ship pass over every move."""
        liaison = self.liaison
        transport = liaison.transport
        # flush ALL models on the nodes that source moves, so memtable
        # rows are parts before the manifest snapshot
        sources = set()
        for m in plan.moves:
            for nm in liaison.placement.chain(m.shard):
                sources.add(nm)
        for nm in sorted(sources):
            node = liaison.selector.node_by_name(nm)
            if node is None or nm not in liaison.alive:
                continue
            try:
                transport.call(
                    node.addr, "rebalance", {"op": "flush"},
                    timeout=_RPC_SYNC_S,
                )
            except TransportError:
                continue  # dead source: its replicas cover the manifest
        from banyandb_tpu_torch.obs.metrics import global_meter

        meter = global_meter()
        for m in plan.moves:
            if not m.add:
                continue
            old_chain = liaison.placement.chain(m.shard)
            holders = [
                liaison.selector.node_by_name(nm)
                for nm in old_chain
                if nm in liaison.alive
                and liaison.selector.node_by_name(nm) is not None
            ]
            if not holders:
                raise TransportError(
                    f"shard {m.shard}: no alive holder to move parts from"
                )
            # union manifest across alive holders (independent flushes
            # mean holders can each own parts the others lack); a
            # holder-side mid-listing merge counts as vanishing so the
            # convergence loop runs another round
            union: dict[str, tuple[NodeInfo, dict]] = {}
            for h in holders:
                try:
                    entries, skipped = shard_manifest(transport, h, m.shard)
                except TransportError:
                    liaison._mark_dead(h.name)
                    continue
                stats["parts_vanished"] += skipped
                for key, entry in entries.items():
                    union.setdefault(key, (h, entry))
            for nm in m.add:
                dst = liaison.selector.node_by_name(nm)
                if dst is None:
                    raise TransportError(
                        f"shard {m.shard}: new owner {nm} not in addr book"
                    )
                try:
                    have, _skipped = shard_manifest(transport, dst, m.shard)
                except TransportError:
                    have = {}
                missing = [k for k in union if k not in have]
                stats["parts_planned"] += len(missing)
                meter.counter_add(
                    "rebalance_parts_planned", float(len(missing))
                )
                for key in missing:
                    holder, entry = union[key]
                    outcome = self._ship_with_holder_failover(
                        holders, holder, dst, entry
                    )
                    if outcome == "moved":
                        stats["parts_moved"] += 1
                        meter.counter_add("rebalance_parts_moved", 1.0)
                    elif outcome == "gone":
                        stats["parts_vanished"] += 1
                    else:
                        stats["parts_deduped"] += 1

    def _ship_with_holder_failover(
        self, holders, holder: NodeInfo, dst: NodeInfo, entry: dict
    ) -> str:
        """Ship one part, failing over to the other alive holders when
        the preferred one dies mid-pull (the mover's own read
        failover).  -> ship_part's outcome; "gone" is returned only
        from the part's OWN holder (other holders have differently-
        named parts for the same keys)."""
        liaison = self.liaison
        last: Optional[TransportError] = None
        tried = []
        for src in [holder] + [h for h in holders if h.name != holder.name]:
            if src.name not in liaison.alive:
                continue
            tried.append(src.name)
            try:
                return ship_part(
                    liaison.transport, src, dst, entry,
                    epoch=liaison.placement.epoch,
                )
            except TransportError as e:
                last = e
                kind = getattr(e, "kind", "error")
                if kind == "error":
                    liaison._mark_dead(src.name)
                continue
        raise TransportError(
            f"part {entry['part']} (shard {entry['shard']}) unshippable: "
            f"tried {tried}: {last}"
        )

    def status(self) -> dict:
        with self._state_lock:
            last = dict(self._last)
            active = self._active
        p = self.liaison.placement
        return {
            "epoch": p.epoch,
            "nodes": list(p.nodes),
            "replicas": p.replicas,
            "explicit_chains": len(p.chains),
            "dual_route_shards": sorted(self.liaison.dual_route_shards()),
            "active": active,
            "last_apply": last,
            "pending_topology": sorted(self.liaison.pending_topology or ()),
        }


class ReplicaRepairer:
    """Anti-entropy over the replica chains: re-ship parts a replica is
    missing so replication factor >= 2 self-heals after a node is
    restored from loss (docs/robustness.md "Elastic cluster")."""

    def __init__(self, liaison):
        self.liaison = liaison
        self._state_lock = threading.Lock()
        self.last: dict = {}

    def run_once(self) -> dict:
        from banyandb_tpu_torch.obs.metrics import global_meter

        liaison = self.liaison
        meter = global_meter()
        stats = {"shards_checked": 0, "parts_shipped": 0, "parts_deduped": 0,
                 "errors": 0}
        widest = 0
        for g in liaison.registry.list_groups():
            widest = max(widest, g.resource_opts.shard_num)
        for shard in range(widest):
            chain = liaison.placement.chain(shard)
            members = [
                liaison.selector.node_by_name(nm)
                for nm in chain
                if nm in liaison.alive
                and liaison.selector.node_by_name(nm) is not None
            ]
            if len(members) < 2:
                continue  # nothing to compare against
            stats["shards_checked"] += 1
            manifests: dict[str, dict[str, dict]] = {}
            for node in members:
                try:
                    manifests[node.name], _skipped = shard_manifest(
                        liaison.transport, node, shard
                    )
                except TransportError:
                    stats["errors"] += 1
            if len(manifests) < 2:
                continue
            union: dict[str, tuple[NodeInfo, dict]] = {}
            for node in members:
                for key, entry in manifests.get(node.name, {}).items():
                    union.setdefault(key, (node, entry))
            for node in members:
                have = manifests.get(node.name)
                if have is None:
                    continue
                for key, (holder, entry) in union.items():
                    if key in have or holder.name == node.name:
                        continue
                    try:
                        outcome = ship_part(
                            liaison.transport, holder, node, entry,
                            epoch=liaison.placement.epoch,
                        )
                    except TransportError:
                        stats["errors"] += 1
                        continue
                    if outcome == "moved":
                        stats["parts_shipped"] += 1
                        meter.counter_add("repair_parts_shipped", 1.0)
                    elif outcome == "deduped":
                        stats["parts_deduped"] += 1
                    # "gone": merged away mid-repair — the next interval
                    # compares fresh manifests and ships the merged part
        stats["ts"] = time.time()
        with self._state_lock:
            self.last = stats
        return stats

    def status(self) -> dict:
        with self._state_lock:
            return dict(self.last)
