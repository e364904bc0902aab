"""Deterministic fault-injection plane (docs/robustness.md).

Generalizes the test-local chunked-sync injector (reference:
queue.go:230 ChunkedSyncFailureInjector) into a first-class, seedable,
schedule-driven plane covering four boundaries:

- ``rpc``   — the transport call surface (cluster/rpc.py): inject a hard
              error, an UNAVAILABLE-shaped failure, a shed rejection
              (ServerBusy semantics) or a fixed delay before dispatch;
- ``sync``  — the chunked-sync stream (cluster/chunked_sync.py): cut the
              stream mid-flight, truncate a chunk, corrupt chunk bytes
              after the checksum was computed;
- ``disk``  — spool/part disk I/O (cluster/wqueue.py seal,
              cluster/handoff.py spool): ENOSPC before the write, or a
              short write that leaves a truncated artifact behind;
- ``kill``  — harness-driven process kills: the plane carries the
              schedule (which node dies at which chaos cycle), the
              harness (scripts/chaos.py) performs the kill.
- ``partition`` — an ASYMMETRIC rpc blackhole between named node pairs
              (``partition=blackhole:src=n0:dst=n1`` drops every call
              n0 makes TO n1; the n1->n0 direction stays up).  The
              process's own identity comes from ``set_local_node``
              (servers set it from --name at boot); ``dst`` matches a
              node name against the dialed address via the LocalTransport
              ``local:<name>`` form or an explicit
              ``register_node_addr(name, addr)`` mapping.  A standing
              filter: it fires on every matching call (bounded only by
              ``count``/``after``), unlike the seeded one-shot sites.
- ``join`` / ``leave`` — membership-change schedules carried exactly
              like ``kill`` (``join=n3:at=2;leave=n0:at=3``): the
              harness reads them via ``kills_for_cycle(cycle,
              site="join")`` / ``events_for_cycle`` and performs the
              discovery edit + rebalance itself, so elastic-cluster
              moves are chaos-testable under the same determinism.

Spec grammar (``BYDB_FAULTS`` env var or an explicit ``configure()``):

    spec   := clause (";" clause)*
    clause := "seed=" INT
            | SITE "=" KIND (":" key "=" value)*

    BYDB_FAULTS="seed=42;rpc=delay:p=0.2:ms=50;rpc=error:every=7;
                 sync=corrupt:every=3:count=2;disk=enospc:after=1:count=1;
                 kill=n0:at=1;kill=n1:at=2"

Per-rule keys: ``p`` (fire with probability p), ``every`` (fire each
Nth decision at the site), ``after`` (skip the first N decisions),
``count`` (fire at most N times), ``ms`` (delay duration, rpc=delay),
``match`` (substring filter on the decision detail, e.g. a topic name),
``at`` (kill: the chaos cycle index the kill belongs to).

Determinism contract (pinned by tests/test_faults.py): every site owns
a decision counter and a dedicated ``random.Random`` seeded from
``(seed, site)``.  Each decision draws exactly one uniform per
probabilistic rule of that site — in clause order, whether or not the
rule fires — so the decision-index -> fault mapping is a pure function
of (seed, schedule).  A fault's history entry records ``(site,
decision_seq, kind)``; replaying the same schedule against the same
decision sequence reproduces the same faults.  Which *request* lands on
which decision index depends on thread interleaving; the per-site fault
sequence does not.

Every fired fault also bumps ``fault_injected_total{site,kind}`` on the
process-global meter, so chaos artifacts can assert the schedule
actually ran.
"""

from __future__ import annotations

import errno
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

# fault kinds understood per boundary (free-form sites are allowed; the
# hooks below only act on the kinds they know)
RPC_KINDS = ("error", "unavailable", "shed", "delay")
SYNC_KINDS = ("cut", "truncate", "corrupt")
DISK_KINDS = ("enospc", "short")
PARTITION_KINDS = ("blackhole",)

# -- node identity (the partition site's "who am I" + addr book) -------------
# Process-global by design: production runs one node per process, and
# the harness/tests set the identity explicitly per scenario.
_LOCAL_NODE = ""
_NODE_ADDRS: dict[str, set[str]] = {}
_IDENT_LOCK = threading.Lock()


def set_local_node(name: str) -> None:
    """Declare this process's node identity for the ``partition`` site
    (servers call it with --name at boot; "" clears)."""
    global _LOCAL_NODE
    _LOCAL_NODE = name or ""


def local_node() -> str:
    return _LOCAL_NODE


def register_node_addr(name: str, addr: str) -> None:
    """Teach the partition matcher a node's transport address (the
    LocalTransport ``local:<name>`` form needs no registration)."""
    with _IDENT_LOCK:
        _NODE_ADDRS.setdefault(name, set()).add(addr)


def clear_node_addrs() -> None:
    with _IDENT_LOCK:
        _NODE_ADDRS.clear()


def _addr_is_node(name: str, addr: str) -> bool:
    if addr == name or addr == f"local:{name}":
        return True
    with _IDENT_LOCK:
        return addr in _NODE_ADDRS.get(name, ())


class DeadlineExceeded(RuntimeError):
    """A data node rejecting work whose liaison-propagated deadline is
    already exhausted.  Classified as kind="deadline" on the wire (the
    node is healthy — the query was simply too late), so the liaison
    degrades the response instead of evicting the node."""


@dataclass(frozen=True)
class FaultAction:
    """One decided fault: where, what, and the reproducible index."""

    site: str
    kind: str
    seq: int  # the site's decision index that produced this fault
    params: dict = field(default_factory=dict)


class _Rule:
    __slots__ = ("site", "kind", "p", "every", "after", "count", "params",
                 "fired")

    def __init__(self, site: str, kind: str, params: dict):
        self.site = site
        self.kind = kind
        self.p = float(params["p"]) if "p" in params else None
        self.every = int(params["every"]) if "every" in params else None
        self.after = int(params.get("after", 0))
        self.count = int(params["count"]) if "count" in params else None
        self.params = params
        self.fired = 0

    def spec(self) -> str:
        extra = ":".join(f"{k}={v}" for k, v in sorted(self.params.items()))
        return f"{self.site}={self.kind}" + (f":{extra}" if extra else "")


def _parse(spec: str) -> tuple[int, list[_Rule]]:
    seed = 0
    rules: list[_Rule] = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        head, _, tail = clause.partition(":")
        site, _, kind = head.partition("=")
        site, kind = site.strip(), kind.strip()
        if site == "seed":
            seed = int(kind)
            continue
        if not site or not kind:
            raise ValueError(f"bad BYDB_FAULTS clause {clause!r}")
        params: dict = {}
        if tail:
            for kv in tail.split(":"):
                k, _, v = kv.partition("=")
                if not k or not v:
                    raise ValueError(
                        f"bad BYDB_FAULTS param {kv!r} in {clause!r}"
                    )
                params[k.strip()] = v.strip()
        rules.append(_Rule(site, kind, params))
    return seed, rules


class FaultPlane:
    """Seeded decision engine over the parsed schedule.

    ``decide(site, detail)`` is the one entry point every boundary hook
    funnels through; it returns the fault to inject (or None) and
    advances that site's decision counter.
    """

    HISTORY_CAP = 4096

    def __init__(self, spec: str = ""):
        import random

        self.spec = spec
        self.seed, self._rules = _parse(spec)
        self._by_site: dict[str, list[_Rule]] = {}
        for r in self._rules:
            self._by_site.setdefault(r.site, []).append(r)
        self._counters: dict[str, int] = {}
        self._rngs: dict[str, object] = {
            site: random.Random(f"{self.seed}/{site}")
            for site in self._by_site
        }
        self.history: list[tuple[str, int, str]] = []
        self._lock = threading.Lock()

    # -- core ---------------------------------------------------------------
    def decide(self, site: str, detail: str = "") -> Optional[FaultAction]:
        """Advance `site`'s decision counter and return the fault the
        schedule assigns to this decision index, if any."""
        rules = self._by_site.get(site)
        if not rules:
            return None
        with self._lock:
            n = self._counters.get(site, 0)
            self._counters[site] = n + 1
            rng = self._rngs[site]
            hit: Optional[_Rule] = None
            for rule in rules:
                # one uniform per probabilistic rule per decision, drawn
                # unconditionally: the draw stream stays aligned with the
                # decision index whatever fires or filters
                draw = rng.random() if rule.p is not None else None
                if hit is not None:
                    continue
                if n < rule.after:
                    continue
                if rule.count is not None and rule.fired >= rule.count:
                    continue
                if rule.every is not None and (n - rule.after) % rule.every:
                    continue
                if draw is not None and draw >= rule.p:
                    continue
                if rule.params.get("match") and rule.params["match"] not in detail:
                    continue
                hit = rule
            if hit is None:
                return None
            hit.fired += 1
            if len(self.history) < self.HISTORY_CAP:
                self.history.append((site, n, hit.kind))
        from banyandb_tpu_torch.obs.metrics import global_meter

        global_meter().counter_add(
            "fault_injected", 1.0, {"site": site, "kind": hit.kind}
        )
        return FaultAction(site, hit.kind, n, dict(hit.params))

    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)

    # -- boundary hooks -----------------------------------------------------
    def check_partition(self, local: str, addr: str, topic: str) -> None:
        """partition boundary: drop the call when an active rule names
        (local -> addr's node) — BEFORE the rpc site draws, so a
        blackholed call never consumes an rpc decision.  Asymmetric by
        construction: only the src->dst direction ever matches."""
        rules = self._by_site.get("partition")
        if not rules:
            return
        hit: Optional[_Rule] = None
        with self._lock:
            n = self._counters.get("partition", 0)
            for rule in rules:
                src = rule.params.get("src", "")
                dst = rule.params.get("dst", "")
                if src and src != local:
                    continue
                if dst and not _addr_is_node(dst, addr):
                    continue
                if rule.count is not None and rule.fired >= rule.count:
                    continue
                if n < rule.after:
                    continue
                hit = rule
                break
            # the decision counter advances only on MATCHING pairs: an
            # un-partitioned peer's traffic never perturbs the site
            if hit is not None:
                self._counters["partition"] = n + 1
                hit.fired += 1
                if len(self.history) < self.HISTORY_CAP:
                    self.history.append(("partition", n, hit.kind))
        if hit is None:
            return
        from banyandb_tpu_torch.cluster.rpc import TransportError

        from banyandb_tpu_torch.obs.metrics import global_meter

        global_meter().counter_add(
            "fault_injected", 1.0, {"site": "partition", "kind": hit.kind}
        )
        raise TransportError(
            f"rpc to {addr} blackholed: partition {local or '?'}->"
            f"{hit.params.get('dst', addr)} "
            f"[fault site=partition kind={hit.kind}]"
        )

    def fail_rpc(self, addr: str, topic: str) -> None:
        """rpc boundary: raise/delay per the schedule, before dispatch."""
        self.check_partition(_LOCAL_NODE, addr, topic)
        act = self.decide("rpc", topic)
        if act is None:
            return
        from banyandb_tpu_torch.cluster.rpc import TransportError

        tag = f"[fault site=rpc seq={act.seq} kind={act.kind}]"
        if act.kind == "delay":
            time.sleep(float(act.params.get("ms", 50.0)) / 1000.0)
            return
        if act.kind == "shed":
            raise TransportError(
                f"ServerBusy: injected shed for {addr}/{topic} {tag}",
                kind="shed",
            )
        # "error" and "unavailable" both surface as hard transport
        # failures (the gRPC path maps UNAVAILABLE into the same class)
        raise TransportError(f"rpc to {addr} failed: injected {tag}")

    def check_disk(self, where: str) -> Optional[str]:
        """disk boundary: raise ENOSPC, or return "short" when the caller
        must simulate a torn write (write partial bytes, then raise)."""
        act = self.decide("disk", where)
        if act is None:
            return None
        if act.kind == "short":
            return "short"
        raise OSError(
            errno.ENOSPC,
            f"injected ENOSPC at {where} [fault site=disk seq={act.seq}]",
        )

    def sync_injector(self):
        """sync boundary: a chunked_sync-shaped injector driven by this
        plane (duck-typed: before_sync + mutate_request), or None when
        the schedule names no sync faults."""
        if "sync" not in self._by_site:
            return None
        return _PlaneSyncInjector(self)

    def kills_for_cycle(self, cycle: int, site: str = "kill") -> list[str]:
        """Node names the schedule kills at this chaos cycle
        (site=<site>, kind=<node>, at=<cycle>).  Consumed by the
        harness; the plane never kills anything itself.  ``site``
        selects the kill plane: ``kill`` = cluster data nodes,
        ``worker`` = shard-owning worker processes of the multi-process
        data plane (cluster/workers.py)."""
        out = []
        for rule in self._by_site.get(site, ()):
            if int(rule.params.get("at", 0)) == cycle:
                out.append(rule.kind)
        return out

    def events_for_cycle(
        self,
        cycle: int,
        sites: tuple[str, ...] = ("kill", "worker", "join", "leave"),
    ) -> dict[str, list[str]]:
        """Every scheduled membership/kill event for one chaos cycle:
        {site: [node, ...]}.  ``join``/``leave`` ride the same
        ``<site>=<node>:at=<cycle>`` grammar as kills — the harness
        performs the discovery edit and the rebalance plan/apply, the
        plane only carries the schedule (docs/robustness.md "Elastic
        cluster")."""
        return {site: self.kills_for_cycle(cycle, site=site) for site in sites}


class _PlaneSyncInjector:
    """Chunked-sync injector driven by the plane's sync schedule: one
    decision per outgoing chunk."""

    def __init__(self, plane: FaultPlane):
        self._plane = plane

    def before_sync(self, part_dirs):  # noqa: ARG002 - injector contract
        return (False, "")

    def mutate_request(self, req):
        act = self._plane.decide("sync", f"chunk:{req.chunk_index}")
        if act is None:
            return req
        tag = f"[fault site=sync seq={act.seq} kind={act.kind}]"
        if act.kind == "cut":
            from banyandb_tpu_torch.cluster.rpc import TransportError

            raise TransportError(f"sync stream cut mid-flight {tag}")
        if req.chunk_data:
            if act.kind == "truncate":
                # drop the tail AFTER the checksum was computed: the
                # receiver's CRC catches the torn chunk
                req.chunk_data = req.chunk_data[: len(req.chunk_data) // 2]
            elif act.kind == "corrupt":
                req.chunk_data = (
                    bytes([req.chunk_data[0] ^ 0xFF]) + req.chunk_data[1:]
                )
        return req


# -- process-global plane ----------------------------------------------------
# One plane per process, parsed from BYDB_FAULTS at first use (or set
# explicitly by tests/harnesses via configure()).  `_ACTIVE` keeps the
# fault-free hot path to one module-global read.

_PLANE: Optional[FaultPlane] = None
_ACTIVE = False
_INIT = False
_GLOBAL_LOCK = threading.Lock()


def get_plane() -> Optional[FaultPlane]:
    global _PLANE, _ACTIVE, _INIT
    if not _INIT:
        with _GLOBAL_LOCK:
            if not _INIT:
                from banyandb_tpu_torch.utils.envflag import env_str

                spec = env_str("BYDB_FAULTS").strip()
                _PLANE = FaultPlane(spec) if spec else None
                _ACTIVE = _PLANE is not None
                _INIT = True
    return _PLANE


def configure(spec: str) -> FaultPlane:
    """Install a fresh plane for `spec` (tests/harnesses); "" clears."""
    global _PLANE, _ACTIVE, _INIT
    with _GLOBAL_LOCK:
        _PLANE = FaultPlane(spec) if spec else None
        _ACTIVE = _PLANE is not None
        _INIT = True
    return _PLANE  # type: ignore[return-value]


def clear() -> None:
    configure("")


def active() -> bool:
    if not _INIT:
        get_plane()
    return _ACTIVE


def maybe_fail_rpc(addr: str, topic: str) -> None:
    """Transport hook: no-op unless a plane with rpc rules is active."""
    if _ACTIVE or not _INIT:
        plane = get_plane()
        if plane is not None:
            plane.fail_rpc(addr, topic)


def check_disk(where: str) -> Optional[str]:
    """Disk hook: None (proceed), "short" (caller tears the write), or
    raises OSError(ENOSPC)."""
    if _ACTIVE or not _INIT:
        plane = get_plane()
        if plane is not None:
            return plane.check_disk(where)
    return None


def plane_sync_injector():
    if _ACTIVE or not _INIT:
        plane = get_plane()
        if plane is not None:
            return plane.sync_injector()
    return None
