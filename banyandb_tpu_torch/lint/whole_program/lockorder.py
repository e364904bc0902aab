"""Lock-order cycle detector over the acquires-while-holding graph.

Nodes are declaration-based lock identities (``module.Class.attr`` —
see callgraph.lock_identity).  An edge ``A -> B`` means: somewhere the
program acquires ``B`` (directly via a nested ``with``, or transitively
through a call chain) while ``A`` is held.  A cycle in this graph is a
*potential* deadlock: two threads taking the locks in opposite orders
can each end up waiting on the other.

"Potential" is load-bearing: identities are per declaration site, not
per instance, so ``node_a.lock -> node_b.lock`` between two instances of
the same class shows up as a self-edge.  Such self-edges are still worth
a look (cross-instance calls under a held lock are how fabric fan-outs
deadlock), but a verified-safe one is suppressed at the acquisition site
with a reason, like any bdlint finding.

Scope: the graph is built package-wide (edges through helper layers
count), and every cycle is reported — the fabric (cluster/, api/) is
where the multi-lock topology actually lives, per SURVEY §1.
"""

from __future__ import annotations

from dataclasses import dataclass

from banyandb_tpu_torch.lint.core import Finding
from banyandb_tpu_torch.lint.whole_program.callgraph import Program

RULE = "lock-order"


@dataclass(frozen=True)
class LockEdge:
    held: str
    acquired: str
    path: str
    line: int
    col: int
    via: str  # "" for a direct nested with, else the callee qualname


def build_lock_graph(program: Program) -> list[LockEdge]:
    """Every held->acquired pair, with the source location that creates
    it (the nested ``with`` or the call that transitively acquires)."""
    acq = program.lock_acquires()
    edges: list[LockEdge] = []
    for info in program.functions.values():
        for region in info.lock_regions:
            for lid, node in region.inner_locks:
                edges.append(
                    LockEdge(
                        held=region.lock_id,
                        acquired=lid,
                        path=info.path,
                        line=node.lineno,
                        col=node.col_offset,
                        via="",
                    )
                )
            for site in region.calls:
                if not site.callee:
                    continue
                for lid in sorted(acq.get(site.callee, ())):
                    edges.append(
                        LockEdge(
                            held=region.lock_id,
                            acquired=lid,
                            path=info.path,
                            line=site.line,
                            col=site.col,
                            via=site.callee,
                        )
                    )
    return edges


def _cycles(adj: dict[str, set[str]]) -> list[tuple[str, ...]]:
    """Elementary cycles, canonicalized (rotation-minimal, deduped).
    Bounded DFS — lock graphs here are tiny (tens of nodes)."""
    out: set[tuple[str, ...]] = set()

    def canon(path: tuple[str, ...]) -> tuple[str, ...]:
        i = path.index(min(path))
        return path[i:] + path[:i]

    def dfs(start: str, node: str, path: tuple[str, ...]) -> None:
        for nxt in sorted(adj.get(node, ())):
            if nxt == start:
                out.add(canon(path))
            elif nxt not in path and len(path) < 8:
                dfs(start, nxt, path + (nxt,))

    for n in sorted(adj):
        dfs(n, n, (n,))
    return sorted(out)


def analyze_lock_order(program: Program) -> list[Finding]:
    edges = build_lock_graph(program)
    adj: dict[str, set[str]] = {}
    for e in edges:
        if e.held != e.acquired:
            adj.setdefault(e.held, set()).add(e.acquired)
    findings: list[Finding] = []

    # self-edges: re-acquiring the same declaration while held — either a
    # genuine non-reentrant self-deadlock or a cross-instance hold.
    # Declarations assigned threading.RLock() are reentrant by design and
    # exempt (length>=2 cycles still report: lock ORDER across threads
    # matters regardless of reentrancy).
    self_edges = [
        e
        for e in edges
        if e.held == e.acquired and e.held not in program.reentrant_locks
    ]
    for e in self_edges:
        via = f" via `{e.via.split(':', 1)[1]}`" if e.via else ""
        findings.append(
            Finding(
                path=e.path,
                line=e.line,
                col=e.col,
                rule=RULE,
                message=(
                    f"`{e.acquired}` is acquired while already held{via}: "
                    "self-deadlock on a non-reentrant lock (or a "
                    "cross-instance hold chain — verify and suppress with "
                    "the reason)"
                ),
            )
        )

    by_pair: dict[tuple[str, str], LockEdge] = {}
    for e in edges:
        by_pair.setdefault((e.held, e.acquired), e)
    for cycle in _cycles(adj):
        hops = []
        for i, lock in enumerate(cycle):
            nxt = cycle[(i + 1) % len(cycle)]
            e = by_pair[(lock, nxt)]
            via = f" via {e.via.split(':', 1)[1]}" if e.via else ""
            hops.append(f"{lock} -> {nxt} (at {e.path}:{e.line}{via})")
        anchor = by_pair[(cycle[0], cycle[1 % len(cycle)])]
        findings.append(
            Finding(
                path=anchor.path,
                line=anchor.line,
                col=anchor.col,
                rule=RULE,
                message=(
                    "potential deadlock cycle: " + "; ".join(hops) + "; "
                    "pick one global acquisition order and restructure "
                    "the odd one out"
                ),
            )
        )
    return findings
