"""Node registry + replica placement (pkg/node/round_robin.go analog)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class NodeInfo:
    name: str
    addr: str  # transport address ("local:<name>" or "host:port")
    roles: tuple[str, ...] = ("data",)
    # lifecycle stages this node serves (hot/warm/cold tier labels,
    # banyand/queue/pub/stage.go ResolveStage analog); empty = all stages
    stages: tuple[str, ...] = ()

    def serves_stage(self, stage: str) -> bool:
        return not self.stages or stage in self.stages


class RoundRobinSelector:
    """Deterministic shard -> replica-ordered node list.

    node for (shard, replica r) = nodes[(shard + r) % len(nodes)]
    (pkg/node/round_robin.go:219-248 contract): every node gets an equal
    share of primaries and replicas follow consecutively.
    """

    def __init__(self, nodes: list[NodeInfo], replicas: int = 0):
        self.nodes = sorted(nodes, key=lambda n: n.name)
        self.replicas = replicas

    def replica_set(self, shard: int) -> list[NodeInfo]:
        n = len(self.nodes)
        if n == 0:
            raise RuntimeError("no data nodes registered")
        count = min(self.replicas + 1, n)
        return [self.nodes[(shard + r) % n] for r in range(count)]

    def primary(self, shard: int, alive: set[str] | None = None) -> NodeInfo:
        """First alive node in the shard's replica order (failover walk)."""
        for node in self.replica_set(shard):
            if alive is None or node.name in alive:
                return node
        raise RuntimeError(f"no alive replica for shard {shard}")
