"""Epoch-versioned shard placement (docs/robustness.md "Elastic cluster").

Replaces the implicit round-robin shard->node mapping with an EXPLICIT,
persisted, epoch-fenced placement map (the reference's liaison placement
layer grown a version number):

- ``PlacementMap`` — one epoch + the replica chain per shard.  A fresh
  map (``initial``) carries NO explicit chains: every shard resolves
  through the round-robin closed form over the sorted node ring, so a
  brand-new cluster places exactly like the historical
  ``RoundRobinSelector`` — byte-identical routing, now with an epoch.
  A rebalance plan (cluster/rebalance.py) materializes explicit chains
  and bumps the epoch at cutover.
- ``PlacementSelector`` — the liaison's routing view: an addr book (the
  discovered ``NodeInfo`` set, which may include joined nodes that own
  no shards yet) resolved against the placement's chains.  Drop-in for
  the old selector surface (``nodes`` / ``replicas`` / ``replica_set`` /
  ``primary``).
- ``StaleEpoch`` — the write fence.  Every write/scatter envelope
  carries ``placement_epoch``; data nodes remember the highest epoch
  they have seen (persisted) and REJECT writes stamped with an older
  one (wire ``kind="stale_epoch"``, retryable — the sender is healthy
  but holds a superseded map and must refresh before retrying).  A
  mover and a straggling liaison can therefore never double-apply a
  write across a cutover.

The epoch changes ONLY at an explicit rebalance cutover.  Membership
changes alone (discovery file edits, node joins/leaves) never move
shards — see ``Liaison.refresh_nodes``.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence

from banyandb_tpu_torch.cluster.node import NodeInfo


class StaleEpoch(RuntimeError):
    """A data node rejecting a write whose ``placement_epoch`` is older
    than the node's remembered epoch.  Classified ``kind="stale_epoch"``
    on the wire: the sender is HEALTHY but routing on a superseded
    placement map — it must refresh (re-read the persisted map / learn
    the new epoch) and retry, never spool-and-replay the fenced copy."""


@dataclass(frozen=True)
class PlacementMap:
    """Shard -> replica-ordered node-name chains, versioned by epoch.

    ``chains`` lists explicit chains for shards ``0..len(chains)-1``;
    shards beyond (a group created after the last rebalance with a
    larger shard_num) fall back to the round-robin closed form over
    ``nodes`` — the same formula ``RoundRobinSelector`` used, so the
    fallback is deterministic and identical across every holder of the
    same map."""

    epoch: int
    nodes: tuple[str, ...]  # sorted ring for the round-robin fallback
    replicas: int
    chains: tuple[tuple[str, ...], ...] = field(default=())

    @classmethod
    def initial(cls, node_names: Sequence[str], replicas: int) -> "PlacementMap":
        """Epoch-1 map with no explicit chains: placement equals the
        historical round-robin for every shard count."""
        return cls(
            epoch=1,
            nodes=tuple(sorted(node_names)),
            replicas=int(replicas),
            chains=(),
        )

    def chain(self, shard: int) -> tuple[str, ...]:
        if 0 <= shard < len(self.chains):
            return self.chains[shard]
        n = len(self.nodes)
        if n == 0:
            return ()
        count = min(self.replicas + 1, n)
        return tuple(self.nodes[(shard + r) % n] for r in range(count))

    def to_json(self) -> dict:
        return {
            "epoch": self.epoch,
            "nodes": list(self.nodes),
            "replicas": self.replicas,
            "chains": [list(c) for c in self.chains],
        }

    @classmethod
    def from_json(cls, d: dict) -> "PlacementMap":
        return cls(
            epoch=int(d["epoch"]),
            nodes=tuple(d.get("nodes", ())),
            replicas=int(d.get("replicas", 0)),
            chains=tuple(tuple(c) for c in d.get("chains", ())),
        )

    # -- persistence (the liaison's placement store) -------------------------
    def save(self, path: str | Path) -> None:
        from banyandb_tpu_torch.utils import fs

        fs.atomic_write_json(Path(path), self.to_json())

    @classmethod
    def load(cls, path: str | Path) -> Optional["PlacementMap"]:
        try:
            return cls.from_json(json.loads(Path(path).read_text()))
        except (OSError, ValueError, KeyError):
            return None


class PlacementSelector:
    """Routing view = addr book (NodeInfo set) x placement chains.

    The addr book may be WIDER than the placement (a joined node is
    reachable for schema sync and part shipping before any rebalance
    hands it shards) or narrower (a departed node's chains keep naming
    it until a plan cuts over — its legs simply show as down).  Same
    read surface as the old ``RoundRobinSelector``."""

    def __init__(self, nodes: list[NodeInfo], placement: PlacementMap):
        self.nodes = sorted(nodes, key=lambda n: n.name)
        self.placement = placement
        self.replicas = placement.replicas
        self._by_name = {n.name: n for n in self.nodes}

    def node_by_name(self, name: str) -> Optional[NodeInfo]:
        return self._by_name.get(name)

    def replica_set(self, shard: int) -> list[NodeInfo]:
        if not self.nodes:
            raise RuntimeError("no data nodes registered")
        return [
            self._by_name[nm]
            for nm in self.placement.chain(shard)
            if nm in self._by_name
        ]

    def primary(self, shard: int, alive: "set[str] | None" = None) -> NodeInfo:
        """First alive node in the shard's replica chain (failover walk,
        same contract as RoundRobinSelector.primary)."""
        for node in self.replica_set(shard):
            if alive is None or node.name in alive:
                return node
        raise RuntimeError(f"no alive replica for shard {shard}")


class EpochRecord:
    """A data node's persisted highest-seen placement epoch — the write
    fence's memory.  Epochs only ratchet UP: adopting a higher epoch
    (from a cutover broadcast or any fenced envelope) persists it, so a
    restarted node keeps rejecting writes from before the last cutover
    it witnessed."""

    def __init__(self, path: str | Path):
        self._path = Path(path)
        self._lock = threading.Lock()
        try:
            self._epoch = int(
                json.loads(self._path.read_text()).get("epoch", 0)
            )
        except (OSError, ValueError):
            self._epoch = 0

    @property
    def epoch(self) -> int:
        return self._epoch

    def observe(self, epoch: int, *, source: str = "") -> None:
        """Ratchet toward `epoch`; raise StaleEpoch when the envelope is
        BEHIND the node's remembered epoch (the double-apply fence)."""
        epoch = int(epoch)
        with self._lock:
            cur = self._epoch
            if epoch > cur:
                self._epoch = epoch
                from banyandb_tpu_torch.utils import fs

                try:
                    fs.atomic_write_json(self._path, {"epoch": epoch})
                except OSError:
                    # a full disk must not fail the write that carried
                    # the fresher epoch; the fence just loses restart
                    # durability until the next successful persist
                    pass
                from banyandb_tpu_torch.obs.metrics import global_meter

                global_meter().gauge_set("placement_epoch", float(epoch))
                return
        if epoch < cur:
            from banyandb_tpu_torch.obs.metrics import global_meter

            global_meter().counter_add(
                "stale_epoch_rejected", 1.0, {"site": source or "write"}
            )
            raise StaleEpoch(
                f"placement epoch {epoch} is stale (node at {cur}); "
                "refresh the placement map and retry"
            )


def parse_epoch_topic(topic: str) -> "tuple[str, int | None]":
    """Split a ``<topic>@epoch=N`` wire topic -> (bare topic, epoch or
    None).  The placement-epoch fence rides the topic string because
    the SyncMetadata proto has no spare field; receivers parse it here
    and feed their EpochRecord.  Kept beside ``EpochRecord`` so the
    in-process path reads it without the streaming sync module (which
    imports gRPC and the protobuf stubs and imports it from here)."""
    base, sep, tail = topic.partition("@epoch=")
    if not sep:
        return topic, None
    try:
        return base, int(tail)
    except ValueError:
        return base, None
