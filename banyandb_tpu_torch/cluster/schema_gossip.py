"""Schema anti-entropy gossip.

Analog of the reference's gossip-backed schema distribution
(banyand/metadata/schema/schemaserver + pkg/schema/cache.go watch/sync):
the primary distribution path here is liaison push + hinted handoff, but
a node that missed pushes AND lost its spool would never converge.  The
gossiper closes that hole: each round it picks a random peer, exchanges
per-object content digests, and pulls objects it LACKS (absent keys —
the catch-up case).  Same-key content conflicts are never auto-resolved
(no comparable cross-node revision exists); they are surfaced in the
round report for the liaison to re-push authoritatively.
"""

from __future__ import annotations

import logging
import random
import threading
from typing import Optional

from banyandb_tpu_torch.cluster.rpc import TransportError

log = logging.getLogger("banyandb.schema-gossip")

TOPIC_SCHEMA_DIGEST = "schema-digest"
TOPIC_SCHEMA_PULL = "schema-pull"


def register_handlers(bus, registry) -> None:
    """Mount the gossip topics on a node's bus."""
    from banyandb_tpu_torch.api import schema as schema_mod

    bus.subscribe(
        TOPIC_SCHEMA_DIGEST,
        lambda env: {
            "digests": registry.digests(),
            "tombstones": registry.tombstones(),
        },
    )

    def pull(env):
        item = registry.export_object(env["kind"], env["key"])
        if item is None:
            raise KeyError(f"{env['kind']} {env['key']} not found")
        return {"item": item}

    bus.subscribe(TOPIC_SCHEMA_PULL, pull)
    # needed to APPLY pulled objects locally
    assert schema_mod  # imported for _from_jsonable at apply time


class SchemaGossiper:
    def __init__(self, registry, transport, peers, *, interval_s: float = 30.0):
        """peers: list[NodeInfo] excluding self."""
        self.registry = registry
        self.transport = transport
        self.peers = list(peers)
        self.interval_s = interval_s
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.pulled = 0
        self.deleted = 0
        self.conflicts: set[tuple[str, str]] = set()  # standing conflicts
        # dedup so a standing conflict doesn't re-append every round

    def run_once(self, peer=None) -> dict:
        """One reconcile round against one (random) peer.
        -> {"pulled": [...], "conflicts": [...]}"""
        from banyandb_tpu_torch.api import schema as schema_mod

        if peer is None:
            if not self.peers:
                return {"pulled": [], "deleted": [], "conflicts": []}
            peer = random.choice(self.peers)
        try:
            resp = self.transport.call(
                peer.addr, TOPIC_SCHEMA_DIGEST, {}, timeout=10
            )
            remote = resp["digests"]
            remote_tombs = resp.get("tombstones", {})
        except TransportError as e:
            log.debug("digest fetch from %s failed: %s", peer.name, e)
            return {"pulled": [], "deleted": [], "conflicts": []}
        local = self.registry.digests()
        local_tombs = self.registry.tombstones()
        pulled, deleted, conflicts = [], [], []
        # deletions first: a peer's tombstone beats our live copy OF THE
        # SAME CONTENT (the delete happened after we received it); a
        # differing local object is a newer create and survives
        for kind, graves in remote_tombs.items():
            for key, buried_hash in graves.items():
                if key in local.get(kind, {}):
                    if self.registry.apply_tombstone(kind, key, buried_hash):
                        deleted.append((kind, key))
        for kind, remote_keys in remote.items():
            local_keys = local.get(kind, {})
            graves = local_tombs.get(kind, {})
            for key, rhash in remote_keys.items():
                if graves.get(key) == rhash:
                    # exactly the content WE deleted; never resurrect it
                    # (a recreate has a different hash and pulls normally;
                    # an IDENTICAL recreate stays buried until the liaison
                    # re-pushes authoritatively — documented limitation)
                    continue
                lhash = local_keys.get(key)
                if lhash == rhash:
                    continue
                if lhash is not None:
                    # content conflict: no comparable revision — surface,
                    # never guess (the liaison re-push is authoritative)
                    conflicts.append((kind, key))
                    continue
                try:
                    item = self.transport.call(
                        peer.addr,
                        TOPIC_SCHEMA_PULL,
                        {"kind": kind, "key": key},
                        timeout=10,
                    )["item"]
                except (TransportError, KeyError):
                    continue
                cls = schema_mod._KINDS[kind]
                self.registry._put(kind, schema_mod._from_jsonable(cls, item))
                pulled.append((kind, key))
        self.pulled += len(pulled)
        self.deleted += len(deleted)
        new_conflicts = set(conflicts) - self.conflicts
        self.conflicts |= set(conflicts)
        if new_conflicts:
            log.warning(
                "schema gossip: %d NEW content conflicts with %s: %s",
                len(new_conflicts),
                peer.name,
                sorted(new_conflicts)[:5],
            )
        return {"pulled": pulled, "deleted": deleted, "conflicts": conflicts}

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.run_once()
                except Exception:  # noqa: BLE001 - gossip must survive
                    log.exception("gossip round failed")

        self._thread = threading.Thread(
            target=loop, daemon=True, name="schema-gossip"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
