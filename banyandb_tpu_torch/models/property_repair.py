"""Property anti-entropy repair: Merkle reconciliation between replicas.

Analog of banyand/property/db/repair.go + repair_gossip.go
(docs/concept/property-repair.md): each replica summarizes its
(group, name) property set as a two-level hash tree — root over 256
slots, slot over the docs hashing into it (slot = doc_id % 256) — and two
replicas reconcile root -> differing slots -> per-doc (id, mod_revision)
lists; the higher mod_revision wins each conflict and missing docs copy
across.  The exchange shape mirrors the reference's bidi-gRPC rounds but
runs over any pair of PropertyEngine handles (the gossip scheduler
drives pair selection above this layer).
"""

from __future__ import annotations

import hashlib
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from banyandb_tpu_torch.models.property import Property, PropertyEngine

SLOTS = 256


def _doc_hash(p) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(p.id.encode())
    h.update(p.mod_revision.to_bytes(8, "little"))
    for k in sorted(p.tags):
        h.update(k.encode() + b"=" + str(p.tags[k]).encode() + b";")
    return h.digest()


def wins(x, y) -> bool:
    """True when doc x beats doc y: higher mod_revision, with a
    deterministic content-hash tie-break — revisions are per-node
    counters, so two nodes can mint EQUAL revisions for different
    content; without a total order those replicas would never
    converge."""
    if x.mod_revision != y.mod_revision:
        return x.mod_revision > y.mod_revision
    return _doc_hash(x) > _doc_hash(y)


def _slot_of(p) -> int:
    return int.from_bytes(
        hashlib.blake2b(p.id.encode(), digest_size=2).digest(), "little"
    ) % SLOTS


def state_tree(engine: "PropertyEngine", group: str, name: str) -> dict:
    """{'root': hex, 'slots': {slot: hex}} — the state-tree.data analog."""
    slots: dict[int, hashlib.blake2b] = {}
    for p in engine.query(group, name, limit=1_000_000):
        s = _slot_of(p)
        h = slots.get(s)
        if h is None:
            h = slots[s] = hashlib.blake2b(digest_size=16)
        h.update(_doc_hash(p))
    slot_hex = {s: h.hexdigest() for s, h in sorted(slots.items())}
    root = hashlib.blake2b(digest_size=16)
    for s, hx in sorted(slot_hex.items()):
        root.update(s.to_bytes(2, "little") + bytes.fromhex(hx))
    return {"root": root.hexdigest(), "slots": slot_hex}


def _slot_docs(engine, group, name, slot: int) -> dict[str, "Property"]:
    return {
        p.id: p
        for p in engine.query(group, name, limit=1_000_000)
        if _slot_of(p) == slot
    }


def repair_pair(
    a: "PropertyEngine", b: "PropertyEngine", group: str, name: str
) -> int:
    """Reconcile (group, name) between two replicas; returns docs copied.

    Round 1: roots.  Round 2: differing slots.  Round 3: per-doc
    (id, mod) — higher mod_revision wins, ties are already identical by
    hash construction, missing docs copy across.
    """
    from banyandb_tpu_torch.models.property import Property

    ta, tb = state_tree(a, group, name), state_tree(b, group, name)
    if ta["root"] == tb["root"]:
        return 0
    slots = set(ta["slots"]) | set(tb["slots"])
    copied = 0
    for s in slots:
        if ta["slots"].get(s) == tb["slots"].get(s):
            continue
        docs_a = _slot_docs(a, group, name, int(s))
        docs_b = _slot_docs(b, group, name, int(s))
        for pid in set(docs_a) | set(docs_b):
            pa, pb = docs_a.get(pid), docs_b.get(pid)
            if pa is not None and (pb is None or wins(pa, pb)):
                _install(b, pa)
                copied += 1
            elif pb is not None and (pa is None or wins(pb, pa)):
                _install(a, pb)
                copied += 1
    return copied


# -- persisted shard state tree (state-tree.data analog) --------------------


def _entity_of(p) -> str:
    return f"{p.name}/{p.id}"


def _entity_slot(entity: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(entity.encode(), digest_size=2).digest(), "little"
    ) % SLOTS


def build_shard_tree(engine: "PropertyEngine", group: str, shard: int) -> dict:
    """Three-level Merkle over one (group, shard): root -> slot SHAs ->
    per-entity leaf SHAs, PERSISTED next to the shard
    (banyand/property/db/repair.go:95 state-tree.data analog).  The
    persisted tree is reused while the engine revision is unchanged, so
    repeated gossip rounds over a quiet shard cost one file read."""
    import json

    from banyandb_tpu_torch.utils import fs

    path = engine.root / "repair" / f"state-tree-{group}-{shard}.json"
    rev = engine.revision
    try:
        cached = json.loads(path.read_text())
        if cached.get("built_rev") == rev:
            return cached
    except (OSError, ValueError):
        pass

    leaves: dict[str, list] = {}
    for p in engine.docs_in_shard(group, shard):
        e = _entity_of(p)
        s = str(_entity_slot(e))
        leaves.setdefault(s, []).append([e, _doc_hash(p).hex()])
    for lst in leaves.values():
        lst.sort()
    slot_sha = {}
    for s, lst in leaves.items():
        h = hashlib.blake2b(digest_size=16)
        for e, hx in lst:
            h.update(e.encode() + bytes.fromhex(hx))
        slot_sha[s] = h.hexdigest()
    root = hashlib.blake2b(digest_size=16)
    for s in sorted(slot_sha, key=int):
        root.update(int(s).to_bytes(2, "little") + bytes.fromhex(slot_sha[s]))
    tree = {
        "built_rev": rev,
        "root": root.hexdigest(),
        "slots": slot_sha,
        "leaves": leaves,
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    fs.atomic_write_json(path, tree)
    return tree


def install_verbatim(engine: "PropertyEngine", p) -> None:
    """Public alias of _install for the wire repair path."""
    _install(engine, p)


def _install(engine: "PropertyEngine", p) -> None:
    """Install a replica's doc verbatim (preserving its mod_revision) —
    repair must not mint new revisions or the tree never converges."""
    import json

    from banyandb_tpu_torch.index.inverted import Doc

    # the engine's revision counter is the persisted state tree's
    # freshness guard: advance it so the NEXT build_shard_tree sees the
    # install (the doc's own mod_revision stays the replica's, above)
    with engine._lock:
        engine._revision += 1
    idx = engine._shard_for(p.group, p.name, p.id)
    keywords = {"@name": p.name.encode(), "@id": p.id.encode()}
    for k, v in p.tags.items():
        keywords[k] = str(v).encode()
    idx.insert(
        [
            Doc(
                doc_id=engine._doc_id(p.name, p.id),
                keywords=keywords,
                numerics={"@mod": p.mod_revision, "@create": p.create_revision},
                payload=json.dumps(
                    {"id": p.id, "name": p.name, "tags": p.tags}
                ).encode(),
            )
        ]
    )
