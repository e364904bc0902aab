"""The port's property model and its replica repair against the JAX
package's, on the CPU.

Both packages run the same script of applies (merge and replace),
deletes, leases and queries; each engine's revision counter starts from
the same value, so revisions compare exactly.  Then one TTL sweep, a
persist and reopen (also across packages: each reads the other's shard
indexes), and one repair round between two diverged replicas with the
state trees of both packages.

Tolerance: none — properties, revisions, counts and hashes are exact.
"""

import time

import pytest

from banyandb_tpu import api as japi
from banyandb_tpu.models import property_repair as jrepair
from banyandb_tpu.models.property import Property as JProperty
from banyandb_tpu.models.property import PropertyEngine as JEngine
from banyandb_tpu_torch import api as tapi
from banyandb_tpu_torch.models import property_repair as trepair
from banyandb_tpu_torch.models.property import Property as TProperty
from banyandb_tpu_torch.models.property import PropertyEngine as TEngine

PKGS = {
    "jax": (japi, JProperty, JEngine, jrepair),
    "torch": (tapi, TProperty, TEngine, trepair),
}
REV0 = 1_000
HOUR_MS = 3_600_000


def _engine(pkg, root):
    api, _p, engine, _r = PKGS[pkg]
    reg = api.SchemaRegistry(root)
    if "g" not in {g.name for g in reg.list_groups()}:
        reg.create_group(api.Group("g", api.Catalog.PROPERTY, api.ResourceOpts(shard_num=2)))
    eng = engine(reg, root / "data")
    eng._revision = REV0
    return eng


def _norm(props) -> list:
    return sorted(
        (p.group, p.name, p.id, tuple(sorted(p.tags.items())), p.mod_revision,
         p.create_revision)
        for p in props
    )


def _script(pkg, eng) -> list:
    """Applies, deletes and queries; -> what each step returned."""
    prop = PKGS[pkg][1]
    out = []
    for i in range(40):
        p = prop("g", "node", f"n{i}", {"role": ("data", "liaison")[i % 2], "rack": f"r{i % 3}"})
        out.append(_norm([eng.apply(p, ttl_seconds=3600 if i % 5 == 0 else None)]))
    out.append(_norm([eng.apply(prop("g", "node", "n3", {"role": "data"}))]))  # merge
    out.append(_norm([eng.apply(prop("g", "node", "n4", {"zone": "z1"}), strategy="replace")]))
    out.append(_norm([eng.apply(prop("g", "ui", "dash-1", {"kind": "dashboard"}))]))
    out.append([eng.delete("g", "node", "n7"), eng.delete("g", "node", "n7")])
    out.append(_norm([eng.get("g", "node", "n3")]))
    out.append(eng.get("g", "node", "n7"))
    out.append(_norm(eng.query("g", "node", tag_filters={"role": "data"}, limit=1000)))
    out.append(_norm(eng.query("g", "node", tag_filters={"role": "liaison", "rack": "r1"})))
    out.append(_norm(eng.query("g", "node", ids=["n1", "n2", "n4", "n7", "n99"])))
    out.append(_norm(eng.query("g", "ui")))
    out.append(len(eng.query("g", "node", limit=5)))
    out.append(eng.revision)
    return out


@pytest.fixture()
def engines(tmp_path):
    out = {pkg: _engine(pkg, tmp_path / pkg) for pkg in PKGS}
    yield out, tmp_path
    for eng in out.values():
        eng.close()


def test_apply_query_revisions_match_jax(engines):
    engs, _root = engines
    got = _script("torch", engs["torch"])
    assert got == _script("jax", engs["jax"])
    assert got[40][0][4] > got[39][0][4]  # the merge minted a newer revision
    assert dict(got[40][0][3]) == {"role": "data", "rack": "r0"}


def test_ttl_sweep_matches_jax(engines):
    engs, _root = engines
    later = int(time.time() * 1000) + 2 * HOUR_MS
    res = {}
    for pkg, eng in engs.items():
        _script(pkg, eng)
        first = eng.sweep_expired("g", now_millis=later)
        res[pkg] = (first, eng.sweep_expired("g", now_millis=later), eng.revision,
                    _norm(eng.query("g", "node", limit=1000)))
    assert res["torch"] == res["jax"]
    assert res["torch"][0] == 8 and res["torch"][1] == 0  # n0, n5, ... n35


@pytest.mark.parametrize("writer,reader", [("jax", "jax"), ("jax", "torch"),
                                           ("torch", "torch"), ("torch", "jax")])
def test_persist_and_reopen_across_packages(engines, writer, reader):
    engs, root = engines
    _script(writer, engs[writer])
    want = _norm(engs[writer].query("g", "node", limit=1000))
    engs[writer].persist()
    eng = _engine(reader, root / writer)
    try:
        assert _norm(eng.query("g", "node", limit=1000)) == want
        assert _norm([eng.get("g", "node", "n4")]) == _norm([engs[writer].get("g", "node", "n4")])
    finally:
        eng.close()


def _replicas(pkg, root):
    """Two replicas that diverged: a has n0..n29, b has n10..n39; b
    rewrote n12 (newer revision) and a deleted n20."""
    prop = PKGS[pkg][1]
    a, b = _engine(pkg, root / "a"), _engine(pkg, root / "b")
    for i in range(30):
        a.apply(prop("g", "node", f"n{i}", {"v": str(i)}))
    for i in range(10, 40):
        b.apply(prop("g", "node", f"n{i}", {"v": str(i)}))
    b.apply(prop("g", "node", "n12", {"v": "new"}))
    a.delete("g", "node", "n20")
    return a, b


def test_repair_round_matches_jax(tmp_path):
    res = {}
    for pkg, (_api, _p, _e, repair) in PKGS.items():
        a, b = _replicas(pkg, tmp_path / pkg)
        try:
            before = repair.state_tree(a, "g", "node"), repair.state_tree(b, "g", "node")
            copied = repair.repair_pair(a, b, "g", "node")
            after = repair.state_tree(a, "g", "node"), repair.state_tree(b, "g", "node")
            again = repair.repair_pair(a, b, "g", "node")
            trees = [repair.build_shard_tree(e, "g", s)["root"] for e in (a, b) for s in (0, 1)]
            res[pkg] = (before, copied, after, again, trees,
                        _norm(a.query("g", "node", limit=1000)),
                        _norm(b.query("g", "node", limit=1000)))
        finally:
            a.close()
            b.close()
    assert res["torch"] == res["jax"]
    _before, copied, after, again, trees, docs_a, docs_b = res["torch"]
    assert copied > 0 and again == 0 and after[0] == after[1]
    assert trees[:2] == trees[2:] and docs_a == docs_b
    assert dict(next(d for d in docs_a if d[2] == "n12")[3]) == {"v": "new"}
