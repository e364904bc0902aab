"""bdwire for the port: the seeded-violation proofs and audited-tree
meta-tests of tests/test_wire_audit.py, with the port's wire analyzers
(copies of the reference's) run beside the reference's on every seeded
package — the same findings on the same inputs — and the behavioral
pins re-run against the port's fabric on the CPU.
"""

from __future__ import annotations

from pathlib import Path

import pytest

from banyandb_tpu_torch.lint.whole_program.callgraph import Program
from banyandb_tpu_torch.lint.wire.envelopes import analyze_envelopes
from banyandb_tpu_torch.lint.wire.envregistry import analyze_envflags
from banyandb_tpu_torch.lint.wire.fault_sites import analyze_fault_sites
from banyandb_tpu_torch.lint.wire.kinds import analyze_kinds
from banyandb_tpu_torch.lint.wire.obs_contract import analyze_obs
from banyandb_tpu_torch.lint.wire.retryable import analyze_retryable
from banyandb_tpu_torch.lint.wire.topics import analyze_topics, role_topic_matrix

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "banyandb_tpu_torch"


def _pkg(tmp_path: Path, files: dict[str, str], name: str = "mypkg") -> Path:
    root = tmp_path / name
    root.mkdir(parents=True, exist_ok=True)
    (root / "__init__.py").write_text("")
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        if p.name != "__init__.py" and not (p.parent / "__init__.py").exists():
            (p.parent / "__init__.py").write_text("")
        p.write_text(src)
    return root


def _key(findings):
    return sorted((f.rule, str(f.path), f.line, f.col, f.message) for f in findings)


class _Both:
    """One seeded tree, parsed and call-graphed by both packages."""

    def __init__(self, root: Path, name: str = "mypkg"):
        from banyandb_tpu.lint.whole_program.callgraph import Program as RP
        from banyandb_tpu.lint.whole_program.layers import parse_package as rpp
        from banyandb_tpu_torch.lint.whole_program.layers import parse_package

        self.root = root
        self.trees = parse_package(root, name)
        self.program = Program.build(root, name, trees=self.trees)
        self.ref_trees = rpp(root, name)
        self.ref_program = RP.build(root, name, trees=self.ref_trees)

    def run(self, analyzer, *, program=True, trees=False, **kw):
        """Run the port's `analyzer` and the reference's function of the
        same name in both packages; assert equal findings; -> the
        port's."""
        import importlib

        ref_mod = importlib.import_module(
            analyzer.__module__.replace("banyandb_tpu_torch.", "banyandb_tpu.", 1)
        )
        out = []
        for fn, prog, tr in (
            (analyzer, self.program, self.trees),
            (getattr(ref_mod, analyzer.__name__), self.ref_program, self.ref_trees),
        ):
            args = ([prog] if program else []) + ([tr] if trees else [])
            out.append(fn(*args, **kw))
        assert _key(out[0]) == _key(out[1])
        return out[0]


def _build(tmp_path, files):
    root = _pkg(tmp_path, files)
    b = _Both(root)
    return b.program, b.trees, b


# -- wire-topic --------------------------------------------------------------

_TOPIC_PKG = {
    "bus.py": (
        "TOPIC_PING = 'ping'\n"
        "TOPIC_PONG = 'pong'\n"
    ),
    "server.py": (
        "from mypkg.bus import TOPIC_PING\n"
        "class Server:\n"
        "    def _register(self):\n"
        "        self.bus.subscribe(TOPIC_PING, self._on_ping)\n"
        "    def _on_ping(self, env):\n"
        "        return {}\n"
    ),
    "client.py": (
        "from mypkg.bus import TOPIC_PING, TOPIC_PONG\n"
        "class Client:\n"
        "    def go(self):\n"
        "        self.transport.call('addr', TOPIC_PONG, {})\n"
    ),
}

_TOPIC_CFG = dict(
    roles={"server": ("mypkg.server:Server._register",)},
    client_targets={"mypkg.client": ("server",)},
    exemptions={},
)


def test_topic_client_gap_flagged(tmp_path):
    _, _, b = _build(tmp_path, _TOPIC_PKG)
    fs = b.run(analyze_topics, trees=True,
        expected_matrix={"server": ("ping",)}, **_TOPIC_CFG,
    )
    assert any("pong" in f.message and f.rule == "wire-topic" for f in fs), fs


def test_topic_matrix_drift_flagged_both_ways(tmp_path):
    _, _, b = _build(tmp_path, _TOPIC_PKG)
    # golden matrix missing a served topic
    fs = b.run(analyze_topics, trees=True, expected_matrix={"server": ()},
        **_TOPIC_CFG,
    )
    assert any("ping" in f.message for f in fs), fs
    # golden matrix citing a topic nobody serves
    fs = b.run(analyze_topics, trees=True,
        expected_matrix={"server": ("ping", "gone")}, **_TOPIC_CFG,
    )
    assert any("gone" in f.message for f in fs), fs


def test_topic_exemption_covers_gap_and_stale_entry_fails(tmp_path):
    _, _, b = _build(tmp_path, _TOPIC_PKG)
    cfg = dict(_TOPIC_CFG, exemptions={("server", "pong"): "by design"})
    fs = b.run(analyze_topics, trees=True,
        expected_matrix={"server": ("ping",)}, **cfg,
    )
    assert not any("pong" in f.message and "no handler" in f.message
                   for f in fs), fs
    # once the handler exists, the entry must be deleted
    served = dict(_TOPIC_PKG)
    served["server.py"] = (
        "from mypkg.bus import TOPIC_PING, TOPIC_PONG\n"
        "class Server:\n"
        "    def _register(self):\n"
        "        self.bus.subscribe(TOPIC_PING, self._on_ping)\n"
        "        self.bus.subscribe(TOPIC_PONG, self._on_ping)\n"
        "    def _on_ping(self, env):\n"
        "        return {}\n"
    )
    _, _, b = _build(tmp_path / "b", served)
    fs = b.run(analyze_topics, trees=True,
        expected_matrix={"server": ("ping", "pong")}, **cfg,
    )
    assert any("stale" in f.message.lower() for f in fs), fs


# -- wire-kind ---------------------------------------------------------------

_KIND_CFG = dict(
    declared=("deadline", "error", "shed"),
    retryable=frozenset({"deadline", "shed"}),
    error_classes=("TransportError",),
)


def test_kind_vocabulary_typo_flagged(tmp_path):
    _, _, b = _build(tmp_path, {
        "rpc.py": (
            "class TransportError(Exception):\n"
            "    def __init__(self, msg, kind='error'):\n"
            "        self.kind = kind\n"
            "def reject():\n"
            "    raise TransportError('busy', kind='sched')\n"
        ),
    })
    fs = b.run(analyze_kinds, transport_kinds={}, classifier_switches={},
        **_KIND_CFG,
    )
    assert any("'sched'" in f.message for f in fs), fs


def test_kind_classifier_missing_branch_flagged(tmp_path):
    _, _, b = _build(tmp_path, {
        "rpc.py": (
            "def handle(e):\n"
            "    kind = getattr(e, 'kind', 'error')\n"
            "    if kind == 'shed':\n"
            "        return 'spool'\n"
            "    return 'dead'\n"
        ),
    })
    fs = b.run(analyze_kinds,
        transport_kinds={},
        classifier_switches={
            "mypkg.rpc:handle": frozenset({"deadline", "shed"}),
        },
        **_KIND_CFG,
    )
    assert any(
        "handle" in f.message and "'deadline'" in f.message for f in fs
    ), fs


def test_kind_transport_drift_flagged(tmp_path):
    _, _, b = _build(tmp_path, {
        "rpc.py": (
            "class TransportError(Exception):\n"
            "    def __init__(self, msg, kind='error'):\n"
            "        self.kind = kind\n"
            "def reject():\n"
            "    raise TransportError('busy', kind='shed')\n"
        ),
    })
    fs = b.run(analyze_kinds,
        transport_kinds={"mypkg.rpc": frozenset({"shed", "deadline"})},
        classifier_switches={},
        **_KIND_CFG,
    )
    assert any("'deadline'" in f.message for f in fs), fs


def test_kind_non_wire_kind_attributes_ignored(tmp_path):
    # plan-node/fault-style `.kind` compares must not enter the taxonomy
    _, _, b = _build(tmp_path, {
        "plan.py": (
            "def walk(node):\n"
            "    if node.kind == 'IndexModeScan':\n"
            "        return 1\n"
            "    return 0\n"
        ),
    })
    fs = b.run(analyze_kinds, transport_kinds={}, classifier_switches={},
        **_KIND_CFG,
    )
    assert fs == [], fs


# -- wire-envelope -----------------------------------------------------------

def _env_groups(**over):
    g = {
        "producers": ("mypkg.liaison:Liaison.send",),
        "consumers": ("mypkg.node:Node.on_write",),
        "accepted_write_only": {},
        "accepted_silent_default": {},
    }
    g.update(over)
    return {"write": g}


def test_envelope_write_only_field_flagged(tmp_path):
    _, _, b = _build(tmp_path, {
        "liaison.py": (
            "class Liaison:\n"
            "    def send(self):\n"
            "        return {'rows': 1, 'epoch': 2}\n"
        ),
        "node.py": (
            "class Node:\n"
            "    def on_write(self, env):\n"
            "        return env['rows']\n"
        ),
    })
    fs = b.run(analyze_envelopes, groups=_env_groups())
    assert any(
        "`epoch`" in f.message and "never read" in f.message for f in fs
    ), fs


def test_envelope_silent_default_flagged_and_accepted(tmp_path):
    files = {
        "liaison.py": (
            "class Liaison:\n"
            "    def send(self):\n"
            "        return {'rows': 1}\n"
        ),
        "node.py": (
            "class Node:\n"
            "    def on_write(self, env):\n"
            "        return env.get('rows', 0)\n"
        ),
    }
    _, _, b = _build(tmp_path, files)
    fs = b.run(analyze_envelopes, groups=_env_groups())
    assert any("silent default" in f.message for f in fs), fs
    fs = b.run(analyze_envelopes,
        groups=_env_groups(accepted_silent_default={"rows": "legacy"}),
    )
    assert fs == [], fs


def test_envelope_helper_hop_and_or_guard_count_as_reads(tmp_path):
    # env.get through a helper AND through the `(env or {})` idiom both
    # count as consumption — no false write-only finding
    _, _, b = _build(tmp_path, {
        "liaison.py": (
            "class Liaison:\n"
            "    def send(self):\n"
            "        return {'epoch': 2, 'flag': True}\n"
        ),
        "node.py": (
            "class Node:\n"
            "    def on_write(self, env):\n"
            "        self._fence(env)\n"
            "        return (env or {}).get('flag')\n"
            "    def _fence(self, env):\n"
            "        return env['epoch']\n"
        ),
    })
    fs = b.run(analyze_envelopes, groups=_env_groups())
    assert fs == [], fs


# -- wire-fault --------------------------------------------------------------

def test_fault_unhooked_transport_flagged(tmp_path):
    _, _, b = _build(tmp_path, {
        "rpc.py": (
            "class GrpcTransport:\n"
            "    def call(self, addr, topic, env):\n"
            "        return {}\n"
        ),
    })
    fs = b.run(analyze_fault_sites, transport_exempt={},
        disk_prefixes=("mypkg.",), disk_exempt={}, sync_modules=(),
    )
    assert any("maybe_fail_rpc" in f.message for f in fs), fs


def test_fault_uncovered_disk_write_flagged_and_caller_hook_covers(tmp_path):
    _, _, b = _build(tmp_path, {
        "spool.py": (
            "from mypkg import faults\n"
            "def bare(path, data):\n"
            "    path.write_text(data)\n"
            "def covered(path, data):\n"
            "    faults.check_disk('spool')\n"
            "    writer(path, data)\n"
            "def writer(path, data):\n"
            "    path.write_bytes(data)\n"
        ),
        "faults.py": "def check_disk(where):\n    return None\n",
    })
    fs = b.run(analyze_fault_sites, transport_exempt={},
        disk_prefixes=("mypkg.",), disk_exempt={}, sync_modules=(),
    )
    msgs = [f.message for f in fs]
    assert any("bare" in m for m in msgs), msgs
    assert not any("writer" in m for m in msgs), msgs


def test_fault_stale_disk_exempt_flagged(tmp_path):
    _, _, b = _build(tmp_path, {
        "spool.py": "def nothing():\n    return 1\n",
    })
    fs = b.run(analyze_fault_sites, transport_exempt={},
        disk_prefixes=("mypkg.",),
        disk_exempt={("mypkg.spool", "gone"): "was a pid file"},
        sync_modules=(),
    )
    assert any("stale DISK_EXEMPT" in f.message for f in fs), fs


# -- wire-retry --------------------------------------------------------------

_RETRY_SRC = {
    "rpc.py": (
        "class TransportError(Exception):\n"
        "    pass\n"
    ),
    "client.py": (
        "from mypkg.rpc import TransportError\n"
        "class C:\n"
        "    def swallow(self):\n"
        "        try:\n"
        "            self.t.call('a', 'b', {})\n"
        "        except TransportError:\n"
        "            pass\n"
        "    def recovers(self):\n"
        "        try:\n"
        "            self.t.call('a', 'b', {})\n"
        "        except TransportError:\n"
        "            self.spool_it()\n"
        "    def spool_it(self):\n"
        "        return 1\n"
    ),
}


def test_retry_bare_swallow_flagged_spool_path_clean(tmp_path):
    _, _, b = _build(tmp_path, _RETRY_SRC)
    fs = b.run(analyze_retryable, error_classes=("TransportError",),
        substrings=("spool",), exempt={},
    )
    msgs = [f.message for f in fs]
    assert any("swallow" in m for m in msgs), msgs
    assert not any("recovers" in m for m in msgs), msgs


def test_retry_exempt_and_stale_entry(tmp_path):
    _, _, b = _build(tmp_path, _RETRY_SRC)
    fs = b.run(analyze_retryable, error_classes=("TransportError",),
        substrings=("spool",),
        exempt={
            "mypkg.client:C.swallow": "terminal reporter",
            "mypkg.client:C.gone": "stale",
        },
    )
    msgs = [f.message for f in fs]
    assert not any("swallow" in m and "recovery" in m for m in msgs), msgs
    assert any("stale RETRY_EXEMPT" in m for m in msgs), msgs


# -- wire-envflag ------------------------------------------------------------

def test_envflag_raw_read_and_unregistered_flag(tmp_path):
    root = _pkg(tmp_path, {
        "envflag.py": (
            "import os\n"
            "def env_flag(name, default=False):\n"
            "    return os.environ.get(name) is not None\n"
            "FLAGS = {'BYDB_GOOD': 'a flag', 'BYDB_GONE': 'stale'}\n"
        ),
        "a.py": (
            "import os\n"
            "from mypkg.envflag import env_flag\n"
            "RAW = os.environ.get('BYDB_RAW')\n"
            "SUB = os.environ['BYDB_SUB']\n"
            "GOOD = env_flag('BYDB_GOOD')\n"
            "ROGUE = env_flag('BYDB_ROGUE')\n"
        ),
    })
    b = _Both(root)
    fs = b.run(analyze_envflags, program=False, trees=True, repo_root=None,
        envflag_module="mypkg.envflag", envflag_funcs=("env_flag",),
        prefix="BYDB_", flags_doc="flags.md",
    )
    msgs = [f.message for f in fs]
    assert any("BYDB_RAW" in m and "raw" in m for m in msgs), msgs
    assert any("BYDB_SUB" in m and "raw" in m for m in msgs), msgs
    assert any("BYDB_ROGUE" in m and "missing from" in m for m in msgs), msgs
    assert any("stale FLAGS entry BYDB_GONE" in m for m in msgs), msgs
    assert not any("BYDB_GOOD" in m for m in msgs), msgs


def test_envflag_docs_cross_reference(tmp_path):
    root = _pkg(tmp_path, {
        "envflag.py": (
            "import os\n"
            "def env_flag(name, default=False):\n"
            "    return os.environ.get(name) is not None\n"
            "FLAGS = {'BYDB_GOOD': 'a flag'}\n"
        ),
        "a.py": "from mypkg.envflag import env_flag\n"
                "G = env_flag('BYDB_GOOD')\n",
    })
    (tmp_path / "flags.md").write_text("# flags\n\nBYDB_PHANTOM only.\n")
    b = _Both(root)
    fs = b.run(analyze_envflags, program=False, trees=True, repo_root=tmp_path,
        envflag_module="mypkg.envflag", envflag_funcs=("env_flag",),
        prefix="BYDB_", flags_doc="flags.md",
    )
    msgs = [f.message for f in fs]
    assert any("BYDB_GOOD" in m and "undocumented" in m for m in msgs), msgs
    assert any("BYDB_PHANTOM" in m for m in msgs), msgs


def test_fleet_cache_dir_reads_through_envflag(tmp_path, monkeypatch):
    """The build-cache directory the shard workers share is read through
    utils/envflag (wire-envflag found the raw os.environ read): unset
    gives the pool's own directory, an off-value builds no fleet cache,
    a path is used as given."""
    from banyandb_tpu_torch.cluster.workers import fleet_cache_dir
    from banyandb_tpu_torch.utils.compile_cache import _DISABLE_VALUES

    monkeypatch.delenv("BYDB_COMPILE_CACHE_DIR", raising=False)
    assert fleet_cache_dir(tmp_path) == str(tmp_path / "compile-cache")
    monkeypatch.setenv("BYDB_COMPILE_CACHE_DIR", "")
    assert fleet_cache_dir(tmp_path) == str(tmp_path / "compile-cache")
    monkeypatch.setenv("BYDB_COMPILE_CACHE_DIR", "off")
    got = fleet_cache_dir(tmp_path)
    # the parent then provides no cache: the off-value reaches the check
    assert got.strip().lower() in _DISABLE_VALUES
    monkeypatch.setenv("BYDB_COMPILE_CACHE_DIR", str(tmp_path / "cc"))
    assert fleet_cache_dir(tmp_path) == str(tmp_path / "cc")


# -- wire-obs ----------------------------------------------------------------

def test_obs_undeclared_and_label_drift(tmp_path):
    root = _pkg(tmp_path, {
        "m.py": (
            "def f(meter):\n"
            "    meter.counter_add('rogue_total_thing', 1, {'a': 1})\n"
            "    meter.counter_add('known', 1, {'node': 'x'})\n"
            "    meter.observe('rpc_client_ms', 1.0, {'topic': 't'})\n"
        ),
    })
    contract = {
        "known": frozenset({"peer"}),
        "rpc_*": frozenset({"topic"}),
        "ghost": frozenset(),
    }
    fs = _Both(root).run(analyze_obs, program=False, trees=True, repo_root=None,
        contract=contract, obs_doc="obs.md",
    )
    msgs = [f.message for f in fs]
    assert any("rogue_total_thing" in m for m in msgs), msgs
    assert any(
        "`known`" in m and "['node']" in m and "['peer']" in m for m in msgs
    ), msgs
    assert any("stale OBS_CONTRACT entry `ghost`" in m for m in msgs), msgs
    assert not any("rpc_client_ms" in m for m in msgs), msgs


def test_obs_doc_cross_reference(tmp_path):
    root = _pkg(tmp_path, {
        "m.py": (
            "def f(meter):\n"
            "    meter.gauge_set('alive', 1)\n"
        ),
    })
    (tmp_path / "obs.md").write_text(
        "# obs\n\n`banyandb_phantom_total` is documented but fictional.\n"
    )
    fs = _Both(root).run(analyze_obs, program=False, trees=True, repo_root=tmp_path,
        contract={"alive": frozenset()}, obs_doc="obs.md",
    )
    msgs = [f.message for f in fs]
    assert any("`alive`" in m and "not mentioned" in m for m in msgs), msgs
    assert any("banyandb_phantom_total" in m for m in msgs), msgs


# -- the audited tree --------------------------------------------------------

def test_real_tree_wire_clean():
    """The port's package carries ZERO wire findings — every gap is
    either fixed or carries a reviewed reason in its wire_config.py —
    and the documents the port's policy reads are the port's own."""
    from banyandb_tpu_torch.lint.whole_program import run_whole_program
    from banyandb_tpu_torch.lint.wire import wire_config

    findings, stats = run_whole_program(PORT, plan_audit=False, only={"wire"})
    assert findings == [], "\n".join(f.render() for f in findings)
    # the audit is not vacuous: the fabric serves a real topic surface
    # and the taxonomy has live sites
    assert stats["wire_topics"] >= 20
    assert stats["wire_kind_sites"] >= 10
    for doc in (wire_config.FLAGS_DOC, wire_config.OBS_DOC):
        assert doc.startswith("banyandb_tpu_torch/docs/")
        assert (REPO / doc).is_file()
    # the port's instruments are contracted; the reference's stale one
    # is not
    c = wire_config.OBS_CONTRACT
    assert {"kernel_launches", "kernel_launch_budget", "wqueue_shipped_bytes"} <= set(c)
    assert "kernel_dispatch_budget" not in c


def test_wire_policy_parity_with_reference():
    """The port's policy is the reference's, re-keyed, except the
    instruments and documents it owns."""
    from banyandb_tpu.lint.wire import wire_config as ref
    from banyandb_tpu_torch.lint.wire import wire_config as port

    def rekey(x):
        if isinstance(x, str):
            return x.replace("banyandb_tpu.", "banyandb_tpu_torch.")
        if isinstance(x, dict):
            return {rekey(k): rekey(v) for k, v in x.items()}
        if isinstance(x, (tuple, frozenset)):
            return type(x)(rekey(v) for v in x)
        return x

    for name in (
        "ROLES", "EXPECTED_MATRIX", "CLIENT_TARGETS", "TOPIC_EXEMPTIONS",
        "DECLARED_KINDS", "RETRYABLE_KINDS", "ERROR_CLASSES",
        "TRANSPORT_KINDS", "CLASSIFIER_SWITCHES", "ENVELOPE_GROUPS",
        "FAULT_TRANSPORT_EXEMPT", "DISK_SCAN_PREFIXES", "DISK_EXEMPT",
        "SYNC_MODULES", "RETRY_SUBSTRINGS", "RETRY_EXEMPT", "ENVFLAG_FUNCS",
        "ENV_PREFIX",
    ):
        assert getattr(port, name) == rekey(getattr(ref, name)), name
    extra = set(port.OBS_CONTRACT) - set(ref.OBS_CONTRACT)
    gone = set(ref.OBS_CONTRACT) - set(port.OBS_CONTRACT)
    assert extra == {"kernel_launches", "kernel_launch_budget", "wqueue_shipped_bytes"}
    assert gone == {"kernel_dispatch_budget"}


# -- behavioral pins for the bugs the audit surfaced ------------------------
#
# The reference's pins, re-run against the port's fabric (data nodes on
# the CPU): each one held a contract the bdwire analyzers flagged.

def _mini_cluster(tmp_path, *, group="sw", n_nodes=2, replicas=0):
    from banyandb_tpu_torch.api import (
        Catalog, Entity, FieldSpec, FieldType, Group, Measure,
        ResourceOpts, SchemaRegistry, TagSpec, TagType,
    )
    from banyandb_tpu_torch.cluster import DataNode, Liaison, NodeInfo
    from banyandb_tpu_torch.cluster.rpc import LocalTransport

    def _schema(reg):
        reg.create_group(Group(
            group, Catalog.MEASURE,
            ResourceOpts(shard_num=4, replicas=replicas),
        ))
        reg.create_measure(Measure(
            group=group, name="cpm",
            tags=(TagSpec("svc", TagType.STRING),),
            fields=(FieldSpec("v", FieldType.FLOAT),),
            entity=Entity(("svc",)),
        ))

    transport = LocalTransport()
    nodes, datanodes = [], []
    for i in range(n_nodes):
        reg = SchemaRegistry(tmp_path / f"node{i}")
        _schema(reg)
        dn = DataNode(
            f"data-{i}", reg, tmp_path / f"node{i}" / "data", device="cpu"
        )
        addr = transport.register(dn.name, dn.bus)
        nodes.append(NodeInfo(dn.name, addr))
        datanodes.append(dn)
    liaison_reg = SchemaRegistry(tmp_path / "liaison")
    _schema(liaison_reg)
    liaison = Liaison(liaison_reg, transport, nodes, replicas=replicas)
    return transport, liaison, datanodes


def _points(group, n=64):
    from banyandb_tpu_torch.api import DataPointValue, WriteRequest

    t0 = 1_700_000_000_000
    return WriteRequest(group, "cpm", tuple(
        DataPointValue(
            t0 + i, {"svc": f"svc-{i % 4}"}, {"v": float(i)}, version=1,
        )
        for i in range(n)
    ))


def test_streamagg_unregister_routed_on_liaison_role():
    """wire-topic flagged the liaison role's streamagg surface as
    stats/register-only; the autoreg eviction path must reach it too."""
    from banyandb_tpu_torch.cluster_server import LiaisonServer

    class _FakeLiaison:
        def __init__(self):
            self.calls = []

        def unregister_streamagg(self, group, measure, **kw):
            self.calls.append((group, measure, kw))
            return {"data-0": {"ok": True}}

    srv = LiaisonServer.__new__(LiaisonServer)
    srv.liaison = _FakeLiaison()
    out = LiaisonServer._streamagg(srv, {
        "op": "unregister", "group": "g", "measure": "m",
        "key_tags": ["svc"], "fields": ["v"],
    })
    assert out == {"acks": {"data-0": {"ok": True}}}
    assert srv.liaison.calls == [
        ("g", "m", {"key_tags": ("svc",), "fields": ("v",),
                    "window_millis": None}),
    ]


def test_write_deadline_rejection_keeps_replica_alive(tmp_path):
    """wire-kind flagged _deliver_writes handling "shed" but not
    "deadline": a node refusing an expired budget is healthy and must
    not be evicted — the retryable rejection propagates instead."""
    from banyandb_tpu_torch.cluster.rpc import TransportError

    transport, liaison, datanodes = _mini_cluster(tmp_path, n_nodes=1)

    def _refuse(addr, topic, env, timeout=None):
        raise TransportError("budget spent", kind="deadline")

    liaison.transport = type(transport)()
    liaison.transport.call = _refuse
    with pytest.raises(TransportError) as ei:
        liaison.write_measure(_points("sw"))
    assert ei.value.kind == "deadline"
    assert datanodes[0].name in liaison.alive


def test_query_handlers_fence_stale_epoch(tmp_path):
    """wire-envelope flagged placement_epoch as write-plane-only: the
    four query handlers must fence a scatter routed on a superseded
    map with a retryable rejection."""
    from banyandb_tpu_torch.cluster.placement import StaleEpoch

    _, _, datanodes = _mini_cluster(tmp_path, n_nodes=1)
    dn = datanodes[0]
    dn.epoch_record.observe(5, source="test")
    for handler in (
        dn._on_stream_query,
        dn._on_trace_query_ordered,
        dn._on_measure_query_partial,
        dn._on_measure_query_raw,
    ):
        with pytest.raises(StaleEpoch):
            handler({"placement_epoch": 3})


def test_query_fence_adopts_fresher_epoch(tmp_path):
    """The fence's other half: a FRESHER epoch on a query envelope is
    adopted, so epoch knowledge gossips with read traffic too."""
    from banyandb_tpu_torch.api import QueryRequest, TimeRange
    from banyandb_tpu_torch.cluster import serde

    _, liaison, datanodes = _mini_cluster(tmp_path, n_nodes=1)
    liaison.write_measure(_points("sw"))
    dn = datanodes[0]
    assert dn.epoch_record.epoch < 7
    t0 = 1_700_000_000_000
    req = QueryRequest(("sw",), "cpm", TimeRange(t0, t0 + 10_000))
    out = dn._on_measure_query_raw({
        "request": serde.query_request_to_json(req),
        "placement_epoch": 7,
    })
    assert out["data_points"]
    assert dn.epoch_record.epoch == 7


def test_stale_liaison_query_replaces_leg_without_evicting(tmp_path):
    """End-to-end: a liaison routing on a superseded map gets its query
    leg fenced; the leg re-places onto a replica and the query still
    answers — the fencing node is healthy and stays alive."""
    from banyandb_tpu_torch.api import Aggregation, QueryRequest, TimeRange
    from banyandb_tpu_torch.obs.metrics import global_meter

    _, liaison, datanodes = _mini_cluster(tmp_path, n_nodes=2, replicas=1)
    req = _points("sw", n=64)
    liaison.write_measure(req)
    datanodes[0].epoch_record.observe(liaison.placement.epoch + 5,
                                      source="test")
    key = ("stale_epoch_rejected",
           (("site", "measure-query-partial"),))
    before = global_meter().snapshot()["counters"].get(key, 0.0)
    t0 = 1_700_000_000_000
    res = liaison.query_measure(QueryRequest(
        ("sw",), "cpm", TimeRange(t0, t0 + 10_000),
        agg=Aggregation("count", "v"),
    ))
    assert res.values["count"][0] == 64
    after = global_meter().snapshot()["counters"].get(key, 0.0)
    assert after > before  # the fence actually fired on the query plane
    assert datanodes[0].name in liaison.alive


def test_measure_write_runs_under_stamped_tenant(tmp_path):
    """wire-envelope/obs flagged the write handlers running the engine
    OUTSIDE the tenant scope: cache invalidations and QoS accounting
    must land in the partition the tenant's queries read from."""
    from banyandb_tpu_torch.qos import tenancy

    _, liaison, datanodes = _mini_cluster(tmp_path, group="t1.sw",
                                          n_nodes=1)
    dn = datanodes[0]
    seen = []
    inner = dn.measure.write

    def _spy(req):
        seen.append(tenancy.current_tenant())
        return inner(req)

    dn.measure.write = _spy
    liaison.write_measure(_points("t1.sw", n=8))
    assert seen and all(t == "t1" for t in seen)


def test_worker_watermark_enospc_keeps_old_watermark(tmp_path):
    """wire-fault flagged _write_wm as an unhooked disk write: injected
    ENOSPC must raise BEFORE the tmp write so the rename never runs and
    the old watermark stays authoritative."""
    from banyandb_tpu_torch.cluster import faults
    from banyandb_tpu_torch.cluster.workers import _write_wm

    wm = tmp_path / "wm"
    _write_wm(wm, 5)
    assert wm.read_text() == "5"
    faults.configure("disk=enospc:every=1:match=worker-watermark")
    try:
        with pytest.raises(OSError):
            _write_wm(wm, 9)
    finally:
        faults.clear()
    assert wm.read_text() == "5"
    assert not wm.with_suffix(".tmp").exists()


def test_handoff_replay_rewrite_enospc_preserves_spool(tmp_path):
    """wire-fault flagged the replay-rewrite path: an ENOSPC on the
    spool rewrite must leave the file intact, so delivered entries
    replay again (idempotent repair) instead of vanishing."""
    from banyandb_tpu_torch.cluster import faults
    from banyandb_tpu_torch.cluster.handoff import HandoffController

    h = HandoffController(tmp_path / "spool")
    h.spool("n1", "measure-write", {"seq": 1})
    h.spool("n1", "measure-write", {"seq": 2})

    def _first_only(topic, env):
        if env["seq"] == 2:
            raise RuntimeError("still down")

    faults.configure("disk=enospc:every=1:count=1:match=handoff-spool")
    try:
        with pytest.raises(OSError):
            h.replay("n1", _first_only)
    finally:
        faults.clear()
    assert h.pending("n1") == 2  # nothing lost; over-delivery is safe
    got = []
    assert h.replay("n1", lambda t, e: got.append(e["seq"])) == 2
    assert got == [1, 2]
    assert h.pending("n1") == 0


def test_real_tree_matrix_matches_golden():
    """role_topic_matrix == EXPECTED_MATRIX exactly, and equals the
    reference's matrix: the port serves the same topics per role."""
    from banyandb_tpu.lint.wire import wire_config as ref_config
    from banyandb_tpu_torch.lint.whole_program.layers import parse_package
    from banyandb_tpu_torch.lint.wire import wire_config

    trees = parse_package(PORT, "banyandb_tpu_torch")
    program = Program.build(PORT, "banyandb_tpu_torch", trees=trees)
    live = {
        role: tuple(sorted(served))
        for role, served in role_topic_matrix(program, trees).items()
    }
    assert live == {
        r: tuple(sorted(t)) for r, t in wire_config.EXPECTED_MATRIX.items()
    }
    assert wire_config.EXPECTED_MATRIX == ref_config.EXPECTED_MATRIX
