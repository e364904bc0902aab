"""Whole-program analyses of the port: the seeded-violation proofs of
tests/test_whole_program.py (upward import, transitive host sync in a
device region, lock-order cycle, dtype-promoting plan), the layer-map
golden test, the audited-tree meta-tests, and parity with the
reference.

The copied analyzers (layers, lockorder, shared_state, the lock-blocking
half of the call graph) run beside the reference's on the same seeded
trees and must report the same findings.  The sync facts are the port's
own (device regions and ``device_get``/``synchronize`` instead of jit
regions and ``jax.device_get``), so their fixtures are written in
PyTorch; the rule is ``wp-sync-in-kernel`` (the reference's
``wp-sync-in-jit``).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from banyandb_tpu_torch.lint.whole_program import apply_suppressions, layer_config
from banyandb_tpu_torch.lint.whole_program.callgraph import (
    Program,
    analyze_lock_blocking,
    analyze_sync_in_kernel,
)
from banyandb_tpu_torch.lint.whole_program.layers import (
    LayerConfig,
    analyze_layers,
    iter_py_modules,
)
from banyandb_tpu_torch.lint.whole_program.lockorder import analyze_lock_order
from banyandb_tpu_torch.lint.whole_program.plan_audit import KernelAudit, audit_kernel
from banyandb_tpu_torch.lint.whole_program.shared_state import (
    analyze_shared_state,
    collect_accesses,
    discover_roots,
)
from banyandb_tpu_torch.query.precompile import TensorSpec

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


def _ref_layer_config(cfg: LayerConfig):
    from banyandb_tpu.lint.whole_program.layers import LayerConfig as RefConfig

    return RefConfig(
        layers=cfg.layers, may_import=cfg.may_import, layer_of=cfg.layer_of
    )


def _layers_both(root, name, cfg, baseline=frozenset()):
    """The port's layering findings, asserted equal to the reference's
    on the same tree."""
    from banyandb_tpu.lint.whole_program.layers import analyze_layers as ref

    fs = analyze_layers(root, name, cfg, baseline=baseline)
    assert _key(fs) == _key(
        ref(root, name, _ref_layer_config(cfg), baseline=baseline)
    )
    return fs


def _program_both(root, name="mypkg"):
    from banyandb_tpu.lint.whole_program.callgraph import Program as RefProgram

    return Program.build(root, name), RefProgram.build(root, name)


_TWO_LAYERS = LayerConfig(
    layers=("low", "high"),
    may_import={"low": (), "high": ("low",)},
    layer_of={"": "low", "lo": "low", "hi": "high"},
)


# -- layering ----------------------------------------------------------------


def test_layering_upward_import_flagged(tmp_path):
    root = _pkg(
        tmp_path,
        {
            "lo/a.py": "from mypkg.hi.b import f\n",
            "hi/b.py": "def f():\n    return 1\n",
        },
    )
    fs = _layers_both(root, "mypkg", _TWO_LAYERS)
    assert len(fs) == 1 and fs[0].rule == "layering"
    assert "upward import" in fs[0].message
    assert fs[0].path.endswith("lo/a.py") and fs[0].line == 1


def test_layering_downward_import_clean(tmp_path):
    root = _pkg(
        tmp_path,
        {
            "hi/b.py": "from mypkg.lo.a import g\n",
            "lo/a.py": "def g():\n    return 1\n",
        },
    )
    assert _layers_both(root, "mypkg", _TWO_LAYERS) == []


def test_layering_skip_layer_flagged(tmp_path):
    cfg = LayerConfig(
        layers=("l0", "l1", "l2"),
        # l2 may only reach l1 — touching l0 directly is a skip
        may_import={"l0": (), "l1": ("l0",), "l2": ("l1",)},
        layer_of={"": "l0", "base": "l0", "mid": "l1", "top": "l2"},
    )
    root = _pkg(
        tmp_path,
        {
            "base/a.py": "X = 1\n",
            "top/c.py": "from mypkg.base import a\n",
        },
    )
    fs = _layers_both(root, "mypkg", cfg)
    assert len(fs) == 1 and "skip-layer" in fs[0].message


def test_layering_lazy_and_type_checking_imports_exempt(tmp_path):
    root = _pkg(
        tmp_path,
        {
            "lo/a.py": (
                "from typing import TYPE_CHECKING\n"
                "if TYPE_CHECKING:\n"
                "    from mypkg.hi.b import f\n"
                "def g():\n"
                "    from mypkg.hi.b import f\n"
                "    return f()\n"
            ),
            "hi/b.py": "def f():\n    return 1\n",
        },
    )
    assert _layers_both(root, "mypkg", _TWO_LAYERS) == []


def test_layering_unknown_module_is_failure(tmp_path):
    root = _pkg(tmp_path, {"elsewhere/x.py": "X = 1\n"})
    fs = _layers_both(root, "mypkg", _TWO_LAYERS)
    assert [f for f in fs if "maps to no layer" in f.message]


def test_layering_ratchet_baseline(tmp_path):
    files = {
        "lo/a.py": "from mypkg.hi.b import f\n",
        "hi/b.py": "def f():\n    return 1\n",
    }
    root = _pkg(tmp_path, files)
    edge = frozenset({"mypkg.lo.a -> mypkg.hi.b"})
    # baselined live violation: tolerated
    assert _layers_both(root, "mypkg", _TWO_LAYERS, baseline=edge) == []
    # fixed violation with a lingering entry: stale-baseline failure
    (root / "lo" / "a.py").write_text("A = 1\n")
    fs = _layers_both(root, "mypkg", _TWO_LAYERS, baseline=edge)
    assert len(fs) == 1 and "stale baseline" in fs[0].message


def test_real_layer_map_is_total_and_unambiguous():
    """The golden test: every module of the port maps to exactly one
    layer, the port's own modules included."""
    cfg = layer_config.CONFIG
    seen = set()
    for mod, _path in iter_py_modules(PORT, "banyandb_tpu_torch"):
        rel = (
            mod[len("banyandb_tpu_torch") + 1 :]
            if mod != "banyandb_tpu_torch"
            else ""
        )
        layer = cfg.module_layer(rel)
        assert layer is not None, f"{mod} maps to no layer; extend layer_config"
        assert layer in cfg.layers, f"{mod} -> {layer} is not a known layer"
        seen.add(rel)
    L = layer_config
    assert cfg.module_layer("backend") == L.L0
    assert cfg.module_layer("ops.hopper_kernels") == L.L3
    assert cfg.module_layer("ops.blocks") == L.L1
    assert cfg.module_layer("lint.kernel.op_audit") == L.L6
    assert cfg.module_layer("api.pb.banyandb_pb2") == L.L1
    for top in ("cluster_server", "server", "run", "cli", "mcp_server"):
        assert cfg.module_layer(top) == L.L6
    assert {"backend", "ops.hopper_kernels", "lint.kernel.op_audit"} <= seen


def test_real_tree_layering_clean():
    fs = analyze_layers(
        PORT, "banyandb_tpu_torch", layer_config.CONFIG, layer_config.BASELINE
    )
    assert fs == [], "\n".join(f.render() for f in fs)


def test_baseline_entries_all_still_live():
    """The ratchet's other half, stated positively: every baselined edge
    still exists (stale entries would have failed the clean-tree test),
    and they are the reference's edges, re-keyed."""
    from banyandb_tpu.lint.whole_program import layer_config as ref_config
    from banyandb_tpu_torch.lint.whole_program.layers import scan_import_edges

    edges, _ = scan_import_edges(PORT, "banyandb_tpu_torch")
    live = {f"{e.src} -> {e.dst}" for e in edges}
    assert layer_config.BASELINE <= live
    assert layer_config.BASELINE == {
        e.replace("banyandb_tpu.", "banyandb_tpu_torch.")
        for e in ref_config.BASELINE
    }


# -- call-graph facts --------------------------------------------------------


def test_transitive_host_sync_in_kernel_flagged(tmp_path):
    root = _pkg(
        tmp_path,
        {
            "a.py": (
                "import torch\n"
                "from mypkg.b import helper\n"
                "\n"
                "def kernel(x):\n"
                "    return helper(x)\n"
            ),
            "b.py": (
                "import torch\n"
                "from mypkg.c import deep\n"
                "def helper(x):\n"
                "    return deep(x)\n"
            ),
            "c.py": (
                "import torch\n"
                "def deep(x):\n"
                "    torch.cuda.synchronize()\n"
                "    return x\n"
            ),
        },
    )
    program = Program.build(root, "mypkg")
    fs = analyze_sync_in_kernel(program)
    assert len(fs) == 1 and fs[0].rule == "wp-sync-in-kernel"
    assert fs[0].path.endswith("a.py") and fs[0].line == 5
    # the witness chain names the whole path to the base API
    assert "helper" in fs[0].message and "deep" in fs[0].message
    assert "torch.cuda.synchronize" in fs[0].message


def test_blocking_call_in_kernel_flagged(tmp_path):
    root = _pkg(
        tmp_path,
        {
            "a.py": (
                "from mypkg.b import probe\n"
                "\n"
                "\n"
                "def step(x):\n"
                "    probe()\n"
                "    return x\n"
            ),
            "b.py": (
                "import time\n"
                "def probe():\n"
                "    time.sleep(1)\n"
            ),
        },
    )
    fs = analyze_sync_in_kernel(Program.build(root, "mypkg"))
    assert len(fs) == 1 and "transitively blocks" in fs[0].message


def test_direct_sync_in_kernel_not_duplicated(tmp_path):
    # depth-0 is the per-file host-sync rule's finding, not ours — the
    # port's boundary is a package function, so resolution must not turn
    # a direct device_get call into a depth-1 chain
    root = _pkg(
        tmp_path,
        {
            "a.py": (
                "import torch\n"
                "from mypkg.me import device_get\n"
                "def kernel(x):\n"
                "    torch.cuda.synchronize()\n"
                "    return device_get(x)\n"
            ),
            "me.py": (
                "import torch\n"
                "def device_get(x):\n"
                "    torch.cuda.current_stream().synchronize()\n"
                "    return x\n"
            ),
        },
    )
    assert analyze_sync_in_kernel(Program.build(root, "mypkg")) == []


def test_nested_kernel_builder_traced(tmp_path):
    # the measure_exec pattern: _kernel_body returns its per-chunk body
    root = _pkg(
        tmp_path,
        {
            "a.py": (
                "from mypkg.b import leak\n"
                "def _kernel_body(spec):\n"
                "    def body(c):\n"
                "        return leak(c)\n"
                "    return body\n"
            ),
            "b.py": (
                "def leak(c):\n"
                "    return c.synchronize()\n"
            ),
        },
    )
    program = Program.build(root, "mypkg")
    assert program.functions["mypkg.a:_kernel_body.body"].traced
    assert not program.functions["mypkg.a:_kernel_body"].traced
    fs = analyze_sync_in_kernel(program)
    assert len(fs) == 1 and fs[0].path.endswith("a.py")


def test_own_nested_helper_resolved(tmp_path):
    # a function calling its OWN nested def resolves ("outer.h", not a
    # non-existent module-level "h"), so facts propagate through the
    # common build-a-closure-and-use-it pattern
    root = _pkg(
        tmp_path,
        {
            "a.py": (
                "from mypkg.b import outer\n"
                "\n"
                "\n"
                "def kernel(x):\n"
                "    return outer(x)\n"
            ),
            "b.py": (
                "from mypkg import me\n"
                "def outer(x):\n"
                "    def h(y):\n"
                "        return me.device_get(y)\n"
                "    return h(x)\n"
            ),
            "me.py": "def device_get(x):\n    return x\n",
        },
    )
    fs = analyze_sync_in_kernel(Program.build(root, "mypkg"))
    assert len(fs) == 1 and "outer" in fs[0].message
    assert "me.device_get" in fs[0].message


def test_lock_blocking_across_files_flagged(tmp_path):
    root = _pkg(
        tmp_path,
        {
            "a.py": (
                "from mypkg.b import push\n"
                "class S:\n"
                "    def send(self, env):\n"
                "        with self._lock:\n"
                "            return push(env)\n"
            ),
            "b.py": (
                "def push(env):\n"
                "    return env.transport.call('n1', 'topic', env, timeout=5)\n"
            ),
        },
    )
    from banyandb_tpu.lint.whole_program.callgraph import (
        analyze_lock_blocking as ref,
    )

    port, refp = _program_both(root)
    fs = analyze_lock_blocking(port)
    assert _key(fs) == _key(ref(refp))
    assert len(fs) == 1 and fs[0].rule == "wp-lock-blocking"
    assert "S._lock" in fs[0].message and "transport.call" in fs[0].message


def test_lock_blocking_direct_call_not_duplicated(tmp_path):
    # a DIRECT blocking call under the lock is lock-across-rpc's finding
    root = _pkg(
        tmp_path,
        {
            "a.py": (
                "import time\n"
                "class S:\n"
                "    def send(self):\n"
                "        with self._lock:\n"
                "            time.sleep(1)\n"
            ),
        },
    )
    from banyandb_tpu.lint.whole_program.callgraph import (
        analyze_lock_blocking as ref,
    )

    port, refp = _program_both(root)
    assert analyze_lock_blocking(port) == [] == ref(refp)


# -- lock-order cycles -------------------------------------------------------


def _lock_order_both(root):
    from banyandb_tpu.lint.whole_program.lockorder import (
        analyze_lock_order as ref,
    )

    port, refp = _program_both(root)
    fs = analyze_lock_order(port)
    assert _key(fs) == _key(ref(refp))
    return fs


def test_lock_order_cycle_flagged(tmp_path):
    root = _pkg(
        tmp_path,
        {
            "m.py": (
                "import threading\n"
                "ingest_lock = threading.Lock()\n"
                "flush_lock = threading.Lock()\n"
                "def fwd():\n"
                "    with ingest_lock:\n"
                "        with flush_lock:\n"
                "            pass\n"
                "def rev():\n"
                "    with flush_lock:\n"
                "        with ingest_lock:\n"
                "            pass\n"
            ),
        },
    )
    fs = _lock_order_both(root)
    assert len(fs) == 1 and fs[0].rule == "lock-order"
    assert "potential deadlock cycle" in fs[0].message
    assert "ingest_lock" in fs[0].message and "flush_lock" in fs[0].message


def test_lock_order_cycle_through_call_chain(tmp_path):
    root = _pkg(
        tmp_path,
        {
            "a.py": (
                "import threading\n"
                "from mypkg.b import grab_b\n"
                "a_lock = threading.Lock()\n"
                "def fwd():\n"
                "    with a_lock:\n"
                "        grab_b()\n"
            ),
            "b.py": (
                "import threading\n"
                "import mypkg.a\n"
                "b_lock = threading.Lock()\n"
                "def grab_b():\n"
                "    with b_lock:\n"
                "        pass\n"
                "def rev():\n"
                "    with b_lock:\n"
                "        with mypkg.a.a_lock:\n"
                "            pass\n"
            ),
        },
    )
    fs = _lock_order_both(root)
    assert len(fs) == 1 and "via grab_b" in fs[0].message


def test_lock_order_self_reacquire_flagged_for_plain_lock(tmp_path):
    root = _pkg(
        tmp_path,
        {
            "a.py": (
                "import threading\n"
                "class S:\n"
                "    def __init__(self):\n"
                "        self._lock = threading.Lock()\n"
                "    def outer(self):\n"
                "        with self._lock:\n"
                "            self.inner()\n"
                "    def inner(self):\n"
                "        with self._lock:\n"
                "            pass\n"
            ),
        },
    )
    fs = _lock_order_both(root)
    assert len(fs) == 1 and "acquired while already held" in fs[0].message


def test_lock_order_rlock_self_reacquire_exempt(tmp_path):
    root = _pkg(
        tmp_path,
        {
            "a.py": (
                "import threading\n"
                "class S:\n"
                "    def __init__(self):\n"
                "        self._lock = threading.RLock()\n"
                "    def outer(self):\n"
                "        with self._lock:\n"
                "            self.inner()\n"
                "    def inner(self):\n"
                "        with self._lock:\n"
                "            pass\n"
            ),
        },
    )
    assert _lock_order_both(root) == []


def test_real_tree_callgraph_analyses_clean():
    program = Program.build(PORT, "banyandb_tpu_torch")
    # the audit found real device regions — the analyses are not vacuous
    traced = {q for q, i in program.functions.items() if i.traced}
    assert len(traced) >= 4
    assert "banyandb_tpu_torch.query.measure_exec:_kernel_body.kernel" in traced
    assert "banyandb_tpu_torch.query.fused_exec:build_fused_dist_step.step" in traced
    assert sum(1 for i in program.functions.values() if i.block) >= 10
    assert program.functions["banyandb_tpu_torch.query.measure_exec:device_get"].sync
    fs = (
        analyze_sync_in_kernel(program)
        + analyze_lock_blocking(program)
        + analyze_lock_order(program)
    )
    fs, suppressed = apply_suppressions(fs)
    assert fs == [], "\n".join(f.render() for f in fs)
    # the one: nvcc under the kernel library's load lock
    assert suppressed == 1


# -- shared-state race analysis ----------------------------------------------


_RACY_PKG = {
    "svc.py": (
        "import threading\n"
        "class Svc:\n"
        "    def __init__(self):\n"
        "        self.count = 0\n"
        "        self._lock = threading.Lock()\n"
        "    def on_write(self, env):\n"  # bus subscriber root
        "        self.count += 1\n"
        "        return {}\n"
        "    def _loop(self):\n"
        "        self.count = 0\n"
        "    def start(self, bus):\n"
        "        bus.subscribe('write', self.on_write)\n"
        "        threading.Thread(target=self._loop, name='svc-loop').start()\n"
    ),
}


def _shared_both(root, **kw):
    from banyandb_tpu.lint.whole_program.shared_state import (
        analyze_shared_state as ref,
    )

    port, refp = _program_both(root)
    fs = analyze_shared_state(port, **kw)
    assert _key(fs) == _key(ref(refp, **kw))
    return fs, port


def test_shared_state_unguarded_two_root_write_flagged(tmp_path):
    fs, program = _shared_both(_pkg(tmp_path, _RACY_PKG))
    roots = {r.qual for r in discover_roots(program)}
    assert "mypkg.svc:Svc.on_write" in roots  # subscriber
    assert "mypkg.svc:Svc._loop" in roots  # thread target
    assert len(fs) == 1 and fs[0].rule == "wp-shared-state"
    assert "mypkg.svc.Svc.count" in fs[0].message
    # witness chains name both roots
    assert "svc-loop" in fs[0].message and "subscriber" in fs[0].message


def test_shared_state_common_guard_is_clean(tmp_path):
    files = {
        "svc.py": _RACY_PKG["svc.py"]
        .replace(
            "        self.count += 1\n",
            "        with self._lock:\n            self.count += 1\n",
        )
        .replace(
            "        self.count = 0\n    def start",
            "        with self._lock:\n            self.count = 0\n    def start",
        )
    }
    assert _shared_both(_pkg(tmp_path, files))[0] == []


def test_shared_state_single_root_write_is_clean(tmp_path):
    files = {
        "svc.py": (
            "import threading\n"
            "class Svc:\n"
            "    def _loop(self):\n"
            "        self.count = 0\n"  # only ONE root ever writes
            "    def on_read(self, env):\n"
            "        return {'n': self.count}\n"
            "    def start(self, bus):\n"
            "        bus.subscribe('read', self.on_read)\n"
            "        threading.Thread(target=self._loop).start()\n"
        ),
    }
    assert _shared_both(_pkg(tmp_path, files))[0] == []


def test_shared_state_interprocedural_guard_via_must_hold(tmp_path):
    # the lock is taken by the CALLER; the helper that writes inherits it
    # through must-hold propagation across both roots
    files = {
        "svc.py": (
            "import threading\n"
            "class Svc:\n"
            "    def _bump(self):\n"
            "        self.count += 1\n"
            "    def on_write(self, env):\n"
            "        with self._lock:\n"
            "            self._bump()\n"
            "    def _loop(self):\n"
            "        with self._lock:\n"
            "            self._bump()\n"
            "    def start(self, bus):\n"
            "        bus.subscribe('write', self.on_write)\n"
            "        threading.Thread(target=self._loop).start()\n"
        ),
    }
    assert _shared_both(_pkg(tmp_path, files))[0] == []


def test_shared_state_constructor_writes_exempt(tmp_path):
    # __init__ (and helpers only reachable through it) are pre-publication
    files = {
        "svc.py": (
            "import threading\n"
            "class Svc:\n"
            "    def __init__(self):\n"
            "        self._setup()\n"
            "    def _setup(self):\n"
            "        self.count = 0\n"
            "    def on_a(self, env):\n"
            "        s = Svc()\n"
            "        return {}\n"
            "    def on_b(self, env):\n"
            "        s = Svc()\n"
            "        return {}\n"
            "    def start(self, bus):\n"
            "        bus.subscribe('a', self.on_a)\n"
            "        bus.subscribe('b', self.on_b)\n"
        ),
    }
    assert _shared_both(_pkg(tmp_path, files))[0] == []


def test_shared_state_sync_primitives_exempt(tmp_path):
    files = {
        "svc.py": (
            "import threading, queue\n"
            "class Svc:\n"
            "    def __init__(self):\n"
            "        self._stop = threading.Event()\n"
            "        self._q = queue.Queue()\n"
            "    def on_write(self, env):\n"
            "        self._q.put(env)\n"
            "        return {}\n"
            "    def _loop(self):\n"
            "        self._q.put(None)\n"
            "        self._stop.set()\n"
            "    def start(self, bus):\n"
            "        bus.subscribe('write', self.on_write)\n"
            "        threading.Thread(target=self._loop).start()\n"
        ),
    }
    assert _shared_both(_pkg(tmp_path, files))[0] == []


def test_shared_state_mutator_calls_count_as_writes(tmp_path):
    files = {
        "svc.py": (
            "import threading\n"
            "class Svc:\n"
            "    def on_write(self, env):\n"
            "        self.items.append(env)\n"
            "        return {}\n"
            "    def _loop(self):\n"
            "        self.items.clear()\n"
            "    def start(self, bus):\n"
            "        bus.subscribe('write', self.on_write)\n"
            "        threading.Thread(target=self._loop).start()\n"
        ),
    }
    fs, program = _shared_both(_pkg(tmp_path, files))
    assert len(fs) == 1 and "Svc.items" in fs[0].message
    accesses = [
        a for a in collect_accesses(program) if a.attr.endswith("items")
    ]
    assert all(a.write for a in accesses)


def test_shared_state_baseline_ratchet(tmp_path):
    root = _pkg(tmp_path, _RACY_PKG)
    live = frozenset({"mypkg.svc.Svc.count"})
    # baselined live race: tolerated
    assert _shared_both(root, baseline=live)[0] == []
    # stale entry: fails so the set only shrinks
    fs, _ = _shared_both(
        root,
        baseline=live | {"mypkg.svc.Svc.gone"},
        baseline_path="<bl>",
    )
    assert len(fs) == 1 and "stale baseline" in fs[0].message


def test_shared_state_worker_process_entries_are_roots():
    """The worker entries run as the MAIN thread of a spawned subprocess
    — exec boundaries are invisible to registration discovery, so
    shared_state declares them as process roots (cluster/workers.py)."""
    program = Program.build(PORT, "banyandb_tpu_torch")
    kinds = {r.qual: r.kind for r in discover_roots(program)}
    assert kinds.get("banyandb_tpu_torch.cluster.workers:worker_main") == "process"
    assert (
        kinds.get("banyandb_tpu_torch.cluster.workers:_WorkerServer.serve")
        == "process"
    )


def test_shared_state_grpc_servicer_and_timer_roots(tmp_path):
    files = {
        "api.py": (
            "import threading\n"
            "class WireServices:\n"
            "    def measure_write(self, req):\n"
            "        self.total += 1\n"
            "        return req\n"
            "class Saver:\n"
            "    def _fire(self):\n"
            "        self.total = 0\n"
            "    def schedule(self):\n"
            "        threading.Timer(1.0, self._fire).start()\n"
        ),
    }
    program = Program.build(_pkg(tmp_path, files), "mypkg")
    kinds = {r.qual: r.kind for r in discover_roots(program)}
    assert kinds.get("mypkg.api:WireServices.measure_write") == "grpc"
    assert kinds.get("mypkg.api:Saver._fire") == "timer"


def test_real_tree_shared_state_clean_with_pinned_suppressions():
    """The audited-tree meta-test: zero findings, and the suppression
    population is a pinned, reviewed number."""
    from banyandb_tpu_torch.lint.whole_program import run_whole_program

    findings, stats = run_whole_program(PORT, plan_audit=False)
    assert findings == [], "\n".join(f.render() for f in findings)
    # 8 = the reference's 7 wp-shared-state suppressions at their
    # counterparts (bydbql._Parser, StreamEngine.last_scan_stats,
    # Bloom.bits, Span.t1, WorkerPool._jbytes/_journal,
    # _WorkerServer.applied_seq) + the port's one wp-lock-blocking:
    # nvcc under hopper_kernels._lib_lock (one thread builds, the others
    # wait for the library)
    assert stats["wp_suppressed"] == 8
    # root discovery is not vacuous: threads, subscribers, grpc methods
    assert stats["wp_roots"] >= 60


# -- plan auditor ------------------------------------------------------------


def _entry(fn, expect, cache_key=None, args=None):
    if args is None:
        args = (TensorSpec((64,), torch.int32),)
    return KernelAudit(
        name="seeded",
        path="query/x.py",
        line=1,
        fn=fn,
        args=args,
        expect=expect,
        cache_key=cache_key,
    )


def test_plan_audit_dtype_promotion_flagged():
    # an int32 key column silently promoted to float: the contract table
    # pins int32, the audit reports the drift
    fs = audit_kernel(_entry(lambda x: x + 0.5, {"<out>": ("int32", (64,))}))
    assert len(fs) == 1 and fs[0].rule == "plan-audit"
    assert "float32" in fs[0].message and "int32" in fs[0].message


def test_plan_audit_64bit_output_flagged():
    fs = audit_kernel(
        _entry(
            lambda x: x.to(torch.float64),
            None,
            args=(TensorSpec((64,), torch.float32),),
        )
    )
    assert len(fs) == 1 and "float64" in fs[0].message


def test_plan_audit_shape_mismatch_flagged():
    fs = audit_kernel(
        # reduces away the row axis while the contract expects [64]
        _entry(
            lambda x: torch.sum(x),
            {"<out>": ("float32", (64,))},
            args=(TensorSpec((64,), torch.float32),),
        )
    )
    assert len(fs) == 1 and "shape=()" in fs[0].message


def test_plan_audit_trace_failure_flagged():
    fs = audit_kernel(
        _entry(lambda x: x + torch.zeros((3, 5)), {"<out>": ("int32", (64,))})
    )
    assert len(fs) == 1 and "fake-tensor trace failed" in fs[0].message


def test_plan_audit_retrace_hazard_mutable_cache_key():
    fs = audit_kernel(
        _entry(
            lambda x: x,
            {"<out>": ("int32", (64,))},
            cache_key=("plan", np.zeros(3)),
        )
    )
    assert any("not deeply immutable" in f.message for f in fs)


def test_plan_audit_retrace_hazard_identity_hash_key():
    class IdentityKey:  # hashes by id(): equal rebuilt plans miss the cache
        pass

    fs = audit_kernel(
        _entry(lambda x: x, {"<out>": ("int32", (64,))}, cache_key=IdentityKey())
    )
    assert any("not deeply immutable" in f.message for f in fs) or any(
        "identity" in f.message for f in fs
    )


def test_plan_audit_real_matrix_clean():
    from banyandb_tpu_torch.lint.whole_program.plan_audit import run_plan_audit

    fs = run_plan_audit()
    assert fs == [], "\n".join(f.render() for f in fs)


# -- CLI / suppressions ------------------------------------------------------


def test_wp_findings_honor_suppressions(tmp_path):
    p = tmp_path / "x.py"
    p.write_text(
        "import torch\n"
        "# bdlint: disable=wp-sync-in-kernel -- seeded, documented\n"
        "y = 1\n"
    )
    from banyandb_tpu_torch.lint.core import Finding

    f = Finding(path=str(p), line=3, col=0, rule="wp-sync-in-kernel", message="m")
    kept, suppressed = apply_suppressions([f])
    assert kept == [] and suppressed == 1


_GATE = (
    "import runpy, sys\n"
    "sys.modules['jax'] = None\n"  # the gate must need no JAX
    "sys.argv = ['bdlint', '--check', '--format', 'json', sys.argv[1]]\n"
    "runpy.run_module('banyandb_tpu_torch.lint', run_name='__main__')\n"
)


def test_cli_whole_program_gate_green(tmp_path):
    """The acceptance run: --check over the port's package exits 0 with
    every whole-program family folded in (plan audit and kernel audit
    included, no --fast), in a fresh process where JAX cannot import."""
    import json

    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("BYDB_SANITIZE", None)
    out = subprocess.run(
        [sys.executable, "-c", _GATE, str(PORT)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    props = json.loads(out.stdout)["runs"][0]["properties"]
    assert props["findings"] == 0 and props["wp_findings"] == 0
    assert props["kernel_lowering"] is True
    # 15 per-file (test_torch_lint.test_tree_is_bdlint_clean) + 8 whole-program
    assert props["suppressed"] == 15 + 8
    assert "jax" not in out.stderr.lower()


def test_cli_families_and_list_rules_cover_the_reference(capsys):
    """--list-rules names every per-file rule and whole-program family of
    the reference under the same ids, except the two renamed ones."""
    from banyandb_tpu.lint.__main__ import main as ref_main
    from banyandb_tpu_torch.lint.__main__ import main

    def ids(fn):
        assert fn(["--list-rules"]) == 0
        return {ln.split()[0] for ln in capsys.readouterr().out.splitlines()}

    ref, port = ids(ref_main), ids(main)
    renamed = {"wp-sync-in-jit": "wp-sync-in-kernel", "kernel-jaxpr": "kernel-ops"}
    assert {renamed.get(r, r) for r in ref} == port
    from banyandb_tpu.lint.whole_program import FAMILIES as REF_FAMILIES
    from banyandb_tpu_torch.lint.whole_program import FAMILIES, family_of_rule

    assert set(FAMILIES) == set(REF_FAMILIES)
    assert family_of_rule("wp-sync-in-kernel") == "sync"
    assert family_of_rule("kernel-ops") == "kernel"
    assert family_of_rule("wire-obs") == "wire"
    assert family_of_rule("host-sync") is None


# -- parity over the real trees ---------------------------------------------


# Static lock-order edges of the reference, re-keyed, that the port's
# graph no longer has: held -> acquired -> reason.  Empty: the port keeps
# every nesting of the reference.
DROPPED_EDGES: dict[tuple[str, str], str] = {}

# Edges only the port has, each with its reason.
PORT_EXTRA_EDGES: dict[tuple[str, str], str] = {
    (
        "banyandb_tpu_torch.cluster.wqueue.WriteQueue._pass_lock",
        "banyandb_tpu_torch.cluster.wqueue.WriteQueue._lock",
    ): "a flush pass (one at a time) takes the state lock for each "
    "bookkeeping step",
    (
        "banyandb_tpu_torch.cluster.wqueue.WriteQueue._pass_lock",
        "banyandb_tpu_torch.cluster.wqueue.WriteQueue._pass_lock",
    ): "an RLock: a forced flush re-enters the pass it runs under",
    (
        "banyandb_tpu_torch.cluster.wqueue.WriteQueue._pass_lock",
        "banyandb_tpu_torch.cluster.faults._GLOBAL_LOCK",
    ): "shipping a part passes the fault plane's injection hook",
    (
        "banyandb_tpu_torch.cluster.wqueue.WriteQueue._pass_lock",
        "banyandb_tpu_torch.obs.metrics._GLOBAL_LOCK",
    ): "the pass counts shipped parts and bytes on the meter",
    (
        "banyandb_tpu_torch.ops.hopper_kernels._lib_lock",
        "banyandb_tpu_torch.utils.compile_cache._lock",
    ): "the kernel library's load records its build or load in the build "
    "cache's counters",
}


def test_static_lock_graph_parity_with_reference():
    from banyandb_tpu.lint.whole_program.callgraph import Program as RefProgram
    from banyandb_tpu.lint.whole_program.lockorder import (
        build_lock_graph as ref_graph,
    )
    from banyandb_tpu_torch.lint.whole_program.lockorder import build_lock_graph

    def rekey(lock_id: str) -> str:
        return lock_id.replace("banyandb_tpu.", "banyandb_tpu_torch.", 1)

    ref = RefProgram.build(REPO / "banyandb_tpu", "banyandb_tpu")
    port = Program.build(PORT, "banyandb_tpu_torch")
    ref_edges = {(rekey(e.held), rekey(e.acquired)) for e in ref_graph(ref)}
    port_edges = {(e.held, e.acquired) for e in build_lock_graph(port)}
    assert ref_edges - port_edges == set(DROPPED_EDGES)
    assert port_edges - ref_edges == set(PORT_EXTRA_EDGES)
    # every lock the reference declares, the port declares too
    assert {rekey(v) for v in ref.lock_sites.values()} <= set(
        port.lock_sites.values()
    )
    assert {rekey(v) for v in ref.reentrant_locks} <= port.reentrant_locks


def test_copied_analyzers_parity_over_package_named_trees(tmp_path):
    """One synthetic tree — an upward import, a lock-order cycle, a
    cross-file lock-blocking call and a two-root race — written under
    each package's name, through both packages' analyzers: the same
    findings, with the package name the only difference."""
    from banyandb_tpu.lint.whole_program import callgraph as rcg
    from banyandb_tpu.lint.whole_program import layers as rlayers
    from banyandb_tpu.lint.whole_program import lockorder as rlo
    from banyandb_tpu.lint.whole_program import shared_state as rss
    from banyandb_tpu_torch.lint.whole_program import callgraph as pcg
    from banyandb_tpu_torch.lint.whole_program import layers as players
    from banyandb_tpu_torch.lint.whole_program import lockorder as plo
    from banyandb_tpu_torch.lint.whole_program import shared_state as pss

    def files(name):
        return {
            "lo/a.py": f"from {name}.hi.b import f\n",
            "hi/b.py": (
                "import threading\n"
                "a_lock = threading.Lock()\n"
                "b_lock = threading.Lock()\n"
                "def f():\n"
                "    with a_lock:\n"
                "        with b_lock:\n"
                "            pass\n"
                "def g():\n"
                "    with b_lock:\n"
                "        with a_lock:\n"
                "            pass\n"
            ),
            "hi/c.py": (
                f"from {name}.hi.d import push\n"
                "class S:\n"
                "    def send(self, env):\n"
                "        with self._lock:\n"
                "            return push(env)\n"
            ),
            "hi/d.py": (
                "def push(env):\n"
                "    return env.transport.call('n', 't', env, timeout=5)\n"
            ),
            "hi/svc.py": _RACY_PKG["svc.py"],
        }

    results = {}
    for name, cg, lay, lo, ss in (
        ("banyandb_tpu", rcg, rlayers, rlo, rss),
        ("banyandb_tpu_torch", pcg, players, plo, pss),
    ):
        root = _pkg(tmp_path / name, files(name), name=name)
        cfg = lay.LayerConfig(
            layers=("low", "high"),
            may_import={"low": (), "high": ("low",)},
            layer_of={"": "low", "lo": "low", "hi": "high"},
        )
        program = cg.Program.build(root, name)
        fs = (
            lay.analyze_layers(root, name, cfg)
            + lo.analyze_lock_order(program)
            + cg.analyze_lock_blocking(program)
            + ss.analyze_shared_state(program)
        )
        results[name] = sorted(
            (
                f.rule,
                Path(f.path).relative_to(root).as_posix(),
                f.line,
                f.message.replace(str(root), "ROOT").replace(name + ".", "PKG."),
            )
            for f in fs
        )
    assert results["banyandb_tpu"] == results["banyandb_tpu_torch"]
    assert {r[0] for r in results["banyandb_tpu"]} == {
        "layering", "lock-order", "wp-lock-blocking", "wp-shared-state",
    }
