"""bdlint for the port: the per-rule fixtures of tests/test_lint.py
(positive / negative / suppressed), the JAX-specific ones rewritten in
PyTorch for rules_torch, plus the meta-test that the port's tree is
clean and the parity tests that hold the copied fabric rules and the
rewritten hot-path rules to the reference's on the same inputs.

Fixtures are linted via lint_source with a virtual package-relative
path, so rule scoping (hot modules vs whole package) is exercised
without touching the filesystem.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from banyandb_tpu_torch.lint import lint_paths, lint_source, render_json

REPO = Path(__file__).resolve().parents[1]


def _rules(src: str, rel: str = "query/x.py") -> list[str]:
    findings, _ = lint_source(src, rel=rel)
    return [f.rule for f in findings]


def _count(src: str, rule: str, rel: str = "query/x.py") -> int:
    return _rules(src, rel=rel).count(rule)


# Each reference fixture that rules_jax flags, beside its PyTorch
# counterpart for rules_torch: (rule, rel, JAX source, torch source).
# The two sources are line-aligned: the same rule fires on the same
# lines (test_torch_rules_flag_every_reference_fixture_on_the_same_line).
PAIRS = {
    "stream-wait": (
        "host-sync",
        "query/x.py",
        "def f(x):\n    return x.block_until_ready()\n",
        "def f(stream):\n    return stream.synchronize()\n",
    ),
    "device-get": (
        "host-sync",
        "query/x.py",
        "import jax\n\ndef f(x):\n    return jax.device_get(x)\n",
        "from banyandb_tpu_torch.query import measure_exec\n\n"
        "def f(x):\n    return measure_exec.device_get(x)\n",
    ),
    "asarray-kernel": (
        "host-sync",
        "query/x.py",
        "import numpy as np\n"
        "def run(kernel, chunk):\n"
        "    out = kernel(chunk)\n"
        "    return np.asarray(out['count'])\n",
        "import numpy as np\n"
        "def run(kernel, chunk):\n"
        "    out = kernel(chunk)\n"
        "    return np.asarray(out['count'])\n",
    ),
    "cast-device": (
        "host-sync",
        "query/x.py",
        "import jax.numpy as jnp\n"
        "def f(a):\n"
        "    s = jnp.sum(a)\n"
        "    return float(s)\n",
        "import torch\n"
        "def f(a):\n"
        "    s = torch.sum(a.cuda())\n"
        "    return float(s)\n",
    ),
    "built-local": (
        "host-sync",
        "query/x.py",
        "import jax, numpy as np\n"
        "def f(g, x):\n"
        "    run = jax.jit(g)\n"
        "    out = run(x)\n"
        "    return np.asarray(out)\n",
        "import numpy as np\n"
        "def f(spec, x):\n"
        "    run = _build_kernel(spec)\n"
        "    out = run(x)\n"
        "    return np.asarray(out)\n",
    ),
    "clock-region": (
        "host-sync",
        "query/x.py",
        "import jax, time\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    t = time.time()\n"
        "    return x + t\n",
        "import time\n"
        "\n"
        "def kernel(x):\n"
        "    t = time.time()\n"
        "    return x + t\n",
    ),
    "clock-builder-body": (
        "host-sync",
        "query/x.py",
        "import jax, time\n"
        "def build():\n"
        "    def kernel(x):\n"
        "        return x * time.monotonic()\n"
        "    return jax.jit(kernel)\n",
        "import time\n"
        "def _kernel_body(spec):\n"
        "    def body(x):\n"
        "        return x * time.monotonic()\n"
        "    return body\n",
    ),
    "per-call-load": (
        "recompile-hazard",
        "query/x.py",
        "import jax\nf = jax.jit(lambda x: x + 1)\n",
        "import ctypes\ndef launch(p): return ctypes.CDLL(p)\n",
    ),
    "immediately-called": (
        "recompile-hazard",
        "query/x.py",
        "import jax\n\ndef f(g, x):\n    return jax.jit(g)(x)\n",
        "\n\ndef f(spec, x):\n    return _build_kernel(spec)(x)\n",
    ),
    "in-loop": (
        "recompile-hazard",
        "query/x.py",
        "import jax\n"
        "def f(fns, x):\n"
        "    outs = []\n"
        "    for g in fns:\n"
        "        h = jax.jit(g)\n"
        "        outs.append(h)\n"
        "    return outs\n",
        "\n"
        "def f(specs, x):\n"
        "    outs = []\n"
        "    for s in specs:\n"
        "        h = _build_kernel(s)\n"
        "        outs.append(h)\n"
        "    return outs\n",
    ),
    "format-argument": (
        "recompile-hazard",
        "query/x.py",
        "import jax\n"
        "@jax.jit\n"
        "def f(x):\n"
        "    name = f'value {x}'\n"
        "    return x\n",
        "\n"
        "\n"
        "def kernel(x):\n"
        "    name = f'value {x}'\n"
        "    return x\n",
    ),
    "f64-constructor": (
        "precision-drift",
        "ops/x.py",
        "import numpy as np\nbuf = np.zeros(4)\n",
        "import torch\nbuf = torch.zeros(4, dtype=torch.float64, device='cuda')\n",
    ),
    "f64-shipped": (
        "precision-drift",
        "ops/x.py",
        "import numpy as np\na = np.full(3, 0.0)\nb = np.arange(7)\n",
        "import numpy as np\n"
        "a = ship(np.full(3, 0.0), 'cuda')\n"
        "b = torch.as_tensor(np.zeros(7), device='cuda')\n",
    ),
}


def _torch(name: str) -> str:
    return PAIRS[name][3]


# -- host-sync ---------------------------------------------------------------


def test_host_sync_stream_synchronize():
    src = _torch("stream-wait")
    assert _count(src, "host-sync") == 1
    # out of hot scope: nothing fires
    assert _count(src, "host-sync", rel="admin/x.py") == 0
    assert _count("import torch\ntorch.cuda.synchronize()\n", "host-sync") == 1


def test_host_sync_device_get_flagged():
    assert _count(_torch("device-get"), "host-sync") == 1


def test_host_sync_asarray_on_kernel_result():
    assert _count(_torch("asarray-kernel"), "host-sync") == 1


def test_host_sync_cast_on_device_tensor():
    assert _count(_torch("cast-device"), "host-sync") == 1
    # the host copy methods and np.array of a card tensor, one each
    src = (
        "import numpy as np, torch\n"
        "def f(x, dev):\n"
        "    t = x.to(dev)\n"
        "    a = t.sum().item()\n"
        "    b = t.tolist()\n"
        "    c = t.cpu()\n"
        "    d = np.array(t)\n"
        "    e = bool(t.any())\n"
        "    return a, b, c, d, e\n"
    )
    assert _count(src, "host-sync") == 5
    # a tensor's metadata is on the host already
    meta = (
        "def f(x, dev):\n"
        "    t = x.to(dev)\n"
        "    return int(t.shape[0]) + int(t.numel())\n"
    )
    assert _count(meta, "host-sync") == 0


def test_host_sync_asarray_on_host_value_clean():
    src = (
        "import numpy as np\n"
        "def f(rows):\n"
        "    return np.asarray(rows, dtype=np.int64)\n"
    )
    assert _count(src, "host-sync") == 0


def test_host_sync_built_local_name():
    assert _count(_torch("built-local"), "host-sync") == 1


def test_host_sync_clock_in_device_region():
    assert _count(_torch("clock-region"), "host-sync") == 1


def test_host_sync_clock_in_builder_body():
    # the nested build pattern: _kernel_body returns its per-chunk body
    assert _count(_torch("clock-builder-body"), "host-sync") == 1


def test_host_sync_clock_outside_device_region_clean():
    src = "import time\n\ndef f():\n    return time.time()\n"
    assert _count(src, "host-sync") == 0


def test_host_sync_suppressed_same_line():
    src = (
        "from banyandb_tpu_torch.query import measure_exec\n"
        "def f(x):\n"
        "    return measure_exec.device_get(x)  "
        "# bdlint: disable=host-sync -- boundary\n"
    )
    findings, suppressed = lint_source(src, rel="query/x.py")
    assert [f.rule for f in findings] == []
    assert suppressed == 1


def test_host_sync_suppressed_previous_comment_line():
    src = (
        "from banyandb_tpu_torch.query import measure_exec\n"
        "def f(x):\n"
        "    # bdlint: disable=host-sync -- result boundary, reason here\n"
        "    return measure_exec.device_get(x)\n"
    )
    findings, suppressed = lint_source(src, rel="query/x.py")
    assert not findings
    assert suppressed == 1


# -- recompile-hazard --------------------------------------------------------


def test_recompile_library_load_per_call():
    assert _count(_torch("per-call-load"), "recompile-hazard") == 1
    # nvcc outside the guarded load is the same hazard, minutes per call
    src = "def launch(so):\n    return _compile(so)\n"
    assert _count(src, "recompile-hazard", rel="ops/x.py") == 1
    guarded = (
        "import ctypes, threading\n"
        "_lib_lock = threading.Lock()\n"
        "def build(so):\n"
        "    with _lib_lock:\n"
        "        _compile(so)\n"
        "        return ctypes.CDLL(so)\n"
    )
    assert _count(guarded, "recompile-hazard", rel="ops/x.py") == 0


def test_recompile_builder_immediately_called():
    assert _count(_torch("immediately-called"), "recompile-hazard") == 1


def test_recompile_builder_in_loop():
    assert _count(_torch("in-loop"), "recompile-hazard") == 1


def test_recompile_builder_taken_as_value():
    # a dict of builders looked up per call builds outside the memo
    src = (
        "from q import fused_exec, measure_exec\n"
        "def signature_function(kind, spec):\n"
        "    build = {\n"
        "        'measure': measure_exec._build_kernel,\n"
        "        'fused': fused_exec._build_kernel,\n"
        "    }.get(kind)\n"
        "    return None if build is None else build(spec)\n"
    )
    assert _count(src, "recompile-hazard") == 2
    # the accessor that reads the executor's memo is clean
    via_memo = (
        "from q import fused_exec, measure_exec\n"
        "def signature_function(kind, spec):\n"
        "    mod = {'measure': measure_exec, 'fused': fused_exec}.get(kind)\n"
        "    return None if mod is None else mod.kernel_for(spec)\n"
    )
    assert _count(via_memo, "recompile-hazard") == 0


def test_recompile_cached_build_pattern_clean():
    # the blessed executor pattern: build once per plan spec, in a memo
    src = (
        "_KERNEL_CACHE = {}\n"
        "def _build_kernel(spec):\n"
        "    body = _kernel_body(spec)\n"
        "    def kernel(c):\n"
        "        return body(c)\n"
        "    return kernel\n"
        "def run(spec, c):\n"
        "    kernel = _KERNEL_CACHE.get(spec)\n"
        "    if kernel is None:\n"
        "        kernel = _KERNEL_CACHE[spec] = _build_kernel(spec)\n"
        "    return kernel(c)\n"
        "_STEP_CACHE = {}\n"
        "def build_dist_step(plan):\n"
        "    cached = _STEP_CACHE.get(plan)\n"
        "    if cached is not None:\n"
        "        return cached\n"
        "    def step(c):\n"
        "        return c\n"
        "    _STEP_CACHE[plan] = step\n"
        "    return step\n"
        "def go(plan, c):\n"
        "    return build_dist_step(plan)(c)\n"
    )
    assert _count(src, "recompile-hazard") == 0


def test_recompile_format_over_device_argument():
    assert _count(_torch("format-argument"), "recompile-hazard") == 1
    # a list constant shipped per chunk inside the body
    src = (
        "import torch\n"
        "def kernel(x):\n"
        "    w = torch.tensor([1, 2, 3], device=x.device)\n"
        "    return x * w\n"
    )
    assert _count(src, "recompile-hazard") == 1


def test_recompile_format_over_closure_var_clean():
    src = (
        "def _build_kernel(i):\n"
        "    def kernel(x):\n"
        "        return x + len(f'p{i}')\n"
        "    return kernel\n"
    )
    assert _count(src, "recompile-hazard") == 0


# -- precision-drift ---------------------------------------------------------


def test_precision_f64_tensor_on_card():
    src = _torch("f64-constructor")
    assert _count(src, "precision-drift", rel="ops/x.py") == 1
    # cluster code is out of scope for the kernel-path rule
    assert _count(src, "precision-drift", rel="cluster/x.py") == 0
    src = (
        "import torch\n"
        "def f(x):\n"
        "    return x.double() + x.to(torch.float64).sum()\n"
    )
    assert _count(src, "precision-drift", rel="query/x.py") == 2


def test_precision_explicit_dtype_clean():
    src = (
        "import numpy as np, torch\n"
        "a = np.zeros(4, dtype=np.float64)\n"  # the host f64 fold
        "b = ship(np.zeros(4, dtype=np.float32), 'cuda')\n"
        "c = torch.zeros(3, dtype=torch.float64, device='cpu')\n"
        "d = torch.as_tensor(np.full(3, 0, dtype=np.int32), device='cuda')\n"
    )
    assert _count(src, "precision-drift", rel="ops/x.py") == 0


def test_precision_f64_arrays_shipped():
    assert _count(_torch("f64-shipped"), "precision-drift", rel="ops/x.py") == 2
    src = (
        "import numpy as np\n"
        "def f(v, dev):\n"
        "    w = v.astype(np.float64)\n"
        "    return ship(w, dev)\n"
    )
    assert _count(src, "precision-drift", rel="query/x.py") == 1


# -- rpc-timeout -------------------------------------------------------------


FABRIC = {
    "rpc-transport": (
        "cluster/x.py",
        "class C:\n"
        "    def f(self, addr, env):\n"
        "        return self.transport.call(addr, 'topic', env)\n",
    ),
    "rpc-with-timeout": (
        "cluster/x.py",
        "class C:\n"
        "    def f(self, addr, env):\n"
        "        return self.transport.call(addr, 'topic', env, timeout=5)\n",
    ),
    "rpc-urlopen": (
        "utils/x.py",
        "import urllib.request\n"
        "def fetch(req):\n"
        "    return urllib.request.urlopen(req).read()\n",
    ),
    "rpc-non-transport": (
        "cluster/x.py",
        "class C:\n"
        "    def f(self, cb):\n"
        "        return self.registry.call(cb)\n",
    ),
    "lock-rpc": (
        "cluster/x.py",
        "class C:\n"
        "    def f(self, addr, env):\n"
        "        with self._lock:\n"
        "            return self.transport.call(addr, 't', env, timeout=5)\n",
    ),
    "lock-then-call": (
        "cluster/x.py",
        "class C:\n"
        "    def f(self, addr, env):\n"
        "        with self._lock:\n"
        "            target = self.nodes[addr]\n"
        "        return self.transport.call(target, 't', env, timeout=5)\n",
    ),
    "lock-sleep": (
        "storage/x.py",
        "import time\n"
        "class C:\n"
        "    def f(self):\n"
        "        with self.lock:\n"
        "            time.sleep(1)\n",
    ),
    "retry-hammer": (
        "cluster/x.py",
        "def f(rpc):\n"
        "    while True:\n"
        "        try:\n"
        "            return rpc()\n"
        "        except Exception:\n"
        "            continue\n",
    ),
    "retry-sleep": (
        "cluster/x.py",
        "import time\n"
        "def f(rpc):\n"
        "    while True:\n"
        "        try:\n"
        "            return rpc()\n"
        "        except Exception:\n"
        "            time.sleep(0.5)\n",
    ),
    "retry-bounded-get": (
        "cluster/x.py",
        "import queue\n"
        "def f(q):\n"
        "    while True:\n"
        "        try:\n"
        "            return q.get(timeout=0.2)\n"
        "        except queue.Empty:\n"
        "            continue\n",
    ),
    "retry-rpc-timeout": (
        "cluster/x.py",
        "class C:\n"
        "    def f(self, addr, env):\n"
        "        while True:\n"
        "            try:\n"
        "                return self.transport.call(addr, 't', env, timeout=5)\n"
        "            except Exception:\n"
        "                pass\n",
    ),
    "retry-break": (
        "storage/x.py",
        "def f(q):\n"
        "    while True:\n"
        "        try:\n"
        "            q.pop()\n"
        "        except IndexError:\n"
        "            break\n",
    ),
    "open-bare": (
        "storage/x.py",
        "def f(p):\n    fh = open(p)\n    return fh.read()\n",
    ),
    "open-with": (
        "storage/x.py",
        "def f(p):\n    with open(p) as fh:\n        return fh.read()\n",
    ),
    "open-suppressed": (
        "storage/x.py",
        "def f(p):\n"
        "    # bdlint: disable=resource-hygiene -- cache, closed by owner\n"
        "    fh = open(p)\n"
        "    return fh\n",
    ),
    "open-file-wide": (
        "storage/x.py",
        "# bdlint: disable-file=resource-hygiene\n"
        "a = open('x')\n"
        "b = open('y')\n",
    ),
}


def _fab(name: str, rule: str) -> int:
    rel, src = FABRIC[name]
    return _count(src, rule, rel=rel)


def test_rpc_timeout_transport_call():
    assert _fab("rpc-transport", "rpc-timeout") == 1


def test_rpc_timeout_with_timeout_clean():
    assert _fab("rpc-with-timeout", "rpc-timeout") == 0


def test_rpc_timeout_urlopen():
    assert _fab("rpc-urlopen", "rpc-timeout") == 1


def test_rpc_timeout_non_transport_call_clean():
    assert _fab("rpc-non-transport", "rpc-timeout") == 0


# -- lock-across-rpc ---------------------------------------------------------


def test_lock_across_rpc_flagged():
    assert _fab("lock-rpc", "lock-across-rpc") == 1


def test_lock_then_call_outside_clean():
    assert _fab("lock-then-call", "lock-across-rpc") == 0


def test_lock_across_sleep_flagged():
    assert _fab("lock-sleep", "lock-across-rpc") == 1


# -- retry-backoff -----------------------------------------------------------


def test_retry_without_backoff_flagged():
    assert _fab("retry-hammer", "retry-backoff") == 1


def test_retry_with_sleep_clean():
    assert _fab("retry-sleep", "retry-backoff") == 0


def test_retry_paced_by_bounded_get_clean():
    assert _fab("retry-bounded-get", "retry-backoff") == 0


def test_retry_rpc_own_timeout_is_not_backoff():
    # the rpc-timeout rule mandates timeout= on transport calls; that
    # timeout must NOT count as pacing — connection-refused returns in
    # microseconds and the loop still hammers the peer
    assert _fab("retry-rpc-timeout", "retry-backoff") == 1


def test_retry_break_on_error_clean():
    assert _fab("retry-break", "retry-backoff") == 0


# -- resource-hygiene --------------------------------------------------------


def test_open_outside_with_flagged():
    assert _fab("open-bare", "resource-hygiene") == 1


def test_open_in_with_clean():
    assert _fab("open-with", "resource-hygiene") == 0


def test_open_suppressed_with_reason():
    rel, src = FABRIC["open-suppressed"]
    findings, suppressed = lint_source(src, rel=rel)
    assert not findings
    assert suppressed == 1


# -- engine behaviors --------------------------------------------------------


def test_suppression_survives_blank_line_after_comment():
    # a reflow that inserts a blank line between the suppression comment
    # and its code line must not silently detach the suppression
    src = (
        "from banyandb_tpu_torch.query import measure_exec\n"
        "def f(x):\n"
        "    # bdlint: disable=host-sync -- boundary, documented\n"
        "\n"
        "    return measure_exec.device_get(x)\n"
    )
    findings, suppressed = lint_source(src, rel="query/x.py")
    assert not findings
    assert suppressed == 1


def test_disable_file_suppresses_everywhere():
    rel, src = FABRIC["open-file-wide"]
    findings, suppressed = lint_source(src, rel=rel)
    assert not [f for f in findings if f.rule == "resource-hygiene"]
    assert suppressed == 2


def test_unsuppressed_rule_still_fires():
    src = (
        "from banyandb_tpu_torch.query import measure_exec\n"
        "def f(x):\n"
        "    return measure_exec.device_get(x)  "
        "# bdlint: disable=precision-drift\n"
    )
    findings, _ = lint_source(src, rel="query/x.py")
    assert [f.rule for f in findings] == ["host-sync"]


def test_findings_sorted_and_sarif_2_1_0():
    src = (
        "import torch\n"
        "a = torch.ones(3).double()\n"
        "b = open('x')\n"
        "c = torch.zeros(3).double()\n"
    )
    findings, _ = lint_source(src, rel="query/x.py")
    assert [f.rule for f in findings] == [
        "precision-drift", "resource-hygiene", "precision-drift",
    ]
    assert findings == sorted(findings)
    summary = {"files": 1, "findings": len(findings), "suppressed": 0}
    doc = json.loads(render_json(findings, summary))
    # real SARIF 2.1.0: code-scanning UIs and editors ingest this shape
    assert doc["version"] == "2.1.0" and doc["$schema"].endswith(
        "sarif-schema-2.1.0.json"
    )
    (run,) = doc["runs"]
    driver = run["tool"]["driver"]
    assert driver["name"] == "bdlint"
    rule_ids = [r["id"] for r in driver["rules"]]
    assert "host-sync" in rule_ids and "layering" in rule_ids
    assert all(r["shortDescription"]["text"] for r in driver["rules"])
    assert [r["ruleId"] for r in run["results"]] == [f.rule for f in findings]
    for res, f in zip(run["results"], findings):
        # every result carries a physical location; ruleIndex round-trips
        # into the driver rule table; columns are SARIF 1-based
        loc = res["locations"][0]["physicalLocation"]
        assert loc["artifactLocation"]["uri"] == f.path
        assert loc["region"]["startLine"] == f.line
        assert loc["region"]["startColumn"] == f.col + 1
        assert driver["rules"][res["ruleIndex"]]["id"] == f.rule
    assert run["properties"] == summary
    # serialization is deterministic (stable CI diffing)
    assert render_json(findings, summary) == render_json(findings, summary)


def test_cli_check_mode_and_rule_filter(tmp_path, capsys):
    from banyandb_tpu_torch.lint.__main__ import main

    bad = tmp_path / "banyandb_tpu_torch" / "query"
    bad.mkdir(parents=True)
    (bad / "x.py").write_text("import torch\na = torch.ones(3).double()\n")
    assert main(["--check", str(bad)]) == 1
    # without --check the run is report-only: findings print, exit 0
    assert main([str(bad)]) == 0
    assert main(["--check", "--rules", "host-sync", str(bad)]) == 0
    assert main(["--rules", "nope", str(bad)]) == 2
    assert main(["--only", "nope", str(bad)]) == 2
    capsys.readouterr()
    assert main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert "wp-sync-in-kernel" in listed and "kernel-ops" in listed


def test_generated_pb_trees_skipped(tmp_path):
    pb = tmp_path / "banyandb_tpu_torch" / "api" / "pb"
    pb.mkdir(parents=True)
    (pb / "x_pb2.py").write_text("a = open('x')\n")
    findings, stats = lint_paths([str(tmp_path)])
    assert not findings
    assert stats["files"] == 0


# -- the meta-test: the port's tree is clean ---------------------------------


# The host-sync suppressions of the port: the counterparts of the
# reference's seven result boundaries plus the body of device_get, the
# boundary itself.  path -> count.
HOST_SYNC_SITES = {
    "query/measure_exec.py": 3,  # device_get's wait + two chunk boundaries
    "query/fused_exec.py": 1,
    "query/stream_exec.py": 1,
    "query/precompile.py": 1,
    "parallel/mesh_query.py": 2,
}


def _suppressions(pkg: Path, rule: str) -> dict[str, list[str]]:
    import re

    out: dict[str, list[str]] = {}
    pat = re.compile(rf"#\s*bdlint:\s*disable=[\w,\- ]*\b{re.escape(rule)}\b(.*)")
    for p in sorted(pkg.rglob("*.py")):
        if p.relative_to(pkg).parts[0] == "lint":
            continue  # the linter's own docs show the syntax
        for line in p.read_text().splitlines():
            m = pat.search(line)
            if m:
                out.setdefault(p.relative_to(pkg).as_posix(), []).append(
                    m.group(1)
                )
    return out


def test_tree_is_bdlint_clean():
    import banyandb_tpu_torch

    pkg = Path(banyandb_tpu_torch.__file__).parent
    findings, stats = lint_paths([str(pkg)])
    assert findings == [], "\n".join(f.render() for f in findings)
    # every suppression in the tree is a documented decision; pin the
    # exact count so adding (or dropping) one forces a reviewed edit
    # here: 15 = the 8 host-sync boundaries (HOST_SYNC_SITES) + the six
    # fabric/resource decisions the reference also carries (accesslog's
    # two log handles, the part's per-column handle, the worker pool's
    # log file and parent socket, the liaison's read-failover walk) +
    # the replay soak's query loop (harness/soak.py: a failed query is
    # counted and the next one asked, not retried)
    assert stats["suppressed"] == 15
    assert stats["files"] > 90


def test_host_sync_suppressed_exactly_at_the_boundaries():
    import banyandb_tpu_torch

    pkg = Path(banyandb_tpu_torch.__file__).parent
    sites = _suppressions(pkg, "host-sync")
    assert {k: len(v) for k, v in sites.items()} == HOST_SYNC_SITES
    # each one gives its reason
    assert all(r.strip().startswith("--") and len(r) > 10 for v in sites.values() for r in v)


# -- parity with the reference ----------------------------------------------


def _write_tree(root: Path, pkg: str, files: dict[str, str]) -> Path:
    base = root / pkg
    base.mkdir(parents=True, exist_ok=True)
    (base / "__init__.py").write_text("")
    for rel, src in files.items():
        p = base / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        if not (p.parent / "__init__.py").exists():
            (p.parent / "__init__.py").write_text("")
        p.write_text(src)
    return base


def test_fabric_rules_parity_over_package_trees(tmp_path):
    """The copied fabric family finds the same (rule, relative path,
    line, col) over the same synthetic tree written under each
    package's name."""
    from banyandb_tpu.lint import core as rcore
    from banyandb_tpu.lint import rules_fabric as rfab
    from banyandb_tpu_torch.lint import core as pcore
    from banyandb_tpu_torch.lint import rules_fabric as pfab

    files = {
        f"{rel.split('/')[0]}/{name.replace('-', '_')}.py": src
        for name, (rel, src) in FABRIC.items()
    }
    got = {}
    for pkg, core, rules in (
        ("banyandb_tpu", rcore, rfab.RULES),
        ("banyandb_tpu_torch", pcore, pfab.RULES),
    ):
        base = _write_tree(tmp_path / pkg, pkg, files)
        fs, stats = core.lint_paths([str(base)], rules=list(rules))
        got[pkg] = (
            sorted(
                (f.rule, Path(f.path).relative_to(base).as_posix(), f.line, f.col)
                for f in fs
            ),
            stats["suppressed"],
        )
    assert got["banyandb_tpu"] == got["banyandb_tpu_torch"]
    assert len(got["banyandb_tpu"][0]) == 7


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_torch_rules_flag_every_reference_fixture_on_the_same_line(name):
    from banyandb_tpu.lint import lint_source as ref_lint_source

    rule, rel, jax_src, torch_src = PAIRS[name]
    ref = [f.line for f in ref_lint_source(jax_src, rel=rel)[0] if f.rule == rule]
    port = [f.line for f in lint_source(torch_src, rel=rel)[0] if f.rule == rule]
    assert ref, f"the reference fixture {name} must be flagged"
    assert sorted(port) == sorted(ref)


def test_every_reference_hot_path_fixture_has_a_counterpart():
    """Every fixture of tests/test_lint.py that rules_jax flags appears in
    PAIRS (so the parity test above covers it)."""
    import ast

    from banyandb_tpu.lint import lint_source as ref_lint_source

    tree = ast.parse((REPO / "tests" / "test_lint.py").read_text())
    flagged = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "src" for t in node.targets
        ):
            try:
                src = ast.literal_eval(node.value)
            except ValueError:
                continue
            for rel in ("query/x.py", "ops/x.py"):
                for f in ref_lint_source(src, rel=rel)[0]:
                    if f.rule in ("host-sync", "recompile-hazard", "precision-drift"):
                        flagged.add(src)
    ours = {p[2] for p in PAIRS.values()}
    # the suppression fixtures (flagged only with the comment removed)
    # reuse the device-get pair; every other flagged fixture is a PAIRS key
    missing = {s for s in flagged - ours if "bdlint:" not in s}
    missing -= {
        # the SARIF fixture's precision findings: PAIRS["f64-constructor"]
        "import numpy as np\na = np.zeros(3)\nb = open('x')\nc = np.ones(3)\n",
    }
    assert not missing, missing
