"""wire-fault: every fabric boundary must sit behind a chaos hook.

cluster/faults.py is the package's single fault plane; scale-out tests
drive it to prove the retry/spool/failover machinery.  A boundary the
plane cannot reach is a boundary the chaos suite silently stopped
testing — this analyzer makes that a gate:

1. **RPC transports** — every ``*Transport`` class with a ``call``
   method must invoke ``faults.maybe_fail_rpc`` inside that method (or
   carry a FAULT_TRANSPORT_EXEMPT reason).  New transports are covered
   the day they are written.
2. **Chunked-sync streams** — each SYNC_MODULES module must install
   ``plane_sync_injector`` at least once, so stream-level fault points
   (truncate / flip / stall) stay reachable.
3. **Spool/part disk writes** — a disk-write call (``atomic_write`` /
   ``write_bytes`` / ``write_text`` / ``open(..., "w"/"a"/"x")``) in a
   DISK_SCAN_PREFIXES module must have ``faults.check_disk`` in the
   enclosing function or a transitive caller (3 hops), or carry a
   DISK_EXEMPT reason — the gate the cold tier's remote reads will be
   built under (ROADMAP item 2).
"""

from __future__ import annotations

import ast
from typing import Optional

from banyandb_tpu_torch.lint.core import Finding, dotted_name
from banyandb_tpu_torch.lint.whole_program.callgraph import Program, _walk_own

from banyandb_tpu_torch.lint.wire import wire_config as _cfg

RULE = "wire-fault"

_DISK_WRITE_ATTRS = ("atomic_write", "write_bytes", "write_text")


def _calls_matching(info, needle: str) -> bool:
    for node in _walk_own(info.node):
        if isinstance(node, ast.Call):
            name = dotted_name(node.func) or ""
            if needle in name:
                return True
    return False


def _reverse_edges(program: Program) -> dict[str, set[str]]:
    rev: dict[str, set[str]] = {}
    for qual, info in program.functions.items():
        for site in info.calls:
            if site.callee:
                rev.setdefault(site.callee, set()).add(qual)
    return rev


def _covered(
    program: Program,
    rev: dict[str, set[str]],
    qual: str,
    needle: str,
    max_depth: int = 3,
) -> bool:
    """True when ``qual`` or a transitive caller (within max_depth)
    calls something matching ``needle``."""
    seen: set[str] = set()
    work = [(qual, 0)]
    while work:
        q, depth = work.pop()
        if q in seen:
            continue
        seen.add(q)
        info = program.functions.get(q)
        if info is not None and _calls_matching(info, needle):
            return True
        if depth < max_depth:
            for caller in rev.get(q, ()):
                work.append((caller, depth + 1))
    return False


def _disk_write_sites(info) -> list[tuple[str, int]]:
    sites: list[tuple[str, int]] = []
    for node in _walk_own(info.node):
        if not isinstance(node, ast.Call):
            continue
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _DISK_WRITE_ATTRS
        ):
            sites.append((node.func.attr, node.lineno))
        elif (
            isinstance(node.func, ast.Name)
            and node.func.id == "open"
            and len(node.args) >= 2
            and isinstance(node.args[1], ast.Constant)
            and isinstance(node.args[1].value, str)
            and any(m in node.args[1].value for m in ("w", "a", "x"))
        ):
            sites.append(("open", node.lineno))
    return sites


def analyze_fault_sites(
    program: Program,
    *,
    transport_exempt: Optional[dict[str, str]] = None,
    disk_prefixes: Optional[tuple[str, ...]] = None,
    disk_exempt: Optional[dict[tuple[str, str], str]] = None,
    sync_modules: Optional[tuple[str, ...]] = None,
    baseline_path: str = "<wire-config>",
) -> list[Finding]:
    transport_exempt = (
        _cfg.FAULT_TRANSPORT_EXEMPT
        if transport_exempt is None
        else transport_exempt
    )
    disk_prefixes = (
        _cfg.DISK_SCAN_PREFIXES if disk_prefixes is None else disk_prefixes
    )
    disk_exempt = _cfg.DISK_EXEMPT if disk_exempt is None else disk_exempt
    sync_modules = _cfg.SYNC_MODULES if sync_modules is None else sync_modules
    findings: list[Finding] = []

    # 1. transports: every *Transport.call behind maybe_fail_rpc
    for qual, info in sorted(program.functions.items()):
        if info.cls is None or not info.cls.endswith("Transport"):
            continue
        if qual.split(".")[-1] != "call" or qual.rsplit(".", 1)[0] != (
            f"{info.module}:{info.cls}"
        ):
            continue
        key = f"{info.module}:{info.cls}"
        if key in transport_exempt:
            continue
        if not _calls_matching(info, "maybe_fail_rpc"):
            findings.append(
                Finding(
                    path=info.path,
                    line=info.node.lineno,
                    col=0,
                    rule=RULE,
                    message=(
                        f"transport {info.cls}.call carries RPCs without a "
                        f"faults.maybe_fail_rpc hook — the chaos plane "
                        f"cannot reach this wire; hook it or add a "
                        f"FAULT_TRANSPORT_EXEMPT reason"
                    ),
                )
            )

    # 2. chunked-sync streams: plane_sync_injector present per module
    for mod in sync_modules:
        mod_fns = [i for i in program.functions.values() if i.module == mod]
        if not mod_fns:
            continue
        if not any(_calls_matching(i, "plane_sync_injector") for i in mod_fns):
            anchor = min(mod_fns, key=lambda i: i.node.lineno)
            findings.append(
                Finding(
                    path=anchor.path,
                    line=1,
                    col=0,
                    rule=RULE,
                    message=(
                        f"sync module {mod} installs no plane_sync_injector "
                        f"— stream-level fault points (truncate/flip/stall) "
                        f"are unreachable"
                    ),
                )
            )

    # 3. spool/part disk writes behind check_disk
    rev = _reverse_edges(program)
    for qual, info in sorted(program.functions.items()):
        if not info.module.startswith(disk_prefixes):
            continue
        sites = _disk_write_sites(info)
        if not sites:
            continue
        fn = qual.split(":", 1)[1]
        if any(
            info.module == mod and fn.endswith(suffix)
            for (mod, suffix) in disk_exempt
        ):
            continue
        if _covered(program, rev, qual, "check_disk"):
            continue
        writer, line = sites[0]
        findings.append(
            Finding(
                path=info.path,
                line=line,
                col=0,
                rule=RULE,
                message=(
                    f"disk-write boundary ({writer}) in {fn} has no "
                    f"faults.check_disk on its path — ENOSPC/short-write "
                    f"chaos cannot reach it; add a check_disk site or a "
                    f"reasoned DISK_EXEMPT entry"
                ),
            )
        )

    # stale exemption hygiene: every exempt key must still match a live
    # disk-writing function / transport
    live_transport = {
        f"{i.module}:{i.cls}"
        for i in program.functions.values()
        if i.cls and i.cls.endswith("Transport")
    }
    for key in sorted(set(transport_exempt) - live_transport):
        findings.append(
            Finding(
                path=baseline_path,
                line=1,
                col=0,
                rule=RULE,
                message=(
                    f"stale FAULT_TRANSPORT_EXEMPT entry {key!r}: no such "
                    f"transport class exists — delete the entry"
                ),
            )
        )
    for (mod, suffix), _reason in sorted(disk_exempt.items()):
        hit = any(
            i.module == mod
            and q.split(":", 1)[1].endswith(suffix)
            and _disk_write_sites(i)
            for q, i in program.functions.items()
        )
        if not hit and any(i.module == mod for i in program.functions.values()):
            findings.append(
                Finding(
                    path=baseline_path,
                    line=1,
                    col=0,
                    rule=RULE,
                    message=(
                        f"stale DISK_EXEMPT entry ({mod!r}, {suffix!r}): no "
                        f"matching disk-write site remains — delete the "
                        f"entry"
                    ),
                )
            )
    return findings
