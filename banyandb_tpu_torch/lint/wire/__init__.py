"""bdwire: whole-program wire-contract & fault-coverage audit.

The fourth whole-program family on the bdlint engine (after layering /
sync / shared-state and the bdjit kernel audit).  Seven analyzers over
the shared parsed package + callgraph, each diffing discovered facts
against the checked-in policy in wire_config.py — drift in either
direction is a finding:

- ``wire-topic``     role/topic exhaustiveness: every client-invoked bus
                     topic served on every target role; the golden
                     matrix (EXPECTED_MATRIX) cannot drift
- ``wire-kind``      the error/shed/deadline/stale_epoch taxonomy:
                     vocabulary, per-transport consistency, classifier
                     switch exhaustiveness
- ``wire-envelope``  producer/consumer field matching per envelope
                     plane; write-only and silent-default fields
- ``wire-fault``     every RPC transport, chunked-sync stream and
                     spool/part disk write behind a cluster/faults.py
                     hook
- ``wire-retry``     every TransportError catch reaches a
                     retry/spool/shed path, never a bare swallow
- ``wire-envflag``   all BYDB_* reads through utils/envflag + the FLAGS
                     registry + docs/flags.md, cross-checked both ways
- ``wire-obs``       instrument names/label sets vs OBS_CONTRACT and
                     docs/observability.md

Findings reuse bdlint's Finding/suppression machinery (``# bdlint:
disable=wire-<x> -- reason``); the accepted/exempt tables in
wire_config.py are the family's ratchets — every entry carries its
reviewed reason and stale entries fail, so the tables only shrink.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

from banyandb_tpu_torch.lint.core import Finding

WIRE_RULES = (
    ("wire-topic", "bus topic invoked against a role with no handler"),
    ("wire-kind", "wire-kind taxonomy drift or non-exhaustive classifier"),
    ("wire-envelope", "envelope field write-only or read with silent default"),
    ("wire-fault", "fabric boundary unreachable by the cluster/faults plane"),
    ("wire-retry", "retryable rejection caught without a recovery path"),
    ("wire-envflag", "BYDB_* flag outside envflag/FLAGS/docs registry"),
    ("wire-obs", "instrument outside the obs contract or label-set drift"),
)


def run_wire(
    program,
    trees: dict,
    pkg_root: Optional[Path] = None,
) -> tuple[list[Finding], dict]:
    """Run the bdwire family -> (findings, stats).

    The checked-in wire_config tables name banyandb_tpu_torch quals; on a
    foreign package (the seeded trees the whole-program meta-tests
    build) none of them resolve, so the family is skipped outright —
    seeded wire tests drive the analyzers directly with injected
    config.
    """
    from banyandb_tpu_torch.lint.wire import wire_config as _cfg

    is_home = any(
        m == _cfg.PKG or m.startswith(_cfg.PKG + ".") for m in trees
    )
    if not is_home:
        return [], {"wire_topics": 0, "wire_kind_sites": 0}

    from banyandb_tpu_torch.lint.wire.envelopes import analyze_envelopes
    from banyandb_tpu_torch.lint.wire.envregistry import analyze_envflags
    from banyandb_tpu_torch.lint.wire.fault_sites import analyze_fault_sites
    from banyandb_tpu_torch.lint.wire.kinds import analyze_kinds, collect_kind_sites
    from banyandb_tpu_torch.lint.wire.obs_contract import analyze_obs
    from banyandb_tpu_torch.lint.wire.retryable import analyze_retryable
    from banyandb_tpu_torch.lint.wire.topics import analyze_topics, role_topic_matrix

    cfg_path = str(Path(__file__).parent / "wire_config.py")
    repo_root = Path(pkg_root).parent if pkg_root is not None else None

    findings: list[Finding] = []
    findings += analyze_topics(program, trees, baseline_path=cfg_path)
    findings += analyze_kinds(program, baseline_path=cfg_path)
    findings += analyze_envelopes(program, baseline_path=cfg_path)
    findings += analyze_fault_sites(program, baseline_path=cfg_path)
    findings += analyze_retryable(program, baseline_path=cfg_path)
    findings += analyze_envflags(trees, repo_root)
    findings += analyze_obs(trees, repo_root)
    # callgraph paths arrive as Path objects; Finding sorts path-first,
    # so normalize to str before the engine merges families
    findings = [
        dataclasses.replace(f, path=str(f.path)) for f in findings
    ]

    matrix = role_topic_matrix(program, trees)
    topics: set[str] = set()
    for served in matrix.values():
        topics.update(served)
    stats = {
        "wire_topics": len(topics),
        "wire_kind_sites": len(
            collect_kind_sites(program, error_classes=_cfg.ERROR_CLASSES)
        ),
    }
    return findings, stats
