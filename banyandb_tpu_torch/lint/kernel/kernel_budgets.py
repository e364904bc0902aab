"""kernel-budget: the port's checked-in per-signature budget table (the
counterpart of banyandb_tpu/lint/kernel/kernel_budgets.py).

This file IS the performance contract the kernel audit enforces.  One
row per audited signature; every column is a *measured* fact of the
port (dispatch.py / op_audit.py / lowering.py), none copied from the
JAX table (whose dispatch counts describe one XLA program per
part-batch, not a sequence of CUDA launches), ratcheted with the
shared lint/core mechanics:

- measured **above** budget  -> regression finding;
- measured **below** budget  -> the entry is stale (too loose) and fails
  until tightened, so an improvement is locked in the moment it lands.

Columns (None = not measured for that row's kind):

- ``ops``: ATen ops one call of the signature's function dispatches on
  the device, views and allocations left out (lowering.py) — the
  launch estimate without a card.  The card's kernel count is recorded
  beside it by chip_smoke.py and pinned per row by
  tests/test_torch_cuda.py; it is not this column.
- ``hand_launches``/``gets``/``puts``: Hopper kernel wrapper calls,
  batched device->host gets and host->device ships per scenario run
  (dispatch.py; measure/stream scenarios are one part-batch, one scan
  chunk except the multi-chunk tripwires).  The ql rows pin the
  trace/property executors to ZERO device work.  chip_smoke.py holds
  the card's counts of the same scenarios to these three columns.
- ``widest``: widest itemsize of any non-index tensor an op produces
  (4 = the 32-bit device contract; 8 would mean a 64-bit leak).
- ``index64``: int64 index operands the function makes (PyTorch's
  index_put_/scatter_reduce_/gathers/sort take or give int64 indices).
- ``syncs``: host syncs inside the function (0: none may appear).
- ``bytes_class``: power-of-two class (``int.bit_length``) of the bytes
  the counted ops read and write.
- ``collectives``: cross-slot combines; single-device plans carry none,
  the mesh steps exactly count + sums + min + max.

Legitimately changing a row: land the change, run
``run_kernel_audit()`` and copy the measured value the finding reports
into the row — tighter is always allowed, looser must be argued in
review.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from banyandb_tpu_torch.lint.core import (
    Finding,
    ratchet_value,
    stale_entry_finding,
)

RULE = "kernel-budget"


@dataclass(frozen=True)
class KernelBudget:
    """One signature's budget row (None = column not measured)."""

    ops: Optional[int] = None
    hand_launches: Optional[int] = None
    gets: Optional[int] = None
    puts: Optional[int] = None
    widest: Optional[int] = None
    index64: Optional[int] = None
    syncs: Optional[int] = None
    bytes_class: Optional[int] = None
    collectives: Optional[int] = None


def _b(ops=None, hand_launches=None, gets=None, puts=None, widest=None,
       index64=None, syncs=None, bytes_class=None, collectives=None):
    return KernelBudget(ops, hand_launches, gets, puts, widest, index64,
                        syncs, bytes_class, collectives)


# fmt: off
BUDGETS: dict[str, KernelBudget] = {
    # the builtin measure plan matrix, staged: one per-chunk call, one
    # batched get per scan chunk; puts = padded chunk columns + predicate
    # values + the two histogram scalars; one fused_group_multi call
    "measure/flat-count": _b(ops=12, hand_launches=1, gets=1, puts=7, widest=4, index64=1, syncs=0, bytes_class=20, collectives=0),
    "measure/group-eq-lut": _b(ops=33, hand_launches=1, gets=1, puts=11, widest=4, index64=4, syncs=0, bytes_class=21, collectives=0),
    "measure/percentile-hist": _b(ops=24, hand_launches=1, gets=1, puts=8, widest=4, index64=2, syncs=0, bytes_class=24, collectives=0),
    "measure/or-expr": _b(ops=12, hand_launches=1, gets=1, puts=10, widest=4, index64=0, syncs=0, bytes_class=20, collectives=0),
    "measure/topn-dashboard": _b(ops=27, hand_launches=1, gets=1, puts=10, widest=4, index64=2, syncs=0, bytes_class=24, collectives=0),
    # the staged loop in the compressed ship form (a row family the
    # reference's table has not): each 1-D narrow column widens through
    # widen_narrow, so hand_launches = 1 + the narrow tag/field columns
    "measure+decode/flat-count": _b(hand_launches=2, gets=1, puts=7),
    "measure+decode/group-eq-lut": _b(hand_launches=4, gets=1, puts=14),
    "measure+decode/percentile-hist": _b(hand_launches=2, gets=1, puts=10),
    "measure+decode/or-expr": _b(hand_launches=3, gets=1, puts=12),
    "measure+decode/topn-dashboard": _b(hand_launches=4, gets=1, puts=13),
    # fused whole-plan twins (query/fused_exec): one batched get per
    # part-batch; puts the staged column count (stacked ships)
    "fused/flat-count": _b(ops=16, hand_launches=1, gets=1, puts=7, widest=4, index64=1, syncs=0, bytes_class=20, collectives=0),
    "fused/group-eq-lut": _b(ops=39, hand_launches=1, gets=1, puts=11, widest=4, index64=4, syncs=0, bytes_class=21, collectives=0),
    "fused/percentile-hist": _b(ops=29, hand_launches=1, gets=1, puts=8, widest=4, index64=2, syncs=0, bytes_class=24, collectives=0),
    "fused/or-expr": _b(ops=14, hand_launches=1, gets=1, puts=10, widest=4, index64=0, syncs=0, bytes_class=20, collectives=0),
    "fused/topn-dashboard": _b(ops=33, hand_launches=1, gets=1, puts=10, widest=4, index64=2, syncs=0, bytes_class=24, collectives=0),
    # the staging tripwire: a 2-chunk part-batch, still 1 get (dispatch
    # columns only: its bucket is synthesized per run)
    "fused/multi-chunk": _b(hand_launches=2, gets=1, puts=7),
    # device-side decode twins (BYDB_DEVICE_DECODE=1): the compressed
    # ship form still costs one batched get; puts grow by the LUT and
    # ordinal ships; the [C, nrows] batch widens with plain conversions
    "fused+decode/flat-count": _b(ops=17, hand_launches=1, gets=1, puts=7, widest=4, index64=1, syncs=0, bytes_class=20, collectives=0),
    "fused+decode/group-eq-lut": _b(ops=54, hand_launches=1, gets=1, puts=14, widest=4, index64=8, syncs=0, bytes_class=22, collectives=0),
    "fused+decode/percentile-hist": _b(ops=36, hand_launches=1, gets=1, puts=10, widest=4, index64=4, syncs=0, bytes_class=24, collectives=0),
    "fused+decode/or-expr": _b(ops=22, hand_launches=1, gets=1, puts=12, widest=4, index64=2, syncs=0, bytes_class=21, collectives=0),
    "fused+decode/topn-dashboard": _b(ops=48, hand_launches=1, gets=1, puts=13, widest=4, index64=6, syncs=0, bytes_class=25, collectives=0),
    "fused+decode/multi-chunk": _b(hand_launches=2, gets=1, puts=7),
    # the fused chunked-scan mesh step: count + sums + min + max combines
    "fused/dist-step": _b(ops=66, widest=4, index64=4, syncs=0, bytes_class=19, collectives=4),
    # stream retrieval mask: whole bool mask in one get; the narrow twin
    # (i8 source codes widened on the device) has the same shape
    "stream/mask-eq-in": _b(ops=4, hand_launches=0, gets=1, puts=3, widest=4, index64=0, syncs=0, bytes_class=20, collectives=0),
    "stream+decode/mask-eq-in": _b(hand_launches=0, gets=1, puts=3),
    # shared ops reductions every plan lowers onto (op columns only)
    "ops/group_reduce": _b(ops=11, widest=4, index64=1, syncs=0, bytes_class=20, collectives=0),
    "ops/group_histogram": _b(ops=13, widest=4, index64=1, syncs=0, bytes_class=21, collectives=0),
    # the legacy mesh step: count + sums + min + max combines
    "parallel/dist-step": _b(ops=24, widest=4, index64=3, syncs=0, bytes_class=18, collectives=4),
    # ql trace/property executors are host-only BY CONTRACT: zero device
    # work — a device leg appearing here is a bug
    "ql/trace": _b(hand_launches=0, gets=0, puts=0),
    "ql/property": _b(hand_launches=0, gets=0, puts=0),
}
# fmt: on


def budget_path() -> str:
    from banyandb_tpu_torch.lint.whole_program.plan_audit import _rel_path

    return _rel_path(__file__)


def audit_budgets(
    op_cols: Optional[dict] = None,
    traces: Optional[dict] = None,
    lowered: Optional[dict] = None,
    budgets: Optional[dict] = None,
    anchors: Optional[dict] = None,
    failed: Optional[set] = None,
) -> list[Finding]:
    """Compare measured columns against the budget table.

    Any argument left None means that analyzer did not run (``fast``
    skips lowering) and its columns are not judged.  Row-set agreement
    is judged from the measurements that DID run: a measured signature
    with no row fails (new kernels ship with a budget), a row no
    measurement covers fails as stale.  ``failed`` names signatures
    whose measurement itself errored — they already carry a failure
    finding and are excluded from both the column ratchet and the
    stale-row check (a failed measurement is not an improvement).
    """
    from banyandb_tpu_torch.lint.kernel.dispatch import measured_columns

    budgets = BUDGETS if budgets is None else budgets
    bpath = budget_path()
    anchors = anchors or {}
    failed = failed or set()

    measured: dict[str, dict] = {}
    for name, cols in (op_cols or {}).items():
        measured.setdefault(name, {}).update(cols)
    for name, t in (traces or {}).items():
        if not t.error:
            measured.setdefault(name, {}).update(measured_columns(t))
    for name, cols in (lowered or {}).items():
        if cols is not None:
            measured.setdefault(name, {}).update(cols)
    for name in failed:
        measured.pop(name, None)

    findings: list[Finding] = []
    for name in sorted(set(measured) - set(budgets)):
        findings.append(
            Finding(
                path=anchors.get(name, (bpath, 1))[0],
                line=anchors.get(name, (bpath, 1))[1],
                col=0,
                rule=RULE,
                message=(
                    f"[{name}] audited signature has no budget row; add "
                    "one to lint/kernel/kernel_budgets.py with the "
                    "measured values (the table is total)"
                ),
            )
        )
    for key in sorted(set(budgets) - set(measured) - failed):
        findings.append(
            stale_entry_finding(
                key, rule=RULE, path=bpath, what="the audited signature"
            )
        )

    for name in sorted(measured):
        row = budgets.get(name)
        if row is None:
            continue  # already reported above
        cols = measured[name]
        path, line = anchors.get(name, (bpath, 1))
        for column, value in sorted(cols.items()):
            budget = getattr(row, column)
            if budget is None:
                continue
            findings += ratchet_value(
                name,
                column,
                value,
                budget,
                rule=RULE,
                path=path,
                line=line,
                budget_path=bpath,
                regression_hint=_HINTS.get(column, ""),
            )
    return findings


_HINTS = {
    "ops": "every extra op is one more launch per part-batch",
    "hand_launches": "the hand kernels' routing changed",
    "gets": "result transfers must stay batched (one device_get a batch)",
    "puts": "extra host->device ships grow the pad/ship stage",
    "widest": "64-bit values double memory traffic; keep device math 32-bit",
    "index64": "a new int64 index operand: prefer one the plan already has",
    "syncs": "a host sync stalls the device once per call",
    "bytes_class": "bytes moved per part-batch doubled a class",
    "collectives": "the cross-slot combine plan changed",
}


# -- obs-plane export --------------------------------------------------------


def publish_to_meter(meter=None) -> int:
    """Export the static launch budgets as gauges
    (``kernel_launch_budget{signature=...}``: the ``ops`` column) so
    the obs plane can be cross-checked against the prediction.
    -> rows published."""
    if meter is None:
        from banyandb_tpu_torch.obs.metrics import global_meter

        meter = global_meter()
    n = 0
    for name, row in sorted(BUDGETS.items()):
        if row.ops is None:
            continue
        meter.gauge_set(
            "kernel_launch_budget",
            float(row.ops),
            labels={"signature": name},
        )
        n += 1
    return n


def dispatch_budget(kind: str = "measure") -> int:
    """The static per-part-batch launch estimate for a signature family
    (max ``ops`` over its rows)."""
    vals = [
        row.ops
        for name, row in BUDGETS.items()
        if name.startswith(kind + "/") and row.ops is not None
    ]
    if not vals:
        raise KeyError(f"no launch budgets for kind {kind!r}")
    return max(vals)
