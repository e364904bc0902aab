"""kernel-dispatch: count host->device ships, device->host gets and
hand-kernel calls per plan signature by driving the REAL executor entry
paths (the counterpart of banyandb_tpu/lint/kernel/dispatch.py).

The reference runs the executors on a stub device.  The port counts at
its own boundaries instead, with counting pass-throughs that are
restored on exit:

- **puts**   ``measure_exec.ship``: every host->device copy of the
             measure executors (padded chunk columns, the remap LUTs,
             predicate values, the histogram scalars) and of the
             stream mask (columns, in-sets);
- **gets**   ``measure_exec.device_get``: the batched device->host
             result transfer (one per staged chunk, one per fused
             part-batch, one per stream mask);
- **hand_launches**  calls of the Hopper kernel wrappers
             (``ops/hopper_kernels.fused_group_multi``, ``widen_narrow``,
             ``prefix_sum_narrow``).  A wrapper is counted where it is
             called, not where it launches, so a CPU run (each wrapper
             takes its plain version) counts what the card launches:
             the executors route to the wrappers by shape, never by
             device.

The per-signature functions are wrapped too, to record the signatures
the executor actually resolved: each measure/stream scenario is
synthesized so the executor resolves EXACTLY the builtin precompile
signature (dict sizes pin the radices, row counts pin the scan bucket)
— signature drift between what production queries run and what the
registry warms and audits is itself a finding.  The ql trace/property
executors are host-only by design: their budget is zero of each.

The scenarios run on the CPU here (``device="cpu"``) and on the card in
chip_smoke.py (``device="cuda"``, under ``torch.profiler``), held to
the same rows of kernel_budgets.BUDGETS.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np

from banyandb_tpu_torch.lint.core import Finding

RULE = "kernel-dispatch"

T0 = 1_700_000_000_000

# the Hopper kernel wrappers the executors call by module attribute
HAND_KERNELS = ("fused_group_multi", "widen_narrow", "prefix_sum_narrow")


class Counters:
    """Event sinks of one scenario (list appends are GIL-atomic: the
    prefetch worker ships chunks while the main thread runs them)."""

    def __init__(self):
        self.dispatches: list[tuple[str, object]] = []  # (kind, spec)
        self.gets: list[int] = []
        self.puts: list[int] = []
        self.hand: list[str] = []


@dataclass(frozen=True)
class DispatchTrace:
    """Measured ship/get/launch profile of one scenario."""

    name: str
    kind: str  # measure | stream | ql
    dispatches: int  # calls of the per-signature function
    gets: int
    puts: int
    hand_launches: int
    specs: tuple  # plan signatures the executor actually resolved
    builtin: object = None  # the precompile-registry signature expected
    path: str = ""
    line: int = 1
    error: str = ""
    by_kernel: tuple = ()  # ((wrapper name, calls), ...)


def _counting_builder(real_build: Callable, counters: Counters, kind: str):
    """A function builder whose functions record (kind, spec) per call
    and run the real function."""

    def build(spec):
        real = real_build(spec)

        def counted(*args, **kwargs):
            counters.dispatches.append((kind, spec))
            return real(*args, **kwargs)

        return counted

    return build


@contextlib.contextmanager
def counting():
    """Wrap the executors' boundaries with counting pass-throughs;
    yields the Counters.  Scoped and restoring: the precompile registry
    is swapped for a throwaway so the audit never pollutes process
    state."""
    from banyandb_tpu_torch.ops import hopper_kernels
    from banyandb_tpu_torch.query import (
        fused_exec,
        measure_exec,
        precompile,
        stream_exec,
    )

    counters = Counters()
    real_ship = measure_exec.ship
    real_get = measure_exec.device_get

    def counting_ship(a, device):
        counters.puts.append(1)
        return real_ship(a, device)

    def counting_get(tree):
        counters.gets.append(1)
        return real_get(tree)

    def counting_kernel(name, real):
        def call(*args, **kwargs):
            counters.hand.append(name)
            return real(*args, **kwargs)

        return call

    patches = [
        (measure_exec, "ship", counting_ship),
        (measure_exec, "device_get", counting_get),
        (measure_exec, "_build_kernel",
         _counting_builder(measure_exec._build_kernel, counters, "measure")),
        (fused_exec, "_build_kernel",
         _counting_builder(fused_exec._build_kernel, counters, "fused")),
        (stream_exec, "_build_kernel",
         _counting_builder(stream_exec._build_kernel, counters, "stream_mask")),
        (precompile, "default_registry",
         lambda r=precompile.PrecompileRegistry(): r),
    ] + [
        (hopper_kernels, k, counting_kernel(k, getattr(hopper_kernels, k)))
        for k in HAND_KERNELS
    ]
    saved = [(m, a, getattr(m, a)) for m, a, _ in patches]
    try:
        for m, a, v in patches:
            setattr(m, a, v)
        yield counters
    finally:
        for m, a, v in saved:
            setattr(m, a, v)


# -- scenario synthesis ------------------------------------------------------


def _int_bytes(i: int) -> bytes:
    return i.to_bytes(8, "little", signed=True)


def _source(n: int, step: int, tags: dict, fields: dict):
    """One synthetic ColumnData: distinct (series, ts) per row so version
    dedup keeps every row, dictionaries sized exactly to pin radices."""
    from banyandb_tpu_torch.storage.part import ColumnData

    return ColumnData(
        ts=T0 + np.arange(n, dtype=np.int64) * step,
        series=np.arange(n, dtype=np.int64) % 64,
        version=np.ones(n, dtype=np.int64),
        tags={t: codes for t, (_vals, codes) in tags.items()},
        fields={f: a for f, a in fields.items()},
        dicts={t: vals for t, (vals, _codes) in tags.items()},
    )


def _measure_schema(tags, fields):
    from banyandb_tpu_torch.api.schema import (
        Entity,
        FieldSpec,
        Measure,
        TagSpec,
    )

    return Measure(
        group="g",
        name="m",
        tags=tuple(TagSpec(n, t) for n, t in tags),
        fields=tuple(FieldSpec(n, t) for n, t in fields),
        entity=Entity((tags[0][0],)),
    )


def _measure_scenarios(device):
    """(name, builtin PlanSpec, runner) per builtin measure plan.  Each
    runner drives compute_partials so the resolved PlanSpec must equal
    the precompile registry's builtin signature."""
    from banyandb_tpu_torch.api.model import (
        Aggregation,
        Condition,
        GroupBy,
        LogicalExpression,
        QueryRequest,
        TimeRange,
        Top,
    )
    from banyandb_tpu_torch.api.schema import FieldType, TagType
    from banyandb_tpu_torch.query import precompile
    from banyandb_tpu_torch.query.measure_exec import compute_partials

    builtins = dict(precompile.builtin_plans())
    rng = np.random.default_rng(7)

    def svc_dict(k: int):
        vals = [b"s%04d" % i for i in range(k)]
        return vals

    def run_flat():
        n = 8192
        m = _measure_schema(
            [("svc", TagType.STRING)], [("v", FieldType.INT)]
        )
        src = _source(
            n,
            1,
            {"svc": (svc_dict(4), rng.integers(0, 4, n).astype(np.int32))},
            {"v": rng.integers(0, 100, n).astype(np.float64)},
        )
        req = QueryRequest(
            ("g",), "m", TimeRange(T0, T0 + n), field_projection=("v",)
        )
        compute_partials(m, req, [src], device=device)

    def run_grouped():
        n = 8192
        m = _measure_schema(
            [("svc", TagType.STRING), ("region", TagType.INT)],
            [("v", FieldType.INT)],
        )
        src = _source(
            n,
            1,
            {
                "svc": (svc_dict(8), rng.integers(0, 8, n).astype(np.int32)),
                "region": (
                    [_int_bytes(i) for i in range(4)],
                    rng.integers(0, 4, n).astype(np.int32),
                ),
            },
            {"v": rng.integers(0, 100, n).astype(np.float64)},
        )
        req = QueryRequest(
            ("g",),
            "m",
            TimeRange(T0, T0 + n),
            criteria=LogicalExpression(
                "and",
                Condition("svc", "eq", "s0003"),
                Condition("region", "le", 2),
            ),
            group_by=GroupBy(("svc", "region")),
            field_projection=("v",),
        )
        compute_partials(m, req, [src], device=device)

    def run_pct():
        n = 65536
        # ts span > 2^31 ms: long-range percentile dashboards run with
        # scan-order tracking off (int32 offsets would wrap), which is
        # exactly the builtin percentile-hist signature shape
        step = 32769
        m = _measure_schema(
            [("svc", TagType.STRING)], [("lat", FieldType.FLOAT)]
        )
        src = _source(
            n,
            step,
            {"svc": (svc_dict(16), rng.integers(0, 16, n).astype(np.int32))},
            {"lat": rng.random(n).astype(np.float64) * 100},
        )
        req = QueryRequest(
            ("g",),
            "m",
            TimeRange(T0, T0 + n * step + 1),
            group_by=GroupBy(("svc",)),
            agg=Aggregation("percentile", "lat", quantiles=(0.5,)),
        )
        compute_partials(m, req, [src], device=device)

    def run_or():
        n = 8192
        m = _measure_schema(
            [("svc", TagType.STRING)], [("v", FieldType.INT)]
        )
        src = _source(
            n,
            1,
            {"svc": (svc_dict(8), rng.integers(0, 8, n).astype(np.int32))},
            {"v": rng.integers(0, 100, n).astype(np.float64)},
        )
        req = QueryRequest(
            ("g",),
            "m",
            TimeRange(T0, T0 + n),
            criteria=LogicalExpression(
                "or",
                Condition(
                    "svc", "in", ("s0000", "s0001", "s0002", "s0003")
                ),
                Condition("svc", "eq", "s0000"),
            ),
            agg=Aggregation("sum", "v"),
        )
        compute_partials(m, req, [src], device=device)

    def run_topn():
        n = 65536
        m = _measure_schema(
            [("svc", TagType.STRING), ("region", TagType.STRING)],
            [("value", FieldType.INT)],
        )
        src = _source(
            n,
            1,
            {
                "svc": (
                    svc_dict(1024),
                    rng.integers(0, 1024, n).astype(np.int32),
                ),
                "region": (
                    [b"r%d" % i for i in range(8)],
                    rng.integers(0, 8, n).astype(np.int32),
                ),
            },
            {"value": rng.integers(0, 100, n).astype(np.float64)},
        )
        req = QueryRequest(
            ("g",),
            "m",
            TimeRange(T0, T0 + n),
            criteria=Condition("region", "ne", "r0"),
            group_by=GroupBy(("svc",)),
            top=Top(10, "value"),
        )
        compute_partials(m, req, [src], device=device)

    return [
        ("measure/flat-count", builtins["measure/flat-count"], run_flat),
        ("measure/group-eq-lut", builtins["measure/group-eq-lut"], run_grouped),
        ("measure/percentile-hist", builtins["measure/percentile-hist"], run_pct),
        ("measure/or-expr", builtins["measure/or-expr"], run_or),
        ("measure/topn-dashboard", builtins["measure/topn-dashboard"], run_topn),
    ]


def _multichunk_scenario(device):
    """fused/multi-chunk: a part-batch spanning SEVERAL scan chunks must
    still cost exactly ONE batched get on the fused path — the tripwire
    that fails the moment per-chunk staging creeps back into the fused
    executor."""
    from banyandb_tpu_torch.api.model import QueryRequest, TimeRange
    from banyandb_tpu_torch.api.schema import FieldType, TagType

    def run():
        from banyandb_tpu_torch.query import measure_exec
        from banyandb_tpu_torch.query.measure_exec import compute_partials

        n = 8192
        rng = np.random.default_rng(5)
        m = _measure_schema(
            [("svc", TagType.STRING)], [("v", FieldType.INT)]
        )
        src = _source(
            n,
            1,
            {
                "svc": (
                    [b"s%04d" % i for i in range(4)],
                    rng.integers(0, 4, n).astype(np.int32),
                )
            },
            {"v": rng.integers(0, 100, n).astype(np.float64)},
        )
        req = QueryRequest(
            ("g",), "m", TimeRange(T0, T0 + n), field_projection=("v",)
        )
        saved = measure_exec.SCAN_CHUNK
        measure_exec.SCAN_CHUNK = 4096  # n=8192 -> a 2-chunk part-batch
        try:
            compute_partials(m, req, [src], device=device)
        finally:
            measure_exec.SCAN_CHUNK = saved

    return run


def _stream_scenario(device, narrow: bool = False):
    """The stream retrieval-mask scenario; ``narrow=True`` feeds the
    source at stored i8 code width (the device-decode read path,
    models/stream narrow_codes) so the widen-on-device ship form is
    budget-audited alongside the dense one."""
    from banyandb_tpu_torch.api.model import Condition
    from banyandb_tpu_torch.query import precompile, stream_exec

    builtin = dict(precompile.builtin_masks())["stream/mask-eq-in"]
    code_dtype = np.int8 if narrow else np.int32

    def run():
        n = 32768
        rng = np.random.default_rng(9)
        src = _source(
            n,
            1,
            {
                "svc": (
                    [b"a", b"b"],
                    rng.integers(0, 2, n).astype(code_dtype),
                ),
                "region": (
                    [b"r0", b"r1", b"r2", b"r3"],
                    rng.integers(0, 4, n).astype(code_dtype),
                ),
            },
            {},
        )
        conds = [
            Condition("svc", "eq", "a"),
            Condition("region", "in", ("r0", "r1", "r2", "r3")),
        ]
        mask = stream_exec.device_tag_mask(src, conds, device)
        assert mask is not None and mask.shape == (n,)

    name = "stream+decode/mask-eq-in" if narrow else "stream/mask-eq-in"
    return (name, builtin, run)


def _ql_scenarios():
    from banyandb_tpu_torch.api.model import Condition, QueryRequest, TimeRange
    from banyandb_tpu_torch.query import ql_exec

    def run_trace():
        from banyandb_tpu_torch.api.model import QueryResult

        def q(req, tracer=None):
            res = QueryResult()
            res.data_points = [
                {
                    "trace_id": "t-1",
                    "timestamp": T0,
                    "tags": {"svc": "a", "trace_id": "t-1"},
                    "span": b"",
                }
            ]
            return res

        eng = SimpleNamespace(query=q)
        req = QueryRequest(
            ("g",),
            "t",
            TimeRange(T0, T0 + 1000),
            criteria=Condition("trace_id", "eq", "t-1"),
        )
        ql_exec.execute_trace_ql(eng, req)

    def run_property():
        eng = SimpleNamespace(
            query=lambda g, n, tag_filters=None, ids=None, limit=100: [
                SimpleNamespace(id="p1", tags={"k": "v"}, mod_revision=1)
            ]
        )
        req = QueryRequest(
            ("g",),
            "p",
            TimeRange(T0, T0 + 1000),
            criteria=Condition("id", "eq", "p1"),
        )
        ql_exec.execute_property_ql(eng, req)

    return [("ql/trace", None, run_trace), ("ql/property", None, run_property)]


def _anchor(kind: str) -> tuple[str, int]:
    import inspect

    from banyandb_tpu_torch.lint.whole_program.plan_audit import _rel_path
    from banyandb_tpu_torch.query import measure_exec, ql_exec, stream_exec

    mod, fn = {
        "measure": (measure_exec, measure_exec.compute_partials),
        "stream_mask": (stream_exec, stream_exec.device_tag_mask),
        "ql": (ql_exec, ql_exec.execute_trace_ql),
    }[kind]
    return _rel_path(inspect.getsourcefile(mod)), inspect.getsourcelines(fn)[1]


@contextlib.contextmanager
def _env(overrides: Optional[dict]):
    """Scoped os.environ overrides ({} / None = ambient values)."""
    import os

    overrides = overrides or {}
    saved = {name: os.environ.get(name) for name in overrides}
    os.environ.update(overrides)
    try:
        yield
    finally:
        for name, old in saved.items():
            if old is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = old


def scenarios(device="cpu") -> list[tuple]:
    """(name, kind, builtin, runner, env) for every audited scenario.

    Each measure scenario runs THREE ways: with ``BYDB_FUSED=0`` (the
    staged per-chunk loop, the ``measure/*`` rows), with the fused
    executor (the ``fused/*`` rows, pinned to the precompile registry's
    builtin FusedSpecs), and with fused + ``BYDB_DEVICE_DECODE=1`` (the
    ``fused+decode/*`` rows: the compressed ship form must still cost
    one batched get), plus the multi-chunk staging tripwire.  The
    measure/fused rows pin ``BYDB_DEVICE_DECODE=0`` so their put counts
    stay the dense-ship baseline regardless of the ambient default.

    The port adds a fourth way the reference's table has no row for:
    ``measure+decode/*``, the staged loop in the compressed ship form
    (the production default whenever a part-batch takes the staged
    path).  It is the path whose 1-D narrow columns widen through the
    ``widen_narrow`` kernel."""
    from banyandb_tpu_torch.query import precompile

    staged_env = {"BYDB_FUSED": "0", "BYDB_DEVICE_DECODE": "0"}
    staged_decode_env = {"BYDB_FUSED": "0", "BYDB_DEVICE_DECODE": "1"}
    fused_env = {"BYDB_FUSED": "1", "BYDB_DEVICE_DECODE": "0"}
    decode_env = {"BYDB_FUSED": "1", "BYDB_DEVICE_DECODE": "1"}
    measure = _measure_scenarios(device)
    out = [
        (name, "measure", builtin, run, staged_env)
        for name, builtin, run in measure
    ]
    out += [
        (name.replace("measure/", "measure+decode/"), "measure", builtin, run,
         staged_decode_env)
        for name, builtin, run in measure
    ]
    fused_builtins = dict(precompile.builtin_fused())
    for name, _builtin, run in measure:
        fname = name.replace("measure/", "fused/")
        out.append((fname, "measure", fused_builtins[fname], run, fused_env))
    for name, _builtin, run in measure:
        dname = name.replace("measure/", "fused+decode/")
        # same builtin FusedSpec: the ship form changes the chunk
        # tree, never the plan signature
        out.append(
            (dname, "measure", fused_builtins[name.replace("measure/", "fused/")],
             run, decode_env)
        )
    out.append(
        ("fused/multi-chunk", "measure", None, _multichunk_scenario(device), fused_env)
    )
    out.append(
        ("fused+decode/multi-chunk", "measure", None,
         _multichunk_scenario(device), decode_env)
    )
    s_name, s_builtin, s_run = _stream_scenario(device)
    out.append((s_name, "stream_mask", s_builtin, s_run, {"BYDB_DEVICE_DECODE": "0"}))
    d_name, d_builtin, d_run = _stream_scenario(device, narrow=True)
    out.append((d_name, "stream_mask", d_builtin, d_run, {"BYDB_DEVICE_DECODE": "1"}))
    out += [
        (name, "ql", builtin, run, None)
        for name, builtin, run in _ql_scenarios()
    ]
    return out


def audit_dispatch(device="cpu", around=None, names=None) -> dict[str, DispatchTrace]:
    """Run every scenario on `device` (or those in `names`) -> measured
    traces.

    ``around(name)`` (optional) returns a context manager entered around
    each scenario's run, inside the counting scope — ``card_audit`` puts
    ``torch.profiler`` there."""
    out: dict[str, DispatchTrace] = {}
    for name, kind, builtin, run, env in scenarios(device):
        if names is not None and name not in names:
            continue
        path, line = _anchor(kind)
        with counting() as counters, _env(env):
            error = ""
            try:
                with around(name) if around else contextlib.nullcontext():
                    run()
            except Exception as e:  # noqa: BLE001 — the finding IS the report
                error = f"{type(e).__name__}: {e}"
        by_kernel = tuple(
            (k, counters.hand.count(k))
            for k in HAND_KERNELS
            if counters.hand.count(k)
        )
        out[name] = DispatchTrace(
            name=name,
            kind=kind,
            dispatches=len(counters.dispatches),
            gets=len(counters.gets),
            puts=len(counters.puts),
            hand_launches=len(counters.hand),
            specs=tuple(spec for _k, spec in counters.dispatches),
            builtin=builtin,
            path=path,
            line=line,
            error=error,
            by_kernel=by_kernel,
        )
    return out


def profile_counts(prof) -> dict:
    """CUDA kernels, copies and memsets one ``torch.profiler`` session
    saw on the card."""
    out = {"cuda_launches": 0, "h2d": 0, "d2h": 0, "d2d": 0, "memset": 0}
    for e in prof.key_averages():
        if getattr(e, "self_device_time_total", 0.0) <= 0:
            continue
        if "Memcpy HtoD" in e.key:
            out["h2d"] += e.count
        elif "Memcpy DtoH" in e.key:
            out["d2h"] += e.count
        elif "Memcpy DtoD" in e.key:
            out["d2d"] += e.count
        elif "Memset" in e.key:
            out["memset"] += e.count
        else:
            out["cuda_launches"] += e.count
    return out


def card_audit(device="cuda", tries: int = 3) -> tuple[dict, dict]:
    """Every scenario on the card, each under its own ``torch.profiler``
    session -> (traces, {name: profiler counts + ``launched``, the
    ``hopper_kernels.LAUNCHES`` it added, + ``tries``}).

    The scenarios run once unprofiled first (the first CUDA use of an op
    is not what a part-batch costs).  Every ship is one host->device
    copy, so a profile with fewer copies than the scenario's ``puts``
    lost events (the profiler drops some at times on the card): such a
    scenario runs again, up to `tries` profiles."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from banyandb_tpu_torch.ops import hopper_kernels

    counts: dict[str, dict] = {}

    @contextlib.contextmanager
    def around(name):
        before = dict(hopper_kernels.LAUNCHES)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            yield
            torch.cuda.synchronize()
        tries_so_far = counts.get(name, {}).get("tries", 0)
        counts[name] = {
            **profile_counts(prof),
            "launched": {
                k: hopper_kernels.LAUNCHES[k] - before[k] for k in before
            },
            "tries": tries_so_far + 1,
        }

    audit_dispatch(device=device)
    traces = audit_dispatch(device=device, around=around)
    for _ in range(tries - 1):
        short = {n for n, t in traces.items() if counts[n]["h2d"] < t.puts}
        if not short:
            break
        traces.update(audit_dispatch(device=device, around=around, names=short))
    return traces, counts


def _spec_diff(got, want) -> str:
    parts = []
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if g != w:
            parts.append(f"{f.name}: resolved {g!r} != builtin {w!r}")
    return "; ".join(parts) or f"resolved {got!r} != builtin {want!r}"


def dispatch_findings(traces: dict[str, DispatchTrace]) -> list[Finding]:
    """Scenario failures and signature drift (budget columns are checked
    by kernel_budgets.audit_budgets on the same traces)."""
    findings: list[Finding] = []
    for name in sorted(traces):
        t = traces[name]
        if t.error:
            findings.append(
                Finding(
                    path=t.path,
                    line=t.line,
                    col=0,
                    rule=RULE,
                    message=f"[{name}] scenario failed: {t.error}",
                )
            )
            continue
        if t.builtin is None:
            continue
        resolved = tuple(dict.fromkeys(t.specs))
        if resolved != (t.builtin,):
            detail = (
                _spec_diff(resolved[0], t.builtin)
                if len(resolved) == 1
                and dataclasses.is_dataclass(resolved[0])
                else f"resolved {len(resolved)} distinct signatures"
            )
            findings.append(
                Finding(
                    path=t.path,
                    line=t.line,
                    col=0,
                    rule=RULE,
                    message=(
                        f"[{name}] plan signature drift: the executor did "
                        "not resolve the precompile-registry builtin "
                        f"signature ({detail}); the registry would warm a "
                        "plan production queries never run"
                    ),
                )
            )
    return findings


def measured_columns(t: DispatchTrace) -> dict[str, Optional[int]]:
    """The budget-table columns this analyzer measures."""
    return {"gets": t.gets, "puts": t.puts, "hand_launches": t.hand_launches}
