"""Fake-tensor plan auditor: trace every registered kernel entry point
against a matrix of representative plan shapes.

The counterpart of banyandb_tpu/lint/whole_program/plan_audit.py, where
``jax.eval_shape`` runs the trace.  Here each entry runs under
``torch._subclasses.fake_tensor.FakeTensorMode`` on fake tensors: every
op computes only its output's shape, dtype and device, so the audit
moves no data.  The fake tensors claim the CUDA device where the
process has one; a CPU-only build of PyTorch cannot index a fake CUDA
tensor (Python indexing takes a CUDA device guard), so there they claim
the CPU — the traced functions route by shape and signature, never by
device, so both traces dispatch the same ops.  The Hopper kernels take
part as custom ops whose fake implementations give their output shapes
(ops/hopper_kernels.py).  It catches:

- **shape mismatch**: a plan whose per-chunk function no longer traces
  (broadcast error, bad segment count, wrong tree) fails here, not on
  the first production query with that plan shape;
- **dtype promotion**: the precision contract (f32 device partials, i32
  keys/timestamps, f64 only on the host merge) is pinned as an explicit
  expectation table per entry; any drift — an f64 constant, an int64
  key — is a finding;
- **unstable signatures**: the plan signature objects
  (PlanSpec/FusedSpec/_MaskSpec) key the precompile registry and its
  store, so they are audited for deep immutability, by-value equality
  and stable hashing, and the row-bucket functions are audited to
  produce a finite power-of-two shape set.

The matrix is the precompile registry's builtin signature set plus the
shared ops reductions every plan lowers onto; ``run_plan_audit()`` is
the tree audit.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from banyandb_tpu_torch.lint.core import Finding

RULE = "plan-audit"

_IMMUTABLE_SCALARS = (str, bytes, int, float, bool, type(None))


def _rel_path(path) -> str:
    """Repo-relative anchor path for a module's source file (stable
    across machines).  Falls back to the absolute path when the package
    lives outside a repo checkout."""
    from pathlib import Path

    import banyandb_tpu_torch

    root = Path(banyandb_tpu_torch.__file__).resolve().parent.parent
    p = Path(path).resolve()
    try:
        return str(p.relative_to(root))
    except ValueError:
        return str(p)


def fake_device() -> str:
    """The device the fake tensors claim: CUDA where the process has it."""
    return "cuda" if torch.cuda.is_available() else "cpu"


@dataclass
class KernelAudit:
    """One entry of the audit matrix."""

    name: str
    path: str  # finding anchor: the file that owns the function builder
    line: int
    fn: Callable  # the per-chunk (or per-batch) function to trace
    args: tuple  # trees of precompile.TensorSpec / static scalars
    kwargs: dict = field(default_factory=dict)
    # flattened output key-path -> (dtype name, shape); the checked-in
    # precision/shape contract for this plan shape
    expect: Optional[dict[str, tuple[str, tuple]]] = None
    cache_key: object = None  # plan signature object to audit, if any


def fake_call(entry: KernelAudit, mode=None):
    """Run one entry on fake tensors -> its (fake) output tree.

    ``mode`` (a TorchDispatchMode, e.g. lint/kernel/op_audit's recorder)
    sees every op the entry dispatches; it sits above the fake mode."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from banyandb_tpu_torch.query.precompile import TensorSpec, tree_map

    dev = fake_device()

    def materialize(s):
        if isinstance(s, TensorSpec):
            return torch.empty(s.shape, dtype=s.dtype, device=dev)
        return s

    with FakeTensorMode():
        args = tree_map(materialize, entry.args)
        kwargs = {k: tree_map(materialize, v) for k, v in entry.kwargs.items()}
        with mode if mode is not None else contextlib.nullcontext():
            return entry.fn(*args, **kwargs)


def _mutable_parts(obj, prefix: str = "") -> list[str]:
    """Paths inside a cache-key object that are not deeply immutable."""
    if isinstance(obj, _IMMUTABLE_SCALARS):
        return []
    if isinstance(obj, tuple):
        return [
            p
            for i, v in enumerate(obj)
            for p in _mutable_parts(v, f"{prefix}[{i}]")
        ]
    if isinstance(obj, frozenset):
        return [p for v in obj for p in _mutable_parts(v, prefix + "{}")]
    if dataclasses.is_dataclass(obj) and obj.__dataclass_params__.frozen:
        return [
            p
            for f in dataclasses.fields(obj)
            for p in _mutable_parts(
                getattr(obj, f.name), f"{prefix}.{f.name}".lstrip(".")
            )
        ]
    return [prefix or "<root>"]


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``float32`` (the JAX package's spelling)."""
    return str(dtype).removeprefix("torch.")


def flat_spec(tree, prefix: str = "") -> dict[str, tuple[str, tuple]]:
    """Output tree -> {key path: (dtype name, shape)}, key paths spelled
    as jax.tree_util spells them (``['count']``, ``.sums['v']``,
    ``<out>`` for a bare tensor)."""
    if isinstance(tree, torch.Tensor):
        return {prefix or "<out>": (dtype_name(tree.dtype), tuple(tree.shape))}
    out: dict = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flat_spec(tree[k], f"{prefix}['{k}']"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(flat_spec(v, f"{prefix}[{i}]"))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            out.update(flat_spec(getattr(tree, f.name), f"{prefix}.{f.name}"))
    return out


def audit_kernel(entry: KernelAudit) -> list[Finding]:
    """Run one matrix entry -> findings (empty = the plan holds)."""
    findings: list[Finding] = []

    def hit(message: str) -> None:
        findings.append(
            Finding(
                path=entry.path,
                line=entry.line,
                col=0,
                rule=RULE,
                message=f"[{entry.name}] {message}",
            )
        )

    if entry.cache_key is not None:
        for p in _mutable_parts(entry.cache_key):
            hit(
                f"plan signature field `{p}` is not deeply immutable; "
                "an array/list/dict in the signature breaks the registry "
                "and its store (a new signature per query)"
            )
        try:
            clone = copy.deepcopy(entry.cache_key)
            if bool(clone != entry.cache_key) or hash(clone) != hash(
                entry.cache_key
            ):
                hit(
                    "plan signature compares/hashes by identity, not "
                    "value: an equal plan rebuilt next query is a new "
                    "signature"
                )
        except TypeError as e:
            hit(f"plan signature is unhashable: {e}")
        except ValueError:
            # e.g. an ndarray in the key makes != ambiguous — already
            # reported above as a non-immutable field
            pass

    try:
        out = fake_call(entry)
    except Exception as e:  # noqa: BLE001 — the finding IS the report
        hit(
            f"fake-tensor trace failed (shape mismatch / trace error): "
            f"{type(e).__name__}: {e}"
        )
        return findings

    got = flat_spec(out)
    for key, (dtype, _shape) in sorted(got.items()):
        if dtype in ("float64", "int64", "uint64"):
            hit(
                f"output `{key}` is {dtype}: 64-bit dtypes in a device "
                "plan double memory traffic and break the f32-partials/"
                "f64-host-merge precision contract"
            )
    if entry.expect is not None:
        for key in sorted(set(entry.expect) | set(got)):
            want, have = entry.expect.get(key), got.get(key)
            if want is None:
                hit(f"unexpected output `{key}` {have}; extend the contract "
                    "table if this is deliberate")
            elif have is None:
                hit(f"missing output `{key}` (contract says {want})")
            elif want != have:
                hit(
                    f"output `{key}` is dtype={have[0]} shape={have[1]}, "
                    f"contract says dtype={want[0]} shape={want[1]}"
                )
    return findings


def _bucket_findings() -> list[Finding]:
    """The signature-population audit: row-bucket functions must emit a
    finite power-of-two shape set."""
    import inspect

    from banyandb_tpu_torch.query import measure_exec, stream_exec

    findings: list[Finding] = []
    for mod, fn_name, fn, hi in (
        (measure_exec, "_scan_bucket", measure_exec._scan_bucket, measure_exec.SCAN_CHUNK),
        (stream_exec, "_pad_bucket", stream_exec._pad_bucket, 1 << 24),
    ):
        path = _rel_path(inspect.getsourcefile(mod))
        line = inspect.getsourcelines(fn)[1]
        buckets = {fn(n) for n in (1, 2, 63, 64, 65, 1000, 8192, 100_000, hi)}
        bad = [b for b in buckets if b & (b - 1) or b > max(hi, 1)]
        if bad:
            findings.append(
                Finding(
                    path=path,
                    line=line,
                    col=0,
                    rule=RULE,
                    message=(
                        f"{fn_name} emitted non-power-of-two/unbounded row "
                        f"buckets {sorted(bad)}: every distinct bucket is "
                        "one more plan signature; the shape set must stay "
                        "O(log max_rows)"
                    ),
                )
            )
    return findings


def base_expect(spec) -> dict[str, tuple[str, tuple]]:
    """The output contract of one measure plan (the reference's table)."""
    g = (spec.num_groups,)
    out = {"['count']": ("float32", g)}
    for f in spec.fields:
        out[f"['sums']['{f}']"] = ("float32", g)
        if spec.want_minmax:  # min/max tensors exist only when asked
            out[f"['mins']['{f}']"] = ("float32", g)
            out[f"['maxs']['{f}']"] = ("float32", g)
    if spec.hist_field:
        out["['hist']"] = ("float32", (spec.num_groups, 512))
    if spec.want_rep:
        out["['rep_ts']"] = ("int32", g)
        out["['rep_row']"] = ("int32", g)
    return out


def default_entries() -> list[KernelAudit]:
    """The checked-in plan matrix for the banyandb_tpu_torch query layer.

    The measure/stream signatures come from the precompile registry's
    builtin matrix (query/precompile.builtin_plans/_masks/_fused) — ONE
    list feeds both warming and auditing, and the agreement is pinned
    by a test, so a signature the server warms is exactly a signature
    this audit contracts."""
    import inspect

    from banyandb_tpu_torch import ops
    from banyandb_tpu_torch.query import (
        fused_exec,
        measure_exec,
        precompile,
        stream_exec,
    )

    S = precompile.TensorSpec
    f32, i32, b8 = torch.float32, torch.int32, torch.bool

    mpath = _rel_path(inspect.getsourcefile(measure_exec))
    mline = inspect.getsourcelines(measure_exec._build_kernel)[1]
    spath = _rel_path(inspect.getsourcefile(stream_exec))
    sline = inspect.getsourcelines(stream_exec._build_kernel)[1]
    fpath = _rel_path(inspect.getsourcefile(fused_exec))
    fline = inspect.getsourcelines(fused_exec._build_kernel)[1]

    entries: list[KernelAudit] = []
    for name, spec in precompile.builtin_plans():
        entries.append(
            KernelAudit(
                name=name,
                path=mpath,
                line=mline,
                fn=measure_exec.kernel_for(spec),
                args=(
                    precompile.chunk_struct(spec),
                    precompile.pred_struct(spec),
                    *precompile.scalar_struct(),
                ),
                expect=base_expect(spec),
                cache_key=spec,
            )
        )

    for name, mspec in precompile.builtin_masks():
        entries.append(
            KernelAudit(
                name=name,
                path=spath,
                line=sline,
                fn=stream_exec.kernel_for(mspec),
                args=precompile.mask_structs(mspec),
                expect={"<out>": ("bool", (mspec.nrows,))},
                cache_key=mspec,
            )
        )

    # the fused whole-plan twins: same contract per chunk, stacked
    # [num_chunks, ...] outputs; then the device-decode twins: SAME fused
    # function, the COMPRESSED ship form (narrow codes + remap LUTs +
    # narrow int fields) — the decode stage must keep the output
    # contract identical and introduce no 64-bit dtypes
    for builtins, struct in (
        (precompile.builtin_fused(), precompile.fused_chunk_struct),
        (precompile.builtin_fused_decode(), precompile.fused_decode_chunk_struct),
    ):
        for name, fspec in builtins:
            fexpect = {
                key: (dtype, (fspec.num_chunks,) + shape)
                for key, (dtype, shape) in base_expect(fspec.plan).items()
            }
            entries.append(
                KernelAudit(
                    name=name,
                    path=fpath,
                    line=fline,
                    fn=fused_exec.kernel_for(fspec),
                    args=(
                        struct(fspec),
                        precompile.pred_struct(fspec.plan),
                        *precompile.scalar_struct(),
                    ),
                    expect=fexpect,
                    cache_key=fspec,
                )
            )

    # the shared ops reductions every plan lowers onto, at a
    # representative grouped shape (method dispatch goes through "auto")
    opath = _rel_path(inspect.getsourcefile(ops.groupby))
    oline = inspect.getsourcelines(ops.group_reduce)[1]
    n, G = 8192, 128
    entries.append(
        KernelAudit(
            name="ops/group_reduce",
            path=opath,
            line=oline,
            fn=lambda key, valid, f: ops.group_reduce(key, valid, {"v": f}, G),
            args=(S((n,), i32), S((n,), b8), S((n,), f32)),
            expect={
                ".count": ("float32", (G,)),
                ".sums['v']": ("float32", (G,)),
                ".mins['v']": ("float32", (G,)),
                ".maxs['v']": ("float32", (G,)),
            },
        )
    )
    hpath = _rel_path(inspect.getsourcefile(ops.percentile))
    hline = inspect.getsourcelines(ops.group_histogram)[1]
    entries.append(
        KernelAudit(
            name="ops/group_histogram",
            path=hpath,
            line=hline,
            fn=lambda key, valid, vals, lo, span: ops.group_histogram(
                key, valid, vals, G, lo, span, 512
            ),
            args=(S((n,), i32), S((n,), b8), S((n,), f32), S((), f32), S((), f32)),
            expect={"<out>": ("float32", (G, 512))},
        )
    )
    return entries


def run_plan_audit() -> list[Finding]:
    findings: list[Finding] = []
    for entry in default_entries():
        findings.extend(audit_kernel(entry))
    findings.extend(_bucket_findings())
    return findings
