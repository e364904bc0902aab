"""kernel-ops: walk the ATen ops each audited per-chunk function
dispatches (the counterpart of banyandb_tpu/lint/kernel/jaxpr_audit.py).

The plan audit (lint/whole_program/plan_audit.py) checks only the
*outputs* of a function; this pass checks every op in between.  The
entry runs on fake tensors (``FakeTensorMode``: shapes and dtypes only,
no data) under a ``TorchDispatchMode`` that records each op with its
input and output tensors.  It reports:

- **host syncs**: ``aten._local_scalar_dense`` (``.item()``), ``nonzero``
  and the other ops whose output shape depends on the data, inside a
  device plan, force a device->host round trip per call;
- **64-bit values**: any f64 tensor, and any i64 tensor other than an
  index operand, double memory traffic and break the f32-partials /
  f64-host-merge precision contract;
- **narrowing**: an op taking an f32 tensor and producing f16/bf16/f8
  truncates an accumulator's mantissa;
- **index64**: PyTorch's indexing ops (``index_put_``,
  ``scatter_reduce_``, gathers) and its sort/argsort/topk take or give
  int64 indices (ops/groupby.py's segment reductions).  Those int64
  tensors are index operands: an i64 tensor counts as one when every
  path from it ends in an index argument, or when an op fixes its
  dtype as an index (sort, topk, ...; and views of such outputs).  They are counted in a column of
  their own, and the value widths stay pinned at 4 bytes;
- **widest**: the widest itemsize of any non-index tensor an op
  produces — the budget table's ``widest`` column (4 = the 32-bit
  device contract).

The reference's buffer-donation check has no counterpart: eager
PyTorch allocates each output, there is no ``donate_argnums`` to set.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from banyandb_tpu_torch.lint.core import Finding

RULE = "kernel-ops"

# ops whose result (or its shape) needs the data on the host; any other
# op whose fake run raises for a data-dependent shape counts as well
_SYNC_OPS = {
    "aten._local_scalar_dense",
    "aten.nonzero",
    "aten.masked_select",
    "aten._unique2",
    "aten.unique_dim",
    "aten.unique_consecutive",
    "aten.is_nonzero",
    "aten.equal",
}

# f32 -> any of these narrows an accumulator's mantissa
_NARROW_FLOATS = {
    torch.float16,
    torch.bfloat16,
    torch.float8_e4m3fn,
    torch.float8_e5m2,
}

# op -> positions of its index arguments (a list argument: every tensor)
_INDEX_ARGS = {
    "aten.index_put_": (1,),
    "aten.index_put": (1,),
    "aten._index_put_impl_": (1,),
    "aten.index": (1,),
    "aten.scatter_reduce_": (2,),
    "aten.scatter_reduce": (2,),
    "aten.scatter_": (2,),
    "aten.scatter": (2,),
    "aten.scatter_add_": (2,),
    "aten.scatter_add": (2,),
    "aten.index_add_": (2,),
    "aten.index_add": (2,),
    "aten.gather": (2,),
    "aten.index_select": (2,),
    "aten.take": (1,),
}

# ops whose int64 outputs are indices by definition
_INDEX_SOURCES = {
    "aten.sort",
    "aten.argsort",
    "aten.topk",
    "aten.argmax",
    "aten.argmin",
    "aten.max",
    "aten.min",
    "aten.searchsorted",
}

# ops that launch no kernel: allocation without a fill, metadata
_NO_LAUNCH = {
    "aten.empty",
    "aten.empty_strided",
    "aten.empty_like",
    "aten.new_empty",
    "aten.new_empty_strided",
    "aten.lift_fresh",
    "aten.detach",
    "aten.alias",
    "aten.sym_size",
    "aten.sym_numel",
    "aten.sym_stride",
    "aten.is_same_size",
}


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


@dataclass
class OpRecord:
    """One dispatched op: its name and its input/output tensors."""

    name: str
    is_view: bool
    inputs: list
    outputs: list
    index_inputs: list  # the inputs taken as index arguments

    @property
    def launches(self) -> bool:
        """Counts as a kernel launch in the op estimate."""
        return not (
            self.is_view
            or self.name in _NO_LAUNCH
            or self.name.startswith("prim.")
            or self.name in _SYNC_OPS
        )

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.inputs + self.outputs)


@dataclass
class OpTrace:
    """Every op one entry dispatched, in order, plus its host syncs."""

    ops: list[OpRecord] = field(default_factory=list)
    syncs: list[str] = field(default_factory=list)
    output: object = None

    def index_tensors(self) -> set[int]:
        """ids of the int64 tensors that are index operands."""
        consumers: dict[int, list[OpRecord]] = {}
        sinks: set[int] = set()
        sources: set[int] = set()
        for op in self.ops:
            for t in op.inputs:
                consumers.setdefault(id(t), []).append(op)
            sinks.update(id(t) for t in op.index_inputs)
            # an index-fixing op's int64 outputs, and views of them
            if op.name in _INDEX_SOURCES or (
                op.is_view and any(id(t) in sources for t in op.inputs)
            ):
                sources.update(
                    id(t) for t in op.outputs if t.dtype == torch.int64
                )
        returned = {id(t) for t in _tensors(self.output)}
        memo: dict[int, bool] = {}

        def feeds_index(tid: int) -> bool:
            if tid in memo:
                return memo[tid]
            memo[tid] = True  # an in-place op's cycle does not decide it
            ok = tid in sinks or tid in sources
            if not ok and tid not in returned:
                uses = consumers.get(tid, [])
                ok = bool(uses) and all(
                    tid in {id(t) for t in op.index_inputs}
                    or (
                        op.outputs
                        and all(
                            t.dtype == torch.int64 and feeds_index(id(t))
                            for t in op.outputs
                        )
                    )
                    for op in uses
                )
            memo[tid] = ok
            return ok

        out = set()
        for op in self.ops:
            for t in op.outputs:
                if t.dtype == torch.int64 and feeds_index(id(t)):
                    out.add(id(t))
        return out


class OpRecorder(TorchDispatchMode):
    """Records every op below it; ``.item()`` on a fake tensor (a host
    sync) is recorded and answered with 0 so the trace can go on."""

    def __init__(self, trace: OpTrace):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import (
            DataDependentOutputException,
            DynamicOutputShapeException,
        )

        kwargs = kwargs or {}
        name = str(func.overloadpacket)
        if name in _SYNC_OPS:
            self.trace.syncs.append(name)
        try:
            out = func(*args, **kwargs)
        except DataDependentOutputException:
            if name not in _SYNC_OPS:
                self.trace.syncs.append(name)
            if name == "aten._local_scalar_dense":
                return 0
            raise
        except DynamicOutputShapeException:
            if name not in _SYNC_OPS:
                self.trace.syncs.append(name)
            raise
        index_inputs = []
        for pos in _INDEX_ARGS.get(name, ()):
            if pos < len(args):
                index_inputs += _tensors(args[pos])
        self.trace.ops.append(
            OpRecord(
                name=name,
                is_view=func.is_view,
                inputs=_tensors((args, kwargs)),
                outputs=_tensors(out),
                index_inputs=index_inputs,
            )
        )
        return out


def trace_entry(entry, patches=()) -> OpTrace:
    """Run one audit entry on fake tensors under the recorder.
    ``patches``: (module, attribute, replacement) set for the trace and
    restored after.  Raises what the trace raises (``.syncs`` is filled
    first)."""
    from banyandb_tpu_torch.lint.whole_program.plan_audit import fake_call

    trace = OpTrace()
    saved = [(m, a, getattr(m, a)) for m, a, _ in patches]
    try:
        for m, a, v in patches:
            setattr(m, a, v)
        trace.output = fake_call(entry, mode=OpRecorder(trace))
    except Exception as e:
        e.op_trace = trace  # the syncs seen before the trace stopped
        raise
    finally:
        for m, a, v in saved:
            setattr(m, a, v)
    return trace


def audit_entry(entry) -> tuple[list[Finding], dict | None]:
    """-> (findings, measured columns ``widest``/``index64``/``syncs``),
    columns None when the trace itself failed."""
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

    def sync_findings(syncs) -> None:
        for name in dict.fromkeys(syncs):
            hit(
                f"host sync `{name}` inside a device plan: it waits for "
                "the device and reads its data on the host per call; "
                "lift it out of the per-chunk function"
            )

    try:
        trace = trace_entry(entry)
    except Exception as e:  # noqa: BLE001 — plan-audit reports trace errors
        sync_findings(getattr(e, "op_trace", OpTrace()).syncs)
        hit(f"op trace failed: {type(e).__name__}: {e}")
        return findings, None

    sync_findings(trace.syncs)
    index = trace.index_tensors()
    widest = 1
    wide_hits: set[str] = set()
    for i, op in enumerate(trace.ops):
        if any(t.dtype == torch.float32 for t in op.inputs) and any(
            t.dtype in _NARROW_FLOATS for t in op.outputs
        ):
            hit(
                f"accumulator narrowed at op #{i} (`{op.name}`): float32 -> "
                f"{[str(t.dtype) for t in op.outputs]} truncates the "
                "mantissa; partial sums must stay f32 on the device"
            )
        for t in op.outputs:
            if id(t) in index:
                continue
            widest = max(widest, t.element_size())
            if t.element_size() >= 8 and str(t.dtype) not in wide_hits:
                wide_hits.add(str(t.dtype))
                hit(
                    f"64-bit value `{t.dtype}` produced at op #{i} "
                    f"(`{op.name}`) that is no index operand: 64-bit "
                    "values double memory traffic and break the "
                    "f32-partials/f64-host-merge precision contract"
                )
    return findings, {
        "widest": widest,
        "index64": len(index),
        "syncs": len(trace.syncs),
    }
