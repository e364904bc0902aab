"""kernel-lowering: the countable device work of each plan signature
(the counterpart of banyandb_tpu/lint/kernel/lowering.py).

The reference lowers and compiles each signature with XLA and reads
fusion counts, bytes accessed and collectives off the compiled module.
Eager PyTorch has no lowering; each signature's function is traced on
fake tensors (lint/kernel/op_audit.py) and three facts are counted:

- **ops**: the ATen ops it dispatches that launch work (views,
  allocations without a fill and metadata ops excluded; a hand kernel
  is one op) — the estimate, without a card, of the CUDA launches one call
  costs.  The card's profiler count sits beside it in chip_smoke.py;
  an op may launch no kernel or several.
- **bytes class**: the bytes those ops read and write, summed over
  their fake input and output tensors, as a power-of-two class
  (``int.bit_length``, as in the reference) — a real regression, 2x
  the traffic, lands in the next class.
- **collectives**: the cross-slot combines of the mesh steps
  (``parallel/dist_exec._combine``: the reference's psum/pmin/pmax).
  Single-device plans carry none; the ``parallel/dist-step`` and
  ``fused/dist-step`` entries carry exactly count, sums, min and max.
"""

from __future__ import annotations

from typing import Optional

from banyandb_tpu_torch.lint.core import Finding

RULE = "kernel-lowering"


def _mesh_plan():
    from banyandb_tpu_torch.parallel import dist_exec

    return dist_exec.DistPlan(
        tags_code=("svc",),
        fields=("v",),
        group_tags=("svc",),
        radices=(16,),
        num_groups=16,
        topn=4,
    )


def _one_slot_mesh():
    """A one-slot mesh on the fake device: the combine structure is the
    same at any mesh size."""
    import torch

    from banyandb_tpu_torch.lint.whole_program.plan_audit import fake_device
    from banyandb_tpu_torch.parallel.mesh import Mesh

    return Mesh((torch.device(fake_device()),), 1, 1)


def _slot_args(n: int) -> tuple:
    import torch

    from banyandb_tpu_torch.query.precompile import TensorSpec as S

    return (
        {
            "valid": [S((n,), torch.bool)],
            "tags": {"svc": [S((n,), torch.int32)]},
            "fields": {"v": [S((n,), torch.float32)]},
        },
        {},
        0.0,
        1.0,
    )


def mesh_entry():
    """The legacy mesh step (parallel/dist_exec.build_distributed_step):
    grouped sum/min/max + top-N over one slot of 1,024 rows."""
    import inspect

    from banyandb_tpu_torch.lint.whole_program.plan_audit import (
        KernelAudit,
        _rel_path,
    )
    from banyandb_tpu_torch.parallel import dist_exec

    return KernelAudit(
        name="parallel/dist-step",
        path=_rel_path(inspect.getsourcefile(dist_exec)),
        line=inspect.getsourcelines(dist_exec.reduce_slots)[1],
        fn=dist_exec.build_distributed_step(_one_slot_mesh(), _mesh_plan()),
        args=_slot_args(1024),
    )


def fused_mesh_entry():
    """The fused chunked-scan mesh step
    (query/fused_exec.build_fused_dist_step) at a 2-chunk bucket: the
    same combine set as the legacy step."""
    import inspect

    from banyandb_tpu_torch.lint.whole_program.plan_audit import (
        KernelAudit,
        _rel_path,
    )
    from banyandb_tpu_torch.query import fused_exec

    num_chunks = 2
    return KernelAudit(
        name="fused/dist-step",
        path=_rel_path(inspect.getsourcefile(fused_exec)),
        line=inspect.getsourcelines(fused_exec._fused_dist_slot)[1],
        fn=fused_exec.build_fused_dist_step(
            _one_slot_mesh(), _mesh_plan(), num_chunks
        ),
        args=_slot_args(num_chunks * 1024),
    )


def audit_entry(entry) -> tuple[list[Finding], Optional[dict]]:
    """-> (findings, measured ``ops``/``bytes_class``/``collectives``)
    for one signature; None when the trace failed."""
    from banyandb_tpu_torch.lint.kernel import op_audit
    from banyandb_tpu_torch.parallel import dist_exec

    combines: list = []
    real_combine = dist_exec._combine

    def counting_combine(values, op, dev):
        combines.append(op)
        return real_combine(values, op, dev)

    try:
        trace = op_audit.trace_entry(
            entry, patches=((dist_exec, "_combine", counting_combine),)
        )
    except Exception as e:  # noqa: BLE001 — the finding IS the report
        return [
            Finding(
                path=entry.path,
                line=entry.line,
                col=0,
                rule=RULE,
                message=(
                    f"[{entry.name}] fake-tensor trace failed: "
                    f"{type(e).__name__}: {e}"
                ),
            )
        ], None
    launched = [op for op in trace.ops if op.launches]
    return [], {
        "ops": len(launched),
        "bytes_class": sum(op.nbytes for op in launched).bit_length(),
        "collectives": len(combines),
    }
