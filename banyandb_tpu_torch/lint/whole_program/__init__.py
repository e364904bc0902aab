"""Whole-program analyses of the port: the plan audit
(``plan_audit.py``) and, riding the same surface, the kernel audit
family (``lint/kernel``).  The reference's other whole-program
analyzers (layering, lock order, shared state, wire) are not ported
yet."""

from __future__ import annotations

from banyandb_tpu_torch.lint.kernel import KERNEL_RULES

# (name, summary) catalog for --list-rules / the SARIF driver rules
WP_RULES = (
    ("plan-audit", "fake-tensor shape/dtype/cache-key audit of every builtin plan"),
) + KERNEL_RULES
