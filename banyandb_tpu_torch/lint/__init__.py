"""bdlint for banyandb_tpu_torch: the analysis families the port has.

- ``plan-audit``  (``lint/whole_program/plan_audit.py``) fake-tensor
  shape/dtype trace of every builtin plan signature, cache-key and
  row-bucket audits;
- ``kernel-*``    (``lint/kernel``) the ATen-op walk, dispatch and
  transfer counts per plan signature, the launch/bytes/collective
  facts, and the ratcheted per-signature budget table.

The per-file rule families and the ``python -m`` CLI of
``banyandb_tpu/lint`` are not ported yet.
"""

from banyandb_tpu_torch.lint.core import (  # noqa: F401
    ALL_RULES,
    Finding,
    lint_file,
    lint_paths,
    lint_source,
    render_json,
    render_text,
)
