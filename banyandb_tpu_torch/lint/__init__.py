"""bdlint — project-native static analysis for banyandb_tpu_torch.

Machine-checks the invariants that keep the CUDA hot path hot and the
cluster fabric live (the port's copy of banyandb_tpu/lint; the per-file
rule ids are the reference's):

- ``host-sync``        device->host copies and stream waits in hot modules
- ``recompile-hazard`` per-call rebuilds of a device entry point or of the
                       kernel library, per-chunk constants and formatting
- ``precision-drift``  float64 reaching the card
- ``rpc-timeout``      fabric calls that can block forever
- ``lock-across-rpc``  locks held across blocking network calls
- ``retry-backoff``    retry loops that hammer without sleeping
- ``resource-hygiene`` files/sockets opened outside context managers

plus the whole-program families (``lint/whole_program``: layering, sync,
lock order, shared state, wire, plan audit, kernel audit).

Usage::

    python -m banyandb_tpu_torch.lint --check banyandb_tpu_torch
    python -m banyandb_tpu_torch.lint --format json path/to/file.py

Per-line suppression (same line or the comment line directly above)::

    out = device_get(tree)  # bdlint: disable=host-sync -- boundary transfer
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
