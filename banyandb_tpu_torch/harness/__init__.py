"""Operating harnesses of the port: the load/SLO harness (``load``),
the standalone-vs-cluster replay soak (``soak``) and the chaos harness
(``chaos``).  Each runs with ``python -m banyandb_tpu_torch.harness.<name>``
on CUDA by default, or on the CPU with ``--device cpu``."""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def env_scope(values: dict):
    """Set `values` in the process environment for the block, then put
    back what each name held before (unset names are unset again): the
    harnesses arm server flags (QoS, self-trace) for one phase only."""
    saved = {name: os.environ.get(name) for name in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for name, old in saved.items():
            if old is None:
                os.environ.pop(name, None)
            else:
                os.environ.update({name: old})
