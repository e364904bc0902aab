"""Stand-in for banyandb_tpu.query.precompile.

The executors record every plan signature they resolve
(``default_registry().record(...)``); the real registry persists them
and warms the kernels on a cold start.  Until that registry is ported,
``default_registry()`` returns a registry that records nothing.
"""

from __future__ import annotations


class NullRegistry:
    """Accepts the registry calls of the executors and keeps nothing."""

    def record(self, kind: str, spec, context=None) -> None:
        pass

    def note_flush(self) -> None:
        pass


_REGISTRY = NullRegistry()


def default_registry() -> NullRegistry:
    return _REGISTRY
