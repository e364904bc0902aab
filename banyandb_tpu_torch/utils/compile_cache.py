"""Build cache of the Hopper kernel library (+ hit/miss counters).

The counterpart of banyandb_tpu/utils/compile_cache.py, which points
JAX's persistent XLA cache at a directory that outlives the process.
Here the compiled artefact is the kernel library that
``ops/hopper_kernels.py`` builds from ``csrc/*.cu`` with ``nvcc``: a
``.so`` named by the hash of its sources and flags.  Pointing the build
at a directory that outlives the process (default:
``<data-root>/compile-cache``) makes a restart load the library instead
of running ``nvcc`` again.

Resolution order for the directory, most specific wins:

    explicit CLI flag (``--compile-cache-dir``, via enable_at)
      >  BYDB_COMPILE_CACHE_DIR env var (``off``/``0`` disables)
      >  the caller's computed default (``enable(default_dir)``)

Wiring is process-global and first-wins (the library name hashes the
sources and flags, so sharing one directory between roots and between
processes is safe: the build moves the finished ``.so`` into place
atomically).  With nothing enabled the library builds under the
package's git-ignored ``_build/``.  ``stats()`` keeps the reference's
keys — a hit is a load of an existing ``.so``, a miss an ``nvcc``
build — and adds ``builds``, ``loads``, ``build_s`` and ``load_s``.
"""

from __future__ import annotations

import os
import threading

from banyandb_tpu_torch.utils.envflag import env_str

_DISABLE_VALUES = ("0", "off", "no", "none", "false", "disabled")

_lock = threading.Lock()
_state = {
    "enabled": False,
    "dir": None,
    "hits": 0,
    "misses": 0,
    "builds": 0,
    "loads": 0,
    "build_s": 0.0,
    "load_s": 0.0,
    "error": None,
}


def _wire(target: str) -> str | None:
    with _lock:
        if _state["enabled"]:
            return _state["dir"]  # first wiring wins (process-global)
        try:
            os.makedirs(target, exist_ok=True)
        except OSError as e:  # the cache is an optimization
            _state["error"] = f"{type(e).__name__}: {e}"
            return None
        _state["enabled"] = True
        _state["dir"] = target
        return target


def enable(default_dir=None) -> str | None:
    """Enable the build cache; env overrides the computed default.

    Returns the active directory, or None when disabled (env set to an
    off-value, or no directory resolvable).  Idempotent; later calls
    with a different directory keep the first wiring."""
    env = env_str("BYDB_COMPILE_CACHE_DIR")
    if env and env.strip().lower() in _DISABLE_VALUES:
        return None
    target = env or (str(default_dir) if default_dir else None)
    if not target:
        return None
    return _wire(target)


def enable_at(path) -> str | None:
    """Explicit-path form for CLI flags; off-values disable."""
    if str(path).strip().lower() in _DISABLE_VALUES:
        return None
    return _wire(str(path))


def active_dir() -> str | None:
    return _state["dir"]


def note_build(seconds: float) -> None:
    """One ``nvcc`` build of the library (a miss)."""
    with _lock:
        _state["misses"] += 1
        _state["builds"] += 1
        _state["build_s"] += seconds


def note_load(seconds: float, hit: bool) -> None:
    """One load of the library; ``hit`` when it was already built."""
    with _lock:
        _state["loads"] += 1
        _state["load_s"] += seconds
        if hit:
            _state["hits"] += 1


def stats() -> dict:
    """Telemetry for /metrics and the smoke run."""
    entries = 0
    d = _state["dir"]
    if _state["enabled"] and d and os.path.isdir(d):
        try:
            entries = sum(1 for e in os.scandir(d) if e.name.endswith(".so"))
        except OSError:
            entries = 0
    return {
        "enabled": _state["enabled"],
        "dir": d,
        "hits": _state["hits"],
        "misses": _state["misses"],
        "entries": entries,
        "error": _state["error"],
        "builds": _state["builds"],
        "loads": _state["loads"],
        "build_s": _state["build_s"],
        "load_s": _state["load_s"],
    }
