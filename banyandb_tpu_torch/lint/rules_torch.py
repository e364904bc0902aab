"""Hot-path rules: host syncs, rebuild churn, precision drift.

These encode the port's PyTorch performance contract: device work in
query/, ops/, parallel/ and index/ must not round-trip to the host per
column or per chunk, must not rebuild a device entry point (or reload
the kernel library) per call, and must not put float64 on the card.
The rule ids are the reference's (banyandb_tpu/lint/rules_jax.py);
what each one means in eager PyTorch:

- ``host-sync``  a blocking device->host copy or stream wait.  Flagged
  on a value that came from the card: ``.item()``, ``.tolist()``,
  ``.cpu()`` and ``.numpy()``; ``float``/``int``/``bool`` of a tensor;
  ``np.asarray``/``np.array`` of a tensor.  The explicit sync APIs are
  flagged wherever they appear: ``measure_exec.device_get`` (the port's
  counterpart of ``jax.device_get``), ``torch.cuda.synchronize`` and
  ``<stream>.synchronize()``.  A wall-clock read inside a device region
  is flagged too: the launches are asynchronous, so it times the
  enqueue, not the work.  A legitimate result boundary carries a
  suppression with its reason.
- ``recompile-hazard``  a builder of a device entry point called per
  call, outside the memo that keys it.  Builders are ``_build_kernel``,
  ``build_*_step`` and ``_kernel_body`` (the executors' function
  builders), ``ctypes.CDLL`` and ``hopper_kernels._compile`` (the
  kernel library's load and ``nvcc`` build, which belong inside the
  lock-guarded load).  A builder call is memoized when its result is
  stored into a cache slot (``CACHE[key] = build(...)``), when it is
  made inside another builder or inside a builder that memoizes itself
  (``CACHE.get(key)`` ... ``CACHE[key] = ...``), or, for the library
  load, inside a ``with <lock>:`` block.  A builder taken as a value
  (an alias, a dict of builders) is flagged, since a call through it
  escapes that check.  Python string formatting over
  a device region's arguments and a ``torch.tensor(<list>, device=...)``
  constant built inside a device region are flagged as well: both run
  per chunk, and the constant is one host->device copy per chunk.
- ``precision-drift``  float64 reaching the card (the port's 32-bit
  device contract): ``dtype=torch.float64``/``torch.double``,
  ``.to(torch.float64)``, ``.double()``, and a float64 numpy array
  (``dtype=np.float64``, ``.astype(np.float64)`` or a dtype-less
  float64-defaulting constructor) handed to ``ship``,
  ``torch.as_tensor(..., device=)`` or ``torch.tensor(..., device=)``.
  A call placed explicitly on the host (``device="cpu"``) is the host
  f64 fold and stays unflagged, as does every numpy f64 array that
  never crosses to the card.

Device-value taint is convention-driven, as in the reference: a call to
a callable whose final name segment is ``kernel``, ``jitted`` or
``step`` (or a name bound from a builder call) produces device tensors;
so do ``ship``, ``.to(...)``/``.cuda()`` and any ``torch.*`` constructor
given a ``device=``.  Device regions are functions named ``kernel``,
``step`` or ``jitted`` (and the function a builder returns): their
arguments are device tensors.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, Iterator

from banyandb_tpu_torch.lint.core import FileContext, Finding, dotted_name

HOT_SCOPE = ("query/", "ops/", "parallel/", "index/")

_DEVICE_CALLEE_RE = re.compile(r"^_?([a-z0-9]+_)*(kernel|jitted|step)$")
# the executors' function builders: _build_kernel, build_fused_dist_step,
# build_distributed_step, _kernel_body
_BUILDER_RE = re.compile(r"^(_?build_[a-z0-9_]*(kernel|step)|_kernel_body)$")
# the kernel library's load and build: memoized by the guarded load
_LIB_LOADERS = {"ctypes.CDLL", "CDLL", "_compile", "hopper_kernels._compile"}
_CLOCK_CALLS = {
    "time.time",
    "time.time_ns",
    "time.monotonic",
    "time.perf_counter",
    "_time.perf_counter",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
}
_SYNC_CASTS = {"float", "int", "bool"}
_SYNC_NP = {
    "np.asarray",
    "np.array",
    "numpy.asarray",
    "numpy.array",
}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# host-side metadata of a tensor: reading it never touches the card
_META_ATTRS = {
    "shape", "dtype", "device", "ndim", "is_cuda", "layout", "itemsize",
    "nbytes",
}
_META_METHODS = {"size", "numel", "dim", "element_size", "data_ptr", "stride"}
_SHIP_NAMES = {"ship", "_ship"}
_TO_DEVICE_METHODS = {"to", "cuda"}
_F64_TORCH = {"torch.float64", "torch.double"}
_F64_NP = {"np.float64", "numpy.float64", "float", "np.double", "numpy.double"}
_NP_F64_CTORS = {
    "np.zeros",
    "np.ones",
    "np.empty",
    "np.full",
    "numpy.zeros",
    "numpy.ones",
    "numpy.empty",
    "numpy.full",
}


def _last(d: str) -> str:
    return d.rsplit(".", 1)[-1] if d else ""


def is_builder_name(name: str) -> bool:
    return bool(_BUILDER_RE.match(name))


def is_device_region_name(name: str) -> bool:
    """``kernel``/``step``/``jitted`` functions (never a builder: the
    builder ``_build_kernel`` shares the suffix)."""
    return bool(_DEVICE_CALLEE_RE.match(name)) and not is_builder_name(name)


def _kw(node: ast.Call, name: str):
    for k in node.keywords:
        if k.arg == name:
            return k.value
    return None


def _on_host(node: ast.Call) -> bool:
    """``device="cpu"`` (or ``torch.device("cpu")``): explicitly host."""
    dev = _kw(node, "device")
    if isinstance(dev, ast.Constant):
        return dev.value == "cpu"
    if isinstance(dev, ast.Call) and dotted_name(dev.func) == "torch.device":
        return bool(dev.args) and isinstance(dev.args[0], ast.Constant) and (
            dev.args[0].value == "cpu"
        )
    return False


def _returned_names(fn: ast.AST) -> set[str]:
    return {
        n.value.id
        for n in _walk_own(fn)
        if isinstance(n, ast.Return) and isinstance(n.value, ast.Name)
    }


def _self_memoizing(fn: ast.AST) -> bool:
    """A builder that keys its own memo: ``cached = CACHE.get(key)`` and
    ``CACHE[key] = ...`` on the same name in its body."""
    got, stored = set(), set()
    for n in _walk_own(fn):
        if (
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr == "get"
        ):
            d = dotted_name(n.func.value)
            if d:
                got.add(d)
        elif isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Subscript):
                    d = dotted_name(t.value)
                    if d:
                        stored.add(d)
    return bool(got & stored)


class ModuleTorchFacts:
    """Module-level device-region analysis shared by the hot-path rules.

    - ``device_fns``: FunctionDef nodes whose bodies run on device
      tensors (``kernel``/``step``/``jitted`` defs, and the nested def a
      builder returns — ``_kernel_body``'s body)
    - ``builder_fns``: defs of the executors' function builders
    - ``memo_builders``: names of builders defined here that key their
      own memo (``build_fused_dist_step``)
    """

    def __init__(self, tree: ast.Module):
        fns = [
            n
            for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        self.builder_fns = [n for n in fns if is_builder_name(n.name)]
        self.memo_builders = {
            n.name for n in self.builder_fns if _self_memoizing(n)
        }
        returned: set[int] = set()
        for b in self.builder_fns:
            names = _returned_names(b)
            for child in ast.walk(b):
                if (
                    isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and child is not b
                    and child.name in names
                ):
                    returned.add(id(child))
        self.device_fns = [
            n
            for n in fns
            if is_device_region_name(n.name) or id(n) in returned
        ]


def _walk_own(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk a function's subtree WITHOUT descending into nested function
    defs — each nested def is visited as its own function by the caller,
    so descending here would report its findings once per enclosing
    scope."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _assign_targets(node: ast.AST) -> Iterator[str]:
    if isinstance(node, ast.Assign):
        for t in node.targets:
            if isinstance(t, ast.Name):
                yield t.id
            elif isinstance(t, ast.Tuple):
                for e in t.elts:
                    if isinstance(e, ast.Name):
                        yield e.id
    elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
        if isinstance(node.target, ast.Name):
            yield node.target.id


def _params(fn: ast.AST) -> set[str]:
    a = fn.args
    names = {x.arg for x in list(a.args) + list(a.posonlyargs) + list(a.kwonlyargs)}
    if a.vararg:
        names.add(a.vararg.arg)
    if a.kwarg:
        names.add(a.kwarg.arg)
    return names - {"self", "cls"}


class _FnTaint:
    """Single-pass device-value taint over one function body."""

    def __init__(self, fn: ast.AST, device_region: bool):
        self.tainted: set[str] = set(_params(fn)) if device_region else set()
        # names bound to device callables: `kernel = _build_kernel(spec)`
        self.device_callables: set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                value = node.value
                if value is None:
                    continue
                if isinstance(value, ast.Call) and is_builder_name(
                    _last(dotted_name(value.func))
                ):
                    self.device_callables.update(_assign_targets(node))
                elif self.expr_tainted(value):
                    self.tainted.update(_assign_targets(node))

    def callee_is_device(self, func: ast.AST) -> bool:
        last = _last(dotted_name(func))
        if last in self.device_callables:
            return True
        return is_device_region_name(last)

    def expr_tainted(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.tainted
        if isinstance(e, ast.Attribute) and e.attr in _META_ATTRS:
            return False
        if isinstance(e, (ast.Subscript, ast.Attribute)):
            return self.expr_tainted(e.value)
        if isinstance(e, ast.Call):
            d = dotted_name(e.func)
            last = _last(d)
            if last in _SHIP_NAMES:
                return True
            if isinstance(e.func, ast.Attribute):
                if e.func.attr in _META_METHODS:
                    return False
                if e.func.attr in _TO_DEVICE_METHODS and not _on_host(e):
                    if e.func.attr == "cuda" or e.args or _kw(e, "device"):
                        return True
                if e.func.attr in _SYNC_METHODS:
                    return False  # the result is already on the host
                if self.expr_tainted(e.func.value):
                    return True  # a tensor method of a device tensor
            if d.startswith("torch.") and _kw(e, "device") is not None:
                return not _on_host(e)
            if d.startswith("torch.") and any(
                self.expr_tainted(a) for a in e.args
            ):
                return True
            return self.callee_is_device(e.func)
        if isinstance(e, ast.BinOp):
            return self.expr_tainted(e.left) or self.expr_tainted(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.expr_tainted(e.operand)
        if isinstance(e, ast.Compare):
            return self.expr_tainted(e.left) or any(
                self.expr_tainted(c) for c in e.comparators
            )
        if isinstance(e, ast.IfExp):
            return self.expr_tainted(e.body) or self.expr_tainted(e.orelse)
        return False


def _fns(tree: ast.AST) -> list:
    return [
        n
        for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]


class HostSyncRule:
    """host-sync: device->host round-trips in hot modules.

    Flags ``measure_exec.device_get``, ``torch.cuda.synchronize`` and
    ``<stream>.synchronize()`` anywhere in scope (the legitimate result
    boundary carries a suppression with a reason — that is the point:
    boundaries become greppable decisions), ``.item()``/``.tolist()``/
    ``.cpu()``/``.numpy()``, ``float``/``int``/``bool`` and
    ``np.asarray``/``np.array`` of device-tainted values (each one is a
    separate blocking copy; batch them into ONE device_get at the
    boundary), and wall-clock reads inside device regions (the launches
    are asynchronous: the clock times the enqueue)."""

    name = "host-sync"
    summary = "device->host sync (copy/cast/stream wait/clock) in a hot module"
    scope = HOT_SCOPE

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        facts = ctx.torch_facts
        device = set(map(id, facts.device_fns))
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func)
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "synchronize"
            ):
                yield ctx.finding(
                    node,
                    self.name,
                    "synchronize() waits for every queued launch; batch "
                    "at the result boundary",
                )
            elif _last(d) == "device_get":
                yield ctx.finding(
                    node,
                    self.name,
                    "explicit device->host transfer; if this is the "
                    "result boundary, suppress with a reason",
                )
        for fn in _fns(ctx.tree):
            taint = _FnTaint(fn, id(fn) in device)
            for node in _walk_own(fn):
                if not isinstance(node, ast.Call):
                    continue
                d = dotted_name(node.func)
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SYNC_METHODS
                    and not node.args
                    and taint.expr_tainted(node.func.value)
                ):
                    yield ctx.finding(
                        node,
                        self.name,
                        f".{node.func.attr}() on a device tensor forces a "
                        "blocking copy; use one device_get at the boundary",
                    )
                    continue
                if not node.args:
                    continue
                is_cast = d in _SYNC_CASTS and len(node.args) == 1
                if (d in _SYNC_NP or is_cast) and taint.expr_tainted(
                    node.args[0]
                ):
                    yield ctx.finding(
                        node,
                        self.name,
                        f"{d}() on a device tensor forces a blocking "
                        "copy; use one device_get at the boundary",
                    )
            if id(fn) in device:
                for node in _walk_own(fn):
                    if (
                        isinstance(node, ast.Call)
                        and dotted_name(node.func) in _CLOCK_CALLS
                    ):
                        yield ctx.finding(
                            node,
                            self.name,
                            "wall-clock read inside a device region times "
                            "the asynchronous enqueue, not the work; time "
                            "with CUDA events at the boundary",
                        )


def _in_lock_block(node: ast.AST, parents: dict) -> bool:
    anc = parents.get(node)
    while anc is not None:
        if isinstance(anc, (ast.With, ast.AsyncWith)):
            for item in anc.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call):
                    expr = expr.func
                if "lock" in _last(dotted_name(expr)).lower():
                    return True
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        anc = parents.get(anc)
    return False


def _enclosing_fn(node: ast.AST, parents: dict):
    anc = parents.get(node)
    while anc is not None:
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
        anc = parents.get(anc)
    return None


def _formats_params(node: ast.AST, params: set[str]) -> bool:
    """f-string, ``"..." % x`` or ``"...".format(x)`` over a parameter."""
    if isinstance(node, ast.JoinedStr):
        exprs = [v.value for v in node.values if isinstance(v, ast.FormattedValue)]
    elif (
        isinstance(node, ast.BinOp)
        and isinstance(node.op, ast.Mod)
        and isinstance(node.left, ast.Constant)
        and isinstance(node.left.value, str)
    ):
        exprs = [node.right]
    elif (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "format"
        and isinstance(node.func.value, ast.Constant)
        and isinstance(node.func.value.value, str)
    ):
        exprs = list(node.args) + [k.value for k in node.keywords]
    else:
        return False
    used = {
        n.id for e in exprs for n in ast.walk(e) if isinstance(n, ast.Name)
    }
    return bool(used & params)


class RecompileHazardRule:
    """recompile-hazard: per-call rebuilds of a device entry point.

    A builder (``_build_kernel``, ``build_*_step``, ``_kernel_body``)
    called outside the memo that keys it rebuilds the entry point on
    every call; the blessed pattern is the module memo keyed by the
    static plan spec (``_KERNEL_CACHE[spec] = _build_kernel(spec)``) or
    a builder that memoizes itself.  A builder taken as a value (a
    dict of builders, an alias) escapes that check, so it is flagged
    too.  ``ctypes.CDLL`` and ``hopper_kernels._compile`` belong inside
    the lock-guarded load.  Formatting over a device region's arguments
    and list constants shipped inside one run per chunk."""

    name = "recompile-hazard"
    summary = "per-call rebuild of a device entry point / per-chunk constants"
    scope = HOT_SCOPE

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        facts = ctx.torch_facts
        parents = ctx.parents
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func)
            last = _last(d)
            if d in _LIB_LOADERS:
                # module level loads once, at import
                if _enclosing_fn(node, parents) is not None and not (
                    _in_lock_block(node, parents)
                ):
                    yield ctx.finding(
                        node,
                        self.name,
                        f"{d}() outside the lock-guarded load: the kernel "
                        "library is loaded (or nvcc runs) per call; memoize "
                        "it under the load lock",
                    )
                continue
            if not is_builder_name(last) or last in facts.memo_builders:
                continue
            parent = parents.get(node)
            if isinstance(parent, ast.Call) and parent.func is node:
                yield ctx.finding(
                    node,
                    self.name,
                    f"{last}(...)(...) rebuilds the entry point per call; "
                    "memoize it by its plan spec and reuse it",
                )
                continue
            if isinstance(parent, ast.Assign) and any(
                isinstance(t, ast.Subscript) for t in parent.targets
            ):
                continue  # the memo fill: CACHE[spec] = build(spec)
            fn = _enclosing_fn(node, parents)
            if fn is None:
                continue  # module level: built once at import
            if (
                is_builder_name(fn.name)
                or id(fn) in set(map(id, facts.device_fns))
                or _self_memoizing(fn)
            ):
                continue
            yield ctx.finding(
                node,
                self.name,
                f"{last}() called per call outside the memo that keys it; "
                "cache the built entry point by its plan spec",
            )
        for node in ast.walk(ctx.tree):
            if not (
                isinstance(node, (ast.Name, ast.Attribute))
                and isinstance(node.ctx, ast.Load)
            ):
                continue
            last = _last(dotted_name(node))
            if not is_builder_name(last) or last in facts.memo_builders:
                continue
            parent = parents.get(node)
            if isinstance(parent, ast.Call) and parent.func is node:
                continue  # a call: judged above
            if isinstance(parent, ast.Attribute):
                continue  # part of a longer dotted name
            yield ctx.finding(
                node,
                self.name,
                f"{last} taken as a value: a call through the alias "
                "escapes the memo check; read the executor's memo "
                "accessor instead",
            )
        for fn in facts.device_fns:
            params = _params(fn)
            for node in _walk_own(fn):
                if _formats_params(node, params):
                    yield ctx.finding(
                        node,
                        self.name,
                        "string formatting over a device region's argument "
                        "runs per chunk",
                    )
                elif (
                    isinstance(node, ast.Call)
                    and dotted_name(node.func)
                    in ("torch.tensor", "torch.as_tensor")
                    and node.args
                    and isinstance(
                        node.args[0], (ast.List, ast.Tuple, ast.ListComp)
                    )
                    and _kw(node, "device") is not None
                    and not _on_host(node)
                ):
                    yield ctx.finding(
                        node,
                        self.name,
                        "a list constant shipped inside a device region is "
                        "one host->device copy per chunk; build it once "
                        "outside",
                    )


def _np_f64(e: ast.AST, f64_names: set[str]) -> bool:
    """A numpy float64 array expression."""
    if isinstance(e, ast.Name):
        return e.id in f64_names
    if not isinstance(e, ast.Call):
        return False
    d = dotted_name(e.func)
    dt = _kw(e, "dtype")
    if dt is not None and dotted_name(dt) in _F64_NP:
        return True
    if (
        isinstance(e.func, ast.Attribute)
        and e.func.attr == "astype"
        and e.args
        and dotted_name(e.args[0]) in _F64_NP
    ):
        return True
    if d in _NP_F64_CTORS and dt is None:
        pos = 2 if d.endswith("full") else 1
        if len(e.args) > pos:
            return dotted_name(e.args[pos]) in _F64_NP
        if d.endswith("full") and len(e.args) > 1:
            fill = e.args[1]
            # np.full(n, 0) is int64, np.full(n, 0.0) is float64
            return isinstance(fill, ast.Constant) and isinstance(
                fill.value, float
            )
        return not d.endswith("full")
    return False


class PrecisionDriftRule:
    """precision-drift: float64 reaching the card.

    The device path is 32-bit by contract (values f32, codes/keys i32,
    the f64 host fold after the result boundary).  A float64 tensor on
    the card doubles the bytes every kernel moves and runs at a small
    fraction of the f32 rate on the H100; an f64 numpy array shipped
    as-is becomes exactly that.  State the device dtype explicitly."""

    name = "precision-drift"
    summary = "float64 tensor or f64 numpy array headed for the card"
    scope = HOT_SCOPE

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for fn in [ctx.tree] + _fns(ctx.tree):
            walk = ast.walk(fn) if fn is ctx.tree else _walk_own(fn)
            nodes = list(walk)
            if fn is ctx.tree:
                # module level only: functions are visited on their own
                nodes = [
                    n
                    for n in nodes
                    if _enclosing_fn(n, ctx.parents) is None
                ]
            f64_names: set[str] = set()
            for node in nodes:
                if isinstance(node, ast.Assign) and _np_f64(
                    node.value, f64_names
                ):
                    f64_names.update(_assign_targets(node))
            for node in nodes:
                if not isinstance(node, ast.Call):
                    continue
                d = dotted_name(node.func)
                if _on_host(node):
                    continue
                attr = (
                    node.func.attr
                    if isinstance(node.func, ast.Attribute)
                    else ""
                )
                dt = _kw(node, "dtype")
                if dt is not None and dotted_name(dt) in _F64_TORCH:
                    yield ctx.finding(
                        node,
                        self.name,
                        f"{dotted_name(dt)} on the device path; the card "
                        "runs 32-bit (fold in f64 on the host)",
                    )
                elif attr in ("to", "type") and any(
                    dotted_name(a) in _F64_TORCH for a in node.args
                ):
                    yield ctx.finding(
                        node,
                        self.name,
                        f".{attr}(torch.float64) on the device path; the "
                        "card runs 32-bit (fold in f64 on the host)",
                    )
                elif attr == "double" and not node.args:
                    yield ctx.finding(
                        node,
                        self.name,
                        ".double() on the device path; the card runs "
                        "32-bit (fold in f64 on the host)",
                    )
                elif node.args and _np_f64(node.args[0], f64_names) and (
                    _last(d) in _SHIP_NAMES
                    or (
                        d in ("torch.as_tensor", "torch.tensor")
                        and _kw(node, "device") is not None
                    )
                ):
                    yield ctx.finding(
                        node,
                        self.name,
                        f"a float64 numpy array shipped by {d}() lands "
                        "on the card as float64; cast to float32 first",
                    )


RULES = (HostSyncRule(), RecompileHazardRule(), PrecisionDriftRule())
