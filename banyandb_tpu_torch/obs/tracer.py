"""Hierarchical query tracer (pkg/query/tracer.go:50 analog).

A ``Tracer`` owns one root ``Span``; nested ``tracer.span(...)`` context
managers build the tree.  Spans carry a name, wall duration, a flat tag
map (device_ms/host_ms attribution, cache hit/miss, row counts...) and
child spans.  ``Span.attach`` grafts an already-serialized subtree —
the cluster merge: each data node runs its own tracer and returns
``tracer.finish()`` in the RPC reply, the liaison attaches the subtree
under that node's scatter span, and the response carries ONE tree.

Serialized form (JSON-safe, the ``res.trace["span_tree"]`` payload and
the wire common/v1 Span mapping):

    {"name": str, "duration_ms": float, "tags": {str: scalar},
     "children": [<span>...], "error": str?}

Tracing off must cost nothing: callers thread ``None`` (executors skip
span work on a ``None`` span) or ``NOOP_TRACER`` (handlers keep one
code path); both avoid allocation on the hot path.
"""

from __future__ import annotations

import time
from typing import Optional


class Span:
    """One timed node of the trace tree.  Not thread-safe: a span is
    owned by the thread that created it (worker-side timings are
    accumulated into plain tags by the owner, see measure_exec)."""

    __slots__ = ("name", "t0", "t1", "tags", "children", "error_msg")

    def __init__(self, name: str):
        self.name = name
        self.t0 = time.perf_counter()
        self.t1: Optional[float] = None
        self.tags: dict = {}
        self.children: list = []  # Span | dict (attached subtree)
        self.error_msg: Optional[str] = None

    # -- building -----------------------------------------------------------
    def tag(self, key: str, value) -> "Span":
        self.tags[key] = value
        return self

    def error(self, msg: str) -> "Span":
        self.error_msg = str(msg)
        return self

    def child(self, name: str) -> "Span":
        s = Span(name)
        self.children.append(s)
        return s

    def attach(self, subtree: dict) -> None:
        """Graft a serialized span tree (a remote node's subtree)."""
        if subtree:
            self.children.append(subtree)

    def finish(self) -> "Span":
        if self.t1 is None:
            # bdlint: disable=wp-shared-state -- a Span belongs to ONE
            # query's tracer (constructed per request, never shared
            # across requests); many roots run queries, but no two roots
            # ever hold the same Span instance
            self.t1 = time.perf_counter()
        return self

    # spans double as context managers so executors can scope a leg
    # without holding a Tracer
    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None and self.error_msg is None:
            self.error(f"{type(exc).__name__}: {exc}")
        self.finish()

    # -- reading ------------------------------------------------------------
    @property
    def duration_ms(self) -> float:
        end = self.t1 if self.t1 is not None else time.perf_counter()
        return (end - self.t0) * 1000.0

    def to_dict(self) -> dict:
        self.finish()
        out = {
            "name": self.name,
            "duration_ms": round(self.duration_ms, 3),
            "tags": dict(self.tags),
            "children": [
                c.to_dict() if isinstance(c, Span) else c
                for c in self.children
            ],
        }
        if self.error_msg is not None:
            out["error"] = self.error_msg
        return out


class _SpanCtx:
    """Context manager pushing/popping one span on a tracer's stack."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None and self._span.error_msg is None:
            self._span.error(f"{type(exc).__name__}: {exc}")
        self._span.finish()
        self._tracer._stack.pop()


class Tracer:
    """Span-tree builder for one query.  Single-owner (the query's
    request thread); remote subtrees arrive serialized via attach."""

    __slots__ = ("root", "_stack")

    def __init__(self, name: str):
        self.root = Span(name)
        self._stack: list[Span] = [self.root]

    def current(self) -> Span:
        return self._stack[-1]

    def span(self, name: str) -> _SpanCtx:
        s = self._stack[-1].child(name)
        self._stack.append(s)
        return _SpanCtx(self, s)

    def finish(self) -> dict:
        """Close the root and return the serialized tree."""
        return self.root.to_dict()


class _NoopSpan:
    """Absorbs the whole Span surface at near-zero cost."""

    __slots__ = ()

    def tag(self, key, value):
        return self

    def error(self, msg):
        return self

    def child(self, name):
        return self

    def attach(self, subtree):
        pass

    def finish(self):
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        pass

    def to_dict(self) -> dict:
        return {}


class _NoopTracer:
    __slots__ = ()

    root = _NoopSpan()

    def current(self):
        return NOOP_SPAN

    def span(self, name):
        return NOOP_SPAN

    def finish(self) -> dict:
        return {}


NOOP_SPAN = _NoopSpan()
NOOP_TRACER = _NoopTracer()


def attach_tree(res, req, tree: dict):
    """Attach a finished span tree to a QueryResult when the request
    asked for in-band tracing (`res.trace["span_tree"]`) — the one
    response-side attach, shared by every serving surface."""
    if getattr(req, "trace", False):
        res.trace = dict(res.trace or {})
        res.trace["span_tree"] = tree
    return res


def find_span(tree: Optional[dict], name: str) -> Optional[dict]:
    """Depth-first lookup by span name in a serialized tree (tests,
    smoke scripts, slowlog consumers)."""
    if not tree:
        return None
    if tree.get("name") == name:
        return tree
    for c in tree.get("children", ()):
        hit = find_span(c, name)
        if hit is not None:
            return hit
    return None


def iter_spans(tree: Optional[dict]):
    """Yield every span dict of a serialized tree, depth-first."""
    if not tree:
        return
    yield tree
    for c in tree.get("children", ()):
        yield from iter_spans(c)
