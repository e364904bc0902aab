"""Cluster-fabric and resource hygiene rules.

The fabric invariants keep a degraded cluster degraded instead of dead:
every RPC must be able to time out, no lock may be held across a
blocking network call (one slow peer would serialize the process), and
retry loops must back off instead of hammering a struggling node.
Resource hygiene keeps long-running nodes from leaking fds across
flush/merge/restart cycles.
"""

from __future__ import annotations

import ast
from typing import Iterable

from banyandb_tpu_torch.lint.core import FileContext, Finding, dotted_name

# Callees that block on the network (or deliberately stall the thread).
_BLOCKING_SLEEPS = {"time.sleep", "_time.sleep", "sleep"}
_URLOPEN = {"urlopen", "urllib.request.urlopen", "request.urlopen"}
_SOCKET_CONNECT = {"socket.create_connection", "create_connection"}


def _attr_chain_ids(node: ast.AST) -> list[str]:
    """['self', 'transport', 'call'] for self.transport.call."""
    out: list[str] = []
    while isinstance(node, ast.Attribute):
        out.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        out.append(node.id)
    return list(reversed(out))


def _is_transport_call(node: ast.Call) -> bool:
    """A bus/transport RPC: ``<...>.transport.call(...)`` or a bare
    ``transport.call(...)`` — the project's one fabric call surface
    (cluster/rpc.py LocalTransport/GrpcTransport)."""
    if not isinstance(node.func, ast.Attribute) or node.func.attr != "call":
        return False
    chain = _attr_chain_ids(node.func)
    return any("transport" in part for part in chain[:-1])


def _is_blocking(node: ast.Call) -> bool:
    d = dotted_name(node.func)
    if d in _BLOCKING_SLEEPS | _URLOPEN | _SOCKET_CONNECT:
        return True
    return _is_transport_call(node)


class RpcTimeoutRule:
    """rpc-timeout: fabric calls that can block a thread forever.

    Transport defaults exist, but an explicit timeout at every call site
    is the contract: the right bound depends on the call (health probes
    want 5s, chunked sync wants 120s) and an inherited default is how
    30s stalls hide in gossip loops."""

    name = "rpc-timeout"
    summary = "network call without an explicit timeout"
    scope = ("",)

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            kw = {k.arg for k in node.keywords}
            if _is_transport_call(node) and "timeout" not in kw:
                yield ctx.finding(
                    node,
                    self.name,
                    "transport.call without explicit timeout=; pick the "
                    "bound this call actually tolerates",
                )
            d = dotted_name(node.func)
            if d in _URLOPEN | _SOCKET_CONNECT and "timeout" not in kw:
                yield ctx.finding(
                    node,
                    self.name,
                    f"{d}() without timeout= can hang the fabric thread",
                )


class LockAcrossRpcRule:
    """lock-across-rpc: a mutex held across a blocking network call.

    One unreachable peer then serializes every thread that touches the
    lock — the exact failure the per-node health/handoff machinery
    exists to avoid.  Move the call out of the critical section (snapshot
    under the lock, call after)."""

    name = "lock-across-rpc"
    summary = "lock held across a blocking RPC/sleep"
    scope = ("",)

    @staticmethod
    def _is_lock_ctx(expr: ast.AST) -> bool:
        ids = _attr_chain_ids(expr)
        return bool(ids) and "lock" in ids[-1].lower()

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            if not any(
                self._is_lock_ctx(item.context_expr) for item in node.items
            ):
                continue
            for inner in ast.walk(node):
                if isinstance(inner, ast.Call) and _is_blocking(inner):
                    yield ctx.finding(
                        inner,
                        self.name,
                        "blocking call while holding a lock; snapshot "
                        "under the lock, call outside it",
                    )


class RetryBackoffRule:
    """retry-backoff: a retry loop with no sleep between attempts.

    A ``while`` loop that swallows exceptions and immediately re-tries
    turns one struggling peer into a busy-loop DoS from every client.
    The blessed shape is schema_plane's watcher: exponential backoff,
    reset on a healthy pass."""

    name = "retry-backoff"
    summary = "retry loop without backoff/sleep"
    scope = ("",)

    @staticmethod
    def _has_pause(loop: ast.While) -> bool:
        for node in ast.walk(loop):
            if isinstance(node, ast.Call):
                d = dotted_name(node.func)
                last = d.rsplit(".", 1)[-1]
                if last in ("sleep", "wait") or "backoff" in d:
                    return True
                # a bounded blocking call (q.get(timeout=...)) paces the
                # loop just as well as an explicit sleep — but a NETWORK
                # call's own timeout does not: against a down peer,
                # connection-refused returns in microseconds and the loop
                # still hammers (the timeout only bounds the slow case)
                if (
                    any(k.arg == "timeout" for k in node.keywords)
                    and not _is_blocking(node)
                ):
                    return True
        return False

    @staticmethod
    def _swallows(handler: ast.ExceptHandler) -> bool:
        """True when the handler neither re-raises nor leaves the loop —
        i.e. the loop will immediately try again."""
        escapes = (ast.Raise, ast.Return, ast.Break)
        return not any(
            isinstance(n, escapes) for n in ast.walk(handler)
        )

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.While):
                continue
            retries = [
                t
                for t in ast.walk(node)
                if isinstance(t, ast.Try)
                and any(self._swallows(h) for h in t.handlers)
            ]
            if retries and not self._has_pause(node):
                yield ctx.finding(
                    retries[0],
                    self.name,
                    "loop swallows errors and retries without sleeping; "
                    "add (exponential) backoff",
                )


class ResourceHygieneRule:
    """resource-hygiene: files/sockets opened outside context managers.

    Nodes run for weeks across flush/merge/restart cycles; a handle that
    relies on GC is a handle that leaks under load.  Deliberate
    long-lived handles (caches, access logs) carry a suppression naming
    who closes them."""

    name = "resource-hygiene"
    summary = "open()/socket() outside a context manager"
    scope = ("",)

    _OPENERS = {"open", "socket.socket", "socket.create_connection"}

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted_name(node.func)
            if d not in self._OPENERS:
                continue
            parent = ctx.parents.get(node)
            if isinstance(parent, ast.withitem):
                continue
            yield ctx.finding(
                node,
                self.name,
                f"{d}() outside a with-block; use a context manager or "
                "suppress naming the owner that closes it",
            )


RULES = (
    RpcTimeoutRule(),
    LockAcrossRpcRule(),
    RetryBackoffRule(),
    ResourceHygieneRule(),
)
