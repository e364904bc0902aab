"""Message transports: in-process.

``LocalTransport`` carries JSON-serializable envelopes to a node's
``LocalBus`` in this process (the standalone wiring and the
multi-node-in-one-process topology).  The gRPC transport and server of
the JAX package (``GrpcTransport``, ``GrpcBusServer``: generic handlers
on ``/banyandb.Bus/Call``) come with the serving slice; this module
imports neither ``grpc`` nor protobuf.
"""

from __future__ import annotations

import threading
import time

from banyandb_tpu_torch.cluster import faults
from banyandb_tpu_torch.cluster.bus import LocalBus
from banyandb_tpu_torch.obs import metrics as obs_metrics


def _observe_rpc(side: str, topic: str, t0: float) -> None:
    """Stage-labelled fabric latency: rpc_client_ms / rpc_server_ms per
    topic.  Handle lookup is the meter's lock-free fast path; observe
    happens after the call completes, never under a transport lock."""
    obs_metrics.global_meter().histogram(
        f"rpc_{side}_ms", {"topic": topic}
    ).observe((time.perf_counter() - t0) * 1000)


class TransportError(RuntimeError):
    """kind: "error" (default), "shed" — the remote rejected the call to
    shed load (DiskFull/ServerBusy); "deadline" — the remote refused
    work whose propagated deadline already expired; or "stale_epoch" —
    the remote fenced a write stamped with a superseded placement epoch
    (cluster/placement.py): the SENDER must refresh its map and retry.
    Shed, deadline and stale-epoch rejecting nodes are healthy and must
    not be treated as dead."""

    def __init__(self, msg: str, kind: str = "error"):
        super().__init__(msg)
        self.kind = kind


# write-admission exception class names serialized as shed rejections
_SHED_TYPES = ("DiskFull", "ServerBusy")


def _error_kind(e: Exception) -> str:
    """Classify a handler exception for the wire: shed rejections,
    deadline refusals and stale-epoch fences are structured (the caller
    must NOT evict the node); everything else is a hard error."""
    name = type(e).__name__
    if name in _SHED_TYPES:
        return "shed"
    if name == "DeadlineExceeded":
        return "deadline"
    if name == "StaleEpoch":
        return "stale_epoch"
    return "error"


class LocalTransport:
    """In-process transport: addr "local:<name>" -> LocalBus.

    The standalone wiring AND the multi-node-in-one-process test trick
    (pkg/test/setup analog) both ride this.
    """

    def __init__(self):
        self._buses: dict[str, LocalBus] = {}
        self._lock = threading.Lock()

    def register(self, name: str, bus: LocalBus) -> str:
        with self._lock:
            self._buses[name] = bus
        return f"local:{name}"

    def unregister(self, name: str) -> None:
        with self._lock:
            self._buses.pop(name, None)

    def call(self, addr: str, topic: str, envelope: dict, timeout: float = 30.0) -> dict:
        assert addr.startswith("local:"), addr
        faults.maybe_fail_rpc(addr, topic)
        bus = self._buses.get(addr[6:])
        if bus is None:
            raise TransportError(f"node {addr} unreachable")
        t0 = time.perf_counter()
        try:
            return bus.handle(topic, envelope)
        except Exception as e:
            # mirror the gRPC transport's shed/deadline classification;
            # all other exceptions keep propagating raw (standalone-equal
            # behavior)
            kind = _error_kind(e)
            if kind != "error":
                raise TransportError(
                    f"{type(e).__name__}: {e}", kind=kind
                ) from e
            raise
        finally:
            _observe_rpc("client", topic, t0)
