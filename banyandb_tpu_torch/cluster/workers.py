"""Shard-owning worker processes: the multi-process data plane
(docs/performance.md "Multi-process data plane").

One CPython process serializes the host work (gather, decode, fold) of
concurrent queries and writes on the GIL.  This module frees the GIL by
mapping shard ownership to worker subprocesses, so the work of
concurrent requests runs in separate processes (one query's scatter
legs are still called one after another, as the liaison calls them;
what N workers on one card give is measured by ``chip_smoke.py``):

- each worker runs a full :class:`~banyandb_tpu_torch.cluster.data_node.DataNode`
  over its OWN directory tree (``<root>/workers/w00i``) — parts,
  memtables, flush/merge/retention loops and streamagg windows are
  single-owner per process, exactly like a cluster data node's — on the
  parent's device (``--device``): on the card each worker loads the
  kernel library the parent built into the fleet's build cache and
  launches its own kernels; a worker that cannot reach the card or load
  the library exits and fails the pool's start, never falling back to
  the CPU;
- the parent speaks to workers over a framed-JSON socketpair with the
  SAME topic envelopes the liaison→data-node wire uses, so a worker is
  just one more scatter leg: :class:`WorkerTransport` plugs the pipe
  into the ordinary :class:`~banyandb_tpu_torch.cluster.liaison.Liaison`,
  which contributes shard placement, scatter/merge through
  ``combine/finalize_partials``, the ``_QueryGuard`` deadline budget,
  one failover round, ``degraded`` markers, and span-subtree grafting —
  none of it reimplemented here;
- ingest partitions by the existing shard hash
  (``hashing.series_id % shard_num``, shard → ``shard % n`` worker) and
  forwards to the owning worker;
- every measure write is journaled in the parent BEFORE forwarding
  (handoff-style): a SIGKILLed worker restarts, replays the journal
  from the last flush watermark, and reloads its streamagg registry
  AFTER the replay — so no acked write is lost and windows never
  double-fold (rows in both a flushed part and the journal collapse in
  the backfill's (series, ts, version) dedup).  The journal trims on
  explicit worker flushes (the watermark = last seq the worker had
  applied when the flush drained its memtables).  ALL flushes are
  parent-driven (the supervisor ticks them on the single-process
  loop's cadence; workers run their lifecycle with local_flush=False):
  a worker-local drain would persist journaled rows without trimming
  them, and the replay after a crash would re-append stream/trace
  elements, which have no version dedup to collapse the copies.

Crash-durability contract: the journal lives in the PARENT process, so
worker death loses nothing acked; parent death loses at most the
untrimmed journal window — identical to the single-process layout's
memtable loss window.  ``BYDB_WORKERS=0`` restores that layout exactly
(see server.py), with result JSON pinned byte-identical across modes.

Every envelope crosses the socket as JSON (``json.dumps``), both ways:
the data node's replies are already JSON-able (``cluster/serde.py``
encodes rows, partials and ±inf/NaN extremes), so no tensor, numpy
scalar or raw bytes reaches ``_send_frame``.  Kernel launch counts
(``ops/hopper_kernels.LAUNCHES``) are per process: the worker's
``metrics`` exposition carries its own, and ``WorkerPool.metrics_text``
labels them ``worker=``.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import re
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Optional

from banyandb_tpu_torch.cluster import faults, serde
from banyandb_tpu_torch.cluster.bus import Topic
from banyandb_tpu_torch.cluster.liaison import Liaison
from banyandb_tpu_torch.cluster.node import NodeInfo
from banyandb_tpu_torch.cluster.rpc import TransportError, _error_kind
from banyandb_tpu_torch.utils import hashing, procreg
from banyandb_tpu_torch.utils.envflag import env_int

log = logging.getLogger("banyandb.workers")

CTL_TOPIC = "worker-ctl"

# Topics the worker executes on its single ordered writer thread, in
# arrival order: the parent's per-worker journal seq therefore matches
# the worker's apply order, which is what makes the flush watermark a
# sound trim point.
ORDERED_TOPICS = frozenset(
    {
        Topic.MEASURE_WRITE.value,
        Topic.MEASURE_WRITE_COLUMNS.value,
        Topic.STREAM_WRITE.value,
        Topic.TRACE_WRITE.value,
        CTL_TOPIC,
    }
)

_SPAWN_TIMEOUT_S = 120.0
_LOG_TAIL_BYTES = 4000
_WRITE_TIMEOUT_S = 30.0
_CTL_TIMEOUT_S = 120.0
_HDR = struct.Struct(">I")


# -- framing -----------------------------------------------------------------


def _send_frame(
    sock: socket.socket,
    lock: threading.Lock,
    obj: Optional[dict] = None,
    *,
    data: Optional[bytes] = None,
) -> None:
    if data is None:
        data = json.dumps(obj).encode()
    with lock:
        sock.sendall(_HDR.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> Optional[dict]:
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    body = _recv_exact(sock, _HDR.unpack(hdr)[0])
    if body is None:
        return None
    return json.loads(body)


# -- parent side: one worker ---------------------------------------------------


def fleet_cache_dir(pool_root: Path) -> str:
    """The build-cache directory the fleet shares: the parent's
    ``BYDB_COMPILE_CACHE_DIR`` when set (an off-value disables it),
    else ``<pool root>/compile-cache``."""
    return os.environ.get("BYDB_COMPILE_CACHE_DIR") or str(
        Path(pool_root) / "compile-cache"
    )


class WorkerClient:
    """Parent-side handle on one worker subprocess: spawn, framed-JSON
    RPC with the bus envelope contract, SIGKILL for chaos, reaping.
    `device` (``cuda``, ``cuda:0`` or ``cpu``) is where the worker's
    data node scans."""

    def __init__(self, name: str, root: Path, device: str = "cuda"):
        self.name = name
        self.device = str(device)
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._send_lock = threading.Lock()
        self._pending_lock = threading.Lock()
        self._pending: dict[int, dict] = {}
        self._ids = itertools.count(1)
        self._dead = threading.Event()
        self._ready = threading.Event()
        self.flush_wm = 0  # set from the ready banner (persisted wm)
        # the worker's device and build-cache counters at boot (banner)
        self.ready_info: dict = {}
        parent_sock, child_sock = socket.socketpair()
        self._sock = parent_sock
        env = dict(os.environ)
        # the worker replays BEFORE loading its streamagg registry (see
        # module docstring); it must also never spawn a pool of its own
        env["BYDB_STREAMAGG_AUTOLOAD"] = "0"
        env["BYDB_WORKERS"] = "0"
        if not env.get("BYDB_COMPILE_CACHE_DIR"):
            # one shared build cache for the whole fleet: the parent put
            # the kernel library there before the spawn (WorkerPool), so
            # every worker loads it and none runs nvcc
            env["BYDB_COMPILE_CACHE_DIR"] = fleet_cache_dir(self.root.parent)
        pkg_root = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (pkg_root, env.get("PYTHONPATH", "")) if p
        )
        self._log = open(  # bdlint: disable=resource-hygiene --
            # owned for the worker's lifetime; close() closes it
            self.root / "worker.log", "ab"
        )
        try:
            self.proc = subprocess.Popen(
                [
                    sys.executable,
                    "-m",
                    "banyandb_tpu_torch.cluster.workers",
                    "--fd",
                    str(child_sock.fileno()),
                    "--root",
                    str(self.root),
                    "--name",
                    name,
                    "--device",
                    self.device,
                ],
                pass_fds=(child_sock.fileno(),),
                stdout=self._log,
                stderr=subprocess.STDOUT,
                env=env,
                close_fds=True,
            )
        except OSError:
            # spawn failures (EAGAIN/ENOMEM) happen exactly when the
            # supervisor retry loop runs hot — leaking 3 fds per attempt
            # would march the parent to EMFILE
            parent_sock.close()
            child_sock.close()
            self._log.close()
            raise
        child_sock.close()
        procreg.register(self.proc.pid, f"bydb-worker {name}")
        self._router = threading.Thread(
            target=self._route, name=f"bydb-worker-router-{name}", daemon=True
        )
        self._router.start()

    # -- receive path -------------------------------------------------------
    def _route(self) -> None:
        try:
            while True:
                msg = _recv_frame(self._sock)
                if msg is None:
                    break
                if msg.get("ready"):
                    # the worker's persisted flush watermark (last
                    # journal seq applied before its newest durable
                    # flush): replay skips entries at or below it —
                    # they are already in parts on disk
                    self.flush_wm = int(msg.get("flush_wm", 0))
                    self.ready_info = msg
                    self._ready.set()
                    continue
                with self._pending_lock:
                    slot = self._pending.pop(msg.get("id"), None)
                if slot is not None:
                    slot["msg"] = msg
                    slot["evt"].set()
        except OSError:
            pass
        finally:
            self._dead.set()
            with self._pending_lock:
                pending = list(self._pending.values())
                self._pending.clear()
            for slot in pending:
                slot["evt"].set()

    @property
    def alive(self) -> bool:
        return not self._dead.is_set() and self.proc.poll() is None

    def wait_ready(self, timeout: float = _SPAWN_TIMEOUT_S) -> None:
        """Block until the worker's ready banner; a worker that exited
        first (its device or kernel library failed) raises here with the
        tail of its log."""
        deadline = time.monotonic() + timeout
        while not self._ready.wait(0.05):
            if self._dead.is_set() or time.monotonic() >= deadline:
                break
        if not self._ready.is_set() or not self.alive:
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass
            raise TransportError(
                f"worker {self.name} failed to start on {self.device} "
                f"(exit={self.proc.poll()}, log={self.root / 'worker.log'}):\n"
                f"{self.log_tail()}"
            )

    def log_tail(self, n: int = _LOG_TAIL_BYTES) -> str:
        """The last `n` bytes of the worker's log (stdout and stderr)."""
        try:
            with open(self.root / "worker.log", "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(f.tell() - n, 0))
                return f.read().decode(errors="replace")
        except OSError as e:
            return f"<log unreadable: {e}>"

    # -- RPC ---------------------------------------------------------------
    def begin_call(
        self,
        topic: str,
        envelope: Optional[dict],
        *,
        env_json: Optional[str] = None,
    ) -> tuple:
        """Send the frame NOW (wire order = send order = the worker's
        ordered-thread apply order) and return a waiter handle for
        ``wait_reply`` — flush_worker sends under the journal lock but
        waits for the long-running reply outside it."""
        if not self.alive:
            raise TransportError(f"worker {self.name} down")
        mid = next(self._ids)
        slot: dict = {"evt": threading.Event(), "msg": None}
        with self._pending_lock:
            self._pending[mid] = slot
        if env_json is None:
            env_json = json.dumps(envelope)
        data = (
            '{"id": %d, "topic": %s, "env": %s}'
            % (mid, json.dumps(topic), env_json)
        ).encode()
        try:
            _send_frame(self._sock, self._send_lock, data=data)
        except OSError as e:
            with self._pending_lock:
                self._pending.pop(mid, None)
            self._dead.set()
            raise TransportError(f"worker {self.name} pipe closed: {e}") from e
        return mid, slot

    def wait_reply(self, handle: tuple, topic: str, timeout: float) -> dict:
        mid, slot = handle
        if not slot["evt"].wait(timeout):
            with self._pending_lock:
                self._pending.pop(mid, None)
            # the call may still complete worker-side; classify like a
            # budget-clamped RPC timeout — the worker is not dead
            raise TransportError(
                f"worker {self.name} call {topic} timed out", kind="deadline"
            )
        msg = slot["msg"]
        if msg is None:
            raise TransportError(f"worker {self.name} died mid-call")
        if not msg.get("ok"):
            err = TransportError(
                msg.get("error", "worker error"), kind=msg.get("kind", "error")
            )
            err.remote = True  # the worker's HANDLER raised (vs. transport)
            raise err
        return msg["reply"]

    def call(
        self,
        topic: str,
        envelope: Optional[dict],
        timeout: float = 30.0,
        *,
        env_json: Optional[str] = None,
    ) -> dict:
        """``env_json`` is the envelope pre-serialized: the write plane
        journals the encoded form, so the hot path serializes ONCE (the
        frame splices it in verbatim) instead of dumps-for-size +
        dumps-for-wire."""
        handle = self.begin_call(topic, envelope, env_json=env_json)
        return self.wait_reply(handle, topic, timeout)

    # -- lifecycle ----------------------------------------------------------
    def kill(self) -> None:
        """SIGKILL (chaos harness; the supervisor restarts + replays)."""
        try:
            self.proc.kill()
        except OSError:
            pass

    def close(self, timeout: float = 10.0) -> None:
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=5)
        self._dead.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._router.join(timeout=5)
        try:
            self._log.close()
        except OSError:
            pass
        procreg.unregister(self.proc.pid)


class WorkerTransport:
    """Liaison transport over the worker pipes: addr ``worker:<i>`` —
    a worker is one more scatter leg on the liaison's envelope contract."""

    def __init__(self, pool: "WorkerPool"):
        self._pool = pool

    def call(
        self, addr: str, topic: str, envelope: dict, timeout: float = 30.0
    ) -> dict:
        faults.maybe_fail_rpc(addr, topic)
        assert addr.startswith("worker:"), addr
        client = self._pool._clients[int(addr.split(":", 1)[1])]
        if client is None:
            raise TransportError(f"worker {addr} restarting")
        return client.call(topic, envelope, timeout=timeout)


# -- parent side: the pool ----------------------------------------------------


class WorkerPool:
    """N shard-owning worker processes behind an embedded Liaison.

    `device` (``backend.resolve_device``: the CUDA device by default;
    without CUDA the constructor raises unless ``"cpu"`` was asked for)
    is passed to every worker.  On the card the parent builds or loads
    the kernel library and puts it in the fleet's build cache
    (``fleet_cache_dir``) before the spawn, so each worker loads it and
    none runs ``nvcc``."""

    def __init__(
        self,
        root: str | Path,
        registry,
        n: int,
        *,
        query_budget_s: Optional[float] = None,
        journal_cap_mb: Optional[int] = None,
        device=None,
    ):
        from banyandb_tpu_torch.backend import resolve_device
        from banyandb_tpu_torch.obs.metrics import global_meter

        if n <= 0:
            raise ValueError("WorkerPool needs n >= 1 workers")
        self.device = resolve_device(device)
        self.root = Path(root) / "workers"
        self.registry = registry
        self.n = n
        self.meter = global_meter()
        self._names = [f"w{i:03d}" for i in range(n)]
        self._clients: list[Optional[WorkerClient]] = [None] * n
        self._jlocks = [threading.RLock() for _ in range(n)]
        self._journal: list[list] = [[] for _ in range(n)]
        self._jbytes = [0] * n
        self._seq = itertools.count(1)
        self._stopping = threading.Event()
        self.restarts = 0
        # workers whose registries may be behind the parent's (a schema
        # push failed while they were alive); the supervisor resyncs
        # them — restart-only catch-up would strand a live worker on
        # stale schema forever
        self._schema_stale: set[int] = set()
        self._stale_lock = threading.Lock()
        # parent-driven flush cadence: workers never drain memtables on
        # their own (worker_main passes local_flush=False), so the
        # supervisor flushes on the single-process loop's default
        # interval — same crash-loss window, journal trimmed in step
        from banyandb_tpu_torch.utils.envflag import env_float

        self._flush_interval_s = max(
            env_float("BYDB_WORKER_FLUSH_S", 1.0), 0.05
        )
        # supervisor-thread-only; seeded with now so the first periodic
        # flush waits a full interval (monotonic() is not epoch-0-based)
        self._last_flush = [time.monotonic()] * n
        cap_mb = (
            journal_cap_mb
            if journal_cap_mb is not None
            else env_int("BYDB_WORKER_JOURNAL_MB", 64)
        )
        self._journal_cap = max(cap_mb, 1) * (1 << 20)
        if self.device.type == "cuda":
            # N workers building the library at once on their first
            # query would each run nvcc and race to move the same file
            # into place: build (or load) it here and put it where the
            # workers' build cache looks
            from banyandb_tpu_torch.ops import hopper_kernels
            from banyandb_tpu_torch.utils.compile_cache import _DISABLE_VALUES

            cache = fleet_cache_dir(self.root)
            hopper_kernels.provide(
                None if cache.strip().lower() in _DISABLE_VALUES else cache
            )
        # spawn the fleet concurrently (each pays the interpreter+torch
        # import once), then wait for every ready banner; any failure —
        # a Popen OSError mid-fleet included — reaps what already spawned
        clients: list[WorkerClient] = []
        try:
            for i in range(n):
                # journal seqs restart with THIS parent process: a
                # flush.wm persisted under a previous parent's seq
                # domain would wrongly skip this domain's replay
                try:
                    os.remove(self.root / self._names[i] / "flush.wm")
                except OSError:
                    pass
                clients.append(
                    WorkerClient(
                        self._names[i], self.root / self._names[i],
                        str(self.device),
                    )
                )
            for c in clients:
                c.wait_ready()
        except Exception:
            for c in clients:
                c.kill()
                c.close(timeout=2)
            raise
        self._clients = clients
        self.transport = WorkerTransport(self)
        nodes = [NodeInfo(self._names[i], f"worker:{i}") for i in range(n)]
        self.liaison = Liaison(
            registry,
            self.transport,
            nodes,
            replicas=0,
            query_budget_s=query_budget_s,
        )
        try:
            self._sync_schema_full()
            # future schema creates on the parent registry push through
            # the same plane the cluster liaison uses
            registry.watch(self._on_schema_put)
            for i in range(n):
                self._ctl(i, {"op": "streamagg-load"})
            self.liaison.probe()
        except Exception:
            # __init__ raising means the owner never gets a pool to
            # stop(): reap the fleet here or N workers (and their
            # procreg entries) outlive the failed construction
            self._stopping.set()
            for c in clients:
                c.kill()
                c.close(timeout=2)
            raise
        self._supervisor = threading.Thread(
            target=self._supervise, name="bydb-worker-supervisor", daemon=True
        )
        self._supervisor.start()

    # -- schema plane --------------------------------------------------------
    def _schema_objects(self):
        """(kind, obj) for every stored schema object, groups first
        (measures/streams/rules reference their group)."""
        store = self.registry._store
        kinds = ["group"] + [k for k in store if k != "group"]
        for kind in kinds:
            for obj in store.get(kind, {}).values():
                yield kind, obj

    def _sync_schema_full(self) -> None:
        for kind, obj in self._schema_objects():
            try:
                self.liaison.sync_schema(kind, obj)
            except TransportError:
                log.exception("initial schema sync failed for %s", kind)
                self._mark_schema_stale()

    def _sync_schema_to(self, widx: int, client: WorkerClient) -> None:
        from banyandb_tpu_torch.api.schema import _to_jsonable

        for kind, obj in self._schema_objects():
            client.call(
                Topic.SCHEMA_SYNC.value,
                {"kind": kind, "item": _to_jsonable(obj)},
                timeout=_CTL_TIMEOUT_S,
            )

    def _mark_schema_stale(self) -> None:
        """A sync fan-out failed partway: liaison.sync_schema raises on
        the FIRST unreachable leg without reporting which workers it
        already reached, so every worker is suspect until the
        supervisor's (idempotent) full resync clears it."""
        with self._stale_lock:
            self._schema_stale.update(range(self.n))

    def _on_schema_put(self, kind: str, obj, revision: int) -> None:
        if self._stopping.is_set():
            return
        try:
            self.liaison.sync_schema(kind, obj)
        except Exception:  # noqa: BLE001 - never fail the local create:
            # a down worker catches up at restart via _sync_schema_to,
            # and a LIVE worker that missed the push (timeout, transient
            # pipe error) is resynced by the supervisor — without the
            # stale mark it would miss the schema until it crashed
            log.exception("schema push to workers failed for %s", kind)
            self._mark_schema_stale()

    # -- control -------------------------------------------------------------
    def _ctl(self, widx: int, env: dict, timeout: float = _CTL_TIMEOUT_S):
        client = self._clients[widx]
        if client is None:
            raise TransportError(f"worker {self._names[widx]} restarting")
        return client.call(CTL_TOPIC, env, timeout=timeout)

    # -- write plane ----------------------------------------------------------
    def _worker_of_shard(self, shard: int) -> int:
        # matches RoundRobinSelector placement over the zero-padded
        # name order (replicas=0): shard's primary is nodes[shard % n]
        return shard % self.n

    def _forward_write(self, widx: int, topic: str, env: dict) -> None:
        """Journal-then-forward (handoff-style ack): transport death
        keeps the entry for restart replay and still acks; a worker-side
        REJECTION (validation, shed) drops the entry and propagates —
        replaying it later would fail identically.

        The envelope is serialized exactly ONCE: the journal holds the
        encoded form (halves journal memory vs dict + re-dump), the wire
        frame splices it in verbatim, and replay re-sends the same
        bytes.  The journal seq is spliced into the encoded envelope as
        ``_seq`` (a string prepend, no re-serialization): the worker
        records the last seq it applied and persists it with each
        flush, so replay after a crash can skip entries whose rows are
        already in parts on disk — the at-least-once edge that would
        otherwise duplicate stream/trace appends (no version dedup)."""
        env_json = json.dumps(env)
        size = len(env_json)
        with self._jlocks[widx]:
            dead = (
                self._clients[widx] is None
                or not self._clients[widx].alive
            )
            if dead and self._jbytes[widx] + size > self._journal_cap:
                # the pressure valve for a dead worker: nothing can trim
                # the spool (journal-pressure flush needs a live worker),
                # so past the cap the write SHEDS — a retryable
                # ServerBusy (kind="shed" on the wire, the wqueue
                # high-watermark contract) instead of acking into
                # unbounded parent memory
                from banyandb_tpu_torch.admin.protector import ServerBusy

                self.meter.counter_add(
                    "worker_journal_shed", 1.0,
                    {"worker": self._names[widx]},
                )
                raise ServerBusy(
                    f"worker {self._names[widx]} down and its write "
                    f"journal is full ({self._jbytes[widx]} bytes >= "
                    f"{self._journal_cap}); retry after restart"
                )
            seq = next(self._seq)
            # write envelopes are never the empty object, so the splice
            # below always yields valid JSON
            env_json = '{"_seq": %d, %s' % (seq, env_json[1:])
            size = len(env_json)
            self._journal[widx].append((seq, topic, env_json, size))
            # bdlint: disable=wp-shared-state -- every write to the
            # journal fields happens under self._jlocks[widx] (a
            # per-worker lock held by THIS with-block and by
            # flush_worker/_restart); the analyzer's lockset model
            # tracks attribute locks, not per-index list elements
            self._jbytes[widx] += size
            client = self._clients[widx]
            if client is None or not client.alive:
                return  # spooled ack: replay delivers after restart
            # SEND under the lock (the frame must hit the worker's
            # ordered thread in journal-seq order), but wait for the
            # reply OUTSIDE it — same split as flush_worker — so one
            # slow apply doesn't serialize every writer thread and the
            # flush loop behind a worker-long lock hold.
            try:
                handle = client.begin_call(topic, None, env_json=env_json)
            except TransportError:
                # pipe died at send: journaled + acked (spooled ack);
                # restart replay delivers
                return
        try:
            client.wait_reply(handle, topic, _WRITE_TIMEOUT_S)
        except TransportError as e:
            if getattr(e, "remote", False):
                with self._jlocks[widx]:
                    # remove by seq — concurrent writes may have
                    # journaled behind this entry while we waited
                    j = self._journal[widx]
                    for k in range(len(j) - 1, -1, -1):
                        if j[k][0] == seq:
                            del j[k]
                            self._jbytes[widx] -= size
                            break
                raise
            # died/timed out mid-call: journaled + acked; an
            # applied-but-unacked duplicate collapses in the
            # (series, ts, version) dedup on replay

    def write_measure(self, req) -> int:
        """Row-shaped measure write partitioned by the existing shard
        hash; returns the accepted point count (the 0-mode contract)."""
        from banyandb_tpu_torch.api.model import WriteRequest

        m = self.registry.get_measure(req.group, req.name)
        shard_num = self.registry.get_group(req.group).resource_opts.shard_num
        buckets: dict[int, list] = {}
        for p in req.points:
            entity = [req.name.encode()] + [
                hashing.entity_bytes(p.tags[t]) for t in m.entity.tag_names
            ]
            shard = hashing.shard_id(hashing.series_id(entity), shard_num)
            buckets.setdefault(self._worker_of_shard(shard), []).append(p)
        for widx, pts in sorted(buckets.items()):
            env = {
                "request": serde.write_request_to_json(
                    WriteRequest(req.group, req.name, tuple(pts))
                )
            }
            self._forward_write(widx, Topic.MEASURE_WRITE.value, env)
        return len(req.points)

    def write_measure_columns(self, env: dict) -> int:
        """Columnar envelope: decode once, route rows by vectorized
        entity hashing (the engine's own series_ids_for_columns), and
        forward per-worker slices re-encoded with the same codec."""
        import numpy as np

        from banyandb_tpu_torch.models.measure import (
            DictColumn,
            series_ids_for_columns,
        )

        cols = serde.write_columns_env_decode(env)
        group, name = cols["group"], cols["name"]
        m = self.registry.get_measure(group, name)
        shard_num = self.registry.get_group(group).resource_opts.shard_num
        n = int(cols["ts_millis"].size)
        if n == 0:
            return 0
        # 0-mode parity on the ERROR path: the engine's write_columns
        # validates every column before touching a memtable, but a
        # worker may be down at forward time (journal-spooled ack), so
        # the worker's validation can run AFTER this call returned
        # written=n — a ragged non-entity column would be acked, then
        # deterministically rejected at replay and silently lost.
        # Validate the full envelope here, before anything is acked.
        for t in m.tags:
            col = cols["tags"].get(t.name)
            if col is None:
                continue
            if isinstance(col, DictColumn):
                codes = np.asarray(col.codes)
                if len(codes) != n:
                    raise ValueError(
                        f"tag {t.name}: {len(codes)} codes for {n} rows"
                    )
                if codes.size and (
                    int(codes.min()) < 0
                    or int(codes.max()) >= len(col.values)
                ):
                    raise ValueError(
                        f"tag {t.name}: code out of range for dict of "
                        f"{len(col.values)}"
                    )
            elif len(col) != n:
                raise ValueError(
                    f"tag {t.name}: {len(col)} values for {n} rows"
                )
        for f in m.fields:
            fcol = cols["fields"].get(f.name)
            if fcol is not None and len(fcol) != n:
                raise ValueError(
                    f"field {f.name}: {len(fcol)} values for {n} rows"
                )
        if cols.get("versions") is not None and len(cols["versions"]) != n:
            raise ValueError(f"{len(cols['versions'])} versions for {n} rows")
        ent_cols = []
        for t in m.entity.tag_names:
            col = cols["tags"].get(t)
            if col is None:
                raise KeyError(t)
            if isinstance(col, DictColumn):
                codes = np.asarray(col.codes)
                ent_cols.append(
                    DictColumn(
                        [
                            hashing.entity_bytes(v) if v is not None else b""
                            for v in col.values
                        ],
                        codes,
                    )
                )
            else:
                ent_cols.append(
                    [
                        hashing.entity_bytes(v) if v is not None else b""
                        for v in col
                    ]
                )
        sids, _ = series_ids_for_columns(name, ent_cols, n)
        widx = (sids % shard_num) % self.n
        for w in np.unique(widx).tolist():
            idx = np.nonzero(widx == w)[0]
            sub = (
                env
                if len(idx) == n
                else serde.write_columns_env_slice(cols, idx)
            )
            self._forward_write(int(w), Topic.MEASURE_WRITE_COLUMNS.value, sub)
        return n

    def write_stream(self, group: str, name: str, elements: list[dict]) -> int:
        """Same shard routing + envelope the liaison's write_stream
        would send, but through the parent journal: the crash contract
        ('worker death loses nothing acked') covers every model, so
        stream writes spool/replay exactly like measure writes."""
        from banyandb_tpu_torch.api.schema import _to_jsonable

        schema = _to_jsonable(self.registry.get_stream(group, name))
        shard_num = self.registry.get_group(group).resource_opts.shard_num
        entity_tags = schema["entity"]
        buckets: dict[int, list] = {}
        for e in elements:
            entity = [name.encode()] + [
                hashing.entity_bytes(e["tags"][t]) for t in entity_tags
            ]
            shard = hashing.shard_id(hashing.series_id(entity), shard_num)
            buckets.setdefault(self._worker_of_shard(shard), []).append(e)
        for widx, elems in sorted(buckets.items()):
            env = {
                "group": group, "name": name,
                "schema": schema, "elements": elems,
            }
            self._forward_write(widx, Topic.STREAM_WRITE.value, env)
        return len(elements)

    def write_trace(
        self, group: str, name: str, spans: list[dict], ordered_tags=()
    ) -> int:
        """Trace twin of write_stream: journaled-then-forwarded."""
        from banyandb_tpu_torch.api.schema import _to_jsonable
        from banyandb_tpu_torch.models.trace import trace_shard_id

        schema = _to_jsonable(self.registry.get_trace(group, name))
        shard_num = self.registry.get_group(group).resource_opts.shard_num
        tid_tag = schema["trace_id_tag"]
        buckets: dict[int, list] = {}
        for s in spans:
            shard = trace_shard_id(str(s["tags"][tid_tag]), shard_num)
            buckets.setdefault(self._worker_of_shard(shard), []).append(s)
        for widx, batch in sorted(buckets.items()):
            env = {
                "group": group, "name": name, "schema": schema,
                "spans": batch, "ordered_tags": list(ordered_tags),
            }
            self._forward_write(widx, Topic.TRACE_WRITE.value, env)
        return len(spans)

    # -- query plane ----------------------------------------------------------
    def query_measure(self, req, tracer=None):
        return self.liaison.query_measure(req, tracer=tracer)

    def query_stream(self, req, tracer=None):
        return self.liaison.query_stream(req, tracer=tracer)

    def query_trace_by_id(self, group: str, name: str, trace_id: str):
        return self.liaison.query_trace_by_id(group, name, trace_id)

    def query_trace_ordered(self, *a, **kw):
        return self.liaison.query_trace_ordered(*a, **kw)

    def query_trace(self, req, tracer=None):
        return self.liaison.query_trace(req, tracer=tracer)

    def topn(self, env: dict) -> dict:
        """Scatter the node-local TopN ranking to every worker and
        re-rank the union — entities are shard-routed, so per-worker
        entity sets are disjoint and concat is exact.  A down worker (or
        a leg lost to a transport failure) degrades the answer, so the
        reply carries the measure/stream ``degraded``/``unavailable_nodes``
        markers instead of posing as complete."""
        # agg="count" flattens every ranked item to 1.0 AFTER the
        # truncation (query_topn's distinct-best contract) — workers
        # must therefore rank on the underlying distinct-best value
        # (any non-count agg equals it) or the parent re-rank would
        # sort a sea of 1.0s by entity and pick a different top-n set
        # than BYDB_WORKERS=0
        agg = env.get("agg", "sum")
        wenv = dict(env, agg="sum") if agg == "count" else env
        items: list[dict] = []
        unavailable: list[str] = []
        for i in range(self.n):
            client = self._clients[i]
            if client is None or not client.alive:
                unavailable.append(self._names[i])
                continue  # degraded TopN over surviving workers
            try:
                items.extend(client.call("topn", wenv, timeout=30.0)["items"])
            except TransportError as e:
                if getattr(e, "remote", False):
                    raise  # e.g. unknown rule: 0-mode parity
                unavailable.append(self._names[i])
        desc = env.get("direction", "desc") != "asc"
        # (value, entity) key matches models/topn.py query_topn's
        # tie-break, so equal values rank identically vs BYDB_WORKERS=0
        items.sort(
            key=lambda it: (it["value"], tuple(it["entity"])), reverse=desc
        )
        items = items[: env.get("n", 10)]
        if agg == "count":
            items = [{"entity": it["entity"], "value": 1.0} for it in items]
        out: dict = {"items": items}
        if unavailable:
            out["degraded"] = True
            out["unavailable_nodes"] = sorted(unavailable)
        return out

    def streamagg(self, env: dict) -> dict:
        op = env.get("op", "stats")
        if op == "register":
            acks = self.liaison.register_streamagg(
                env["group"],
                env["measure"],
                key_tags=tuple(env.get("key_tags", ())),
                fields=tuple(env.get("fields", ())),
                window_millis=env.get("window_millis"),
                max_windows=env.get("max_windows"),
                origin=env.get("origin", "manual"),
            )
            return {"registered": acks}
        if op == "unregister":
            acks = self.liaison.unregister_streamagg(
                env["group"],
                env["measure"],
                key_tags=tuple(env.get("key_tags", ())),
                fields=tuple(env.get("fields", ())),
                window_millis=env.get("window_millis"),
            )
            return {
                "unregistered": any(
                    a.get("unregistered") for a in acks.values()
                ),
                "acks": acks,
            }
        if op == "stats":
            out = {}
            for i in range(self.n):
                client = self._clients[i]
                if client is None or not client.alive:
                    continue
                try:
                    out[self._names[i]] = client.call(
                        "streamagg", {"op": "stats"}, timeout=30.0
                    ).get("streamagg")
                except TransportError as e:
                    if getattr(e, "remote", False):
                        raise
                    # died between the alive check and the call: skip,
                    # like topn()/metrics_text() — stats stay degradable
            return {"streamagg": out}
        raise ValueError(f"bad streamagg op {op!r}")

    # -- flush / journal trim -------------------------------------------------
    def flush_worker(self, widx: int, group: Optional[str] = None) -> list:
        """Flush one worker's memtables and trim its journal to the
        watermark the WORKER reports back (the last journal seq it had
        applied when the flush drained its memtables — every row at or
        below it is now in parts on disk, durably marked by the
        worker's flush.wm file).  A group-scoped flush reports no
        watermark (other groups' memtables still hold journaled rows)
        and trims nothing.

        The flush frame is SENT under the journal lock — it must order
        after every delivered write on the worker's ordered thread —
        but the reply wait happens OUTSIDE it: a flush can run for
        seconds and must not stall ingest to this worker's shards.
        Writes that land while the flush runs apply after it, get
        seq > wm, and are untouched by the trim."""
        with self._jlocks[widx]:
            client = self._clients[widx]
            if client is None or not client.alive:
                return []
            handle = client.begin_call(
                CTL_TOPIC, {"op": "flush", "group": group}
            )
        r = client.wait_reply(handle, CTL_TOPIC, _CTL_TIMEOUT_S)
        wm = r.get("flush_wm")
        if wm is None:
            return r.get("parts", [])
        with self._jlocks[widx]:
            if self._clients[widx] is not client:
                # the worker restarted while we waited: replay already
                # re-delivered the journal; a stale watermark must not
                # trim entries the fresh incarnation still needs
                return r.get("parts", [])
            j = self._journal[widx]
            keep = [e for e in j if e[0] > wm]
            self._jbytes[widx] -= sum(e[3] for e in j) - sum(
                e[3] for e in keep
            )
            # bdlint: disable=wp-shared-state -- guarded by
            # self._jlocks[widx] (held by this with-block), same
            # per-worker-lock invariant as _jbytes
            self._journal[widx] = keep
            return r.get("parts", [])

    def flush(self, group: Optional[str] = None) -> list:
        out: list = []
        for i in range(self.n):
            try:
                out.extend(self.flush_worker(i, group))
            except TransportError:
                log.exception("flush of worker %s failed", self._names[i])
        return out

    # -- obs ------------------------------------------------------------------
    def metrics_text(self) -> str:
        """Worker expositions merged with per-worker labels (the
        scatter:<node> graft idea applied to /metrics)."""
        parts = []
        for i in range(self.n):
            client = self._clients[i]
            if client is None or not client.alive:
                continue
            try:
                text = client.call("metrics", {}, timeout=10.0)["prometheus"]
            except TransportError:
                continue
            parts.append(
                relabel_exposition(text, {"worker": self._names[i]})
            )
        return "\n".join(p for p in parts if p)

    def stats(self) -> dict:
        return {
            "workers": self.n,
            "alive": sorted(self.liaison.alive),
            "restarts": self.restarts,
            "journal_bytes": list(self._jbytes),
            "journal_entries": [len(j) for j in self._journal],
        }

    # -- crash supervision ----------------------------------------------------
    def kill_worker(self, widx: int) -> int:
        """SIGKILL one worker (chaos harness).  Returns its pid; the
        supervisor restarts it and replays the journal."""
        client = self._clients[widx]
        if client is None:
            raise RuntimeError(f"worker {widx} already restarting")
        pid = client.proc.pid
        client.kill()
        return pid

    def _replay_locked(self, widx: int, client: WorkerClient) -> int:
        replayed = 0
        kept = []
        for entry in self._journal[widx]:
            seq, topic, env_json, size = entry
            if seq <= client.flush_wm:
                # the dead incarnation flushed this entry into parts
                # (its persisted flush.wm proves it) but died before
                # the parent's trim: re-sending would append
                # stream/trace rows a second time
                self._jbytes[widx] -= size
                continue
            try:
                client.call(
                    topic, None, timeout=_WRITE_TIMEOUT_S, env_json=env_json
                )
                kept.append(entry)
                replayed += 1
            except TransportError as e:
                if (
                    getattr(e, "remote", False)
                    and getattr(e, "kind", "error") == "error"
                ):
                    # a DETERMINISTIC rejection (validation): it would
                    # have failed live too — drop, never wedge the
                    # replay.  Shed/deadline kinds are transient
                    # (DiskFull/ServerBusy from a healthy worker): the
                    # entry was ACKED, so it must survive for the
                    # supervisor's next restart+replay attempt.
                    log.warning(
                        "replay drop on %s: %s", self._names[widx], e
                    )
                    self._jbytes[widx] -= size
                    continue
                # died again mid-replay, or a transient shed: keep THIS
                # and all later entries for the next attempt
                kept.extend(
                    x for x in self._journal[widx] if x[0] >= seq
                )
                self._journal[widx] = kept
                raise
        self._journal[widx] = kept
        return replayed

    def _restart(self, widx: int) -> None:
        name = self._names[widx]
        with self._jlocks[widx]:
            old, self._clients[widx] = self._clients[widx], None
        if old is not None:
            old.close(timeout=5)
        if self._stopping.is_set():
            return  # shutdown raced the crash: reap only, never respawn
        self.restarts += 1
        self.meter.counter_add("worker_restarts", 1.0, {"worker": name})
        log.warning("worker %s died; restarting (replay from journal)", name)
        client = WorkerClient(name, self.root / name, str(self.device))
        try:
            client.wait_ready()
            self._sync_schema_to(widx, client)
            with self._stale_lock:
                self._schema_stale.discard(widx)
            with self._jlocks[widx]:
                self._replay_locked(widx, client)
                self._clients[widx] = client
            # streamagg AFTER replay: the backfill snapshot now holds
            # surviving parts + replayed memtable rows in one dedup pass
            client.call(CTL_TOPIC, {"op": "streamagg-load"}, timeout=_CTL_TIMEOUT_S)
        except TransportError:
            client.kill()
            client.close(timeout=2)
            raise
        self.liaison.forget_streamagg_sent(name)
        self.liaison.probe()

    def _supervise(self) -> None:
        while not self._stopping.wait(0.25):
            needs_probe = False
            for i in range(self.n):
                if self._stopping.is_set():
                    return
                client = self._clients[i]
                # a None slot means a previous restart attempt failed
                # mid-flight (spawn/schema-sync/replay raised after the
                # slot was cleared) — it must keep retrying, or the
                # worker stays down for the process lifetime
                if client is None or not client.alive:
                    try:
                        self._restart(i)
                    except Exception:  # noqa: BLE001 - retry next tick
                        log.exception(
                            "worker %s restart failed", self._names[i]
                        )
                        time.sleep(0.5)
                    continue
                # schema reconcile: a live worker that missed a push
                # gets the full (idempotent) object set again
                with self._stale_lock:
                    stale = i in self._schema_stale
                if stale:
                    try:
                        self._sync_schema_to(i, client)
                        with self._stale_lock:
                            self._schema_stale.discard(i)
                    except TransportError:
                        log.exception(
                            "schema resync to %s failed", self._names[i]
                        )
                # liveness reconcile: one errored scatter leg evicts a
                # worker from liaison.alive, but only probe() readmits
                # it — without this, a healthy worker whose handler once
                # raised degrades every later query until it crashes
                if self._names[i] not in self.liaison.alive:
                    needs_probe = True
                now = time.monotonic()
                if self._jbytes[i] > self._journal_cap or (
                    self._journal[i]
                    and now - self._last_flush[i] >= self._flush_interval_s
                ):
                    # workers never drain memtables themselves
                    # (local_flush=False): this tick is THE flush loop
                    # for worker shards, and the only journal trim
                    self._last_flush[i] = now
                    try:
                        self.flush_worker(i)
                    except TransportError:
                        log.exception(
                            "parent-driven flush of %s failed",
                            self._names[i],
                        )
            if needs_probe:
                self.liaison.probe()

    def stop(self) -> None:
        self._stopping.set()
        # a restart in flight holds the supervisor (spawn + schema sync
        # + replay can exceed a short join); wait it out — leaking the
        # supervisor thread would fail the bdsan thread-parity check
        self._supervisor.join(timeout=_SPAWN_TIMEOUT_S)
        for i in range(self.n):
            client = self._clients[i]
            if client is None:
                continue
            try:
                if client.alive:
                    client.call(CTL_TOPIC, {"op": "stop"}, timeout=30.0)
            except TransportError:
                pass
            client.close()
            self._clients[i] = None


# -- engine-shaped adapters (WireServices / TopN / self-measure reuse) --------


class PoolMeasureAdapter:
    """Engine-shaped facade over the pool's distributed measure plane
    (the _LiaisonMeasureAdapter idea, intra-node edition): TopN
    post-processing and the self-measure sink run against the pool
    without knowing about processes."""

    def __init__(self, pool: WorkerPool):
        self._pool = pool
        self.registry = pool.registry

    def query(self, req, shard_ids=None, tracer=None):
        return self._pool.query_measure(req, tracer=tracer)

    def write(self, req, _internal: bool = False) -> int:
        return self._pool.write_measure(req)

    def write_points_bulk(self, req) -> int:
        return self._pool.write_measure(req)

    def flush(self, group=None) -> list:
        return self._pool.flush(group)

    def topn_scatter(self, env: dict) -> dict:
        """The wire's TopN entry in worker mode: result-measure rows
        live worker-locally in arbitrary shards (each worker's TopN
        manager writes its own winners), so a shard-routed
        query_measure would silently miss rows — the pool's concat
        re-rank over the per-worker ranked lists is the exact plane."""
        return self._pool.topn(env)


class PoolStreamAdapter:
    """Stream twin of PoolMeasureAdapter: queries scatter through the
    embedded liaison, writes journal-then-forward through the pool —
    the wire surface's acks get the same crash contract as bus writes."""

    def __init__(self, pool: WorkerPool):
        self._pool = pool

    def query(self, req, shard_ids=None):
        return self._pool.query_stream(req)

    def write(self, group: str, name: str, elements) -> int:
        import base64

        return self._pool.write_stream(
            group, name,
            [
                {
                    "element_id": e.element_id,
                    "ts": e.ts_millis,
                    "tags": e.tags,
                    "body": base64.b64encode(e.body).decode(),
                }
                for e in elements
            ],
        )


class PoolTraceAdapter:
    """Trace-engine facade for ql_exec.execute_trace_ql over workers.
    Writes journal through the pool like every other model."""

    def __init__(self, pool: WorkerPool):
        self._pool = pool

    def get_trace(self, group: str, name: str):
        return self._pool.registry.get_trace(group, name)

    def query_by_trace_id(self, group: str, name: str, trace_id: str):
        return self._pool.query_trace_by_id(group, name, trace_id)

    def query_ordered(self, group, name, order_tag, time_range, **kw):
        kw.pop("with_keys", None)
        return self._pool.query_trace_ordered(
            group, name, order_tag, time_range, **kw
        )

    def query(self, req, *, shard_ids=None, tracer=None):
        return self._pool.query_trace(req, tracer=tracer)

    def write(self, group: str, name: str, spans, *, ordered_tags=()) -> int:
        import base64

        return self._pool.write_trace(
            group, name,
            [
                {
                    "ts": s.ts_millis,
                    "tags": s.tags,
                    "span": base64.b64encode(s.span).decode(),
                }
                for s in spans
            ],
            ordered_tags=tuple(ordered_tags),
        )


# -- exposition relabeling ----------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})?( .+)$"
)


def relabel_exposition(text: str, extra: dict) -> str:
    """Inject labels into every sample line of a Prometheus exposition
    (comment lines dropped — the merged text is for scrapers, which
    aggregate across the injected label)."""
    inject = ",".join(f'{k}="{v}"' for k, v in sorted(extra.items()))
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, _, labels, rest = m.groups()
        merged = f"{labels},{inject}" if labels else inject
        out.append(f"{name}{{{merged}}}{rest}")
    return "\n".join(out)


# -- worker side --------------------------------------------------------------


def _read_wm(path: Optional[Path]) -> int:
    if path is None:
        return 0
    try:
        return int(path.read_text().strip() or 0)
    except (OSError, ValueError):
        return 0


def _write_wm(path: Optional[Path], seq: int) -> None:
    """Persist the flush watermark atomically (tmp + rename): a crash
    mid-write must leave the OLD watermark, never a torn one — replay
    over-delivery is collapsible for measures and bounded for
    streams/traces only because the watermark is trustworthy."""
    if path is None:
        return
    # disk-fault boundary: ENOSPC raises before the tmp write, so the
    # rename never runs and the OLD watermark stays authoritative
    faults.check_disk("worker-watermark")
    tmp = path.with_suffix(".tmp")
    tmp.write_text(str(seq))
    os.replace(tmp, path)


class _WorkerServer:
    """Serve a DataNode's bus over the parent socketpair: ordered
    topics on ONE writer thread (journal-seq apply order), the rest on
    a small executor."""

    def __init__(
        self,
        sock: socket.socket,
        node,
        wm_path: Optional[Path] = None,
        banner: Optional[dict] = None,
    ):
        import queue
        from concurrent import futures

        self.sock = sock
        self.node = node
        self.wm_path = wm_path
        self.banner = dict(banner or {})
        # last parent-journal seq applied on the writer thread; the
        # flush ctl op persists it NEXT TO the parts it drained, so a
        # restart replays only entries the durable state lacks.  Written
        # and read on the writer thread alone (ctl is an ordered topic).
        self.applied_seq = _read_wm(wm_path)
        self._send_lock = threading.Lock()
        self._stop = threading.Event()
        self._writeq: "queue.Queue" = queue.Queue()
        self._pool = futures.ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="bydb-worker-rpc"
        )
        self._writer = threading.Thread(
            target=self._write_loop, name="bydb-worker-writer", daemon=True
        )

    def request_stop(self) -> None:
        self._stop.set()
        try:
            # unblocks the main recv loop; replies still flush out
            self.sock.shutdown(socket.SHUT_RD)
        except OSError:
            pass

    def _reply(self, mid, payload: dict) -> None:
        try:
            _send_frame(self.sock, self._send_lock, dict(payload, id=mid))
        except OSError:
            self._stop.set()

    def _handle(self, msg: dict) -> None:
        try:
            env = msg.get("env") or {}
            reply = self.node.bus.handle(msg["topic"], env)
            if msg["topic"] in ORDERED_TOPICS and "_seq" in env:
                # bdlint: disable=wp-shared-state -- the ORDERED_TOPICS
                # guard makes this branch writer-thread-only (serve()
                # routes every ordered topic to the single writer
                # thread; the executor never sees one), so applied_seq
                # is single-writer and read on the same thread by the
                # ctl flush handler
                self.applied_seq = env["_seq"]
            self._reply(msg["id"], {"ok": True, "reply": reply})
        except Exception as e:  # noqa: BLE001 - errors cross the pipe
            self._reply(
                msg["id"],
                {
                    "ok": False,
                    "kind": _error_kind(e),
                    "error": f"{type(e).__name__}: {e}",
                },
            )

    def _write_loop(self) -> None:
        while True:
            msg = self._writeq.get()
            if msg is None:
                return
            self._handle(msg)

    def serve(self) -> None:
        self._writer.start()
        _send_frame(
            self.sock,
            self._send_lock,
            dict(
                self.banner,
                ready=True, pid=os.getpid(), flush_wm=self.applied_seq,
            ),
        )
        try:
            while not self._stop.is_set():
                msg = _recv_frame(self.sock)
                if msg is None:
                    break
                if msg.get("topic") in ORDERED_TOPICS:
                    self._writeq.put(msg)
                else:
                    self._pool.submit(self._handle, msg)
        finally:
            self._writeq.put(None)
            self._writer.join(timeout=10)
            self._pool.shutdown(wait=True)


def _ctl_handler(node, server: _WorkerServer, env: dict) -> dict:
    op = env.get("op", "ping")
    if op == "ping":
        return {"pong": True, "pid": os.getpid()}
    if op == "flush":
        # runs ON the writer thread (CTL_TOPIC is ordered): every write
        # received before this frame is applied, so the parent's
        # last-forwarded seq is a sound journal trim watermark
        # pending TopN windows emit into the result measure first (the
        # emissions are ordinary versioned writes; later data re-emits
        # with a higher version), so they reach the flushed parts
        node.measure.topn.flush_all_windows()
        parts = list(node.measure.flush(env.get("group")))
        parts += node.stream.flush(env.get("group"))
        parts += node.trace.flush(env.get("group"))
        # group-scoped flushes leave other groups' memtables undrained:
        # rows <= applied_seq may then exist ONLY in the journal, so the
        # watermark (and the trim it licenses) must not advance
        if env.get("group") is None:
            _write_wm(server.wm_path, server.applied_seq)
            return {"parts": parts, "flush_wm": server.applied_seq}
        return {"parts": parts}
    if op == "streamagg-load":
        return {"loaded": node.measure.streamagg.load_persisted()}
    if op == "stop":
        server.request_stop()
        return {"stopping": True}
    raise ValueError(f"bad worker-ctl op {op!r}")


def _metrics_reply(env: dict) -> dict:
    """The worker's ``metrics`` topic: the process-global meter's
    exposition, with this process's kernel-library build cache
    (``compile_cache_*``) and its per-kernel launch counts
    (``kernel_launches{kernel=...}``, ``hopper_kernels.LAUNCHES``) set
    just before the render — launches are per process, so the parent
    reads the workers' through ``WorkerPool.metrics_text``."""
    from banyandb_tpu_torch.obs.metrics import global_meter
    from banyandb_tpu_torch.ops import hopper_kernels
    from banyandb_tpu_torch.utils import compile_cache

    meter = global_meter()
    cc = compile_cache.stats()
    meter.gauge_set("compile_cache_enabled", float(cc["enabled"]))
    for k in ("hits", "misses", "entries", "builds", "loads"):
        meter.gauge_set(f"compile_cache_{k}", float(cc[k]))
    for k, n in hopper_kernels.LAUNCHES.items():
        meter.gauge_set("kernel_launches", float(n), {"kernel": k})
    return {"prometheus": meter.prometheus_text()}


def _open_device(device: str) -> dict:
    """Bring up the worker's device before the ready banner.  On the
    card: initialize CUDA and load the kernel library from the build
    cache (the parent put it there).  Any failure raises, and the
    worker exits non-zero before it is ready: it never serves from the
    CPU in place of the card.  -> the banner's device fields."""
    import torch

    from banyandb_tpu_torch.backend import resolve_device
    from banyandb_tpu_torch.utils import compile_cache

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.init()
        from banyandb_tpu_torch.ops import hopper_kernels

        hopper_kernels.build()
    return {"device": str(dev), "compile_cache": compile_cache.stats()}


def worker_main(argv=None) -> int:
    """Worker process entry (``python -m banyandb_tpu_torch.cluster.workers``):
    a DataNode over its own root on ``--device``, served over the parent
    socketpair.  This function is a PROCESS root: everything it reaches
    runs outside the parent's thread population (wp-shared-state models
    it as a thread root)."""
    import argparse

    ap = argparse.ArgumentParser("bydb shard worker")
    ap.add_argument("--fd", type=int, required=True)
    ap.add_argument("--root", required=True)
    ap.add_argument("--name", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from banyandb_tpu_torch.api.schema import SchemaRegistry
    from banyandb_tpu_torch.cluster.data_node import DataNode
    from banyandb_tpu_torch.utils import compile_cache

    sock = socket.socket(  # bdlint: disable=resource-hygiene -- the
        # worker's lifetime handle to its parent; closed in the
        # serve() finally below
        fileno=args.fd
    )
    root = Path(args.root)
    # workers share the pool's build cache of the kernel library (the
    # parent stamps BYDB_COMPILE_CACHE_DIR into the child env and puts
    # the library there first): each worker loads it, none builds it
    compile_cache.enable()
    banner = _open_device(args.device)
    registry = SchemaRegistry(root)
    node = DataNode(args.name, registry, root / "data", device=banner["device"])
    server = _WorkerServer(sock, node, wm_path=root / "flush.wm", banner=banner)
    node.bus.subscribe(CTL_TOPIC, lambda env: _ctl_handler(node, server, env))
    node.bus.subscribe("metrics", _metrics_reply)
    # local_flush=False: memtables drain ONLY through the parent's ctl
    # flush (the journal-trim watermark path).  A loop-driven drain here
    # would persist journaled rows the parent never trimmed — after a
    # SIGKILL the replay would then append stream/trace elements a
    # second time (no version dedup in those models).  Merge/retention/
    # rotation/blooms/index-persist keep their normal cadence.
    node.start_lifecycle(local_flush=False)
    try:
        server.serve()
    finally:
        try:
            node.stop_lifecycle()
            node.measure.close()
            node.stream.close()
            node.trace.close()
        except Exception:  # noqa: BLE001 - exit anyway; parent owns the
            # durability story (journal + parts already on disk)
            log.exception("worker %s teardown failed", args.name)
        try:
            sock.close()
        except OSError:
            pass
    return 0


if __name__ == "__main__":
    sys.exit(worker_main())
