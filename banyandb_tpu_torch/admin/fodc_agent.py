"""FODC per-node agent: watchdog, flight recorder, pressure profiler.

Analog of the reference's fodc agent internals
(upstream fodc/agent/internal/watchdog/watchdog.go,
fodc/agent/internal/flightrecorder, fodc/agent/internal/pressureprofiler
+ fodc/internal/pprofcapture): the watchdog polls local metric sources on
an interval with bounded retry/backoff and forwards each cycle to the
flight recorder (a windowed in-memory ring the proxy can query); the
pressure profiler rides the watchdog as a post-poll hook and captures
profile artifacts to disk when RSS crosses a cgroup-derived threshold.

Re-scoped for this runtime: the reference scrapes Prometheus HTTP
endpoints and shells out to pprof; here metric sources are in-process
callables (the admin.metrics.Meter, process stats) and a "profile" is
the profiling module's thread/heap/runtime text artifacts — the eBPF
kernel telemetry is host-specific and intentionally out of scope.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from pathlib import Path
from typing import Callable, Optional

# fodc/v1 MetricType enum values (api/proto/banyandb/fodc/v1/rpc.proto)
GAUGE = "gauge"
COUNTER = "counter"
HISTOGRAM = "histogram"

PPROF_TOPIC = "fodc-pprof"  # on-demand capture over the cluster bus


@dataclasses.dataclass(frozen=True)
class RawMetric:
    """One sample: the fodc/v1 Metric message shape, host-side."""

    name: str
    labels: tuple  # sorted (k, v) pairs
    value: float
    type: str = GAUGE
    ts_millis: int = 0


def meter_source(meter) -> Callable[[], list[RawMetric]]:
    """Adapt an admin.metrics.Meter into a watchdog metric source."""

    def poll() -> list[RawMetric]:
        now = int(time.time() * 1000)
        snap = meter.snapshot()
        pfx = (meter.scope + "_") if meter.scope else ""
        out = [
            RawMetric(pfx + n + "_total", lbls, v, COUNTER, now)
            for (n, lbls), v in snap["counters"].items()
        ]
        out += [
            RawMetric(pfx + n, lbls, v, GAUGE, now)
            for (n, lbls), v in snap["gauges"].items()
        ]
        for (n, lbls), (count, total) in snap["histograms"].items():
            out.append(RawMetric(pfx + n + "_count", lbls, count, HISTOGRAM, now))
            out.append(RawMetric(pfx + n + "_sum", lbls, total, HISTOGRAM, now))
        return out

    return poll


def process_source() -> list[RawMetric]:
    """RSS / thread-count gauges (fodc watchdog's runtime params poll)."""
    from banyandb_tpu_torch.admin.protector import process_rss

    now = int(time.time() * 1000)
    return [
        RawMetric("process_resident_memory_bytes", (), float(process_rss()), GAUGE, now),
        RawMetric("process_threads", (), float(threading.active_count()), GAUGE, now),
    ]


def io_source() -> Callable[[], list[RawMetric]]:
    """Host IO telemetry: the ktm eBPF io-monitor re-scoped to /proc
    (fodc/agent/internal/ktm/iomonitor, loader.go:54 — kernel BPF IO
    latency probes become /proc/diskstats + /proc/self/io delta rates).

    Stateful: each poll reports rates/averages over the interval since
    the previous poll.  Per physical device (partitions and loop/ram
    devices skipped): iops, bytes/s, average await ms, utilization.
    Process-level: read/write bytes/s of this node process.
    """
    from banyandb_tpu_torch.admin.diagnostics import read_self_io

    state: dict = {"ts": None, "disk": {}, "proc": None}

    def whole_devices() -> Optional[set]:
        """Whole block devices per the kernel (/sys/block lists exactly
        those — partitions live underneath).  A name heuristic would
        misclassify nvme0n1/mmcblk0/dm-0 as partitions."""
        try:
            import os as _os

            return set(_os.listdir("/sys/block"))
        except OSError:
            return None

    def read_diskstats() -> dict:
        out = {}
        whole = whole_devices()
        try:
            with open("/proc/diskstats") as f:
                for line in f:
                    p = line.split()
                    if len(p) < 14:
                        continue
                    name = p[2]
                    if name.startswith(("loop", "ram", "zram")):
                        continue
                    if whole is not None:
                        if name not in whole:
                            continue  # partition
                    elif name[-1].isdigit() and not name.startswith(
                        ("nvme", "mmcblk", "dm-", "md")
                    ):
                        continue  # fallback heuristic without /sys/block
                    # fields: 4=reads 6=sectors_read 7=ms_reading
                    #         8=writes 10=sectors_written 11=ms_writing
                    #         13=ms_doing_io
                    out[name] = (
                        int(p[3]) + int(p[7]),           # ios completed
                        (int(p[5]) + int(p[9])) * 512,   # bytes
                        int(p[6]) + int(p[10]),          # ms waiting
                        int(p[12]),                      # ms device busy
                    )
        except OSError:
            pass
        return out


    def poll() -> list[RawMetric]:
        now_s = time.time()
        now = int(now_s * 1000)
        disk = read_diskstats()
        proc = read_self_io()
        prev_ts = state["ts"]
        out: list[RawMetric] = []
        if prev_ts is not None and now_s > prev_ts:
            dt = now_s - prev_ts
            for name, cur in disk.items():
                prev = state["disk"].get(name)
                if prev is None:
                    continue
                d_ios = cur[0] - prev[0]
                d_bytes = cur[1] - prev[1]
                d_wait = cur[2] - prev[2]
                d_busy = cur[3] - prev[3]
                if min(d_ios, d_bytes, d_wait, d_busy) < 0:
                    # counter wrap (io_ticks wraps ~49 busy-days) or a
                    # device reset under the same name: skip the interval
                    # rather than publish negative rates
                    continue
                lbl = (("device", name),)
                out.append(RawMetric("disk_iops", lbl, d_ios / dt, GAUGE, now))
                out.append(RawMetric("disk_bytes_per_s", lbl, d_bytes / dt, GAUGE, now))
                out.append(RawMetric(
                    "disk_await_ms", lbl,
                    (d_wait / d_ios) if d_ios else 0.0, GAUGE, now,
                ))
                out.append(RawMetric(
                    "disk_util", lbl, min(1.0, d_busy / (dt * 1000.0)), GAUGE, now,
                ))
            if (
                proc is not None
                and state["proc"] is not None
                and proc[0] >= state["proc"][0]
                and proc[1] >= state["proc"][1]
            ):
                out.append(RawMetric(
                    "process_read_bytes_per_s", (),
                    (proc[0] - state["proc"][0]) / dt, GAUGE, now,
                ))
                out.append(RawMetric(
                    "process_write_bytes_per_s", (),
                    (proc[1] - state["proc"][1]) / dt, GAUGE, now,
                ))
        state["ts"], state["disk"], state["proc"] = now_s, disk, proc
        return out

    return poll


class FlightRecorder:
    """Windowed ring of metric cycles (fodc flight recorder analog).

    Keeps up to `window_s` seconds of polled cycles; `latest()` answers
    the proxy's live scrape, `window(start, end)` its historical query.
    """

    def __init__(self, window_s: float = 900.0, max_cycles: int = 512):
        self.window_s = window_s
        self.max_cycles = max_cycles
        self._lock = threading.Lock()
        self._cycles: list[tuple[float, list[RawMetric]]] = []

    def update(self, metrics: list[RawMetric]) -> None:
        now = time.time()
        with self._lock:
            self._cycles.append((now, list(metrics)))
            cutoff = now - self.window_s
            while self._cycles and (
                self._cycles[0][0] < cutoff or len(self._cycles) > self.max_cycles
            ):
                self._cycles.pop(0)

    def latest(self) -> list[RawMetric]:
        with self._lock:
            return list(self._cycles[-1][1]) if self._cycles else []

    def window(self, start_s: float, end_s: float) -> list[tuple[float, list[RawMetric]]]:
        with self._lock:
            return [
                (ts, list(ms)) for ts, ms in self._cycles if start_s <= ts <= end_s
            ]


class Watchdog:
    """Polls metric sources on an interval; feeds the flight recorder.

    Mirrors watchdog.go's contract: per-source retry (3 attempts,
    100ms->5s exponential backoff), a live node-identity provider whose
    first resolved answer "sticks" (a provider regressing to unresolved
    must not fork a ghost series), a resolve grace period before the
    first recording, and post-poll hooks run in registration order.
    """

    MAX_RETRIES = 3
    INITIAL_BACKOFF_S = 0.1
    MAX_BACKOFF_S = 5.0

    def __init__(
        self,
        recorder: FlightRecorder,
        sources: list[Callable[[], list[RawMetric]]],
        *,
        interval_s: float = 5.0,
        node_role: str = "",
        resolve_grace_s: float = 300.0,
    ):
        self.recorder = recorder
        self.sources = list(sources)
        self.interval_s = interval_s
        self._node_info: Optional[Callable[[], tuple[str, dict]]] = None
        self._resolved: Optional[tuple[str, dict]] = None
        self._static_role = node_role
        self._resolve_grace_s = resolve_grace_s
        self._start_time = time.monotonic()
        self._hooks: list[Callable[[], None]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.poll_count = 0
        self.error_count = 0

    def set_node_info_provider(self, fn: Callable[[], tuple[str, dict]]) -> None:
        with self._lock:
            self._node_info = fn

    def add_post_poll_hook(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._hooks.append(fn)

    def _resolve_identity(self) -> tuple[str, dict]:
        with self._lock:
            provider, cached = self._node_info, self._resolved
        role, labels = (provider() if provider else (self._static_role, {}))
        if role and role != "unspecified":
            resolved = (role, dict(labels))
            with self._lock:
                self._resolved = resolved
            return resolved
        if cached is not None:  # sticky: never regress to unresolved
            return cached
        return (self._static_role, {})

    def _poll_source(self, src) -> list[RawMetric]:
        backoff = self.INITIAL_BACKOFF_S
        for attempt in range(self.MAX_RETRIES):
            try:
                return src()
            except Exception:  # noqa: BLE001 - retried, then surfaced as a count
                if attempt == self.MAX_RETRIES - 1:
                    self.error_count += 1
                    return []
                time.sleep(backoff)
                backoff = min(backoff * 2, self.MAX_BACKOFF_S)
        return []

    def poll_once(self) -> list[RawMetric]:
        """One full cycle: poll every source, stamp identity, record, hooks."""
        role, labels = self._resolve_identity()
        if (
            not role
            and time.monotonic() - self._start_time < self._resolve_grace_s
        ):
            # defer recording while unresolved (ghost-series guard); after
            # the grace period record anyway so a never-resolving node is
            # still observable
            return []
        stamp = tuple(sorted({"node_role": role or "unknown", **labels}.items()))
        cycle: list[RawMetric] = []
        for src in self.sources:
            for m in self._poll_source(src):
                cycle.append(
                    dataclasses.replace(m, labels=tuple(sorted((*m.labels, *stamp))))
                )
        self.recorder.update(cycle)
        self.poll_count += 1
        with self._lock:
            hooks = list(self._hooks)
        for h in hooks:
            try:
                h()
            except Exception:  # noqa: BLE001 - a hook must not kill the poll loop
                pass
        return cycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.poll_once()
                except Exception:  # noqa: BLE001
                    self.error_count += 1

        self._thread = threading.Thread(target=loop, daemon=True, name="fodc-watchdog")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class PressureProfiler:
    """Capture profile artifacts when memory pressure crosses a threshold.

    fodc pressureprofiler + pprofcapture analog: each capture event is a
    directory named by its UTC-ns timestamp holding `threads.txt`,
    `heap.txt` (tracemalloc top), and `runtime.txt`, plus a `record.json`
    matching the fodc/v1 PressureProfileRecord fields. Ride a Watchdog
    via `hook()`; serve the proxy's list/fetch commands via
    `list_records()` / `read_profile()` (path-validated to this dir).
    """

    PROFILE_FILES = ("threads", "heap", "runtime")

    def __init__(
        self,
        root: str | Path,
        *,
        limit_bytes: int,
        trigger_percent: int = 75,
        min_interval_s: float = 300.0,
        max_events: int = 8,
    ):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.limit_bytes = int(limit_bytes)
        self.trigger_percent = int(trigger_percent)
        self.threshold_bytes = self.limit_bytes * self.trigger_percent // 100
        self.min_interval_s = min_interval_s
        self.max_events = max_events
        self._last_capture = -1e18
        self._lock = threading.Lock()
        self.captured = 0

    def hook(self) -> None:
        """Watchdog post-poll hook: check pressure, maybe capture."""
        from banyandb_tpu_torch.admin.protector import process_rss

        self.maybe_capture(process_rss())

    def maybe_capture(self, rss_bytes: int) -> Optional[Path]:
        if self.threshold_bytes <= 0 or rss_bytes < self.threshold_bytes:
            return None
        now = time.monotonic()
        with self._lock:
            if now - self._last_capture < self.min_interval_s:
                return None
            self._last_capture = now
        return self.capture(rss_bytes)

    def capture(self, rss_bytes: int) -> Path:
        import json

        from banyandb_tpu_torch.admin.profiling import (
            _threads_text,
            _tracemalloc_text,
            _vars_text,
        )

        profile_id = f"{time.time_ns()}"
        event = self.root / profile_id
        event.mkdir(parents=True, exist_ok=True)
        contents = {
            "threads": _threads_text(),
            "heap": _tracemalloc_text(25),
            "runtime": _vars_text(),
        }
        profiles = []
        for kind in self.PROFILE_FILES:
            p = event / f"{kind}.txt"
            p.write_text(contents[kind])
            profiles.append(
                {
                    "type": kind,
                    "filename": p.name,
                    "filepath": str(p),
                    "format": "text",
                    "size_bytes": p.stat().st_size,
                }
            )
        record = {
            "profile_id": profile_id,
            "captured_at_millis": int(time.time() * 1000),
            "rss_bytes": rss_bytes,
            "cgroup_limit_bytes": self.limit_bytes,
            "trigger_percent": self.trigger_percent,
            "threshold_bytes": self.threshold_bytes,
            "profiles": profiles,
        }
        (event / "record.json").write_text(json.dumps(record, indent=1))
        self.captured += 1
        self._enforce_retention()
        return event

    def _enforce_retention(self) -> None:
        import shutil

        events = sorted(d for d in self.root.iterdir() if d.is_dir())
        for old in events[: max(0, len(events) - self.max_events)]:
            shutil.rmtree(old, ignore_errors=True)

    def list_records(self) -> list[dict]:
        import json

        out = []
        for d in sorted(p for p in self.root.iterdir() if p.is_dir()):
            rec = d / "record.json"
            if rec.exists():
                try:
                    out.append(json.loads(rec.read_text()))
                except ValueError:
                    pass
        return out

    def read_profile(self, profile_id: str, kind: str) -> bytes:
        """Serve one profile's bytes; the path is validated to live under
        this profiler's root (the agent-side check FetchPressureProfile
        documents — a proxy-supplied path must not escape the dir)."""
        p = (self.root / profile_id / f"{kind}.txt").resolve()
        if not str(p).startswith(str(self.root.resolve()) + "/"):
            raise PermissionError(f"profile path escapes profiler dir: {p}")
        if not p.exists():
            raise FileNotFoundError(f"{profile_id}/{kind}")
        return p.read_bytes()


def pprof_capture_handler(payload: dict) -> dict:
    """Bus handler for on-demand profile capture (fodc pprofcapture RPC
    analog; register under PPROF_TOPIC on every node).

    payload: {"kinds": ["threads","heap","runtime","cpu"], "seconds": N}
    -> {"profiles": {kind: text}}
    """
    from banyandb_tpu_torch.admin import profiling

    kinds = payload.get("kinds") or ["threads", "runtime"]
    out = {}
    for kind in kinds:
        if kind == "threads":
            out[kind] = profiling._threads_text()
        elif kind == "heap":
            out[kind] = profiling._tracemalloc_text(int(payload.get("top", 25)))
        elif kind == "runtime":
            out[kind] = profiling._vars_text()
        elif kind == "cpu":
            out[kind] = profiling._profile_text(
                float(payload.get("seconds", 2.0))
            )
        else:
            out[kind] = f"unknown profile kind {kind!r}"
    return {"profiles": out}
