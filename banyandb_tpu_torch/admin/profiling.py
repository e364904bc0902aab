"""In-process profiling endpoints (pprof-server analog).

The reference mounts Go's pprof handlers
(banyand/observability/pprof.go:40 upstream); the Python twin
serves the equivalent diagnostics over a tiny HTTP listener:

    GET /debug/threads            all thread stacks (goroutine profile)
    GET /debug/tracemalloc?top=N  top allocation sites (heap profile);
                                  first call starts tracing
    GET /debug/profile?seconds=N  statistical sampler over ALL threads
                                  for N seconds (cpu profile); top
                                  frames by sample count
    GET /debug/vars               runtime counters (gc, threads, rss)

Plain text responses — curl-able under incident pressure, no tooling
required.
"""

from __future__ import annotations

import collections
import gc
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse


def _threads_text() -> str:
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append(f"--- thread {tid} ({names.get(tid, '?')}) ---")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
    return "\n".join(out) + "\n"


def _tracemalloc_text(top: int) -> str:
    import tracemalloc

    if not tracemalloc.is_tracing():
        tracemalloc.start()
        return "tracemalloc started; call again for a snapshot\n"
    snap = tracemalloc.take_snapshot()
    stats = snap.statistics("lineno")[:top]
    total = sum(s.size for s in snap.statistics("filename"))
    lines = [f"total traced: {total / 1e6:.1f} MB; top {top} by line:"]
    lines += [str(s) for s in stats]
    return "\n".join(lines) + "\n"


def _profile_text(seconds: float, hz: float = 100.0) -> str:
    """Statistical wall-clock sampler over ALL threads (cProfile hooks
    only the calling thread, which here would just be sleeping): sample
    sys._current_frames() at `hz`, aggregate leaf frames and full
    stacks by count — the py-spy/pprof-CPU-profile shape, curl-able."""
    me = threading.get_ident()
    deadline = time.monotonic() + min(seconds, 30.0)
    interval = 1.0 / hz
    leaf: collections.Counter = collections.Counter()
    stacks: collections.Counter = collections.Counter()
    samples = 0
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            samples += 1
            f = frame
            leaf[f"{f.f_code.co_filename}:{f.f_lineno} {f.f_code.co_name}"] += 1
            parts = []
            while f is not None and len(parts) < 12:
                parts.append(f.f_code.co_name)
                f = f.f_back
            stacks[" < ".join(parts)] += 1
        time.sleep(interval)
    out = [f"{samples} samples over {seconds}s at {hz:.0f}Hz (all threads)"]
    out.append("\n--- top leaf frames ---")
    for frame_id, n in leaf.most_common(25):
        out.append(f"{n:6d}  {frame_id}")
    out.append("\n--- top stacks ---")
    for stack, n in stacks.most_common(15):
        out.append(f"{n:6d}  {stack}")
    return "\n".join(out) + "\n"


def _vars_text() -> str:
    from banyandb_tpu_torch.admin.protector import process_rss

    return (
        f"threads: {threading.active_count()}\n"
        f"gc_counts: {gc.get_count()}\n"
        f"gc_objects: {len(gc.get_objects())}\n"
        f"rss_bytes: {process_rss()}\n"
    )


class ProfilingServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)
                try:
                    if u.path == "/debug/threads":
                        body = _threads_text()
                    elif u.path == "/debug/tracemalloc":
                        body = _tracemalloc_text(int(q.get("top", ["20"])[0]))
                    elif u.path == "/debug/profile":
                        body = _profile_text(float(q.get("seconds", ["5"])[0]))
                    elif u.path == "/debug/vars":
                        body = _vars_text()
                    else:
                        self.send_error(404)
                        return
                except Exception as e:  # noqa: BLE001
                    self.send_error(500, str(e))
                    return
                raw = body.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; charset=utf-8")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_port
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True, name="profiling"
        )
        self._thread.start()
        return self

    def stop(self):
        if self._thread is not None:
            self.httpd.shutdown()
        self.httpd.server_close()
