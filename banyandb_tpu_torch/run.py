"""Phased unit-group run lifecycle.

Analog of the reference's pkg/run group (run.Group with PreRun / Serve /
GracefulStop phases, banyand/pkg/cmdsetup wiring): units register in
dependency order; startup runs PreRun then Serve forward, and ANY
failure (or a stop signal) tears the started units down in reverse with
a bounded grace period — so a half-started process never leaks
listeners or daemon loops.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

log = logging.getLogger("banyandb.run")


class Unit:
    """One lifecycle participant.  Subclass or wrap callables via
    FuncUnit.  serve() must RETURN after starting background work (the
    group owns the foreground wait)."""

    name = "unit"

    def pre_run(self) -> None:  # validation / directory prep
        pass

    def serve(self) -> None:  # start listeners / daemons, then return
        pass

    def graceful_stop(self) -> None:
        pass


class FuncUnit(Unit):
    def __init__(
        self,
        name: str,
        pre_run: Optional[Callable] = None,
        serve: Optional[Callable] = None,
        stop: Optional[Callable] = None,
    ):
        self.name = name
        self._pre = pre_run
        self._serve = serve
        self._stop = stop

    def pre_run(self) -> None:
        if self._pre:
            self._pre()

    def serve(self) -> None:
        if self._serve:
            self._serve()

    def graceful_stop(self) -> None:
        if self._stop:
            self._stop()


class Group:
    def __init__(self, name: str = "banyandb"):
        self.name = name
        self._units: list[Unit] = []
        self._started: list[Unit] = []
        self._stop_evt = threading.Event()

    def add(self, unit: Unit) -> None:
        self._units.append(unit)

    def start(self) -> None:
        """PreRun then Serve, forward order; on any failure stop every
        unit whose serve() RAN — including the failing one, which may
        have bound listeners before raising (graceful_stop must
        therefore tolerate partial starts) — in reverse, and re-raise."""
        try:
            for u in self._units:
                u.pre_run()
            for u in self._units:
                self._started.append(u)  # before serve: partial starts
                # (a listener bound, then a later bind fails) still unwind
                u.serve()
        except Exception:
            log.exception("startup failed; unwinding started units")
            self.stop()
            raise

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until trigger_stop() (or a signal handler calls it)."""
        return self._stop_evt.wait(timeout)

    def trigger_stop(self) -> None:
        self._stop_evt.set()

    def stop(self) -> None:
        """GracefulStop in reverse start order; a failing unit never
        blocks the remaining teardown."""
        for u in reversed(self._started):
            try:
                u.graceful_stop()
            except Exception:  # noqa: BLE001
                log.exception("graceful_stop failed for %s", u.name)
        self._started.clear()

    def run(self) -> None:
        """start + wait-for-signal + stop (the main() shape)."""
        import signal

        self.start()
        signal.signal(signal.SIGTERM, lambda *a: self.trigger_stop())
        signal.signal(signal.SIGINT, lambda *a: self.trigger_stop())
        self.wait()
        self.stop()
