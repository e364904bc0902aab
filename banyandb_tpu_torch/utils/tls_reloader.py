"""TLS certificate hot-reload for gRPC servers.

Analog of the reference's fsnotify-based reloader
(upstream pkg/tls/reloader.go:55): rotated cert/key files take
effect WITHOUT restarting the server.  gRPC Python exposes exactly the
right hook — ``dynamic_ssl_server_credentials`` calls a configuration
fetcher on every TLS handshake — so the reloader only needs to re-read
the PEM files when their mtimes change (mtime polling instead of
fsnotify; the fetcher runs per-handshake, so a poll loop isn't even
needed).
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Optional


class CertReloader:
    def __init__(self, cert_file: str | Path, key_file: str | Path):
        self.cert_file = Path(cert_file)
        self.key_file = Path(key_file)
        self._lock = threading.Lock()
        self._mtimes: tuple[float, float] = (-1.0, -1.0)
        self._pair: Optional[tuple[bytes, bytes]] = None
        self.reloads = 0  # observability: how many rotations served
        self._refresh()

    @staticmethod
    def _pair_valid(key: bytes, cert: bytes) -> bool:
        """True when the key actually matches the cert — a handshake
        mid-rotation (cert written, key not yet) must not adopt a
        mismatched pair."""
        import ssl
        import tempfile

        try:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            with tempfile.NamedTemporaryFile(suffix=".pem") as f:
                f.write(key)
                f.write(b"\n")
                f.write(cert)
                f.flush()
                ctx.load_cert_chain(f.name)
            return True
        except (ssl.SSLError, OSError, ValueError):
            return False

    def _refresh(self) -> None:
        """Re-read the PEMs when either file's mtime moved.  A rotation
        in progress (cert written, key not yet — a MISMATCHED pair)
        keeps serving the last good pair; the matching half lands on a
        later handshake once both files rotated."""
        try:
            mt = (
                self.cert_file.stat().st_mtime,
                self.key_file.stat().st_mtime,
            )
        except OSError:
            return
        with self._lock:
            if mt == self._mtimes and self._pair is not None:
                return
            try:
                pair = (self.key_file.read_bytes(), self.cert_file.read_bytes())
            except OSError:
                return
            if pair != self._pair and not self._pair_valid(*pair):
                return  # mid-rotation mismatch: keep the last good pair
            if self._pair is not None and pair != self._pair:
                self.reloads += 1
            self._mtimes = mt
            self._pair = pair

    def current_pair(self) -> tuple[bytes, bytes]:
        self._refresh()
        with self._lock:
            if self._pair is None:
                raise FileNotFoundError(
                    f"TLS material unreadable: {self.cert_file}, {self.key_file}"
                )
            return self._pair

    def server_credentials(self):
        """gRPC server credentials that pick up rotated files per
        handshake (no restart, no rebind)."""
        import grpc

        def fetch():
            key, cert = self.current_pair()
            return grpc.ssl_server_certificate_configuration([(key, cert)])

        return grpc.dynamic_ssl_server_credentials(
            fetch(), lambda: fetch(), require_client_authentication=False
        )
