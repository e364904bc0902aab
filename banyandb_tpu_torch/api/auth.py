"""Basic auth with hot-reloaded users file for the wire surface.

Reference: banyand/liaison/pkg/auth/reloader.go (yaml users file,
0600-permission enforcement, fsnotify hot reload with debounce) and
banyand/liaison/grpc/auth.go (username/password gRPC metadata check on
every unary + stream call; health checks optionally exempt).

This implementation polls the file's (mtime, size) signature on access
with a small interval instead of inotify — same convergence contract
(changes apply without restart), no extra thread or dependency.
Credential comparison is constant-time over sha256 digests, as upstream
compares sha256 via crypto/subtle.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import threading
import time
from pathlib import Path

import grpc

_RECHECK_S = 0.2  # stat() at most this often


class AuthReloader:
    """users.yaml loader: {"users": [{"username","password"}, ...]}."""

    def __init__(self, config_file: str | Path, health_auth: bool = False):
        self.config_file = Path(config_file)
        self.health_auth_enabled = health_auth
        self._lock = threading.Lock()
        self._users: dict[str, bytes] = {}
        self._sig: tuple | None = None
        self._next_check = 0.0
        self._load(required=True)

    @property
    def enabled(self) -> bool:
        return True

    def _load(self, required: bool = False) -> None:
        import yaml

        try:
            st = self.config_file.stat()
        except OSError:
            if required:
                raise
            return  # keep last-good users if the file blinks away
        mode = st.st_mode & 0o777
        if mode != 0o600:
            # same contract as the reference loader: refuse world/group
            # readable credential files
            err = PermissionError(
                f"auth config {self.config_file} has unsafe permissions "
                f"{oct(mode)} (expected 0o600)"
            )
            if required:
                raise err
            return
        sig = (st.st_mtime_ns, st.st_size)
        if sig == self._sig:
            return
        data = yaml.safe_load(self.config_file.read_text()) or {}
        users = {}
        for u in data.get("users") or []:
            name, pw = u.get("username"), u.get("password")
            if name and pw is not None:
                users[name] = hashlib.sha256(str(pw).encode()).digest()
        with self._lock:
            self._users = users
            self._sig = sig

    def _maybe_reload(self) -> None:
        now = time.monotonic()
        if now < self._next_check:
            return
        self._next_check = now + _RECHECK_S
        try:
            self._load()
        except Exception as e:  # noqa: BLE001 - keep last-good config,
            # but tell the operator the rotation did NOT apply
            import logging

            logging.getLogger("banyandb.auth").warning(
                "auth config reload failed; keeping previous users: %s", e
            )

    def check(self, username: str, password: str) -> bool:
        self._maybe_reload()
        with self._lock:
            want = self._users.get(username)
        if want is None:
            # constant-time shape even for unknown users
            hmac.compare_digest(hashlib.sha256(password.encode()).digest(), b"\0" * 32)
            return False
        return hmac.compare_digest(
            hashlib.sha256(password.encode()).digest(), want
        )

    def touch_for_test(self) -> None:
        """Force the next check() to re-stat immediately (tests)."""
        self._next_check = 0.0
        self._sig = None


class BasicAuthInterceptor(grpc.ServerInterceptor):
    """Rejects calls without valid username/password metadata pairs
    (auth.go:validateUser analog).  Health checks pass unless
    health_auth_enabled."""

    _HEALTH = "/grpc.health.v1.Health/Check"

    def __init__(self, reloader: AuthReloader):
        self.reloader = reloader

        def deny(request, context):
            context.abort(grpc.StatusCode.UNAUTHENTICATED, "Invalid credentials")

        self._deny_unary = grpc.unary_unary_rpc_method_handler(deny)

    def intercept_service(self, continuation, handler_call_details):
        if (
            handler_call_details.method == self._HEALTH
            and not self.reloader.health_auth_enabled
        ):
            return continuation(handler_call_details)
        md = dict(handler_call_details.invocation_metadata or ())
        user = md.get("username", "")
        pw = md.get("password", "")
        if user and self.reloader.check(user, pw):
            return continuation(handler_call_details)
        return self._deny_handler(continuation, handler_call_details)

    def _deny_handler(self, continuation, handler_call_details):
        """Return a handler of the RIGHT arity that aborts UNAUTHENTICATED
        (a unary handler for a stream method breaks the server)."""
        real = continuation(handler_call_details)

        def deny(request_or_iterator, context):
            context.abort(
                grpc.StatusCode.UNAUTHENTICATED, "Invalid credentials"
            )

        if real is None:
            return self._deny_unary
        if real.request_streaming and real.response_streaming:
            return grpc.stream_stream_rpc_method_handler(
                deny,
                request_deserializer=real.request_deserializer,
                response_serializer=real.response_serializer,
            )
        if real.request_streaming:
            return grpc.stream_unary_rpc_method_handler(
                deny,
                request_deserializer=real.request_deserializer,
                response_serializer=real.response_serializer,
            )
        if real.response_streaming:
            return grpc.unary_stream_rpc_method_handler(
                deny,
                request_deserializer=real.request_deserializer,
                response_serializer=real.response_serializer,
            )
        return grpc.unary_unary_rpc_method_handler(
            deny,
            request_deserializer=real.request_deserializer,
            response_serializer=real.response_serializer,
        )


def write_users_file(path: str | Path, users: dict[str, str]) -> None:
    """Write a users.yaml with the required 0600 permissions (test +
    provisioning helper)."""
    import yaml

    p = Path(path)
    body = yaml.safe_dump(
        {"users": [{"username": u, "password": pw} for u, pw in users.items()]}
    ).encode()
    # create 0600 from the first byte — never a world-readable window
    fd = os.open(p, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    try:
        os.write(fd, body)
    finally:
        os.close(fd)
    os.chmod(p, 0o600)  # O_CREAT mode is masked by umask; re-assert
