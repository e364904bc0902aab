"""HTTP/JSON gateway over the wire services.

Analog of the reference's grpc-gateway liaison HTTP tier
(banyand/liaison/http/server.go:105): the google.api.http annotations in
the upstream protos define these routes; requests/responses are the same
proto messages in protobuf-JSON form (google.protobuf.json_format, the
encoding grpc-gateway itself uses).

Routes (base path /api as upstream):
    POST /api/v1/measure/data          MeasureService.Query
    POST /api/v1/measure/topn          MeasureService.TopN
    POST /api/v1/stream/data           StreamService.Query
    POST /api/v1/bydbql/query          BydbQLService.Query
    POST /api/v1/group/schema          GroupRegistryService.Create
    GET  /api/v1/group/schema/{g}      GroupRegistryService.Get
    GET  /api/v1/group/schema/lists    GroupRegistryService.List
    POST /api/v1/measure/schema        MeasureRegistryService.Create
    GET  /api/v1/measure/schema/{g}/{n}   MeasureRegistryService.Get
    GET  /api/v1/measure/schema/lists/{g} MeasureRegistryService.List
    POST /api/v1/stream/schema         StreamRegistryService.Create
    GET  /api/v1/stream/schema/{g}/{n}    StreamRegistryService.Get
    GET  /api/healthz
    GET  /metrics                      Prometheus exposition (obs plane)
    GET  /api/v1/slowlog?limit=N       slow-query flight recorder
    GET  /api/v1/trace/search?group=&name=&where=&order_by=&desc=&limit=&offset=
                                       trace search via BydbQL
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from google.protobuf import json_format

from banyandb_tpu_torch.api import pb


class _GatewayAbort(Exception):
    def __init__(self, code, details: str):
        self.code = code
        self.details = details
        super().__init__(details)


class _HTTPContext:
    """grpc.ServicerContext stand-in for gateway-invoked handlers."""

    def abort(self, code, details):
        raise _GatewayAbort(code, details)


_GRPC_TO_HTTP = {
    "NOT_FOUND": 404,
    "INVALID_ARGUMENT": 400,
    "ALREADY_EXISTS": 409,
    "UNIMPLEMENTED": 501,
    "INTERNAL": 500,
    # load shedding (QoS quota / ServerBusy / DiskFull): the HTTP
    # retryable rejection — clients back off, never silently dropped
    "RESOURCE_EXHAUSTED": 429,
}

# resource kinds -> registry service stems, keyed by their upstream route
# segment (database/v1/rpc.proto google.api.http paths)
_KIND_SERVICES = {
    "measure": "Measure",
    "stream": "Stream",
    "trace": "Trace",
    "property": "Property",
    "index-rule": "IndexRule",
    "index-rule-binding": "IndexRuleBinding",
    "topn-agg": "TopNAggregation",
}


class HttpGateway:
    def __init__(
        self,
        services,
        host: str = "127.0.0.1",
        port: int = 17913,
        auth=None,
        slowlog=None,
    ):
        """auth: optional banyandb_tpu_torch.api.auth.AuthReloader — when set,
        every API route (healthz excepted) requires HTTP Basic credentials
        from the same hot-reloaded users file as the gRPC surface.

        slowlog: optional obs.SlowQueryRecorder — enables
        GET /api/v1/slowlog (the flight recorder's HTTP surface)."""
        self.services = services
        self.auth = auth
        self.slowlog = slowlog
        gateway = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, status: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _check_auth(self) -> bool:
                if gateway.auth is None:
                    return True
                import base64

                hdr = self.headers.get("Authorization", "")
                if hdr.startswith("Basic "):
                    try:
                        user, _, pw = (
                            base64.b64decode(hdr[6:]).decode().partition(":")
                        )
                    except (ValueError, UnicodeDecodeError):
                        user = pw = ""
                    if user and gateway.auth.check(user, pw):
                        return True
                body = json.dumps({"error": "Invalid credentials"}).encode()
                self.send_response(401)
                self.send_header("WWW-Authenticate", 'Basic realm="banyandb"')
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return False

            def _dispatch(self, method: str):
                if not self._check_auth():
                    return
                try:
                    route = gateway._route(method, self.path.rstrip("/"))
                    if route is None:
                        return self._send(404, {"error": "no such route"})
                    handler, req_msg = route
                    if method == "POST":
                        n = int(self.headers.get("Content-Length") or 0)
                        raw = self.rfile.read(n) if n else b"{}"
                        json_format.Parse(raw, req_msg, ignore_unknown_fields=True)
                    resp = handler(req_msg, _HTTPContext())
                    self._send(
                        200,
                        json_format.MessageToDict(
                            resp, preserving_proto_field_name=True
                        ),
                    )
                except _GatewayAbort as e:
                    self._send(
                        _GRPC_TO_HTTP.get(e.code.name, 500), {"error": e.details}
                    )
                except json_format.ParseError as e:
                    self._send(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001
                    self._send(500, {"error": str(e)})

            def do_POST(self):
                self._dispatch("POST")

            def do_DELETE(self):
                self._dispatch("DELETE")

            def do_GET(self):
                if self.path == "/api/healthz":
                    return self._send(200, {"status": "ok"})
                if self.path == "/metrics":
                    # Prometheus scrape surface: the process-global meter
                    # (stage histograms, rpc, lifecycle, caches)
                    from banyandb_tpu_torch.obs.metrics import global_meter

                    if not self._check_auth():
                        return
                    body = global_meter().prometheus_text().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "text/plain; version=0.0.4"
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if self.path.split("?")[0] == "/api/v1/slowlog":
                    if not self._check_auth():
                        return
                    if gateway.slowlog is None:
                        return self._send(
                            404, {"error": "slow-query recorder not wired"}
                        )
                    from urllib.parse import parse_qs, urlsplit

                    q = parse_qs(urlsplit(self.path).query)
                    limit = None
                    if q.get("limit"):
                        try:
                            limit = int(q["limit"][0])
                        except ValueError:
                            limit = None
                    return self._send(
                        200,
                        {"entries": gateway.slowlog.entries(limit=limit)},
                    )
                if self.path.split("?")[0] == "/api/v1/trace/search":
                    # search params compose into one BydbQL trace query
                    # through the same builder cli.py uses (lazy import:
                    # the server package is fully loaded at request time)
                    if not self._check_auth():
                        return
                    from urllib.parse import parse_qs, urlsplit

                    from banyandb_tpu_torch.cli import trace_search_ql

                    q = parse_qs(urlsplit(self.path).query)

                    def one(k, d=""):
                        return q.get(k, [d])[0]

                    if not one("group") or not one("name"):
                        return self._send(
                            400, {"error": "group and name params required"}
                        )
                    try:
                        limit = int(one("limit", "20"))
                        offset = int(one("offset", "0"))
                    except ValueError:
                        return self._send(
                            400, {"error": "limit/offset must be integers"}
                        )
                    ql = trace_search_ql(
                        one("group"), one("name"),
                        tags=one("tags", "*"),
                        where=q.get("where", []),
                        order_by=one("order_by"),
                        desc=one("desc").lower() in ("1", "true", "yes", "on"),
                        limit=limit, offset=offset,
                        from_ms=int(one("from_ms")) if one("from_ms") else None,
                        to_ms=int(one("to_ms")) if one("to_ms") else None,
                    )
                    try:
                        req = pb.bydbql_query_pb2.QueryRequest(query=ql)
                        resp = gateway.services.bydbql_query(
                            req, _HTTPContext()
                        )
                        return self._send(
                            200,
                            json_format.MessageToDict(
                                resp, preserving_proto_field_name=True
                            ),
                        )
                    except _GatewayAbort as e:
                        return self._send(
                            _GRPC_TO_HTTP.get(e.code.name, 500),
                            {"error": e.details},
                        )
                if self.path in ("/", "/console"):
                    page = gateway._console_page
                    if page is None:
                        return self._send(500, {"error": "console.html missing"})
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(page)))
                    self.end_headers()
                    self.wfile.write(page)
                    return
                self._dispatch("GET")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_port
        self._thread: threading.Thread | None = None
        # console page read once at startup (missing file -> 500, not a
        # per-request OSError escaping the handler)
        try:
            import os

            with open(
                os.path.join(os.path.dirname(__file__), "console.html"), "rb"
            ) as f:
                self._console_page: bytes | None = f.read()
        except OSError:
            self._console_page = None

        # static route tables (registry handler dicts are built once; the
        # request message is instantiated per request at dispatch time)
        s = services
        rpc = pb.database_rpc_pb2
        self._reg = {
            kind: s._registry_handlers(kind)
            for kind in ("group", "measure", "stream")
        }
        self._post = {
            ("v1", "measure", "data"): (s.measure_query, pb.measure_query_pb2.QueryRequest),
            ("v1", "measure", "topn"): (s.measure_topn, pb.measure_topn_pb2.TopNRequest),
            ("v1", "stream", "data"): (s.stream_query, pb.stream_query_pb2.QueryRequest),
            ("v1", "bydbql", "query"): (s.bydbql_query, pb.bydbql_query_pb2.QueryRequest),
            ("v1", "group", "schema"): (
                self._reg["group"]["Create"].unary_unary,
                rpc.GroupRegistryServiceCreateRequest,
            ),
            ("v1", "measure", "schema"): (
                self._reg["measure"]["Create"].unary_unary,
                rpc.MeasureRegistryServiceCreateRequest,
            ),
            ("v1", "stream", "schema"): (
                self._reg["stream"]["Create"].unary_unary,
                rpc.StreamRegistryServiceCreateRequest,
            ),
        }
        if getattr(s, "property", None) is not None:
            self._post[("v1", "property", "data", "query")] = (
                s.property_query,
                pb.property_rpc_pb2.QueryRequest,
            )
        if getattr(s, "trace", None) is not None:
            self._post[("v1", "trace", "data")] = (
                s.trace_query,
                pb.trace_query_pb2.QueryRequest,
            )
        from banyandb_tpu_torch.api import wire as _wire

        self._reg["trace"] = s._spec_registry_handlers(
            "TraceRegistryService", "trace", "trace",
            _wire.trace_to_internal, _wire.trace_to_pb,
        )
        self._reg["property"] = s._spec_registry_handlers(
            "PropertyRegistryService", "property", "property_schema",
            _wire.property_schema_to_internal, _wire.property_schema_to_pb,
        )
        # spec registries under their upstream route segments
        # (rpc.proto:261 /v1/index-rule, :175 /v1/index-rule-binding,
        # :701 /v1/topn-agg)
        self._reg["index-rule"] = s._spec_registry_handlers(
            "IndexRuleRegistryService", "index_rule", "index_rule",
            _wire.index_rule_to_internal, _wire.index_rule_to_pb,
        )
        self._reg["index-rule-binding"] = s._spec_registry_handlers(
            "IndexRuleBindingRegistryService", "index_rule_binding",
            "index_rule_binding",
            _wire.index_rule_binding_to_internal,
            _wire.index_rule_binding_to_pb,
        )
        self._reg["topn-agg"] = s._spec_registry_handlers(
            "TopNAggregationRegistryService", "top_n_aggregation", "topn",
            _wire.topn_to_internal, _wire.topn_to_pb,
            reg_list="list_topn",
        )
        for seg, svc in (
            ("index-rule", "IndexRule"),
            ("index-rule-binding", "IndexRuleBinding"),
            ("topn-agg", "TopNAggregation"),
        ):
            self._post[("v1", seg, "schema")] = (
                self._reg[seg]["Create"].unary_unary,
                getattr(rpc, f"{svc}RegistryServiceCreateRequest"),
            )
        self._post[("v1", "trace", "schema")] = (
            self._reg["trace"]["Create"].unary_unary,
            rpc.TraceRegistryServiceCreateRequest,
        )
        self._post[("v1", "property", "schema")] = (
            self._reg["property"]["Create"].unary_unary,
            rpc.PropertyRegistryServiceCreateRequest,
        )
        # parameterless GET endpoints (rpc.proto:952 /v1/cluster/state,
        # common/v1/rpc.proto /v1/common/api/version)
        self._get_plain = {
            ("v1", "cluster", "state"): (
                s.get_cluster_state,
                pb.database_rpc_pb2.GetClusterStateRequest,
            ),
            ("v1", "common", "api", "version"): (
                s.get_api_version,
                pb.common_rpc_pb2.GetAPIVersionRequest,
            ),
        }

    # -- routing -----------------------------------------------------------
    def _route(self, method: str, path: str):
        rpc = pb.database_rpc_pb2
        parts = [p for p in path.split("/") if p]
        if not parts or parts[0] != "api":
            return None
        parts = parts[1:]
        if method == "POST":
            hit = self._post.get(tuple(parts))
            return (hit[0], hit[1]()) if hit else None
        if method == "GET":  # read-only endpoints never answer DELETE
            hit = self._get_plain.get(tuple(parts))
            if hit:
                return (hit[0], hit[1]())
        # routes with path params
        if len(parts) == 4 and parts[:3] == ["v1", "group", "schema"]:
            if method == "DELETE":
                return (
                    self._reg["group"]["Delete"].unary_unary,
                    rpc.GroupRegistryServiceDeleteRequest(group=parts[3]),
                )
            if parts[3] == "lists":
                return (
                    self._reg["group"]["List"].unary_unary,
                    rpc.GroupRegistryServiceListRequest(),
                )
            return (
                self._reg["group"]["Get"].unary_unary,
                rpc.GroupRegistryServiceGetRequest(group=parts[3]),
            )
        for kind, svc in _KIND_SERVICES.items():
            if len(parts) == 5 and parts[:3] == ["v1", kind, "schema"]:
                P = f"{svc}RegistryService"
                if method == "DELETE":
                    req = getattr(rpc, f"{P}DeleteRequest")()
                    req.metadata.group, req.metadata.name = parts[3], parts[4]
                    return (self._reg[kind]["Delete"].unary_unary, req)
                if parts[3] == "lists":
                    return (
                        self._reg[kind]["List"].unary_unary,
                        getattr(rpc, f"{P}ListRequest")(group=parts[4]),
                    )
                req = getattr(rpc, f"{P}GetRequest")()
                req.metadata.group, req.metadata.name = parts[3], parts[4]
                return (self._reg[kind]["Get"].unary_unary, req)
        return None

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        # shutdown() blocks on serve_forever's loop flag; calling it when
        # start() never ran would deadlock (partial StandaloneServer start)
        if self._thread is not None:
            self.httpd.shutdown()
        self.httpd.server_close()
