"""MCP server: BanyanDB for LLM agents over the Model Context Protocol.

Analog of the reference's mcp/ tier (a TypeScript MCP server exposing
list_groups_schemas / list_resources_bydbql / validate_bydbql /
query tools, mcp/src/server/mcp.ts) re-implemented as a
self-contained Python JSON-RPC 2.0 stdio server — no SDK dependency,
just the MCP wire shapes (initialize, tools/list, tools/call).

Run: python -m banyandb_tpu_torch.mcp_server --root /var/lib/banyandb

The measure and stream engines run on the CUDA device unless the caller
names another (``--device cpu``); without CUDA the server raises.

Tools:
    list_groups_schemas  groups + their measure/stream/trace schemas
    list_resources       resources of one group with tag/field detail
    validate_bydbql      parse a BydbQL statement, report errors
    execute_bydbql       parse + run a BydbQL statement, JSON results
    topn_query           ranked TopN over a pre-aggregation rule
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

PROTOCOL_VERSION = "2024-11-05"


def _schema_obj(obj) -> dict:
    from banyandb_tpu_torch.api.schema import _to_jsonable

    return _to_jsonable(obj)


class McpServer:
    def __init__(self, root: str | Path, device=None):
        """`device` (``backend.resolve_device``), resolved once and given
        to the measure and stream engines: the CUDA device by default;
        without CUDA the constructor raises unless ``"cpu"`` was asked
        for.  Trace and property engines are host-only."""
        from banyandb_tpu_torch.api.schema import SchemaRegistry
        from banyandb_tpu_torch.backend import resolve_device
        from banyandb_tpu_torch.models.measure import MeasureEngine
        from banyandb_tpu_torch.models.property import PropertyEngine
        from banyandb_tpu_torch.models.stream import StreamEngine
        from banyandb_tpu_torch.models.trace import TraceEngine

        root = Path(root)
        self.device = resolve_device(device)
        self.registry = SchemaRegistry(root)
        self.measure = MeasureEngine(self.registry, root / "data", device=self.device)
        self.stream = StreamEngine(self.registry, root / "data", device=self.device)
        self.trace = TraceEngine(self.registry, root / "data")
        self.property = PropertyEngine(self.registry, root / "data")

    # -- tool implementations ----------------------------------------------
    def list_groups_schemas(self) -> dict:
        out = {}
        for g in self.registry.list_groups():
            out[g.name] = {
                "catalog": g.catalog.value,
                "shard_num": g.resource_opts.shard_num,
                "measures": [m.name for m in self.registry.list_measures(g.name)],
                "streams": [s.name for s in self.registry.list_streams(g.name)],
                "traces": [t.name for t in self.registry.list_traces(g.name)],
                "topn_rules": [r.name for r in self.registry.list_topn(g.name)],
            }
        return out

    def list_resources(self, group: str) -> dict:
        return {
            "measures": [_schema_obj(m) for m in self.registry.list_measures(group)],
            "streams": [_schema_obj(s) for s in self.registry.list_streams(group)],
            "traces": [_schema_obj(t) for t in self.registry.list_traces(group)],
            "index_rules": [
                _schema_obj(r) for r in self.registry.list_index_rules(group)
            ],
        }

    def validate_bydbql(self, query: str) -> dict:
        from banyandb_tpu_torch import bydbql

        try:
            catalog, req = bydbql.parse_with_catalog(query)
        except bydbql.QLError as e:
            return {"valid": False, "error": str(e)}
        return {
            "valid": True,
            "catalog": catalog,
            "group": req.groups[0],
            "resource": req.name,
        }

    def execute_bydbql(self, query: str) -> dict:
        from banyandb_tpu_torch import bydbql
        from banyandb_tpu_torch.server import result_to_json

        catalog, req = bydbql.parse_with_catalog(query)
        if catalog == "stream":
            res = self.stream.query(req)
        elif catalog == "measure":
            res = self.measure.query(req)
        else:
            raise ValueError(
                f"MCP execute supports measure/stream QL; got {catalog}"
            )
        return {"catalog": catalog, "result": result_to_json(res)}

    def topn_query(
        self, group: str, rule: str, begin_millis: int, end_millis: int, n: int = 10
    ) -> dict:
        from banyandb_tpu_torch.api.model import TimeRange
        from banyandb_tpu_torch.models import topn as topn_mod

        ranked = topn_mod.query_topn(
            self.measure, group, rule, TimeRange(begin_millis, end_millis), n=n
        )
        return {
            "items": [
                {"entity": list(e), "value": v} for e, v in ranked
            ]
        }

    # -- MCP wire -----------------------------------------------------------
    TOOLS = [
        {
            "name": "list_groups_schemas",
            "description": "List all groups with their resource inventories.",
            "inputSchema": {"type": "object", "properties": {}},
        },
        {
            "name": "list_resources",
            "description": "Full schemas (tags, fields, entities, index "
            "rules) of one group's resources.",
            "inputSchema": {
                "type": "object",
                "properties": {"group": {"type": "string"}},
                "required": ["group"],
            },
        },
        {
            "name": "validate_bydbql",
            "description": "Parse a BydbQL statement without executing it.",
            "inputSchema": {
                "type": "object",
                "properties": {"query": {"type": "string"}},
                "required": ["query"],
            },
        },
        {
            "name": "execute_bydbql",
            "description": "Execute a BydbQL statement (measure/stream "
            "catalogs) and return JSON results.",
            "inputSchema": {
                "type": "object",
                "properties": {"query": {"type": "string"}},
                "required": ["query"],
            },
        },
        {
            "name": "topn_query",
            "description": "Ranked entities from a TopN pre-aggregation rule.",
            "inputSchema": {
                "type": "object",
                "properties": {
                    "group": {"type": "string"},
                    "rule": {"type": "string"},
                    "begin_millis": {"type": "integer"},
                    "end_millis": {"type": "integer"},
                    "n": {"type": "integer"},
                },
                "required": ["group", "rule", "begin_millis", "end_millis"],
            },
        },
    ]

    def handle(self, msg: dict) -> dict | None:
        """One JSON-RPC request -> response dict (None for notifications)."""
        method = msg.get("method", "")
        mid = msg.get("id")
        if method.startswith("notifications/"):
            return None
        try:
            if method == "initialize":
                result = {
                    "protocolVersion": PROTOCOL_VERSION,
                    "capabilities": {"tools": {}},
                    "serverInfo": {
                        "name": "banyandb-tpu-mcp",
                        "version": "0.2.0",
                    },
                }
            elif method == "tools/list":
                result = {"tools": self.TOOLS}
            elif method == "tools/call":
                params = msg.get("params", {})
                name = params.get("name")
                args = params.get("arguments", {}) or {}
                fn = {
                    "list_groups_schemas": self.list_groups_schemas,
                    "list_resources": self.list_resources,
                    "validate_bydbql": self.validate_bydbql,
                    "execute_bydbql": self.execute_bydbql,
                    "topn_query": self.topn_query,
                }.get(name)
                if fn is None:
                    raise ValueError(f"unknown tool {name!r}")
                payload = fn(**args)
                result = {
                    "content": [
                        {"type": "text", "text": json.dumps(payload, default=str)}
                    ]
                }
            elif method == "ping":
                result = {}
            else:
                return {
                    "jsonrpc": "2.0",
                    "id": mid,
                    "error": {"code": -32601, "message": f"unknown method {method}"},
                }
            return {"jsonrpc": "2.0", "id": mid, "result": result}
        except Exception as e:  # noqa: BLE001 - reported in-band
            return {
                "jsonrpc": "2.0",
                "id": mid,
                "error": {"code": -32000, "message": f"{type(e).__name__}: {e}"},
            }

    def serve_stdio(self, stdin=None, stdout=None) -> None:
        stdin = stdin or sys.stdin
        stdout = stdout or sys.stdout
        for line in stdin:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                continue
            resp = self.handle(msg)
            if resp is not None:
                stdout.write(json.dumps(resp) + "\n")
                stdout.flush()


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser("banyandb-tpu MCP server")
    ap.add_argument("--root", required=True)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    McpServer(args.root, device=args.device).serve_stdio()


if __name__ == "__main__":
    main()
