"""bydbctl-analog CLI (bydbctl/internal/cmd surface, argparse flavor).

    python -m banyandb_tpu_torch.cli --addr 127.0.0.1:17912 health
    ... group create sw --catalog measure --shards 2
    ... measure create sw cpm --tags svc:string --fields v:float --entity svc
    ... write sw cpm --point '{"ts": 1700000000000, "tags": {"svc": "a"}, "fields": {"v": 1}}'
    ... query "SELECT sum(v) FROM MEASURE cpm IN sw GROUP BY svc"
    ... snapshot
"""

from __future__ import annotations

import argparse
import json
import sys

from banyandb_tpu_torch.cluster.rpc import GrpcTransport
from banyandb_tpu_torch.cluster.bus import Topic
from banyandb_tpu_torch.server import (
    TOPIC_METRICS,
    TOPIC_QL,
    TOPIC_REGISTRY,
    TOPIC_SLOWLOG,
    TOPIC_SNAPSHOT,
)


def _call(args, topic: str, envelope: dict) -> dict:
    t = GrpcTransport()
    try:
        return t.call(args.addr, topic, envelope, timeout=args.timeout)
    finally:
        t.close()


def _parse_specs(spec: str) -> list[dict]:
    out = []
    for item in spec.split(","):
        name, _, typ = item.partition(":")
        out.append({"name": name, "type": typ or "string"})
    return out


def render_explain(reply: dict) -> str:
    """Deterministic text rendering of one traced query reply: the
    logical plan tree, the serve path, and the adaptive planner's
    decision with estimated vs actual rows (query/planner).  No
    durations — the output is pinned by goldens
    (tests/test_planner.py)."""
    from banyandb_tpu_torch.obs.tracer import find_span

    trace = (reply.get("result") or {}).get("trace") or {}
    tree = trace.get("span_tree") or {}
    served = reply.get("served", "scan")
    lines = ["plan:"]
    plan_text = trace.get("plan") or "(no plan text)"
    lines.extend("  " + ln for ln in plan_text.splitlines())
    pspan = find_span(tree, "planner")
    ptags = (pspan or {}).get("tags") or {}
    rspan = find_span(tree, "reduce")
    rtags = (rspan or {}).get("tags") or {}
    # executed path: the reduce span's ground truth when a scan ran,
    # else the serve class (materialized fold / cache replay)
    path = rtags.get("path") if served == "scan" else served
    lines.append(f"path: {path or served} (served: {served})")
    if pspan is not None:
        est = ptags.get("est_rows", "-")
        actual = ptags.get("actual_rows", "-")
        lines.append("planner:")
        lines.append(f"  estimated rows: {est}  actual rows: {actual}")
        lines.append(
            f"  estimated groups: {ptags.get('est_groups', '-')}"
            f"  group method: {ptags.get('group_method', 'auto')}"
        )
        lines.append(
            f"  selectivity: {ptags.get('selectivity', '-')}"
            f"  zone pre-pass: "
            f"{'on' if ptags.get('zone_prepass') else 'off'}"
            f"  parts: {ptags.get('parts', '-')}"
        )
    else:
        lines.append(
            "planner: (no scan planned — materialized fold, cache "
            "replay, raw rows, or BYDB_PLANNER=0)"
        )
    sspan = find_span(tree, "streamagg")
    if sspan is not None and (sspan.get("tags") or {}).get("signature"):
        st = sspan["tags"]
        lines.append("materialized:")
        lines.append(f"  signature: {st.get('signature')}")
        lines.append(
            f"  coverage: {st.get('coverage')}"
            f"  windows: {st.get('windows', '-')}"
        )
    return "\n".join(lines)


def trace_search_ql(
    group: str,
    name: str,
    *,
    tags: str = "*",
    where=(),
    order_by: str = "",
    desc: bool = False,
    limit: int = 20,
    offset: int = 0,
    from_ms=None,
    to_ms=None,
) -> str:
    """Compose one BydbQL trace query from CLI/gateway search fields —
    shared by `cli.py trace search` and `GET /api/v1/trace/search` so
    the two front doors cannot drift.  [from_ms, to_ms) is half-open,
    matching the engine's TimeRange."""
    parts = [f"SELECT {tags} FROM TRACE {name} IN {group}"]
    if from_ms is not None:
        parts.append(f"TIME >= {int(from_ms)}")
        if to_ms is not None:
            parts.append(f"AND TIME < {int(to_ms)}")
    elif to_ms is not None:
        parts.append(f"TIME < {int(to_ms)}")
    conds = [w for w in where if w and w.strip()]
    if conds:
        parts.append("WHERE " + " AND ".join(conds))
    if order_by:
        parts.append(f"ORDER BY {order_by} {'DESC' if desc else 'ASC'}")
    parts.append(f"LIMIT {int(limit)}")
    if offset:
        parts.append(f"OFFSET {int(offset)}")
    return " ".join(parts)


# the pre-canned slowlog --from-db query: slowest self-traced queries
# first (duration_us is the sidx ordering key — docs/observability.md
# "Self-trace")
SELF_QUERY_QL = (
    "SELECT * FROM TRACE self_query IN _monitoring "
    "ORDER BY duration_us DESC LIMIT {limit}"
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("bydbctl (banyandb-tpu)")
    ap.add_argument("--addr", default="127.0.0.1:17912")
    # first query against a cold server may include the kernel library's
    # first build
    ap.add_argument("--timeout", type=float, default=180.0)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("health")
    sub.add_parser("snapshot")

    g = sub.add_parser("group")
    g.add_argument("action", choices=["create", "list"])
    g.add_argument("name", nargs="?")
    g.add_argument("--catalog", default="measure")
    g.add_argument("--shards", type=int, default=1)
    g.add_argument("--replicas", type=int, default=0)

    m = sub.add_parser("measure")
    m.add_argument("action", choices=["create", "list"])
    m.add_argument("group")
    m.add_argument("name", nargs="?")
    m.add_argument("--tags", default="")
    m.add_argument("--fields", default="")
    m.add_argument("--entity", default="")
    m.add_argument("--index-mode", action="store_true")

    s = sub.add_parser("stream")
    s.add_argument("action", choices=["create"])
    s.add_argument("group")
    s.add_argument("name")
    s.add_argument("--tags", default="")
    s.add_argument("--entity", default="")

    w = sub.add_parser("write")
    w.add_argument("group")
    w.add_argument("name")
    w.add_argument("--point", action="append", default=[], help="JSON data point")
    w.add_argument("--file", help="JSON file: list of points")

    q = sub.add_parser("query")
    q.add_argument("ql", help="BydbQL text")

    ex = sub.add_parser(
        "explain",
        help="run a BydbQL query traced and render the adaptive "
        "planner's decision: chosen path, estimated vs actual rows, "
        "plan tree (docs/performance.md 'Adaptive planner')",
    )
    ex.add_argument("ql", help="BydbQL text")

    rb = sub.add_parser(
        "rebalance",
        help="elastic-cluster shard placement (liaison role; "
        "docs/robustness.md 'Elastic cluster'): plan a minimal part-move "
        "list toward a target topology, apply it live (dual-route "
        "catch-up window, epoch-bumping cutover), or show placement/"
        "repair status",
    )
    rb.add_argument("action", choices=["plan", "apply", "status", "repair"])
    rb.add_argument(
        "--nodes", default="",
        help="comma-separated target node names (default: the liaison's "
        "current discovery addr book — i.e. 'make placement match "
        "membership')",
    )
    rb.add_argument(
        "--replicas", type=int, default=None,
        help="override the replica count in the new placement",
    )

    sl = sub.add_parser(
        "slowlog",
        help="slow-query flight recorder: span trees + plan text of "
        "queries over --slow-query-ms (newest first)",
    )
    sl.add_argument("--limit", type=int, default=20)
    sl.add_argument(
        "--clear", action="store_true", help="drain the ring buffer"
    )
    sl.add_argument(
        "--from-db", action="store_true",
        help="read the persistent self-trace rows from "
        "_monitoring.self_query instead of the in-memory ring "
        "(BYDB_SELF_TRACE; docs/observability.md 'Self-trace')",
    )

    sub.add_parser("metrics", help="Prometheus exposition text")

    sub.add_parser(
        "qos",
        help="multi-tenant QoS status: per-tenant admission counters "
        "(write/query admitted/queued/shed), limits, serving-cache "
        "partitions and in-flight byte charges "
        "(docs/robustness.md 'Multi-tenant QoS')",
    )

    tg = sub.add_parser("trace-get")
    tg.add_argument("group")
    tg.add_argument("name")
    tg.add_argument("trace_id")

    ts = sub.add_parser(
        "trace",
        help="trace query surface: search composes criteria, tag "
        "projection and a sidx ORDER BY into one BydbQL request "
        "(served by standalone and liaison roles)",
    )
    ts.add_argument("action", choices=["search"])
    ts.add_argument("--group", required=True)
    ts.add_argument("--name", required=True)
    ts.add_argument(
        "--where", action="append", default=[],
        help="one condition, e.g. \"svc = 'a'\" or \"dur > 100\" "
        "(repeatable; ANDed)",
    )
    ts.add_argument(
        "--tags", default="*", help="comma-separated tag projection"
    )
    ts.add_argument(
        "--order-by", default="",
        help="sidx-indexed INT tag to order traces by",
    )
    ts.add_argument("--desc", action="store_true")
    ts.add_argument("--limit", type=int, default=20)
    ts.add_argument("--offset", type=int, default=0)
    ts.add_argument(
        "--from-ms", type=int, default=None,
        help="epoch-ms lower bound (inclusive)",
    )
    ts.add_argument(
        "--to-ms", type=int, default=None,
        help="epoch-ms upper bound (exclusive)",
    )

    pr = sub.add_parser("property")
    pr.add_argument("action", choices=["apply", "get", "query"])
    pr.add_argument("group")
    pr.add_argument("name")
    pr.add_argument("id", nargs="?")
    pr.add_argument("--tags", default="{}", help="JSON tag map")

    ins = sub.add_parser("inspect", help="offline on-disk inspection")
    ins.add_argument("--root", help="server root (offline mode)")
    ins.add_argument("--part", help="one part dir for column detail")

    dp = sub.add_parser(
        "dump",
        help="offline part dump (cmd/dump analog): column extents, "
        "block stats, zone-map presence; sidx parts and property shard "
        "indexes have their own formats",
    )
    dp.add_argument(
        "kind", choices=["measure", "stream", "trace", "sidx", "property"],
        help="expected resource kind (validated against part metadata; "
        "property takes a shard-N.idx directory instead of a part dir)",
    )
    dp.add_argument(
        "part_dir",
        help="one part-<id> directory (property: one shard-N.idx dir)",
    )

    lc = sub.add_parser(
        "lifecycle",
        help="tier migration agent (banyand-lifecycle CLI analog)",
    )
    lc.add_argument("action", choices=["migrate"])
    lc.add_argument(
        "--node-root", required=True,
        help="hot node root dir (holds the registry; data under <root>/data)",
    )
    lc.add_argument(
        "--target", required=True, help="warm/cold node bus addr host:port"
    )
    lc.add_argument(
        "--older-than", type=int, required=True,
        help="migrate segments whose window ended before this epoch-ms cutoff",
    )
    lc.add_argument(
        "--catalog", action="append", default=None,
        choices=["measure", "stream", "trace"],
        help="restrict to catalog(s) (repeatable)",
    )
    lc.add_argument(
        "--device", default="cuda",
        help="torch device of the agent's engines (default cuda; without "
        "CUDA the agent refuses unless cpu is asked for)",
    )

    args = ap.parse_args(argv)

    if args.cmd == "health":
        print(json.dumps(_call(args, Topic.HEALTH.value, {})))
    elif args.cmd == "snapshot":
        print(json.dumps(_call(args, TOPIC_SNAPSHOT, {})))
    elif args.cmd == "group":
        if args.action == "create":
            item = {
                "name": args.name,
                "catalog": args.catalog,
                "resource_opts": {
                    "shard_num": args.shards,
                    "replicas": args.replicas,
                    "segment_interval": {"num": 1, "unit": "day"},
                    "ttl": {"num": 7, "unit": "day"},
                    "stages": [],
                },
            }
            print(json.dumps(_call(args, TOPIC_REGISTRY, {"op": "create", "kind": "group", "item": item})))
        else:
            print(json.dumps(_call(args, TOPIC_REGISTRY, {"op": "list", "kind": "group"})))
    elif args.cmd == "measure":
        if args.action == "create":
            item = {
                "group": args.group,
                "name": args.name,
                "tags": _parse_specs(args.tags),
                "fields": _parse_specs(args.fields) if args.fields else [],
                "entity": {"tag_names": args.entity.split(",") if args.entity else []},
                "interval": "",
                "index_mode": args.index_mode,
            }
            print(json.dumps(_call(args, TOPIC_REGISTRY, {"op": "create", "kind": "measure", "item": item})))
        else:
            print(json.dumps(_call(args, TOPIC_REGISTRY, {"op": "list", "kind": "measure", "group": args.group})))
    elif args.cmd == "stream":
        item = {
            "group": args.group,
            "name": args.name,
            "tags": _parse_specs(args.tags),
            "entity": args.entity.split(",") if args.entity else [],
        }
        print(json.dumps(_call(args, TOPIC_REGISTRY, {"op": "create_stream", "kind": "stream", "item": item})))
    elif args.cmd == "write":
        points = [json.loads(p) for p in args.point]
        if args.file:
            with open(args.file) as fh:
                points += json.loads(fh.read())
        env = {
            "request": {
                "group": args.group,
                "name": args.name,
                "points": [
                    {
                        "ts": p["ts"],
                        "tags": p.get("tags", {}),
                        "fields": p.get("fields", {}),
                        "version": p.get("version", 0),
                    }
                    for p in points
                ],
            }
        }
        print(json.dumps(_call(args, Topic.MEASURE_WRITE.value, env)))
    elif args.cmd == "query":
        print(json.dumps(_call(args, TOPIC_QL, {"ql": args.ql}), indent=1))
    elif args.cmd == "explain":
        reply = _call(args, TOPIC_QL, {"ql": args.ql, "trace": True})
        print(render_explain(reply))
    elif args.cmd == "rebalance":
        env = {"op": args.action}
        if args.nodes:
            env["nodes"] = [n for n in args.nodes.split(",") if n]
        if args.replicas is not None:
            env["replicas"] = args.replicas
        print(json.dumps(_call(args, "rebalance", env), indent=1))
    elif args.cmd == "slowlog":
        if args.from_db:
            ql = SELF_QUERY_QL.format(limit=args.limit)
            print(json.dumps(_call(args, TOPIC_QL, {"ql": ql}), indent=1))
        else:
            env = {"limit": args.limit}
            if args.clear:
                env["clear"] = True
            print(json.dumps(_call(args, TOPIC_SLOWLOG, env), indent=1))
    elif args.cmd == "metrics":
        print(_call(args, TOPIC_METRICS, {})["prometheus"], end="")
    elif args.cmd == "qos":
        from banyandb_tpu_torch.server import TOPIC_QOS

        print(json.dumps(_call(args, TOPIC_QOS, {}), indent=1))
    elif args.cmd == "trace":
        ql = trace_search_ql(
            args.group, args.name,
            tags=args.tags, where=args.where,
            order_by=args.order_by, desc=args.desc,
            limit=args.limit, offset=args.offset,
            from_ms=args.from_ms, to_ms=args.to_ms,
        )
        print(json.dumps(_call(args, TOPIC_QL, {"ql": ql}), indent=1))
    elif args.cmd == "trace-get":
        print(json.dumps(_call(args, Topic.TRACE_QUERY_BY_ID.value, {
            "group": args.group, "name": args.name, "trace_id": args.trace_id,
        }), indent=1))
    elif args.cmd == "property":
        if args.action in ("apply", "get") and not args.id:
            print(f"property {args.action} requires an id", file=sys.stderr)
            return 2
        if args.action == "apply":
            print(json.dumps(_call(args, Topic.PROPERTY_APPLY.value, {
                "group": args.group, "name": args.name, "id": args.id,
                "tags": json.loads(args.tags),
            })))
        elif args.action == "get":
            print(json.dumps(_call(args, Topic.PROPERTY_QUERY.value, {
                "group": args.group, "name": args.name, "id": args.id,
            })))
        else:
            print(json.dumps(_call(args, Topic.PROPERTY_QUERY.value, {
                "group": args.group, "name": args.name,
            }), indent=1))
    elif args.cmd == "inspect":
        from banyandb_tpu_torch.admin.inspect import inspect_part, inspect_root

        if args.part:
            print(json.dumps(inspect_part(args.part), indent=1))
        elif args.root:
            print(json.dumps(inspect_root(args.root), indent=1))
        else:
            print("inspect needs --root or --part", file=sys.stderr)
            return 2
    elif args.cmd == "dump":
        from banyandb_tpu_torch.admin.inspect import (
            inspect_part,
            inspect_property_index,
        )

        if args.kind == "property":
            try:
                doc = inspect_property_index(args.part_dir)
            except (ValueError, KeyError, OSError) as e:
                # an inconsistent index (manifest-listed segment gone,
                # malformed manifest entry) must exit 2 like a non-index
                # dir, not traceback on the operator
                print(f"dump: {e}", file=sys.stderr)
                return 2
            print(json.dumps(doc, indent=1))
            return 0
        doc = inspect_part(args.part_dir)
        if doc["meta"].get(args.kind) is None:
            print(
                f"dump: {args.part_dir} is not a {args.kind} part "
                f"(meta: {sorted(doc['meta'])})",
                file=sys.stderr,
            )
            return 2
        print(json.dumps(doc, indent=1))
    elif args.cmd == "lifecycle":
        # offline agent form, like the reference's standalone lifecycle
        # CLI: open the node's storage directly (the node process must
        # not be running against the same root) and ship over gRPC
        from pathlib import Path

        from banyandb_tpu_torch.admin.tier_migration import TierMigrator
        from banyandb_tpu_torch.api.schema import SchemaRegistry
        from banyandb_tpu_torch.cluster.data_node import DataNode

        root = Path(args.node_root)
        if not (root / "data").exists():
            # a typo'd root must not read as "ran, nothing expired"
            print(f"no data dir under node root {root}", file=sys.stderr)
            return 2
        # the offline agent opens storage and may run query kernels:
        # share the node's kernel build cache
        from banyandb_tpu_torch.utils import compile_cache

        compile_cache.enable(root / "compile-cache")
        # refuse a root whose owning node process is still alive: a
        # second Shard owner over the same dirs loses in-flight writes
        pid_file = root / "data" / ".bydb-node.pid"
        if pid_file.exists():
            import os

            try:
                owner = int(pid_file.read_text())
            except ValueError:
                owner = 0
            if owner and owner != os.getpid():
                try:
                    os.kill(owner, 0)
                except ProcessLookupError:
                    pass  # stale record from a dead process
                else:  # alive (PermissionError = alive under another uid)
                    print(
                        f"node process pid={owner} is still running on "
                        f"{root}; stop it before offline migration",
                        file=sys.stderr,
                    )
                    return 2
        node = DataNode(
            "lifecycle-agent", SchemaRegistry(root), root / "data",
            device=args.device,
        )
        transport = GrpcTransport()
        try:
            stats = TierMigrator(node, transport, args.target).run(
                args.older_than,
                catalogs=tuple(args.catalog) if args.catalog else None,
            )
        finally:
            transport.close()
        print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
