"""Load/SLO harness (test/load analog, BASELINE-style workload shape).

Boots a REAL standalone server (gRPC bus transport on a socket) on
``--device`` (CUDA by default, the CPU only when asked for), then
drives a sustained mixed workload from concurrent client threads:

  - writer threads: batched measure writes (svc/region/status tags,
    one numeric field) — the benchmark-single-model ingest shape,
  - query threads: randomized BydbQL aggregates over the trailing
    window — the 50-concurrent-query read side,

while the server's own lifecycle loops flush/merge/retain underneath.
Reports sustained write points/min, query throughput, and query latency
p50/p90/p99 — the same metrics the reference's published benchmark
tables carry (docs/operation/benchmark/benchmark-single-model.md) —
plus SLO pass/fail against optional floors.

    python -m banyandb_tpu_torch.harness.load \
        --seconds 60 --writers 2 --queriers 4 \
        --min-writes-per-min 1000000 --max-p99-ms 250 [--device cpu]

Modes: one load run (``run_load``), ``--tenants`` (``run_tenants``),
``--expand`` (``run_expand``), ``--scaling`` (``run_scaling``) and
``--selftrace`` (``run_selftrace``).  Each is importable.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np

from banyandb_tpu_torch.backend import resolve_device

T0 = 1_700_000_000_000
GROUP, MEASURE = "load", "cpm"


def _percentile(xs: list, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


def run_load(
    *,
    seconds: float = 30.0,
    writers: int = 2,
    queriers: int = 4,
    batch: int = 500,
    seed: int = 0,
    write_rate: int = 0,
    query_interval_ms: int = 0,
    tmp_root: str | None = None,
    workers: int = 0,
    autoreg: bool = False,
    device=None,
) -> dict:
    """write_rate: total sustained ingest points/s across all writers
    (0 = closed loop, writers go as fast as the core allows).  The
    reference's published query latencies are measured at a FIXED ingest
    rate (~9.5k points/s, benchmark-single-model.md:96) — a closed loop
    on a shared core measures writer throughput, not query SLO.

    workers: shard-owning worker subprocesses (BYDB_WORKERS A/B,
    docs/performance.md "Multi-process data plane"); 0 = the
    single-process layout.

    autoreg: the self-driving scenario — NO manual streamagg signature
    is registered; the server's bydb-autoreg loop must discover the
    dashboard pattern from query evidence on its own.  The artifact then
    carries the materialized-hit RAMP (per-bucket fraction + time to
    0.9).

    device: the server's device (CUDA unless ``"cpu"`` is asked for)."""
    import os as _os
    import tempfile

    from banyandb_tpu_torch.cluster.rpc import GrpcTransport
    from banyandb_tpu_torch.server import TOPIC_REGISTRY, StandaloneServer

    own_root = tmp_root is None
    root = tmp_root or tempfile.mkdtemp(prefix="bydb-load-")
    # the loop reads the env at server start; the baseline leg pins it
    # OFF explicitly (the server defaults autoreg ON) so the manual-
    # registration runs measure exactly the manual configuration — a
    # background loop adding signatures would contaminate the A/B
    _os.environ.update({"BYDB_AUTOREG": "1" if autoreg else "0"})
    # pass 0 through verbatim: the baseline phase must pin the
    # single-process layout even when BYDB_WORKERS is exported (None
    # would fall through to the env and mislabel the artifact)
    srv = StandaloneServer(root, port=0, workers=workers,
                           device=resolve_device(device))
    srv.start()
    addr = srv.addr

    def call(transport, topic, env, timeout=60.0):
        return transport.call(addr, topic, env, timeout=timeout)

    try:
        setup = GrpcTransport()
        try:
            call(setup, TOPIC_REGISTRY, {"op": "create", "kind": "group", "item": {
                "name": GROUP, "catalog": "measure",
                "resource_opts": {
                    "shard_num": 2, "replicas": 0,
                    "segment_interval": {"num": 1, "unit": "day"},
                    "ttl": {"num": 7, "unit": "day"}, "stages": [],
                },
            }})
            call(setup, TOPIC_REGISTRY, {"op": "create", "kind": "measure", "item": {
                "group": GROUP, "name": MEASURE,
                "tags": [{"name": "svc", "type": "string"},
                         {"name": "region", "type": "string"},
                         {"name": "status", "type": "int"}],
                "fields": [{"name": "value", "type": "float"}],
                "entity": {"tag_names": ["svc"]}, "interval": "", "index_mode": False,
            }})
        finally:
            setup.close()
        if not autoreg:
            # materialized dashboard signatures (query/streamagg.py):
            # the two shapes the query mix re-asks — per-service reads
            # filter on svc, dashboards group by svc and optionally
            # filter region — registered up front exactly like a real
            # console deployment.  (The --autoreg scenario registers
            # NOTHING: the bydb-autoreg loop must find them itself.)
            reg_probe = GrpcTransport()
            try:
                from banyandb_tpu_torch.server import TOPIC_STREAMAGG

                # ONE covering signature: (region, svc) answers both the
                # per-service reads and the dashboards (coverage needs
                # key-tag SUPERSET), so ingest pays a single window
                # update per row.  15s windows bound the uncovered
                # head/tail rescan to <=15s of event time per side.
                call(reg_probe, TOPIC_STREAMAGG, {
                    "op": "register", "group": GROUP, "measure": MEASURE,
                    "key_tags": ["region", "svc"], "fields": ["value"],
                    "window_millis": 15_000,
                })
            finally:
                reg_probe.close()
        stats = _drive_load(
            call, seconds=seconds, writers=writers,
            queriers=queriers, batch=batch, seed=seed,
            write_rate=write_rate, query_interval_ms=query_interval_ms,
        )
        stats["workers"] = workers
        stats["autoreg"] = autoreg
        # serving-cache composition of the reported latencies: without
        # hit/miss counters a p50 could be 99% cache replay — fetch them from the RUNNING server so the
        # artifact records what the percentiles actually measured
        probe = GrpcTransport()
        try:
            stats["serving_cache"] = _serving_cache_stats(probe, addr)
            # per-stage attribution (gather / device_execute / merge /
            # streamagg p50/p99) from the server's bucketed histograms,
            # same scraper the bench artifact uses (obs/prom.py)
            stats["stage_breakdown"] = _stage_breakdown(probe, addr)
            from banyandb_tpu_torch.server import TOPIC_STREAMAGG

            stats["streamagg"] = probe.call(
                addr, TOPIC_STREAMAGG, {"op": "stats"}, timeout=30.0
            )["streamagg"]
            if autoreg:
                stats["autoreg_stats"] = srv.autoreg.stats()
        finally:
            probe.close()
        return stats
    finally:
        srv.stop()
        if own_root:
            import shutil

            shutil.rmtree(root, ignore_errors=True)


def _serving_cache_stats(transport, addr: str) -> dict:
    """Serving-cache counters scraped from the live server's metrics
    topic -> {hits, misses, evictions, entries, hit_rate}."""
    from banyandb_tpu_torch.server import TOPIC_METRICS

    from banyandb_tpu_torch.obs import prom as obs_prom

    text = transport.call(addr, TOPIC_METRICS, {}, timeout=30.0).get(
        "prometheus", ""
    )
    # sum across label sets: in worker mode each worker exposes its own
    # serving cache under a worker="wNNN" label
    out = {}
    for name, _labels, value in obs_prom.parse_exposition(text):
        for key in ("hits", "misses", "evictions", "entries"):
            if name == f"banyandb_serving_cache_{key}":
                out[key] = out.get(key, 0) + int(value)
    lookups = out.get("hits", 0) + out.get("misses", 0)
    out["hit_rate"] = (
        round(out.get("hits", 0) / lookups, 4) if lookups else 0.0
    )
    return out


def _stage_breakdown(transport, addr: str) -> dict:
    """Stage latency quantiles recovered from the live exposition's
    _bucket series (docs/observability.md instrument scheme)."""
    from banyandb_tpu_torch.obs import prom as obs_prom
    from banyandb_tpu_torch.server import TOPIC_METRICS

    text = transport.call(addr, TOPIC_METRICS, {}, timeout=30.0).get(
        "prometheus", ""
    )
    return obs_prom.stage_breakdown(text)


def _drive_load(
    call, *, seconds, writers, queriers, batch, seed, write_rate=0,
    query_interval_ms=0,
) -> dict:
    """query_interval_ms: per-querier poll cadence (0 = closed loop).
    Closed-loop clients sharing the server's interpreter measure GIL
    saturation, not query latency — real dashboards poll on a refresh
    interval, and an OPEN-loop stream at that cadence measures latency
    including queueing without the coordinated-saturation artifact."""
    from banyandb_tpu_torch.cluster.bus import Topic
    from banyandb_tpu_torch.cluster.rpc import GrpcTransport
    from banyandb_tpu_torch.server import TOPIC_QL

    stop = threading.Event()
    written = [0] * writers
    write_errors = [0] * writers
    q_lat_ms: list[list[float]] = [[] for _ in range(queriers)]
    q_errors = [0] * queriers
    clock0 = time.time()

    def writer(wid: int):
        rng = np.random.default_rng(seed + wid)
        t = GrpcTransport()
        lane_rate = write_rate / writers if write_rate else 0
        t_start = time.monotonic()
        try:
            while not stop.is_set():
                if lane_rate:
                    # token-bucket pacing: sleep until this lane's next
                    # batch is due at the configured points/s
                    due = t_start + written[wid] / lane_rate
                    delay = due - time.monotonic()
                    if delay > 0:
                        if stop.wait(min(delay, 0.5)):
                            break
                        continue
                # disjoint per-writer timestamp lanes: stride by writer
                # count so no two writers ever collide on (series, ts)
                # and silently overwrite each other
                ts = (
                    T0
                    + ((written[wid] + np.arange(batch, dtype=np.int64))
                       * writers + wid) * 10
                )
                env = _columns_env(GROUP, MEASURE, ts, rng, batch)
                try:
                    call(t, Topic.MEASURE_WRITE_COLUMNS.value, env)
                    written[wid] += batch
                except Exception:  # noqa: BLE001 - keep load flowing
                    write_errors[wid] += 1
        finally:
            t.close()

    AGGS = ("count", "sum", "mean", "max")

    def querier(qid: int):
        rng = np.random.default_rng(1000 + seed + qid)
        t = GrpcTransport()
        issued = 0
        q_start = time.monotonic()
        try:
            while not stop.is_set():
                if query_interval_ms:
                    # open-loop dashboard poll: next query is DUE on the
                    # cadence regardless of the last one's latency
                    due = q_start + issued * query_interval_ms / 1000.0
                    delay = due - time.monotonic()
                    if delay > 0:
                        if stop.wait(min(delay, 0.5)):
                            break
                        continue
                issued += 1
                agg = AGGS[rng.integers(0, len(AGGS))]
                # Trailing event-time window (the reference benchmark's
                # query shape: trailing 15 minutes during sustained
                # ingest, benchmark-single-model.md:104): high-water
                # mark from the writers' lane clocks, quantized to 1s
                # ticks the way dashboard refresh cycles are.
                hw = T0 + (max(written) * writers * 10) // 1000 * 1000
                lo = max(T0, hw - 900_000)
                if rng.integers(0, 4) < 3:
                    # per-entity metric read (the OAP access pattern the
                    # reference benchmark measures: one service's metric
                    # over the window, series-index pruned)
                    where = f"WHERE svc = 's{rng.integers(0, 50)}' "
                    group_by = ""
                else:
                    # dashboard aggregation across all services
                    where = (
                        f"WHERE region = 'r{rng.integers(0, 3)}' "
                        if rng.integers(0, 2) else ""
                    )
                    group_by = "GROUP BY svc "
                ql = (
                    f"SELECT {agg}(value) FROM MEASURE {MEASURE} IN {GROUP} "
                    f"TIME BETWEEN {lo} AND {hw} "
                    f"{where}{group_by}LIMIT 100"
                )
                t0 = time.perf_counter()
                try:
                    reply = call(t, TOPIC_QL, {"ql": ql})
                    # per-query serve-path marker (server classifies
                    # from the span tree): replay = partials-cache hit,
                    # materialized = streamagg window fold, scan = real
                    # cache-miss reduction.  The wall offset feeds the
                    # --autoreg materialized-hit ramp.
                    q_lat_ms[qid].append((
                        (time.perf_counter() - t0) * 1000,
                        reply.get("served", "scan"),
                        time.time() - clock0,
                    ))
                except Exception:  # noqa: BLE001
                    q_errors[qid] += 1
        finally:
            t.close()

    threads = [
        threading.Thread(target=writer, args=(w,), daemon=True)
        for w in range(writers)
    ] + [
        threading.Thread(target=querier, args=(q,), daemon=True)
        for q in range(queriers)
    ]
    for th in threads:
        th.start()
    time.sleep(seconds)
    stop.set()
    for th in threads:
        th.join(timeout=30)
    elapsed = time.time() - clock0

    samples = [x for bucket in q_lat_ms for x in bucket]
    lats = sorted(ms for ms, _served, _t in samples)
    # Headline split: an aggregate p50 can hide a majority of
    # serving-cache replays — report replay and real (cache-miss) scans as separate percentiles, with materialized-window reads
    # counted as scans (they ARE the cache-miss answer path) but also
    # surfaced as their own hit fraction.
    replay = sorted(ms for ms, served, _t in samples if served == "replay")
    scans = sorted(ms for ms, served, _t in samples if served != "replay")
    materialized = [
        ms for ms, served, _t in samples if served == "materialized"
    ]
    # materialized-hit RAMP (the --autoreg acceptance evidence): per
    # 10s bucket, what fraction of queries served from windows — and
    # the first bucket whose fraction crosses 0.9
    ramp: list[dict] = []
    time_to_materialized = None
    bucket_s = 10.0
    if samples:
        horizon = max(t for _ms, _s, t in samples)
        b = 0.0
        while b < horizon:
            in_b = [s for _ms, s, t in samples if b <= t < b + bucket_s]
            if in_b:
                frac = sum(
                    1 for s in in_b if s == "materialized"
                ) / len(in_b)
                ramp.append(
                    {"t_s": round(b, 1), "fraction": round(frac, 3)}
                )
                if frac >= 0.9 and time_to_materialized is None:
                    time_to_materialized = round(b + bucket_s, 1)
            b += bucket_s
    total_written = sum(written)
    n_q = len(samples)
    return {
        "seconds": round(elapsed, 1),
        "writers": writers,
        "queriers": queriers,
        "points_written": total_written,
        "write_points_per_min": round(total_written / elapsed * 60),
        "write_errors": sum(write_errors),
        "queries": n_q,
        "queries_per_s": round(n_q / elapsed, 1),
        "query_errors": sum(q_errors),
        "latency_ms": {
            "p50": round(_percentile(lats, 50), 1),
            "p90": round(_percentile(lats, 90), 1),
            "p99": round(_percentile(lats, 99), 1),
        },
        "replay_p50_ms": round(_percentile(replay, 50), 1),
        "scan_p50_ms": round(_percentile(scans, 50), 1),
        "scan_p99_ms": round(_percentile(scans, 99), 1),
        "replay_fraction": round(len(replay) / n_q, 4) if n_q else 0.0,
        "materialized_hit_fraction": (
            round(len(materialized) / n_q, 4) if n_q else 0.0
        ),
        "materialized_ramp": ramp,
        "time_to_materialized_0_9_s": time_to_materialized,
        "served": {
            kind: sum(1 for _ms, s, _t in samples if s == kind)
            for kind in ("scan", "materialized", "replay")
        },
    }


def _columns_env(group: str, measure: str, ts, rng, batch: int) -> dict:
    """One columnar write envelope in the benchmark-single-model ingest
    shape (svc/region/status tags + one float field)."""
    import base64

    def b64(a) -> str:
        return base64.b64encode(a.tobytes()).decode()

    return {
        "group": group, "name": measure,
        "ts": b64(ts.astype("<i8")),
        "versions": b64(np.ones(batch, dtype="<i8")),
        "tags": {
            "svc": {
                "dict": [f"s{i}" for i in range(50)],
                "codes": b64(
                    rng.integers(0, 50, batch, dtype=np.int32).astype("<i4")
                ),
            },
            "region": {
                "dict": [f"r{i}" for i in range(3)],
                "codes": b64(
                    rng.integers(0, 3, batch, dtype=np.int32).astype("<i4")
                ),
            },
            "status": {
                "dict": [200, 404, 500],
                "codes": b64(
                    rng.integers(0, 3, batch, dtype=np.int32).astype("<i4")
                ),
            },
        },
        "fields": {
            "value": b64(rng.integers(0, 1000, batch).astype("<f8")),
        },
    }


def _tenant_phase(
    *,
    tenants: dict,
    seconds: float,
    batch: int,
    seed: int,
    query_interval_ms: int,
    quota: int,
    device=None,
) -> dict:
    """One multi-tenant load phase on a fresh standalone server with the
    QoS plane armed: ``tenants`` maps tenant name -> target write rate
    (points/s; the ABUSER's target exceeds its quota on purpose).  Every
    tenant gets its own group (``<tenant>.load``), one paced writer and
    one open-loop querier; per-tenant latency percentiles, client-side
    shed counts (TransportError kind="shed" — the EXPECTED rejection,
    never counted as an error) and a zero-silent-drop witness (acked
    writes == served count) come back per tenant."""
    import os as _os
    import tempfile

    from banyandb_tpu_torch.cluster.bus import Topic
    from banyandb_tpu_torch.cluster.rpc import GrpcTransport, TransportError
    from banyandb_tpu_torch.qos.plane import reset_qos
    from banyandb_tpu_torch.server import (
        TOPIC_QL,
        TOPIC_QOS,
        TOPIC_REGISTRY,
        StandaloneServer,
    )

    root = tempfile.mkdtemp(prefix="bydb-tenants-")
    _os.environ.update({
        "BYDB_AUTOREG": "0",
        "BYDB_QOS": "1",
        "BYDB_QOS_TENANTS": json.dumps(
            {t: {"write_rate": quota} for t in tenants}
        ),
    })
    reset_qos()
    srv = StandaloneServer(root, port=0, workers=0, device=device)
    srv.start()
    addr = srv.addr

    def call(transport, topic, env, timeout=60.0):
        return transport.call(addr, topic, env, timeout=timeout)

    try:
        setup = GrpcTransport()
        try:
            for tenant in tenants:
                call(setup, TOPIC_REGISTRY, {
                    "op": "create", "kind": "group", "item": {
                        "name": f"{tenant}.load", "catalog": "measure",
                        "resource_opts": {
                            "shard_num": 1, "replicas": 0,
                            "segment_interval": {"num": 1, "unit": "day"},
                            "ttl": {"num": 7, "unit": "day"}, "stages": [],
                        },
                    },
                })
                call(setup, TOPIC_REGISTRY, {
                    "op": "create", "kind": "measure", "item": {
                        "group": f"{tenant}.load", "name": MEASURE,
                        "tags": [
                            {"name": "svc", "type": "string"},
                            {"name": "region", "type": "string"},
                            {"name": "status", "type": "int"},
                        ],
                        "fields": [{"name": "value", "type": "float"}],
                        "entity": {"tag_names": ["svc"]},
                        "interval": "", "index_mode": False,
                    },
                })
                # the covering dashboard signature, per tenant (same
                # deployment shape as run_load): tenant-partitioned
                # materialized windows are part of what the scenario
                # verifies — one tenant's churn must not evict another's
                from banyandb_tpu_torch.server import TOPIC_STREAMAGG

                call(setup, TOPIC_STREAMAGG, {
                    "op": "register", "group": f"{tenant}.load",
                    "measure": MEASURE,
                    "key_tags": ["region", "svc"], "fields": ["value"],
                    "window_millis": 15_000,
                })
        finally:
            setup.close()

        stop = threading.Event()
        acked = {t: 0 for t in tenants}
        sheds = {t: 0 for t in tenants}
        write_errors = {t: 0 for t in tenants}
        q_lat = {t: [] for t in tenants}  # (ms, served)
        q_sheds = {t: 0 for t in tenants}
        q_errors = {t: 0 for t in tenants}
        clock0 = time.time()

        def writer(tenant: str, rate: float):
            rng = np.random.default_rng(seed + sum(map(ord, tenant)))
            tr = GrpcTransport()
            t_start = time.monotonic()
            sent = 0  # attempted points (pacing covers sheds too)
            try:
                while not stop.is_set():
                    due = t_start + sent / rate
                    delay = due - time.monotonic()
                    if delay > 0:
                        if stop.wait(min(delay, 0.5)):
                            break
                        continue
                    ts = T0 + acked[tenant] + np.arange(batch, dtype=np.int64)
                    env = _columns_env(
                        f"{tenant}.load", MEASURE, ts, rng, batch
                    )
                    sent += batch
                    try:
                        call(tr, Topic.MEASURE_WRITE_COLUMNS.value, env)
                        acked[tenant] += batch
                    except TransportError as e:
                        if getattr(e, "kind", "") == "shed":
                            sheds[tenant] += 1  # EXPECTED, retryable
                        else:
                            write_errors[tenant] += 1
                    except Exception:  # noqa: BLE001 - keep load flowing
                        write_errors[tenant] += 1
            finally:
                tr.close()

        AGGS = ("count", "sum", "mean", "max")

        def querier(tenant: str):
            rng = np.random.default_rng(7000 + seed + sum(map(ord, tenant)))
            tr = GrpcTransport()
            issued = 0
            q_start = time.monotonic()
            try:
                while not stop.is_set():
                    due = q_start + issued * query_interval_ms / 1000.0
                    delay = due - time.monotonic()
                    if delay > 0:
                        if stop.wait(min(delay, 0.5)):
                            break
                        continue
                    issued += 1
                    agg = AGGS[rng.integers(0, len(AGGS))]
                    hw = T0 + max(acked[tenant], 1)
                    where = (
                        f"WHERE region = 'r{rng.integers(0, 3)}' "
                        if rng.integers(0, 2) else ""
                    )
                    ql = (
                        f"SELECT {agg}(value) FROM MEASURE {MEASURE} "
                        f"IN {tenant}.load "
                        f"TIME BETWEEN {T0} AND {hw} "
                        f"{where}GROUP BY svc LIMIT 100"
                    )
                    t0 = time.perf_counter()
                    try:
                        reply = call(tr, TOPIC_QL, {"ql": ql})
                        q_lat[tenant].append((
                            (time.perf_counter() - t0) * 1000,
                            reply.get("served", "scan"),
                        ))
                    except TransportError as e:
                        if getattr(e, "kind", "") == "shed":
                            q_sheds[tenant] += 1
                        else:
                            q_errors[tenant] += 1
                    except Exception:  # noqa: BLE001
                        q_errors[tenant] += 1
            finally:
                tr.close()

        threads = [
            threading.Thread(target=writer, args=(t, r), daemon=True)
            for t, r in tenants.items()
        ] + [
            threading.Thread(target=querier, args=(t,), daemon=True)
            for t in tenants
        ]
        for th in threads:
            th.start()
        time.sleep(seconds)
        stop.set()
        for th in threads:
            th.join(timeout=30)
        elapsed = time.time() - clock0

        # zero-silent-drop witness: every ACKED point must be served
        # back by a count over the full range (sheds were never acked)
        served_counts = {}
        probe = GrpcTransport()
        try:
            for tenant in tenants:
                r = call(probe, TOPIC_QL, {
                    "ql": f"SELECT count(value) FROM MEASURE {MEASURE} "
                          f"IN {tenant}.load "
                          f"TIME BETWEEN {T0} AND {T0 + (1 << 40)}",
                })
                served_counts[tenant] = int(
                    sum(r["result"]["values"].get("count", ()))
                )
            qos_stats = call(probe, TOPIC_QOS, {})["qos"]["tenants"]
        finally:
            probe.close()

        out: dict = {"seconds": round(elapsed, 1), "tenants": {}}
        for tenant, rate in tenants.items():
            lats = q_lat[tenant]
            scans = sorted(ms for ms, served in lats if served != "replay")
            all_ms = sorted(ms for ms, _s in lats)
            server_side = qos_stats.get(tenant, {})
            out["tenants"][tenant] = {
                "target_rate": rate,
                "quota": quota,
                "acked_points": acked[tenant],
                "acked_rate": round(acked[tenant] / elapsed, 1),
                "write_sheds_client": sheds[tenant],
                "write_shed_server": server_side.get("write_shed", 0),
                "write_errors": write_errors[tenant],
                "silent_drops": max(
                    0, acked[tenant] - served_counts[tenant]
                ),
                "queries": len(lats),
                "query_sheds": q_sheds[tenant],
                "query_errors": q_errors[tenant],
                "p50_ms": round(_percentile(all_ms, 50), 1),
                "p99_ms": round(_percentile(all_ms, 99), 1),
                "scan_p50_ms": round(_percentile(scans, 50), 1),
                "scan_samples": len(scans),
            }
        return out
    finally:
        srv.stop()
        import shutil

        shutil.rmtree(root, ignore_errors=True)
        for k in ("BYDB_QOS", "BYDB_QOS_TENANTS"):
            _os.environ.pop(k, None)
        from banyandb_tpu_torch.qos.plane import reset_qos as _reset

        _reset()


TENANTS_MIN_CORES = 4


def run_tenants(
    *,
    seconds: float = 40.0,
    quota: int = 4000,
    abuse_x: int = 10,
    batch: int = 200,
    seed: int = 0,
    query_interval_ms: int = 250,
    allow_small_host: bool = False,
    device=None,
) -> dict:
    """The adversarial multi-tenant scenario: one ABUSER tenant
    driving ingest at ``abuse_x`` times its quota beside two compliant
    tenants, after a SOLO baseline phase measuring one compliant tenant
    alone (SAME duration and rate, so both phases scan comparable row
    counts).  The done-bar: compliant scan_p50 within 1.5x of its solo
    baseline, the abuser shed with explicit retryable rejections, zero
    silent drops anywhere.

    Small-host rule (same as --scaling/--expand): on a
    < TENANTS_MIN_CORES host the server, three tenants' clients and
    the abuser's shed attempts all convoy on the same cores, so the
    p50 ratio measures the BOX, not the admission plane — refuse
    unless --allow-small-host, and stamp the artifact with an explicit
    caveat when recorded anyway."""
    import os as _os

    cores = _os.cpu_count() or 1
    small = cores < TENANTS_MIN_CORES
    if small and not allow_small_host:
        raise SystemExit(
            f"load --tenants: host has {cores} cores < "
            f"{TENANTS_MIN_CORES}; the compliant-p50 ratio would "
            "measure core contention, not tenant isolation.  Re-run on "
            "a bigger host, or pass --allow-small-host to record an "
            "explicitly-caveated artifact."
        )
    dev = resolve_device(device)
    compliant_rate = max(quota // 2, 1)  # well inside quota
    phase_s = max(seconds * 0.5, 10.0)  # EQUAL phases: comparable scans
    solo = _tenant_phase(
        tenants={"t1": compliant_rate},
        seconds=phase_s,
        batch=batch, seed=seed,
        query_interval_ms=query_interval_ms, quota=quota, device=dev,
    )
    adversarial = _tenant_phase(
        tenants={
            "t1": compliant_rate,
            "t2": compliant_rate,
            "abuser": quota * abuse_x,
        },
        seconds=phase_s,
        batch=batch, seed=seed + 1,
        query_interval_ms=query_interval_ms, quota=quota, device=dev,
    )
    solo_p50 = solo["tenants"]["t1"]["scan_p50_ms"]
    compliant = [adversarial["tenants"][t] for t in ("t1", "t2")]
    worst_p50 = max(c["scan_p50_ms"] for c in compliant)
    abuser = adversarial["tenants"]["abuser"]
    out = {
        "phase": "tenants",
        "cores": cores,
        "small_host": small,
        "quota_points_per_s": quota,
        "abuse_x": abuse_x,
        "solo": solo,
        "adversarial": adversarial,
        "solo_scan_p50_ms": solo_p50,
        "worst_compliant_scan_p50_ms": worst_p50,
        "compliant_p50_x": (
            round(worst_p50 / solo_p50, 2) if solo_p50 > 0 else None
        ),
        "abuser_sheds": abuser["write_sheds_client"],
        "abuser_acked_rate": abuser["acked_rate"],
        "silent_drops": sum(
            row["silent_drops"]
            for phase in (solo, adversarial)
            for row in phase["tenants"].values()
        ),
        "compliant_scan_samples": sum(
            c["scan_samples"] for c in compliant
        ),
        "write_errors": sum(
            row["write_errors"]
            for phase in (solo, adversarial)
            for row in phase["tenants"].values()
        ),
        "query_errors": sum(
            row["query_errors"]
            for phase in (solo, adversarial)
            for row in phase["tenants"].values()
        ),
    }
    if small:
        out["caveat"] = (
            f"measured on a {cores}-core host: server + three tenants' "
            "clients + the abuser's shed attempts share cores, so the "
            "compliant-p50 ratio OVERSTATES the abuser's impact; the "
            "<=1.5x bar is only valid on >= "
            f"{TENANTS_MIN_CORES} cores.  Shed/isolation/zero-drop "
            "witnesses are box-independent and binding."
        )
    return out


SCALING_MIN_CORES = 8


def run_expand(
    *,
    seconds: float = 45.0,
    writers: int = 2,
    queriers: int = 2,
    batch: int = 200,
    seed: int = 0,
    start_nodes: int = 3,
    end_nodes: int = 5,
    shard_num: int = 6,
    replicas: int = 1,
    allow_small_host: bool = False,
    device=None,
) -> dict:
    """Live cluster expansion under traffic (the <2x move-window bar;
    docs/robustness.md "Elastic cluster"): a ``start_nodes``-node
    cluster of real gRPC data nodes takes sustained writes+queries
    while ``end_nodes - start_nodes`` nodes JOIN and one rebalance
    plan+apply moves their fair share of shards.  The artifact carries
    per-phase (steady / move-window / post-cutover) query p99, the
    move stats, and the zero-acked-loss witness.

    Small-host caveat rules mirror ``--scaling``: parent + nodes +
    clients convoy on a tiny host, so the move-window p99 ratio
    measures the BOX; refuse unless --allow-small-host, and stamp the
    artifact with an explicit caveat when recorded anyway."""
    import os as _os
    import tempfile
    from pathlib import Path

    from banyandb_tpu_torch.api import (
        Catalog,
        DataPointValue,
        Entity,
        FieldSpec,
        FieldType,
        Group,
        Measure,
        ResourceOpts,
        SchemaRegistry,
        TagSpec,
        TagType,
        WriteRequest,
    )
    from banyandb_tpu_torch.cluster import DataNode, Liaison, NodeInfo
    from banyandb_tpu_torch.cluster.placement import PlacementSelector
    from banyandb_tpu_torch.cluster.rebalance import Rebalancer
    from banyandb_tpu_torch.cluster.rpc import (
        GrpcBusServer,
        GrpcTransport,
        TransportError,
    )

    cores = _os.cpu_count() or 1
    small = cores < SCALING_MIN_CORES
    if small and not allow_small_host:
        raise SystemExit(
            f"load --expand: host has {cores} cores < {SCALING_MIN_CORES}; "
            "the move-window p99 would measure core contention, not the "
            "mover.  Re-run on a bigger host, or pass --allow-small-host "
            "to record an explicitly-caveated artifact."
        )
    dev = resolve_device(device)
    tmp = Path(tempfile.mkdtemp(prefix="bydb-expand-"))

    def schema(reg):
        reg.create_group(Group(
            GROUP, Catalog.MEASURE,
            ResourceOpts(shard_num=shard_num, replicas=replicas),
        ))
        reg.create_measure(Measure(
            group=GROUP, name=MEASURE,
            tags=(TagSpec("svc", TagType.STRING),),
            fields=(FieldSpec("value", FieldType.FLOAT),),
            entity=Entity(("svc",)),
        ))

    def spawn(name):
        reg = SchemaRegistry(tmp / name / "schema")
        schema(reg)
        dn = DataNode(name, reg, tmp / name / "data", device=dev)
        srv = GrpcBusServer(dn.bus, sync_install=dn.install_synced_parts)
        srv.start()
        return dn, srv, NodeInfo(name, srv.addr)

    dns, servers, infos = {}, {}, []
    for i in range(start_nodes):
        dn, srv, info = spawn(f"x{i}")
        dns[info.name], servers[info.name] = dn, srv
        infos.append(info)
    transport = GrpcTransport()
    lreg = SchemaRegistry(tmp / "liaison" / "schema")
    schema(lreg)
    liaison = Liaison(
        lreg, transport, infos, replicas=replicas,
        placement_store=str(tmp / "liaison" / "placement.json"),
        handoff_root=str(tmp / "liaison" / "handoff"),
    )
    liaison.probe()

    stop = threading.Event()
    acked = [0] * writers
    write_errors = [0]
    samples: list[tuple[float, float]] = []  # (latency_ms, wall_s)
    q_errors = [0]
    clock0 = time.monotonic()
    write_lock = threading.Lock()

    def writer(wid):
        while not stop.is_set():
            with write_lock:
                base = sum(acked)
                pts = tuple(
                    DataPointValue(
                        ts_millis=T0 + (base + i) * writers + wid,
                        tags={"svc": f"s{(base + i) % 24}"},
                        fields={"value": 1.0}, version=1,
                    )
                    for i in range(batch)
                )
            try:
                liaison.write_measure(WriteRequest(GROUP, MEASURE, pts))
                acked[wid] += batch
            except TransportError:
                write_errors[0] += 1
                time.sleep(0.01)
                continue  # the retry: the next pass rebuilds the same batch
            time.sleep(0.01)

    def querier(qid):
        from banyandb_tpu_torch.api import (
            Aggregation, GroupBy, QueryRequest, TimeRange,
        )

        rng = np.random.default_rng(1000 + seed + qid)
        while not stop.is_set():
            req = QueryRequest(
                groups=(GROUP,), name=MEASURE,
                time_range=TimeRange(T0, T0 + 500_000_000),
                group_by=GroupBy(("svc",)),
                agg=Aggregation(
                    ("count", "sum", "max")[rng.integers(0, 3)], "value"
                ),
            )
            t0 = time.perf_counter()
            try:
                liaison.query_measure(req)
                samples.append((
                    (time.perf_counter() - t0) * 1000,
                    time.monotonic() - clock0,
                ))
            except Exception:  # noqa: BLE001 - counted, load continues
                q_errors[0] += 1
            time.sleep(0.05)

    threads = [
        threading.Thread(target=writer, args=(w,), daemon=True)
        for w in range(writers)
    ] + [
        threading.Thread(target=querier, args=(q,), daemon=True)
        for q in range(queriers)
    ]
    move_stats: dict = {}
    try:
        for th in threads:
            th.start()
        steady_s = max(seconds * 0.3, 5.0)
        time.sleep(steady_s)
        # the JOIN: new nodes appear in the addr book (no re-placement)
        for i in range(start_nodes, end_nodes):
            dn, srv, info = spawn(f"x{i}")
            dns[info.name], servers[info.name] = dn, srv
            with liaison._placement_lock:
                liaison.selector = PlacementSelector(
                    list(liaison.selector.nodes) + [info], liaison.placement
                )
        liaison.probe()
        move_t0 = time.monotonic() - clock0
        reb = Rebalancer(liaison)
        plan = reb.plan()
        move_stats = reb.apply(plan)
        move_t1 = time.monotonic() - clock0
        time.sleep(max(seconds - steady_s - (move_t1 - move_t0), 5.0))
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=30)

    # zero acked-write loss: poll until the full count is served
    total_acked = sum(acked)
    got = -1
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        from banyandb_tpu_torch.api import Aggregation, QueryRequest, TimeRange

        try:
            res = liaison.query_measure(QueryRequest(
                groups=(GROUP,), name=MEASURE,
                time_range=TimeRange(T0, T0 + 500_000_000),
                agg=Aggregation("count", "value"),
            ))
        except TransportError:
            time.sleep(0.5)
            continue  # a node still coming back: poll again
        got = int(sum(res.values.get("count", [])))
        if got == total_acked and not res.degraded:
            break
        time.sleep(0.5)
    transport.close()
    for srv in servers.values():
        srv.stop(grace=0)
    for dn in dns.values():
        dn.measure.close()
        dn.stream.close()
        dn.trace.close()

    def phase_p(xs, q):
        return round(_percentile(xs, q), 1)

    steady = [ms for ms, t in samples if t < move_t0]
    window = [ms for ms, t in samples if move_t0 <= t <= move_t1]
    post = [ms for ms, t in samples if t > move_t1]
    out = {
        "phase": "expand",
        "cores": cores,
        "small_host": small,
        "nodes": {"start": start_nodes, "end": end_nodes},
        "shard_num": shard_num,
        "replicas": replicas,
        "seconds": round(time.monotonic() - clock0, 1),
        "acked": total_acked,
        "served_after_move": got,
        "acked_loss": max(0, total_acked - got),
        "write_errors": write_errors[0],
        "query_errors": q_errors[0],
        "queries": len(samples),
        "move_window_s": round(move_t1 - move_t0, 2),
        "rebalance": move_stats,
        "epoch": move_stats.get("new_epoch"),
        "p99_ms": {
            "steady": phase_p(steady, 99),
            "move_window": phase_p(window, 99),
            "post_cutover": phase_p(post, 99),
        },
        "p50_ms": {
            "steady": phase_p(steady, 50),
            "move_window": phase_p(window, 50),
            "post_cutover": phase_p(post, 50),
        },
        "move_p99_x": (
            round(phase_p(window, 99) / phase_p(steady, 99), 2)
            if steady and window and phase_p(steady, 99) > 0
            else None
        ),
    }
    if small:
        out["caveat"] = (
            f"measured on a {cores}-core host: liaison + {end_nodes} "
            "nodes + clients share cores, so the move-window p99 ratio "
            "OVERSTATES the mover's impact; the <2x bar is only "
            f"valid on >= {SCALING_MIN_CORES} cores"
        )
    return out


def run_scaling(
    *,
    seconds: float = 45.0,
    writers: int = 2,
    queriers: int = 4,
    batch: int = 500,
    seed: int = 0,
    write_rate: int = 0,
    query_interval_ms: int = 0,
    allow_small_host: bool = False,
    steps: tuple[int, ...] = (1, 4),
    device=None,
) -> dict:
    """The 1→4 worker scaling phase (the >=3x bar): the SAME
    N-querier workload against BYDB_WORKERS=1 then =4, reporting the
    headline scaling ratio, per-phase scan/replay p50 and write errors.

    Guarded like the --max-scan-p50-ms vacuous-pass rule: measuring a
    4-worker fleet on a <8-core host convoys every process onto the
    same cores and reads as a scaling regression of the ENGINE when it
    is a property of the BOX — fail loudly instead of recording it,
    unless the caller explicitly marks the artifact as small-host."""
    import os as _os

    cores = _os.cpu_count() or 1
    small = cores < SCALING_MIN_CORES
    if small and not allow_small_host:
        raise SystemExit(
            f"load --scaling: host has {cores} cores < {SCALING_MIN_CORES}; "
            "the 1->4 worker headline would measure core contention, not "
            "scaling.  Re-run on a bigger host, or pass --allow-small-host "
            "to record an explicitly-caveated artifact."
        )
    phases = {}
    for n in steps:
        phases[f"workers_{n}"] = run_load(
            seconds=seconds, writers=writers, queriers=queriers,
            batch=batch, seed=seed, write_rate=write_rate,
            query_interval_ms=query_interval_ms, workers=n, device=device,
        )
    lo, hi = phases[f"workers_{steps[0]}"], phases[f"workers_{steps[-1]}"]
    out = {
        "phase": "worker-scaling",
        "cores": cores,
        "small_host": small,
        "steps": list(steps),
        "phases": phases,
        "qps_scaling": (
            round(hi["queries_per_s"] / lo["queries_per_s"], 2)
            if lo["queries_per_s"]
            else 0.0
        ),
        "scan_p50_scaling": (
            round(lo["scan_p50_ms"] / hi["scan_p50_ms"], 2)
            if hi["scan_p50_ms"]
            else 0.0
        ),
        "write_errors": sum(p["write_errors"] for p in phases.values()),
    }
    if small:
        out["caveat"] = (
            f"measured on a {cores}-core host: parent + workers + "
            "clients share cores, so the ratio UNDERSTATES the engine's "
            "scaling; the >=3x bar is only valid on >= "
            f"{SCALING_MIN_CORES} cores"
        )
    return out


def run_selftrace(
    *,
    seconds: float = 30.0,
    writers: int = 2,
    queriers: int = 4,
    batch: int = 500,
    seed: int = 0,
    write_rate: int = 0,
    query_interval_ms: int = 0,
    device=None,
) -> dict:
    """Self-trace overhead A/B (docs/observability.md "Self-trace"):
    the SAME workload with the dogfood sink OFF then ON at its
    worst-case setting (BYDB_SELF_TRACE_MS=0 — EVERY query's span tree
    queued and mirrored through the server's own TraceEngine), reporting
    ``selftrace_overhead_x`` = on_p50 / off_p50.  The sink's contract is
    shed-never-block, so the ratio is the whole claim: the gate reads
    <= 1.05.  The ON phase also witnesses the sink actually fired
    (``selftrace_spans`` delta) — a gate over a sink that never ran
    would pass vacuously."""
    import contextlib

    from banyandb_tpu_torch.harness import env_scope
    from banyandb_tpu_torch.obs import metrics as obs_metrics

    def spans_total() -> float:
        snap = obs_metrics.global_meter().snapshot()
        return snap["counters"].get(("selftrace_spans", ()), 0.0)

    phases = {}
    deltas = {}
    for label in ("off", "on"):
        s0 = spans_total()
        with (
            env_scope({"BYDB_SELF_TRACE": "1", "BYDB_SELF_TRACE_MS": "0"})
            if label == "on" else contextlib.nullcontext()
        ):
            phases[label] = run_load(
                seconds=seconds, writers=writers, queriers=queriers,
                batch=batch, seed=seed, write_rate=write_rate,
                query_interval_ms=query_interval_ms, device=device,
            )
        deltas[label] = spans_total() - s0
    off_p50 = phases["off"]["latency_ms"]["p50"]
    on_p50 = phases["on"]["latency_ms"]["p50"]
    return {
        "phase": "selftrace",
        "phases": phases,
        "selftrace_spans_off": deltas["off"],
        "selftrace_spans_on": deltas["on"],
        "off_p50_ms": off_p50,
        "on_p50_ms": on_p50,
        "selftrace_overhead_x": (
            round(on_p50 / off_p50, 2) if off_p50 > 0 else None
        ),
        "write_errors": sum(p["write_errors"] for p in phases.values()),
        "query_errors": sum(p["query_errors"] for p in phases.values()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("bydb load (throughput/SLO harness)")
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--writers", type=int, default=2)
    ap.add_argument("--queriers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--write-rate", type=int, default=0,
        help="total ingest points/s across writers (0 = closed loop)",
    )
    ap.add_argument(
        "--write-rate-x", type=int, default=1,
        help="multiplier on --write-rate (e.g. --write-rate 10000 "
        "--write-rate-x 4 = a 40k points/s run)",
    )
    ap.add_argument(
        "--query-interval-ms", type=int, default=0,
        help="per-querier dashboard poll cadence; 0 = closed loop "
        "(closed-loop clients in the server's interpreter measure GIL "
        "saturation, not latency)",
    )
    ap.add_argument("--min-writes-per-min", type=int, default=0)
    ap.add_argument("--max-p99-ms", type=float, default=0.0)
    ap.add_argument(
        "--max-scan-p50-ms", type=float, default=0.0,
        help="SLO floor on the real-scan (cache-miss) p50 — the "
        "multi-tenant done-bar reads this field directly",
    )
    ap.add_argument(
        "--workers", type=int, default=0,
        help="shard-owning worker subprocesses (BYDB_WORKERS A/B; "
        "0 = single-process layout)",
    )
    ap.add_argument(
        "--autoreg", action="store_true",
        help="self-driving scenario: register NO manual streamagg "
        "signature and let the bydb-autoreg loop discover the dashboard "
        "pattern (persists the materialized-hit ramp)",
    )
    ap.add_argument(
        "--max-materialize-s", type=float, default=0.0,
        help="SLO ceiling on time_to_materialized_0_9_s under --autoreg "
        "(the autoreg bar reads <= 120); never reaching 0.9 "
        "fails the gate",
    )
    ap.add_argument(
        "--expand", action="store_true",
        help="live cluster-expansion scenario: real "
        "gRPC data nodes under sustained traffic, N nodes join, one "
        "rebalance plan+apply moves their fair share — persists "
        "per-phase p99 (steady/move-window/post-cutover), the move "
        "stats and the zero-acked-loss witness",
    )
    ap.add_argument(
        "--expand-from", type=int, default=3,
        help="cluster size before the join (default 3)",
    )
    ap.add_argument(
        "--expand-to", type=int, default=5,
        help="cluster size after the join (default 5; the "
        "done-bar reads 3->5)",
    )
    ap.add_argument(
        "--max-move-p99-x", type=float, default=0.0,
        help="SLO ceiling on move-window p99 / steady p99 under "
        "--expand (the done-bar reads < 2.0); unmeasurable on "
        "a small host = failed SLO (vacuous-pass rule)",
    )
    ap.add_argument(
        "--tenants", action="store_true",
        help="multi-tenant adversarial scenario ("
        "done-bar): one abusive tenant at --abuse-x times its quota "
        "beside two compliant tenants, after a solo compliant "
        "baseline — persists per-tenant p50/p99, shed counts and the "
        "zero-silent-drop witness",
    )
    ap.add_argument(
        "--tenant-quota", type=int, default=4000,
        help="per-tenant ingest quota, points/s (the abuser targets "
        "--abuse-x times this)",
    )
    ap.add_argument(
        "--abuse-x", type=int, default=10,
        help="abuser ingest multiple over its quota (default 10)",
    )
    ap.add_argument(
        "--max-compliant-p50-x", type=float, default=0.0,
        help="SLO ceiling on worst compliant-tenant scan_p50 / solo "
        "baseline scan_p50 under --tenants (the done-bar reads "
        "<= 1.5); zero compliant scan samples = failed SLO "
        "(vacuous-pass rule)",
    )
    ap.add_argument(
        "--selftrace", action="store_true",
        help="self-trace overhead A/B: the same workload with the "
        "dogfood sink off then on at BYDB_SELF_TRACE_MS=0 (every query "
        "mirrored) — persists selftrace_overhead_x = on_p50/off_p50",
    )
    ap.add_argument(
        "--max-selftrace-x", type=float, default=1.05,
        help="SLO ceiling on selftrace_overhead_x under --selftrace "
        "(docs/observability.md reads <= 1.05); an unmeasurable ratio "
        "or a sink that never fired fails the gate (vacuous-pass rule)",
    )
    ap.add_argument(
        "--scaling", action="store_true",
        help="run the 1->4 worker scaling phase instead of one load run "
        "(persists per-phase stats + scaling ratios; requires a host "
        f"with >= {SCALING_MIN_CORES} cores)",
    )
    ap.add_argument(
        "--allow-small-host", action="store_true",
        help="record the scaling artifact on a small host anyway, with "
        "an explicit small_host caveat (the >=3x bar is NOT valid there)",
    )
    ap.add_argument(
        "--min-qps-scaling", type=float, default=0.0,
        help="SLO floor on the 1->4 worker queries/s ratio (the "
        "done-bar reads >=3.0 on a >=8-core host)",
    )
    ap.add_argument(
        "--out", default="",
        help="also persist the stats JSON to this path "
        "(e.g. load.json)",
    )
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without CUDA only cpu runs")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.expand:
        stats = run_expand(
            seconds=args.seconds, writers=args.writers,
            queriers=args.queriers, batch=args.batch, seed=args.seed,
            start_nodes=args.expand_from, end_nodes=args.expand_to,
            allow_small_host=args.allow_small_host, device=dev,
        )
        slo_fail = []
        if stats["acked_loss"]:
            slo_fail.append("acked_loss")
        if stats["query_errors"]:
            slo_fail.append("errors")
        if args.max_move_p99_x:
            if stats["small_host"]:
                # vacuous-pass guard: a ratio measured under core
                # contention must never satisfy the bar
                slo_fail.append("move_p99_unmeasurable_small_host")
            elif (
                stats["move_p99_x"] is None
                or stats["move_p99_x"] > args.max_move_p99_x
            ):
                slo_fail.append("move_p99")
        stats["slo_fail"] = slo_fail
        print(json.dumps(stats))
        if args.out:
            from pathlib import Path

            Path(args.out).write_text(json.dumps(stats, indent=1) + "\n")
        return 1 if slo_fail else 0
    if args.tenants:
        stats = run_tenants(
            seconds=args.seconds, quota=args.tenant_quota,
            abuse_x=args.abuse_x, batch=args.batch, seed=args.seed,
            query_interval_ms=args.query_interval_ms or 250,
            allow_small_host=args.allow_small_host, device=dev,
        )
        slo_fail = []
        if stats["abuser_sheds"] == 0:
            # the quota never bit: the scenario measured nothing
            slo_fail.append("abuser_not_shed")
        if stats["silent_drops"]:
            slo_fail.append("silent_drops")
        if stats["write_errors"] or stats["query_errors"]:
            slo_fail.append("errors")
        if args.max_compliant_p50_x:
            if stats["small_host"]:
                # vacuous-pass guard: a ratio measured under core
                # contention must never satisfy the bar
                slo_fail.append("compliant_p50_unmeasurable_small_host")
            elif stats["compliant_scan_samples"] == 0 or not stats[
                "compliant_p50_x"
            ]:
                # zero compliant samples (or an unmeasurable solo
                # baseline) must never satisfy the bar either
                slo_fail.append("compliant_p50_unmeasurable")
            elif stats["compliant_p50_x"] > args.max_compliant_p50_x:
                slo_fail.append("compliant_p50")
        stats["slo_fail"] = slo_fail
        print(json.dumps(stats))
        if args.out:
            from pathlib import Path

            Path(args.out).write_text(json.dumps(stats, indent=1) + "\n")
        return 1 if slo_fail else 0
    if args.selftrace:
        stats = run_selftrace(
            seconds=args.seconds, writers=args.writers,
            queriers=args.queriers, batch=args.batch, seed=args.seed,
            write_rate=args.write_rate * max(args.write_rate_x, 1),
            query_interval_ms=args.query_interval_ms, device=dev,
        )
        slo_fail = []
        if stats["write_errors"] or stats["query_errors"]:
            slo_fail.append("errors")
        if args.max_selftrace_x:
            if stats["selftrace_spans_on"] <= 0:
                # the sink never mirrored a span: the ON phase measured
                # the OFF path twice and the ratio proves nothing
                slo_fail.append("selftrace_sink_never_fired")
            elif stats["selftrace_spans_off"] > 0:
                # the OFF baseline was contaminated by a live sink
                slo_fail.append("selftrace_baseline_contaminated")
            elif stats["selftrace_overhead_x"] is None:
                # off_p50 of 0.0 means no queries completed — an
                # unmeasured SLO is a failed SLO (vacuous-pass rule)
                slo_fail.append("selftrace_unmeasurable")
            elif stats["selftrace_overhead_x"] > args.max_selftrace_x:
                slo_fail.append("selftrace_overhead")
        stats["slo_fail"] = slo_fail
        print(json.dumps(stats))
        if args.out:
            from pathlib import Path

            Path(args.out).write_text(json.dumps(stats, indent=1) + "\n")
        return 1 if slo_fail else 0
    if args.scaling:
        if args.workers:
            # the sweep sets the worker count itself; a silently-ignored
            # flag would mislabel what was measured
            print(
                "load --scaling: --workers is ignored (the phase sweeps "
                "1->4 workers itself)",
                file=sys.stderr,
            )
        stats = run_scaling(
            seconds=args.seconds, writers=args.writers,
            queriers=args.queriers, batch=args.batch, seed=args.seed,
            write_rate=args.write_rate * max(args.write_rate_x, 1),
            query_interval_ms=args.query_interval_ms,
            allow_small_host=args.allow_small_host, device=dev,
        )
        slo_fail = []
        if stats["write_errors"]:
            slo_fail.append("errors")
        # the single-run SLO gates apply PER PHASE — a gated pipeline
        # passing --max-scan-p50-ms must never sail through on the
        # scaling path unevaluated (vacuous-pass rule)
        for pname, p in stats["phases"].items():
            if (
                args.min_writes_per_min
                and p["write_points_per_min"] < args.min_writes_per_min
            ):
                slo_fail.append(f"write_points_per_min:{pname}")
            if args.max_p99_ms and p["latency_ms"]["p99"] > args.max_p99_ms:
                slo_fail.append(f"p99:{pname}")
            if args.max_scan_p50_ms:
                scan_samples = (
                    p["served"]["scan"] + p["served"]["materialized"]
                )
                if (
                    scan_samples == 0
                    or p["scan_p50_ms"] > args.max_scan_p50_ms
                ):
                    slo_fail.append(f"scan_p50:{pname}")
        if args.min_qps_scaling:
            if stats["small_host"]:
                # vacuous-pass guard, scaling edition: a ratio measured
                # under core contention must never satisfy the bar
                slo_fail.append("qps_scaling_unmeasurable_small_host")
            elif stats["qps_scaling"] < args.min_qps_scaling:
                slo_fail.append("qps_scaling")
        stats["slo_fail"] = slo_fail
        print(json.dumps(stats))
        if args.out:
            from pathlib import Path

            Path(args.out).write_text(json.dumps(stats, indent=1) + "\n")
        return 1 if slo_fail else 0
    stats = run_load(
        seconds=args.seconds, writers=args.writers,
        queriers=args.queriers, batch=args.batch, seed=args.seed,
        write_rate=args.write_rate * max(args.write_rate_x, 1),
        query_interval_ms=args.query_interval_ms,
        workers=args.workers,
        autoreg=args.autoreg,
        device=dev,
    )
    slo_fail = []
    if args.max_materialize_s:
        t_m = stats.get("time_to_materialized_0_9_s")
        # vacuous-pass rule: never crossing 0.9 is a failure, not a None
        if t_m is None or t_m > args.max_materialize_s:
            slo_fail.append("time_to_materialized")
    if args.min_writes_per_min and stats["write_points_per_min"] < args.min_writes_per_min:
        slo_fail.append("write_points_per_min")
    if args.max_p99_ms and stats["latency_ms"]["p99"] > args.max_p99_ms:
        slo_fail.append("p99")
    if args.max_scan_p50_ms:
        scan_samples = stats["served"]["scan"] + stats["served"]["materialized"]
        # zero real-scan samples would make the gate pass vacuously
        # (_percentile([]) is 0.0) — an unmeasured SLO is a failed SLO
        if scan_samples == 0 or stats["scan_p50_ms"] > args.max_scan_p50_ms:
            slo_fail.append("scan_p50")
    if stats["write_errors"] or stats["query_errors"]:
        slo_fail.append("errors")
    stats["slo_fail"] = slo_fail
    print(json.dumps(stats))
    if args.out:
        from pathlib import Path

        Path(args.out).write_text(json.dumps(stats, indent=1) + "\n")
    return 1 if slo_fail else 0


if __name__ == "__main__":
    sys.exit(main())
