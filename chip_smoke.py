#!/usr/bin/env python3
"""Smoke run of banyandb_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit (``nvcc``).  Phases, in order; any failure exits non-zero
before the last line is printed:

1. card: the card's name and power limit (``nvidia-smi``);
2. build: compile the Hopper kernels from ``banyandb_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version (and the
   group reduce against an f64 oracle) at the main path's shapes and at
   the edge cases, twice (same bits), with its time, the plain
   version's, one PyTorch library call's and the memory-bound floor;
   device times with the L2 flushed before each call by a read of 64 MB
   (``ms``) and warm (``warm_ms``); ``fused_group_multi`` on uniform codes and on rows
   stored by series (``sorted_ms``), the layout the main path feeds;
4. executor path: 4,194,304 points (1,024 services x 8 regions) written
   through the memtable and ``PartWriter`` into four parts, read back,
   and queried with ``execute_aggregate`` — count/sum/avg/min/max TopN
   and p50/p99 — fused, then staged (``BYDB_FUSED=0``, must be
   byte-identical), then on the CPU (must agree within the stated
   tolerances), and held against a numpy oracle;
5. decode path: the timestamp column of one 1,048,576-row part,
   encoded by ``utils/encoding`` (fixed-width deltas), rebased to the
   part's smallest timestamp and decoded on the card by
   ``ops.delta_decode`` (the prefix-sum kernel), against the host
   decode;
6. engine path: the same configuration written through
   ``MeasureEngine.write_columns`` (group ``sw``, ``shard_num=2``, four
   batches, a flush after each) and queried from BydbQL text through
   ``MeasureEngine.query`` on the card, against a ``device="cpu"``
   engine over the same parts and the numpy oracle;
7. determinism: the ``scatter`` (G = 16,384) and ``sort``
   (G = 100,000) group reduce of non-integer values, twice on the card
   (same bytes) and against the CPU;
8. stream path: 4,194,304 log elements (54 services, 1,080 instances,
   4 levels, a 16-byte id and a 64-byte body each, 1 ms apart) written
   through ``StreamEngine.write`` (group ``sw``, ``shard_num=2``, an
   inverted rule on ``level`` and a skipping rule on ``instance``, four
   batches, a flush after each: eight parts), then four BydbQL queries
   (eq, ne, in, not_in, each with a LIMIT) three times on the card and
   once on a ``device="cpu"`` engine over the same parts, against a
   numpy oracle; every source's tag mask must take the card;
9. host-only models: ``TraceEngine`` (by-id, ordered, one BydbQL scan)
   and ``PropertyEngine`` (apply, query, revisions) at a small size
   against plain Python;
10. cluster path: the measure configuration at 1,048,576 points written
   point by point through ``Liaison.write_measure`` into two
   ``DataNode``s on the card over ``LocalTransport`` (group ``sw``,
   ``shard_num=4``), then six BydbQL aggregates (TOP 10 by mean latency
   where region = 'r3', p50/p99 of latency, count/sum/min/max of calls,
   each by svc) through ``Liaison.query_measure`` three times on the
   mesh fast path over ``make_mesh(1, 1)`` (the card) and over
   ``make_mesh(4, 2)`` (8 slots on the card), and a ``region != 'r3'``
   query that must fall back to the scatter partials; each result
   against the host combine, the same mesh on CPU slots and a numpy
   oracle, ``executions`` once per mesh query;
11. cold start against warmed start: two fresh processes of this script
   (``--warm-child A|B``) share an empty build cache
   (``BYDB_COMPILE_CACHE_DIR``) and phase 6's data.  A reopens the
   engine, builds the kernel library (an ``nvcc`` miss), asks phase 6's
   two queries twice each and records their plan signatures into
   ``<root>/plan-registry.json`` (``attach_store``); B, started after A
   exits, loads the library (a hit), attaches the same store, runs
   ``warm()`` on the card and asks the queries once; a third, C, cold
   like A, asks the TOP 10 under ``torch.profiler`` (where a cold
   query's time goes).
   All answer with phase 6's values; the warm must launch
   ``fused_group_multi`` and ``widen_narrow`` with no error.  One
   ``{"warm": ...}`` line;
12. kernel audit on the card: every dispatch scenario of
   ``lint/kernel/dispatch.py`` on CUDA tensors under ``torch.profiler``,
   in a fresh process (``--audit-child``);
   its host->device ships, gets and hand-kernel launches must equal the
   budget table (``lint/kernel/kernel_budgets.py``); the profiler's
   kernel, copy and memset counts are recorded beside the table's op
   estimate.  One ``{"kernel_audit": [...]}`` line;
13. server path: ``StandaloneServer(root, device="cuda",
   slow_query_ms=0)`` with the precompile registry on, started (its warm
   joined before any query, 0 errors), driven over its in-process bus:
   phase 6's group and measure through the ``registry`` topic, phase 6's
   4,194,304 points in ``measure-write-cols`` envelopes of 65,536 points,
   ``snapshot``, phase 6's two BydbQL queries three times each through
   the ``bydbql`` topic (``fused_group_multi`` launched on each, every
   reply equal to phase 6's result and to numpy), one ``trace: true``
   reply, the percentile again through ``measure-query-raw``, one
   profiled query; then the ``metrics`` exposition (parsed by
   ``obs/prom``), the ``slowlog``, the ``_monitoring`` self-measures
   counted back by BydbQL on the card, the self-trace span rows of
   ``_monitoring.self_query``; a small stream, trace and property round
   through their topics against the engines' own answers; and a restart
   over the same root that must answer with the same bytes.  One
   ``{"server": ...}`` line;
14. worker path: ``StandaloneServer(root, device="cuda", workers=2,
   slow_query_ms=0)`` over a fresh root (two shard-worker processes,
   one shard each, every one a ``DataNode`` on the card that loads the
   kernel library the parent put in the fleet's build cache): phase
   13's schema, 4,194,304 points and ``snapshot``, its two BydbQL
   queries three times each (every reply equal to phase 13's and to
   numpy; each worker launches ``fused_group_multi``, read from
   ``pool.metrics_text()``, the parent none); then 65,536 more points,
   ``kill_worker(0)``: a query in the dead window is ``degraded`` and
   names the worker, and after the restart's journal replay the TOP 10
   over all 4,259,840 points equals numpy; ``stop()`` reaps both
   children.  One ``{"workers": ...}`` line;
15. rebalance path, on phase 10's cluster after its queries: a third
   ``DataNode`` on the card joins, ``Rebalancer.plan`` to three nodes
   and ``apply`` while a second thread writes 65,536 more points
   through ``Liaison.write_measure``; then phase 10's six queries
   through the host combine and the 1 x 1 mesh equal numpy over all
   1,114,112 points, the epoch is one higher and the new node answers a
   scatter leg.  One ``{"rebalance": ...}`` line;
16. lifecycle path: the measure configuration at 1,048,576 points over
   four day segments (262,144 a day, one ``write_columns`` batch and a
   flush a day: eight parts) in a server root on the card, then five
   steps, each asking its BydbQL (phase 6's TOP 10 and p50/p99,
   count/sum/min/max of calls by svc) with the serving caches emptied
   (they key a part by its path, and a restored segment comes back at
   the same one), against numpy: ``lifecycle.migrate`` archives the
   first two days (the answers then cover days 3-4) and
   ``restore_segment`` brings them back; ``migration`` analyzes,
   plans a rewrite of all eight parts, copies them into a fresh root
   and verifies it, and a fresh engine answers over it; ``backup`` to a
   local directory and ``restore`` into an empty root (and a refused
   restore into the live one), a fresh engine answering; a hot and a
   warm ``DataNode`` and a liaison (stages hot and warm): 262,144
   points over two days, ``TierMigrator`` ships day 1 to the warm node,
   the TOP 10 and count/sum by svc through ``Liaison.query_measure``
   with stages warm, hot and both, a second run ships nothing; and
   ``McpServer`` over the first root answers ``execute_bydbql`` of the
   TOP 10.  Every answer after a move is byte-identical to the one
   before it, and ``fused_group_multi`` launches in each step (on the
   warm node in the tier step).  One ``{"lifecycle": ...}`` line (each
   step's wall, bytes moved, launches, and the device busy and wall ms
   of one cold TOP 10 after each move);
17. wire path, in a child process (the smoke's own process never loads
   grpc or protobuf): 65,536 points through MeasureService/Write from
   a writer process, the TOP 10 and p50/p99 asked over BydbQLService,
   MeasureService/Query, the HTTP gateway and the bus with cold caches,
   each equal to the others and to numpy.  One ``{"wire": ...}`` line;
18. grpc cluster, in child processes: two ``python -m
   banyandb_tpu_torch.server --role data`` processes on the card (each
   loads the kernel library this process put in their build cache:
   0 builds) and a liaison process (``LiaisonServer``) whose
   ``Liaison.enable_write_queue`` takes phase 10's 1,048,576 points and
   ships sealed parts over streaming chunked sync; phase 10's asks and
   p50/p99 over region != r3, each with cold serving caches (the data
   processes hold none), equal numpy and phase 10's host combine; each
   data process launched ``fused_group_multi`` (its ``metrics`` topic,
   read before and after the asks).  One ``{"grpc_cluster": ...}``
   line (ingest rate, parts and bytes shipped, each ask's wall, each
   data process's launches, builds and loads);
19. lint and sanitizers, two fresh processes: (a) the static gate,
   ``python -m banyandb_tpu_torch.lint --check --format json
   banyandb_tpu_torch``, run with JAX made unimportable, must exit 0;
   its wall and the finding and suppression counts per rule are
   recorded; (b) a sanitized server (``--sanitize-child``, started with
   ``BYDB_SANITIZE=1``, ``sanitize.install()`` before the server is
   imported): phase 13's configuration uncut (4,194,304 points in 64
   ``measure-write-cols`` envelopes), phase 6's TOP 10 and p50/p99
   three times each while a second thread writes 65,536 points into a
   second measure of the same group; each ask equal to phase 13's and
   to numpy, the second measure's count 65,536, then ``stop()``: no
   runtime lock-order edge outside the declared graph, no leaked
   thread, fd or process, ``fused_group_multi`` launched.  One
   ``{"lint_sanitize": ...}`` line;
20. entry and dryrun: ``banyandb_tpu_torch.entry.entry("cuda")``'s
   step (the flagship plan signature, 8,192 rows, 64 groups) on the
   card against the same step on the CPU (counts, min/max and histogram
   equal; sums within rtol 1e-5), then ``dryrun_multichip(4)`` and
   ``(8)`` over 4 and 8 slots on the one card, each against the host
   union and through a liaison's mesh fast path.  One ``{"entry": ...}``
   line;
21. soak: ``harness.soak.run_soak`` for 50 s at its defaults (seed 0,
   400-point batches every 5 queries, flushes and merges) over three
   topologies on the card: a standalone engine, a two-node cluster and
   a 2 x 2 mesh of slots; 0 divergences and 0 errors, the mesh ran
   queries.  One ``{"soak": ...}`` line (queries, writes, launches by
   topology);
22. chaos: ``harness.chaos.run_smoke`` (seed 42) with data nodes and
   shard workers on the card: write-queue kill cycles, degradation
   markers, a seeded fault schedule, worker kill cycles and a rebalance
   under a kill; the reference's invariants (kill cycles >= 3, a
   degraded answer, faults injected, every query within 4.0 s, worker
   kill cycles >= 2 with degraded windows under 45 s, zero acked loss).
   One ``{"chaos": ...}`` line;
23. load: ``harness.load.run_load`` on the card for 45 s (2 writers at
   9,500 points/s in all, 4 queriers, batches of 500, a real gRPC
   socket); 0 write and query errors; the server reopened over its root
   counts every acked point back, from its materialized windows and
   from a rescan.  One ``{"load": ...}`` line (with ``cores`` and the
   served composition);
24. the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line and, last,
   ``{"ok": true, "device": {...}}``.

Every launch count is set to 0 just before a path (4, 5, 6, 8, 10, the
warm of 11, 12, the queries of 13, 15, each step of 16, the asks of 19,
20, 21, 22, 23) is driven and read just after it
(the workers of 14, the child of 17, the data processes of 18 and the
sanitized server of 19 count in their own processes: their counts are
read before and after the queries, and the difference is the path's;
the chaos harness's shard workers count in theirs, unread: its
measure's field is FLOAT, which reduces on the host);
each kernel of a path must have launched there (the stream path
launches none of the four kernels: its mask is PyTorch compares on the
card).  Phases 1-10 run with the precompile registry off
(``BYDB_PRECOMPILE=0``), so no background warm runs beside them; phase
11's children and phase 13's server turn it on.

The query's data: the BASELINE.json configuration "service_resp_time
avg+percentile, 1k series, groupBy service_id" — ``latency`` drawn from
gamma(2, 40) and an integer ``calls`` field, as bench.py's
``_host_data`` does.  Everything is made from a seed.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

N_POINTS = 4 << 20
N_PARTS = 4
N_SVC = 1024
N_REGION = 8
SEED = 3
T0 = 1_700_000_000_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
RTOL = 1e-5  # f32 sums of non-integer fields (tests/test_precision.py)
KERNEL_N = 1 << 20  # one scan chunk (measure_exec.SCAN_CHUNK)
KERNEL_G = N_SVC


# the kernels each path must launch (fused_group_sum is on none: tests only)
PATH_KERNELS = {
    "executor": ("fused_group_multi", "widen_narrow"),
    "decode": ("prefix_sum_narrow",),
    "engine": ("fused_group_multi",),
    "cluster": ("fused_group_multi",),
    "warm": ("fused_group_multi", "widen_narrow"),
    "audit": ("fused_group_multi", "widen_narrow"),
    "server": ("fused_group_multi",),
    "workers": ("fused_group_multi",),
    "rebalance": ("fused_group_multi",),
    "lifecycle": ("fused_group_multi",),
    "tier": ("fused_group_multi",),
    "wire": ("fused_group_multi",),
    "grpc_cluster": ("fused_group_multi",),
    "sanitize": ("fused_group_multi",),
    "entry": ("fused_group_multi",),
    "dryrun": ("fused_group_multi",),
    "soak": ("fused_group_multi",),
}


class Failed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 1: card -------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- phase 3: kernels against their plain versions -----------------------------


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


FLUSH_BYTES = 64 << 20  # > the 50 MB L2: one pass over it evicts the inputs
_flush = {}


def flush_l2() -> None:
    """Read a 64 MB buffer, so that the next call finds its inputs in
    device memory, as a query's first touch of a chunk does.  A read
    leaves clean lines: a write would leave dirty ones, whose write-back
    would land inside the next timed call."""
    import torch

    if "buf" not in _flush:
        _flush["buf"] = torch.ones(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    _flush["buf"].max()


def _flush_keys() -> set:
    """Profiler keys of what flush_l2 runs on the card (left out below)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if "keys" not in _flush:
        flush_l2()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flush_l2()
            torch.cuda.synchronize()
        _flush["keys"] = {
            e.key for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0.0) > 0
        }
    return _flush["keys"]


def device_profile(fn, iters: int, cold: bool = False) -> dict:
    """Device time per call of everything ``fn`` runs on the card, from
    torch.profiler: {"total": ms, "<kernel>": ms, ...}; with ``cold``,
    the L2 is flushed before each call, outside what is counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    skip = _flush_keys() if cold else set()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if cold:
                flush_l2()
            fn()
        torch.cuda.synchronize()
    out = {"total": 0.0}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us <= 0 or e.key in skip:
            continue
        out[e.key] = out.get(e.key, 0.0) + us / 1e3 / iters
        out["total"] += us / 1e3 / iters
    return out


def timed_row(fn, plain, library, iters: int, prefix: str = "") -> dict:
    """Per call, for the kernel, its plain version and the library call:
    device ms with a cold L2 (``ms``; what the bound is held against),
    device ms with a warm L2 (``warm_ms``), both from the profiler, and
    CUDA-event ms in a loop (``call_ms``: what a caller waits for, the
    Python wrapper included).  ``prefix`` names a second input layout."""
    row = {}
    for key, f, n in (("", fn, iters), ("plain_", plain, 3), ("library_", library, iters)):
        if f is None:
            continue
        k = prefix + key
        row[f"{k}call_ms"] = cuda_ms(f, n, 1 if key == "plain_" else 2)
        cold = device_profile(f, n, cold=True)
        warm = device_profile(f, n)
        row[f"{k}ms"] = cold["total"]
        row[f"{k}warm_ms"] = warm["total"]
        if key == "":
            row[f"{prefix}device_kernels"] = {
                name: (cold[name], warm.get(name)) for name in cold if name != "total"
            }
    return row


def group_inputs(n: int, f: int, g: int, integer: bool, seed: int,
                 layout: str = "uniform"):
    """Codes uniform over [-1, g] (-1 and g, the spill code, must count
    nowhere), or ``sorted``: rows stored by (series, ts) as parts keep
    them — 8 g series over g groups (series // 8, group codes permuted),
    runs of about N / 8 g rows; pred and valid drop rows at random at
    the same rates either way."""
    import torch

    rng = np.random.default_rng(seed)
    if layout == "sorted":
        series = np.sort(rng.integers(0, 8 * g, n))
        codes = rng.permutation(g).astype(np.int32)[series // 8]
    else:
        codes = rng.integers(-1, g + 1, n).astype(np.int32)
    pred = rng.random(n) < 0.9
    valid = rng.random(n) < 0.95
    if integer:
        vals = rng.integers(0, 100, (f, n)).astype(np.float32)
    else:
        vals = rng.gamma(2.0, 40.0, (f, n)).astype(np.float32)
    dev = torch.device("cuda")
    return (
        torch.from_numpy(codes).to(dev),
        torch.from_numpy(pred).to(dev),
        torch.from_numpy(vals).to(dev),
        torch.from_numpy(valid).to(dev),
    )


def compare_group(hk, n, f, g, integer, seed, layout="uniform") -> float:
    """Kernel vs plain (and a second kernel run: the same bits) on one
    input; counts against bincount and sums against an f64 oracle.
    -> max abs error of the sums against the plain version."""
    import torch

    codes, pred, vals, valid = group_inputs(n, f, g, integer, seed, layout)
    kc, ks = hk.fused_group_multi(codes, pred, vals, valid, num_groups=g)
    kc2, ks2 = hk.fused_group_multi(codes, pred, vals, valid, num_groups=g)
    pc, ps = hk.fused_group_multi_plain(codes, pred, vals, valid, g)
    torch.cuda.synchronize()
    what = f"fused_group_multi N={n} F={f} G={g} {layout} integer={integer}"
    check(torch.equal(kc, kc2) and torch.equal(ks, ks2), f"{what}: two runs differ")
    kc, ks, pc, ps = (t.cpu().numpy() for t in (kc, ks, pc, ps))
    check(kc.shape == (g,) and ks.shape == (f, g), f"{what}: shapes")
    check(np.array_equal(kc, pc), f"{what}: counts differ")
    if integer:
        check(np.array_equal(ks, ps), f"{what}: integer sums differ")
    else:
        check(
            np.allclose(ks, ps, rtol=RTOL, atol=0.0),
            f"{what}: sums beyond rtol={RTOL}",
        )
    # independent oracles: bincount for the counts, f64 sums
    c = codes.cpu().numpy()
    v = vals.cpu().numpy().astype(np.float64)
    m = pred.cpu().numpy() & valid.cpu().numpy() & (c >= 0) & (c < g)
    check(
        np.array_equal(kc, np.bincount(c[m], minlength=g)[:g].astype(np.float32)),
        f"{what}: counts differ from bincount",
    )
    oracle = np.zeros((f, g))
    for k in range(f):
        oracle[k] = np.bincount(c[m], weights=v[k][m], minlength=g)
    check(
        np.allclose(ks, oracle, rtol=RTOL, atol=0.0),
        f"{what}: sums beyond rtol={RTOL} of the f64 oracle",
    )
    err = float(np.max(np.abs(ks - ps))) if ks.size else 0.0
    log(f"  ok  {what}  max|kernel-plain| sums = {err!r}")
    return err


def kernel_phase(hk) -> dict:
    import torch

    rows = {}
    # edge cases
    compare_group(hk, 0, 2, 16, True, 1)
    compare_group(hk, 65536, 0, 64, True, 2)
    compare_group(hk, 65536, 2, 100, True, 3)  # G not a multiple of 128
    compare_group(hk, KERNEL_N, 1, 8192, True, 4)  # several group tiles
    compare_group(hk, KERNEL_N, 2, 8192, False, 5)
    # fewer tiles than row blocks, a tile count no block count divides,
    # F = 3 and F = 5 (two launches)
    compare_group(hk, 2048, 2, KERNEL_G, False, 12)
    compare_group(hk, 6144, 2, KERNEL_G, True, 13)
    compare_group(hk, 133 * 2048, 3, 300, False, 14)
    compare_group(hk, 65536, 5, 64, True, 15)
    try:
        codes, pred, vals, valid = group_inputs(2049, 1, 8, True, 6)
        hk.fused_group_multi(codes, pred, vals, valid, num_groups=8)
        raise Failed("fused_group_multi accepted a ragged N")
    except ValueError:
        log("  ok  fused_group_multi rejects ragged N=2049")
    # the main path's shapes: one 1M-row chunk, G=1024, F=1 (percentile
    # query) and F=2 (TopN query)
    compare_group(hk, KERNEL_N, 1, KERNEL_G, False, 7)
    compare_group(hk, KERNEL_N, 2, KERNEL_G, True, 8)
    err = compare_group(hk, KERNEL_N, 2, KERNEL_G, False, 9)
    # the layout the main path feeds: rows by series, runs of ~128
    compare_group(hk, KERNEL_N, 1, KERNEL_G, False, 16, "sorted")
    compare_group(hk, KERNEL_N, 2, KERNEL_G, True, 17, "sorted")
    err = max(err, compare_group(hk, KERNEL_N, 2, KERNEL_G, False, 18, "sorted"))

    codes, pred, vals, valid = group_inputs(KERNEL_N, 2, KERNEL_G, False, 9)
    g = KERNEL_G
    # library yardstick: one index_add_ of [count, fields] rows into
    # [1 + F, G + 1] slots, on inputs masked beforehand
    m = pred & valid & (codes >= 0) & (codes < g)
    slot = torch.where(m, codes, g).long()
    rows_in = torch.cat([m.float()[None], torch.where(m, vals, 0.0)])
    acc = torch.zeros((3, g + 1), device="cuda")
    n, f = KERNEL_N, 2
    moved = n * (4 + 1 + 1 + 4 * f) + (1 + f) * g * 4
    scodes, spred, svals, svalid = group_inputs(n, f, g, False, 18, "sorted")
    sm = spred & svalid
    sslot = torch.where(sm, scodes, g).long()
    srows = torch.cat([sm.float()[None], torch.where(sm, svals, 0.0)])
    rows["fused_group_multi"] = dict(
        name="fused_group_multi",
        route="cuda",
        source="banyandb_tpu_torch/csrc/fused_group.cu",
        replaces="banyandb_tpu/ops/pallas_kernels.py:111",
        max_abs_err=err,
        bound_ms=moved / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        shape=f"N={n} F={f} G={g}",
        **timed_row(
            lambda: hk.fused_group_multi(codes, pred, vals, valid, num_groups=g),
            lambda: hk.fused_group_multi_plain(codes, pred, vals, valid, g),
            lambda: acc.zero_().index_add_(1, slot, rows_in),
            50,
        ),
        **timed_row(
            lambda: hk.fused_group_multi(scodes, spred, svals, svalid, num_groups=g),
            None,
            lambda: acc.zero_().index_add_(1, sslot, srows),
            50,
            prefix="sorted_",
        ),
    )

    # fused_group_sum: the single-field wrapper, off the main path
    v1 = vals[0].contiguous()
    ksc, kss = hk.fused_group_sum(codes, pred, v1, valid, num_groups=g)
    psc, pss = hk.fused_group_multi_plain(codes, pred, v1[None], valid, g)
    check(torch.equal(ksc, psc), "fused_group_sum: counts differ")
    check(
        torch.allclose(kss, pss[0], rtol=RTOL, atol=0.0),
        f"fused_group_sum: sums beyond rtol={RTOL}",
    )
    rows["fused_group_sum"] = dict(
        name="fused_group_sum",
        route="cuda",
        source="banyandb_tpu_torch/csrc/fused_group.cu",
        replaces="banyandb_tpu/ops/pallas_kernels.py:260",
        max_abs_err=float((kss - pss[0]).abs().max()),
        bound_ms=(n * 10 + 2 * g * 4) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        shape=f"N={n} F=1 G={g}",
        **timed_row(
            lambda: hk.fused_group_sum(codes, pred, v1, valid, num_groups=g),
            lambda: hk.fused_group_multi_plain(codes, pred, v1[None], valid, g),
            lambda: acc[:2].zero_().index_add_(1, slot, rows_in[:2]),
            50,
        ),
    )

    rng = np.random.default_rng(10)
    for dt, lo, hi in ((np.int8, -128, 128), (np.int16, -32768, 32768)):
        for n in (2048, KERNEL_N, 4 * KERNEL_N):
            x = torch.from_numpy(rng.integers(lo, hi, n).astype(dt)).cuda()
            out = hk.widen_narrow(x)
            torch.cuda.synchronize()
            check(out.dtype == torch.int32, "widen_narrow: dtype")
            check(
                torch.equal(out, hk.widen_narrow_plain(x)),
                f"widen_narrow {dt.__name__} N={n}: differs from plain",
            )
            log(f"  ok  widen_narrow {dt.__name__} N={n} exact")
    try:
        hk.widen_narrow(torch.zeros(2049, dtype=torch.int8, device="cuda"))
        raise Failed("widen_narrow accepted a ragged N")
    except ValueError:
        log("  ok  widen_narrow rejects ragged N=2049")
    # main path shape: one 1M-row chunk of i16 dictionary codes (svc)
    x = torch.from_numpy(rng.integers(0, N_SVC, KERNEL_N).astype(np.int16)).cuda()
    rows["widen_narrow"] = dict(
        name="widen_narrow",
        route="cuda",
        source="banyandb_tpu_torch/csrc/widen.cu",
        replaces="banyandb_tpu/ops/pallas_kernels.py:197",
        max_abs_err=0.0,
        bound_ms=KERNEL_N * (2 + 4) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        shape=f"N={KERNEL_N} int16",
        **timed_row(
            lambda: hk.widen_narrow(x),
            lambda: hk.widen_narrow_plain(x),
            lambda: x.to(torch.int32),
            200,
        ),
    )
    rows["prefix_sum_narrow"] = prefix_sum_rows(hk)
    for r in rows.values():
        for lay in ("", "sorted_"):
            if f"{lay}ms" not in r:
                continue
            log(
                f"  {r['name']} [{r['shape']}{' ' + lay[:-1] if lay else ''}] "
                f"device ms per call, cold L2 / warm: kernel {r[lay + 'ms']!r} / "
                f"{r[lay + 'warm_ms']!r} {r[lay + 'device_kernels']}, plain "
                f"{r.get(lay + 'plain_ms')!r} / {r.get(lay + 'plain_warm_ms')!r}, "
                f"library {r[lay + 'library_ms']!r} / {r[lay + 'library_warm_ms']!r}, "
                f"bound {r['bound_ms']!r}; event ms per call: kernel "
                f"{r[lay + 'call_ms']!r}, plain {r.get(lay + 'plain_call_ms')!r}, "
                f"library {r[lay + 'library_call_ms']!r}"
            )
    return rows


def prefix_sum_rows(hk) -> dict:
    """prefix_sum_narrow against its plain version at the edge cases of
    the CPU tests and at the decode path's shape; -> its kernel row."""
    import torch

    rng = np.random.default_rng(11)
    t = hk.TILE
    cases = {
        "one tile": rng.integers(-1000, 1000, t),
        "int16 range": rng.integers(-32768, 32768, 2 * t),
        "full int32 range": rng.integers(-(2**31), 2**31, 3 * t, dtype=np.int64),
        "wraps past 2^31": np.full(4 * t, 2**20),
        "wraps below -2^31": np.full(t, -(2**22)),
        # 34 scan tiles of 4,096 rows (the last half full): not a multiple
        # of the 32-tile look-back window
        "odd window": rng.integers(-(2**31), 2**31, 67 * t, dtype=np.int64),
        "8,192 tiles": rng.integers(-4096, 4096, 1 << 24),
        "main path": rng.integers(-4096, 4096, KERNEL_N),
    }
    for what, x in cases.items():
        x = torch.from_numpy(x.astype(np.int32)).cuda()
        out = hk.prefix_sum_narrow(x)
        plain = hk.prefix_sum_narrow_plain(x)
        torch.cuda.synchronize()
        want = np.cumsum(x.cpu().numpy(), dtype=np.int32)
        check(out.dtype == torch.int32, "prefix_sum_narrow: dtype")
        check(
            torch.equal(out, plain) and np.array_equal(out.cpu().numpy(), want),
            f"prefix_sum_narrow {what} N={x.shape[0]}: differs from plain",
        )
        check(torch.equal(hk.prefix_sum_narrow(x), out),
              f"prefix_sum_narrow {what} N={x.shape[0]}: two runs differ")
        log(f"  ok  prefix_sum_narrow {what} N={x.shape[0]} exact, same bits twice")
    for bad in (torch.zeros(2049, dtype=torch.int32, device="cuda"),
                torch.zeros(2048, dtype=torch.int16, device="cuda")):
        try:
            hk.prefix_sum_narrow(bad)
            raise Failed(f"prefix_sum_narrow accepted {bad.dtype} N={bad.shape[0]}")
        except (ValueError, TypeError):
            log(f"  ok  prefix_sum_narrow rejects {bad.dtype} N={bad.shape[0]}")
    # timed at the main path's case (the loop leaves it in x, out and
    # plain): one 1,048,576-row part's deltas with `first` in front
    return dict(
        name="prefix_sum_narrow",
        route="cuda",
        source="banyandb_tpu_torch/csrc/prefix_sum.cu",
        replaces="banyandb_tpu/ops/pallas_kernels.py:233",
        max_abs_err=float((out.long() - plain.long()).abs().max()),
        bound_ms=KERNEL_N * (4 + 4) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes",
        shape=f"N={KERNEL_N} int32",
        **timed_row(
            lambda: hk.prefix_sum_narrow(x),
            lambda: hk.prefix_sum_narrow_plain(x),
            lambda: torch.cumsum(x, 0, dtype=torch.int32),
            200,
        ),
    )


# -- phase 4: the executor path ------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DictColumn:
    """A dictionary-encoded tag column (MemTable.append_bulk duck type)."""

    values: list
    codes: np.ndarray


def make_points(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    svc = rng.integers(0, N_SVC, n).astype(np.int32)
    region = rng.integers(0, N_REGION, n).astype(np.int32)
    return {
        "ts": T0 + np.arange(n, dtype=np.int64),
        "svc": svc,
        "region": region,
        # one series per (service, region)
        "series": (svc.astype(np.int64) * N_REGION + region),
        "latency": rng.gamma(2.0, 40.0, n),
        "calls": rng.integers(1, 100, n).astype(np.float64),
    }


def measure_schema():
    from banyandb_tpu_torch.api.schema import (
        Entity, FieldSpec, FieldType, Measure, TagSpec, TagType,
    )

    return Measure(
        group="sw_metric",
        name="service_resp_time",
        tags=(TagSpec("svc", TagType.STRING), TagSpec("region", TagType.STRING)),
        fields=(
            FieldSpec("latency", FieldType.FLOAT),
            FieldSpec("calls", FieldType.INT),
        ),
        entity=Entity(("svc", "region")),
    )


def write_parts(root: str, pts: dict, n_parts: int) -> list:
    """memtable -> flush -> PartWriter, one part per slice of points."""
    from banyandb_tpu_torch.storage.memtable import MemTable
    from banyandb_tpu_torch.storage.part import Part, PartWriter

    svc_vals = [b"svc-%04d" % i for i in range(N_SVC)]
    region_vals = [b"r%d" % i for i in range(N_REGION)]
    n = pts["ts"].shape[0]
    bounds = np.linspace(0, n, n_parts + 1).astype(np.int64)
    parts = []
    for k in range(n_parts):
        lo, hi = int(bounds[k]), int(bounds[k + 1])
        mem = MemTable(["svc", "region"], ["latency", "calls"])
        mem.append_bulk(
            pts["ts"][lo:hi],
            pts["series"][lo:hi],
            np.ones(hi - lo, dtype=np.int64),
            {
                "svc": DictColumn(svc_vals, pts["svc"][lo:hi]),
                "region": DictColumn(region_vals, pts["region"][lo:hi]),
            },
            {"latency": pts["latency"][lo:hi], "calls": pts["calls"][lo:hi]},
        )
        ((_suffix, cols, extra),) = mem.drain()
        d = os.path.join(root, f"part-{k:04d}")
        PartWriter.write(
            d,
            ts=cols.ts,
            series=cols.series,
            version=cols.version,
            tag_codes=dict(cols.tags),
            tag_dicts=dict(cols.dicts),
            fields=dict(cols.fields),
            extra_meta=extra,
        )
        parts.append(Part(d))
    return parts


def read_sources(parts: list) -> list:
    from banyandb_tpu_torch.storage import encoded

    narrow = encoded.device_decode_enabled()
    return [
        p.read(
            range(len(p.blocks)),
            tags=["svc", "region"],
            fields=["latency", "calls"],
            narrow_codes=narrow,
        )
        for p in parts
    ]


def requests(n: int) -> dict:
    from banyandb_tpu_torch.api.model import (
        Aggregation, Condition, GroupBy, QueryRequest, TimeRange, Top,
    )

    where = Condition("region", "ne", "r3")
    tr = TimeRange(T0, T0 + n)
    return {
        # count/sum/avg/min/max of every projected field, ranked TOP 10
        # by mean latency
        "topn": QueryRequest(
            ("sw_metric",), "service_resp_time", tr,
            criteria=where,
            group_by=GroupBy(("svc",)),
            field_projection=("latency", "calls"),
            top=Top(10, "latency"),
        ),
        "percentile": QueryRequest(
            ("sw_metric",), "service_resp_time", tr,
            criteria=where,
            group_by=GroupBy(("svc",)),
            agg=Aggregation("percentile", "latency", quantiles=(0.5, 0.99)),
            limit=N_SVC,
        ),
    }


def run_query(m, req, sources, device, fused: bool):
    """-> (Partials, QueryResult, wall ms, span tree)."""
    import torch

    from banyandb_tpu_torch.obs.tracer import Tracer
    from banyandb_tpu_torch.query import measure_exec as me

    os.environ["BYDB_FUSED"] = "1" if fused else "0"
    tr = Tracer("smoke")
    t0 = time.perf_counter()
    with tr.span("q") as sp:
        p = me.compute_partials(m, req, sources, span=sp, device=device)
        res = me.finalize_partials(m, req, [p], span=sp)
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    return p, res, wall_ms, tr.finish()


def find_span(tree: dict, name: str):
    if tree.get("name") == name:
        return tree
    for c in tree.get("children", ()):
        hit = find_span(c, name)
        if hit is not None:
            return hit
    return None


def breakdown(tree: dict) -> str:
    """Stage times of one query from its span tree."""
    red = find_span(tree, "reduce")
    t = red["tags"]
    return (
        f"gather {find_span(tree, 'gather')['duration_ms']!r} ms, reduce "
        f"{red['duration_ms']!r} ms (device boundary {t['device_ms']!r}, "
        f"host {t['host_ms']!r}, pad+ship {t['pad_ship_ms']!r}), merge "
        f"{find_span(tree, 'merge')['duration_ms']!r} ms"
    )


def query_profile(m, req, sources) -> None:
    """Device busy time and idle share over one fused query (profiler
    device time of every kernel and copy, against the host wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run_query(m, req, sources, "cuda", True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _p, _r, wall_ms, _t = run_query(m, req, sources, "cuda", True)
    busy = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0:
            busy[e.key] = us / 1e3
    total = sum(busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    log(
        f"  device busy {total!r} ms of {wall_ms!r} ms wall, idle share "
        f"{1 - total / wall_ms!r}; top: "
        + "; ".join(f"{k[:60]} {v!r}" for k, v in top)
    )


def same_result(a, b) -> bool:
    return (a.groups, a.values, a.rep_tags) == (b.groups, b.values, b.rep_tags)


def close_partials(a, b, exact_fields: set, what: str) -> None:
    """Counts, min/max, histograms and the representative key exact;
    sums exact for integer-valued fields and within RTOL otherwise."""
    check(np.array_equal(a.codes, b.codes), f"{what}: group codes differ")
    check(np.array_equal(a.count, b.count), f"{what}: counts differ")
    for f in a.sums:
        if f in exact_fields:
            check(np.array_equal(a.sums[f], b.sums[f]), f"{what}: sums[{f}] differ")
        else:
            check(
                np.allclose(a.sums[f], b.sums[f], rtol=RTOL, atol=0.0),
                f"{what}: sums[{f}] beyond rtol={RTOL}",
            )
    for d in ("mins", "maxs"):
        for f in getattr(a, d):
            check(
                np.array_equal(getattr(a, d)[f], getattr(b, d)[f]),
                f"{what}: {d}[{f}] differ",
            )
    check(
        (a.hist is None) == (b.hist is None)
        and (a.hist is None or np.array_equal(a.hist, b.hist)),
        f"{what}: histograms differ",
    )
    check(
        (a.rep_key is None) == (b.rep_key is None)
        and (a.rep_key is None or np.array_equal(a.rep_key, b.rep_key)),
        f"{what}: representative keys differ",
    )


def oracle_check(pts: dict, p, res, what: str) -> None:
    """Hold the card's partials against plain numpy over the points."""
    keep = pts["region"] != 3
    svc = pts["svc"][keep]
    count = np.bincount(svc, minlength=N_SVC).astype(np.float64)
    groups = np.nonzero(count)[0]
    # group codes follow first appearance in the dictionary, not svc id:
    # map them back through the group values
    gv = p.group_values["svc"]
    ids = np.asarray([int(gv[c][4:]) for c in p.codes[:, 0]])
    check(np.array_equal(np.sort(ids), groups), f"{what}: group set")
    check(np.array_equal(p.count, count[ids]), f"{what}: counts vs numpy")
    for f in p.sums:
        v = pts[f][keep]
        s = np.bincount(svc, weights=v, minlength=N_SVC)
        check(
            np.allclose(p.sums[f], s[ids], rtol=RTOL, atol=0.0),
            f"{what}: sums[{f}] vs numpy",
        )
        mn = np.full(N_SVC, np.inf)
        mx = np.full(N_SVC, -np.inf)
        v32 = v.astype(np.float32).astype(np.float64)
        np.minimum.at(mn, svc, v32)
        np.maximum.at(mx, svc, v32)
        if p.mins:
            check(np.array_equal(p.mins[f], mn[ids]), f"{what}: mins[{f}]")
            check(np.array_equal(p.maxs[f], mx[ids]), f"{what}: maxs[{f}]")
    if p.hist is not None:
        # each estimate lies in the bucket holding the rank-ceil(qN)
        # order statistic: within one bucket width of it
        width = p.hist_span / 512
        lat = pts["latency"][keep]
        order = np.lexsort((lat, svc))
        bounds = np.searchsorted(svc[order], np.arange(N_SVC + 1))
        lat_sorted = lat[order]
        est = res.values["percentile(latency)"]
        name_to_id = {g[0]: int(g[0][4:]) for g in res.groups}
        for row, grp in zip(est, res.groups):
            gid = name_to_id[grp[0]]
            vals = lat_sorted[bounds[gid]: bounds[gid + 1]]
            for q, e in zip((0.5, 0.99), row):
                k = max(int(np.ceil(q * len(vals))), 1) - 1
                # + 1e-4: the card buckets f32 values, the oracle
                # sorts f64 ones
                check(
                    abs(e - vals[k]) <= width + 1e-4,
                    f"{what}: p{q} of {grp[0]} = {e}, order statistic {vals[k]}",
                )
    log(f"  ok  {what}: agrees with the numpy oracle")


def main_path(hk, n_points: int, device: str, root: str) -> tuple:
    """Write, read and query; -> (kernel launch counts over the runs on
    `device`, the parts).  The CPU comparison runs come after the counts
    are read."""
    pts = make_points(n_points, SEED)
    m = measure_schema()
    t0 = time.perf_counter()
    parts = write_parts(root, pts, N_PARTS)
    t1 = time.perf_counter()
    sources = read_sources(parts)
    t2 = time.perf_counter()
    log(
        f"  wrote {n_points} points into {len(parts)} parts in "
        f"{(t1 - t0):.3f} s, read back in {(t2 - t1):.3f} s"
    )
    reqs = requests(n_points)
    card = {}
    hk.reset_launches()
    for name, req in reqs.items():
        fused = [run_query(m, req, sources, device, True) for _ in range(3)]
        staged = [run_query(m, req, sources, device, False) for _ in range(3)]
        for want, runs in (("fused", fused), ("staged", staged)):
            for _p, _res, _ms, tree in runs:
                took = find_span(tree, "reduce")["tags"]["path"]
                check(took == want, f"{name}: {want} run took {took}")
        ref = fused[0][0].content_bytes()
        for p, res, _ms, _t in fused + staged:
            check(p.content_bytes() == ref, f"{name}: fused/staged partials differ")
            check(same_result(res, fused[0][1]), f"{name}: fused/staged results differ")
        log(
            f"  ok  {name}: fused and staged byte-identical "
            f"({len(fused[0][0].count)} groups, "
            f"{find_span(fused[0][3], 'reduce')['tags']['chunks']} chunks)"
        )
        log(f"  {name} fused: {breakdown(fused[-1][3])}")
        log(f"  {name} staged: {breakdown(staged[-1][3])}")
        log(
            f"  {name} wall ms fused {[round(x[2], 3) for x in fused]}, "
            f"staged {[round(x[2], 3) for x in staged]}"
        )
        card[name] = fused[0]
    launches = dict(hk.LAUNCHES)
    log(f"  kernel launches over the card runs: {launches}")
    if device == "cuda":
        for name, req in reqs.items():
            log(f"  {name} profile:")
            query_profile(m, req, sources)

    for name, req in reqs.items():
        p, res, _ms, _t = card[name]
        cp, cres, cms, _ = run_query(m, req, sources, "cpu", True)
        close_partials(p, cp, {"calls"}, f"{name} card vs cpu")
        if name == "percentile":
            check(same_result(res, cres), f"{name}: card and cpu results differ")
        else:
            check(res.groups == cres.groups, f"{name}: TopN groups differ")
        log(f"  ok  {name}: card agrees with the CPU run ({cms:.1f} ms on CPU)")
        oracle_check(pts, p, res, name)
    return launches, parts


# -- phase 5: the decode path --------------------------------------------------


def decode_path(hk, part, device: str) -> dict:
    """One part's timestamp column through ``utils/encoding`` and
    ``ops.delta_decode`` on `device`; -> the launch counts of the path."""
    import torch

    from banyandb_tpu_torch import ops
    from banyandb_tpu_torch.utils import compress as zst
    from banyandb_tpu_torch.utils import encoding as enc

    ts = part.read(range(len(part.blocks)), tags=[], fields=[]).ts
    n = ts.shape[0]
    blob = enc.encode_int64(ts)
    check(blob[0] == 1, f"decode: the timestamp column took mode {blob[0]}, not delta")
    width = blob[1]
    first = int.from_bytes(blob[2:10], "little", signed=True)
    dt = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[width]
    deltas = np.frombuffer(zst.decompress(blob[10:]), dtype=dt)
    check(deltas.shape[0] == n - 1, "decode: delta count")
    check(width <= 4, f"decode: {width}-byte deltas do not fit the i32 width")
    epoch = int(ts.min())
    want = (enc.decode_int64(blob, n) - epoch).astype(np.int32)
    check(np.array_equal(want.astype(np.int64) + epoch, ts), "decode: host round trip")
    hk.reset_launches()
    t0 = time.perf_counter()
    got = ops.delta_decode(first - epoch, torch.from_numpy(deltas.copy()).to(device))
    got = got.cpu().numpy()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(hk.LAUNCHES)
    check(got.dtype == np.int32 and np.array_equal(got, want),
          "decode: card decode differs from the host decode")
    log(
        f"  ok  {n} timestamps ({width}-byte deltas) decoded on {device} equal "
        f"the host decode minus epoch {epoch} ({ms:.3f} ms with copies); "
        f"launches {launches}"
    )
    return launches


# -- phase 6: the engine path --------------------------------------------------

ENGINE_GROUP = "sw"


def engine_registry(root: str, shard_num: int = 2, stages: tuple = (),
                    schema_dir: str = "schema"):
    """Group ``sw`` (day segments, `stages`) and the measure, persisted
    under ``root/schema_dir`` (``""``: ``root`` itself, a server root's
    layout)."""
    from banyandb_tpu_torch.api import SchemaRegistry

    reg = SchemaRegistry(os.path.join(root, schema_dir))
    engine_schema(reg, shard_num, stages)
    return reg


def engine_schema(reg, shard_num: int = 2, stages: tuple = ()) -> None:
    """Create group ``sw`` (day segments, `stages`) and the measure in
    `reg` (a liaison's registry pushes them to its data nodes)."""
    from banyandb_tpu_torch.api import (
        Catalog, Entity, FieldSpec, FieldType, Group, Measure, ResourceOpts,
        TagSpec, TagType,
    )

    reg.create_group(
        Group(ENGINE_GROUP, Catalog.MEASURE,
              ResourceOpts(shard_num=shard_num, stages=stages))
    )
    reg.create_measure(
        Measure(
            group=ENGINE_GROUP,
            name="service_resp_time",
            tags=(TagSpec("svc", TagType.STRING), TagSpec("region", TagType.STRING)),
            fields=(
                FieldSpec("latency", FieldType.FLOAT),
                FieldSpec("calls", FieldType.INT),
            ),
            entity=Entity(("svc", "region")),
        )
    )


def engine_queries(n: int) -> dict:
    """BydbQL text of the executor path's two queries."""
    span = f"TIME BETWEEN {T0} AND {T0 + n - 1}"
    frm = f"FROM MEASURE service_resp_time IN {ENGINE_GROUP} {span}"
    where = "WHERE region != 'r3' GROUP BY svc"
    return {
        "topn": f"SELECT latency, calls {frm} {where} TOP 10 BY latency",
        "percentile": (
            f"SELECT percentile(latency, 0.5, 0.99) {frm} {where} LIMIT {N_SVC}"
        ),
    }


def engine_breakdown(tree: dict) -> str:
    """Stage times of one engine query from its span tree."""
    out = []
    for name in ("analyze", "planner", "part_gather", "execute", "gather", "reduce",
                 "merge"):
        sp = find_span(tree, name)
        if sp is not None:
            out.append(f"{name} {sp['duration_ms']!r}")
    red = find_span(tree, "reduce")
    cache = red["tags"].get("partials_cache") if red is not None else None
    return ", ".join(out) + f" ms (partials cache {cache})"


def same_values(a, b, exact: set, what: str) -> None:
    """Engine results: groups and their order equal; values equal except
    the sums and means of non-integer fields, within RTOL."""
    check(a.groups == b.groups, f"{what}: groups differ")
    check(a.rep_tags == b.rep_tags, f"{what}: representative tags differ")
    check(sorted(a.values) == sorted(b.values), f"{what}: value keys differ")
    for k, va in a.values.items():
        vb = b.values[k]
        if k.startswith(("sum", "mean")) and not any(f in k for f in exact):
            ok = np.allclose(np.asarray(va, float), np.asarray(vb, float),
                             rtol=RTOL, atol=0.0)
        else:
            ok = va == vb
        check(ok, f"{what}: {k} differs")


def write_batches(eng, pts: dict, per_batch: int) -> float:
    """write_columns + flush, one batch of `per_batch` points at a time;
    -> seconds."""
    from banyandb_tpu_torch.models.measure import DictColumn as EngineDict

    svc_vals = ["svc-%04d" % i for i in range(N_SVC)]
    region_vals = ["r%d" % i for i in range(N_REGION)]
    t0 = time.perf_counter()
    for lo in range(0, pts["ts"].shape[0], per_batch):
        hi = lo + per_batch
        eng.write_columns(
            ENGINE_GROUP, "service_resp_time",
            ts_millis=pts["ts"][lo:hi],
            tags={"svc": EngineDict(svc_vals, pts["svc"][lo:hi]),
                  "region": EngineDict(region_vals, pts["region"][lo:hi])},
            fields={"latency": pts["latency"][lo:hi], "calls": pts["calls"][lo:hi]},
            versions=np.ones(hi - lo, dtype=np.int64),
        )
        eng.flush()
    return time.perf_counter() - t0


def engine_path(hk, n_points: int, device: str, root: str) -> tuple:
    """Write through MeasureEngine.write_columns, query from BydbQL on
    `device`; -> (the launch counts of the path (the CPU engine's runs
    come after they are read), {query name: the card's first result})."""
    from banyandb_tpu_torch import bydbql
    from banyandb_tpu_torch.models.measure import MeasureEngine
    from banyandb_tpu_torch.obs.tracer import Tracer

    pts = make_points(n_points, SEED + 1)
    reg = engine_registry(root)
    eng = MeasureEngine(reg, os.path.join(root, "data"), device=device)
    write_s = write_batches(eng, pts, n_points // 4)
    log(f"  wrote {n_points} points in 4 batches of write_columns + flush in "
        f"{write_s:.3f} s")
    texts = engine_queries(n_points)
    reqs = {name: bydbql.parse(ql) for name, ql in texts.items()}
    card = {}
    hk.reset_launches()
    for name, req in reqs.items():
        runs = []
        for _ in range(3):
            tr = Tracer("engine")
            t1 = time.perf_counter()
            res = eng.query(req, tracer=tr)
            runs.append((res, (time.perf_counter() - t1) * 1e3, tr.finish()))
        for res, _ms, _t in runs[1:]:
            same_values(res, runs[0][0], {"calls"}, f"engine {name}: repeat run")
        log(f"  engine {name}: {texts[name]}")
        log(f"  engine {name} wall ms {[round(r[1], 3) for r in runs]}")
        log(f"  engine {name} breakdown (first, last): {engine_breakdown(runs[0][2])}; "
            f"{engine_breakdown(runs[-1][2])}")
        card[name] = runs[0][0]
    # the partials of each query, for the numpy oracle
    parts = {name: eng.query_partials(req) for name, req in reqs.items()}
    launches = dict(hk.LAUNCHES)
    log(f"  kernel launches over the engine's card runs: {launches}")
    eng.close()

    cpu = MeasureEngine(reg, os.path.join(root, "data"), device="cpu")
    try:
        for name, req in reqs.items():
            t1 = time.perf_counter()
            cres = cpu.query(req)
            cms = (time.perf_counter() - t1) * 1e3
            same_values(card[name], cres, {"calls"}, f"engine {name} card vs cpu")
            log(f"  ok  engine {name}: card agrees with a device='cpu' engine "
                f"({cms:.1f} ms on CPU)")
            oracle_check(pts, parts[name], card[name], f"engine {name}")
    finally:
        cpu.close()
    top = card["topn"]
    keep = pts["region"] != 3
    mean = (np.bincount(pts["svc"][keep], weights=pts["latency"][keep], minlength=N_SVC)
            / np.bincount(pts["svc"][keep], minlength=N_SVC))
    want = ["svc-%04d" % i for i in np.argsort(-mean, kind="stable")[:10]]
    check([g[0] for g in top.groups] == want, "engine topn: TOP 10 differs from numpy")
    log("  ok  engine topn: TOP 10 by mean latency agrees with numpy")
    return launches, card


# -- phase 7: determinism of scatter and sort ----------------------------------


def determinism_phase() -> None:
    import torch

    from banyandb_tpu_torch import ops

    rng = np.random.default_rng(17)
    n = KERNEL_N
    for method, g in (("scatter", 16384), ("sort", 100000)):
        key = rng.integers(0, g, n).astype(np.int32)
        valid = rng.random(n) < 0.9
        vals = rng.gamma(2.0, 40.0, n).astype(np.float32)
        args = (torch.from_numpy(key), torch.from_numpy(valid))
        dev_args = [a.cuda() for a in args]
        v = torch.from_numpy(vals)
        runs = [
            ops.group_reduce(*dev_args, {"v": v.cuda()}, g, method=method)
            for _ in range(2)
        ]
        torch.cuda.synchronize()
        b = [(r.count.cpu().numpy(), r.sums["v"].cpu().numpy()) for r in runs]
        check(
            b[0][0].tobytes() == b[1][0].tobytes()
            and b[0][1].tobytes() == b[1][1].tobytes(),
            f"{method} G={g}: two card runs differ",
        )
        cpu = ops.group_reduce(*args, {"v": v}, g, method=method)
        cs = cpu.sums["v"].numpy()
        check(np.array_equal(cpu.count.numpy(), b[0][0]), f"{method} G={g}: counts vs cpu")
        check(np.allclose(b[0][1], cs, rtol=RTOL, atol=0.0),
              f"{method} G={g}: sums beyond rtol={RTOL} of the cpu")
        diff = np.abs(b[0][1].astype(np.float64) - cs)
        log(
            f"  ok  {method} N={n} G={g}: two card runs byte-identical; card vs "
            f"cpu sums: max abs diff {float(diff.max())!r}, "
            f"{int((diff > 0).sum())} of {g} groups differ, "
            f"bit-identical {bool(np.array_equal(b[0][1], cs))}"
        )


# -- phase 8: the stream path --------------------------------------------------

STREAM_N = 4 << 20
STREAM_BATCHES = 4
N_INST_PER_SVC = 20  # 54 services x 20 = 1,080 instances
N_STREAM_SVC = 54
LEVELS = ("INFO", "WARN", "ERROR", "DEBUG")
LEVEL_P = (0.70, 0.20, 0.08, 0.02)


def stream_registry(root: str):
    from banyandb_tpu_torch.api import (
        Catalog, Group, IndexRule, ResourceOpts, SchemaRegistry, Stream, TagSpec,
        TagType,
    )

    reg = SchemaRegistry(os.path.join(root, "schema"))
    reg.create_group(Group(ENGINE_GROUP, Catalog.STREAM, ResourceOpts(shard_num=2)))
    reg.create_stream(
        Stream(
            group=ENGINE_GROUP,
            name="log",
            tags=(
                TagSpec("svc", TagType.STRING),
                TagSpec("instance", TagType.STRING),
                TagSpec("level", TagType.STRING),
            ),
            entity=("svc", "instance"),
        )
    )
    reg.create_index_rule(
        IndexRule(group=ENGINE_GROUP, name="level_idx", tags=("level",), type="inverted")
    )
    reg.create_index_rule(
        IndexRule(group=ENGINE_GROUP, name="instance_skip", tags=("instance",),
                  type="skipping")
    )
    return reg


def svc_name(i: int) -> str:
    return "service-%02d" % i


def inst_name(j: int) -> str:
    return "instance-%02d-%02d" % (j // N_INST_PER_SVC, j % N_INST_PER_SVC)


def make_elements(n: int, seed: int) -> dict:
    """Log elements 1 ms apart: an instance drawn uniformly (its service
    follows), a level drawn INFO 70 %, WARN 20 %, ERROR 8 %, DEBUG 2 %,
    a 16-byte element id and a 64-byte body of letters."""
    rng = np.random.default_rng(seed)
    inst = rng.integers(0, N_STREAM_SVC * N_INST_PER_SVC, n).astype(np.int32)
    return {
        "ts": T0 + np.arange(n, dtype=np.int64),
        "inst": inst,
        "svc": inst // N_INST_PER_SVC,
        "level": rng.choice(len(LEVELS), n, p=LEVEL_P).astype(np.int32),
        "body": rng.integers(97, 123, (n, 64), dtype=np.uint8),
    }


def element_values(els: dict, lo: int, hi: int) -> list:
    from banyandb_tpu_torch.models.stream import ElementValue

    svc = [svc_name(i) for i in range(N_STREAM_SVC)]
    inst = [inst_name(j) for j in range(N_STREAM_SVC * N_INST_PER_SVC)]
    body = els["body"][lo:hi].tobytes()
    return [
        ElementValue(
            element_id="%016x" % i,
            ts_millis=int(els["ts"][i]),
            tags={"svc": svc[els["svc"][i]], "instance": inst[els["inst"][i]],
                  "level": LEVELS[els["level"][i]]},
            body=body[(i - lo) * 64: (i - lo + 1) * 64],
        )
        for i in range(lo, hi)
    ]


def stream_queries(n: int) -> dict:
    """BydbQL text of the four queries (eq, ne, in, not_in), each chosen
    to match fewer than about 20,000 of the elements before its LIMIT;
    -> {name: (text, numpy predicate over the elements)}."""
    frm = f"FROM STREAM log IN {ENGINE_GROUP} TIME BETWEEN {T0} AND {T0 + n - 1}"
    sel = f"SELECT svc, instance, level {frm}"
    insts3 = [3 * N_INST_PER_SVC + k for k in range(N_INST_PER_SVC)]
    lv = {v: i for i, v in enumerate(LEVELS)}

    def quoted(names):
        return ", ".join(f"'{x}'" for x in names)

    return {
        "eq": (
            f"{sel} WHERE svc = '{svc_name(7)}' AND level = 'ERROR' LIMIT 100",
            lambda e: (e["svc"] == 7) & (e["level"] == lv["ERROR"]),
        ),
        "ne": (
            f"{sel} WHERE svc = '{svc_name(11)}' AND instance != '{inst_name(220)}' "
            "AND level != 'INFO' AND level != 'WARN' LIMIT 100",
            lambda e: (e["svc"] == 11) & (e["inst"] != 220)
            & (e["level"] != lv["INFO"]) & (e["level"] != lv["WARN"]),
        ),
        "in": (
            f"{sel} WHERE instance IN ({quoted(inst_name(j) for j in insts3)}) "
            "AND level IN ('ERROR', 'DEBUG') LIMIT 1000",
            lambda e: np.isin(e["inst"], insts3)
            & np.isin(e["level"], [lv["ERROR"], lv["DEBUG"]]),
        ),
        "not_in": (
            f"{sel} WHERE svc = '{svc_name(20)}' AND instance NOT IN "
            f"('{inst_name(400)}', '{inst_name(401)}') "
            "AND level NOT IN ('INFO', 'WARN') LIMIT 1000",
            lambda e: (e["svc"] == 20) & ~np.isin(e["inst"], [400, 401])
            & ~np.isin(e["level"], [lv["INFO"], lv["WARN"]]),
        ),
    }


def stream_rows(res) -> list:
    return [
        (dp["element_id"], dp["timestamp"], tuple(sorted(dp["tags"].items())),
         bytes(dp["body"]))
        for dp in res.data_points
    ]


def stream_oracle(els: dict, pred, req) -> tuple:
    """-> (rows the query must return, elements that match before the
    limit), by plain numpy over the written elements: newest first."""
    tr = req.time_range
    m = pred(els) & (els["ts"] >= tr.begin_millis) & (els["ts"] < tr.end_millis)
    idx = np.nonzero(m)[0][::-1][req.offset or 0:][: req.limit]
    rows = [
        ("%016x" % i, int(els["ts"][i]),
         tuple(sorted({"svc": svc_name(els["svc"][i]),
                       "instance": inst_name(els["inst"][i]),
                       "level": LEVELS[els["level"][i]]}.items())),
         els["body"][i].tobytes())
        for i in idx
    ]
    return rows, int(m.sum())


def stream_query_profile(eng, req) -> str:
    """Device time of one card query from torch.profiler: everything on
    the card, the host-to-device copies, and the rest (the mask's
    compares, reductions and the one mask copy back); the idle share
    against the host wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.query(req)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = h2d = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us <= 0:
            continue
        busy += us / 1e3
        if "HtoD" in e.key:
            h2d += us / 1e3
    return (
        f"device busy {busy!r} ms (H2D copies {h2d!r}, mask compute and D2H "
        f"{busy - h2d!r}) of {wall!r} ms wall, idle share {1 - busy / wall!r}"
    )


def stream_path(hk, n: int, device: str, root: str) -> dict:
    """Write log elements through StreamEngine.write (four batches, a
    flush after each), ask the four BydbQL queries three times on
    `device` and once on a device="cpu" engine over the same parts, hold
    both against the numpy oracle; -> the kernel launch counts of the
    card runs (none of the four kernels is on this path)."""
    from banyandb_tpu_torch import bydbql
    from banyandb_tpu_torch.models.stream import StreamEngine
    from banyandb_tpu_torch.obs.tracer import Tracer
    from banyandb_tpu_torch.query import stream_exec

    els = make_elements(n, SEED + 2)
    reg = stream_registry(root)
    eng = StreamEngine(reg, os.path.join(root, "data"), device=device)
    bounds = np.linspace(0, n, STREAM_BATCHES + 1).astype(np.int64)
    make_s = write_s = 0.0
    flush_s = []
    for k in range(STREAM_BATCHES):
        t0 = time.perf_counter()
        batch = element_values(els, int(bounds[k]), int(bounds[k + 1]))
        t1 = time.perf_counter()
        eng.write(ENGINE_GROUP, "log", batch)
        t2 = time.perf_counter()
        eng.flush()
        flush_s.append(time.perf_counter() - t2)
        make_s += t1 - t0
        write_s += t2 - t1
        del batch
    db = eng._tsdb(ENGINE_GROUP)
    parts = [p for seg in db.segments for sh in seg.shards for p in sh.parts]
    check(len(parts) == 2 * STREAM_BATCHES, f"stream: {len(parts)} parts")
    small = [p.total_count for p in parts if p.total_count < stream_exec.DEVICE_MIN_ROWS]
    check(not small, f"stream: parts below DEVICE_MIN_ROWS: {small}")
    for p in parts:
        check((p.dir / "eidx_level.bin").exists() and (p.dir / "tff_instance.bin").exists(),
              f"stream: index sidecars missing in {p.dir.name}")
    log(
        f"  wrote {n} elements in {STREAM_BATCHES} batches through StreamEngine.write: "
        f"{write_s!r} s ({n / write_s!r} elements/s; ElementValue construction "
        f"{make_s!r} s apart), flush s {flush_s!r}; {len(parts)} parts of rows "
        f"{sorted(p.total_count for p in parts)} with eidx_level/tff_instance sidecars"
    )
    queries = stream_queries(n)
    reqs = {name: bydbql.parse(ql) for name, (ql, _pred) in queries.items()}
    card = {}
    hk.reset_launches()
    stream_exec.reset_stats()
    for name, req in reqs.items():
        before = dict(stream_exec.STATS)
        runs = []
        for _ in range(3):
            tr = Tracer("stream")
            t1 = time.perf_counter()
            res = eng.query(req, tracer=tr)
            runs.append((stream_rows(res), (time.perf_counter() - t1) * 1e3, tr.finish()))
        stats = dict(eng.last_scan_stats)
        masks = {k: stream_exec.STATS[k] - before[k] for k in before}
        for rows, _ms, _t in runs[1:]:
            check(rows == runs[0][0], f"stream {name}: repeat run differs")
        # one device mask per source (a part with blocks to read) per run
        check(masks["host_masks"] == 0 and masks["device_masks"] == 3 * len(parts),
              f"stream {name}: mask routes {masks}")
        scan = find_span(runs[-1][2], "scan")
        log(f"  stream {name}: {queries[name][0]}")
        log(
            f"  stream {name} wall ms {[r[1] for r in runs]!r}; scan span ms "
            f"{[find_span(r[2], 'scan')['duration_ms'] for r in runs]!r} "
            f"({scan['tags'].get('rows')} rows decoded); device masks per query "
            f"{masks['device_masks'] // 3} (one per source), H2D bytes per query "
            f"{masks['h2d_bytes'] // 3}; scan stats {stats}"
        )
        card[name] = (runs[0][0], stats)
    launches = dict(hk.LAUNCHES)
    log(f"  kernel launches over the stream card runs: {launches}; masks {stream_exec.STATS}")
    if device == "cuda":
        for name, req in reqs.items():
            log(f"  stream {name} profile: {stream_query_profile(eng, req)}")
    eng.close()

    cpu = StreamEngine(reg, os.path.join(root, "data"), device="cpu")
    try:
        for name, req in reqs.items():
            t1 = time.perf_counter()
            crows = stream_rows(cpu.query(req))
            cms = (time.perf_counter() - t1) * 1e3
            rows, stats = card[name]
            check(crows == rows, f"stream {name}: card and cpu rows differ")
            check(cpu.last_scan_stats == stats,
                  f"stream {name}: scan stats differ {cpu.last_scan_stats} vs {stats}")
            want, matched = stream_oracle(els, queries[name][1], req)
            check(rows == want, f"stream {name}: rows differ from the numpy oracle")
            check(0 < len(rows) <= matched <= 20_000,
                  f"stream {name}: {matched} matches before the limit")
            log(
                f"  ok  stream {name}: {len(rows)} rows (of {matched} matching) equal "
                f"on the card, a device='cpu' engine ({cms:.1f} ms) and numpy; "
                f"scan stats equal"
            )
    finally:
        cpu.close()
    return launches


# -- phase 9: the host-only models ---------------------------------------------


def host_models_phase(root: str) -> None:
    """TraceEngine (by-id, ordered, one BydbQL scan) and PropertyEngine
    (apply, query, revisions) at a small size against plain Python."""
    from banyandb_tpu_torch import bydbql
    from banyandb_tpu_torch.api import (
        Catalog, Group, ResourceOpts, SchemaRegistry, TagSpec, TagType, TimeRange,
    )
    from banyandb_tpu_torch.api.schema import Trace
    from banyandb_tpu_torch.models.property import Property, PropertyEngine
    from banyandb_tpu_torch.models.trace import SpanValue, TraceEngine
    from banyandb_tpu_torch.query import ql_exec

    reg = SchemaRegistry(os.path.join(root, "schema"))
    reg.create_group(Group("tg", Catalog.TRACE, ResourceOpts(shard_num=2)))
    reg.create_group(Group("pg", Catalog.PROPERTY, ResourceOpts(shard_num=2)))
    eng = TraceEngine(reg, os.path.join(root, "data"))
    eng.create_trace(Trace(
        group="tg", name="spans",
        tags=(TagSpec("trace_id", TagType.STRING), TagSpec("svc", TagType.STRING),
              TagSpec("duration", TagType.INT)),
        trace_id_tag="trace_id",
    ))
    rows = [
        (T0 + t * 10 + s, {"trace_id": f"t{t}", "svc": f"s{t % 5}",
                           "duration": t * 100 + s * 7}, f"sp-{t}-{s}".encode())
        for t in range(200) for s in range(3)
    ]
    for lo in (0, 300):  # two flushes: two parts a shard
        eng.write("tg", "spans", [SpanValue(*r) for r in rows[lo:lo + 300]],
                  ordered_tags=("duration",))
        eng.flush()
    try:
        got = eng.query_by_trace_id("tg", "spans", "t17")
        want = [(ts, p) for ts, tg, p in rows if tg["trace_id"] == "t17"]
        check([(s["timestamp"], bytes(s["span"])) for s in got] == want,
              "trace: by-id differs from the oracle")
        tr = TimeRange(T0, T0 + 2000 + 10)
        got = eng.query_ordered("tg", "spans", "duration", tr, limit=5)
        check(got == [f"t{199 - i}" for i in range(5)], f"trace: ordered {got}")
        ql = ("SELECT * FROM TRACE spans IN tg WHERE svc = 's3' AND duration >= 5000 "
              "LIMIT 1000")
        _cat, req = bydbql.parse_with_catalog(ql)
        res = ql_exec.execute_trace_ql(eng, req)
        want = sorted((ts, p) for ts, tg, p in rows
                      if tg["svc"] == "s3" and tg["duration"] >= 5000)
        check([(d["timestamp"], bytes(d["span"])) for d in res.data_points] == want,
              "trace: BydbQL scan differs from the oracle")
        log(f"  ok  trace: by-id, ordered and a BydbQL scan ({len(want)} spans) equal "
            "plain Python")
    finally:
        eng.close()
    peng = PropertyEngine(reg, os.path.join(root, "data"))
    try:
        first = [peng.apply(Property("pg", "node", f"n{i}", {"role": ("data", "liaison")[i % 2]}))
                 for i in range(50)]
        upd = peng.apply(Property("pg", "node", "n3", {"zone": "z1"}))
        check(upd.tags == {"role": "liaison", "zone": "z1"}, "property: merge apply")
        check(upd.create_revision == first[3].create_revision
              and upd.mod_revision > first[-1].mod_revision, "property: revisions")
        data = sorted(p.id for p in peng.query("pg", "node", tag_filters={"role": "data"}))
        check(data == sorted(f"n{i}" for i in range(50) if i % 2 == 0),
              "property: tag query differs from the oracle")
        check(peng.revision >= upd.mod_revision, "property: engine revision")
        log("  ok  property: apply, merge, revisions and a tag query equal plain Python")
    finally:
        peng.close()

# -- phase 10: the cluster path ------------------------------------------------

# Cut from the 4,194,304 points of phases 4 and 6: every point crosses
# the liaison one by one (DataPointValue, shard routing, the JSON-able
# envelope, the data node's per-point write), so the full size would
# take the phase past two minutes; 1,048,576 points are still two
# 65,536-row chunks on each of the 8 slots (PERF.md section 4)
CLUSTER_N = 1 << 20
CLUSTER_BATCH = 1 << 16


def cluster_queries(n: int) -> dict:
    """name -> (BydbQL text, whether the mesh takes it)."""
    span = f"TIME BETWEEN {T0} AND {T0 + n - 1}"
    frm = f"FROM MEASURE service_resp_time IN {ENGINE_GROUP} {span}"
    by = f"GROUP BY svc LIMIT {N_SVC}"
    out = {
        "topn": (f"SELECT mean(latency) {frm} WHERE region = 'r3' GROUP BY svc "
                 "TOP 10 BY latency", True),
        "percentile": (f"SELECT percentile(latency, 0.5, 0.99) {frm} {by}", True),
    }
    for fn in ("count", "sum", "min", "max"):
        out[fn] = (f"SELECT {fn}(calls) {frm} {by}", True)
    # ne is not mesh-lowered: the scatter partials answer it
    out["fallback_ne"] = (
        f"SELECT mean(latency) {frm} WHERE region != 'r3' GROUP BY svc "
        "TOP 10 BY latency", False)
    return out


def cluster_same(a, b, what: str, host: bool = False) -> None:
    """Two cluster results: the same groups with the same values.  Sums
    and means of latency within RTOL; against the host combine (`host`)
    the mesh's extremes are the host's rounded to f32 and its
    percentiles, over the f32 range, within RTOL; everything else
    exact."""
    check(sorted(a.groups) == sorted(b.groups), f"{what}: groups differ")
    check(sorted(a.values) == sorted(b.values), f"{what}: value keys differ")
    for key in b.values:
        got = dict(zip(a.groups, a.values[key]))
        want = dict(zip(b.groups, b.values[key]))
        if key.startswith(("min", "max")) and host:
            ok = got == {g: float(np.float32(w)) for g, w in want.items()}
        elif "latency" in key and (host or not key.startswith("percentile")):
            ok = all(np.allclose(got[g], want[g], rtol=RTOL, atol=0.0) for g in want)
        else:
            ok = got == want
        check(ok, f"{what}: {key} differs")


def cluster_oracle(pts: dict, name: str, res, keep=None, what: str = "cluster") -> None:
    """One query's result against plain numpy over the points (`keep`,
    a row mask, overrides the query's own predicate)."""
    if keep is None:
        keep = {"topn": pts["region"] == 3,
                "fallback_ne": pts["region"] != 3}.get(name, slice(None))
    svc = pts["svc"][keep]
    count = np.bincount(svc, minlength=N_SVC).astype(np.float64)
    ids = [int(g[0][4:]) for g in res.groups]
    if name in ("topn", "fallback_ne"):
        mean = np.bincount(svc, weights=pts["latency"][keep], minlength=N_SVC)
        mean = np.where(count > 0, mean / np.maximum(count, 1), -np.inf)
        check(ids == list(np.argsort(-mean, kind="stable")[:10]),
              f"{what} {name}: TOP 10 differs from numpy")
        check(res.values["count"] == list(count[ids]), f"{what} {name}: counts vs numpy")
        # a TOP 10 that selects no aggregate returns counts alone: its
        # sums are held through the card's partials (oracle_check)
        if "mean(latency)" in res.values:
            check(np.allclose(res.values["mean(latency)"], mean[ids], rtol=RTOL, atol=0.0),
                  f"{what} {name}: means vs numpy")
        return
    check(sorted(ids) == list(np.nonzero(count)[0]), f"{what} {name}: group set")
    check(res.values["count"] == list(count[ids]), f"{what} {name}: counts vs numpy")
    calls = pts["calls"][keep]
    if name == "percentile":
        lat = pts["latency"][keep]
        lat32 = lat.astype(np.float32)
        width = (float(lat32.max()) - float(lat32.min())) / 512
        order = np.lexsort((lat, svc))
        bounds = np.searchsorted(svc[order], np.arange(N_SVC + 1))
        lat_sorted = lat[order]
        for gid, row in zip(ids, res.values["percentile(latency)"]):
            vals = lat_sorted[bounds[gid]: bounds[gid + 1]]
            for q, e in zip((0.5, 0.99), row):
                k = max(int(np.ceil(q * len(vals))), 1) - 1
                check(abs(e - vals[k]) <= width + 1e-4,
                      f"{what} percentile: p{q} of svc {gid} = {e}, order "
                      f"statistic {vals[k]}")
        return
    if name == "count":
        want = count
    elif name == "sum":
        want = np.bincount(svc, weights=calls, minlength=N_SVC)
    else:
        want = np.full(N_SVC, np.inf if name == "min" else -np.inf)
        (np.minimum if name == "min" else np.maximum).at(want, svc, calls)
    check(res.values[f"{name}(calls)"] == list(want[ids]),
          f"{what} {name}: {name}(calls) vs numpy")


def device_split(fn) -> tuple:
    """Run fn once under torch.profiler: -> (device busy ms, of which
    host-to-device copies, host wall ms, the five busiest keys)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = h2d = 0.0
    keys = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0:
            busy += us / 1e3
            keys.append((us / 1e3, e.key[:60]))
            if "HtoD" in e.key:
                h2d += us / 1e3
    return busy, h2d, wall, sorted(keys, reverse=True)[:5]


def close_nodes(nodes) -> None:
    for dn in nodes:
        dn.measure.close()
        dn.stream.close()
        dn.trace.close()


def measure_batch(pts: dict, lo: int, hi: int) -> tuple:
    """Points [lo, hi) as the DataPointValues Liaison.write_measure takes."""
    from banyandb_tpu_torch.api import DataPointValue

    svc_vals = ["svc-%04d" % i for i in range(N_SVC)]
    region_vals = ["r%d" % i for i in range(N_REGION)]
    ts, sv, rg = (pts[k][lo:hi].tolist() for k in ("ts", "svc", "region"))
    lat, calls = pts["latency"][lo:hi].tolist(), pts["calls"][lo:hi].tolist()
    return tuple(
        DataPointValue(ts[k], {"svc": svc_vals[sv[k]], "region": region_vals[rg[k]]},
                       {"latency": lat[k], "calls": int(calls[k])}, version=1)
        for k in range(hi - lo)
    )


def cluster_path(hk, n_points: int, device: str, root: str) -> tuple:
    """Two data nodes on `device` and a liaison over LocalTransport:
    per-point writes through ``Liaison.write_measure``, then each BydbQL
    query through ``Liaison.query_measure`` three times on the one-slot
    mesh of the card and on a 4 x 2 mesh of 8 slots on it, and once
    through the host combine of the scatter partials; -> (the launch
    counts of those runs, the cluster: its liaison, transport, data
    nodes (left open for phase 15; close_nodes closes them) and points).
    Afterwards (not counted): a profiled run for the idle share, the
    same 4 x 2 mesh on CPU slots over the same data nodes, and the numpy
    oracle."""
    import torch

    from banyandb_tpu_torch import bydbql
    from banyandb_tpu_torch.api import WriteRequest
    from banyandb_tpu_torch.cluster import DataNode, Liaison, NodeInfo
    from banyandb_tpu_torch.cluster.rpc import LocalTransport
    from banyandb_tpu_torch.obs.tracer import Tracer
    from banyandb_tpu_torch.parallel import make_mesh

    pts = make_points(n_points, SEED + 2)
    transport, infos, nodes = LocalTransport(), [], []
    for i in range(3):  # two data nodes, then the liaison's registry
        reg = engine_registry(os.path.join(root, f"n{i}"), shard_num=4)
        if i < 2:
            dn = DataNode(f"data-{i}", reg, os.path.join(root, f"n{i}", "data"),
                          device=device)
            nodes.append(dn)
            infos.append(NodeInfo(dn.name, transport.register(dn.name, dn.bus)))
    liaison = Liaison(reg, transport, infos)
    build_s = write_s = 0.0
    for lo in range(0, n_points, CLUSTER_BATCH):
        hi = min(n_points, lo + CLUSTER_BATCH)
        t0 = time.perf_counter()
        batch = measure_batch(pts, lo, hi)
        t1 = time.perf_counter()
        check(liaison.write_measure(WriteRequest(ENGINE_GROUP, "service_resp_time", batch))
              == hi - lo, "cluster: write not accepted")
        write_s += time.perf_counter() - t1
        build_s += t1 - t0
    t0 = time.perf_counter()
    for dn in nodes:
        dn.measure.flush()
    log(f"  wrote {n_points} points through Liaison.write_measure in "
        f"{write_s:.3f} s ({n_points / write_s:.0f} points/s; building the "
        f"DataPointValues {build_s:.3f} s apart), flushed both nodes in "
        f"{time.perf_counter() - t0:.3f} s")

    engines = {dn.name: dn.measure for dn in nodes}
    meshes = {
        "1x1": make_mesh(1, 1, devices=[device]),
        "4x2": make_mesh(4, 2, devices=[device] * 8),
    }
    queries = cluster_queries(n_points)
    reqs = {name: bydbql.parse(ql) for name, (ql, _m) in queries.items()}
    card = {}
    hk.reset_launches()
    for name, req in reqs.items():
        on_mesh = queries[name][1]
        t0 = time.perf_counter()
        host = liaison.query_measure(req)
        host_ms = (time.perf_counter() - t0) * 1e3
        card[name] = {"host": host}
        log(f"  cluster {name}: {queries[name][0]}")
        log(f"  cluster {name} host combine wall ms {host_ms!r}")
        for mname, mesh in meshes.items():
            liaison.enable_mesh_fastpath(mesh, engines)
            runs = []
            for _ in range(3):
                tr = Tracer("cluster")
                before = hk.LAUNCHES["fused_group_multi"]
                t0 = time.perf_counter()
                res = liaison.query_measure(req, tracer=tr)
                runs.append((res, (time.perf_counter() - t0) * 1e3, tr.finish(),
                             dict(liaison.mesh_exec.last_stats),
                             hk.LAUNCHES["fused_group_multi"] - before))
            check(liaison.mesh_exec.executions == (3 if on_mesh else 0),
                  f"cluster {name} on {mname}: {liaison.mesh_exec.executions} "
                  "mesh executions in 3 runs")
            del liaison.mesh_exec
            for res, *_rest in runs[1:]:
                cluster_same(res, runs[0][0], f"cluster {name} {mname}: repeat run")
            spans = [find_span(r[2], "mesh_execute") for r in runs]
            log(f"  cluster {name} mesh {mname}: wall ms {[r[1] for r in runs]!r}; "
                f"mesh_execute span ms {[sp and sp['duration_ms'] for sp in spans]!r}; "
                f"fused_group_multi launches per run {[r[4] for r in runs]!r}")
            if on_mesh:
                st = runs[-1][3]
                log(f"  cluster {name} mesh {mname} last run: gather {st['gather_ms']!r} "
                    f"ms, pack + H2D {st['pack_ms']!r} ms, device steps to host "
                    f"{st['device_ms']!r} ms, {st['passes']} pass(es) of "
                    f"{st['num_chunks']} chunk(s) a slot, H2D bytes {st['h2d_bytes']}")
            card[name][mname] = runs[0][0]
    launches = dict(hk.LAUNCHES)
    log(f"  kernel launches over the cluster's card runs: {launches}")

    if device == "cuda":
        for name, req in reqs.items():
            liaison.enable_mesh_fastpath(meshes["4x2"], engines)
            busy, h2d, wall, top = device_split(lambda: liaison.query_measure(req))
            del liaison.mesh_exec
            log(f"  cluster {name} mesh 4x2 profile: device busy {busy!r} ms (H2D "
                f"{h2d!r}) of {wall!r} ms wall, idle share {1 - busy / wall!r}; "
                f"top: {top!r}")
    cpu_mesh = make_mesh(4, 2, devices=["cpu"] * 8)
    try:
        for name, req in reqs.items():
            liaison.enable_mesh_fastpath(cpu_mesh, engines)
            t0 = time.perf_counter()
            cres = liaison.query_measure(req)
            cms = (time.perf_counter() - t0) * 1e3
            del liaison.mesh_exec
            got = card[name]
            cluster_same(got["4x2"], cres, f"cluster {name}: card 4x2 vs cpu 4x2")
            cluster_same(got["1x1"], got["4x2"], f"cluster {name}: 1x1 vs 4x2")
            cluster_same(got["4x2"], got["host"], f"cluster {name}: mesh vs host combine",
                         host=queries[name][1])
            for res in got.values():
                cluster_oracle(pts, name, res)
            log(f"  ok  cluster {name}: meshes 1x1 and 4x2 on the card, 4x2 on CPU "
                f"slots ({cms:.1f} ms) and the host combine agree, and the numpy "
                "oracle holds")
    except BaseException:
        close_nodes(nodes)
        raise
    return launches, {"liaison": liaison, "transport": transport, "nodes": nodes,
                      "pts": pts, "root": root,
                      "host": {name: result_doc(got["host"]) for name, got in card.items()}}


# -- phase 11: cold start against warmed start ----------------------------------

WARM_QUERIES = ("topn", "percentile")


def result_doc(res) -> dict:
    """A query result as JSON-able plain values (groups as lists)."""
    return json.loads(json.dumps({
        "groups": [list(g) for g in res.groups],
        "values": res.values,
        "rep_tags": res.rep_tags,
    }))


def same_doc(a, b) -> bool:
    """Equal value for value (NaN equals NaN)."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (a != a and b != b)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same_doc(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(same_doc(x, y) for x, y in zip(a, b))
    return a == b


def warm_child(role: str, root: str, out_path: str, device: str) -> int:
    """One fresh process of phase 11 (run by warm_phase): the engine
    reopened on phase 6's root, the kernel library from the build cache
    named by BYDB_COMPILE_CACHE_DIR, the registry's store at
    <root>/plan-registry.json.  A asks each query twice and records;
    B warms, then asks each query once; C, cold like A, asks the TOP 10
    once under torch.profiler (where a cold query's time goes).  On `device`; writes its numbers to `out_path` as
    JSON."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from banyandb_tpu_torch import bydbql
    from banyandb_tpu_torch.api import SchemaRegistry
    from banyandb_tpu_torch.models.measure import MeasureEngine
    from banyandb_tpu_torch.obs.tracer import Tracer
    from banyandb_tpu_torch.ops import hopper_kernels as hk
    from banyandb_tpu_torch.query import precompile
    from banyandb_tpu_torch.utils import compile_cache

    out: dict = {"role": role}
    t0 = time.perf_counter()
    if device == "cuda":  # the context, apart from what follows
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
        out["arch_list"] = torch.cuda.get_arch_list()
    out["ctx_s"] = time.perf_counter() - t0
    cc = compile_cache.enable()
    check(cc == os.environ["BYDB_COMPILE_CACHE_DIR"], f"child {role}: build cache {cc}")
    if device == "cuda":
        hk.build()
    reg = precompile.default_registry()
    reg.device = device
    reg.attach_store(os.path.join(root, "plan-registry.json"))
    t0 = time.perf_counter()
    eng = MeasureEngine(SchemaRegistry(os.path.join(root, "schema")),
                        os.path.join(root, "data"), device=device)
    out["open_s"] = time.perf_counter() - t0
    reqs = {k: bydbql.parse(v) for k, v in engine_queries(N_POINTS).items()}
    if role == "B":
        out["recorded_before_warm"] = reg.stats()["recorded"]
        hk.reset_launches()
        t0 = time.perf_counter()
        out["warmed"] = reg.warm()
        out["warm_s"] = time.perf_counter() - t0
        out["warm_launches"] = dict(hk.LAUNCHES)
    runs = 2 if role == "A" else 1
    out["walls_ms"] = {}
    out["breakdown"] = {}
    out["results"] = {}
    for name in WARM_QUERIES[:1] if role == "C" else WARM_QUERIES:
        walls = []
        for i in range(runs):
            tr = Tracer("warm")
            profiled = role == "C" and not out["walls_ms"] and i == 0
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device == "cuda" else []
            )
            with profile(activities=acts) if profiled else contextlib.nullcontext() as prof:
                t0 = time.perf_counter()
                res = eng.query(reqs[name], tracer=tr)
                if device == "cuda":
                    torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            if profiled:
                out["cold_profile"] = cold_profile(prof)
            if i == 0:
                out["breakdown"][name] = engine_breakdown(tr.finish())
        out["walls_ms"][name] = walls
        out["results"][name] = result_doc(res)
    eng.close()
    reg.shutdown()  # joins the save timer: the store is on disk
    out["registry"] = reg.stats()
    out["compile_cache"] = compile_cache.stats()
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def cold_profile(prof) -> dict:
    """The host ops that took most of a profiled query (self time), and
    the card's busy time beside them."""
    ka = prof.key_averages()
    top = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    return {
        "top_self_cpu_ms": [
            [e.key[:70], e.self_cpu_time_total / 1e3, e.count] for e in top
        ],
        "device_busy_ms": sum(
            getattr(e, "self_device_time_total", 0.0) for e in ka
        ) / 1e3,
    }


def run_child(role: str, root: str, cc_dir: str, device: str) -> dict:
    out_path = os.path.join(cc_dir, f"child-{role}.json")
    env = dict(os.environ)
    env["BYDB_COMPILE_CACHE_DIR"] = os.path.join(cc_dir, "lib")
    env["BYDB_PRECOMPILE"] = "1"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--warm-child", role, root,
         out_path, device],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=600,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stdout[-4000:])
    check(proc.returncode == 0, f"warm child {role} exited {proc.returncode}")
    with open(out_path) as f:
        doc = json.load(f)
    doc["process_s"] = wall
    return doc


def warm_phase(root: str, card: dict, device: str = "cuda") -> dict:
    """Phase 11 -> the launch counts of B's warm() (`device` "cpu" only
    to rehearse the phase without a card)."""
    import torch

    want = {name: result_doc(card[name]) for name in WARM_QUERIES}
    if device == "cuda":
        torch.cuda.empty_cache()  # the children need the card's memory
    with tempfile.TemporaryDirectory(prefix="bydb-smoke-cc-") as cc_dir:
        a = run_child("A", root, cc_dir, device)
        b = run_child("B", root, cc_dir, device)
        c = run_child("C", root, cc_dir, device)
    for doc in (a, b, c):
        for name in doc["results"]:
            check(same_doc(doc["results"][name], want[name]),
                  f"warm child {doc['role']}: {name} differs from phase 6")
    check(sorted(a["results"]) == sorted(b["results"]) == sorted(WARM_QUERIES),
          "warm children: a query is missing")
    ca, cb = a["compile_cache"], b["compile_cache"]
    if device == "cuda":
        check(ca["misses"] == 1 and ca["builds"] == 1 and ca["hits"] == 0,
              f"child A: expected one nvcc build, got {ca}")
        check(cb["hits"] == 1 and cb["builds"] == 0,
              f"child B: expected a load from the cache, got {cb}")
    check(a["registry"]["recorded"] > 0, "child A recorded no signature")
    check(b["recorded_before_warm"] == a["registry"]["recorded"],
          "child B did not load child A's store")
    rb = b["registry"]
    check(rb["errors"] == 0, f"warm errors: {rb['errors']} ({rb['last_error']})")
    launches = b["warm_launches"]
    for k in PATH_KERNELS["warm"] if device == "cuda" else ():
        check(launches[k] > 0, f"{k}: not launched by warm()")
    log(f"  ok  children A and B answer with phase 6's values; warm() "
        f"{b['warm_s']:.3f} s over {b['warmed']} signatures, launches {launches}")
    print(json.dumps({"warm": {
        "build_s": ca["build_s"], "load_s": cb["load_s"],
        "load_s_after_build": ca["load_s"],
        "warm_s": b["warm_s"], "compiled": rb["compiled"],
        "errors": rb["errors"], "signatures_recorded": a["registry"]["recorded"],
        "warm_launches": launches,
        "first_ms": {r: {k: v[0] for k, v in d["walls_ms"].items()}
                     for r, d in (("A", a), ("B", b), ("C", c))},
        "second_ms_A": {k: v[1] for k, v in a["walls_ms"].items()},
        "first_breakdown": {"A": a["breakdown"], "B": b["breakdown"]},
        "cold_profile_C": c["cold_profile"],
        "ctx_s": {"A": a["ctx_s"], "B": b["ctx_s"]},
        "arch_list": a.get("arch_list"),
        "open_s": {"A": a["open_s"], "B": b["open_s"]},
        "process_s": {"A": a["process_s"], "B": b["process_s"]},
        "compile_cache": {"A": ca, "B": cb},
    }}), flush=True)
    return launches


# -- phase 12: kernel audit on the card -------------------------------------------


def audit_child(out_path: str) -> int:
    """The process of phase 12 (run by audit_phase): every dispatch
    scenario on the card under torch.profiler, written to `out_path` as
    JSON.  A fresh process, as tests/test_torch_cuda.py's: profiles
    taken late in a long run of this script lost events."""
    from banyandb_tpu_torch.lint.kernel import dispatch
    from banyandb_tpu_torch.ops import hopper_kernels as hk

    traces, seen = dispatch.card_audit()
    doc = {
        "launches": dict(hk.LAUNCHES),
        "findings": [f.render() for f in dispatch.dispatch_findings(traces)],
        "rows": [
            {"name": name, "error": t.error, "puts": t.puts, "gets": t.gets,
             "hand_launches": t.hand_launches, **seen[name]}
            for name, t in traces.items()
        ],
    }
    with open(out_path, "w") as f:
        json.dump(doc, f)
    return 0


def audit_phase() -> dict:
    """Phase 12 -> the launch counts of the audit's card runs."""
    from banyandb_tpu_torch.lint.kernel import kernel_budgets

    with tempfile.TemporaryDirectory(prefix="bydb-smoke-audit-") as tmp:
        out_path = os.path.join(tmp, "audit.json")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--audit-child", out_path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=600,
        )
        if proc.returncode != 0:
            log(proc.stdout[-4000:])
        check(proc.returncode == 0, f"audit child exited {proc.returncode}")
        with open(out_path) as f:
            doc = json.load(f)
    for finding in doc["findings"]:
        check(False, finding)
    rows = []
    for r in doc["rows"]:
        name = r.pop("name")
        check(not r.pop("error"), f"audit {name}: scenario failed")
        row = kernel_budgets.BUDGETS[name]
        for col in ("puts", "gets", "hand_launches"):
            check(r[col] == getattr(row, col),
                  f"audit {name}: {col} {r[col]} on the card, "
                  f"table {getattr(row, col)}")
        launched = r.pop("launched")
        check(sum(launched.values()) == r["hand_launches"],
              f"audit {name}: {launched} launched, {r['hand_launches']} wrapper calls")
        rows.append({"name": name, **r, "ops": row.ops,
                     "h2d_equals_puts": r["h2d"] == r["puts"],
                     "launched": {k: v for k, v in launched.items() if v}})
    total = doc["launches"]
    log(f"  ok  {len(rows)} scenarios: puts, gets and hand-kernel launches "
        f"equal the budget table; launches {total}")
    print(json.dumps({"kernel_audit": rows}), flush=True)
    return total


# -- phase 13: the server path ---------------------------------------------------

# a client batching its writes: 65,536 points an envelope, 16.8 MB charged
# to the memory protector (256 bytes a point) while one is applied
SERVER_BATCH = 1 << 16
# the other models' round, at phase 9's size
SERVER_TRACES = 200
SERVER_NODES = 50
SERVER_ELEMENTS = 3000
SERVER_ENV = {
    "BYDB_PRECOMPILE": "1",  # start() warms the plan signatures
    "BYDB_SELF_TRACE": "1",  # every query's span tree into _monitoring.self_query
    "BYDB_SELF_TRACE_MS": "0",
    # the periodic self-measure flush writes _monitoring rows, and the
    # flush after them starts a warm of the recorded signatures beside
    # the queries; the phase flushes the self-measures itself instead
    "BYDB_SELF_MEASURE_INTERVAL_S": "3600",
    # no materialized windows: the TOP 10 would be answered from them
    # after three asks, not by the scan this phase holds
    "BYDB_AUTOREG": "0",
}


def columns_envelope(pts: dict, lo: int, hi: int) -> dict:
    """A measure-write-cols envelope: base64 little-endian ts and field
    columns, tag columns as {"dict", "codes"} pairs."""
    import base64

    def b64(a) -> str:
        return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()

    return {
        "group": ENGINE_GROUP, "name": "service_resp_time",
        "ts": b64(pts["ts"][lo:hi].astype("<i8")),
        "tags": {
            "svc": {"dict": ["svc-%04d" % i for i in range(N_SVC)],
                    "codes": b64(pts["svc"][lo:hi].astype("<i4"))},
            "region": {"dict": ["r%d" % i for i in range(N_REGION)],
                       "codes": b64(pts["region"][lo:hi].astype("<i4"))},
        },
        "fields": {"latency": b64(pts["latency"][lo:hi].astype("<f8")),
                   "calls": b64(pts["calls"][lo:hi].astype("<f8"))},
        "versions": b64(np.ones(hi - lo, dtype="<i8")),
    }


def create_measure(handle, name: str) -> None:
    """Phase 6's measure schema under `name` in group ``sw``, through the
    registry topic."""
    from banyandb_tpu_torch.api import schema as S

    handle("registry", {"op": "create", "kind": "measure", "item": S._to_jsonable(S.Measure(
        group=ENGINE_GROUP, name=name,
        tags=(S.TagSpec("svc", S.TagType.STRING), S.TagSpec("region", S.TagType.STRING)),
        fields=(S.FieldSpec("latency", S.FieldType.FLOAT),
                S.FieldSpec("calls", S.FieldType.INT)),
        entity=S.Entity(("svc", "region")),
    ))})


def server_schema(handle) -> None:
    """Phase 6's group and measure, and the other models' groups,
    through the registry topic."""
    from banyandb_tpu_torch.api import schema as S

    def create(kind, obj):
        handle("registry", {"op": "create", "kind": kind, "item": S._to_jsonable(obj)})

    create("group", S.Group(ENGINE_GROUP, S.Catalog.MEASURE, S.ResourceOpts(shard_num=2)))
    create_measure(handle, "service_resp_time")
    for name, cat in (("sg", S.Catalog.STREAM), ("tg", S.Catalog.TRACE),
                      ("pg", S.Catalog.PROPERTY)):
        create("group", S.Group(name, cat, S.ResourceOpts(shard_num=2)))
    items = handle("registry", {"op": "list", "kind": "measure", "group": ENGINE_GROUP})
    check([i["name"] for i in items["items"]] == ["service_resp_time"],
          f"server: registry list {items}")


def result_values(doc: dict, res) -> None:
    """A reply["result"] against an engine's QueryResult: groups, their
    order and representative tags equal; values equal except the sums and
    means of non-integer fields (rtol)."""
    from types import SimpleNamespace

    want = result_doc(res)
    same_values(
        SimpleNamespace(groups=doc["groups"], values=doc["values"],
                        rep_tags=doc.get("rep_tags") or {}),
        SimpleNamespace(groups=want["groups"], values=want["values"],
                        rep_tags=want["rep_tags"] or {}),
        {"calls"}, "server vs phase 6",
    )


def topn_oracle(pts: dict, top: dict, what: str) -> None:
    """A TOP 10 reply (mean latency where region != 'r3', by svc) against
    plain numpy over the points."""
    keep = pts["region"] != 3
    svc = pts["svc"][keep]
    count = np.bincount(svc, minlength=N_SVC)
    mean = np.bincount(svc, weights=pts["latency"][keep], minlength=N_SVC) / count
    want = ["svc-%04d" % i for i in np.argsort(-mean, kind="stable")[:10]]
    check([g[0] for g in top["groups"]] == want, f"{what}: TOP 10 differs from numpy")
    check(top["values"]["count"] == [float(count[int(g[4:])]) for g in want],
          f"{what}: counts differ from numpy")


def server_oracle(pts: dict, n: int, docs: dict, what: str = "server") -> None:
    """The two answers against plain numpy over the points written."""
    topn_oracle(pts, docs["topn"], f"{what} topn")
    keep = pts["region"] != 3
    svc = pts["svc"][keep]
    count = np.bincount(svc, minlength=N_SVC)
    pct = docs["percentile"]
    check(sorted(g[0] for g in pct["groups"]) == ["svc-%04d" % i for i in range(N_SVC)
                                                  if count[i]],
          f"{what} percentile: group set differs from numpy")
    # each estimate lies in the bucket holding the rank-ceil(qN) order
    # statistic (512 buckets over the f32 range of the rows scanned)
    lat32 = pts["latency"][:n].astype(np.float32)
    width = (float(lat32.max()) - float(lat32.min())) / 512
    lat = pts["latency"][keep]
    order = np.lexsort((lat, svc))
    bounds = np.searchsorted(svc[order], np.arange(N_SVC + 1))
    lat_sorted = lat[order]
    for row, grp in zip(pct["values"]["percentile(latency)"], pct["groups"]):
        gid = int(grp[0][4:])
        vals = lat_sorted[bounds[gid]: bounds[gid + 1]]
        for q, e in zip((0.5, 0.99), row):
            k = max(int(np.ceil(q * len(vals))), 1) - 1
            check(abs(e - vals[k]) <= width + 1e-4,
                  f"{what} percentile: p{q} of {grp[0]} = {e}, order statistic {vals[k]}")


def server_profile(handle, ql: str) -> dict:
    """Device busy time and idle share over one query through the bus."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        handle("bydbql", {"ql": ql})
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()) / 1e3
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1 - busy / wall}


def span_count(tree: dict) -> int:
    return 1 + sum(span_count(c) for c in tree.get("children", ()))


def server_models(handle, srv) -> dict:
    """A small stream, trace and property round through their topics,
    held against the engines' own answers and plain Python."""
    import base64

    from banyandb_tpu_torch import bydbql
    from banyandb_tpu_torch.server import result_to_json

    handle("registry", {"op": "create_stream", "kind": "stream", "item": {
        "group": "sg", "name": "log", "entity": ["svc"],
        "tags": [{"name": "svc", "type": "string"}, {"name": "level", "type": "string"}]}})
    handle("registry", {"op": "create_trace", "kind": "trace", "item": {
        "group": "tg", "name": "spans", "trace_id_tag": "trace_id",
        "tags": [{"name": "trace_id", "type": "string"}, {"name": "svc", "type": "string"},
                 {"name": "duration", "type": "int"}]}})
    elements = [
        {"element_id": "%08x" % i, "ts": T0 + i,
         "tags": {"svc": f"s{i % 7}", "level": LEVELS[i % 4]},
         "body": base64.b64encode(b"line %d" % i).decode()}
        for i in range(SERVER_ELEMENTS)
    ]
    check(handle("stream-write", {"group": "sg", "name": "log", "elements": elements})
          == {"written": SERVER_ELEMENTS}, "server stream: write")
    request = {"groups": ["sg"], "name": "log", "limit": 50,
               "time_range": [T0, T0 + SERVER_ELEMENTS],
               "criteria": {"kind": "cond", "op": "eq", "name": "level", "value": "ERROR"}}
    got = handle("stream-query-user", {"request": request})["result"]
    from banyandb_tpu_torch.cluster import serde

    own = result_to_json(srv.stream.query(serde.query_request_from_json(request)))
    check(json.dumps(got) == json.dumps(own), "server stream: reply differs from the engine")
    want = ["%08x" % i for i in range(SERVER_ELEMENTS - 1, -1, -1) if i % 4 == 2][:50]
    check([dp["element_id"] for dp in got["data_points"]] == want,
          "server stream: rows differ from plain Python")
    spans = [
        {"ts": T0 + t * 10 + s, "span": base64.b64encode(b"sp-%d-%d" % (t, s)).decode(),
         "tags": {"trace_id": f"t{t}", "svc": f"s{t % 5}", "duration": t * 100 + s * 7}}
        for t in range(SERVER_TRACES) for s in range(3)
    ]
    check(handle("trace-write", {"group": "tg", "name": "spans", "spans": spans,
                                 "ordered_tags": ["duration"]})
          == {"written": len(spans)}, "server trace: write")
    got = handle("trace-query-by-id", {"group": "tg", "name": "spans", "trace_id": "t17"})
    own = serde.spans_to_json(srv.trace.query_by_trace_id("tg", "spans", "t17"))
    check(json.dumps(got["spans"]) == json.dumps(own), "server trace: reply differs")
    check([base64.b64decode(s["span"]) for s in got["spans"]]
          == [b"sp-17-%d" % s for s in range(3)], "server trace: spans differ")
    ql = ("SELECT * FROM TRACE spans IN tg WHERE svc = 's3' AND duration >= 5000 "
          "LIMIT 1000")
    got = handle("bydbql", {"ql": ql})["result"]
    from banyandb_tpu_torch.query import ql_exec

    own = result_to_json(ql_exec.execute_trace_ql(srv.trace, bydbql.parse_with_catalog(ql)[1]))
    check(json.dumps(got["data_points"]) == json.dumps(own["data_points"]),
          "server trace: BydbQL reply differs from the engine")
    check(len(got["data_points"]) == sum(1 for t in range(SERVER_TRACES) for s in range(3)
                                         if t % 5 == 3 and t * 100 + s * 7 >= 5000),
          "server trace: BydbQL rows differ from plain Python")
    for i in range(SERVER_NODES):
        handle("property-apply", {"group": "pg", "name": "node", "id": f"n{i}",
                                  "tags": {"role": ("data", "liaison")[i % 2]}})
    upd = handle("property-apply", {"group": "pg", "name": "node", "id": "n3",
                                    "tags": {"zone": "z1"}})
    check(upd["mod_revision"] > upd["create_revision"], "server property: revisions")
    got = handle("property-query", {"group": "pg", "name": "node",
                                    "tag_filters": {"role": "data"}})
    ids = sorted(p["id"] for p in got["properties"])
    own = sorted(p.id for p in srv.property.query("pg", "node", tag_filters={"role": "data"}))
    check(ids == own == sorted(f"n{i}" for i in range(SERVER_NODES) if i % 2 == 0),
          "server property: query differs")
    check(handle("property-query", {"group": "pg", "name": "node", "id": "n3"})
          == {"properties": [{"role": "liaison", "zone": "z1"}]}, "server property: get")
    return {"stream_rows": 50, "trace_spans": len(spans), "properties": SERVER_NODES}


# concurrent clients (phases 13 and 14): each asks TOP 10s over its own
# time range, so no partials cache answers and every ask scans
PROBE_CLIENTS = 2
PROBE_ASKS = 2


def probe_queries(n: int) -> list:
    """PROBE_CLIENTS x PROBE_ASKS distinct TOP 10 texts (the range ends
    1, 2, ... ms early)."""
    top, end = engine_queries(n)["topn"], f"AND {T0 + n - 1} "
    check(end in top, "probe: the TOP 10 text changed")
    return [top.replace(end, f"AND {T0 + n - 1 - k} ")
            for k in range(1, PROBE_CLIENTS * PROBE_ASKS + 1)]


def concurrent_probe(handle, n: int, what: str) -> tuple:
    """PROBE_CLIENTS threads ask the probe queries at once through the
    bus.  -> (figures: the wall of all asks, each ask's wall and how it
    was served, asks a second; {ql: its reply's result})."""
    import threading

    qls = probe_queries(n)
    walls, docs, served, errors = {}, {}, {}, []

    def client(i):
        try:
            for ql in qls[i::PROBE_CLIENTS]:
                t1 = time.perf_counter()
                reply = handle("bydbql", {"ql": ql})
                walls[ql] = (time.perf_counter() - t1) * 1e3
                docs[ql], served[ql] = reply["result"], reply["served"]
        except BaseException as e:  # noqa: BLE001 - raised after the join
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,), name=f"probe-{i}")
               for i in range(PROBE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = (time.perf_counter() - t0) * 1e3
    check(not errors and not any(t.is_alive() for t in threads),
          f"{what} probe: {errors!r}")
    check(all(not d.get("degraded") and d["groups"] for d in docs.values()),
          f"{what} probe: a degraded or empty answer")
    fig = {"clients": PROBE_CLIENTS, "asks": len(qls), "wall_ms": wall,
           "ask_ms": [walls[q] for q in qls], "served": [served[q] for q in qls],
           "asks_per_s": len(qls) / (wall / 1e3)}
    log(f"  {what} {PROBE_CLIENTS} concurrent clients, {len(qls)} TOP 10 asks: {fig}")
    return fig, docs


def server_path(hk, n_points: int, device: str, root: str, want: dict) -> tuple:
    """Phase 13: StandaloneServer driven over its bus on `device`; `want`
    holds phase 6's results.  -> (the launch counts of the queries, the
    figures of the {"server": ...} line, {query name or probe text: its
    reply's result})."""
    from banyandb_tpu_torch.obs import prom
    from banyandb_tpu_torch.query import precompile
    from banyandb_tpu_torch.server import StandaloneServer

    saved = {k: os.environ.get(k) for k in SERVER_ENV}
    os.environ.update(SERVER_ENV)
    reg = precompile.default_registry()
    fig: dict = {"points": n_points, "envelope_points": SERVER_BATCH}
    srv = None
    try:
        # 1. build and start; the warm runs on its own thread: its
        # launches are read after it has joined, before any query
        hk.reset_launches()
        t0 = time.perf_counter()
        srv = StandaloneServer(root, device=device, slow_query_ms=0)
        srv.start()
        fig["start_s"] = time.perf_counter() - t0
        check(reg.wait_warm(600), "server: the warm did not finish")
        fig["warm_s"] = time.perf_counter() - t0
        st = reg.stats()
        fig["warm"] = {"compiled": st["compiled"], "errors": st["errors"],
                       "launches": dict(hk.LAUNCHES), "device": st["device"]}
        check(st["errors"] == 0, f"server warm errors: {st['errors']} ({st['last_error']})")
        check(st["device"] == str(srv.device), f"server: registry warms on {st['device']}")
        for k in PATH_KERNELS["warm"] if device == "cuda" else ():
            check(hk.LAUNCHES[k] > 0, f"server warm: {k} not launched")
        fig["pressure_profiler"] = srv.pressure_profiler is not None
        fig["protector_limit"] = srv.protector.limit
        log(f"  server started in {fig['start_s']:.3f} s, warm joined at "
            f"{fig['warm_s']:.3f} s: {fig['warm']}; pressure profiler "
            f"{'on' if fig['pressure_profiler'] else 'off'} (protector limit "
            f"{srv.protector.limit})")

        def handle(topic, env):
            return srv.bus.handle(topic, env)

        # 2. schema through the registry topic
        server_schema(handle)

        # 3. phase 6's points in measure-write-cols envelopes, then snapshot
        pts = make_points(n_points, SEED + 1)
        write_s = 0.0
        for lo in range(0, n_points, SERVER_BATCH):
            env = columns_envelope(pts, lo, min(lo + SERVER_BATCH, n_points))
            t1 = time.perf_counter()
            reply = handle("measure-write-cols", env)
            write_s += time.perf_counter() - t1
            check(reply == {"written": min(SERVER_BATCH, n_points - lo)},
                  f"server write: {reply}")
        t1 = time.perf_counter()
        snap = handle("snapshot", {})
        fig["snapshot_s"] = time.perf_counter() - t1
        fig["ingest_s"] = write_s
        fig["ingest_points_per_s"] = n_points / write_s
        log(f"  wrote {n_points} points in {n_points // SERVER_BATCH} measure-write-cols "
            f"envelopes: {write_s!r} s ({fig['ingest_points_per_s']!r} points/s); "
            f"snapshot {fig['snapshot_s']!r} s ({len(snap['flushed'])} parts flushed)")

        # 4. the two queries, three times each, through the bydbql topic,
        # over the parts the lifecycle loop left (phase 6 has eight)
        def n_parts():
            db = srv.measure._tsdb(ENGINE_GROUP)
            return sum(len(sh.parts) for seg in db.segments for sh in seg.shards)

        fig["parts_before_queries"] = n_parts()
        texts = engine_queries(n_points)
        check(reg.wait_warm(600), "server: a flush warm did not finish")
        compiled0 = reg.stats()["compiled"]
        hk.reset_launches()
        walls, docs, served = {}, {}, {}
        for name, ql in texts.items():
            walls[name], served[name] = [], []
            for i in range(3):
                before = hk.LAUNCHES["fused_group_multi"]
                t1 = time.perf_counter()
                reply = handle("bydbql", {"ql": ql})
                walls[name].append((time.perf_counter() - t1) * 1e3)
                served[name].append(reply["served"])
                # a partials-cache replay launches nothing; the card's
                # 4,194,304 points overflow that cache (checked below)
                check(hk.LAUNCHES["fused_group_multi"] > before
                      or device != "cuda" or reply["served"] != "scan",
                      f"server {name}: fused_group_multi not launched")
                if i == 0:
                    docs[name] = reply["result"]
                else:
                    check(json.dumps(reply["result"]) == json.dumps(docs[name]),
                          f"server {name}: repeat run differs")
            result_values(docs[name], want[name])
            log(f"  server {name} wall ms {walls[name]!r}, served {served[name]}; "
                "agrees with phase 6")
            check(device != "cuda" or served[name] == ["scan"] * 3,
                  f"server {name}: served {served[name]}, not a scan each time")
        traced = handle("bydbql", {"ql": texts["topn"], "trace": True})
        check(json.dumps({k: v for k, v in traced["result"].items() if k != "trace"})
              == json.dumps(docs["topn"]), "server topn: traced reply differs")
        fig["breakdown_topn"] = engine_breakdown(traced["result"]["trace"]["span_tree"])
        log(f"  server topn breakdown (trace: true): {fig['breakdown_topn']}")
        from banyandb_tpu_torch import bydbql
        from banyandb_tpu_torch.cluster import serde

        raw = handle("measure-query-raw", {
            "request": serde.query_request_to_json(bydbql.parse(texts["percentile"]))})
        check(json.dumps(raw["result"]) == json.dumps(docs["percentile"]),
              "server: measure-query-raw differs from bydbql")
        if device == "cuda":
            fig["profile_topn"] = server_profile(handle, texts["topn"])
            log(f"  server topn profile: {fig['profile_topn']}")
        launches = dict(hk.LAUNCHES)
        st = reg.stats()
        check(not st["warming"] and st["compiled"] == compiled0,
              "server: a warm ran beside the queries; their launches are not theirs alone")
        n_queries = 6 + 1 + 1 + (device == "cuda")
        log(f"  kernel launches over the server's {n_queries} measure queries: {launches}")
        server_oracle(pts, n_points, docs)
        log("  ok  server: TOP 10, counts and percentiles agree with numpy")
        fig["walls_ms"] = walls
        fig["served"] = served
        fig["parts_after_queries"] = n_parts()
        log(f"  server parts: {fig['parts_before_queries']} before the queries, "
            f"{fig['parts_after_queries']} after (the lifecycle loop merges beside them)")

        # 5. the serving planes
        text = handle("metrics", {})["prometheus"]
        samples = prom.parse_exposition(text)
        names = {s[0] for s in samples}
        for base in ("measure_query_ms", "measure_write_points", "precompile_recorded",
                     "precompile_compiled", "precompile_errors", "serving_cache_hits",
                     "serving_cache_misses"):
            check(any(base in nm for nm in names), f"server metrics: {base} missing")

        def value(name, labels=None):
            return prom.gauge_value(text, name, labels)

        scope = next(nm for nm in names if nm.endswith("measure_write_points_total"))
        pfx = scope[: -len("measure_write_points_total")]
        check(value(pfx + "measure_write_points_total") == n_points,
              "server metrics: measure_write_points")
        check(value(pfx + "measure_query_ms_count") == 1,
              "server metrics: measure_query_ms counts the raw-topic query")
        check(value(pfx + "precompile_errors") == 0, "server metrics: precompile_errors")
        check(value(pfx + "precompile_compiled") == st["compiled"],
              "server metrics: precompile_compiled")
        fig["metrics_samples"] = len(samples)
        slow = handle("slowlog", {})
        entries = slow["entries"]
        check(len(entries) == n_queries and all(e["span_tree"] for e in entries),
              f"server slowlog: {len(entries)} entries for {n_queries} queries")
        fig["slowlog_entries"] = len(entries)
        # the bus, parse, admission and epilogue around each engine run:
        # the handle's wall less the engine's own ms the slowlog kept
        # (entries newest first; the first six are the timed queries)
        engine_ms = [e["duration_ms"] for e in reversed(entries)][:6]
        fig["overhead_ms"] = [w - e for w, e in zip(walls["topn"] + walls["percentile"],
                                                    engine_ms)]
        log(f"  server overhead around the engine, ms: {fig['overhead_ms']!r}")
        now = int(time.time() * 1000)
        wrote = srv.self_metrics.flush(now_millis=now)
        own = handle("bydbql", {"ql": "SELECT count(value) FROM MEASURE instruments IN "
                                      f"_monitoring TIME BETWEEN {now} AND {now} GROUP BY kind"})
        counted = sum(own["result"]["values"]["count(value)"])
        check(wrote > 0 and counted == wrote,
              f"server self-measures: {counted} rows counted, {wrote} written")
        srv.self_trace.flush()
        rows = handle("bydbql", {"ql": "SELECT * FROM TRACE self_query IN _monitoring "
                                       "WHERE engine = 'measure' LIMIT 100000"})
        span_rows = rows["result"]["data_points"]
        want_rows = sum(span_count(e["span_tree"]) for e in entries if e["engine"] == "measure")
        stages = {dp["tags"]["stage"] for dp in span_rows}
        check(len(span_rows) >= want_rows and "reduce" in stages,
              f"server self-trace: {len(span_rows)} span rows, {want_rows} spans offered")
        fig["self_measure_rows"] = wrote
        fig["self_trace_rows"] = len(span_rows)
        log(f"  ok  server planes: {len(samples)} metric samples, {len(entries)} slowlog "
            f"entries, {wrote} self-measure rows counted back by BydbQL, "
            f"{len(span_rows)} self-trace span rows ({want_rows} spans of the "
            f"measure queries)")

        # 6. the other models through their topics
        fig["models"] = server_models(handle, srv)
        log(f"  ok  server stream, trace and property rounds: {fig['models']}")
        fig["probe"], probe_docs = concurrent_probe(handle, n_points, "server")
        docs.update(probe_docs)

        # 7. restart over the same root
        fig["pressure_captures"] = (srv.pressure_profiler.captured
                                    if srv.pressure_profiler is not None else None)
        srv.stop()
        srv = None
        t1 = time.perf_counter()
        srv = StandaloneServer(root, device=device, slow_query_ms=0)
        srv.start()
        fig["reopen_s"] = time.perf_counter() - t1
        check(reg.wait_warm(600), "server: the warm after the restart did not finish")
        fig["reopen_warm_s"] = time.perf_counter() - t1
        fig["restart_first_ms"] = {}
        for name, ql in texts.items():
            t1 = time.perf_counter()
            reply = handle("bydbql", {"ql": ql})
            fig["restart_first_ms"][name] = (time.perf_counter() - t1) * 1e3
            check(json.dumps(reply["result"]) == json.dumps(docs[name]),
                  f"server {name}: differs after the restart")
        log(f"  ok  server restart: reopened in {fig['reopen_s']!r} s (warm joined at "
            f"{fig['reopen_warm_s']!r} s); first queries {fig['restart_first_ms']!r} ms, "
            "byte-identical")
        return launches, fig, docs
    finally:
        if srv is not None:
            srv.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# -- phase 14: the worker path ---------------------------------------------------

WORKERS = 2
# points written after the queries and before the kill: in the parent's
# journal and the workers' memtables only, until the replay
WORKERS_EXTRA = 1 << 16
WORKERS_ENV = {
    # no plan warm in the parent (its launches would mix with the
    # queries') nor in the workers, which inherit the environment
    "BYDB_PRECOMPILE": "0",
    # as in phase 13: no materialized windows, no self-measure flush
    # beside the timed queries
    "BYDB_AUTOREG": "0",
    "BYDB_SELF_MEASURE_INTERVAL_S": "3600",
}


def doc_ns(doc: dict):
    """A reply's result as same_values takes it."""
    from types import SimpleNamespace

    return SimpleNamespace(groups=doc["groups"], values=doc["values"],
                           rep_tags=doc.get("rep_tags") or {})


def worker_gauges(pool, metric: str, **labels) -> dict:
    """{worker: value} of one gauge of the workers' merged exposition."""
    from banyandb_tpu_torch.obs import prom

    out = {}
    for name, lbls, value in prom.parse_exposition(pool.metrics_text()):
        if name == "banyandb_" + metric and all(lbls.get(k) == v for k, v in labels.items()):
            out[lbls["worker"]] = value
    return out


def worker_launches(hk, pool) -> dict:
    """{worker: {kernel: launches}} read from the workers' own counts."""
    out: dict = {}
    for k in hk.LAUNCHES:
        for w, v in worker_gauges(pool, "kernel_launches", kernel=k).items():
            out.setdefault(w, {})[k] = int(v)
    return out


def shifted_points(n: int, seed: int, start: int) -> dict:
    """n fresh points whose timestamps follow `start` earlier ones."""
    pts = make_points(n, seed)
    pts["ts"] = pts["ts"] + start
    return pts


def joined(a: dict, b: dict) -> dict:
    return {k: np.concatenate([a[k], b[k]]) for k in a}


def workers_path(hk, n_points: int, device: str, root: str, want: dict) -> tuple:
    """Phase 14: StandaloneServer(workers=2) on `device`; `want` holds
    phase 13's replies (its two queries and its probe's).  -> (the
    workers' launch counts over the queries,
    summed over the workers, the figures of the {"workers": ...} line)."""
    from banyandb_tpu_torch.sanitize import leaks
    from banyandb_tpu_torch.server import StandaloneServer
    from banyandb_tpu_torch.utils import procreg

    fig: dict = {"workers": WORKERS, "points": n_points, "envelope_points": SERVER_BATCH}
    procs_before = procreg.snapshot()
    saved = {k: os.environ.get(k) for k in WORKERS_ENV}
    os.environ.update(WORKERS_ENV)
    srv = None
    try:
        t0 = time.perf_counter()
        srv = StandaloneServer(root, device=device, workers=WORKERS, slow_query_ms=0)
        srv.start()
        pool = srv.pool
        fig["spawn_s"] = time.perf_counter() - t0
        check(len(procreg.snapshot() - procs_before) == WORKERS,
              "workers: the children are not registered in procreg")
        fig["worker_device"] = {c.name: c.ready_info["device"] for c in pool._clients}
        fig["boot_compile_cache"] = {
            c.name: {k: c.ready_info["compile_cache"][k] for k in ("builds", "loads")}
            for c in pool._clients}
        log(f"  {WORKERS} workers ready in {fig['spawn_s']!r} s on "
            f"{fig['worker_device']}; build cache at boot {fig['boot_compile_cache']}")
        if device == "cuda":
            for w, cc in fig["boot_compile_cache"].items():
                check(cc == {"builds": 0, "loads": 1},
                      f"workers: {w} did not load the parent's library: {cc}")

        def handle(topic, env):
            return srv.bus.handle(topic, env)

        server_schema(handle)
        pts = make_points(n_points, SEED + 1)
        write_s = 0.0
        for lo in range(0, n_points, SERVER_BATCH):
            env = columns_envelope(pts, lo, min(lo + SERVER_BATCH, n_points))
            t1 = time.perf_counter()
            reply = handle("measure-write-cols", env)
            write_s += time.perf_counter() - t1
            check(reply == {"written": min(SERVER_BATCH, n_points - lo)},
                  f"workers write: {reply}")
        t1 = time.perf_counter()
        snap = handle("snapshot", {})
        fig["snapshot_s"] = time.perf_counter() - t1
        fig["ingest_points_per_s"] = n_points / write_s
        log(f"  wrote {n_points} points in {n_points // SERVER_BATCH} measure-write-cols "
            f"envelopes: {write_s!r} s ({fig['ingest_points_per_s']!r} points/s); "
            f"snapshot {fig['snapshot_s']!r} s ({len(snap['flushed'])} parts flushed)")

        texts = engine_queries(n_points)
        before = worker_launches(hk, pool)
        hk.reset_launches()
        walls, docs, served = {}, {}, {}
        traced = None
        for name, ql in texts.items():
            walls[name], served[name] = [], []
            for i in range(3):
                # the first TOP 10 carries its span tree (each worker's
                # first scan on the card, grafted under its scatter leg)
                first_top = name == "topn" and i == 0
                t1 = time.perf_counter()
                reply = handle("bydbql", {"ql": ql, "trace": first_top})
                walls[name].append((time.perf_counter() - t1) * 1e3)
                served[name].append(reply["served"])
                if first_top:
                    traced = reply["result"].pop("trace")
                check(not reply["result"].get("degraded"), f"workers {name}: degraded")
                if i == 0:
                    docs[name] = reply["result"]
                else:
                    check(json.dumps(reply["result"]) == json.dumps(docs[name]),
                          f"workers {name}: repeat run differs")
            same_values(doc_ns(docs[name]), doc_ns(want[name]), {"calls"},
                        f"workers {name} vs phase 13")
            log(f"  workers {name} wall ms {walls[name]!r}, served {served[name]}; "
                "agrees with phase 13")
        parent = dict(hk.LAUNCHES)
        after = worker_launches(hk, pool)
        per_worker = {w: {k: after[w][k] - before.get(w, {}).get(k, 0) for k in after[w]}
                      for w in after}
        launches = {k: sum(c[k] for c in per_worker.values()) for k in hk.LAUNCHES}
        log(f"  kernel launches over the {len(texts)} queries x 3 runs: workers "
            f"{per_worker}, parent {parent}")
        check(parent == {k: 0 for k in parent},
              f"workers: the parent launched kernels for the workers' queries: {parent}")
        for w in (c.name for c in pool._clients):
            check(device != "cuda" or per_worker.get(w, {}).get("fused_group_multi", 0) > 0,
                  f"workers: {w} did not launch fused_group_multi")
        server_oracle(pts, n_points, docs, "workers")
        log("  ok  workers: TOP 10, counts and percentiles agree with phase 13 and numpy")
        fig["walls_ms"] = walls
        fig["served"] = served
        fig["first_vs_later_ms"] = {name: [w[0], min(w[1:])] for name, w in walls.items()}
        fig["launches"] = per_worker
        spans = {}
        for c in pool._clients:
            leg = find_span(traced["span_tree"], f"scatter:{c.name}")
            check(leg is not None, f"workers: no scatter:{c.name} span in the trace")
            spans[c.name] = {s: (find_span(leg, s) or {}).get("duration_ms")
                             for s in ("part_gather", "gather", "reduce")}
        fig["spans_ms"] = spans
        log(f"  workers' first TOP 10 (traced), each worker's grafted spans (ms): {spans}")
        fig["compile_cache"] = {
            w: {k: worker_gauges(pool, f"compile_cache_{k}")[w] for k in ("builds", "loads")}
            for w in spans}
        fig["probe"], probe_docs = concurrent_probe(handle, n_points, "workers")
        for ql, doc in probe_docs.items():
            same_values(doc_ns(doc), doc_ns(want[ql]), {"calls"}, "workers probe vs phase 13")
        log("  ok  workers probe: every answer agrees with phase 13's")

        # the kill: acked points in the journal, a degraded window, replay
        extra = shifted_points(WORKERS_EXTRA, SEED + 7, n_points)
        reply = handle("measure-write-cols", columns_envelope(extra, 0, WORKERS_EXTRA))
        check(reply == {"written": WORKERS_EXTRA}, f"workers extra write: {reply}")
        n_all = n_points + WORKERS_EXTRA
        top_all = engine_queries(n_all)["topn"]
        old = pool._clients[0]
        t_kill = time.perf_counter()
        pool.kill_worker(0)
        dead = None
        while dead is None and time.perf_counter() - t_kill < 120:
            t1 = time.perf_counter()
            res = handle("bydbql", {"ql": top_all})["result"]
            if res.get("degraded"):
                dead = res
                fig["dead_window_ms"] = (time.perf_counter() - t1) * 1e3
            elif pool._clients[0] not in (None, old):
                break
        check(dead is not None, "workers: no degraded answer in the dead window")
        check(dead["unavailable_nodes"] == [old.name],
              f"workers: the dead window names {dead['unavailable_nodes']}")
        while (pool._clients[0] in (None, old) or old.name not in pool.liaison.alive) \
                and time.perf_counter() - t_kill < 300:
            time.sleep(0.05)
        fig["restart_s"] = time.perf_counter() - t_kill
        check(pool._clients[0] not in (None, old), "workers: w000 was not restarted")
        fig["restart_compile_cache"] = {
            k: pool._clients[0].ready_info["compile_cache"][k] for k in ("builds", "loads")}
        t1 = time.perf_counter()
        res = handle("bydbql", {"ql": top_all})["result"]
        fig["after_restart_ms"] = (time.perf_counter() - t1) * 1e3
        check(not res.get("degraded"), f"workers: degraded after the restart: {res}")
        topn_oracle(joined(pts, extra), res, "workers after the kill")
        log(f"  ok  workers kill: the dead window answered degraded naming "
            f"{dead['unavailable_nodes']}; w000 back in {fig['restart_s']!r} s (build "
            f"cache {fig['restart_compile_cache']}); the TOP 10 over {n_all} points "
            f"agrees with numpy ({fig['after_restart_ms']!r} ms)")
        if device == "cuda":
            check(fig["restart_compile_cache"] == {"builds": 0, "loads": 1},
                  "workers: the restarted w000 did not load the library")
        fig["restarts"] = pool.restarts
    finally:
        if srv is not None:
            srv.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(procreg.snapshot() - procs_before == frozenset(),
          "workers: stop() left a child registered")
    check(leaks.leaked_processes(procs_before, grace_s=0.1) == [],
          "workers: stop() left a child behind")
    log("  ok  workers: stop() reaped every child (procreg, leaks)")
    return launches, fig


# -- phase 15: the rebalance path ----------------------------------------------

REBALANCE_EXTRA = 1 << 16
REBALANCE_BATCH = 1 << 13


class NodeList:
    """A discovery source over a fixed node list (``Liaison.refresh_nodes``
    re-reads it: the addr book widens, the placement does not move)."""

    def __init__(self, nodes):
        self._nodes = list(nodes)

    def refresh(self) -> bool:
        return True

    def nodes(self):
        return list(self._nodes)


def rebalance_path(hk, cluster: dict, device: str) -> tuple:
    """Phase 15: a third data node on `device` joins phase 10's cluster
    and the Rebalancer moves shards to it while a second thread writes.
    -> (the launch counts of the queries after the move, the figures of
    the {"rebalance": ...} line)."""
    import threading

    from banyandb_tpu_torch import bydbql
    from banyandb_tpu_torch.api import WriteRequest
    from banyandb_tpu_torch.cluster import DataNode, NodeInfo
    from banyandb_tpu_torch.cluster.rebalance import Rebalancer
    from banyandb_tpu_torch.cluster.rpc import TransportError
    from banyandb_tpu_torch.obs.tracer import Tracer
    from banyandb_tpu_torch.parallel import make_mesh

    liaison, transport, nodes = cluster["liaison"], cluster["transport"], cluster["nodes"]
    pts = cluster["pts"]
    n_points = len(pts["ts"])
    fig: dict = {"points_before": n_points, "extra_points": REBALANCE_EXTRA}
    epoch0 = liaison.placement.epoch
    reg = engine_registry(os.path.join(cluster["root"], "n3"), shard_num=4)
    dn = DataNode("data-2", reg, os.path.join(cluster["root"], "n3", "data"), device=device)
    nodes.append(dn)
    liaison.discovery = NodeList(
        list(liaison.selector.nodes) + [NodeInfo(dn.name, transport.register(dn.name, dn.bus))])
    check(liaison.refresh_nodes(), "rebalance: the join was not read")
    reb = Rebalancer(liaison)
    t0 = time.perf_counter()
    plan = reb.plan()
    fig["plan_ms"] = (time.perf_counter() - t0) * 1e3
    fig["moves"] = [m.to_json() for m in plan.moves]
    check(any(dn.name in m.add for m in plan.moves), f"rebalance: no move to {dn.name}")
    log(f"  plan to {list(plan.target_nodes)} in {fig['plan_ms']!r} ms: {fig['moves']}")

    extra = shifted_points(REBALANCE_EXTRA, SEED + 9, n_points)
    writer = {"acked": 0, "retries": 0, "error": None}

    def write_beside():
        try:
            for lo in range(0, REBALANCE_EXTRA, REBALANCE_BATCH):
                batch = measure_batch(extra, lo, lo + REBALANCE_BATCH)
                while True:
                    try:
                        n = liaison.write_measure(
                            WriteRequest(ENGINE_GROUP, "service_resp_time", batch))
                        break
                    except TransportError as e:  # fenced at the cutover: re-route
                        if e.kind != "stale_epoch":
                            raise
                        writer["retries"] += 1
                writer["acked"] += n
        except BaseException as e:  # noqa: BLE001 - reported by the phase
            writer["error"] = e

    thread = threading.Thread(target=write_beside, name="rebalance-writer")
    tr = Tracer("rebalance")
    counting = liaison.transport = SyncBytes(transport)
    t0 = time.perf_counter()
    thread.start()
    try:
        stats = reb.apply(plan, tracer=tr)
    finally:
        fig["apply_ms"] = (time.perf_counter() - t0) * 1e3
        thread.join(timeout=600)
        liaison.transport = transport
    check(not thread.is_alive(), "rebalance: the writer did not finish")
    check(writer["error"] is None, f"rebalance: the writer failed: {writer['error']!r}")
    check(writer["acked"] == REBALANCE_EXTRA, f"rebalance: {writer['acked']} acked")
    tree = tr.finish()
    fig["stats"] = stats
    fig["writer_retries"] = writer["retries"]
    fig["span_ms"] = {s: [sp["duration_ms"] for sp in find_spans(tree, s)]
                      for s in ("schema_sync", "dual_route", "ship:bulk", "ship:delta",
                                "cutover")}
    check(stats.get("ok") and stats["parts_moved"] > 0, f"rebalance: {stats}")
    check(liaison.placement.epoch == epoch0 + 1,
          f"rebalance: epoch {liaison.placement.epoch}, was {epoch0}")
    check(all(d.epoch_record.epoch == epoch0 + 1 for d in nodes),
          "rebalance: a node is not fenced at the new epoch")
    fig["bytes_shipped"] = counting.bytes
    log(f"  apply in {fig['apply_ms']!r} ms beside {REBALANCE_EXTRA} points written "
        f"({writer['retries']} fenced retries): {stats}; spans ms {fig['span_ms']}")
    for d in nodes:
        d.measure.flush()

    n_all = n_points + REBALANCE_EXTRA
    pts_all = joined(pts, extra)
    queries = cluster_queries(n_all)
    reqs = {name: bydbql.parse(ql) for name, (ql, _m) in queries.items()}
    mesh = make_mesh(1, 1, devices=[device])
    engines = {d.name: d.measure for d in nodes}
    walls = {}
    hk.reset_launches()
    for name, req in reqs.items():
        t0 = time.perf_counter()
        host = liaison.query_measure(req)
        host_ms = (time.perf_counter() - t0) * 1e3
        liaison.enable_mesh_fastpath(mesh, engines)
        t0 = time.perf_counter()
        on_mesh = liaison.query_measure(req)
        mesh_ms = (time.perf_counter() - t0) * 1e3
        check(liaison.mesh_exec.executions == (1 if queries[name][1] else 0),
              f"rebalance {name}: {liaison.mesh_exec.executions} mesh executions")
        del liaison.mesh_exec
        walls[name] = {"host_ms": host_ms, "mesh_1x1_ms": mesh_ms}
        for res, what in ((host, "host combine"), (on_mesh, "mesh 1x1")):
            check(not res.degraded, f"rebalance {name} {what}: degraded")
            cluster_oracle(pts_all, name, res)
        cluster_same(on_mesh, host, f"rebalance {name}: mesh vs host combine",
                     host=queries[name][1])
    launches = dict(hk.LAUNCHES)
    fig["walls_ms"] = walls
    traced = liaison.query_measure(dataclasses.replace(reqs["count"], trace=True))
    leg = find_span(traced.trace["span_tree"], f"scatter:{dn.name}")
    check(leg is not None, f"rebalance: {dn.name} answered no scatter leg")
    log(f"  ok  rebalance: the six queries over {n_all} points agree with numpy on the "
        f"host combine and the 1x1 mesh; epoch {liaison.placement.epoch}; {dn.name} "
        f"answers a scatter leg; walls ms {walls}; launches {launches}")
    return launches, fig


# -- phase 16: the data lifecycle ------------------------------------------------

DAY_MS = 86_400_000
LIFE_N = 1 << 20
LIFE_DAYS = 4
LIFE_T0 = T0 - T0 % DAY_MS  # 2023-11-14 00:00 UTC: a day segment's start
TIER_N = 1 << 18


def life_points(n: int, days: int, seed: int) -> dict:
    """The measure configuration's points, n // days a day over `days`
    day segments from LIFE_T0, evenly spaced within each day."""
    pts = make_points(n, seed)
    per = n // days
    i = np.arange(n, dtype=np.int64)
    pts["ts"] = LIFE_T0 + (i // per) * DAY_MS + (i % per) * (DAY_MS // per)
    return pts


def day_slice(pts: dict, lo_day: int, hi_day: int) -> dict:
    keep = (pts["ts"] >= LIFE_T0 + lo_day * DAY_MS) & (pts["ts"] < LIFE_T0 + hi_day * DAY_MS)
    return {k: v[keep] for k, v in pts.items()}


def life_queries(days: int, names=None) -> dict:
    """BydbQL over the first `days` days: phase 6's TOP 10 and p50/p99
    (``region != 'r3'``) and count/sum/min/max of calls, each by svc."""
    span = f"TIME BETWEEN {LIFE_T0} AND {LIFE_T0 + days * DAY_MS - 1}"
    frm = f"FROM MEASURE service_resp_time IN {ENGINE_GROUP} {span}"
    out = {
        "topn": f"SELECT latency, calls {frm} WHERE region != 'r3' GROUP BY svc "
                "TOP 10 BY latency",
        "percentile": f"SELECT percentile(latency, 0.5, 0.99) {frm} "
                      f"WHERE region != 'r3' GROUP BY svc LIMIT {N_SVC}",
    }
    for fn in ("count", "sum", "min", "max"):
        out[fn] = f"SELECT {fn}(calls) {frm} GROUP BY svc LIMIT {N_SVC}"
    return {k: v for k, v in out.items() if names is None or k in names}


def clear_serving_caches() -> None:
    """Empty the decoded-part, gather and partials caches (host and
    device): the next query reads the moved bytes and runs its own scan.
    The caches key a part by its path, and an archived segment comes
    back at the same path."""
    from banyandb_tpu_torch.storage.cache import device_cache, global_cache

    global_cache().clear()
    device_cache().clear()


def tree_bytes(root) -> int:
    from pathlib import Path

    return sum(p.stat().st_size for p in Path(root).rglob("*") if p.is_file())


def life_step(hk, ask, texts: dict, pts: dict, what: str, device: str,
              before: dict = None, partials=None) -> tuple:
    """Ask every query once through `ask`, each with cold serving caches
    (so each one scans), each against numpy over `pts` (the TOP 10 and
    the percentiles where region != 'r3') and, given `before`, exactly
    equal to the answer before the move; given `partials` (an engine's
    ``query_partials``), the TOP 10's partials, its float sums among
    them, against numpy too; -> ({name: result}, wall ms, every kernel's
    launches in the step's queries).  On the card ``fused_group_multi``
    must have launched."""
    from banyandb_tpu_torch import bydbql

    hk.reset_launches()
    out = {}
    t0 = time.perf_counter()
    for name, ql in texts.items():
        clear_serving_caches()
        out[name] = ask(bydbql.parse(ql))
    wall = (time.perf_counter() - t0) * 1e3
    launches = dict(hk.LAUNCHES)
    for name, res in out.items():
        keep = pts["region"] != 3 if name in ("topn", "percentile") else None
        cluster_oracle(pts, name, res, keep=keep, what=what)
        if before is not None:
            check(same_doc(result_doc(res), result_doc(before[name])),
                  f"{what}: {name} differs from before the move")
    if partials is not None:
        oracle_check(pts, partials(bydbql.parse(texts["topn"])), out["topn"],
                     f"{what} topn partials")
    if device == "cuda":
        check(launches["fused_group_multi"] > 0, f"{what}: fused_group_multi not launched")
    log(f"  ok  {what}: {len(texts)} queries in {wall!r} ms equal numpy"
        + (" and the answers before the move" if before is not None else "")
        + f"; launches {launches}")
    return out, wall, launches


def busy_ms(ask, texts: dict, device: str):
    """Device busy ms of phase 6's TOP 10 with cold caches (the card
    only; None elsewhere)."""
    if device != "cuda":
        return None
    from banyandb_tpu_torch import bydbql

    req = bydbql.parse(texts["topn"])
    clear_serving_caches()
    busy, _h2d, wall, _top = device_split(lambda: ask(req))
    return [busy, wall]


def lifecycle_path(hk, n_points: int, device: str, root: str) -> tuple:
    """Phase 16 on `device`: the measure configuration over four day
    segments through the lifecycle tools.  -> (launches of the
    lifecycle steps, launches of the tier step's queries, the figures).

    1. archive: ``lifecycle.migrate`` the first two days away and
       ``restore_segment`` them back;
    2. format migration: ``analyze``, ``plan(target_version=2)``,
       ``copy`` into a fresh root, ``verify``, a fresh engine over it;
    3. backup and restore into an empty root, and a refused restore
       into a live one;
    4. tier migration: a hot and a warm ``DataNode`` and a liaison with
       stages hot and warm; ``TierMigrator`` ships day 1 to the warm
       node; stage-routed queries; a second run ships nothing;
    5. MCP: ``execute_bydbql`` of the TOP 10 through ``McpServer``.

    Each query runs with the serving caches emptied just before it, so
    each one scans, and is held against numpy; each answer after a move
    equals the answer before it exactly, value for value.  The launches
    of every kernel are read after each step's queries."""
    from pathlib import Path

    from banyandb_tpu_torch.admin import backup, lifecycle, migration
    from banyandb_tpu_torch.admin.tier_migration import TierMigrator
    from banyandb_tpu_torch.api import SchemaRegistry
    from banyandb_tpu_torch.cluster import DataNode, Liaison, NodeInfo
    from banyandb_tpu_torch.cluster.rpc import LocalTransport
    from banyandb_tpu_torch.mcp_server import McpServer
    from banyandb_tpu_torch.models.measure import MeasureEngine

    root = Path(root)
    live = root / "live"
    pts = life_points(n_points, LIFE_DAYS, SEED + 5)
    texts = life_queries(LIFE_DAYS)
    fig = {"points": n_points, "days": LIFE_DAYS, "steps": {}}
    launches = {k: 0 for k in hk.LAUNCHES}
    tier_counts = {k: 0 for k in hk.LAUNCHES}

    def engine(r):
        return MeasureEngine(SchemaRegistry(r), r / "data", device=device)

    def step(name, t0, **kw):
        fig["steps"][name] = dict(kw, wall_s=time.perf_counter() - t0)
        log(f"  step {name}: {fig['steps'][name]}")

    def count(step_launches, into=launches):
        """Add one step's launches of every kernel; -> fused_group_multi's."""
        for k, v in step_launches.items():
            into[k] += v
        return step_launches["fused_group_multi"]

    # 1. archive and restore
    t0 = time.perf_counter()
    engine_registry(str(live), schema_dir="")
    eng = engine(live)
    write_s = write_batches(eng, pts, n_points // LIFE_DAYS)
    parts = sum(len(sh.parts) for seg in eng._tsdb(ENGINE_GROUP).segments
                for sh in seg.shards)
    check(parts == 2 * LIFE_DAYS, f"lifecycle: {parts} parts written, not 8")
    log(f"  wrote {n_points} points in {LIFE_DAYS} day batches of write_columns + "
        f"flush in {write_s:.3f} s: {parts} parts")
    first, first_ms, counts = life_step(hk, eng.query, texts, pts, "lifecycle before", device,
                                        partials=eng.query_partials)
    fused = count(counts)
    db = eng._tsdb(ENGINE_GROUP)
    t1 = time.perf_counter()
    moved = lifecycle.migrate(db, root / "archive", LIFE_T0 + 2 * DAY_MS)
    archive_ms = (time.perf_counter() - t1) * 1e3
    check(len(moved) == 2 and lifecycle.list_archived(root / "archive") == moved,
          f"lifecycle: migrate moved {moved}")
    after, after_ms, counts = life_step(
        hk, eng.query, texts, day_slice(pts, 2, 4), "lifecycle archived", device,
        partials=eng.query_partials)
    fused_a = count(counts)
    busy_archived = busy_ms(eng.query, texts, device)
    t1 = time.perf_counter()
    for name in moved:
        lifecycle.restore_segment(root / "archive", db, name)
    restore_ms = (time.perf_counter() - t1) * 1e3
    back, back_ms, counts = life_step(hk, eng.query, texts, pts, "lifecycle restored",
                                      device, before=first, partials=eng.query_partials)
    fused_r = count(counts)
    step("archive", t0, archived=moved, archived_bytes=tree_bytes(root / "archive"),
         migrate_ms=archive_ms, restore_ms=restore_ms,
         query_ms=[first_ms, after_ms, back_ms],
         fused_group_multi=[fused, fused_a, fused_r],
         busy_ms=[busy_archived, busy_ms(eng.query, texts, device)])

    # 2. offline format migration into a fresh root
    t0 = time.perf_counter()
    info = migration.analyze(live)
    check(len(info["parts"]) == parts
          and all(p.get("version") == 1 for p in info["parts"]),
          f"migration: analyze {info['parts'][:2]}")
    plan = migration.plan(live, target_version=2)
    check(len(plan["rewrite"]) == parts, f"migration: plan rewrites {len(plan['rewrite'])}")
    out = migration.copy(live, root / "copy", plan)
    ver = migration.verify(live, root / "copy")
    check(ver["ok"] and ver["checked"] == parts, f"migration: verify {ver}")
    copy_ms = (time.perf_counter() - t0) * 1e3
    eng2 = engine(root / "copy")
    _, copied_ms, counts = life_step(hk, eng2.query, texts, pts, "migration copy", device,
                                     before=first, partials=eng2.query_partials)
    fused = count(counts)
    step("format", t0, rewritten=out["rewritten_parts"], copied_files=out["copied_files"],
         copied_bytes=tree_bytes(root / "copy"), copy_verify_ms=copy_ms,
         query_ms=copied_ms, fused_group_multi=fused,
         busy_ms=busy_ms(eng2.query, texts, device))
    eng2.close()

    # 3. backup and restore
    t0 = time.perf_counter()
    remote = backup.LocalDirFS(root / "backups")
    stamp = backup.backup(live, remote, flush=eng.flush)
    check(backup.list_backups(remote) == [stamp], "backup: list_backups")
    files = backup.restore(remote, stamp, root / "restored")
    eng3 = engine(root / "restored")
    _, restored_ms, counts = life_step(hk, eng3.query, texts, pts, "backup restored",
                                       device, before=first, partials=eng3.query_partials)
    fused = count(counts)
    try:
        backup.restore(remote, stamp, live)
        check(False, "backup: restore into a live root was not refused")
    except FileExistsError:
        pass
    step("backup", t0, time_dir=stamp, files=files,
         backed_up_bytes=tree_bytes(root / "backups"), query_ms=restored_ms,
         fused_group_multi=fused, busy_ms=busy_ms(eng3.query, texts, device))
    eng3.close()
    eng.close()

    # 4. hot -> warm tier migration
    t0 = time.perf_counter()
    tpts = life_points(TIER_N, 2, SEED + 6)
    transport, infos, nodes = LocalTransport(), [], {}
    for name in ("hot", "warm", "liaison"):
        reg = engine_registry(str(root / "tier" / name), stages=("hot", "warm"),
                              schema_dir="")
        if name != "liaison":
            nodes[name] = DataNode(name, reg, root / "tier" / name / "data",
                                   device=device)
            infos.append(NodeInfo(name, transport.register(name, nodes[name].bus),
                                  stages=(name,)))
    liaison = Liaison(reg, transport, infos)
    try:
        hot = nodes["hot"]
        write_batches(hot.measure, tpts, TIER_N)
        sync = SyncBytes(transport)
        t1 = time.perf_counter()
        stats = TierMigrator(hot, sync, infos[1].addr).run(LIFE_T0 + DAY_MS)
        ship_ms = (time.perf_counter() - t1) * 1e3
        check(stats["shipped_parts"] == 2
              and stats["migrated_segments"] == ["measure/sw/seg-20231114"],
              f"tier: {stats}")
        check(all(s.start != LIFE_T0 for s in hot.measure._tsdbs[ENGINE_GROUP].segments),
              "tier: the hot node still holds day 1")
        ttexts = life_queries(2, ("topn", "count", "sum"))
        tier = {}
        for stages, lo, hi in ((("warm",), 0, 1), (("hot",), 1, 2), ((), 0, 2)):
            ask = lambda req, st=stages: liaison.query_measure(  # noqa: E731
                dataclasses.replace(req, stages=st))
            # a single stage's answer is one node's: hold its partials too
            own = nodes[stages[0]].measure.query_partials if stages else None
            _res, ms, counts = life_step(hk, ask, ttexts, day_slice(tpts, lo, hi),
                                         f"tier stages={stages}", device, partials=own)
            tier["/".join(stages) or "all"] = [ms, count(counts, into=tier_counts)]
        busy = busy_ms(lambda req: liaison.query_measure(
            dataclasses.replace(req, stages=("warm",))), ttexts, device)
        again = TierMigrator(hot, transport, infos[1].addr).run(LIFE_T0 + DAY_MS)
        check(again["shipped_parts"] == 0, f"tier: second run shipped {again}")
        step("tier", t0, shipped_parts=stats["shipped_parts"], shipped_bytes=sync.bytes,
             ship_ms=ship_ms, migrated=stats["migrated_segments"], queries=tier,
             busy_ms=busy, second_run_shipped=again["shipped_parts"])
    finally:
        close_nodes(nodes.values())

    # 5. MCP over step 1's root
    t0 = time.perf_counter()
    mcp = McpServer(live, device=device)
    clear_serving_caches()
    hk.reset_launches()
    replies = [mcp.handle({"jsonrpc": "2.0", "id": i, "method": m, "params": p})
               for i, (m, p) in enumerate([
                   ("initialize", {}), ("tools/list", {}),
                   ("tools/call", {"name": "execute_bydbql",
                                   "arguments": {"query": texts["topn"]}})])]
    fused = count(dict(hk.LAUNCHES))
    check(all("result" in r for r in replies), f"mcp: {replies}")
    got = json.loads(replies[2]["result"]["content"][0]["text"])["result"]
    want = result_doc(first["topn"])
    check(got["groups"] == want["groups"] and got["values"] == want["values"],
          "mcp: execute_bydbql TOP 10 differs from step 1's")
    if device == "cuda":
        check(fused > 0, "mcp: fused_group_multi not launched")
    mcp.measure.close()
    mcp.stream.close()
    step("mcp", t0, tools=len(replies[1]["result"]["tools"]), fused_group_multi=fused)

    return launches, tier_counts, fig


def find_spans(tree: dict, name: str) -> list:
    out = [tree] if tree.get("name") == name else []
    for c in tree.get("children", ()):
        out += find_spans(c, name)
    return out


class SyncBytes:
    """The liaison's transport, counting the part bytes that ride the
    sync topic (whole-part bundles and 1 MiB chunks, base64 decoded)."""

    def __init__(self, inner):
        self.inner = inner
        self.bytes = 0

    def call(self, addr, topic, envelope, timeout=30.0):
        if topic == "sync-part":
            blobs = list((envelope.get("files") or {}).values())
            if envelope.get("data"):
                blobs.append(envelope["data"])
            self.bytes += sum(len(b) * 3 // 4 - b[-2:].count("=") for b in blobs)
        return self.inner.call(addr, topic, envelope, timeout=timeout)

    def __getattr__(self, name):
        return getattr(self.inner, name)


# -- phase 17: the network surface -----------------------------------------------

WIRE_N = 1 << 20  # tests/test_torch_cuda.py and the slow CPU test
# the smoke's own depth: the wire ingests a few thousand points a second
# (one WriteRequest per point, the reference's stream), so 1,048,576
# points would take minutes of the smoke's time limit
WIRE_SMOKE_N = 1 << 16
WIRE_ENVELOPE = 1 << 16  # WriteRequests per MeasureService/Write stream


def wire_queries(n: int) -> dict:
    """BydbQL of the phase: the TOP 10 services by mean latency and the
    p50/p99 latency of each service, both over region != 'r3'.  The mean
    of a FLOAT field reduces on the host in f64 (``measure_exec``'s
    host_f64 path, as in the JAX package): only the percentiles launch
    the group kernel."""
    span = f"TIME BETWEEN {T0} AND {T0 + n - 1}"
    frm = f"FROM MEASURE service_resp_time IN {ENGINE_GROUP} {span}"
    where = "WHERE region != 'r3' GROUP BY svc"
    return {
        "topn": f"SELECT mean(latency) {frm} {where} TOP 10 BY latency",
        "percentile": f"SELECT percentile(latency, 0.5, 0.99) {frm} {where} LIMIT {N_SVC}",
    }


def wire_stub(chan, service: str, method: str, req_cls, resp_cls, stream=False):
    kind = chan.stream_stream if stream else chan.unary_unary
    return kind(f"/{service}/{method}", request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString)


def wire_schema(chan) -> None:
    """Group ``sw`` (2 shards, day segments) and the measure, through the
    reference-proto registry services."""
    from banyandb_tpu_torch.api import pb

    rpc = pb.database_rpc_pb2
    g = rpc.GroupRegistryServiceCreateRequest()
    g.group.metadata.name = ENGINE_GROUP
    g.group.catalog = 2  # CATALOG_MEASURE
    opts = g.group.resource_opts
    opts.shard_num = 2
    opts.segment_interval.unit, opts.segment_interval.num = 2, 1  # 1 day
    # the points are stamped from T0 (2023-11-14) and the server's
    # retention sweep (every 60 s, against the wall clock) would drop
    # them mid-ingest under the default 7-day TTL: keep ten years
    opts.ttl.unit, opts.ttl.num = 2, 3650
    wire_stub(chan, "banyandb.database.v1.GroupRegistryService", "Create",
              rpc.GroupRegistryServiceCreateRequest,
              rpc.GroupRegistryServiceCreateResponse)(g)
    m = rpc.MeasureRegistryServiceCreateRequest()
    m.measure.metadata.group, m.measure.metadata.name = ENGINE_GROUP, "service_resp_time"
    fam = m.measure.tag_families.add(name="default")
    fam.tags.add(name="svc", type=1)  # TAG_TYPE_STRING
    fam.tags.add(name="region", type=1)
    m.measure.fields.add(name="latency", field_type=4)  # FIELD_TYPE_FLOAT
    m.measure.fields.add(name="calls", field_type=2)  # FIELD_TYPE_INT
    m.measure.entity.tag_names.extend(["svc", "region"])
    wire_stub(chan, "banyandb.database.v1.MeasureRegistryService", "Create",
              rpc.MeasureRegistryServiceCreateRequest,
              rpc.MeasureRegistryServiceCreateResponse)(m)


def wire_envelope(pts: dict, lo: int, hi: int) -> list:
    """Points lo..hi as MeasureService/Write requests, one data point
    each (the reference's write stream)."""
    from banyandb_tpu_torch.api import pb

    out = []
    for i in range(lo, hi):
        w = pb.measure_write_pb2.WriteRequest()
        w.metadata.group, w.metadata.name = ENGINE_GROUP, "service_resp_time"
        w.message_id = i + 1
        dp = w.data_point
        ts = int(pts["ts"][i])
        dp.timestamp.seconds, dp.timestamp.nanos = ts // 1000, (ts % 1000) * 1_000_000
        fam = dp.tag_families.add()
        fam.tags.add().str.value = f"svc-{pts['svc'][i]}"
        fam.tags.add().str.value = f"r{pts['region'][i]}"
        dp.fields.add().float.value = float(pts["latency"][i])
        dp.fields.add().int.value = int(pts["calls"][i])
        dp.version = 1
        out.append(w)
    return out


def wire_write(chan, pts: dict, n: int) -> float:
    """The points through `chan`'s MeasureService/Write, one stream per
    WIRE_ENVELOPE points, every reply checked.  -> seconds in the
    streams."""
    from banyandb_tpu_torch.api import pb

    write = wire_stub(chan, "banyandb.measure.v1.MeasureService", "Write",
                      pb.measure_write_pb2.WriteRequest,
                      pb.measure_write_pb2.WriteResponse, stream=True)
    spent = 0.0
    for lo in range(0, n, WIRE_ENVELOPE):
        reqs = wire_envelope(pts, lo, min(lo + WIRE_ENVELOPE, n))
        t0 = time.perf_counter()
        resps = list(write(iter(reqs)))
        spent += time.perf_counter() - t0
        bad = [r.status for r in resps if r.status != "STATUS_SUCCEED"]
        check(len(resps) == len(reqs) and not bad,
              f"wire write [{lo}, {lo + len(reqs)}): {len(resps)} replies, {bad[:3]}")
    return spent


def wire_topn_request(n: int):
    """The TOP 10 as the reference's MeasureService/Query request (the
    shape SkyWalking's OAP sends): mean(latency) by svc, region != r3."""
    from banyandb_tpu_torch.api import pb

    q = pb.measure_query_pb2.QueryRequest(groups=[ENGINE_GROUP], name="service_resp_time")
    q.time_range.begin.seconds, q.time_range.begin.nanos = T0 // 1000, (T0 % 1000) * 1_000_000
    end = T0 + n
    q.time_range.end.seconds, q.time_range.end.nanos = end // 1000, (end % 1000) * 1_000_000
    q.group_by.tag_projection.tag_families.add(name="default").tags.append("svc")
    q.tag_projection.tag_families.add(name="default").tags.append("svc")
    q.field_projection.names.append("latency")
    q.agg.function, q.agg.field_name = 1, "latency"  # AGGREGATION_FUNCTION_MEAN
    q.top.number, q.top.field_name, q.top.field_value_sort = 10, "latency", 1  # DESC
    c = q.criteria.condition
    c.name, c.op = "region", 2  # BINARY_OP_NE
    c.value.str.value = "r3"
    return q


def wire_rows(resp) -> list:
    """A measure QueryResponse (or a BydbQL one's measure_result) ->
    [(svc, {field name: value})] in reply order."""
    out = []
    for dp in resp.data_points:
        svc = dp.tag_families[0].tags[0].value.str.value
        vals = {}
        for f in dp.fields:
            kind = f.value.WhichOneof("value")
            v = getattr(f.value, kind)
            vals[f.name] = list(v.value) if kind.endswith("_array") else v.value
        out.append((svc, vals))
    return out


def wire_writer(addr: str, n: str, seed: str) -> int:
    """A writer process of phase 17: the measure configuration's points
    (`seed`) through `addr`'s MeasureService/Write, one stream per
    WIRE_ENVELOPE points; prints {"stream_s": seconds in the streams}.
    A process of its own, so that the server's handler and the client
    do not share one interpreter."""
    import grpc

    chan = grpc.insecure_channel(addr)
    try:
        spent = wire_write(chan, make_points(int(n), int(seed)), int(n))
    finally:
        chan.close()
    print(json.dumps({"stream_s": spent}), flush=True)
    return 0


def spawn_writer(addr: str, n: int, seed: int):
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--wire-writer", addr, str(n), str(seed)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def reap_writer(proc, what: str) -> float:
    out, _ = proc.communicate(timeout=3600)
    if proc.returncode != 0:
        log(out[-4000:])
    check(proc.returncode == 0, f"{what}: writer exited {proc.returncode}")
    return json.loads(out.strip().splitlines()[-1])["stream_s"]


def wire_path(hk, n: int, device: str, root: str, peer=None) -> tuple:
    """Phase 17: StandaloneServer on `device` with its gRPC bus, the
    banyandb.*.v1 wire services and the HTTP gateway on free ports.  A
    writer process sends the measure configuration's n points through
    MeasureService/Write streams of WIRE_ENVELOPE; then the TOP 10 and
    p50/p99 queries are asked over BydbQLService/Query, the TOP 10 also
    over MeasureService/Query, each over the HTTP gateway's
    /bydbql/query and over the bus's ``bydbql`` topic, each with cold
    serving caches (so each scans).  Every surface must give the same
    groups and values, and the bus's answer must agree with numpy.
    `peer` ({"wire": host:port, "bus": host:port} of another server,
    e.g. the JAX package's) gets the same schema, writes (its own
    writer process, at the same time) and questions over its wire, and
    its replies are returned for the caller to compare.  -> (launches of
    the asks, figures, {(query, surface): reply}, {query: peer's wire
    reply})."""
    import urllib.request

    import grpc
    from google.protobuf import json_format

    from banyandb_tpu_torch.api import pb
    from banyandb_tpu_torch.cluster.rpc import GrpcTransport
    from banyandb_tpu_torch.server import StandaloneServer

    seed = SEED + 5
    fig: dict = {"points": n, "envelope_points": WIRE_ENVELOPE}
    t0 = time.perf_counter()
    srv = StandaloneServer(root, port=0, wire_port=0, http_port=0, device=device)
    srv.start()
    fig["start_s"] = time.perf_counter() - t0
    addr = f"127.0.0.1:{srv.wire.port}"
    chans = [grpc.insecure_channel(addr)]
    if peer is not None:
        chans.append(grpc.insecure_channel(peer["wire"]))
    transport = GrpcTransport()
    answers, peer_answers = {}, {}
    try:
        for c in chans:
            wire_schema(c)
        t1 = time.perf_counter()
        writers = [spawn_writer(a, n, seed) for a in [addr] + ([peer["wire"]] if peer else [])]
        spent = [reap_writer(w, "wire") for w in writers]
        fig["ingest_wall_s"] = time.perf_counter() - t1
        fig["ingest_s"] = spent[0]
        fig["ingest_points_per_s"] = n / spent[0]
        t1 = time.perf_counter()
        transport.call(srv.addr, "snapshot", {})
        fig["snapshot_s"] = time.perf_counter() - t1
        if peer is not None:
            transport.call(peer["bus"], "snapshot", {})
        log(f"  wrote {n} points in {len(range(0, n, WIRE_ENVELOPE))} MeasureService/Write "
            f"streams: {spent[0]!r} s ({fig['ingest_points_per_s']!r} points/s), "
            f"snapshot {fig['snapshot_s']!r} s")
        pts = make_points(n, seed)
        ql_stub = [wire_stub(c, "banyandb.bydbql.v1.BydbQLService", "Query",
                             pb.bydbql_query_pb2.QueryRequest,
                             pb.bydbql_query_pb2.QueryResponse) for c in chans]
        q_stub = [wire_stub(c, "banyandb.measure.v1.MeasureService", "Query",
                            pb.measure_query_pb2.QueryRequest,
                            pb.measure_query_pb2.QueryResponse) for c in chans]
        http = f"http://127.0.0.1:{srv.http.port}/api/v1/bydbql/query"

        def post(ql):
            req = urllib.request.Request(http, data=json.dumps({"query": ql}).encode(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=600) as r:
                return json.loads(r.read())

        asks = {}
        for name, ql in wire_queries(n).items():
            asks[(name, "wire_ql")] = lambda ql=ql: ql_stub[0](
                pb.bydbql_query_pb2.QueryRequest(query=ql), timeout=600)
            if name == "topn":
                asks[(name, "wire_query")] = lambda: q_stub[0](wire_topn_request(n), timeout=600)
            asks[(name, "http")] = lambda ql=ql: post(ql)
            asks[(name, "bus")] = lambda ql=ql: transport.call(
                srv.addr, "bydbql", {"ql": ql}, timeout=600)
            if peer is not None:
                peer_answers[name] = ql_stub[1](pb.bydbql_query_pb2.QueryRequest(query=ql),
                                                timeout=600)
                if name == "topn":
                    peer_answers["topn_query"] = q_stub[1](wire_topn_request(n), timeout=600)
        hk.reset_launches()
        fig["asks"] = {}
        for key, ask in asks.items():
            clear_serving_caches()  # each ask scans
            before = dict(hk.LAUNCHES)
            t1 = time.perf_counter()
            answers[key] = ask()
            wall = time.perf_counter() - t1
            row = {"wall_s": wall, "fused_group_multi":
                   hk.LAUNCHES["fused_group_multi"] - before["fused_group_multi"]}
            fig["asks"]["/".join(key)] = row
            log(f"  {'/'.join(key)}: {wall!r} s, fused_group_multi launches "
                f"{row['fused_group_multi']}")
        launches = dict(hk.LAUNCHES)
    finally:
        transport.close()
        for c in chans:
            c.close()
        srv.stop()

    # every surface: the same groups and values, the bus's against numpy
    for name in wire_queries(n):
        bus = answers[(name, "bus")]["result"]
        res = dataclasses.make_dataclass("R", ["groups", "values"])(
            [tuple(g) for g in bus["groups"]], bus["values"])
        cluster_oracle(pts, "fallback_ne" if name == "topn" else name, res,
                       keep=pts["region"] != 3, what=f"wire {name}")
        rows = wire_rows(answers[(name, "wire_ql")].measure_result)
        check([s for s, _ in rows] == [g[0] for g in res.groups],
              f"wire {name}: BydbQL groups differ from the bus's")
        # a percentile row's quantiles are fields latency, latency[1]
        if name == "topn":
            got, want = [v["latency"] for _, v in rows], res.values["mean(latency)"]
        else:
            got = [[v["latency"], v["latency[1]"]] for _, v in rows]
            want = res.values["percentile(latency)"]
        check(got == list(want), f"wire {name}: BydbQL values differ from the bus's")
        http_doc = answers[(name, "http")]
        check(http_doc == json_format.MessageToDict(
            answers[(name, "wire_ql")], preserving_proto_field_name=True),
            f"wire {name}: the HTTP gateway's JSON differs from the wire reply")
        if name == "topn":
            got = wire_rows(answers[(name, "wire_query")])
            check(got == rows, f"wire topn: MeasureService/Query differs from BydbQL: "
                               f"{got[:2]} vs {rows[:2]}")
    log("  ok  wire: BydbQL, MeasureService/Query, HTTP and the bus agree, and with numpy")
    return launches, fig, answers, peer_answers


def wire_child(root: str, out_path: str, n: str, device: str) -> int:
    """The process of phase 17 (run by wire_phase): wire_path on `device`,
    its launches and figures written to `out_path` as JSON.  A process
    of its own, so that the smoke's own process never loads grpc or
    protobuf (main checks that after phase 16)."""
    from banyandb_tpu_torch.ops import hopper_kernels as hk

    if device == "cuda":
        hk.build()  # loads the library the parent built
    launches, fig, _, _ = wire_path(hk, int(n), device, root)
    with open(out_path, "w") as f:
        json.dump({"launches": launches, "fig": fig}, f)
    return 0


def wire_phase(root: str, n: int, device: str = "cuda") -> tuple:
    """Phase 17 in a child process.  -> (its launches, its figures)."""
    out_path = os.path.join(root, "wire.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--wire-child",
         os.path.join(root, "srv"), out_path, str(n), device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=900,
    )
    for line in proc.stdout.splitlines():
        log(line)
    check(proc.returncode == 0, f"wire child exited {proc.returncode}")
    with open(out_path) as f:
        doc = json.load(f)
    doc["fig"]["process_s"] = time.perf_counter() - t0
    return doc["launches"], doc["fig"]


# -- phase 18: the cluster's gRPC half, in child processes ----------------------

GRPC_N = CLUSTER_N
GRPC_NODES = 2
# data-node children scan with cold serving caches: a zero budget serves
# every decoded part, gather and partials uncached (storage/cache.py)
GRPC_NODE_ENV = {"BYDB_SERVING_CACHE_BYTES": "0", "BYDB_DEVICE_CACHE_BYTES": "0"}


def grpc_queries(n: int) -> dict:
    """name -> BydbQL: phase 10's asks, and p50/p99 without region r3."""
    out = {name: ql for name, (ql, _mesh) in cluster_queries(n).items()}
    span = f"TIME BETWEEN {T0} AND {T0 + n - 1}"
    out["percentile_ne"] = (
        f"SELECT percentile(latency, 0.5, 0.99) FROM MEASURE service_resp_time "
        f"IN {ENGINE_GROUP} {span} WHERE region != 'r3' GROUP BY svc LIMIT {N_SVC}")
    return out


def grpc_same(got: dict, want: dict, what: str) -> None:
    """Two answers (result_doc) under the precision contract: the same
    groups in the same order; counts, min/max and integer sums exact;
    latency means, sums and percentiles within RTOL."""
    check(got["groups"] == want["groups"], f"{what}: groups differ")
    check(sorted(got["values"]) == sorted(want["values"]), f"{what}: value keys differ")
    for key, vals in want["values"].items():
        if "latency" in key:
            ok = np.allclose(np.asarray(got["values"][key], np.float64),
                             np.asarray(vals, np.float64), rtol=RTOL, atol=0.0)
        else:
            ok = got["values"][key] == vals
        check(ok, f"{what}: {key} differs")


def node_kernel_gauges(transport, addr: str) -> dict:
    """A data node's ``metrics`` topic, read over the gRPC bus: its own
    kernel launches and its kernel-library build cache."""
    from banyandb_tpu_torch.obs import prom
    from banyandb_tpu_torch.ops import hopper_kernels as hk

    text = transport.call(addr, "metrics", {}, timeout=30.0)["prometheus"]
    out = {"launches": dict.fromkeys(hk.LAUNCHES, 0)}
    for name, lbls, value in prom.parse_exposition(text):
        if name == "banyandb_kernel_launches":
            out["launches"][lbls["kernel"]] = int(value)
        elif name in ("banyandb_compile_cache_builds", "banyandb_compile_cache_loads"):
            out[name[len("banyandb_compile_cache_"):]] = int(value)
    return out


def grpc_liaison_child(root: str, nodes_path: str, out_path: str, n: str) -> int:
    """The liaison process of phase 18 (run by grpc_phase): a
    ``LiaisonServer`` over the data nodes that `nodes_path` lists.  The
    measure configuration's n points go through
    ``Liaison.enable_write_queue`` (sealed parts, streaming chunked sync),
    then each BydbQL ask of grpc_queries once; the data nodes' launches
    are read from their ``metrics`` topic before and after the asks.
    Writes its figures and answers to `out_path` as JSON."""
    from banyandb_tpu_torch import bydbql
    from banyandb_tpu_torch.api import WriteRequest
    from banyandb_tpu_torch.cluster_server import LiaisonServer
    from banyandb_tpu_torch.obs.metrics import global_meter

    def shipped_now() -> dict:
        counters = global_meter().snapshot()["counters"]
        return {"parts": counters.get(("wqueue_shipped", ()), 0.0),
                "bytes": counters.get(("wqueue_shipped_bytes", ()), 0.0)}

    n = int(n)
    shipped0 = shipped_now()
    srv = LiaisonServer(os.path.join(root, "liaison"), nodes_path, port=0).start()
    try:
        names = sorted(node.name for node in srv.liaison.selector.nodes)
        check(sorted(srv.liaison.alive) == names, f"liaison sees {srv.liaison.alive} of {names}")
        engine_schema(srv.registry, shard_num=4)  # pushed to every data node
        wq = srv.liaison.enable_write_queue(os.path.join(root, "wqueue"))
        pts = make_points(n, SEED + 2)
        build_s = 0.0
        t0 = time.perf_counter()
        for lo in range(0, n, CLUSTER_BATCH):
            hi = min(n, lo + CLUSTER_BATCH)
            t1 = time.perf_counter()
            batch = measure_batch(pts, lo, hi)
            build_s += time.perf_counter() - t1
            check(srv.liaison.write_measure_queued(
                WriteRequest(ENGINE_GROUP, "service_resp_time", batch)) == hi - lo,
                "grpc cluster: write not accepted")
        append_s = time.perf_counter() - t0 - build_s
        # a flush waits for a background pass in progress, so the check
        # after it sees every part sealed so far, delivered or pending
        deadline = time.monotonic() + 600
        wq.flush(force=True)
        while wq.pending_parts() or wq.buffered_rows():
            check(time.monotonic() < deadline, "grpc cluster: the write queue never drained")
            wq.flush(force=True)
        ingest_s = time.perf_counter() - t0 - build_s
        wq.stop()
        shipped = {k: int(v - shipped0[k]) for k, v in shipped_now().items()}
        addrs = {node.name: node.addr for node in srv.liaison.selector.nodes}
        before = {name: node_kernel_gauges(srv.transport, a) for name, a in addrs.items()}
        answers, walls = {}, {}
        for name, ql in grpc_queries(n).items():
            req = bydbql.parse(ql)
            t1 = time.perf_counter()
            res = srv.liaison.query_measure(req)
            walls[name] = (time.perf_counter() - t1) * 1e3
            answers[name] = result_doc(res)
            log(f"  grpc {name}: wall ms {walls[name]!r}")
        after = {name: node_kernel_gauges(srv.transport, a) for name, a in addrs.items()}
    finally:
        srv.stop()
    with open(out_path, "w") as f:
        json.dump({
            "ingest_s": ingest_s, "append_s": append_s, "build_s": build_s,
            "shipped": shipped, "walls": walls, "answers": answers,
            "before": before, "after": after,
        }, f)
    return 0


def wait_banner(proc, log_path: str, what: str, timeout_s: float = 300.0) -> list:
    """Poll a child's log until it prints its ``device:`` line (after
    its listening banner); -> the log's lines.  Fails when the child
    exits or the deadline passes first."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        with open(log_path, errors="replace") as f:
            lines = f.read().splitlines()
        if any(ln.startswith("device: ") for ln in lines):
            return lines
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    with open(log_path, errors="replace") as f:
        log(f.read()[-4000:])
    raise Failed(f"{what} printed no banner (exit {proc.poll()})")


def stop_children(procs: list) -> list:
    """SIGTERM every child, then reap each within a minute (a child
    still running then is killed); -> their exit codes."""
    import signal

    for proc in procs:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
    codes = []
    for proc in procs:
        try:
            codes.append(proc.wait(timeout=60))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)
            codes.append(None)
    return codes


def grpc_phase(hk, root: str, n: int, device: str = "cuda", want=None) -> tuple:
    """Phase 18: GRPC_NODES ``python -m banyandb_tpu_torch.server --role
    data`` processes on `device` (sharing the card and the kernel library
    this process built: ``hopper_kernels.provide`` into their build
    cache, so each loads it and builds nothing) and one liaison process
    (grpc_liaison_child) that ingests through the write queue and
    streaming chunked sync and asks over the gRPC bus.  Each answer is
    held against numpy and, where phase 10 asked the same (`want`: name
    -> result_doc of its host combine), against phase 10's.  -> (the
    data nodes' launches during the asks, summed; the figures)."""
    here = os.path.dirname(os.path.abspath(__file__))
    cc = os.path.join(root, "compile-cache")
    if device == "cuda":
        hk.provide(cc)
    env = dict(os.environ, **GRPC_NODE_ENV)
    env["PYTHONPATH"] = os.pathsep.join(
        [here] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs, nodes = [], []
    t0 = time.perf_counter()
    try:
        for i in range(GRPC_NODES):
            log_path = os.path.join(root, f"data-{i}.log")
            with open(log_path, "w") as logf:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "banyandb_tpu_torch.server", "--role", "data",
                     "--root", os.path.join(root, f"n{i}"), "--name", f"data-{i}",
                     "--port", "0", "--device", device, "--compile-cache-dir", cc],
                    stdout=logf, stderr=subprocess.STDOUT, env=env, cwd=here,
                ))
        for i, proc in enumerate(procs):
            lines = wait_banner(proc, os.path.join(root, f"data-{i}.log"), f"data-{i}")
            banner = next(ln for ln in lines if ln.startswith("banyandb-tpu data node"))
            dev = next(ln for ln in lines if ln.startswith("device: "))[len("device: "):]
            check(dev.startswith(device), f"data-{i} serves on {dev}, not {device}")
            nodes.append({"name": f"data-{i}", "addr": banner.rsplit(" ", 1)[1],
                          "roles": ["data"], "device": dev})
        boot_s = time.perf_counter() - t0
        nodes_path = os.path.join(root, "nodes.json")
        with open(nodes_path, "w") as f:
            json.dump([{k: nd[k] for k in ("name", "addr", "roles")} for nd in nodes], f)
        out_path = os.path.join(root, "grpc.json")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--grpc-liaison-child",
             root, nodes_path, out_path, str(n)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=900,
            cwd=here,
        )
        for line in proc.stdout.splitlines():
            log(line)
        check(proc.returncode == 0, f"grpc liaison child exited {proc.returncode}")
    finally:
        codes = stop_children(procs)
    for i, code in enumerate(codes):
        if code != 0:
            with open(os.path.join(root, f"data-{i}.log"), errors="replace") as f:
                log(f.read()[-4000:])
    check(codes == [0] * len(procs), f"data node exit codes {codes}")
    with open(out_path) as f:
        doc = json.load(f)

    launches = dict.fromkeys(hk.LAUNCHES, 0)
    per_node = {}
    for name, after in doc["after"].items():
        before = doc["before"][name]
        delta = {k: after["launches"][k] - before["launches"][k] for k in launches}
        for k, v in delta.items():
            launches[k] += v
        per_node[name] = {"launches": delta, "builds": after.get("builds"),
                          "loads": after.get("loads")}
        check(after.get("builds") == 0, f"grpc {name}: {after.get('builds')} kernel builds")
        if device == "cuda":
            check(after.get("loads") == 1, f"grpc {name}: {after.get('loads')} library loads")
            check(delta["fused_group_multi"] > 0,
                  f"grpc {name}: fused_group_multi not launched by the asks")
    pts = make_points(n, SEED + 2)
    for name, ans in doc["answers"].items():
        res = doc_ns(ans)
        res.groups = [tuple(g) for g in res.groups]
        if name == "percentile_ne":
            cluster_oracle(pts, "percentile", res, keep=pts["region"] != 3,
                           what=f"grpc {name}")
        else:
            cluster_oracle(pts, name, res, what=f"grpc {name}")
        if want is not None and name in want:
            grpc_same(ans, want[name], f"grpc {name} vs phase 10's host combine")
    log(f"  ok  grpc cluster: {len(doc['answers'])} asks agree with numpy"
        + (" and with phase 10's host combine" if want is not None else "")
        + f"; data nodes' launches {per_node}")
    fig = {
        "points": n,
        "ingest_points_per_s": n / doc["ingest_s"],
        "ingest_s": doc["ingest_s"],
        "append_s": doc["append_s"],
        "build_s": doc["build_s"],
        "parts_shipped": doc["shipped"]["parts"],
        "bytes_shipped": doc["shipped"]["bytes"],
        "query_wall_ms": doc["walls"],
        "nodes": per_node,
        "boot_s": boot_s,
        "phase_s": time.perf_counter() - t0,
    }
    return launches, fig


# -- phase 19: lint and sanitizers ------------------------------------------------

# the second measure's points, written by a thread while the asks run, in
# small envelopes so that the writes overlap the asks
SANITIZE_EXTRA = 1 << 16
SANITIZE_BATCH = 1 << 12
SANITIZE_MEASURE = "service_resp_time_b"
# `python -m banyandb_tpu_torch.lint --check --format json
# banyandb_tpu_torch` with JAX made unimportable first: a machine that
# has JAX installed still proves the gate needs none
GATE_CODE = (
    "import runpy, sys\n"
    "sys.modules['jax'] = None\n"
    "sys.argv = ['banyandb_tpu_torch.lint', '--check', '--format', 'json',\n"
    "            'banyandb_tpu_torch']\n"
    "runpy.run_module('banyandb_tpu_torch.lint', run_name='__main__',\n"
    "                 alter_sys=True)\n"
)


def gate_run(here: str) -> dict:
    """Phase 19 (a): the port's static gate in a fresh process -> its
    wall, and its finding and suppression counts per rule."""
    import importlib.util

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", GATE_CODE], cwd=here, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, timeout=900,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stdout[-4000:] + proc.stderr[-4000:])
    check(proc.returncode == 0, f"lint gate exited {proc.returncode}")
    run = json.loads(proc.stdout)["runs"][0]
    props = run["properties"]
    findings: dict = {}
    for res in run["results"]:
        findings[res["ruleId"]] = findings.get(res["ruleId"], 0) + 1
    return {
        "wall_s": wall,
        "jax_importable": importlib.util.find_spec("jax") is not None,
        "files": props["files"],
        "functions": props["wp_functions"],
        "rules": len(run["tool"]["driver"]["rules"]),
        "findings": findings,
        "suppressed": {**props["suppressed_by_rule"],
                       **props["wp_suppressed_by_rule"]},
        "kernel_signatures": props["kernel_signatures"],
    }


def sanitize_child(root: str, out_path: str, n: str, device: str) -> int:
    """The sanitized server of phase 19 (run by lint_sanitize_phase with
    ``BYDB_SANITIZE=1`` and phase 13's environment): the sanitizers go in
    before the server is imported, then phase 13's configuration and
    asks while a second thread writes into a second measure, then
    ``stop()`` and the lock-order and leak checks.  Writes its answers
    and figures to `out_path` as JSON."""
    import gc
    import threading

    n = int(n)
    from banyandb_tpu_torch import sanitize

    check(sanitize.enabled(), "sanitize child: BYDB_SANITIZE is not on")
    t0 = time.perf_counter()
    sanitize.install()
    install_s = time.perf_counter() - t0
    import torch

    from banyandb_tpu_torch.ops import hopper_kernels as hk
    from banyandb_tpu_torch.query import measure_exec, precompile
    from banyandb_tpu_torch.sanitize import leaks, lockwatch

    if device == "cuda":
        hk.build()  # loads the library the parent built
    # the process-wide handles of the card (its device files, the pinned
    # host pool) open on first use: open them before the leak tracker's
    # snapshot, so that only the server's own threads and fds count
    measure_exec.device_get({"x": torch.ones(8, device=device)})
    tracker = leaks.LeakTracker().snapshot()
    from banyandb_tpu_torch.server import StandaloneServer

    fig: dict = {"points": n, "extra_points": SANITIZE_EXTRA, "install_s": install_s}
    reg = precompile.default_registry()
    srv = StandaloneServer(root, device=device, slow_query_ms=0)
    srv.start()
    check(reg.wait_warm(600), "sanitized server: the warm did not finish")
    handle = srv.bus.handle
    server_schema(handle)
    create_measure(handle, SANITIZE_MEASURE)

    pts = make_points(n, SEED + 1)
    write_s = 0.0
    for lo in range(0, n, SERVER_BATCH):
        env = columns_envelope(pts, lo, min(lo + SERVER_BATCH, n))
        t1 = time.perf_counter()
        reply = handle("measure-write-cols", env)
        write_s += time.perf_counter() - t1
        check(reply == {"written": min(SERVER_BATCH, n - lo)},
              f"sanitized server write: {reply}")
    handle("snapshot", {})
    fig["ingest_s"] = write_s
    fig["ingest_points_per_s"] = n / write_s
    log(f"  sanitized server wrote {n} points in {-(-n // SERVER_BATCH)} envelopes: "
        f"{write_s!r} s ({fig['ingest_points_per_s']!r} points/s)")

    texts = engine_queries(n)
    check(reg.wait_warm(600), "sanitized server: a flush warm did not finish")
    extra = make_points(SANITIZE_EXTRA, SEED + 19)
    errors: list = []

    def writer():
        try:
            for lo in range(0, SANITIZE_EXTRA, SANITIZE_BATCH):
                env = columns_envelope(extra, lo, lo + SANITIZE_BATCH)
                env["name"] = SANITIZE_MEASURE
                reply = handle("measure-write-cols", env)
                if reply != {"written": SANITIZE_BATCH}:
                    errors.append(reply)
        except Exception as e:  # noqa: BLE001 - checked after the join
            errors.append(repr(e))

    hk.reset_launches()
    thread = threading.Thread(target=writer, name="sanitize-writer")
    thread.start()
    walls, docs, served = {}, {}, {}
    for name, ql in texts.items():
        walls[name], served[name] = [], []
        for i in range(3):
            t1 = time.perf_counter()
            reply = handle("bydbql", {"ql": ql})
            walls[name].append((time.perf_counter() - t1) * 1e3)
            served[name].append(reply["served"])
            if i == 0:
                docs[name] = reply["result"]
            else:
                check(json.dumps(reply["result"]) == json.dumps(docs[name]),
                      f"sanitized server {name}: repeat run differs")
    thread.join()
    launches = dict(hk.LAUNCHES)
    check(not errors, f"sanitized server: second-measure writer failed: {errors}")
    span = f"TIME BETWEEN {T0} AND {T0 + SANITIZE_EXTRA - 1}"
    got = handle("bydbql", {"ql": f"SELECT count(calls) FROM MEASURE {SANITIZE_MEASURE} "
                                  f"IN {ENGINE_GROUP} {span}"})
    counted = sum(got["result"]["values"]["count(calls)"])
    check(counted == SANITIZE_EXTRA,
          f"sanitized server: the second measure counts {counted}, wrote {SANITIZE_EXTRA}")
    server_oracle(pts, n, docs, "sanitized server")
    for k in PATH_KERNELS["sanitize"] if device == "cuda" else ():
        check(launches[k] > 0, f"sanitized server: {k} not launched")
    traced = [o for o in gc.get_objects() if type(o) is lockwatch.TracedLock]
    fig["traced_locks"] = len(traced)
    fig["traced_lock_ids"] = len({lk.lock_id for lk in traced})
    srv.stop()
    edges = lockwatch.watch().snapshot_edges()
    undeclared = lockwatch.undeclared_edges(edges)
    report = tracker.check(grace_s=10.0)
    fig.update({
        "walls_ms": walls, "served": served, "runtime_edges": len(edges),
        "declared_edges": len(lockwatch.load_static().declared),
        "undeclared_edges": [f"{w.held} -> {w.acquired} at {w.site} [{w.thread}]"
                             for w in undeclared],
        "leaks": report.render(),
    })
    log(f"  sanitized server: {fig['traced_locks']} traced locks "
        f"({fig['traced_lock_ids']} declarations), {len(edges)} runtime edges, "
        f"{len(undeclared)} undeclared; leaks: {fig['leaks']}")
    for line in fig["undeclared_edges"]:
        log(f"    undeclared: {line}")
    with open(out_path, "w") as f:
        json.dump({"launches": launches, "fig": fig, "docs": docs}, f)
    check(not undeclared, f"sanitized server: {len(undeclared)} undeclared lock edges")
    check(report.clean(), f"sanitized server: {report.render()}")
    return 0


def lint_sanitize_phase(root: str, n: int, device: str, want: dict,
                        server_fig: dict) -> tuple:
    """Phase 19: the static gate and the sanitized server, each in a fresh
    process; `want` and `server_fig` are phase 13's answers and figures.
    -> (the sanitized server's launches over the asks, the figures of
    the {"lint_sanitize": ...} line)."""
    here = os.path.dirname(os.path.abspath(__file__))
    gate = gate_run(here)
    check(not gate["findings"], f"lint gate findings: {gate['findings']}")
    log(f"  ok  lint gate: exit 0 in {gate['wall_s']:.3f} s over {gate['files']} files "
        f"and {gate['functions']} functions, {gate['rules']} rules, JAX importable: "
        f"{gate['jax_importable']}; suppressed {gate['suppressed']}")
    out_path = os.path.join(root, "sanitize.json")
    env = dict(os.environ, BYDB_SANITIZE="1", **SERVER_ENV)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--sanitize-child",
         os.path.join(root, "server"), out_path, str(n), device],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=900,
    )
    child_s = time.perf_counter() - t0
    log("\n".join(proc.stdout.splitlines()[-40:]))
    check(proc.returncode == 0, f"sanitized server child exited {proc.returncode}")
    with open(out_path) as f:
        doc = json.load(f)
    for name in ("topn", "percentile"):
        check(json.dumps(doc["docs"][name]) == json.dumps(want[name]),
              f"sanitized server {name}: differs from phase 13")
    log("  ok  sanitized server: each ask equals phase 13's answer and numpy")
    fig = {
        "gate": gate,
        "child_s": child_s,
        **doc["fig"],
        "phase13": {"ingest_points_per_s": server_fig["ingest_points_per_s"],
                    "walls_ms": server_fig["walls_ms"]},
        "launches": doc["launches"],
    }
    return doc["launches"], fig


# -- phases 20-23: the driver entry point and the operating harnesses ---------

DRYRUN_SLOTS = (4, 8)
SOAK_S = 50.0  # the replay soak's wall, at its defaults (seed 0, 400-point batches)
SOAK_MESH_SLOTS = 4  # the soak's third topology: a 2 x 2 mesh of slots on the card
CHAOS_SEED = 42  # the chaos harness's default seed
CHAOS_BUDGET_S = 4.0  # a chaos query's wall limit (tests/test_chaos.py)
CHAOS_WINDOW_S = 45.0  # a killed worker's degraded window limit
LOAD_S = 45.0
LOAD_RATE = 9_500  # points/s: the reference benchmark's fixed ingest rate


def entry_phase(hk, device: str) -> tuple:
    """Phase 20: ``entry()``'s step on `device` against the same step on
    the CPU (the kernels' plain versions), then ``dryrun_multichip(n)``
    over n slots on `device` for each n of DRYRUN_SLOTS.  -> (the entry
    step's launches, the dryruns' launches, the figures of the
    {"entry": ...} line)."""
    import torch

    from banyandb_tpu_torch import entry
    from banyandb_tpu_torch.query.measure_exec import device_get

    hk.reset_launches()
    step, args = entry.entry(device)
    t0 = time.perf_counter()
    got = device_get(step(*args))
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    device_get(step(*args))
    second_ms = (time.perf_counter() - t0) * 1e3
    entry_launches = dict(hk.LAUNCHES)
    cstep, cargs = entry.entry("cpu")
    want = device_get(cstep(*cargs))
    check(sorted(got) == sorted(want), f"entry: outputs {sorted(got)} != {sorted(want)}")
    exact = [("count", got["count"], want["count"]), ("hist", got["hist"], want["hist"])]
    exact += [(f"{k}[{f}]", got[k][f], want[k][f]) for k in ("mins", "maxs") for f in want[k]]
    for name, a, b in exact:
        check(np.array_equal(a, b), f"entry {name}: the card differs from the CPU")
    err = 0.0
    for f in want["sums"]:
        a, b = np.asarray(got["sums"][f], np.float64), np.asarray(want["sums"][f], np.float64)
        check(np.allclose(a, b, rtol=RTOL, atol=0.0), f"entry sums[{f}]: beyond rtol {RTOL}")
        err = max(err, float(np.abs(a - b).max()))
    log(f"  ok  entry step on {device}: count, min/max and histogram equal the CPU's, "
        f"sums within rtol {RTOL} (max abs err {err!r}); {first_ms:.3f} / "
        f"{second_ms:.3f} ms first / second call; launches {entry_launches}")
    hk.reset_launches()
    dry = {}
    for n in DRYRUN_SLOTS:
        t0 = time.perf_counter()
        dry[n] = entry.dryrun_multichip(n, devices=[device] * n)
        dry[n]["wall_ms"] = (time.perf_counter() - t0) * 1e3
        log(f"  ok  dryrun_multichip({n}) over {n} slots on one device "
            f"{dry[n]['slots']} ({dry[n]['shape']}): count {dry[n]['count']} = host "
            f"union, mesh fast path {dry[n]['cluster']}, {dry[n]['wall_ms']:.1f} ms")
    dryrun_launches = dict(hk.LAUNCHES)
    log(f"  kernel launches over the dryruns: {dryrun_launches}")
    fig = {
        "device": str(torch.device(device)),
        "entry": {"outputs": {k: list(np.shape(v)) for k, v in got.items()
                              if not isinstance(v, dict)},
                  "first_ms": first_ms, "second_ms": second_ms,
                  "sums_max_abs_err": err, "launches": entry_launches},
        "dryrun": {str(n): d for n, d in dry.items()},
        "dryrun_launches": dryrun_launches,
    }
    return entry_launches, dryrun_launches, fig


def soak_phase(hk, device: str, root: str, seconds: float = SOAK_S) -> tuple:
    """Phase 21: the replay soak for `seconds` over three topologies on
    `device`: a standalone engine, a two-node cluster and a 2 x 2 mesh
    of slots on the device.  -> (its launches, the figures of the
    {"soak": ...} line)."""
    from banyandb_tpu_torch.harness import soak

    report = os.path.join(root, "soak-report.jsonl")
    hk.reset_launches()
    t0 = time.perf_counter()
    stats = soak.run_soak(seconds=seconds, seed=0, report_path=report,
                          tmp_root=os.path.join(root, "soak"), device=device,
                          mesh_slots=[device] * SOAK_MESH_SLOTS)
    wall_s = time.perf_counter() - t0
    launches = dict(hk.LAUNCHES)
    text = ""
    if os.path.exists(report):
        with open(report) as f:
            text = f.read()[-4000:]
    check(stats["errors"] == 0, f"soak: {stats['errors']} failed queries\n{text}")
    check(stats["divergences"] == 0, f"soak: {stats['divergences']} divergences\n{text}")
    check(stats["queries"] > 0 and stats["writes"] > 0, f"soak: nothing ran {stats}")
    check(stats["mesh_executions"] > 0, "soak: the mesh topology ran no query")
    log(f"  ok  soak {wall_s:.1f} s: {stats['queries']} queries over 3 topologies, "
        f"{stats['writes']} points written, 0 divergences, 0 errors; mesh step ran "
        f"{stats['mesh_executions']} of them; hand-kernel launches by topology "
        f"{stats['launches']}; {launches}")
    return launches, {"wall_s": wall_s, **stats}


def chaos_phase(hk, device: str, root: str) -> tuple:
    """Phase 22: the chaos harness's five in-process phases with data
    nodes and shard workers on `device`.  -> (this process's launches,
    the figures of the {"chaos": ...} line)."""
    from banyandb_tpu_torch.harness import chaos

    hk.reset_launches()
    t0 = time.perf_counter()
    stats = chaos.run_smoke(root, seed=CHAOS_SEED, device=device)
    wall_s = time.perf_counter() - t0
    launches = dict(hk.LAUNCHES)
    windows = stats["worker_degraded_windows_s"]
    for ok, what in (
        (stats["kill_cycles"] >= 3, "kill_cycles >= 3"),
        (stats["degraded_seen"] >= 1, "degraded_seen >= 1"),
        (stats["faults_injected"] > 0, "faults_injected > 0"),
        (stats["max_query_wall_s"] <= CHAOS_BUDGET_S, f"max_query_wall_s <= {CHAOS_BUDGET_S}"),
        (stats["worker_kill_cycles"] >= 2, "worker_kill_cycles >= 2"),
        (stats["worker_restarts"] >= 2, "worker_restarts >= 2"),
        (max(windows) < CHAOS_WINDOW_S, f"worker degraded windows < {CHAOS_WINDOW_S} s"),
        (stats["rebalance_under_kill"] >= 1, "rebalance_under_kill >= 1"),
        (min(stats["acked_a"], stats["acked_c"], stats["worker_acked"],
             stats["rebalance_acked"]) > 0, "acked writes in every phase"),
    ):
        check(ok, f"chaos: {what} fails: {stats}")
    log(f"  ok  chaos smoke {wall_s:.1f} s: kill_cycles {stats['kill_cycles']}, "
        f"degraded_seen {stats['degraded_seen']}, faults_injected "
        f"{stats['faults_injected']} {stats['fault_sites']}, max_query_wall_s "
        f"{stats['max_query_wall_s']!r}, worker_kill_cycles {stats['worker_kill_cycles']} "
        f"(degraded windows {windows} s), rebalance parts moved "
        f"{stats['rebalance_parts_moved']}; zero acked loss (acked "
        f"{stats['acked_a']}/{stats['acked_c']}/{stats['worker_acked']}/"
        f"{stats['rebalance_acked']}); launches here {launches}")
    return launches, {"wall_s": wall_s, **stats}


def load_phase(hk, device: str, root: str, seconds: float = LOAD_S) -> tuple:
    """Phase 23: ``run_load`` on `device` for `seconds` (2 writers, 4
    queriers, batches of 500, LOAD_RATE points/s), then the server
    reopened over its root: a count over the whole window, from the
    materialized windows and from a rescan, equals the acked points.
    -> (its launches, the figures of the {"load": ...} line)."""
    from banyandb_tpu_torch.harness import env_scope, load
    from banyandb_tpu_torch.server import TOPIC_QL, StandaloneServer

    data = os.path.join(root, "server")
    hk.reset_launches()
    stats = load.run_load(seconds=seconds, writers=2, queriers=4, batch=500, seed=0,
                          write_rate=LOAD_RATE, tmp_root=data, device=device)
    launches = dict(hk.LAUNCHES)
    check(stats["write_errors"] == 0, f"load: {stats['write_errors']} write errors")
    check(stats["query_errors"] == 0, f"load: {stats['query_errors']} query errors")
    check(stats["queries"] > 0 and stats["points_written"] > 0, f"load: nothing ran {stats}")
    ql = (f"SELECT count(value) FROM MEASURE {load.MEASURE} IN {load.GROUP} "
          f"TIME BETWEEN {load.T0} AND {load.T0 + (1 << 40)}")
    srv = StandaloneServer(data, device=device)
    srv.start()
    counts = {}
    try:
        for label, flag in (("materialized", "1"), ("rescan", "0")):
            with env_scope({"BYDB_STREAMAGG": flag}):
                r = srv.bus.handle(TOPIC_QL, {"ql": ql})
            counts[label] = {"count": int(sum(r["result"]["values"].get("count", ()))),
                             "served": r.get("served")}
    finally:
        srv.stop()
    for label, c in counts.items():
        check(c["count"] == stats["points_written"],
              f"load: the {label} count {c['count']} != {stats['points_written']} acked")
    fig = {"cores": os.cpu_count(), **stats, "count_back": counts}
    log(f"  ok  load {stats['seconds']} s on {os.cpu_count()} cores: "
        f"{stats['points_written']} points ({stats['write_points_per_min']} a minute), "
        f"{stats['queries']} queries p50/p90/p99 {stats['latency_ms']} ms, served "
        f"{stats['served']}, 0 errors; every acked point counted back {counts}; "
        f"launches {launches}")
    return launches, fig


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--warm-child"]:  # one process of phase 11
        return warm_child(*sys.argv[2:])
    if sys.argv[1:2] == ["--audit-child"]:  # the process of phase 12
        return audit_child(*sys.argv[2:])
    if sys.argv[1:2] == ["--wire-writer"]:  # a client process of phase 17
        return wire_writer(*sys.argv[2:])
    if sys.argv[1:2] == ["--wire-child"]:  # the process of phase 17
        return wire_child(*sys.argv[2:])
    if sys.argv[1:2] == ["--grpc-liaison-child"]:  # the liaison of phase 18
        return grpc_liaison_child(*sys.argv[2:])
    if sys.argv[1:2] == ["--sanitize-child"]:  # the sanitized server of phase 19
        return sanitize_child(*sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from banyandb_tpu_torch.ops import hopper_kernels as hk
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2

    # no background plan warming beside phases 1-10 (phase 11's children
    # turn the registry on)
    os.environ.setdefault("BYDB_PRECOMPILE", "0")
    t_start = time.perf_counter()

    def phase(msg: str) -> None:
        log(f"{msg} (at {time.perf_counter() - t_start:.1f} s)")

    card = card_line()
    log(f"[1] card: {card}")
    log(
        f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}"
    )
    build_s = hk.build()
    phase(f"[2] build: {build_s:.3f} s")
    for line in hk.build_log.splitlines():
        if "registers" in line or "bytes stack" in line or line.startswith("=="):
            log(f"    {line.strip()}")
    phase("[3] kernels against their plain versions")
    rows = kernel_phase(hk)
    paths = {}
    with tempfile.TemporaryDirectory(prefix="bydb-smoke-") as root:
        phase(f"[4] executor path: {N_POINTS} points")
        paths["executor"], parts = main_path(
            hk, N_POINTS, "cuda", os.path.join(root, "parts")
        )
        phase("[5] decode path")
        paths["decode"] = decode_path(hk, parts[0], "cuda")
    # phase 6's data stays until phase 11's children have read it
    engine_dir = tempfile.TemporaryDirectory(prefix="bydb-smoke-engine-")
    engine_root = engine_dir.name
    phase(f"[6] engine path: {N_POINTS} points through MeasureEngine and BydbQL")
    paths["engine"], engine_card = engine_path(hk, N_POINTS, "cuda", engine_root)
    phase("[7] determinism of the scatter and sort group reduce")
    determinism_phase()
    with tempfile.TemporaryDirectory(prefix="bydb-smoke-stream-") as root:
        phase(f"[8] stream path: {STREAM_N} log elements through StreamEngine and BydbQL")
        paths["stream"] = stream_path(hk, STREAM_N, "cuda", root)
    with tempfile.TemporaryDirectory(prefix="bydb-smoke-models-") as root:
        phase("[9] host-only models: TraceEngine and PropertyEngine")
        host_models_phase(root)
    # phase 10's cluster stays until phase 15 has moved its shards
    cluster_dir = tempfile.TemporaryDirectory(prefix="bydb-smoke-cluster-")
    phase(f"[10] cluster path: {CLUSTER_N} points through a liaison and two data nodes")
    paths["cluster"], cluster = cluster_path(hk, CLUSTER_N, "cuda", cluster_dir.name)
    try:
        with engine_dir:
            phase("[11] cold start against warmed start: three fresh processes")
            paths["warm"] = warm_phase(engine_root, engine_card)
        phase("[12] kernel audit on the card")
        paths["audit"] = audit_phase()
        with tempfile.TemporaryDirectory(prefix="bydb-smoke-server-") as root:
            phase(f"[13] server path: {N_POINTS} points through StandaloneServer's bus")
            paths["server"], server_fig, server_docs = server_path(
                hk, N_POINTS, "cuda", root, engine_card)
        print(json.dumps({"server": server_fig}), flush=True)
        with tempfile.TemporaryDirectory(prefix="bydb-smoke-workers-") as root:
            phase(f"[14] worker path: {N_POINTS} points through {WORKERS} shard workers")
            paths["workers"], workers_fig = workers_path(
                hk, N_POINTS, "cuda", root, server_docs)
        print(json.dumps({"workers": workers_fig}), flush=True)
        phase("[15] rebalance path: a third data node joins phase 10's cluster")
        paths["rebalance"], rebalance_fig = rebalance_path(hk, cluster, "cuda")
        print(json.dumps({"rebalance": rebalance_fig}), flush=True)
    finally:
        close_nodes(cluster["nodes"])
        cluster_dir.cleanup()
    with tempfile.TemporaryDirectory(prefix="bydb-smoke-lifecycle-") as root:
        phase(f"[16] lifecycle path: {LIFE_N} points over {LIFE_DAYS} day segments "
              "archived, migrated, backed up, tiered and asked over MCP")
        paths["lifecycle"], paths["tier"], lifecycle_fig = lifecycle_path(
            hk, LIFE_N, "cuda", root)
    print(json.dumps({"lifecycle": lifecycle_fig}), flush=True)
    # the card's paths are in-process: the server's gRPC, wire and HTTP
    # tiers load grpc and protobuf lazily, and none of them ran here
    wire = sorted(k for k in sys.modules
                  if k == "grpc" or k.startswith(("grpc.", "google.protobuf")))
    check(not wire, f"the in-process paths loaded {wire[:5]}")
    with tempfile.TemporaryDirectory(prefix="bydb-smoke-wire-") as root:
        phase(f"[17] wire path: {WIRE_SMOKE_N} points through MeasureService/Write, "
              "asked over gRPC, HTTP and the bus in a child process")
        paths["wire"], wire_fig = wire_phase(root, WIRE_SMOKE_N)
    print(json.dumps({"wire": wire_fig}), flush=True)
    with tempfile.TemporaryDirectory(prefix="bydb-smoke-grpc-") as root:
        phase(f"[18] grpc cluster: {GRPC_N} points through a liaison process's write "
              f"queue into {GRPC_NODES} data-role processes on the card")
        paths["grpc_cluster"], grpc_fig = grpc_phase(
            hk, root, GRPC_N, "cuda", want=cluster["host"])
    print(json.dumps({"grpc_cluster": grpc_fig}), flush=True)
    with tempfile.TemporaryDirectory(prefix="bydb-smoke-sanitize-") as root:
        phase(f"[19] lint and sanitizers: the static gate, then {N_POINTS} points and "
              f"phase 13's asks through a sanitized server beside a writer")
        paths["sanitize"], sanitize_fig = lint_sanitize_phase(
            root, N_POINTS, "cuda", server_docs, server_fig)
    print(json.dumps({"lint_sanitize": sanitize_fig}), flush=True)
    phase(f"[20] entry and dryrun: the flagship step against the CPU, "
          f"dryrun_multichip{DRYRUN_SLOTS} over slots on the card")
    paths["entry"], paths["dryrun"], entry_fig = entry_phase(hk, "cuda")
    print(json.dumps({"entry": entry_fig}), flush=True)
    with tempfile.TemporaryDirectory(prefix="bydb-smoke-soak-") as root:
        phase(f"[21] soak: {SOAK_S} s of replayed queries over a standalone engine, "
              f"a 2-node cluster and a 2 x 2 mesh on the card")
        paths["soak"], soak_fig = soak_phase(hk, "cuda", root)
    print(json.dumps({"soak": soak_fig}), flush=True)
    with tempfile.TemporaryDirectory(prefix="bydb-smoke-chaos-") as root:
        phase("[22] chaos smoke: kills, degradation, a fault schedule, worker kills "
              "and a rebalance under a kill, on the card")
        paths["chaos"], chaos_fig = chaos_phase(hk, "cuda", root)
    print(json.dumps({"chaos": chaos_fig}), flush=True)
    with tempfile.TemporaryDirectory(prefix="bydb-smoke-load-") as root:
        phase(f"[23] load: {LOAD_S} s of 2 writers at {LOAD_RATE} points/s and 4 "
              f"queriers through a gRPC-served server on the card")
        paths["load"], load_fig = load_phase(hk, "cuda", root)
    print(json.dumps({"load": load_fig}), flush=True)
    phase("[24] all phases done")
    for path, kernels in PATH_KERNELS.items():
        for k in kernels:
            check(paths[path][k] > 0, f"{k}: not launched on the {path} path")
    for k, r in rows.items():
        r["launches_by_path"] = {p: c[k] for p, c in paths.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        for lay in ("", "sorted_"):
            r.pop(lay + "device_kernels", None)  # logged in phase 3
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
