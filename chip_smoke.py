#!/usr/bin/env python3
"""Smoke run of banyandb_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit (``nvcc``).  Phases, in order; any failure exits non-zero
before the last line is printed:

1. card: the card's name and power limit (``nvidia-smi``);
2. build: compile the Hopper kernels from ``banyandb_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes and at the edge cases, with its time, the plain
   version's, one PyTorch library call's and the memory-bound floor;
4. main path: 4,194,304 points (1,024 services x 8 regions) written
   through the memtable and ``PartWriter`` into four parts, read back,
   and queried with ``execute_aggregate`` — count/sum/avg/min/max TopN
   and p50/p99 — fused, then staged (``BYDB_FUSED=0``, must be
   byte-identical), then on the CPU (must agree within the stated
   tolerances), and held against a numpy oracle; the kernels' launch
   counts over the card runs must be above zero;
5. the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line and, last,
   ``{"ok": true, "device": {...}}``.

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


def device_profile(fn, iters: int) -> dict:
    """Device time per call of everything ``fn`` runs on the card, from
    torch.profiler: {"total": ms, "<kernel>": ms, ...}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {"total": 0.0}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us <= 0:
            continue
        out[e.key] = out.get(e.key, 0.0) + us / 1e3 / iters
        out["total"] += us / 1e3 / iters
    return out


def timed_row(fn, plain, library, iters: int) -> dict:
    """Event-timed ms per call (what a caller waits for, launch gaps
    included) and profiler device ms per call, for the kernel, its
    plain version and the library call."""
    row = {}
    for key, f, n in (("", fn, iters), ("plain_", plain, 3), ("library_", library, iters)):
        row[f"{key}call_ms"] = cuda_ms(f, n, 1 if key == "plain_" else 2)
        prof = device_profile(f, n)
        row[f"{key}ms"] = prof["total"]
        if key == "":
            row["device_kernels"] = {
                k: v for k, v in prof.items() if k != "total"
            }
    return row


def group_inputs(n: int, f: int, g: int, integer: bool, seed: int):
    import torch

    rng = np.random.default_rng(seed)
    # codes over [-1, g]: -1 and g (the spill code) must count nowhere
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


def compare_group(hk, n, f, g, integer, seed) -> float:
    """Kernel vs plain on one input; -> max abs error of the sums."""
    codes, pred, vals, valid = group_inputs(n, f, g, integer, seed)
    kc, ks = hk.fused_group_multi(codes, pred, vals, valid, num_groups=g)
    pc, ps = hk.fused_group_multi_plain(codes, pred, vals, valid, g)
    import torch

    torch.cuda.synchronize()
    kc, ks, pc, ps = (t.cpu().numpy() for t in (kc, ks, pc, ps))
    what = f"fused_group_multi N={n} F={f} G={g} integer={integer}"
    check(kc.shape == (g,) and ks.shape == (f, g), f"{what}: shapes")
    check(np.array_equal(kc, pc), f"{what}: counts differ")
    if integer:
        check(np.array_equal(ks, ps), f"{what}: integer sums differ")
    else:
        check(
            np.allclose(ks, ps, rtol=RTOL, atol=0.0),
            f"{what}: sums beyond rtol={RTOL}",
        )
    # an independent f64 oracle for the counts
    c = codes.cpu().numpy()
    m = pred.cpu().numpy() & valid.cpu().numpy() & (c >= 0) & (c < g)
    check(
        np.array_equal(kc, np.bincount(c[m], minlength=g)[:g].astype(np.float32)),
        f"{what}: counts differ from bincount",
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
    )

    # fused_group_sum: the single-field wrapper, off the main path
    v1 = vals[0].contiguous()
    srow = timed_row(
        lambda: hk.fused_group_sum(codes, pred, v1, valid, num_groups=g),
        lambda: hk.fused_group_multi_plain(codes, pred, v1[None], valid, g),
        lambda: acc[:2].zero_().index_add_(1, slot, rows_in[:2]),
        50,
    )
    log(
        f"  fused_group_sum [N={n} F=1 G={g}] device ms per call: kernel "
        f"{srow['ms']!r}, plain {srow['plain_ms']!r}, library "
        f"{srow['library_ms']!r}, bound "
        f"{(n * 10 + 2 * g * 4) / HBM_BYTES_PER_S * 1e3!r}"
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
    for r in rows.values():
        log(
            f"  {r['name']} [{r['shape']}] device ms per call: kernel "
            f"{r['ms']!r} {r['device_kernels']}, plain {r['plain_ms']!r}, "
            f"library {r['library_ms']!r}, bound {r['bound_ms']!r}; "
            f"event ms per call: kernel {r['call_ms']!r}, plain "
            f"{r['plain_call_ms']!r}, library {r['library_call_ms']!r}"
        )
    return rows


# -- phase 4: the main path ----------------------------------------------------


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
        est = res.values["percentile(latency)"]
        name_to_id = {g[0]: int(g[0][4:]) for g in res.groups}
        for row, grp in zip(est, res.groups):
            gid = name_to_id[grp[0]]
            vals = lat[order][bounds[gid]: bounds[gid + 1]]
            for q, e in zip((0.5, 0.99), row):
                k = max(int(np.ceil(q * len(vals))), 1) - 1
                # + 1e-4: the card buckets f32 values, the oracle
                # sorts f64 ones
                check(
                    abs(e - vals[k]) <= width + 1e-4,
                    f"{what}: p{q} of {grp[0]} = {e}, order statistic {vals[k]}",
                )
    log(f"  ok  {what}: agrees with the numpy oracle")


def main_path(hk, n_points: int, device: str, root: str) -> dict:
    """Write, read and query; -> kernel launch counts over the runs on
    `device` (the CPU comparison runs come after they are read)."""
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
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from banyandb_tpu_torch.ops import hopper_kernels as hk
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2

    card = card_line()
    log(f"[1] card: {card}")
    log(
        f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}"
    )
    build_s = hk.build()
    log(f"[2] build: {build_s:.3f} s")
    for line in hk.build_log.splitlines():
        if "registers" in line or "bytes stack" in line or line.startswith("=="):
            log(f"    {line.strip()}")
    log("[3] kernels against their plain versions")
    rows = kernel_phase(hk)
    log(f"[4] main path: {N_POINTS} points")
    with tempfile.TemporaryDirectory(prefix="bydb-smoke-") as root:
        launches = main_path(hk, N_POINTS, "cuda", root)
    for k, r in rows.items():
        r["launches"] = launches[k]
        check(r["launches"] > 0, f"{k}: not launched on the main path")
        del r["device_kernels"]  # logged in phase 3
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
