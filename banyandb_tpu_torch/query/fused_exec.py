"""Fused whole-plan executor: one part-batch, one device round trip.

The staged executor (query/measure_exec) runs the per-chunk plan body
once per scan chunk, each followed by a batched device->host transfer.
This executor ships a part-batch as stacked ``[C, nrows]`` tensors,
decodes it once, runs the SAME per-chunk body
(``measure_exec._kernel_body``) over the chunk axis on the device, and
brings the stacked per-chunk partials back in ONE batched transfer; the
host then folds them into the f64 accumulators in scan order exactly
like the staged loop.  Same per-chunk computation, same absorb order =>
byte-identical partials and results (``BYDB_FUSED=0`` restores the
staged path).

Group-by strategy resolves through ``ops.groupby.select_group_method``
from the signature in BOTH paths, so an A/B flip can never pair
different reduction orders.

The chunk-count bucket (``FusedSpec = PlanSpec + num_chunks``,
power-of-two buckets) fixes the stacked layout, the footprint estimate
and the device-cache key; padding chunks are fully invalid and the body
runs over the real chunks only.

The mesh half (``build_fused_dist_step``) runs the same chunked scan on
every slot of a ('shard','seg') mesh with the dist-path collective (sum
count/sums/hist, amin/amax in slot order), so a distributed scan has a
bounded chunk width instead of one unbounded-width chunk per row-count
bucket.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from banyandb_tpu_torch.backend import resolve_device
from banyandb_tpu_torch.query import measure_exec
from banyandb_tpu_torch.query.measure_exec import PlanSpec, _kernel_body
from banyandb_tpu_torch.utils.envflag import env_flag, env_int


def fused_enabled() -> bool:
    """The A/B flag: default on, ``BYDB_FUSED=0`` restores the staged
    per-chunk loop (read per query so operators can flip it live)."""
    return env_flag("BYDB_FUSED", default=True)


def max_fused_mb() -> int:
    """Device-footprint ceiling for one fused part-batch (stacked input
    columns + stacked per-chunk partials).  Plans whose one-shot
    footprint exceeds it (e.g. a huge-G percentile over many chunks,
    where the stacked [C, G, 512] histogram explodes) fall back to the
    staged loop instead of OOMing the device."""
    return env_int("BYDB_FUSED_MAX_MB", 1024)


@dataclass(frozen=True)
class FusedSpec:
    """Static key of one fused part-batch layout: the plan signature
    plus the chunk-count bucket the part-batch is stacked into."""

    plan: PlanSpec
    num_chunks: int


def chunk_count_bucket(n_chunks: int) -> int:
    """Power-of-two chunk-count buckets: the layout set stays
    O(log max_chunks); chunks beyond the real count are fully invalid
    (valid=False everywhere), so skipping them is a numeric no-op."""
    b = 1
    while b < n_chunks:
        b <<= 1
    return b


def _num_hist_buckets() -> int:
    from banyandb_tpu_torch.query import measure_exec

    return measure_exec._NUM_HIST_BUCKETS


def estimate_bytes(spec: PlanSpec, num_chunks: int) -> int:
    """Device footprint of one fused part-batch: stacked input columns
    plus the stacked per-chunk partials pytree.

    Under ``BYDB_DEVICE_DECODE`` the compressed inputs (narrow tag/field
    buffers, the i16 src-ordinal column) are resident ALONGSIDE the
    decoded i32/f32 copies the decode stage materializes
    before the chunk loop, so the ceiling accounts both — else a batch sized
    at ``BYDB_FUSED_MAX_MB`` would OOM instead of taking the intended
    staged fallback.  (The [S, L] remap LUTs are a rounding error next
    to the per-row columns and ride the same conservative margin.)"""
    from banyandb_tpu_torch.storage import encoded as enc_mod

    g = spec.num_groups
    nf = len(spec.fields)
    per_chunk_out = g * (1 + nf + (2 * nf if spec.want_minmax else 0))
    if spec.hist_field:
        per_chunk_out += g * _num_hist_buckets()
    if spec.want_rep:
        per_chunk_out += 2 * g
    cols = 4 + len(spec.tags_code) + nf  # ts/series/valid/row + tags + fields
    per_row = 4 * cols
    if enc_mod.device_decode_enabled():
        # narrow inputs (<=2 B/row per tag/field) + src_ord (2 B/row)
        per_row += 2 + 2 * (len(spec.tags_code) + nf)
    return num_chunks * (per_row * spec.nrows + 4 * per_chunk_out)


def _resolve_bucket(n_chunks: int, min_bucket: int | None) -> int:
    """The chunk-count bucket for a part-batch, honoring the planner's
    minimum-bucket hint.  The hint only ever rounds UP (padding chunks
    are fully invalid, the host absorbs only real ones — byte-identical)
    and is capped at one doubling of the actual bucket: the hint exists
    for part populations oscillating around a bucket boundary, not to
    pad a 1-chunk batch into a 64-chunk batch."""
    bucket = chunk_count_bucket(n_chunks)
    if min_bucket is not None and bucket < min_bucket <= bucket * 2:
        return min_bucket
    return bucket


def eligible(
    spec: PlanSpec, n_chunks: int, min_bucket: int | None = None
) -> bool:
    """Fused path taken for this part-batch?  Flag + footprint budget."""
    if n_chunks < 1 or not fused_enabled():
        return False
    bucket = _resolve_bucket(n_chunks, min_bucket)
    return estimate_bytes(spec, bucket) <= max_fused_mb() * (1 << 20)


def _stacked_chunks(
    cols: dict,
    spans: list[tuple[int, int]],
    spec: PlanSpec,
    num_chunks: int,
    epoch: int,
    device: torch.device,
    pad_ship_s: list | None = None,
    ship_stats: list | None = None,
) -> dict:
    """Pad the gathered columns into ``[C, nrows]`` tensors on `device`.

    Chunk layout (per-row dtypes, padding, the epoch-relative int32 ts,
    the global row index) matches measure_exec._device_chunk exactly —
    the scan body sees per-chunk inputs identical to the staged
    kernel's, in EITHER ship form: compressed snapshots
    (``BYDB_DEVICE_DECODE``) stack the narrow local tag codes, the
    per-row source ordinals and exact-int fields, plus the per-batch
    [S, L] remap LUTs the decode stage consumes.  Per-column
    pad work rides the chunk_stream prefetch worker (BYDB_PIPELINE
    honored) so padding column j+1 overlaps shipping column j.
    ``ship_stats`` collects one (shipped, dense) byte pair for the
    whole part-batch (decode-span attribution).
    """
    from banyandb_tpu_torch.storage.chunk_stream import prefetched

    C, nb = num_chunks, spec.nrows
    compressed = "src_ord" in cols

    def pad2(get, dtype):
        out = np.zeros((C, nb), dtype=dtype)
        for k, (s, e) in enumerate(spans):
            out[k, : e - s] = get(s, e)
        return out

    def valid2():
        out = np.zeros((C, nb), dtype=bool)
        for k, (s, e) in enumerate(spans):
            out[k, : e - s] = True
        return out

    paths: list[tuple] = [("ts",), ("series",), ("valid",), ("row",)]
    thunks = [
        lambda: pad2(lambda s, e: cols["ts"][s:e] - epoch, np.int32),
        lambda: pad2(lambda s, e: cols["series"][s:e] % (2**31), np.int32),
        valid2,
        lambda: pad2(lambda s, e: np.arange(s, e, dtype=np.int32), np.int32),
    ]
    counted: set = set()
    if compressed:
        from banyandb_tpu_torch.storage import encoded as enc_mod

        if spec.tags_code:
            for t in spec.tags_code:
                paths.append(("tags_enc", t))
                counted.add(("tags_enc", t))
                thunks.append(
                    lambda t=t: pad2(
                        lambda s, e: cols["tags_enc"][t][s:e],
                        cols["tags_enc"][t].dtype,
                    )
                )
                paths.append(("tags_lut", t))
                counted.add(("tags_lut", t))
                thunks.append(
                    lambda t=t: enc_mod.pack_luts(cols["tags_lut"][t])
                )
            paths.append(("src_ord",))
            counted.add(("src_ord",))
            thunks.append(
                lambda: pad2(
                    lambda s, e: cols["src_ord"][s:e], enc_mod.SRC_ORD_DTYPE
                )
            )
        for f in spec.fields:
            ndt = cols["fields_narrow"].get(f)
            if ndt is not None:
                paths.append(("fields_enc", f))
                counted.add(("fields_enc", f))
                thunks.append(
                    lambda f=f, ndt=ndt: pad2(
                        lambda s, e: cols["fields"][f][s:e], ndt
                    )
                )
            else:
                paths.append(("fields", f))
                counted.add(("fields", f))
                thunks.append(
                    lambda f=f: pad2(
                        lambda s, e: cols["fields"][f][s:e], np.float32
                    )
                )
    else:
        for t in spec.tags_code:
            paths.append(("tags_code", t))
            counted.add(("tags_code", t))
            thunks.append(
                lambda t=t: pad2(lambda s, e: cols["tags_code"][t][s:e], np.int32)
            )
        for f in spec.fields:
            paths.append(("fields", f))
            counted.add(("fields", f))
            thunks.append(
                lambda f=f: pad2(lambda s, e: cols["fields"][f][s:e], np.float32)
            )

    def timed(fn):
        def pad_thunk():  # host-side work on the prefetch worker
            t0 = time.perf_counter()
            try:
                return fn()
            finally:
                if pad_ship_s is not None:
                    pad_ship_s.append(time.perf_counter() - t0)

        return pad_thunk

    out: dict = {
        "tags_code": {},
        "tags_enc": {},
        "tags_lut": {},
        "fields": {},
        "fields_enc": {},
    }
    shipped = 0
    for path, arr in zip(
        paths,
        prefetched([timed(fn) for fn in thunks], name="bydb-fused-pad"),
    ):
        t0 = time.perf_counter()
        dev = measure_exec.ship(arr, device)
        if pad_ship_s is not None:
            pad_ship_s.append(time.perf_counter() - t0)
        if path in counted:
            shipped += dev.nbytes
        if len(path) == 1:
            out[path[0]] = dev
        else:
            out[path[0]][path[1]] = dev
    # canonical keys (tags_code/fields) stay present even when empty —
    # the pre-decode chunk structure the staged path and the precompile
    # warm args share; the compressed-only keys appear only when used
    for key in ("tags_enc", "tags_lut", "fields_enc"):
        if not out[key]:
            del out[key]
    if ship_stats is not None:
        dense = (len(spec.tags_code) + len(spec.fields)) * C * nb * 4
        ship_stats.append((shipped, dense))
    return out


def run_fused(
    chunks_np: dict,
    chunk_spans: list[tuple[int, int]],
    spec: PlanSpec,
    pred_vals: dict,
    hist_lo,
    hist_span,
    epoch: int,
    device=None,
    *,
    gather_key=None,
    dev_cache=None,
    pad_ship_s: list | None = None,
    ship_stats: list | None = None,
    min_bucket: int | None = None,
) -> tuple[list[dict], float, str]:
    """Execute one part-batch through the fused path on `device`
    (``backend.resolve_device``).

    -> (per-chunk host partials in scan order for the staged f64 absorb
    loop, seconds spent at the two device boundaries, input-cache
    outcome tag).  The decode and the chunk loop stay on the device;
    one batched device->host transfer brings every chunk's partials
    back.  ``min_bucket`` (planner hint) rounds the chunk-count bucket
    up — see ``_resolve_bucket``.
    """
    # function-local import, as in the JAX executor
    from banyandb_tpu_torch.query.precompile import default_registry

    device = resolve_device(device)
    num_chunks = _resolve_bucket(len(chunk_spans), min_bucket)
    default_registry().record("fused", FusedSpec(plan=spec, num_chunks=num_chunks))

    built: list = []

    def _build():
        built.append(1)
        return _stacked_chunks(
            chunks_np, chunk_spans, spec, num_chunks, epoch, device,
            pad_ship_s, ship_stats=ship_stats,
        )

    if dev_cache is not None:
        # stacked inputs depend only on (gathered data, bucket, columns):
        # keep them device-resident so repeat queries skip pad+ship too
        # (the fused twin of the staged per-chunk device cache)
        ck = (
            "fused_chunks",
            str(device),
            gather_key,
            num_chunks,
            spec.nrows,
            spec.tags_code,
            spec.fields,
        )
        dev_chunks = dev_cache.get_or_load(ck, _build)
    else:
        dev_chunks = _build()

    kernel = _build_kernel(FusedSpec(plan=spec, num_chunks=num_chunks))
    t0 = time.perf_counter()
    stacked = kernel(
        dev_chunks, pred_vals, hist_lo, hist_span, n_real=len(chunk_spans)
    )
    # THE result boundary of the fused plan: the whole part-batch's
    # stacked partials move in one batched transfer
    moved = measure_exec.device_get(stacked)
    device_s = time.perf_counter() - t0
    chunks_out = [
        _tree_map(lambda a, k=k: a[k], moved) for k in range(len(chunk_spans))
    ]
    return chunks_out, device_s, ("built" if built else "hit")


def _build_kernel(fspec: FusedSpec):
    """The fused part-batch function of `fspec`: stacked ``[C, nrows]``
    chunks (either ship form) -> stacked ``[n_real, ...]`` per-chunk
    partials, on the chunks' device.  The batch is decoded once (the
    remap LUTs are per-batch), then the per-chunk body runs over the
    first ``n_real`` chunks (default: all ``num_chunks``; padding chunks
    beyond the real ones are fully invalid and skipped)."""
    from banyandb_tpu_torch.ops import decode as ops_decode

    body = _kernel_body(fspec.plan)

    def kernel(chunks: dict, pred_vals: dict, hist_lo, hist_span, n_real=None):
        decoded = ops_decode.decode_chunk(chunks)
        return _stack_trees(
            [
                body(
                    _tree_map(lambda a, k=k: a[k], decoded),
                    pred_vals, hist_lo, hist_span,
                )
                for k in range(fspec.num_chunks if n_real is None else n_real)
            ]
        )

    return kernel


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack_trees(trees: list):
    """[{k: tensor}] -> {k: tensor [C, ...]} over nested dicts."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# Mesh-parallel fused step: the whole distributed scan as one step over the
# mesh's slots (dist_exec's map half per fixed-width chunk, dist_exec's
# collective across slots).
# ---------------------------------------------------------------------------


def _kahan_add(s: torch.Tensor, c: torch.Tensor, x: torch.Tensor):
    """One compensated accumulation step; true sum ~= s - c."""
    y = x - c
    t = s + y
    return t, (t - s) - y


def _fused_dist_slot(
    plan, num_chunks: int, chunk: dict, pred_codes: dict, hist_lo, hist_span
) -> dict:
    """One slot's [num_chunks * nrows] slice -> chunked scan -> partials.

    Per-chunk f32 partials combine across chunks with Kahan-compensated
    f32 (count/sums/hist) and exact min/max — the precision contract's
    bounded-span rule, on the device.  With num_chunks=1 the math
    reduces to the legacy step exactly (Kahan from zero is the
    identity)."""
    from banyandb_tpu_torch import ops
    from banyandb_tpu_torch.parallel import dist_exec

    nhb = dist_exec._NUM_HIST_BUCKETS
    G = plan.num_groups
    dev = chunk["valid"].device
    zero = torch.zeros(G, dtype=torch.float32, device=dev)
    count = (zero, zero)
    sums = {f: (zero, zero) for f in plan.fields}
    mins = {f: torch.full((G,), float("inf"), device=dev) for f in plan.fields}
    maxs = {f: torch.full((G,), float("-inf"), device=dev) for f in plan.fields}
    if plan.want_hist:
        hzero = torch.zeros((G, nhb), dtype=torch.float32, device=dev)
        hist = (hzero, hzero)
    rows = _tree_map(lambda a: a.view(num_chunks, -1), chunk)
    for k in range(num_chunks):
        c = _tree_map(lambda a, k=k: a[k], rows)
        # the SAME map half the legacy mesh step runs (dist_exec.map_chunk)
        part, key, mask = dist_exec.map_chunk(plan, c, pred_codes)
        count = _kahan_add(*count, part.count)
        sums = {f: _kahan_add(*sums[f], part.sums[f]) for f in plan.fields}
        mins = {f: torch.minimum(mins[f], part.mins[f]) for f in plan.fields}
        maxs = {f: torch.maximum(maxs[f], part.maxs[f]) for f in plan.fields}
        if plan.want_hist:
            h = ops.group_histogram(
                key, mask, c["fields"][plan.want_hist], G,
                hist_lo, hist_span, nhb,
            )
            hist = _kahan_add(*hist, h)
    out = {
        "count": count[0] - count[1],
        "sums": {f: sums[f][0] - sums[f][1] for f in plan.fields},
        "mins": mins,
        "maxs": maxs,
    }
    if plan.want_hist:
        out["hist"] = hist[0] - hist[1]
    return out


_DIST_STEP_CACHE: dict[tuple, object] = {}


def build_fused_dist_step(mesh, plan, num_chunks: int):
    """-> f(chunks, pred_codes, hist_lo, hist_span): the whole
    distributed scan as one step over the mesh.  ``chunks`` leaves are
    per-slot [num_chunks * nrows] tensors (``dist_exec.
    stack_shard_chunks``); outputs are tensors on the first slot's
    device.  Memoized per (slot devices, plan, chunk bucket)."""
    from banyandb_tpu_torch.parallel import dist_exec

    cache_key = (dist_exec._mesh_key(mesh), plan, num_chunks)
    cached = _DIST_STEP_CACHE.get(cache_key)
    if cached is not None:
        return cached

    def step(chunks, pred_codes, hist_lo, hist_span):
        return dist_exec.reduce_slots(
            plan,
            [
                _fused_dist_slot(
                    plan, num_chunks, c, pred_codes, hist_lo, hist_span
                )
                for c in dist_exec.slot_chunks(plan, chunks)
            ],
        )

    _DIST_STEP_CACHE[cache_key] = step
    return step


def fused_distributed_aggregate(
    mesh,
    plan,
    num_chunks: int,
    chunks: dict,
    pred_codes=None,
    hist_lo: float = 0.0,
    hist_span: float = 1.0,
):
    """Convenience wrapper mirroring dist_exec.distributed_aggregate."""
    step = build_fused_dist_step(mesh, plan, num_chunks)
    codes = {t: int((pred_codes or {}).get(t, -1)) for t in plan.eq_preds}
    return step(chunks, codes, float(hist_lo), float(hist_span))
