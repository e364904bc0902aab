"""The port's mesh step against the JAX package's.

Both packages run the same seeded numpy rows through their distributed
aggregate over a 4 x 2 ('shard', 'seg') mesh: the JAX package over the
8 host devices ``tests/conftest.py`` forces, the port over 8 slots on
``"cpu"`` (where ``fused_group_multi`` takes its plain version).

- the legacy step (``parallel.distributed_aggregate``) on the shapes of
  ``tests/test_parallel.py``: predicate + top-n + histogram, ragged and
  empty slots, a global aggregate, mixed-radix groups, the two-pass
  percentile;
- the fused chunked step (``query.fused_exec.fused_distributed_aggregate``)
  at num_chunks 1, 2 and 4 against the JAX ``_fused_dist_step`` run
  under nested named ``jax.vmap`` (its ``shard_map`` program does not
  trace under this JAX; the named axes give ``psum``/``pmin``/``pmax``
  their meaning without it);
- ``ops.topk_groups`` with ties in both directions and
  ``ops.latest_by_version`` against the JAX ops.

Tolerance (the precision contract of ``tests/test_precision.py``):
counts, min/max, histograms, integer-valued sums and top-n indices are
equal; other sums and top-n values within rtol 1e-5.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banyandb_tpu import ops as jops
from banyandb_tpu.parallel import dist_exec as jdist
from banyandb_tpu.parallel import make_mesh as jmake_mesh
from banyandb_tpu.query import fused_exec as jfused
from banyandb_tpu_torch import ops as tops
from banyandb_tpu_torch.parallel import dist_exec as tdist
from banyandb_tpu_torch.parallel import make_mesh as tmake_mesh
from banyandb_tpu_torch.query import fused_exec as tfused

RTOL = 1e-5


def _rows(rng, n, nsvc=6):
    return {
        "tags": {
            "svc": rng.integers(0, nsvc, n).astype(np.int32),
            "region": rng.integers(0, 3, n).astype(np.int32),
        },
        "fields": {
            "lat": rng.gamma(2.0, 40.0, n).astype(np.float32),
            "calls": rng.integers(0, 50, n).astype(np.float32),
        },
    }


def _plan(api, **kw):
    base = dict(
        tags_code=("region", "svc"),
        fields=("lat",),
        group_tags=("svc",),
        radices=(6,),
        num_groups=6,
    )
    base.update(kw)
    return api.DistPlan(**base)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    return np.asarray(tree)


def _same(jout, tout, plan, integer_fields=()):
    j, t = _np(jout), _np(tout)
    assert sorted(j) == sorted(t)
    np.testing.assert_array_equal(t["count"], j["count"])
    for f in plan.fields:
        if f in integer_fields:
            np.testing.assert_array_equal(t["sums"][f], j["sums"][f])
        else:
            np.testing.assert_allclose(t["sums"][f], j["sums"][f], rtol=RTOL)
        np.testing.assert_array_equal(t["mins"][f], j["mins"][f])
        np.testing.assert_array_equal(t["maxs"][f], j["maxs"][f])
    if plan.want_hist:
        np.testing.assert_array_equal(t["hist"], j["hist"])
    if plan.topn:
        np.testing.assert_array_equal(t["top_idx"], j["top_idx"])
        np.testing.assert_allclose(t["top_vals"], j["top_vals"], rtol=RTOL)


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 forced host devices of tests/conftest.py")
    return jmake_mesh(4, 2), tmake_mesh(4, 2, devices=["cpu"] * 8)


def _run_both(meshes, plan_kw, per_shard, nrows, pred=None, lo=0.0, span=1.0):
    jmesh, tmesh = meshes
    jplan, tplan = _plan(jdist, **plan_kw), _plan(tdist, **plan_kw)
    jch = jdist.stack_shard_chunks(jmesh, per_shard, jplan.tags_code, jplan.fields, nrows)
    tch = tdist.stack_shard_chunks(tmesh, per_shard, tplan.tags_code, tplan.fields, nrows)
    jout = jdist.distributed_aggregate(
        jmesh, jplan, jch, pred_codes=pred, hist_lo=lo, hist_span=span
    )
    tout = tdist.distributed_aggregate(
        tmesh, tplan, tch, pred_codes=pred, hist_lo=lo, hist_span=span
    )
    return jout, tout, tplan


# (plan overrides, per-slot row counts, chunk width, eq predicate, hist range)
LEGACY_CASES = {
    "predicate_topn_hist": (
        dict(fields=("calls", "lat"), eq_preds=("region",), topn=3, want_hist="lat"),
        [400] * 8, 512, {"region": 1}, (0.0, 1000.0),
    ),
    "ragged_slots": (dict(), [0, 1, 7, 400, 33, 256, 511, 100], 512, None, None),
    "global_aggregate": (
        dict(group_tags=(), radices=(), num_groups=1), [100] * 8, 128, None, None,
    ),
    "mixed_radix": (
        dict(group_tags=("region", "svc"), radices=(3, 6), num_groups=18),
        [200] * 8, 256, None, None,
    ),
    "all_empty": (dict(), [0] * 8, 64, None, None),
}


@pytest.mark.parametrize("case", sorted(LEGACY_CASES))
def test_legacy_step_matches_jax(meshes, case):
    plan_kw, sizes, nrows, pred, hist = LEGACY_CASES[case]
    rng = np.random.default_rng(21)
    per_shard = [_rows(rng, n) for n in sizes]
    lo, span = hist or (0.0, 1.0)
    jout, tout, plan = _run_both(meshes, plan_kw, per_shard, nrows, pred, lo, span)
    _same(jout, tout, plan, integer_fields=("calls",))
    assert float(np.sum(_np(tout)["count"])) == (
        sum(sizes) if pred is None
        else sum(int((r["tags"]["region"] == 1).sum()) for r in per_shard)
    )


def test_legacy_two_pass_percentile_matches_jax(meshes):
    """Pass 1 agrees the global range (amin/amax), pass 2 histograms with
    it: the range and the histograms are the JAX package's exactly."""
    rng = np.random.default_rng(22)
    per_shard = [_rows(rng, 400) for _ in range(8)]
    jout1, tout1, _ = _run_both(meshes, {}, per_shard, 512)
    ranges = []
    for out in (_np(jout1), _np(tout1)):
        nz = out["count"] > 0
        lo = float(out["mins"]["lat"][nz].min())
        hi = float(out["maxs"]["lat"][nz].max())
        ranges.append((lo, max(hi - lo, 1e-6)))
    assert ranges[0] == ranges[1]
    lo, span = ranges[1]
    jout2, tout2, plan2 = _run_both(
        meshes, dict(want_hist="lat"), per_shard, 512, lo=lo, span=span
    )
    _same(jout2, tout2, plan2)
    np.testing.assert_array_equal(_np(tout2)["hist"].sum(axis=1), _np(tout2)["count"])


def _jax_fused_vmapped(plan, num_chunks, per_slot, pred, lo, span):
    """The reference ``_fused_dist_step`` under nested named vmap over
    [S, G_seg, 1, C*R] inputs: the collectives reduce over the named
    axes; every slot's output is the replicated result."""
    codes = {t: jnp.int32(pred.get(t, -1)) for t in plan.eq_preds}
    f = partial(
        jfused._fused_dist_step, plan, num_chunks,
        pred_codes=codes, hist_lo=jnp.float32(lo), hist_span=jnp.float32(span),
    )
    x = jax.tree.map(lambda a: jnp.asarray(a.reshape(4, 2, 1, -1)), per_slot)
    out = jax.vmap(jax.vmap(lambda c: f(chunks=c), axis_name="seg"), axis_name="shard")(x)
    return jax.tree.map(lambda a: np.asarray(a)[0, 0], out)


@pytest.mark.parametrize("num_chunks", [1, 2, 4])
def test_fused_step_matches_vmapped_reference(meshes, num_chunks):
    _jmesh, tmesh = meshes
    rng = np.random.default_rng(30 + num_chunks)
    nrows = 256
    width = num_chunks * nrows
    sizes = [width, 0, 1, width - 3, 100, width // 2, 7, width]
    per_shard = [_rows(rng, n) for n in sizes]
    kw = dict(fields=("calls", "lat"), eq_preds=("region",), topn=4, want_hist="lat")
    jplan, tplan = _plan(jdist, **kw), _plan(tdist, **kw)
    pred = {"region": 2}
    lo, span = 0.0, 600.0

    tch = tdist.stack_shard_chunks(tmesh, per_shard, tplan.tags_code, tplan.fields, width)
    tout = tfused.fused_distributed_aggregate(
        tmesh, tplan, num_chunks, tch, pred_codes=pred, hist_lo=lo, hist_span=span
    )
    # the same padded [slot, C*R] layout for the reference
    packed = {
        "valid": np.stack([np.arange(width) < n for n in sizes]),
        "tags": {
            t: np.stack([np.pad(r["tags"][t], (0, width - len(r["tags"][t])))
                         for r in per_shard])
            for t in tplan.tags_code
        },
        "fields": {
            f: np.stack([np.pad(r["fields"][f], (0, width - len(r["fields"][f])))
                         for r in per_shard])
            for f in tplan.fields
        },
    }
    jout = _jax_fused_vmapped(jplan, num_chunks, packed, pred, lo, span)
    _same(jout, tout, tplan, integer_fields=("calls",))
    assert float(tout["count"].sum()) == sum(
        int((r["tags"]["region"] == 2).sum()) for r in per_shard
    )

    # one chunk: the fused step equals the legacy step exactly
    if num_chunks == 1:
        legacy = tdist.distributed_aggregate(
            tmesh, tplan, tch, pred_codes=pred, hist_lo=lo, hist_span=span
        )
        for key in ("count", "hist", "top_idx", "top_vals"):
            assert torch.equal(legacy[key], tout[key]), key
        for key in ("sums", "mins", "maxs"):
            for f in tplan.fields:
                assert torch.equal(legacy[key][f], tout[key][f]), (key, f)


def test_make_mesh_too_small_and_slot_devices():
    with pytest.raises(ValueError, match="devices"):
        tmake_mesh(100, 2, devices=["cpu"] * 8)
    mesh = tmake_mesh(2, 3, devices=["cpu"] * 6)
    assert mesh.shape == {"shard": 2, "seg": 3} and mesh.size == 6
    assert set(mesh.devices) == {torch.device("cpu")}


@pytest.mark.parametrize("descending", [True, False], ids=["desc", "asc"])
def test_topk_groups_ties_match_jax(descending):
    metric = np.array([3.0, 1.0, 3.0, 2.0, 1.0, 3.0, 2.0, 0.5], np.float32)
    nonempty = np.array([1, 1, 1, 0, 1, 1, 1, 0], bool)
    for n in (1, 3, 5, 8):
        jv, ji = jops.topk_groups(
            jnp.asarray(metric), jnp.asarray(nonempty), n, descending=descending
        )
        tv, ti = tops.topk_groups(
            torch.from_numpy(metric), torch.from_numpy(nonempty), n,
            descending=descending,
        )
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_latest_by_version_matches_jax():
    rng = np.random.default_rng(7)
    n = 3000
    series = rng.integers(0, 20, n).astype(np.int32)
    ts = rng.integers(0, 30, n).astype(np.int32)
    version = rng.integers(0, 4, n).astype(np.int32)  # many exact ties
    valid = rng.random(n) < 0.9
    want = np.asarray(jops.latest_by_version(
        jnp.asarray(series), jnp.asarray(ts), jnp.asarray(version), jnp.asarray(valid)
    ))
    got = tops.latest_by_version(
        torch.from_numpy(series), torch.from_numpy(ts),
        torch.from_numpy(version), torch.from_numpy(valid),
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()
