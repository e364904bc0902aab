"""Port parity: banyandb_tpu_torch.ops against banyandb_tpu.ops on the
same numpy inputs, on the CPU.

Tolerances: codes, counts, min/max, histograms and integer-valued sums
are exact (f32 sums of integers below 2^24 do not depend on order);
non-integer f32 sums are within rtol=1e-5 (tests/test_precision.py's
contract), because the reduction order differs from XLA's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banyandb_tpu import ops as jops
from banyandb_tpu.storage import encoded
from banyandb_tpu_torch import ops as tops
from banyandb_tpu_torch.ops import groupby as tgroupby

RTOL = 1e-5


def test_mixed_radix_key_matches_and_guards():
    rng = np.random.default_rng(1)
    cols = [rng.integers(0, r, 1000).astype(np.int32) for r in (7, 13, 5)]
    jk, jn = jops.mixed_radix_key([jnp.asarray(c) for c in cols], (7, 13, 5))
    tk, tn = tops.mixed_radix_key([torch.from_numpy(c) for c in cols], (7, 13, 5))
    assert tn == jn == 7 * 13 * 5
    assert tk.dtype == torch.int32
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    with pytest.raises(ValueError):
        tops.mixed_radix_key([torch.from_numpy(cols[0])] * 2, (1 << 16, 1 << 15))


def _group_inputs(n, g, integer, seed):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, g, n).astype(np.int32)
    valid = rng.random(n) < 0.85
    if integer:
        f = {"a": rng.integers(0, 1000, n).astype(np.float32),
             "b": rng.integers(-9, 9, n).astype(np.float32)}
    else:
        f = {"a": rng.gamma(2.0, 40.0, n).astype(np.float32)}
    return key, valid, f


@pytest.mark.parametrize(
    "method", ["scatter", "matmul", "matmul_tiled", "sort", "kernel", "auto"]
)
@pytest.mark.parametrize("n,integer", [(5000, True), (70000, True), (5000, False)])
def test_group_reduce_every_method(method, n, integer):
    g = 300
    key, valid, fields = _group_inputs(n, g, integer, seed=n)
    ref = jops.group_reduce(
        jnp.asarray(key), jnp.asarray(valid),
        {k: jnp.asarray(v) for k, v in fields.items()}, g, method="scatter",
    )
    got = tops.group_reduce(
        torch.from_numpy(key), torch.from_numpy(valid),
        {k: torch.from_numpy(v) for k, v in fields.items()}, g, method=method,
    )
    assert got.count.dtype == torch.float32
    assert np.array_equal(got.count.numpy(), np.asarray(ref.count))
    for k in fields:
        a, b = got.sums[k].numpy(), np.asarray(ref.sums[k])
        if integer:
            assert np.array_equal(a, b), k
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)
        assert np.array_equal(got.mins[k].numpy(), np.asarray(ref.mins[k]))
        assert np.array_equal(got.maxs[k].numpy(), np.asarray(ref.maxs[k]))


def test_group_reduce_empty_groups_are_inf():
    key = torch.tensor([0, 0, 2], dtype=torch.int32)
    valid = torch.tensor([True, True, False])
    res = tops.group_reduce(key, valid, {"v": torch.tensor([1.0, 2.0, 3.0])}, 4)
    assert res.count.tolist() == [2.0, 0.0, 0.0, 0.0]
    assert res.mins["v"].tolist() == [1.0] + [float("inf")] * 3
    assert res.maxs["v"].tolist() == [2.0] + [float("-inf")] * 3


def test_select_group_method_policy():
    sel = tgroupby.select_group_method
    assert sel(1) == "kernel"
    assert sel(tgroupby.KERNEL_MAX_GROUPS) == "kernel"
    assert sel(tgroupby.KERNEL_MAX_GROUPS + 1) == "scatter"
    assert sel(tgroupby.SORT_GROUPS_THRESHOLD) == "scatter"
    assert sel(tgroupby.SORT_GROUPS_THRESHOLD + 1) == "sort"


def test_group_histogram_matches_and_guards():
    rng = np.random.default_rng(4)
    n, g = 20000, 37
    key = rng.integers(0, g, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    vals = rng.gamma(2.0, 40.0, n).astype(np.float32)
    lo, span = np.float32(vals.min()), np.float32(vals.max() - vals.min())
    want = jops.group_histogram(
        jnp.asarray(key), jnp.asarray(valid), jnp.asarray(vals), g,
        jnp.float32(lo), jnp.float32(span), 512,
    )
    got = tops.group_histogram(
        torch.from_numpy(key), torch.from_numpy(valid), torch.from_numpy(vals),
        g, torch.tensor(lo), torch.tensor(span), 512,
    )
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        tops.group_histogram(
            torch.from_numpy(key), torch.from_numpy(valid),
            torch.from_numpy(vals), 1 << 22, 0.0, 1.0, 512,
        )


def test_group_percentile_histogram_matches():
    rng = np.random.default_rng(6)
    n, g = 8000, 11
    key = rng.integers(0, g, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    vals = rng.random(n).astype(np.float32) * 100
    kw = dict(lo=0.0, hi=100.0, num_buckets=128)
    want = jops.group_percentile_histogram(
        jnp.asarray(key), jnp.asarray(valid), jnp.asarray(vals), g + 1,
        (0.0, 0.5, 0.99), **kw,
    )
    got = tops.group_percentile_histogram(
        torch.from_numpy(key), torch.from_numpy(valid), torch.from_numpy(vals),
        g + 1, (0.0, 0.5, 0.99), **kw,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _encoded_chunk(lib, as_array):
    """One chunk in the compressed ship form over two sources."""
    rng = np.random.default_rng(8)
    n = 4096
    luts = [np.asarray([5, 3, 9], np.int32), np.asarray([1, 0], np.int32)]
    src = (rng.random(n) < 0.5).astype(np.int16)
    codes = np.where(src == 0, rng.integers(0, 3, n), rng.integers(0, 2, n)).astype(np.int8)
    return {
        "valid": as_array(np.ones(n, bool)),
        "tags_enc": {"svc": as_array(codes)},
        "tags_lut": {"svc": as_array(encoded.pack_luts(luts))},
        "src_ord": as_array(src),
        "fields": {"f": as_array(rng.random(n).astype(np.float32))},
        "fields_enc": {"v": as_array(rng.integers(-300, 300, n).astype(np.int16))},
    }


@pytest.mark.parametrize("form", ["compressed", "dense"])
def test_decode_chunk_both_ship_forms(form):
    j = _encoded_chunk(jops, jnp.asarray)
    t = _encoded_chunk(tops, torch.from_numpy)
    if form == "dense":
        # the dense form passes through unchanged
        j = jops.decode_chunk(j)
        t = tops.decode_chunk(t)
        assert tops.decode_chunk(t) is t
    jd, td = jops.decode_chunk(j), tops.decode_chunk(t)
    assert set(td) == set(jd)
    assert td["tags_code"]["svc"].dtype == torch.int32
    assert np.array_equal(td["tags_code"]["svc"].numpy(), np.asarray(jd["tags_code"]["svc"]))
    for f in ("f", "v"):
        assert td["fields"][f].dtype == torch.float32
        assert np.array_equal(td["fields"][f].numpy(), np.asarray(jd["fields"][f]))


def test_decode_gathers_clamp():
    lut = torch.tensor([[7, 8], [9, 10]], dtype=torch.int32)
    codes = torch.tensor([0, 1, 5, -3], dtype=torch.int8)
    src = torch.tensor([0, 1, 1, 0], dtype=torch.int16)
    want = jops.dict_remap(
        jnp.asarray(codes.numpy()), jnp.asarray(lut.numpy()), jnp.asarray(src.numpy())
    )
    assert tops.dict_remap(codes, lut, src).tolist() == np.asarray(want).tolist()
    d = torch.tensor([1.5, 2.5])
    assert tops.dict_gather(d, torch.tensor([-1, 0, 1, 9])).tolist() == [1.5, 1.5, 2.5, 2.5]


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
def test_delta_and_dod_decode_match(dtype):
    rng = np.random.default_rng(2)
    deltas = rng.integers(-100, 100, 999).astype(dtype)
    want = jops.delta_decode(7, jnp.asarray(deltas))
    got = tops.delta_decode(7, torch.from_numpy(deltas))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert str(got.dtype).split(".")[-1] == str(np.asarray(want).dtype)
    dods = rng.integers(-5, 5, 999).astype(np.int32)
    want = jops.dod_decode(3, 11, jnp.asarray(dods))
    got = tops.dod_decode(3, 11, torch.from_numpy(dods))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_filter_masks_match():
    rng = np.random.default_rng(3)
    col = rng.integers(0, 10, 500).astype(np.int32)
    jc, tc = jnp.asarray(col), torch.from_numpy(col)
    for op in ("eq", "ne", "lt", "le", "gt", "ge"):
        assert np.array_equal(tops.cmp_mask(tc, op, 4).numpy(), np.asarray(jops.cmp_mask(jc, op, 4)))
    vals = np.asarray([1, 3, 8], np.int32)
    a = tops.in_set_mask(tc, torch.from_numpy(vals))
    assert np.array_equal(a.numpy(), np.asarray(jops.in_set_mask(jc, vals)))
    b = tops.time_range_mask(tc, 2, 6)
    assert np.array_equal(b.numpy(), np.asarray(jops.time_range_mask(jc, 2, 6)))
    assert np.array_equal(
        tops.mask_or(tops.mask_and(a, b), tops.mask_not(a)).numpy(),
        np.asarray(jops.mask_or(jops.mask_and(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())), ~jnp.asarray(a.numpy()))),
    )


def _nonfinite_inputs(n, g, seed):
    """Integer-valued f32 values (finite sums are exact in any order)
    with NaN, +inf and -inf planted in valid rows of groups 1..4 and in
    masked-out rows of groups 5..7."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, g, n).astype(np.int32)
    valid = rng.random(n) < 0.85
    vals = rng.integers(-50, 100, n).astype(np.float32)
    plant = [
        (1, True, np.nan), (2, True, np.inf), (3, True, -np.inf),
        (4, True, np.inf), (4, True, -np.inf),
        (5, False, np.nan), (6, False, np.inf), (7, False, -np.inf),
    ]
    for i, (grp, ok, v) in enumerate(plant):
        row = 97 * i + 13
        key[row], valid[row], vals[row] = grp, ok, v
    return key, valid, {"v": vals}


@pytest.mark.parametrize("ref_method", ["scatter", "sort"])
@pytest.mark.parametrize("method", ["kernel", "scatter", "sort"])
@pytest.mark.parametrize("n", [5000, 70000])
def test_group_reduce_non_finite_values_stay_in_their_group(ref_method, method, n):
    """A NaN or +-inf in a valid row reaches only its own group; in a
    masked-out row it counts nowhere (the JAX package's scatter and sort
    semantics; its matmul and Pallas methods spread it over the tile).
    Equal bits, NaN positions included, with one documented exception:
    at most 65,536 rows the reference's scatter adds without Kahan, so a
    lone +-inf stays inf there, while the port's kernel folds 2048-row
    tiles with Kahan, whose compensation turns it into NaN."""
    g = 16
    key, valid, fields = _nonfinite_inputs(n, g, seed=n)
    ref = jops.group_reduce(
        jnp.asarray(key), jnp.asarray(valid),
        {k: jnp.asarray(v) for k, v in fields.items()}, g, method=ref_method,
    )
    got = tops.group_reduce(
        torch.from_numpy(key), torch.from_numpy(valid),
        {k: torch.from_numpy(v) for k, v in fields.items()}, g, method=method,
    )
    assert np.array_equal(got.count.numpy(), np.asarray(ref.count))
    t, j = got.sums["v"].numpy(), np.asarray(ref.sums["v"])
    bad = ~np.isfinite(j)
    assert bad[[1, 2, 3, 4]].all() and np.isfinite(j[[0] + list(range(5, g))]).all()
    assert np.array_equal(~np.isfinite(t), bad)
    if method == "kernel" and n <= 65536:
        assert np.array_equal(t[~bad], j[~bad]) and np.isnan(t[bad]).all()
    else:
        assert np.array_equal(t, j, equal_nan=True)
    for mine, theirs in ((got.mins, ref.mins), (got.maxs, ref.maxs)):
        assert np.array_equal(mine["v"].numpy(), np.asarray(theirs["v"]), equal_nan=True)
