"""Port parity: the plain versions of the Hopper kernels
(banyandb_tpu_torch.ops.hopper_kernels) against the Pallas kernels of
banyandb_tpu.ops.pallas_kernels run in interpret mode, on the same numpy
inputs.  On CPU tensors the wrappers take the plain versions, which is
what these tests reach; the kernels themselves are held against the
same plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances: counts are exact; sums are exact on integer-valued data
(f32 is exact below 2^24 per tile in any order) and within rtol=1e-5
otherwise (tests/test_precision.py's contract), because the two sum
in a different order inside a tile (MXU contraction vs row order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banyandb_tpu.ops import pallas_kernels as pk
from banyandb_tpu_torch.ops import hopper_kernels as hk

RTOL = 1e-5


def _inputs(n, f, g, integer, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, g + 1, n).astype(np.int32)  # g = spill code
    pred = rng.random(n) < 0.8
    valid = rng.random(n) < 0.9
    if integer:
        vals = rng.integers(-50, 100, (f, n)).astype(np.float32)
    else:
        vals = rng.gamma(2.0, 40.0, (f, n)).astype(np.float32)
    return codes, pred, vals, valid


def _jax(codes, pred, vals, valid, g):
    c, s = pk.fused_group_multi(
        jnp.asarray(codes), jnp.asarray(pred), jnp.asarray(vals),
        jnp.asarray(valid), num_groups=g, interpret=True,
    )
    return np.asarray(c), np.asarray(s)


def _torch(codes, pred, vals, valid, g):
    c, s = hk.fused_group_multi(
        torch.from_numpy(codes), torch.from_numpy(pred),
        torch.from_numpy(vals), torch.from_numpy(valid), num_groups=g,
    )
    return c.numpy(), s.numpy()


@pytest.mark.parametrize(
    "n,f,g,integer",
    [
        (0, 2, 16, True),  # N = 0 returns zeros
        (4096, 0, 64, True),  # F = 0 returns the count only
        (4096, 2, 100, True),  # G not a multiple of 128
        (4096, 1, 8192, True),  # four 2048-wide group tiles on the TPU
        (6144, 3, 300, False),  # non-integer sums: rtol
    ],
)
def test_fused_group_multi_matches_pallas(n, f, g, integer):
    args = _inputs(n, f, g, integer, seed=n + f + g)
    jc, js = _jax(*args, g)
    tc, ts = _torch(*args, g)
    assert tc.dtype == np.float32 and ts.dtype == np.float32
    assert tc.shape == (g,) and ts.shape == (f, g) == js.shape
    assert np.array_equal(tc, jc)
    if integer:
        assert np.array_equal(ts, js)
    else:
        np.testing.assert_allclose(ts, js, rtol=RTOL, atol=0)


def test_fused_group_sum_matches_pallas():
    codes, pred, vals, valid = _inputs(4096, 1, 37, True, seed=5)
    jc, js = pk.fused_group_sum(
        jnp.asarray(codes), jnp.asarray(pred), jnp.asarray(vals[0]),
        jnp.asarray(valid), num_groups=37, interpret=True,
    )
    tc, ts = hk.fused_group_sum(
        torch.from_numpy(codes), torch.from_numpy(pred),
        torch.from_numpy(vals[0]), torch.from_numpy(valid), num_groups=37,
    )
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(ts.numpy(), np.asarray(js))


def test_fused_group_multi_rejects_bad_input():
    codes, pred, vals, valid = (
        torch.from_numpy(a) for a in _inputs(2049, 1, 8, True, seed=1)
    )
    with pytest.raises(ValueError):  # ragged N
        hk.fused_group_multi(codes, pred, vals, valid, num_groups=8)
    codes, pred, vals, valid = (
        torch.from_numpy(a) for a in _inputs(2048, 1, 8, True, seed=1)
    )
    with pytest.raises(TypeError):  # codes must be int32
        hk.fused_group_multi(codes.long(), pred, vals, valid, num_groups=8)
    with pytest.raises(ValueError):  # values must be [F, N]
        hk.fused_group_multi(codes, pred, vals[0], valid, num_groups=8)


@pytest.mark.parametrize("dtype,lo,hi", [(np.int8, -128, 128), (np.int16, -32768, 32768)])
def test_widen_narrow_matches_pallas(dtype, lo, hi):
    x = np.random.default_rng(9).integers(lo, hi, 2 * hk.TILE).astype(dtype)
    want = np.asarray(pk.widen_narrow(jnp.asarray(x), interpret=True))
    got = hk.widen_narrow(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


def test_widen_narrow_rejects_bad_input():
    with pytest.raises(ValueError):  # ragged N
        hk.widen_narrow(torch.zeros(2049, dtype=torch.int8))
    with pytest.raises(TypeError):  # not a narrow dtype
        hk.widen_narrow(torch.zeros(2048, dtype=torch.int32))
    with pytest.raises(ValueError):  # 2-D
        hk.widen_narrow(torch.zeros((2, 2048), dtype=torch.int8))


def test_plain_fallback_only_for_cpu_tensors():
    """No CUDA here: the wrapper took the plain version because the
    tensor lies on the CPU, and counted no launch."""
    hk.reset_launches()
    hk.widen_narrow(torch.zeros(2048, dtype=torch.int8))
    codes, pred, vals, valid = (
        torch.from_numpy(a) for a in _inputs(2048, 1, 8, True, seed=2)
    )
    hk.fused_group_multi(codes, pred, vals, valid, num_groups=8)
    hk.fused_group_sum(codes, pred, vals[0], valid, num_groups=8)
    hk.prefix_sum_narrow(torch.zeros(2048, dtype=torch.int32))
    assert hk.LAUNCHES == {
        "fused_group_multi": 0, "fused_group_sum": 0, "widen_narrow": 0,
        "prefix_sum_narrow": 0,
    }


# -- the card kernel's fold order, modelled in numpy ---------------------------
#
# csrc/fused_group.cu sums each 2048-row tile into an f32 partial, folds
# a row block's tiles in tile order with Kahan (blocks from
# hk._partition), then folds the blocks' (sum, compensation) pairs in
# float-float: in block order within each of hk._FOLD_CHUNKS chunks, then
# over the chunks in order.  The model takes each tile partial rounded
# once from f64 (the kernel's in-tile order is not modelled; integer
# partials are exact either way) and the fold exactly as the kernel
# does it, in f32 (adds only, so no FMA contraction on the card).


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _ff_add(hi, lo, bh, bl):
    s, e = _two_sum(hi, bh)
    e = e + (lo + bl)
    hi = s + e
    return hi, e - (hi - s)


def _fold_model(codes, pred, vals, valid, g):
    n, nf = codes.shape[0], vals.shape[0]
    tiles = n // hk.TILE
    m = pred & valid & (codes >= 0) & (codes < g)
    slot = (np.arange(n) // hk.TILE * g + codes)[m]
    parts = np.stack(
        [np.bincount(slot, minlength=tiles * g)]
        + [np.bincount(slot, weights=vals[k][m].astype(np.float64),
                       minlength=tiles * g) for k in range(nf)]
    ).reshape(1 + nf, tiles, g).astype(np.float32)
    pairs = []
    for t0, t1 in hk._partition(n, nf, g):
        s = np.zeros((1 + nf, g), np.float32)
        c = np.zeros_like(s)
        for t in range(t0, t1):
            y = parts[:, t] - c
            u = s + y
            c = (u - s) - y
            s = u
        pairs.append(_two_sum(s, -c))
    blocks, k = len(pairs), hk._FOLD_CHUNKS
    zero = np.zeros((1 + nf, g), np.float32)
    hi, lo = zero, zero
    for w in range(k):
        chi, clo = zero, zero
        for p in range(w * blocks // k, (w + 1) * blocks // k):
            chi, clo = _ff_add(chi, clo, *pairs[p])
        hi, lo = _ff_add(hi, lo, chi, clo)
    out = hi + lo
    return out[0], out[1:]


@pytest.mark.parametrize("nf,g", [(2, 1024), (1, 8192), (0, 16), (2, 8192), (3, 300)])
def test_partition_covers_every_tile_once(nf, g):
    for n in range(0, (1 << 22) + 1, hk.TILE):
        blocks = hk._partition(n, nf, g)
        tiles = n // hk.TILE
        assert blocks == hk._partition(n, nf, g)  # fixed by (N, F, G)
        assert len(blocks) <= min(tiles, hk._BLOCKS)
        assert [t for t0, t1 in blocks for t in range(t0, t1)] == list(range(tiles))
        assert all(t1 > t0 for t0, t1 in blocks)


@pytest.mark.parametrize(
    "g,nf", [(1024, 2), (1024, 1), (100, 2), (16, 0), (300, 3), (8192, 2),
             (8192, 4), (100000, 2)]
)
def test_group_tile_fits_one_block(g, nf):
    gt = hk._group_tile(g, nf)
    assert gt % 32 == 0 and 32 <= gt <= 2048
    assert hk._smem_bytes(gt, nf) <= hk._SMEM_BUDGET
    if g <= 1024 and nf <= 2:
        assert gt >= g  # one group tile: every row read once


def _plain_np(codes, pred, vals, valid, g):
    c, s = hk.fused_group_multi_plain(
        torch.from_numpy(codes), torch.from_numpy(pred),
        torch.from_numpy(vals), torch.from_numpy(valid), g,
    )
    return c.numpy(), s.numpy()


@pytest.mark.parametrize("n", [2048, 6144, 133 * 2048, 1 << 20])
def test_fold_model_integer_data_bit_equal_to_plain(n):
    args = _inputs(n, 2, 1024, True, seed=n)
    mc, ms = _fold_model(*args, 1024)
    pc, ps = _plain_np(*args, 1024)
    assert np.array_equal(mc, pc)
    assert np.array_equal(ms, ps)


@pytest.mark.parametrize("n,g", [(1 << 20, 1024), (1001 * 2048, 1024), (133 * 2048, 8192),
                                 (3 * 2048, 64)])
def test_fold_model_gamma_data_within_rtol(n, g):
    codes, pred, vals, valid = _inputs(n, 2, g, False, seed=n + 1)
    mc, ms = _fold_model(codes, pred, vals, valid, g)
    pc, ps = _plain_np(codes, pred, vals, valid, g)
    assert np.array_equal(mc, pc)
    np.testing.assert_allclose(ms, ps, rtol=RTOL, atol=0)
    m = pred & valid & (codes < g)
    oracle = np.stack([
        np.bincount(codes[m], weights=vals[k][m].astype(np.float64), minlength=g)
        for k in range(2)
    ])
    np.testing.assert_allclose(ms, oracle, rtol=RTOL, atol=0)
    np.testing.assert_allclose(ps, oracle, rtol=RTOL, atol=0)
