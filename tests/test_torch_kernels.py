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
