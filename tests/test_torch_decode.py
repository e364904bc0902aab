"""Port parity of the delta decode: the JAX package's Pallas prefix sum
(interpret mode) and ``banyandb_tpu.ops.delta_decode`` against the
port's ``prefix_sum_narrow_plain`` and ``banyandb_tpu_torch.ops
.delta_decode`` on the same seeded numpy inputs.

Mirrors tests/test_decode.py::test_pallas_prefix_sum_matches_cumsum, the
``test_delta_decode_*`` tests and test_dod_decode_matches_reference_shape
there, and tests/test_ops_kernels.py::test_delta_decode_matches_numpy.
On CPU tensors the port's wrapper takes the plain version; the CUDA
kernel is held against it on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Tolerance: exact equality (integer math, wrapping mod
2^32 like ``jnp.cumsum`` in i32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banyandb_tpu import ops as jops
from banyandb_tpu.ops import pallas_kernels as pk
from banyandb_tpu.utils import encoding as enc
from banyandb_tpu_torch import ops as tops
from banyandb_tpu_torch.ops import hopper_kernels as hk

T0 = 1_700_000_000_000


def _both_decode(first, deltas: np.ndarray):
    """-> (JAX delta_decode, port delta_decode) as numpy arrays."""
    j = np.asarray(jops.delta_decode(first, jnp.asarray(deltas)))
    t = tops.delta_decode(first, torch.from_numpy(deltas)).numpy()
    return j, t


@pytest.mark.parametrize(
    "case", ["int16-small", "int32-wide", "wraps-past-2^31", "wraps-below"]
)
def test_prefix_sum_matches_pallas(case):
    rng = np.random.default_rng(7)
    if case == "int16-small":
        x = rng.integers(-1000, 1000, 2 * pk.TILE).astype(np.int16)
    elif case == "int32-wide":
        x = rng.integers(-(2**31), 2**31, 3 * pk.TILE, dtype=np.int64)
    elif case == "wraps-past-2^31":
        x = np.full(4 * pk.TILE, 2**20, dtype=np.int64)  # total 2^33
    else:
        x = np.full(pk.TILE, -(2**22), dtype=np.int64)  # total -2^33
    want = np.asarray(pk.prefix_sum_narrow(jnp.asarray(x), interpret=True))
    x32 = x.astype(np.int32)
    got = hk.prefix_sum_narrow(torch.from_numpy(x32))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(hk.prefix_sum_narrow_plain(torch.from_numpy(x32)).numpy(), want)
    assert np.array_equal(want, np.cumsum(x32, dtype=np.int32))
    if case.startswith("wraps"):
        assert np.abs(np.cumsum(x32.astype(np.int64))).max() >= 2**31


def test_prefix_sum_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple"):
        hk.prefix_sum_narrow(torch.zeros(100, dtype=torch.int32))
    with pytest.raises(TypeError, match="dtype"):
        hk.prefix_sum_narrow(torch.zeros(pk.TILE, dtype=torch.int64))
    with pytest.raises(ValueError, match="1-D"):
        hk.prefix_sum_narrow(torch.zeros((2, pk.TILE), dtype=torch.int32))
    assert hk.prefix_sum_narrow(torch.zeros(0, dtype=torch.int32)).shape == (0,)


@pytest.mark.parametrize("n", [257, pk.TILE - 1, 3 * pk.TILE - 1])
def test_delta_decode_matches_numpy(n):
    """test_ops_kernels.py::test_delta_decode_matches_numpy, and the
    kernel's shape class (len(deltas) + 1 a TILE multiple)."""
    rng = np.random.default_rng(n)
    vals = rng.integers(-1000, 1000, size=n + 1).cumsum().astype(np.int32)
    deltas = np.diff(vals).astype(np.int32)
    j, t = _both_decode(int(vals[0]), deltas)
    assert t.shape[-1] == len(vals)
    assert np.array_equal(t, vals) and np.array_equal(t, j)


def test_delta_decode_roundtrips_encoder():
    vals = np.array([5, 7, 7, 100, -3, 2**31 - 1], dtype=np.int64)
    blob = enc.encode_int64(vals)
    assert blob[0] == 1  # delta mode
    j, t = _both_decode(int(vals[0]), np.diff(vals).astype(np.int32))
    assert np.array_equal(t, vals.astype(np.int32)) and np.array_equal(t, j)


def test_delta_decode_single_row_no_deltas():
    j, t = _both_decode(42, np.zeros((0,), np.int32))
    assert t.tolist() == [42] == j.tolist()


@pytest.mark.parametrize("lo,hi", [(-128, 127), (-32768, 32767)])
def test_delta_decode_downcast_boundary_values(lo, hi):
    vals = np.cumsum(np.array([0, hi, lo, hi, lo, hi], dtype=np.int64)) + 1000
    assert np.array_equal(enc.decode_int64(enc.encode_int64(vals), len(vals)), vals)
    j, t = _both_decode(int(vals[0]), np.diff(vals).astype(np.int32))
    assert np.array_equal(t, vals.astype(np.int32)) and np.array_equal(t, j)


@pytest.mark.parametrize("dtype", [np.int8, np.int16])
def test_delta_decode_widens_narrow_deltas(dtype):
    rng = np.random.default_rng(3)
    info = np.iinfo(dtype)
    deltas = rng.integers(info.min, info.max + 1, 4 * pk.TILE - 1).astype(dtype)
    j, t = _both_decode(-5, deltas)
    assert t.dtype == np.int32 and np.array_equal(t, j)


def test_delta_decode_wraps_like_jax():
    """i32 deltas whose running sum passes 2^31 wrap mod 2^32 in both."""
    deltas = np.full(pk.TILE - 1, 2**21, dtype=np.int32)
    j, t = _both_decode(2**31 - 1, deltas)
    assert np.array_equal(t, j) and t.min() < 0


def test_delta_decode_rejects_unrebased_i64_first():
    with pytest.raises(ValueError, match="rebase"):
        jops.delta_decode(T0, jnp.ones(7, jnp.int8))
    with pytest.raises(ValueError, match="rebase"):
        tops.delta_decode(T0, torch.ones(7, dtype=torch.int8))
    with pytest.raises(ValueError, match="rebase"):
        tops.delta_decode(np.int64(T0), torch.ones(7, dtype=torch.int32))


def test_dod_decode_matches_reference_shape():
    vals = np.arange(10, dtype=np.int64) * 7 + 3
    deltas = np.diff(vals)
    dods = np.diff(deltas, prepend=deltas[0])
    dods[0] = 0
    dods = dods.astype(np.int32)
    j = np.asarray(jops.dod_decode(int(vals[0]), int(deltas[0]), jnp.asarray(dods)))
    t = tops.dod_decode(int(vals[0]), int(deltas[0]), torch.from_numpy(dods)).numpy()
    assert np.array_equal(t, vals.astype(np.int32)) and np.array_equal(t, j)
