"""The precision contract of tests/test_precision.py, for the port's
``ops.group_reduce``.

Per-group f32 sums over multi-Mi-row chunks stay within rtol 1e-5 of
exact f64 — bounded-span f32 tile partials combined with
Kahan-compensated accumulation (ops/groupby.py) — and counts are exact.
Same data as the JAX package's test: G = 64 groups, gamma(2, 40) values
with rare 1e6 outliers, the adversarial case for naive f32 running
sums.  The methods: ``scatter`` at 4M rows, ``matmul_tiled`` at 1M, the
Hopper kernel's plain version (``kernel`` on CPU tensors) at 1M and
``matmul`` at 32K.

``sort`` forced at 4M is recorded as the reference's own behaviour:
each group's sorted run fills whole 65,536-row spans, and the JAX
package's ``sort`` misses rtol 1e-5 there by the same bits (max
relative error 1.148e-5).  The test holds the port to those bits; it
neither picks other data nor loosens the bound of the other methods.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from banyandb_tpu.ops.groupby import group_reduce as jax_group_reduce
from banyandb_tpu_torch.ops.groupby import group_reduce

G = 64
RTOL = 1e-5  # tests/test_precision.py's bound


def _mk(n, seed=11):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, G, n).astype(np.int32)
    vals = rng.gamma(2.0, 40.0, n).astype(np.float32)
    vals[rng.random(n) < 1e-4] = 1e6
    return key, vals


def _exact(key, vals):
    return (
        np.bincount(key, minlength=G).astype(np.float64),
        np.bincount(key, weights=vals.astype(np.float64), minlength=G),
    )


def _port(key, vals, method):
    n = key.shape[0]
    res = group_reduce(
        torch.from_numpy(key),
        torch.ones(n, dtype=torch.bool),
        {"v": torch.from_numpy(vals)},
        G,
        want_minmax=False,
        method=method,
    )
    return res.count.numpy().astype(np.float64), res.sums["v"].numpy()


@pytest.mark.parametrize(
    "method,n",
    [
        ("scatter", 4 << 20),  # the bench's mega-chunk shape
        ("matmul_tiled", 1 << 20),
        ("kernel", 1 << 20),  # the Hopper kernel's plain version
        ("matmul", 1 << 15),  # one [N, G+1] one-hot: keep it small
    ],
)
def test_group_sum_precision(method, n):
    key, vals = _mk(n)
    count, sums = _port(key, vals, method)
    exact_count, exact_sum = _exact(key, vals)
    np.testing.assert_array_equal(count, exact_count)
    np.testing.assert_allclose(sums.astype(np.float64), exact_sum, rtol=RTOL)


def test_forced_sort_at_4m_is_the_references_behaviour():
    n = 4 << 20
    key, vals = _mk(n)
    count, sums = _port(key, vals, "sort")
    ref = jax_group_reduce(
        jnp.asarray(key),
        jnp.asarray(np.ones(n, bool)),
        {"v": jnp.asarray(vals)},
        G,
        want_minmax=False,
        method="sort",
    )
    exact_count, exact_sum = _exact(key, vals)
    np.testing.assert_array_equal(count, exact_count)
    # the same bits as the JAX package's sort, group for group
    np.testing.assert_array_equal(sums, np.asarray(ref.sums["v"]))
    rel = np.abs(sums.astype(np.float64) - exact_sum) / exact_sum
    # and so the same miss of the 1e-5 bound (max relative error)
    assert f"{rel.max():.3e}" == "1.148e-05"
