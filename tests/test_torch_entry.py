"""The port's driver entry points (``banyandb_tpu_torch/entry.py``)
against the JAX package's (``__graft_entry__.py``).

- ``entry()``: the flagship per-chunk step on the same numpy chunk
  (seed 0, 8,192 rows) through ``jax.jit`` of the JAX step and through
  the port's step on ``"cpu"`` (``fused_group_multi`` takes its plain
  version there).  Tolerance (the precision contract of
  ``tests/test_precision.py``): counts, min/max and the histogram
  equal; the f32 latency sums within rtol 1e-5.
- ``dryrun_multichip(n)`` over n explicit CPU slots (4 and 8), with the
  JAX package's ``_dryrun_impl`` host-union count beside it; too few
  slots or cards raise.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from banyandb_tpu_torch import entry as tentry

RTOL = 1e-5
REPO = Path(__file__).resolve().parent.parent


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree)


def test_entry_step_matches_jax_entry():
    jfn, jargs = graft.entry()
    want = _np(jax.device_get(jax.jit(jfn)(*jargs)))
    step, args = tentry.entry(device="cpu")
    # the same chunk, drawn from the same seed
    for k in ("valid", "series", "ts"):
        np.testing.assert_array_equal(args[0][k].numpy(), np.asarray(jargs[0][k]))
    got = _np(step(*args))
    assert set(got) == set(want)
    assert got["count"].shape == (64,)
    np.testing.assert_array_equal(got["count"], want["count"])
    np.testing.assert_array_equal(got["hist"], want["hist"])
    for k in ("mins", "maxs"):
        for f in want[k]:
            np.testing.assert_array_equal(got[k][f], want[k][f])
    for f in want["sums"]:
        np.testing.assert_allclose(got["sums"][f], want["sums"][f], rtol=RTOL, atol=0)
    # the predicate (region != 3) took rows out, and the count saw them
    keep = args[0]["tags_code"]["region"].numpy() != 3
    assert int(got["count"].sum()) == int(keep.sum()) < 8192


def test_entry_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tentry.entry()


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_over_cpu_slots(n):
    out = tentry.dryrun_multichip(n, devices=["cpu"] * n)
    assert out["slots"] == ["cpu"] * n
    assert out["shape"] == {"shard": n // 2, "seg": 2}
    assert out["count"] == out["expect"] > 0
    assert out["cluster"] == {"executions": 1, "count": 512, "expect": 512}
    # the same rows through the JAX package's host union (seed 7)
    rng = np.random.default_rng(7)
    want = 0
    for _ in range(n):
        rng.integers(0, 8, 256)
        want += int((rng.integers(0, 3, 256) == 1).sum())
        rng.gamma(2.0, 40.0, 256)
    assert out["count"] == want


def test_dryrun_multichip_runs_the_jax_plan_shape():
    """The JAX dryrun over its 8 host devices counts what the port's
    does over 8 CPU slots (the host-union count of the same rows); the
    JAX run stops at its cluster fast path, which does not trace under
    the installed JAX (ROADMAP Queue 3), so only its collective step is
    run here."""
    from banyandb_tpu.parallel import (
        DistPlan,
        distributed_aggregate,
        make_mesh,
        stack_shard_chunks,
    )

    rng = np.random.default_rng(7)
    per_device = [
        {
            "tags": {
                "svc": rng.integers(0, 8, 256).astype(np.int32),
                "region": rng.integers(0, 3, 256).astype(np.int32),
            },
            "fields": {"latency": rng.gamma(2.0, 40.0, 256).astype(np.float32)},
        }
        for _ in range(8)
    ]
    plan = DistPlan(tags_code=("region", "svc"), fields=("latency",),
                    group_tags=("svc",), radices=(8,), num_groups=8,
                    eq_preds=("region",), topn=3, want_hist="latency")
    mesh = make_mesh(4, 2)
    chunks = stack_shard_chunks(mesh, per_device, plan.tags_code, plan.fields, 256)
    jout = distributed_aggregate(mesh, plan, chunks, pred_codes={"region": 1},
                                 hist_lo=0.0, hist_span=1000.0)
    out = tentry.dryrun_multichip(8, devices=["cpu"] * 8)
    assert out["count"] == int(np.asarray(jout["count"]).sum())


def test_dryrun_multichip_too_few_slots_raise():
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        tentry.dryrun_multichip(4, devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        # default slots are the CUDA cards: none here
        with pytest.raises(ValueError, match="needs 8 devices, have 0"):
            tentry.dryrun_multichip(8)


def test_entry_module_runs_with_python_m():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    ok = subprocess.run(
        [sys.executable, "-m", "banyandb_tpu_torch.entry", "--device", "cpu",
         "--slots", "4"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert ok.returncode == 0, ok.stderr
    assert "entry() ok: {'count': (64,), 'hist': (64, 512)}" in ok.stdout
    assert "dryrun_multichip(4) ok:" in ok.stdout
    if not torch.cuda.is_available():
        bad = subprocess.run(
            [sys.executable, "-m", "banyandb_tpu_torch.entry"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
        )
        assert bad.returncode != 0
        assert "CUDA is not available" in bad.stderr
