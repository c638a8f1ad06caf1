"""Sharded BA equivalence tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dsopp_tpu.parallel.mesh import make_mesh
from dsopp_tpu.parallel.sharded import (
    batched_train_step,
    shard_windows,
    stack_windows,
)


def _problems(n=2, landmarks=64):
    from __graft_entry__ import _tiny_problem

    ws, cam = [], None
    for _ in range(n):
        w, cam = _tiny_problem(dtype=jnp.float64, landmarks=landmarks, size=48)
        ws.append(w)
    return ws, cam


def test_sharded_matches_single_device():
    """dp×mp sharded step must produce identical results to unsharded."""
    ws, cam = _problems(2)
    stacked = stack_windows(ws)
    reg = jnp.asarray(1e-5, jnp.float64)

    ref = batched_train_step(stacked, cam, reg)

    mesh = make_mesh(2, 4)
    with mesh:
        sharded_in = shard_windows(stacked, mesh)
        out = batched_train_step(sharded_in, cam, reg)

    for a, b in zip(ref, out):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-8, atol=1e-10)


def test_lm_only_mesh():
    ws, cam = _problems(2)
    stacked = stack_windows(ws)
    mesh = make_mesh(1, 8)
    with mesh:
        out = batched_train_step(
            shard_windows(stacked, mesh), cam, jnp.asarray(1e-5, jnp.float64))
    assert bool(jnp.all(jnp.isfinite(out[2])))


def test_entry_point():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert all(bool(jnp.all(jnp.isfinite(o))) for o in jax.tree_util.tree_leaves(out))


@pytest.mark.slow
def test_dryrun_multichip():
    """The driver's multi-chip dry run: full sharded solver + marg fold +
    a 20-frame tracked segment under the 8-device mesh (~3 min compile)."""
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_tracked_segment_matches_unsharded():
    """A short sequence-sharded tracked segment against the same batch run
    unsharded on one device (the comparison ``chip_smoke.py --multi`` runs
    on four cards)."""
    import __graft_entry__ as ge

    first, final = ge._dryrun_tracked_segment(2, num_frames=4)
    assert first < ge.FIRST_TICK_TOL
    assert final < ge.FINAL_POSE_TOL
