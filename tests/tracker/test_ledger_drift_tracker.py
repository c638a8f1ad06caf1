"""Tracker-level ledger drift: f32+df64 device path vs the CPU-x64 oracle.

The marginalization ledger accumulates dozens of folds over a long run;
``core/df64.py`` keeps it in compensated double-float pairs so the f32 device
path does not lose small updates against the grown prior (DSO eq 8.15/8.19
ledger, reference eigen_photometric_bundle_adjustment.cpp).

What can be gated: POSE-WISE equality between an f32 and an f64 run does
not survive a long horizon — last-ulp differences flip near-tied epipolar
``argmin`` samples and the keyframe/marginalization cascade amplifies them
chaotically (measured here: agreement at ~1e-9 for the first keyframes,
then a step to centimeters; the same effect documented for cross-compiled
runs in tests/tracker/test_batched_loop.py).  The operational claim that
DOES survive — and what a broken ledger would destroy — is tracking
QUALITY: after ~30 marginalization folds under exposure variation, the
f32+df64 path must track ground truth as well as the float64 oracle does.

The ledger ARITHMETIC itself is gated exactly (300-fold property test vs
f64 in tests/core/test_df64.py); this test gates the end-to-end
consequence at the tracker level.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from dsopp_tpu.core.lie import SE3
from dsopp_tpu.testing import render_sequence
from dsopp_tpu.tracker.device_loop import PipelinedTracker
from dsopp_tpu.tracker.monocular import MonocularTracker, TrackerConfig

NUM_FRAMES = 150
INIT_FRAMES = 6
H, W = 120, 160

CFG = TrackerConfig(
    num_frame_slots=7,
    landmarks_per_frame=96,
    immature_per_frame=192,
    desired_points=400,
    frontend_points=600,
    keyframe_factor=3.0,
    window_min=3,
    window_max=4,          # small window → frequent marginalization folds
    use_rotation_perturbations=False,
)


def _run(dtype):
    seq = render_sequence(num_frames=NUM_FRAMES, height=H, width=W,
                          seed=5, advance=0.07)
    tracker = MonocularTracker(seq.camera, CFG, dtype=dtype)
    tracker.initialize([
        (i, float(seq.timestamps[i]), seq.images[i],
         SE3(jnp.asarray(seq.pose_t_wc(i).q, dtype),
             jnp.asarray(seq.pose_t_wc(i).t, dtype)))
        for i in range(INIT_FRAMES)
    ])
    pipe = PipelinedTracker(tracker, flush_every=16)
    for i in range(INIT_FRAMES, NUM_FRAMES):
        # NOTE: no synthetic exposure gain here — the affine-brightness
        # priors are reference-strength (1e12/1e8, standart.yaml), which
        # PINS (a, b) near zero: without dataset exposure times (the
        # reference's photometric-calibration input) a gained image is
        # out-of-model for both paths and only measures divergence noise
        pipe.tick(i, float(seq.timestamps[i]),
                  jnp.asarray(seq.images[i], dtype))
    tracker = pipe.finalize()
    n_marg = len(tracker.track.marginalized)
    traj = {round(t, 6): np.asarray(m)[:3, 3]
            for t, m in tracker.track.trajectory(tracker.window)}
    return traj, n_marg, seq


def _gt_rmse(traj, seq):
    gt = {round(float(seq.timestamps[i]), 6):
          np.asarray(seq.pose_t_wc(i).t, np.float64)
          for i in range(NUM_FRAMES)}
    errs = np.asarray([np.linalg.norm(traj[t] - gt[t])
                       for t in traj if t in gt])
    return float(np.sqrt((errs ** 2).mean())), len(errs)


@pytest.mark.slow
def test_f32_df64_tracker_tracks_like_the_x64_oracle():
    """150 frames, natural keyframe cadence, many ledger folds per path."""
    traj32, n_marg32, seq = _run(jnp.float32)
    traj64, n_marg64, _ = _run(jnp.float64)
    # both paths actually exercised the ledger repeatedly
    assert n_marg32 >= 8, f"only {n_marg32} marginalized keyframes (f32)"
    assert n_marg64 >= 8, f"only {n_marg64} marginalized keyframes (f64)"

    rmse64, n64 = _gt_rmse(traj64, seq)
    rmse32, n32 = _gt_rmse(traj32, seq)
    assert n64 >= NUM_FRAMES - INIT_FRAMES - 2
    assert n32 >= NUM_FRAMES - INIT_FRAMES - 2

    # the x64 oracle holds the trajectory over the ~10 m path (this
    # fixture is deliberately harsh — 120x160, W=4, 400 pts: solo 30-frame
    # runs measure 0.09-0.13 m (test_batched_loop), and monocular scale
    # drift compounds over 5x the horizon; measured oracle: ~0.22 m ≈ 2%)
    assert rmse64 < 0.35, f"oracle run RMSE {rmse64:.4f} m"
    # ...and the f32 path with the df64 ledger tracks AT LEAST as well —
    # a plain-f32 ledger loses the fold updates against the grown prior
    # and blows these bounds.  One-sided: cross-precision runs differ by
    # chaos-level run-to-run variance in BOTH directions (measured here:
    # f32 0.118 m vs oracle 0.217 m), and only "f32 materially worse"
    # indicates ledger damage.
    assert rmse32 < 0.35, f"f32+df64 run RMSE {rmse32:.4f} m"
    assert rmse32 < rmse64 + 0.08, (rmse32, rmse64)
