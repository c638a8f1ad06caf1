"""Sparse frame-marginalization policy.

Mirrors the reference ``SparseFrameMarginalizationStrategy``
(reference: src/marginalization/src/sparse_frame_marginalization_strategy.cpp):

1. flag frames whose live landmark fraction dropped below
   1 − maximum_number_of_marginalized (while staying above the minimum
   window size) — :40-53;
2. if the window exceeds the maximum size, flag the frame maximizing DSO
   eq (20): √dist(newest) · Σ 1/(ε + dist(other)) — :101-140;
3. triage landmarks (:56-93): residual-to-newest not Ok or anchored in a
   flagged frame → marginalize if it survived ≥1 optimization else outlier;
   long-lived well-observed landmarks also marginalize.

Pure host logic over window summaries; returns boolean flags the PBA
marginalizer consumes.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from dsopp_tpu.solvers.pba import RES_OK, Window

KEEP_FRAMES_FROM_END = 2
MIN_FRAME_AGE = 1
EPS_DIST = 1e-5


def flags_device(window: Window, imm_counts, minimum_size: int,
                 maximum_size: int, maximum_marginalized_fraction: float):
    """Device-side (traceable) version of ``SparseMarginalizationStrategy.flags``.

    Same policy as the host implementation below — fixed-shape masked vector
    math instead of python loops, so the whole keyframe tick can run as one
    device program (zero host round-trips).  Returns jnp arrays
    (frame_flags [K] bool, landmark_flags [K,N] bool, new_outliers [K,N] bool).
    """
    k = window.num_slots
    idx = jnp.arange(k)
    fv = window.frame_valid
    f = jnp.sum(fv)
    live = window.lm_valid & ~window.lm_outlier
    active_counts = jnp.sum(live, axis=1) + jnp.asarray(imm_counts)
    total_counts = active_counts  # dropped landmarks are gone; host parity

    # 1. frames with too few live points (sequential budget → exclusive cumsum)
    elig1 = idx < f - KEEP_FRAMES_FROM_END
    cand1 = (elig1 & (total_counts > 0)
             & (active_counts
                < (1.0 - maximum_marginalized_fraction) * total_counts))
    prior = jnp.cumsum(cand1.astype(jnp.int32)) - cand1.astype(jnp.int32)
    flag1 = cand1 & ((f - prior) > minimum_size)

    # 2. DSO eq (20) distance score when the window is too large
    poses_t = window.poses().t
    ids = window.frame_id
    newest_id = jnp.take(ids, f - 1)
    t_new = jnp.take(poses_t, f - 1, axis=0)
    elig_i = elig1 & (ids + MIN_FRAME_AGE <= newest_id)
    elig_j = elig1 & (ids + MIN_FRAME_AGE <= newest_id + 1)
    dist = jnp.linalg.norm(poses_t[:, None, :] - poses_t[None, :, :], axis=-1)
    inv_sum = jnp.sum(
        jnp.where(elig_j[None, :] & ~jnp.eye(k, dtype=bool),
                  1.0 / (EPS_DIST + dist), 0.0), axis=1)
    score = jnp.sqrt(jnp.linalg.norm(poses_t - t_new[None, :], axis=-1)) * inv_sum
    score = jnp.where(elig_i, score, 0.0)
    best_i = jnp.argmax(score)
    need2 = f > maximum_size + jnp.sum(flag1)
    flag2 = need2 & (score[best_i] > 0) & (idx == best_i)
    frame_flags = flag1 | flag2

    # 3. landmark triage
    tri = ((idx < f - 1) & (f > KEEP_FRAMES_FROM_END))[:, None]
    status_newest = jnp.take(window.res_status, f - 1, axis=1)  # [K, N]
    oob = (status_newest != RES_OK) | frame_flags[:, None]
    min_good = (minimum_size + 1) // 2
    good_opts = maximum_size * 2
    valid_marg = (window.lm_inliers >= min_good) & (window.lm_opt_count > good_opts)
    sufficient = window.lm_opt_count > 0
    new_outliers = tri & live & oob & ~sufficient
    lm_flags = tri & live & ~new_outliers & (oob | valid_marg)

    # landmarks of flagged frames must all leave the active set
    lm_flags = lm_flags | (
        (idx < f)[:, None] & frame_flags[:, None] & live & ~new_outliers)
    return frame_flags, lm_flags, new_outliers


def kept_first_perm(frame_valid, frame_flags):
    """Stable kept-frames-first slot permutation (matches the host
    ``marginalize`` wrapper: kept valid frames in order, then the rest)."""
    k = frame_valid.shape[0]
    key = jnp.where(frame_valid & ~frame_flags, 0, 1)
    return jnp.argsort(key, stable=True).astype(jnp.int32)


@dataclass
class SparseMarginalizationStrategy:
    minimum_size: int = 5
    maximum_size: int = 7
    maximum_marginalized_fraction: float = 0.95

    def flags(self, window: Window, immature_counts=None, host=None):
        """→ (frame_flags [K] bool, landmark_flags [K,N] bool, outlier_flags).

        ``immature_counts``: per-slot count of live immature points (they
        count as "active" for the frame-dropping heuristic).
        ``host``: optional dict of pre-fetched numpy copies of the window
        fields (keys: frame_valid, lm_valid, lm_outlier, lm_opt_count,
        lm_inliers, poses_t, frame_id, res_status) — the caller batches
        these into one device→host transfer.
        """
        k = window.num_slots
        f = window.frame_count()
        if host is None:
            host = {
                "frame_valid": np.asarray(window.frame_valid),
                "lm_valid": np.asarray(window.lm_valid),
                "lm_outlier": np.asarray(window.lm_outlier),
                "lm_opt_count": np.asarray(window.lm_opt_count),
                "lm_inliers": np.asarray(window.lm_inliers),
                "poses_t": np.asarray(window.poses().t),
                "frame_id": np.asarray(window.frame_id),
                "res_status": None,   # fetched lazily below
            }
        frame_valid = host["frame_valid"]
        lm_valid = host["lm_valid"]
        lm_outlier = host["lm_outlier"]
        lm_marginalized_count = np.zeros(k)  # dropped landmarks are gone; approximate
        lm_opt = host["lm_opt_count"]
        lm_inl = host["lm_inliers"]
        poses_t = host["poses_t"]

        frame_flags = np.zeros(k, bool)
        if immature_counts is None:
            immature_counts = np.zeros(k)

        # 1. frames with too few live points
        active_counts = (lm_valid & ~lm_outlier).sum(1) + np.asarray(immature_counts)
        total_counts = active_counts + lm_marginalized_count
        for i in range(max(f - KEEP_FRAMES_FROM_END, 0)):
            if total_counts[i] <= 0:
                continue
            if active_counts[i] < (1 - self.maximum_marginalized_fraction) * total_counts[i]:
                if f - frame_flags.sum() > self.minimum_size:
                    frame_flags[i] = True

        # 2. DSO eq (20) distance score when window too large
        if f > self.maximum_size + frame_flags.sum():
            ids = host["frame_id"]
            newest_id = ids[f - 1]
            best, best_i = 0.0, None
            for i in range(max(f - KEEP_FRAMES_FROM_END, 0)):
                if ids[i] + MIN_FRAME_AGE > newest_id:
                    continue
                score = 0.0
                for j in range(max(f - KEEP_FRAMES_FROM_END, 0)):
                    if i == j or ids[j] + MIN_FRAME_AGE > newest_id + 1:
                        continue
                    score += 1.0 / (EPS_DIST + np.linalg.norm(poses_t[i] - poses_t[j]))
                score *= np.sqrt(np.linalg.norm(poses_t[i] - poses_t[f - 1]))
                if score > best:
                    best, best_i = score, i
            if best_i is not None:
                frame_flags[best_i] = True

        # 3. landmark triage
        lm_flags = np.zeros_like(lm_valid)
        new_outliers = np.zeros_like(lm_valid)
        if f > KEEP_FRAMES_FROM_END:
            status = host["res_status"]              # [anchor, target, n]
            if status is None:
                status = np.asarray(window.res_status)
            newest = f - 1
            min_good = (self.minimum_size + 1) // 2
            good_opts = self.maximum_size * 2
            for i in range(f - 1):
                live = lm_valid[i] & ~lm_outlier[i]
                last_not_ok = status[i, newest] != RES_OK
                oob = last_not_ok | frame_flags[i]
                valid_marg = (lm_inl[i] >= min_good) & (lm_opt[i] > good_opts)
                sufficient = lm_opt[i] > 0
                new_outliers[i] = live & oob & ~sufficient
                lm_flags[i] = live & ~new_outliers[i] & (oob | valid_marg)

        # landmarks of flagged frames must all leave the active set
        for i in range(f):
            if frame_flags[i]:
                live = lm_valid[i] & ~lm_outlier[i] & ~new_outliers[i]
                lm_flags[i] = lm_flags[i] | live

        return frame_flags, lm_flags, new_outliers
