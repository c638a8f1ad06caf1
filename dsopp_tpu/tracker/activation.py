"""Immature-landmark activation (reference LandmarksActivator).

Mirrors src/tracker/landmarks_activator/src/landmarks_activator.cpp:

* existing active landmarks are reprojected into the newest keyframe
  (:51-84); a P-controller on ``min_distance_to_neighbor`` regulates point
  density toward ``number_of_desired_points`` (:29-38);
* an immature point activates when it is ready (readyForActivation:
  traced, interval < 8 px, uniqueness > 3, positive idepth), reprojects
  validly into the newest frame, and has no active neighbor within the
  distance (:86-120);
* activated points become active landmarks anchored in their host keyframe.

Fixed-shape deviation: the reference's sequential greedy scan (each accepted
candidate blocks later ones) is replaced by a parallel test against the
ACTIVE point set only — candidate-vs-candidate spacing is already enforced
by the block-structured extractor, and the density controller absorbs any
residual difference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from dsopp_tpu.core.lie import SE3
from dsopp_tpu.core.pattern import PATTERN_CENTER, PATTERN_SIZE, shift_pattern
from dsopp_tpu.core.reproject import reproject, reproject_jacobian
from dsopp_tpu.ops.patch import patch_center_row, sample_pattern_rows
from dsopp_tpu.solvers.pba import (
    RES_OK,
    Window,
    _relative_poses,
    active_lm_mask,
)
from dsopp_tpu.tracker.depth_estimation import (
    STATUS_GOOD,
    STATUS_ILL_CONDITIONED,
    STATUS_OOB,
    STATUS_OUTLIER,
    STATUS_SKIPPED,
    ImmaturePoints,
)

MAX_SEARCH_INTERVAL = 8.0   # readyForActivation (immature_tracking_landmark.cpp:46-52)
MIN_UNIQUENESS = 3.0
P_GAIN = 0.001              # recalculateMinDistanceToNeighbor
MIN_DISTANCE = 0.0
MAX_DISTANCE = 10.0


def ready_for_activation(points: ImmaturePoints):
    s = points.status
    status_ok = (
        (s == STATUS_GOOD) | (s == STATUS_SKIPPED)
        | (s == STATUS_ILL_CONDITIONED) | (s == STATUS_OOB)
    )
    return (
        points.valid & points.traced & status_ok
        & (points.search_interval < MAX_SEARCH_INTERVAL)
        & (points.uniqueness > MIN_UNIQUENESS)
        & (points.idepth > 0)
    )


@jax.jit
def _activation_kernel(window: Window, model, imm: ImmaturePoints,
                       min_distance):
    """→ (activate [K,N_imm] bool, delete [K,N_imm] bool, n_active).

    ``imm`` carries a leading window-slot axis (bank per active keyframe).
    """
    k = window.num_slots
    newest = jnp.sum(window.frame_valid) - 1
    poses = window.poses()
    t_newest_inv = jax.tree_util.tree_map(lambda x: x[newest], poses)
    t_n = SE3(t_newest_inv.q, t_newest_inv.t).inverse()
    t_rel = SE3(t_n.q[None].repeat(k, 0), t_n.t[None].repeat(k, 0)).compose(poses)

    # active landmarks → newest frame
    act_mask = active_lm_mask(window) & ~window.lm_outlier
    rp_act = reproject(
        model, model, window.lm_uv, window.lm_idepth,
        SE3(t_rel.q[:, None], t_rel.t[:, None]))
    act_ok = act_mask & rp_act.valid
    n_active = jnp.sum(act_ok)
    act_uv = jnp.where(act_ok[..., None], rp_act.uv, jnp.inf).reshape(-1, 2)

    # immature candidates → newest frame
    ready = ready_for_activation(imm)
    host_is_newest = (jnp.arange(k) == newest)[:, None]
    ready = ready & ~host_is_newest  # the newest keyframe's points are too fresh
    rp_imm = reproject(
        model, model, imm.uv, imm.idepth, SE3(t_rel.q[:, None], t_rel.t[:, None]))

    # min distance to any active projection
    d2 = jnp.sum(
        (rp_imm.uv.reshape(-1, 1, 2) - act_uv[None, :, :]) ** 2, axis=-1)
    min_d = jnp.sqrt(jnp.min(d2, axis=1)).reshape(imm.uv.shape[:2])
    has_active = n_active > 0
    spaced = jnp.where(has_active, min_d > min_distance, True)

    activate = ready & rp_imm.valid & spaced
    # deletions (activationStatus): outliers, untraced-after-trace, OOB
    dead_status = (
        (imm.status == STATUS_OUTLIER)
        | ((imm.status == STATUS_OOB) & ~ready)
    )
    delete = imm.valid & (dead_status | (ready & ~rp_imm.valid))
    return activate, delete, n_active


def embedded_patches(window: Window, uv):
    """[K, M, C·P] channel-major reference patches sampled at ``uv`` from
    each host keyframe's embedded channels (the window patch tables).

    The immature bank carries INTENSITY patches only — the reference's
    epipolar tracer is hard-wired C=1 (monocular_tracker.cpp:470
    ``estimateDepths<..., Grid2D, 1>``) — so when a candidate activates
    into a C>1 window its C-channel reference patch is sampled here, from
    the same table rows the BA residual pass reads
    (local_frame.hpp:174-221 8C residual blocks).
    """
    h, w = window.maps.shape[-2:]
    c = window.num_channels
    row, bx, by = patch_center_row(uv, h, w)                 # [K, M]
    base = window.patch_map[:, None] * (c * h * w)           # [K, 1]
    tbl = window.patch.reshape(-1, window.patch.shape[-1])
    pat = shift_pattern(uv)                                  # [K, M, P, 2]
    chans = []
    for ch in range(c):
        rows = jnp.take(tbl, base + ch * h * w + row, axis=0)
        vals, _, _, _ = sample_pattern_rows(rows, pat, bx, by, h, w)
        chans.append(vals)
    return jnp.concatenate(chans, axis=-1)                   # [K, M, C·P]


MAX_ENERGY_FOR_INLIERS = PATTERN_SIZE * 12.0 * 12.0  # landmarks_activator.cpp:124
REFINE_ITERATIONS = 3        # optimizeImmatureLandmark options (:286-292)
REFINE_REG0 = 0.1
REFINE_REG_DEC = 2.0
REFINE_REG_INC = 5.0


REFINE_CAP = 512  # compacted candidate slots per keyframe tick


@partial(jax.jit, static_argnames=("huber_sigma", "cap"))
def _refine_idepth_kernel(window: Window, model, imm: ImmaturePoints,
                          activate, huber_sigma: float, cap: int = REFINE_CAP):
    """Idepth refinement of to-activate points (the REFINE template path).

    Mirrors ``optimizeImmatureLandmark`` / ``LandmarkActivationProblem``
    (landmarks_activator.cpp:123-312): per landmark, a scalar LM on idepth
    over residuals against every other window frame — whole-patch Huber
    weight σ/‖r‖, energy capped at ``kMaxEnergyForInliers`` for non-inlier
    reprojections, 3 iterations with λ₀=0.1 (÷2 accept, ×5 reject); points
    ending with idepth < 0 or fewer than min(1, K−1) inlier residuals are
    deleted instead of activated.

    Fixed-shape redesign: only the ≤``cap`` ACTIVATING candidates refine — the
    bank-wide [K,K,N_imm,P] pass burned ~75 ms/keyframe refining points
    that were never activated.  Candidates compact into a fixed [cap] bank
    (index-ranked, like the activation scatter), refine against all window
    frames as a [cap, K, P] pass, and scatter back.  Activations beyond
    ``cap`` in one tick stay immature until the next keyframe (the density
    controller absorbs the difference; typical per-tick activations are
    well under the cap).
    """
    k = window.num_slots
    m = imm.uv.shape[1]
    dtype = imm.idepth.dtype

    # ---- compact the activating candidates into [cap] slots -------------
    # NEWEST host bank first: with beyond-cap deferral (advisor r4), an
    # index-ordered selection lets stale oldest-bank candidates monopolize
    # the cap every tick — refine rejects them while fresh viable
    # candidates starve (measured: dense-point activation collapsed to
    # ~30/keyframe and the active population stalled at ~600 of 5000).
    # Fresh candidates activate promptly; deferred old ones retry when
    # capacity allows and clear when their host marginalizes.
    flat_act = activate.reshape(-1)
    n_flat = k * m
    flat_idx = jnp.arange(n_flat)
    rank = (k - 1 - flat_idx // m) * m + flat_idx % m
    order = jnp.argsort(jnp.where(flat_act, rank, n_flat + flat_idx))[:cap]
    sel = flat_act[order]                                   # [cap]
    host = order // m                                       # [cap] anchor slot
    uv = imm.uv.reshape(n_flat, -1)[order]                  # [cap, 2]
    patch0 = imm.patch.reshape(n_flat, -1)[order]           # [cap, P]
    idepth0 = imm.idepth.reshape(n_flat)[order]             # [cap]

    poses = window.poses()
    t_inv = poses.inverse()
    # T_j⁻¹ · T_host per (candidate, target j): [cap, K]
    t_cj = SE3(t_inv.q[None, :, :], t_inv.t[None, :, :]).compose(
        SE3(poses.q[host][:, None, :], poses.t[host][:, None, :]))
    affine = window.affine()
    ratio = window.exposure[None, :] / jnp.maximum(
        window.exposure[host][:, None], 1e-12)              # [cap, K]
    scale = ratio * jnp.exp(affine[None, :, 0] - affine[host][:, None, 0])
    pair = (window.frame_valid[None, :] & sel[:, None]
            & (jnp.arange(k)[None, :] != host[:, None]))    # [cap, K]

    pattern = shift_pattern(uv)                             # [cap, P, 2]
    t_b = SE3(t_cj.q[:, :, None, :], t_cj.t[:, :, None, :])  # [cap, K, 1]
    corrected = scale[:, :, None] * (
        patch0[:, None] - affine[host][:, None, None, 1])   # [cap, K, P]

    h_px, w_px = window.maps.shape[-2:]

    def eval_full(idepth):
        rj = reproject_jacobian(
            model, model, pattern[:, None], idepth[:, None, None], t_b)
        center = rj.uv[..., PATTERN_CENTER, :]               # [cap, K, 2]
        row, bx, by = patch_center_row(center, h_px, w_px)
        # channel 0 of the bank: immature patches are intensity (the
        # tracker pipeline runs C=1; a C>1 window's channel 0 is the first
        # embedder plane)
        row = row + window.patch_map[None, :] * (
            window.num_channels * h_px * w_px)
        rows = jnp.take(window.patch.reshape(-1, window.patch.shape[-1]),
                        row, axis=0)
        vals, gxs, gys, inside = sample_pattern_rows(
            rows, rj.uv, bx, by, h_px, w_px)                 # [cap, K, P]
        ok = jnp.all(rj.valid & inside, axis=-1) & pair

        r = (vals - affine[None, :, None, 1]) - corrected
        r = jnp.where(ok[..., None], r, 0.0)
        r2 = jnp.sum(r * r, axis=-1)                         # [cap, K]
        rnorm = jnp.sqrt(jnp.maximum(r2, 1e-30))
        w = jnp.where(rnorm > huber_sigma, huber_sigma / rnorm, 1.0)
        inlier = ok & (r2 < MAX_ENERGY_FOR_INLIERS)
        e_term = jnp.where(inlier, w * r2,
                           jnp.where(ok, MAX_ENERGY_FOR_INLIERS, 0.0))
        energy = jnp.sum(e_term, axis=1)                     # [cap]
        inliers = jnp.sum(inlier, axis=1)                    # [cap]

        d = (gxs * rj.d_uv_d_idepth[..., 0]
             + gys * rj.d_uv_d_idepth[..., 1])               # [cap, K, P]
        d = jnp.where(ok[..., None], d, 0.0)
        h = jnp.sum(w[..., None] * d * d, axis=(1, 2))       # [cap]
        b = jnp.sum(w[..., None] * d * r, axis=(1, 2))
        return energy, inliers, h, b

    idepth = idepth0
    e, inliers, h, b = eval_full(idepth)

    def body(it, carry):
        idepth, e, inliers, h, b, lam = carry
        step = b / jnp.maximum(h * (1.0 + lam), 1e-20)
        trial = idepth - step
        e_new, inl_new, h_new, b_new = eval_full(trial)
        accept = (e_new < e) & (h > 0)
        idepth = jnp.where(accept, trial, idepth)
        e = jnp.where(accept, e_new, e)
        inliers = jnp.where(accept, inl_new, inliers)
        h = jnp.where(accept, h_new, h)
        b = jnp.where(accept, b_new, b)
        lam = jnp.where(accept, lam / REFINE_REG_DEC, lam * REFINE_REG_INC)
        return idepth, e, inliers, h, b, lam

    lam0 = jnp.full(idepth.shape, REFINE_REG0, dtype)
    idepth, e, inliers, _, _, _ = jax.lax.fori_loop(
        0, REFINE_ITERATIONS, body, (idepth, e, inliers, h, b, lam0))

    min_inliers = jnp.minimum(1, jnp.sum(window.frame_valid) - 1)
    keep_c = sel & (inliers >= min_inliers) & (idepth > 0)   # [cap]

    # ---- scatter back to the [K, N_imm] banks ----------------------------
    idep_flat = imm.idepth.reshape(n_flat)
    idep_flat = idep_flat.at[order].set(
        jnp.where(keep_c, idepth, idep_flat[order]))
    keep_flat = jnp.zeros((n_flat,), bool).at[order].set(keep_c)
    # which candidates actually entered the cap'd refine bank — callers must
    # only delete refine-rejected points among these; beyond-cap candidates
    # stay immature and retry next keyframe
    sel_flat = jnp.zeros((n_flat,), bool).at[order].set(sel)
    return idep_flat.reshape(k, m), keep_flat.reshape(k, m), sel_flat.reshape(k, m)


@jax.jit
def _activation_scatter(window: Window, imm: ImmaturePoints, activate, delete):
    """Move accepted immature points into free landmark slots (on device).

    Per slot: rank free landmark slots and accepted candidates in index
    order, pair rank-for-rank, scatter with out-of-range drop for the
    unmatched tail — the branch-free equivalent of the host compaction loop.
    """
    n = window.num_landmark_slots
    m = imm.uv.shape[1]
    r = min(n, m)

    # C>1 window: the stored reference patch is the C-channel embedded one
    act_patch = (imm.patch if window.num_channels == 1
                 else embedded_patches(window, imm.uv))

    def per_slot(lm_uv, lm_patch, lm_idepth, lm_valid, status_a,
                 i_uv, i_patch, i_idepth, i_valid, act, dele):
        free_order = jnp.argsort(
            jnp.where(~lm_valid, jnp.arange(n), n + jnp.arange(n)))
        act_order = jnp.argsort(jnp.where(act, jnp.arange(m), m + jnp.arange(m)))
        take = jnp.minimum(jnp.sum(~lm_valid), jnp.sum(act))
        rank = jnp.arange(r)
        mask = rank < take
        dst = jnp.where(mask, free_order[:r], n)   # n → dropped
        src = act_order[:r]

        lm_uv = lm_uv.at[dst].set(i_uv[src], mode="drop")
        lm_patch = lm_patch.at[dst].set(i_patch[src], mode="drop")
        lm_idepth = lm_idepth.at[dst].set(i_idepth[src], mode="drop")
        lm_valid = lm_valid.at[dst].set(True, mode="drop")
        status_a = status_a.at[:, dst].set(RES_OK, mode="drop")

        taken = jnp.zeros(m, bool).at[src].set(mask, mode="drop")
        i_valid = i_valid & ~taken & ~dele
        return lm_uv, lm_patch, lm_idepth, lm_valid, status_a, i_valid, take

    (lm_uv, lm_patch, lm_idepth, lm_valid, status, imm_valid, takes) = jax.vmap(
        per_slot
    )(window.lm_uv, window.lm_patch, window.lm_idepth, window.lm_valid,
      window.res_status, imm.uv, act_patch, imm.idepth, imm.valid,
      activate, delete)

    import dataclasses as dc

    window = dc.replace(
        window, lm_uv=lm_uv, lm_patch=lm_patch, lm_idepth=lm_idepth,
        lm_valid=lm_valid, res_status=status)
    return window, imm._replace(valid=imm_valid), jnp.sum(takes)


@dataclass
class LandmarksActivator:
    desired_points: int = 2000
    min_distance_to_neighbor: float = 3.0
    refine: bool = False          # REFINE template flag (idepth GN on activation)
    huber_sigma: float = 20.0

    def activate_deferred(self, window: Window, model, imm: ImmaturePoints):
        """Run activation; returns (window', imm', n_active_dev,
        n_activated_dev) with the counters left ON DEVICE so the caller can
        batch the readback; follow with :meth:`note_active_count`."""
        activate, delete, n_active = _activation_kernel(
            window, model, imm, self.min_distance_to_neighbor)
        if self.refine:
            idepth, activate, selected = _refine_idepth_kernel(
                window, model, imm, activate, self.huber_sigma)
            # only refine-REJECTED candidates die; activating candidates
            # beyond the REFINE_CAP slots (~never at typical per-tick
            # activation counts) stay immature and retry next keyframe
            delete = delete | (selected & ~activate)
            # setIdepthMin/Max(idepth) — landmarks_activator.cpp:308-309
            imm = imm._replace(
                idepth_min=jnp.where(activate, idepth, imm.idepth_min),
                idepth_max=jnp.where(activate, idepth, imm.idepth_max))
        window, imm, n_activated = _activation_scatter(
            window, imm, activate, delete)
        return window, imm, n_active, n_activated

    def note_active_count(self, n_active: int):
        """P-controller step toward the desired density
        (recalculateMinDistanceToNeighbor)."""
        self.min_distance_to_neighbor = float(np.clip(
            self.min_distance_to_neighbor
            + (int(n_active) - self.desired_points) * P_GAIN,
            MIN_DISTANCE, MAX_DISTANCE))

    def activate(self, window: Window, model, imm: ImmaturePoints):
        """Run activation; returns (window', imm', stats) — two device
        programs plus one scalar readback (three with refinement)."""
        window, imm, n_active, n_activated = self.activate_deferred(
            window, model, imm)
        n_active, n_activated = jax.device_get((n_active, n_activated))
        self.note_active_count(int(n_active))
        return window, imm, {
            "activated": int(n_activated),
            "active": int(n_active),
            "min_distance": self.min_distance_to_neighbor,
        }
