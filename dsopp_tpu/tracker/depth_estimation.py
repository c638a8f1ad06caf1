"""Immature-point depth estimation by epipolar search (the J5 job).

JAX analog of the reference ``DepthEstimation``
(reference: src/tracker/depth_estimators/src/depth_estimation.cpp — per new
frame, every immature landmark searches its epipolar segment between
[idepth_min, idepth_max] with SSD over the 8-point pattern, refines subpixel
along the line tangent with a tiny GN (:81-160), derives an error radius
from the gradient/epiline angle (:26-33), shrinks the idepth interval and
updates the status machine (:223-356); TBB-parallel over landmarks).

Fixed-shape redesign: everything is one fixed-shape batched computation over
[N landmarks × S samples × P pattern]:

* the epipolar segment is sampled at S uniform positions between the
  projections at idepth_min/idepth_max (clamped to the max search length),
  instead of a data-dependent per-pixel walk;
* each sample's reference idepth comes from closed-form two-view
  triangulation (axis chosen per sample for conditioning);
* SSD, argmin, uniqueness, subpixel GN (3 fixed iterations, step clamped to
  0.3 px), the gradient-angle error model, and the interval update are all
  arithmetic over masks — the status machine is int arrays.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dsopp_tpu.core.camera import MIN_DEPTH, valid_idepth
from dsopp_tpu.core.lie import SE3, quat_rotate
from dsopp_tpu.core.pattern import PATTERN_SIZE, shift_pattern
from dsopp_tpu.ops.patch import (
    pack_patch_table,
    patch_center_row,
    sample_pattern_rows,
    sample_values_rows,
)

# ImmatureStatus (reference immature_tracking_landmark.hpp:14-23)
STATUS_GOOD = 0
STATUS_OOB = 1
STATUS_OUTLIER = 2
STATUS_SKIPPED = 3
STATUS_ILL_CONDITIONED = 4
STATUS_UNINITIALIZED = 5
STATUS_DELETE = 6

# Constants from estimateLandmark (depth_estimation.cpp:223-246)
MIN_EPILINE_SIZE = 2.0
MIN_DEPTH_SCALE = 0.75
MAX_DEPTH_SCALE = 1.5
MAX_ERROR = 10.0
UNIQUENESS_RADIUS_PX = 2.0
MIN_EPILINE_FOR_UNIQUENESS = 10.0
MAX_ENERGY_PER_PIXEL = 12.0 * 12.0
MAX_ENERGY_INLIER = PATTERN_SIZE * MAX_ENERGY_PER_PIXEL
MAX_PIX_SEARCH_FACTOR = 0.027
MAX_SUBPIXEL_STEP = 0.3
INITIAL_IDEPTH_MAX = 1.0 / MIN_DEPTH  # reference initial idepth_max_ = 1/0.001


class ImmaturePoints(NamedTuple):
    """Fixed-slot immature landmark bank of one keyframe."""

    uv: jnp.ndarray           # [N, 2] projection in the host keyframe
    patch: jnp.ndarray        # [N, P] reference pattern intensities
    gradient: jnp.ndarray     # [N, 2] image gradient at the point
    idepth_min: jnp.ndarray   # [N]
    idepth_max: jnp.ndarray   # [N]
    status: jnp.ndarray       # [N] int32 ImmatureStatus
    traced: jnp.ndarray       # [N] bool — successfully traced at least once
    uniqueness: jnp.ndarray   # [N] second_best/best energy ratio
    search_interval: jnp.ndarray  # [N] last epipolar search length (px)
    valid: jnp.ndarray        # [N] slot occupied

    @property
    def idepth(self):
        return 0.5 * (self.idepth_min + self.idepth_max)


def _triangulate_idepth(pr, t, ray_target):
    """Reference-frame idepth whose target projection is ``ray_target``.

    Solves (pr + ρ t) ∝ ray_target per image axis; picks the better-
    conditioned axis.  pr = R·ray_ref.  Shapes broadcast: pr,t [...,3],
    ray_target [...,3] (z=1).
    """
    vx, vy = ray_target[..., 0], ray_target[..., 1]
    den_x = t[..., 0] - vx * t[..., 2]
    den_y = t[..., 1] - vy * t[..., 2]
    num_x = vx * pr[..., 2] - pr[..., 0]
    num_y = vy * pr[..., 2] - pr[..., 1]
    use_x = jnp.abs(den_x) > jnp.abs(den_y)
    den = jnp.where(use_x, den_x, den_y)
    num = jnp.where(use_x, num_x, num_y)
    den_safe = jnp.where(jnp.abs(den) < 1e-12, 1e-12, den)
    return num / den_safe


def _project_scaled(model, q):
    return model.project(q)


@partial(jax.jit, static_argnames=("num_samples",))
def estimate_depths(
    points: ImmaturePoints,
    target_map,
    model,
    t_t_r: SE3,
    affine_ref,
    affine_tgt,
    exposure_ratio,
    huber_sigma: float = 20.0,
    num_samples: int = 32,
) -> ImmaturePoints:
    """One epipolar-search update of all immature points against a new frame.

    ``target_map``: [3, H, W] level-0 pixel map of the new frame;
    ``t_t_r``: target-from-host-keyframe relative pose.
    """
    n = points.uv.shape[0]
    s = num_samples
    dtype = points.uv.dtype
    h_px, w_px = target_map.shape[-2:]
    # ONE 10×10-window patch table serves the whole stage (ops/patch.py):
    # gathers are counted in rows, and consecutive
    # epiline samples sit ~1 px apart, so a GROUP of 4 samples × 8 pattern
    # points shares a single 128-lane row — 8 rows per landmark for the
    # whole SSD sweep instead of one row per (sample, point), and the
    # subpixel GN refinement replays all its iterations from ONE row at the
    # winner (r4 cost: sweep 256k + refine 4×64k rows/tick; r5: ~72k).
    # All sampling stays f32-exact — the r4 bf16-sweep experiment cost
    # 18→32 mm e2e ATE (winner/uniqueness gates are not robust to ±0.5-
    # level quantization) and stays rejected.
    tbl = pack_patch_table(target_map[0])
    group = 4 if s % 4 == 0 else 1
    num_groups = s // group

    active = points.valid & (
        (points.status == STATUS_GOOD)
        | (points.status == STATUS_SKIPPED)
        | (points.status == STATUS_ILL_CONDITIONED)
        | (points.status == STATUS_UNINITIALIZED)
    )

    ray = model.unproject(points.uv)                       # [N, 3]
    pr = quat_rotate(t_t_r.q, ray)                         # [N, 3]
    t = jnp.broadcast_to(t_t_r.t, pr.shape)

    rho_min = jnp.maximum(points.idepth_min, 0.0)
    rho_max = jnp.minimum(points.idepth_max, INITIAL_IDEPTH_MAX)
    # clamp rho so the scaled target depth q_z stays positive
    qz_at = lambda rho: pr[..., 2] + rho * t[..., 2]
    min_qz = 1e-3
    rho_limit = (min_qz - pr[..., 2]) / jnp.where(
        jnp.abs(t[..., 2]) < 1e-12, 1e-12, t[..., 2]
    )
    # if moving so q_z decreases with rho, cap rho_max at the limit
    decreasing = t[..., 2] < 0
    rho_max = jnp.where(
        decreasing & (qz_at(rho_max) < min_qz), jnp.maximum(rho_limit, rho_min), rho_max
    )

    uv_a, valid_a = _project_scaled(model, pr + rho_min[..., None] * t)
    uv_b, valid_b = _project_scaled(model, pr + rho_max[..., None] * t)

    # depth-scale gate (reference :265-270): target/ref depth ratio at rho_min
    depth_scale = qz_at(rho_min)
    scale_bad = (points.idepth_min >= 0) & (
        (depth_scale < MIN_DEPTH_SCALE) | (depth_scale > MAX_DEPTH_SCALE)
    )

    seg = uv_b - uv_a
    seg_len = jnp.linalg.norm(seg, axis=-1)
    too_short = seg_len < MIN_EPILINE_SIZE
    dir_unit = seg / jnp.maximum(seg_len, 1e-12)[..., None]

    width = model.image_size[..., 0]
    height = model.image_size[..., 1]
    max_search = MAX_PIX_SEARCH_FACTOR * (width + height)
    search_len = jnp.where(
        points.traced, seg_len, jnp.minimum(seg_len, max_search)
    )

    # S uniform samples from uv_a along dir_unit
    alphas = jnp.linspace(0.0, 1.0, s, dtype=dtype)            # [S]
    uv_s = uv_a[:, None, :] + (alphas[None, :, None] * search_len[:, None, None]) * dir_unit[:, None, :]

    # per-sample idepth via triangulation
    ray_s = model.unproject(uv_s)                              # [N, S, 3]
    rho_s = _triangulate_idepth(pr[:, None, :], t[:, None, :], ray_s)  # [N, S]

    # pattern SSD at every sample
    pattern_ref = shift_pattern(points.uv)                     # [N, P, 2]
    ray_p = model.unproject(pattern_ref)                       # [N, P, 3]
    pr_p = quat_rotate(t_t_r.q, ray_p)
    q_sp = pr_p[:, None, :, :] + rho_s[:, :, None, None] * t[:, None, None, :]  # [N,S,P,3]
    uv_sp, valid_sp = _project_scaled(model, q_sp)
    # group-shared rows: the row is chosen at the mean of the group's
    # sample centers; every sample in the group reads its pattern from that
    # one fetched window (out-of-window points — extreme warp only — are
    # reported invalid, same trade the BA patch tables make)
    alpha_g = (group * jnp.arange(num_groups, dtype=dtype)
               + 0.5 * (group - 1)) / (s - 1)                # [G]
    uv_g = uv_a[:, None, :] + (
        alpha_g[None, :, None] * search_len[:, None, None]) * dir_unit[:, None, :]
    row_g, bx_g, by_g = patch_center_row(uv_g, h_px, w_px)
    rows_g = jnp.take(tbl, row_g, axis=0)                    # [N, G, 128]
    vals_g, inside_g = sample_values_rows(
        rows_g, uv_sp.reshape(n, num_groups, group * PATTERN_SIZE, 2),
        bx_g, by_g, h_px, w_px)
    intensity_sp = vals_g.reshape(n, s, PATTERN_SIZE)        # [N,S,P]
    inside_sp = inside_g.reshape(n, s, PATTERN_SIZE)

    scale = exposure_ratio * jnp.exp(affine_tgt[0] - affine_ref[0])
    corrected_ref = scale * (points.patch - affine_ref[1])     # [N, P]
    resid_sp = (intensity_sp - affine_tgt[1]) - corrected_ref[:, None, :]
    sample_ok = (
        jnp.all(valid_sp & inside_sp, axis=-1)
        & (rho_s > -1e-4) & (rho_s < INITIAL_IDEPTH_MAX * 1.01)
    )                                                          # [N, S]
    energy_s = jnp.where(
        sample_ok, jnp.sum(resid_sp * resid_sp, axis=-1), jnp.inf
    )                                                          # [N, S]

    best_idx = jnp.argmin(energy_s, axis=-1)                   # [N]
    best_energy = jnp.take_along_axis(energy_s, best_idx[:, None], axis=-1)[:, 0]
    any_sample = jnp.any(sample_ok, axis=-1)

    # uniqueness: best energy outside a ±radius (in samples) window
    spacing = search_len / (s - 1)
    radius = jnp.ceil(UNIQUENESS_RADIUS_PX / jnp.maximum(spacing, 1e-6)).astype(jnp.int32)
    sample_ids = jnp.arange(s)[None, :]
    outside = jnp.abs(sample_ids - best_idx[:, None]) > radius[:, None]
    second_best = jnp.min(jnp.where(outside, energy_s, jnp.inf), axis=-1)
    uniqueness = second_best / jnp.maximum(best_energy, 1e-12)
    update_uniqueness = search_len > MIN_EPILINE_FOR_UNIQUENESS

    # ---- subpixel refinement: 3 GN iterations along the tangent ----------
    uv_best = jnp.take_along_axis(uv_s, best_idx[:, None, None].repeat(2, 2), axis=1)[:, 0, :]
    pattern_best = jnp.take_along_axis(
        uv_sp, best_idx[:, None, None, None].repeat(PATTERN_SIZE, 2).repeat(2, 3), axis=1
    )[:, 0]                                                    # [N, P, 2]

    # one row per landmark at the sweep winner serves every GN iteration:
    # the refinement moves the pattern ≤ 4×0.3 px along the tangent, which
    # stays inside the 10×10 window's gradient-valid span for all but
    # extreme-warp points (those report invalid → the trial is rejected,
    # mirroring the reference's insideCameraROI stop, :151-155)
    row_r, bx_r, by_r = patch_center_row(uv_best, h_px, w_px)
    rows_r = jnp.take(tbl, row_r, axis=0)                    # [N, 128]

    def gn_iter(carry, _):
        delta, e_best, best_delta = carry
        pat = pattern_best - delta[:, None, None] * dir_unit[:, None, :]
        it, gx, gy, inside = sample_pattern_rows(
            rows_r, pat, bx_r, by_r, h_px, w_px)
        r = (it - affine_tgt[1]) - corrected_ref
        w = huber_sigma / jnp.maximum(jnp.abs(r), huber_sigma)
        g_tau = gx * dir_unit[:, None, 0] + gy * dir_unit[:, None, 1]
        h = jnp.sum(w * g_tau * g_tau, axis=-1)
        b = jnp.sum(w * r * g_tau, axis=-1)
        step = jnp.clip(b / jnp.maximum(h, 1e-9), -MAX_SUBPIXEL_STEP, MAX_SUBPIXEL_STEP)
        new_delta = delta + step
        # clamped-residual energy (reference calculateEnergy)
        e = jnp.sum(jnp.clip(r, -huber_sigma, huber_sigma) * r, axis=-1)
        e = jnp.where(jnp.all(inside, axis=-1), e, jnp.inf)
        better = e < e_best
        return (new_delta, jnp.where(better, e, e_best),
                jnp.where(better, delta, best_delta)), None

    zero = jnp.zeros(n, dtype)
    (_, refined_energy, best_delta), _ = jax.lax.scan(
        gn_iter, (zero, jnp.full(n, jnp.inf, dtype), zero), None, length=4
    )
    # shift along the tangent (signed px); pattern moved by −delta·dir
    shift = -best_delta
    best_energy = jnp.where(jnp.isfinite(refined_energy), refined_energy, best_energy)

    # ---- gradient-angle error model (reference calculateError) -----------
    g = points.gradient
    a_term = jnp.square(dir_unit[:, 0] * g[:, 0] + dir_unit[:, 1] * g[:, 1])
    b_term = jnp.square(dir_unit[:, 1] * g[:, 0] - dir_unit[:, 0] * g[:, 1])
    error = 0.2 + 0.2 * (a_term + b_term) / jnp.maximum(a_term, 1e-12)
    ill = (error > search_len / 2.0) & points.traced
    error = jnp.minimum(error, MAX_ERROR)

    # ---- interval update: widest valid error radius (reference :330-345) --
    ks = jnp.linspace(1.0, 0.0, 11, dtype=dtype)               # error shrink schedule
    errs = error[:, None] * ks[None, :]                        # [N, 11]
    uv_lo = uv_best[:, None, :] + (shift[:, None] - errs)[..., None] * dir_unit[:, None, :]
    uv_hi = uv_best[:, None, :] + (shift[:, None] + errs)[..., None] * dir_unit[:, None, :]
    rho_lo = _triangulate_idepth(pr[:, None, :], t[:, None, :], model.unproject(uv_lo))
    rho_hi = _triangulate_idepth(pr[:, None, :], t[:, None, :], model.unproject(uv_hi))
    pair_valid = valid_idepth(rho_lo) & valid_idepth(rho_hi)
    first_valid = jnp.argmax(pair_valid, axis=-1)              # largest error that works
    has_valid = jnp.any(pair_valid, axis=-1)
    rho_lo = jnp.take_along_axis(rho_lo, first_valid[:, None], axis=-1)[:, 0]
    rho_hi = jnp.take_along_axis(rho_hi, first_valid[:, None], axis=-1)[:, 0]
    new_min = jnp.minimum(rho_lo, rho_hi)
    new_max = jnp.maximum(rho_lo, rho_hi)

    # ---- status resolution (order mirrors the reference early-returns) ----
    oob = (~valid_a & ~valid_b) | (~any_sample) | scale_bad | ~has_valid
    outlier = best_energy > MAX_ENERGY_INLIER

    status = jnp.full(n, STATUS_GOOD, jnp.int32)
    status = jnp.where(ill, STATUS_ILL_CONDITIONED, status)
    status = jnp.where(outlier, STATUS_OUTLIER, status)
    status = jnp.where(too_short, STATUS_SKIPPED, status)
    status = jnp.where(oob, STATUS_OOB, status)
    good = status == STATUS_GOOD

    search_interval = jnp.where(
        good, 2.0 * error, jnp.where(too_short | ill, search_len, 0.0)
    )

    # inactive slots keep everything
    def keep(new, old):
        return jnp.where(active, new, old)

    return ImmaturePoints(
        uv=points.uv,
        patch=points.patch,
        gradient=points.gradient,
        idepth_min=keep(jnp.where(good, new_min, points.idepth_min), points.idepth_min),
        idepth_max=keep(jnp.where(good, new_max, points.idepth_max), points.idepth_max),
        status=keep(status, points.status).astype(jnp.int32),
        traced=keep(points.traced | good, points.traced),
        uniqueness=keep(
            jnp.where(update_uniqueness & good, uniqueness, points.uniqueness),
            points.uniqueness,
        ),
        search_interval=keep(search_interval, points.search_interval),
        valid=points.valid,
    )


def make_immature_points(uv, patch, gradient, n_slots=None, dtype=jnp.float32):
    """Fresh immature bank from extracted candidates (reference build_features)."""
    n = uv.shape[0] if n_slots is None else n_slots
    uv = jnp.asarray(uv, dtype)
    k = uv.shape[0]
    pad = n - k

    def padded(x, fill=0.0):
        x = jnp.asarray(x, dtype)
        if pad > 0:
            shape = (pad,) + x.shape[1:]
            x = jnp.concatenate([x, jnp.full(shape, fill, dtype)])
        return x

    return ImmaturePoints(
        uv=padded(uv),
        patch=padded(patch),
        gradient=padded(gradient),
        idepth_min=jnp.zeros(n, dtype),
        idepth_max=jnp.full(n, INITIAL_IDEPTH_MAX, dtype),
        status=jnp.full(n, STATUS_UNINITIALIZED, jnp.int32),
        traced=jnp.zeros(n, bool),
        uniqueness=jnp.full(n, jnp.inf, dtype),
        search_interval=jnp.zeros(n, dtype),
        valid=jnp.concatenate([jnp.ones(k, bool), jnp.zeros(max(pad, 0), bool)]),
    )
