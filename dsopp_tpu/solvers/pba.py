"""Sliding-window photometric bundle adjustment (jobs J1–J3, J9).

JAX analog of the reference Eigen PBA stack
(reference: src/energy/problems/ — evaluate_jacobians.hpp:23 residual hot
loop, hessian_block_evaluation.hpp:96/:171/:240 Hessian blocks + landmark
Schur fold + idepth back-substitution,
eigen_photometric_bundle_adjustment_problem.hpp energy/step/marginalized
prior, eigen_photometric_bundle_adjustment.cpp:63-105 solve flow,
first_estimate_jacobians.hpp FEJ, photometric_bundle_adjustment.cpp:311
relinearize / :322 outlier quantile rejection).

Semantics kept from the reference:

* per-frame state ε = [6 pose | a, b]; pose applied as T_lin·exp(ε) (right
  increment), affine = affine0 + ε_ab;
* FEJ: geometric reprojection Jacobians are evaluated ONCE per solve at the
  linearization poses/idepths; image gradients are re-sampled at the current
  projection each linearize; residuals at the current state;
* whole-patch Huber (σ = 20·√C); residual statuses (Ok/OOB/Outlier) with
  candidate-commit on LM accept and rollback on reject;
* LM: force-accept for ≥3 of max 7 iterations, constant regularizer
  λ = 1/1e5; step solves (H_pose+prior + H_marg + λ·diag − H_schur/(1+λ));
* priors: affine-brightness (1e12, 1e8), fixed-first-frame 1e16;
* marginalization ledger (H_m, b_m, E_m) in compensated double-float
  pairs on device (core/df64.py; the reference keeps it in f64), updated per
  DSO eq 8.15/8.19 with b rebased at the current state, frames Schur-
  eliminated via reduce_system.

Design: the window is a fixed-shape bank — K frame slots × N
landmark slots × 8-pixel pattern.  Residuals live in a dense
[K_anchor, K_target, N, P] tensor with masks for existence/status/liveness;
Hessian assembly and the landmark Schur fold are einsum contractions at
full f32 precision; the LM loop is host-driven over jitted kernels (7
iterations/keyframe, each a single device program).
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from dsopp_tpu.core import df64
from dsopp_tpu.core.lie import SE3
from dsopp_tpu.core.pattern import PATTERN_CENTER, PATTERN_SIZE, shift_pattern
from dsopp_tpu.core.reproject import reproject, reproject_jacobian
from dsopp_tpu.ops import pack_corners, sample_packed

from dsopp_tpu.ops.patch import (PATCH_LANES, pack_patch_table,
                                 pack_patch_table_c, patch_center_row,
                                 sample_pattern_rows)
from dsopp_tpu.solvers.measure import huber_energy_weight

# DSOPP_CHECK_FRAME_COUNT_CACHE=1 verifies the host-side frame-count memo
# against the device on every read (costs one readback per call; CI only)
_CHECK_FRAME_COUNT_CACHE = bool(
    int(os.environ.get("DSOPP_CHECK_FRAME_COUNT_CACHE", "0")))

# residual connection statuses (reference track::PointConnectionStatus)
RES_OK = 0
RES_OOB = 1
RES_OUTLIER = 2

BLOCK = 8  # per-frame state size: 6 pose + 2 affine

# every contraction here runs at full f32 (or f64) precision: the GPU's
# default TF32 inputs keep ~10 mantissa bits, which would cost the Hessian,
# the Schur fold and the marginalization ledger ~3 decimal digits
HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=HIGHEST)


class PBAOptions(NamedTuple):
    """Reference production defaults (tracker fabric.cpp:59-122 +
    eigen_photometric_bundle_adjustment.cpp:63-90)."""

    max_iterations: int = 7
    min_iterations: int = 3           # force-accept window
    force_accept: bool = True
    initial_regularizer: float = 1e-5  # 1/trust_radius (1e5); constant (dec=inc=1)
    function_tolerance: float = 1e-8
    parameter_tolerance: float = 1e-8
    huber_sigma: float = 20.0
    reg_decrease: float = 1.0          # PBA keeps λ constant (reference :75-76)
    reg_increase: float = 1.0
    affine_reg_a: float = 1e12
    affine_reg_b: float = 1e8
    fixed_reg: float = 1e16
    idepth_nullspace_threshold: float = 1e-15
    scale_nullspace_reg: float = 1e8
    min_valid_reprojections: int = 1


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Window:
    """Fixed-shape sliding-window state (device arrays; host orchestrated).

    Frame slots are packed: valid slots occupy indices [0, num_frames).
    """

    # frame slots [K]
    t_lin_q: jnp.ndarray      # [K, 4] linearization-point pose T_w_c
    t_lin_t: jnp.ndarray      # [K, 3]
    affine0: jnp.ndarray      # [K, 2]
    eps: jnp.ndarray          # [K, 8] state increment
    exposure: jnp.ndarray     # [K]
    frame_valid: jnp.ndarray  # [K] bool
    frame_fixed: jnp.ndarray  # [K] bool — fixed parameterization
    frame_marg: jnp.ndarray   # [K] bool — flagged for marginalization
    frame_id: jnp.ndarray     # [K] int32 — external keyframe id (-1 = empty)

    # landmark slots [K, N] anchored at their frame
    lm_uv: jnp.ndarray        # [K, N, 2]
    lm_patch: jnp.ndarray     # [K, N, C*P] channel-major reference patches
    lm_idepth: jnp.ndarray    # [K, N]
    lm_valid: jnp.ndarray     # [K, N] bool — slot holds an active landmark
    lm_marg_flag: jnp.ndarray  # [K, N] bool — flagged for marginalization
    lm_outlier: jnp.ndarray   # [K, N] bool
    lm_inliers: jnp.ndarray   # [K, N] int32 — inlier residual count
    lm_opt_count: jnp.ndarray  # [K, N] int32 — solves with ≥1 inlier residual
    lm_baseline: jnp.ndarray  # [K, N] relative baseline (idepth·parallax)

    # residual statuses [K_anchor, K_target, N]
    res_status: jnp.ndarray   # int32

    # marginalization ledger, double-float pairs (core/df64.py): the
    # reference keeps this system in double
    # (eigen_photometric_bundle_adjustment_problem.hpp `system_marginalized_`);
    # the device path runs in f32, so hi+lo compensated pairs carry the
    # extra precision.
    h_marg: jnp.ndarray       # [K*8, K*8] (hi)
    b_marg: jnp.ndarray       # [K*8] (hi)
    energy_marg: jnp.ndarray  # scalar (hi)
    h_marg_lo: jnp.ndarray    # [K*8, K*8]
    b_marg_lo: jnp.ndarray    # [K*8]
    energy_marg_lo: jnp.ndarray  # scalar

    # per-frame level-0 pixel maps [K, 3, H, W]
    maps: jnp.ndarray
    # patch tables [K, C*H*W, 128] (ops/patch.py): one 128-lane row per
    # (pixel, channel) holding its 10x10 window — the residual pass fetches
    # C rows per (anchor, target, landmark) pattern group.  C=1 is the
    # shipped intensity configuration (standart.yaml: frame_embedder off);
    # C>1 carries embedder channels (reference pixel_map.hpp:17
    # template<int C> through local_frame.hpp 8C residuals).  Storage is
    # SLOT-INDIRECT: logical frame slot j's table is physical row bank
    # ``patch_map[j]`` — frame permutation swaps the tiny index vector, not
    # the 1.5 GB bank
    patch: jnp.ndarray
    patch_map: jnp.ndarray    # [K] int32 logical slot → physical bank

    @property
    def num_channels(self):
        h, w = self.maps.shape[-2:]
        return self.patch.shape[1] // (h * w)

    @property
    def num_slots(self):
        return self.t_lin_q.shape[0]

    @property
    def num_landmark_slots(self):
        return self.lm_uv.shape[1]

    def t_lin(self) -> SE3:
        return SE3(self.t_lin_q, self.t_lin_t)

    def poses(self) -> SE3:
        """Current poses T_w_c = T_lin · exp(ε_pose)."""
        return self.t_lin() @ SE3.exp(self.eps[:, :6])

    def affine(self):
        return self.affine0 + self.eps[:, 6:]

    def frame_count(self):
        # memoized: called repeatedly from host orchestration, and each
        # device→host readback waits for the device
        cached = getattr(self, "_frame_count_cache", None)
        if cached is None:
            cached = int(np.asarray(jnp.sum(self.frame_valid)))
            object.__setattr__(self, "_frame_count_cache", cached)
        elif _CHECK_FRAME_COUNT_CACHE and not isinstance(
                self.frame_valid, jax.core.Tracer):
            # opt-in guard of the push/marginalize-path cache writers (a
            # stale cache silently desynchronizes every slot computation);
            # off by default — the verification readback is the round-trip
            # the cache exists to avoid
            actual = int(np.asarray(jnp.sum(self.frame_valid)))
            assert cached == actual, (
                f"_frame_count_cache {cached} != device frame count {actual}")
        return cached


def empty_window(num_frames: int, num_landmarks: int, map_shape,
                 dtype=jnp.float32, channels: int = 1) -> Window:
    k, n = num_frames, num_landmarks
    p = PATTERN_SIZE * channels
    qeye = jnp.zeros((k, 4), dtype).at[:, 0].set(1.0)
    return Window(
        t_lin_q=qeye,
        t_lin_t=jnp.zeros((k, 3), dtype),
        affine0=jnp.zeros((k, 2), dtype),
        eps=jnp.zeros((k, BLOCK), dtype),
        exposure=jnp.ones((k,), dtype),
        frame_valid=jnp.zeros((k,), bool),
        frame_fixed=jnp.zeros((k,), bool),
        frame_marg=jnp.zeros((k,), bool),
        frame_id=jnp.full((k,), -1, jnp.int32),
        lm_uv=jnp.zeros((k, n, 2), dtype),
        lm_patch=jnp.zeros((k, n, p), dtype),
        lm_idepth=jnp.zeros((k, n), dtype),
        lm_valid=jnp.zeros((k, n), bool),
        lm_marg_flag=jnp.zeros((k, n), bool),
        lm_outlier=jnp.zeros((k, n), bool),
        lm_inliers=jnp.zeros((k, n), jnp.int32),
        lm_opt_count=jnp.zeros((k, n), jnp.int32),
        lm_baseline=jnp.zeros((k, n), dtype),
        res_status=jnp.zeros((k, k, n), jnp.int32),
        h_marg=jnp.zeros((k * BLOCK, k * BLOCK), dtype),
        b_marg=jnp.zeros((k * BLOCK,), dtype),
        energy_marg=jnp.zeros((), dtype),
        h_marg_lo=jnp.zeros((k * BLOCK, k * BLOCK), dtype),
        b_marg_lo=jnp.zeros((k * BLOCK,), dtype),
        energy_marg_lo=jnp.zeros((), dtype),
        maps=jnp.zeros((k,) + tuple(map_shape), dtype),
        patch=jnp.zeros(
            (k, channels * map_shape[-2] * map_shape[-1], PATCH_LANES),
            dtype),
        patch_map=jnp.arange(k, dtype=jnp.int32),
    )


# ---------------------------------------------------------------------------
# FEJ Jacobian evaluation (first_estimate_jacobians.hpp)
# ---------------------------------------------------------------------------

class FEJCache(NamedTuple):
    d_uv_ref: jnp.ndarray    # [K,K,N,P,2,6] d(uv_t)/dε_anchor at linearization
    d_uv_tgt: jnp.ndarray    # [K,K,N,P,2,6]
    d_uv_idepth: jnp.ndarray  # [K,K,N,P,2]
    corrected_ref: jnp.ndarray  # [K,K,N,C,P] s0·(patch − b0_i) (frozen affine col)
    scale0: jnp.ndarray      # [K,K] frozen brightness scale
    geom_valid: jnp.ndarray  # [K,K,N] reprojection-jacobian validity


def _relative_poses(t_q, t_t, eps_pose):
    """T_j⁻¹ · T_i for all ordered pairs → SE3 with batch [K_i, K_j]."""
    t = SE3(t_q, t_t) @ SE3.exp(eps_pose)
    t_inv = t.inverse()
    # pair [i, j]: t_inv[j] ∘ t[i]
    qi = t.q[:, None, :]
    ti = t.t[:, None, :]
    qj = t_inv.q[None, :, :]
    tj = t_inv.t[None, :, :]
    return SE3(qj, tj).compose(SE3(qi, ti))  # batch [K_i, K_j]


def _fej_cache(window: Window, model) -> FEJCache:
    k = window.num_slots
    zero = jnp.zeros((k, 6), window.t_lin_q.dtype)
    t_ji = _relative_poses(window.t_lin_q, window.t_lin_t, zero)  # [i, j]
    pattern = shift_pattern(window.lm_uv)                          # [K,N,P,2]
    # broadcast anchor landmarks over target axis: [i, j, n, p, ...]
    uv = pattern[:, None]                                          # [K,1,N,P,2]
    idepth = window.lm_idepth[:, None, :, None]                    # [K,1,N,1]
    t_b = SE3(t_ji.q[:, :, None, None, :], t_ji.t[:, :, None, None, :])
    rj = reproject_jacobian(model, model, uv, idepth, t_b)
    ratio = window.exposure[None, :] / jnp.maximum(window.exposure[:, None], 1e-12)
    scale0 = ratio * jnp.exp(window.affine0[None, :, 0] - window.affine0[:, None, 0])
    patch_ref = window.lm_patch.reshape(
        k, window.num_landmark_slots, window.num_channels, PATTERN_SIZE)
    corrected = scale0[:, :, None, None, None] * (
        patch_ref[:, None] - window.affine0[:, None, None, None, None, 1]
    )
    return FEJCache(
        d_uv_ref=rj.d_uv_d_eps_ref,
        d_uv_tgt=rj.d_uv_d_eps_tgt,
        d_uv_idepth=rj.d_uv_d_idepth,
        corrected_ref=corrected,
        scale0=scale0,
        geom_valid=jnp.all(rj.valid, axis=-1),
    )


# ---------------------------------------------------------------------------
# Residual evaluation (evaluate_jacobians.hpp NEW_EVALUATION_POINT path)
# ---------------------------------------------------------------------------

class Evaluation(NamedTuple):
    residuals: jnp.ndarray     # [K,K,N,C,P]
    energy_patch: jnp.ndarray  # [K,K,N] huber patch energy
    weight: jnp.ndarray        # [K,K,N] huber weight (0 where dead)
    status_candidate: jnp.ndarray  # [K,K,N] int32
    gx: jnp.ndarray            # [K,K,N,C,P] target x-gradient at projection
    gy: jnp.ndarray            # [K,K,N,C,P] (separate fields: a trailing
    ok: jnp.ndarray            # [K,K,N]      2-dim would lane-pad 64x)


def _pair_mask(window: Window):
    fv = window.frame_valid
    eye = jnp.eye(window.num_slots, dtype=bool)
    return fv[:, None] & fv[None, :] & ~eye


def pack_window_maps(window: Window):
    """Corner-pack every frame slot's pixel map → [K, H*W, 12].

    Retained for the non-group sampling paths (kept API); the BA residual
    pass itself now rides the per-pixel patch tables stored in
    ``Window.patch`` (ops/patch.py — one 128-lane row per pattern group,
    ~20x fewer gather rows than per-sample corner rows).
    """
    return jax.vmap(pack_corners)(window.maps)


def _evaluate(window: Window, model, eps, idepth, lm_mask, opts: PBAOptions,
              with_gradients: bool = True, packed_maps=None) -> Evaluation:
    """Residuals of every (anchor i, target j, landmark n) at state (eps, idepth).

    One patch-table row gather per (i, j, n) group yields values AND
    gradients (``with_gradients``/``packed_maps`` kept for API compat)."""
    del with_gradients, packed_maps
    t_ji = _relative_poses(window.t_lin_q, window.t_lin_t, eps[:, :6])
    affine = window.affine0 + eps[:, 6:]
    ratio = window.exposure[None, :] / jnp.maximum(window.exposure[:, None], 1e-12)
    scale = ratio * jnp.exp(affine[None, :, 0] - affine[:, None, 0])

    pattern = shift_pattern(window.lm_uv)                          # [K,N,P,2]
    uv = pattern[:, None]
    d = idepth[:, None, :, None]
    t_b = SE3(t_ji.q[:, :, None, None, :], t_ji.t[:, :, None, None, :])
    rp = reproject(model, model, uv, d, t_b)                       # [K,K,N,P]

    # ONE patch-row gather per (i, j, n, channel) group from target j's
    # table: the target and channel axes fold into the flat row index
    # through patch_map (slot-indirect storage) — one gather total
    h, w = window.maps.shape[-2:]
    k, n_lm = window.num_slots, window.num_landmark_slots
    c = window.num_channels
    center = rp.uv[..., PATTERN_CENTER, :]                         # [K,K,N,2]
    row, bx, by = patch_center_row(center, h, w)
    row = (row[..., None]
           + window.patch_map[None, :, None, None] * (c * h * w)
           + jnp.arange(c)[None, None, None, :] * (h * w))        # [K,K,N,C]
    rows = jnp.take(window.patch.reshape(-1, PATCH_LANES), row, axis=0)
    vals, gx, gy, inside = sample_pattern_rows(
        rows, rp.uv[..., None, :, :], bx[..., None], by[..., None], h, w
    )                                                              # [K,K,N,C,P]
    inside = inside[..., 0, :]                                     # per-point

    patch_ref = window.lm_patch.reshape(k, n_lm, c, PATTERN_SIZE)
    corrected_ref = scale[:, :, None, None, None] * (
        patch_ref[:, None] - affine[:, None, None, None, None, 1]
    )
    r = (vals - affine[None, :, None, None, None, 1]) - corrected_ref

    geom_ok = jnp.all(rp.valid & inside, axis=-1)                  # [K,K,N]
    pair = _pair_mask(window)
    live = pair[:, :, None] & lm_mask[:, None, :]

    status_ok = window.res_status == RES_OK
    candidate = jnp.where(
        live & ~geom_ok, RES_OOB, window.res_status
    ).astype(jnp.int32)

    ok = live & geom_ok & status_ok
    r = jnp.where(ok[..., None, None], r, 0.0)
    # whole-patch Huber over all C·P residuals with σ·√C (the reference's
    # kHuberLossSigma × √C scaling, local_frame.hpp 8C residual blocks)
    r2 = jnp.sum(r * r, axis=(-2, -1))
    energy, weight = huber_energy_weight(
        r2, opts.huber_sigma * float(c) ** 0.5)
    energy = jnp.where(ok, energy, 0.0)
    weight = jnp.where(ok, weight, 0.0)

    return Evaluation(r, energy, weight, candidate, gx, gy, ok)


def _prior_system(window: Window, eps, opts: PBAOptions, marg_pass=False):
    """Affine-brightness + fixed-frame priors (evaluateLinearSystemPrior).

    All prior blocks are diagonal, so the system is built as a [K,8]
    diagonal-entry bank.  ``marg_pass`` selects flagged frames only (the
    reference's ``for_marginalized`` flag); the normal pass takes unflagged.
    """
    k = window.num_slots
    dtype = eps.dtype
    sel = window.frame_valid & (window.frame_marg if marg_pass else ~window.frame_marg)
    fixed = sel & window.frame_fixed
    free = sel & ~window.frame_fixed

    dvec = jnp.where(fixed[:, None], opts.fixed_reg, 0.0) * jnp.ones((k, BLOCK), dtype)
    b = jnp.where(fixed[:, None], opts.fixed_reg * eps, 0.0)

    reg = jnp.asarray([opts.affine_reg_a, opts.affine_reg_b], dtype)
    affine = window.affine0 + eps[:, 6:]
    dvec = dvec.at[:, 6:].add(jnp.where(free[:, None], reg[None, :], 0.0))
    b = b.at[:, 6:].add(jnp.where(free[:, None], reg[None, :] * affine, 0.0))
    return jnp.diag(dvec.reshape(-1)), b.reshape(k * BLOCK)


def _prior_energy(window: Window, eps, opts: PBAOptions):
    reg = jnp.asarray([opts.affine_reg_a, opts.affine_reg_b], eps.dtype)
    affine = window.affine0 + eps[:, 6:]
    e = 0.5 * jnp.sum(
        jnp.where(window.frame_valid[:, None], reg[None, :] * affine * affine, 0.0)
    )
    return e


class LinearSystem(NamedTuple):
    h_pose: jnp.ndarray    # [K*8, K*8] photometric + prior
    b_pose: jnp.ndarray    # [K*8]
    h_schur: jnp.ndarray   # [K*8, K*8]
    b_schur: jnp.ndarray   # [K*8]
    hpd: jnp.ndarray       # [K,N,K,8] per-landmark pose-idepth blocks
    inv_hdd: jnp.ndarray   # [K,N] (0 where ill-conditioned)
    b_d: jnp.ndarray       # [K,N]


def _linearize(window: Window, model, fej: FEJCache, eps, idepth, lm_mask,
               opts: PBAOptions, marg_pass: bool = False,
               with_prior: bool = True,
               packed_maps=None) -> LinearSystem:
    """Build the GN system with FEJ Jacobians + current gradients/weights."""
    ev = _evaluate(window, model, eps, idepth, lm_mask, opts,
                   with_gradients=True, packed_maps=packed_maps)
    return _linearize_from_ev(window, fej, ev, eps, opts,
                              marg_pass=marg_pass, with_prior=with_prior)


def _linearize_from_ev(window: Window, fej: FEJCache, ev: Evaluation, eps,
                       opts: PBAOptions, marg_pass: bool = False,
                       with_prior: bool = True) -> LinearSystem:
    """GN system from an already-computed residual evaluation.

    The solve loop evaluates residuals once per LM iteration (the trial
    energy pass) and feeds the SAME evaluation into the next linearize —
    halving the gather-heavy evaluate passes vs evaluate-per-linearize."""
    k, n = window.num_slots, window.num_landmark_slots

    ok = ev.ok & fej.geom_valid
    w = jnp.where(ok, ev.weight, 0.0)

    gx = ev.gx                                           # [K,K,N,C,P]
    gy = ev.gy
    # pose part of J (chain rule with FEJ geometry, current gradients);
    # the FEJ geometry is per pattern POINT — broadcast over channels
    # (reference local_frame.hpp: 8C residual rows share the 8 point
    # reprojection Jacobians, one per channel block)
    d_ref = fej.d_uv_ref[:, :, :, None]                  # [K,K,N,1,P,2,6]
    d_tgt = fej.d_uv_tgt[:, :, :, None]
    j_ref_pose = gx[..., None] * d_ref[..., 0, :] + gy[..., None] * d_ref[..., 1, :]
    j_tgt_pose = gx[..., None] * d_tgt[..., 0, :] + gy[..., None] * d_tgt[..., 1, :]
    # affine cols (frozen, evaluate_jacobians.hpp tail):
    #   d/da_i = +corrected0, d/db_i = +scale0, d/da_j = −corrected0, d/db_j = −1
    ones = jnp.ones_like(fej.corrected_ref)
    j_ref = jnp.concatenate(
        [j_ref_pose, fej.corrected_ref[..., None],
         (fej.scale0[:, :, None, None, None] * ones)[..., None]], axis=-1)
    j_tgt = jnp.concatenate(
        [j_tgt_pose, -fej.corrected_ref[..., None], -ones[..., None]], axis=-1)
    j_d = (gx * fej.d_uv_idepth[:, :, :, None, :, 0]
           + gy * fej.d_uv_idepth[:, :, :, None, :, 1])  # [K,K,N,C,P]

    # fold the channel axis into the residual axis: C·P rows of 8 cols
    cp = j_ref.shape[-3] * j_ref.shape[-2]
    kk, nn = j_ref.shape[0], j_ref.shape[2]
    j_ref = j_ref.reshape(kk, kk, nn, cp, BLOCK)
    j_tgt = j_tgt.reshape(kk, kk, nn, cp, BLOCK)
    j_d = j_d.reshape(kk, kk, nn, cp)
    r = ev.residuals.reshape(kk, kk, nn, cp)
    wj_ref = w[..., None, None] * j_ref
    wj_tgt = w[..., None, None] * j_tgt

    # H_pp blocks (hessian_block_evaluation.hpp:96)
    h_rr = jnp.einsum("ijnpa,ijnpb->iab", wj_ref, j_ref, precision=HIGHEST)
    h_tt = jnp.einsum("ijnpa,ijnpb->jab", wj_tgt, j_tgt, precision=HIGHEST)
    h_rt = jnp.einsum("ijnpa,ijnpb->ijab", wj_ref, j_tgt,
                      precision=HIGHEST)
    b_r = jnp.einsum("ijnpa,ijnp->ia", wj_ref, r, precision=HIGHEST)
    b_t = jnp.einsum("ijnpa,ijnp->ja", wj_tgt, r, precision=HIGHEST)

    h = jnp.zeros((k, BLOCK, k, BLOCK), r.dtype)
    eye = jnp.eye(k, dtype=r.dtype)
    h = h + eye[:, None, :, None] * (h_rr + h_tt)[:, :, None, :]
    h = h + jnp.einsum("ijab->iajb", h_rt)
    h = h + jnp.einsum("ijab->jbia", h_rt)
    b = b_r + b_t

    h = h.reshape(k * BLOCK, k * BLOCK)
    b = b.reshape(k * BLOCK)
    if with_prior:
        h_pr, b_pr = _prior_system(window, eps, opts, marg_pass=marg_pass)
        h_pose = h + h_pr
        b_pose = b + b_pr
    else:
        # photometric part only — the sharded path psums this across the
        # landmark axis and adds the (replicated) priors exactly once
        h_pose, b_pose = h, b

    # landmark Schur quantities (hessian_block_evaluation.hpp:171)
    hpd_ref = jnp.einsum("ijnpa,ijnp->ina", wj_ref, j_d, precision=HIGHEST)
    hpd_tgt = jnp.einsum("ijnpa,ijnp->ijna", wj_tgt, j_d,
                         precision=HIGHEST)
    hpd = jnp.einsum("ijna->inja", hpd_tgt) + jnp.einsum(
        "ina,ij->inja", hpd_ref, jnp.eye(k, dtype=r.dtype), precision=HIGHEST
    )                                                              # [K,N,K,8]
    h_dd = jnp.einsum("ijnp,ijnp,ijn->in", j_d, j_d, w, precision=HIGHEST)
    b_d = jnp.einsum("ijnp,ijnp,ijn->in", j_d, r, w, precision=HIGHEST)

    if marg_pass:
        # scale-nullspace regularizer for landmarks anchored in a fixed frame
        h_dd = h_dd + jnp.where(
            (window.frame_fixed[:, None]) & (h_dd > opts.idepth_nullspace_threshold),
            opts.scale_nullspace_reg, 0.0)

    well = h_dd > opts.idepth_nullspace_threshold
    inv_hdd = jnp.where(well, 1.0 / jnp.maximum(h_dd, 1e-300), 0.0)

    h_schur = jnp.einsum("inja,in,inkb->jakb", hpd, inv_hdd, hpd,
                         precision=HIGHEST).reshape(k * BLOCK, k * BLOCK)
    b_schur = jnp.einsum("inja,in,in->ja", hpd, inv_hdd, b_d,
                         precision=HIGHEST).reshape(k * BLOCK)
    return LinearSystem(h_pose, b_pose, h_schur, b_schur, hpd, inv_hdd, b_d)


def _energy_from_ev(window: Window, ev: Evaluation, eps, opts: PBAOptions):
    """Total energy from an existing evaluation (landmarks + priors + ledger)."""
    e_land = jnp.sum(ev.energy_patch)
    n_valid = jnp.sum(ev.energy_patch > 0)
    e_prior = _prior_energy(window, eps, opts)
    # DSO eq 8.19 prior quadratic, evaluated in pair precision: b·ε and
    # ½εᵀHε cancel against E_m (they were rebased against each other at
    # marginalization time), so the compensated terms matter here.
    s = eps.reshape(-1)
    hs_hi, hs_lo = df64.df_matvec(window.h_marg, window.h_marg_lo, s)
    bs_hi, bs_lo = df64.df_dot(window.b_marg, window.b_marg_lo, s)
    shs_hi, shs_lo = df64.df_dot(hs_hi, hs_lo, s)
    e_hi, e_lo = df64.df_add(window.energy_marg, window.energy_marg_lo,
                             bs_hi, bs_lo)
    e_hi, e_lo = df64.df_add(e_hi, e_lo, 0.5 * shs_hi, 0.5 * shs_lo)
    e_marg = df64.value(e_hi, e_lo)
    return (e_land + e_prior + e_marg.astype(e_land.dtype)), n_valid


def _energy(window: Window, model, eps, idepth, lm_mask, opts: PBAOptions,
            packed_maps=None):
    """Total energy: landmarks + affine priors + marginalized quadratic."""
    ev = _evaluate(window, model, eps, idepth, lm_mask, opts,
                   with_gradients=False, packed_maps=packed_maps)
    e, n_valid = _energy_from_ev(window, ev, eps, opts)
    return e, n_valid, ev.status_candidate


def _solve_step(window: Window, sys: LinearSystem, eps, idepth, regularizer,
                opts: PBAOptions):
    """LM step from an assembled system → (eps', idepth', pose_sq, d_sq).

    Factored out of :func:`_pba_iteration` so the shard_map path can reuse
    it after psum-ing the pose system across the landmark axis (the
    per-landmark Schur quantities in ``sys`` stay landmark-local)."""
    k = window.num_slots
    dtype = eps.dtype

    lam = regularizer
    s = eps.reshape(-1)
    # the rebased prior gradient b_m + H_m·s is a cancelling difference of
    # large terms — evaluate it with the compensated ledger pair
    hs_hi, hs_lo = df64.df_matvec(window.h_marg, window.h_marg_lo, s)
    b_prior = df64.value(*df64.df_add(window.b_marg, window.b_marg_lo,
                                      hs_hi, hs_lo))
    h_full = (
        sys.h_pose
        + (window.h_marg + window.h_marg_lo)
        + jnp.diag(jnp.diagonal(sys.h_pose) * lam)
        - sys.h_schur / (1.0 + lam)
    )
    b_full = (
        sys.b_pose
        - sys.b_schur / (1.0 + lam)
        + b_prior
    )
    # dead frame slots have zero rows: add identity so the solve is well-posed
    slot_live = jnp.repeat(window.frame_valid, BLOCK)
    h_full = jnp.where(
        slot_live[:, None] & slot_live[None, :], h_full,
        jnp.eye(k * BLOCK, dtype=h_full.dtype))
    b_full = jnp.where(slot_live, b_full, 0.0)

    step = -jnp.linalg.solve(h_full, b_full[:, None])[:, 0].astype(dtype)
    step = jnp.where(jnp.isfinite(step), step, 0.0)
    step = jnp.where(slot_live, step, 0.0)
    eps_new = eps + step.reshape(k, BLOCK)

    # idepth back-substitution (hessian_block_evaluation.hpp:240)
    step_pose = step.reshape(k, BLOCK)
    d_step = -(
        sys.b_d + jnp.einsum("inja,ja->in", sys.hpd, step_pose,
                             precision=HIGHEST)
    ) * sys.inv_hdd / (1.0 + lam)
    d_step = jnp.where(jnp.isfinite(d_step), d_step, 0.0)
    idepth_new = idepth + d_step

    return eps_new, idepth_new, jnp.sum(step * step), jnp.sum(d_step * d_step)


@partial(jax.jit, static_argnames=("opts",))
def _pba_iteration(window: Window, model, fej: FEJCache, eps, idepth, lm_mask,
                   regularizer, opts: PBAOptions):
    """One LM iteration: linearize at (eps, idepth), solve, return candidate state."""
    sys = _linearize(window, model, fej, eps, idepth, lm_mask, opts)
    eps_new, idepth_new, pose_sq, d_sq = _solve_step(
        window, sys, eps, idepth, regularizer, opts)
    return eps_new, idepth_new, pose_sq + d_sq


@partial(jax.jit, static_argnames=("opts",))
def _energy_jit(window: Window, model, eps, idepth, lm_mask, opts: PBAOptions):
    return _energy(window, model, eps, idepth, lm_mask, opts)


@partial(jax.jit, static_argnames=("opts",))
def _fej_jit(window: Window, model, opts: PBAOptions):
    return _fej_cache(window, model)


def active_lm_mask(window: Window):
    return window.lm_valid & window.frame_valid[:, None]


def _relinearize_all(window: Window, eps, idepth) -> Window:
    """Fold the current increment into the linearization point of EVERY frame.

    Only legal while the marginalization ledger is empty (no FEJ-consistency
    constraint yet) — then the solve becomes plain Gauss-Newton with fresh
    Jacobians, which has a far larger convergence basin.  With a non-empty
    ledger the reference semantics (frozen FEJ) apply instead.
    """
    t_new = window.t_lin() @ SE3.exp(eps[:, :6])
    return dataclasses.replace(
        window,
        t_lin_q=t_new.q,
        t_lin_t=t_new.t,
        affine0=window.affine0 + eps[:, 6:],
        eps=jnp.zeros_like(window.eps),
        lm_idepth=idepth,
    )


@partial(jax.jit, static_argnames=("opts",))
def _solve_loop_device(window: Window, model, opts: PBAOptions):
    """The whole LM solve as one device program (zero host round-trips).

    Mirrors the host loop semantics: force-accept for the first
    ``min_iterations``, candidate-status commit on accept, tolerance-based
    convergence, and (while the ledger is empty) relinearization of every
    frame after each accepted step.  The FEJ cache is recomputed from the
    carried linearization state each iteration — identical values when the
    linearization is frozen, fresh Jacobians when it is not.
    """
    lm_mask = active_lm_mask(window)
    ledger_empty = jnp.max(jnp.abs(window.h_marg)) == 0.0
    dtype = window.eps.dtype

    def with_state(tq, tt, ab0, idep_lin, status):
        return dataclasses.replace(
            window, t_lin_q=tq, t_lin_t=tt, affine0=ab0,
            lm_idepth=idep_lin, res_status=status)

    # one evaluation: feeds both the initial energy and the first
    # linearization (the patch-row gather yields values AND gradients)
    ev0 = _evaluate(window, model, window.eps, window.lm_idepth, lm_mask,
                    opts)
    e0, n0 = _energy_from_ev(window, ev0, window.eps, opts)
    fej0 = _fej_cache(window, model)

    # carry: linearization state + increments + carried evaluation/FEJ
    carry0 = (
        window.t_lin_q, window.t_lin_t, window.affine0,   # linearization
        window.eps, window.lm_idepth, window.lm_idepth,   # eps, idepth, lin_idepth
        window.res_status, e0, n0,
        jnp.asarray(opts.initial_regularizer, dtype),
        jnp.asarray(0, jnp.int32), (n0 == 0),
        ev0, fej0, jnp.asarray(False),                    # ev, fej, fej_stale
    )

    def cond(c):
        return (c[10] < opts.max_iterations) & ~c[11]

    def body(c):
        (tq, tt, ab0, eps, idepth, lin_idepth, status, e, n, lam, it, done,
         ev, fej, fej_stale) = c
        win = with_state(tq, tt, ab0, lin_idepth, status)
        # FEJ geometry depends only on the linearization state — recompute
        # only after a relinearization changed it (bootstrap phase); with a
        # non-empty ledger it is computed exactly once, before the loop.
        fej = jax.lax.cond(
            fej_stale, lambda w: _fej_cache(w, model), lambda _: fej, win)
        sys = _linearize_from_ev(win, fej, ev, eps, opts)
        eps_new, idepth_new, pose_sq, d_sq = _solve_step(
            win, sys, eps, idepth, lam, opts)
        step_sq = pose_sq + d_sq
        ev_new = _evaluate(win, model, eps_new, idepth_new, lm_mask, opts)
        e_new, n_new = _energy_from_ev(win, ev_new, eps_new, opts)
        cand = ev_new.status_candidate

        ftol = jnp.abs(e - e_new) / jnp.maximum(e, 1e-30) < opts.function_tolerance
        ok = (n_new > 0) & jnp.isfinite(e_new)
        accept = ((e_new < e) | (opts.force_accept & (it < opts.min_iterations))) & ok
        state_sq = jnp.sum(eps_new * eps_new)
        ptol = step_sq < opts.parameter_tolerance * (state_sq + opts.parameter_tolerance)
        done_new = done | ftol | (accept & ptol)
        if opts.force_accept:
            done_new = done_new | ~accept

        eps = jnp.where(accept, eps_new, eps)
        idepth = jnp.where(accept, idepth_new, idepth)
        status = jnp.where(accept, cand, status)
        e = jnp.where(accept, e_new, e)
        n = jnp.where(accept, n_new, n)
        lam = jnp.where(accept, lam / opts.reg_decrease, lam * opts.reg_increase)
        # the carried evaluation matches the carried (eps, idepth, status):
        # the trial evaluation's ok-mask already equals a fresh evaluation
        # under the committed statuses (OOB candidates have geom_ok=False)
        ev = jax.tree_util.tree_map(
            lambda new, old: jnp.where(accept, new, old), ev_new, ev)

        # bootstrap relinearization: fold eps into the linearization point.
        # residuals/energies are invariant under the re-parameterization, so
        # the carried evaluation stays valid; only the FEJ geometry goes stale
        relin = accept & ledger_empty & ~done_new
        t_new = SE3(tq, tt) @ SE3.exp(eps[:, :6])
        tq = jnp.where(relin, t_new.q, tq)
        tt = jnp.where(relin, t_new.t, tt)
        ab0 = jnp.where(relin, ab0 + eps[:, 6:], ab0)
        lin_idepth = jnp.where(relin, idepth, lin_idepth)
        eps = jnp.where(relin, jnp.zeros_like(eps), eps)
        return (tq, tt, ab0, eps, idepth, lin_idepth, status, e, n, lam,
                it + 1, done_new, ev, fej, relin)

    (tq, tt, ab0, eps, idepth, _lin, status, e, n, _lam, _it, _done,
     _ev, _fej, _stale) = jax.lax.while_loop(cond, body, carry0)

    out = dataclasses.replace(
        window, t_lin_q=tq, t_lin_t=tt, affine0=ab0, eps=eps,
        lm_idepth=idepth, res_status=status)

    # relinearize the newest frame (photometric_bundle_adjustment.cpp:311)
    newest = jnp.sum(out.frame_valid) - 1
    t_last = (SE3(out.t_lin_q[newest], out.t_lin_t[newest])
              @ SE3.exp(out.eps[newest, :6]))
    out = dataclasses.replace(
        out,
        t_lin_q=out.t_lin_q.at[newest].set(t_last.q),
        t_lin_t=out.t_lin_t.at[newest].set(t_last.t),
        affine0=out.affine0.at[newest].add(out.eps[newest, 6:]),
        eps=out.eps.at[newest].set(0.0),
    )

    status, baseline, inliers, outlier, opt_count = _point_status_kernel(
        out, model, opts)
    out = dataclasses.replace(
        out, res_status=status, lm_baseline=baseline,
        lm_inliers=inliers, lm_outlier=outlier, lm_opt_count=opt_count)
    return out, e, n


def solve_window(window: Window, model, opts: PBAOptions = PBAOptions(),
                 readback: bool = True):
    """Full backend solve (EigenPBA::solve): FEJ → LM loop → relinearize →
    outlier rejection — one fused device program + one scalar readback.

    ``readback=False`` returns the (energy, num_valid) device scalars so the
    caller can batch them into a single host transfer."""
    out, e, n = _solve_loop_device(window, model, opts)
    if not readback:
        return out, (e, n)
    energy, n_valid = jax.device_get((e, n))
    return out, {"energy": float(energy), "num_valid": int(n_valid)}


@partial(jax.jit, static_argnames=("opts",))
def pose_covariances(window: Window, model, opts: PBAOptions = PBAOptions()):
    """Pose-pose covariance of the window (the estimate_uncertainty path).

    Mirrors ``covarianceMatrixPosePose``
    (eigen_photometric_bundle_adjustment_problem.hpp:206-242): the full
    reduced system H_pose+prior − H_schur + H_marg is pseudo-inverted via
    SVD dropping the single scale nullspace (``pseudoInverse``,
    eigen_photometric_bundle_adjustment.cpp:30-44), then per-pair relative
    6×6 pose covariances via the adjoint sandwich
    (covariance_matrices_of_relative_poses.hpp + se3_motion.hpp:151-158):
        Σ_rel[i,j] = Adj Σ_ii Adjᵀ − Σ_ijᵀ Adjᵀ − Adj Σ_ij + Σ_jj,
    with Adj = Adj(T_wj⁻¹ T_wi).

    Returns (cov [K·8, K·8], cov_rel [K, K, 6, 6]).
    """
    k = window.num_slots
    dtype = window.eps.dtype
    lm_mask = active_lm_mask(window)
    fej = _fej_cache(window, model)
    sys = _linearize(window, model, fej, window.eps, window.lm_idepth,
                     lm_mask, opts)
    h = ((sys.h_pose - sys.h_schur).astype(window.h_marg.dtype)
         + window.h_marg + window.h_marg_lo)
    # dead slots get a huge diagonal so their (zero-information) blocks read
    # as ~0 covariance and never masquerade as the scale nullspace
    live = jnp.repeat(window.frame_valid, BLOCK)
    h = jnp.where(live[:, None] & live[None, :], h, 0.0)
    h = h + jnp.diag(jnp.where(live, 0.0, jnp.asarray(1e18, h.dtype)))
    h = 0.5 * (h + h.T)

    u, s_vals, vt = jnp.linalg.svd(h, hermitian=True)
    # drop the smallest singular value (monocular scale nullspace)
    keep = jnp.arange(s_vals.shape[0]) < s_vals.shape[0] - 1
    inv_s = jnp.where(keep, 1.0 / jnp.maximum(s_vals, 1e-300), 0.0)
    cov = _mm(vt.T * inv_s[None, :], u.T).astype(dtype)

    c = cov.reshape(k, BLOCK, k, BLOCK).transpose(0, 2, 1, 3)[:, :, :6, :6]
    sigma_d = c[jnp.arange(k), jnp.arange(k)]                    # [K, 6, 6]
    rel = _relative_poses(window.t_lin_q, window.t_lin_t, window.eps[:, :6])
    adj = rel.adjoint()                                          # [K, K, 6, 6]
    adj_t = jnp.swapaxes(adj, -1, -2)
    sig_rel = (
        _mm(_mm(adj, sigma_d[:, None]), adj_t)
        - _mm(jnp.swapaxes(c, -1, -2), adj_t)
        - _mm(adj, c)
        + sigma_d[None, :]
    )
    return cov, sig_rel


def _relinearize_last(window: Window) -> Window:
    """Re-anchor the newest frame (photometric_bundle_adjustment.cpp:311)."""
    idx = window.frame_count() - 1
    if idx < 0:
        return window
    t_new = SE3(window.t_lin_q[idx], window.t_lin_t[idx]) @ SE3.exp(window.eps[idx, :6])
    return dataclasses.replace(
        window,
        t_lin_q=window.t_lin_q.at[idx].set(t_new.q),
        t_lin_t=window.t_lin_t.at[idx].set(t_new.t),
        affine0=window.affine0.at[idx].add(window.eps[idx, 6:]),
        eps=window.eps.at[idx].set(0.0),
    )


@partial(jax.jit, static_argnames=("opts",))
def _point_status_kernel(window: Window, model, opts: PBAOptions,
                         packed_maps=None):
    lm_mask = active_lm_mask(window)
    ev = _evaluate(window, model, window.eps, window.lm_idepth, lm_mask, opts,
                   with_gradients=False, packed_maps=packed_maps)
    e = ev.energy_patch
    ok = ev.ok
    # 75th percentile of OK residual energies + σ²/2 (updatePointStatuses)
    flat = jnp.where(ok, e, jnp.nan).reshape(-1)
    q75 = jnp.nanquantile(flat, 0.75)
    thresh = jnp.where(jnp.isnan(q75), 0.0, q75) + 0.5 * opts.huber_sigma ** 2

    new_status = jnp.where(ok & (e > thresh), RES_OUTLIER, ev.status_candidate)
    still_ok = ok & (e <= thresh)

    # relative baseline: idepth · ‖t_i − t_j‖ over OK residuals
    poses = window.poses()
    dist = jnp.linalg.norm(poses.t[:, None, :] - poses.t[None, :, :], axis=-1)
    rel = jnp.where(still_ok, window.lm_idepth[:, None, :] * dist[:, :, None], 0.0)
    baseline = jnp.maximum(window.lm_baseline, jnp.max(rel, axis=1))

    inliers = jnp.sum(still_ok, axis=1).astype(jnp.int32)
    outlier = window.lm_outlier | (
        lm_mask & (inliers < opts.min_valid_reprojections))
    opt_count = window.lm_opt_count + (inliers > 0).astype(jnp.int32)
    return new_status, baseline, inliers, outlier, opt_count


def _update_point_statuses(window: Window, model, opts: PBAOptions) -> Window:
    status, baseline, inliers, outlier, opt_count = _point_status_kernel(
        window, model, opts)
    return dataclasses.replace(
        window, res_status=status, lm_baseline=baseline,
        lm_inliers=inliers, lm_outlier=outlier, lm_opt_count=opt_count)


# ---------------------------------------------------------------------------
# Marginalization (updateMarginalizedLinearSystem; DSO eq 8.15/8.19)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("opts",))
def _marg_system_kernel(window: Window, model, opts: PBAOptions):
    """H/b/E of flagged landmarks at the current state (FEJ Jacobians)."""
    fej = _fej_cache(window, model)
    lm_mask = window.lm_marg_flag & window.lm_valid & window.frame_valid[:, None]
    sys = _linearize(window, model, fej, window.eps, window.lm_idepth, lm_mask,
                     opts, marg_pass=True)
    ev = _evaluate(window, model, window.eps, window.lm_idepth, lm_mask, opts,
                   with_gradients=False)
    e_land = jnp.sum(ev.energy_patch)
    # pose system minus landmark Schur — the points' information on poses.
    # note: the prior is NOT included here (only in the frame-marg pass).
    h_pr, b_pr = _prior_system(window, window.eps, opts, marg_pass=True)
    h_pts = sys.h_pose - h_pr - sys.h_schur
    b_pts = sys.b_pose - b_pr - sys.b_schur
    return h_pts, b_pts, e_land


@partial(jax.jit, static_argnames=("opts",))
def _prior_system_marg_jit(window: Window, eps, opts: PBAOptions):
    return _prior_system(window, eps, opts, marg_pass=True)


@jax.jit
def _permute_window(window: Window, perm, drop_marg):
    """Compact frame slots by ``perm`` (kept frames first) in one program.
    ``drop_marg``: flagged-frame mask in the OLD slot order."""
    keep = ~drop_marg[perm]
    return dataclasses.replace(
        window,
        t_lin_q=window.t_lin_q[perm],
        t_lin_t=window.t_lin_t[perm],
        affine0=window.affine0[perm],
        eps=window.eps[perm],
        exposure=window.exposure[perm],
        frame_valid=window.frame_valid[perm] & keep,
        frame_fixed=window.frame_fixed[perm] & keep,
        frame_marg=jnp.zeros_like(window.frame_marg),
        frame_id=jnp.where(window.frame_valid[perm] & keep,
                           window.frame_id[perm], -1),
        lm_uv=window.lm_uv[perm],
        lm_patch=window.lm_patch[perm],
        lm_idepth=window.lm_idepth[perm],
        lm_valid=window.lm_valid[perm] & keep[:, None],
        lm_marg_flag=jnp.zeros_like(window.lm_marg_flag),
        lm_outlier=window.lm_outlier[perm],
        lm_inliers=window.lm_inliers[perm],
        lm_opt_count=window.lm_opt_count[perm],
        lm_baseline=window.lm_baseline[perm],
        res_status=window.res_status[perm][:, perm],
        maps=window.maps[perm],
        patch_map=window.patch_map[perm],
    )


@partial(jax.jit, static_argnames=("opts", "any_lm", "any_frame"))
def _marginalize_device(window: Window, model, perm, opts: PBAOptions,
                        any_lm: bool, any_frame: bool) -> Window:
    """The whole marginalization fold as ONE device program.

    Frame-block Schur elimination (``reduce_system``) is done with masked
    fixed-shape linear algebra: the eliminated sub-block is embedded in the
    full [K·8, K·8] ledger with identity padding, pseudo-inverted in place,
    and the correction is masked to the kept rows/columns — no dynamic
    shapes, no host round-trips.
    """
    ledger_t = window.h_marg.dtype
    h_m, h_l = window.h_marg, window.h_marg_lo
    b_m, b_l = window.b_marg, window.b_marg_lo
    e_m, e_l = window.energy_marg, window.energy_marg_lo
    s = window.eps.reshape(-1).astype(ledger_t)

    # flagged landmarks' pose information at the current state
    h_pts, b_pts, e_land = _marg_system_kernel(window, model, opts)
    h_pts = h_pts.astype(ledger_t)
    # keep the ledger EXACTLY symmetric: einsum contractions are symmetric
    # only up to rounding, and the frame-elimination pass re-symmetrizes —
    # folding a symmetric update makes 0.5*(H+Hᵀ) a bitwise no-op, so the
    # always-on device loop and the flag-gated host path stay bit-identical.
    h_pts = 0.5 * (h_pts + h_pts.T)
    b_pts = b_pts.astype(ledger_t)
    # DSO eq 8.15: energy of dropped residuals at the linearization.
    # Fresh contributions are computed in working precision; the LEDGER
    # accumulation runs in compensated pairs (two_sum) so hundreds of folds
    # do not lose the small updates against the grown prior.
    zs = jnp.zeros_like(s)
    hs_hi, hs_lo = df64.df_matvec(h_pts, jnp.zeros_like(h_pts), s)
    e_m, e_l = df64.df_add_flat(e_m, e_l,
                                e_land.astype(ledger_t)
                                + _mm(s, _mm(h_pts, s)) - _mm(s, b_pts))
    h_m, h_l = df64.df_add_flat(h_m, h_l, h_pts)
    b_m, b_l = df64.df_add(b_m, b_l, *df64.df_add(b_pts, zs,
                                                  -hs_hi, -hs_lo))

    window = dataclasses.replace(
        window,
        lm_valid=window.lm_valid & ~window.lm_marg_flag,
        lm_marg_flag=jnp.zeros_like(window.lm_marg_flag),
    )

    if any_frame:
        # frame priors folded before elimination (reference :185-196)
        h_pr, b_pr = _prior_system(window, window.eps, opts, marg_pass=True)
        h_pr = h_pr.astype(ledger_t)
        b_pr = b_pr.astype(ledger_t)
        h_m, h_l = df64.df_add_flat(h_m, h_l, h_pr)
        prs_hi, prs_lo = df64.df_matvec(h_pr, jnp.zeros_like(h_pr), s)
        b_m, b_l = df64.df_add(b_m, b_l, *df64.df_add(b_pr, zs,
                                                      -prs_hi, -prs_lo))

        # Schur-eliminate flagged frame blocks (reduce_system) with masks,
        # in pair precision: H_ee is inverted in working precision and
        # refined by one Newton step against the pair-precision residual,
        # then the correction products run through compensated matmuls.
        kb = window.num_slots * BLOCK
        marg = jnp.repeat(window.frame_marg & window.frame_valid, BLOCK)
        keep = jnp.repeat(window.frame_valid & ~window.frame_marg, BLOCK)
        eye = jnp.eye(kb, dtype=ledger_t)
        mm = marg[:, None] & marg[None, :]
        h_ee = jnp.where(mm, h_m, eye)
        h_ee_lo = jnp.where(mm, h_l, 0.0)
        x0 = jnp.linalg.pinv(h_ee, hermitian=True)
        # Newton refinement: X₁ = X₀ + X₀(I − A X₀), residual in pairs
        ax_hi, ax_lo = df64.df_matmul(h_ee, h_ee_lo, x0, jnp.zeros_like(x0))
        resid = (eye - ax_hi) - ax_lo
        h_ee_inv = x0 + _mm(x0, resid)

        km = keep[:, None] & marg[None, :]
        h_ke = jnp.where(km, h_m, 0.0)
        h_ke_lo = jnp.where(km, h_l, 0.0)
        corr_hi, corr_lo = df64.df_matmul(h_ke, h_ke_lo, h_ee_inv,
                                          jnp.zeros_like(h_ee_inv))
        prod_hi, prod_lo = df64.df_matmul(corr_hi, corr_lo, h_ke.T, h_ke_lo.T)
        kk = keep[:, None] & keep[None, :]
        h_kk, h_kk_lo = df64.df_add(jnp.where(kk, h_m, 0.0),
                                    jnp.where(kk, h_l, 0.0),
                                    -prod_hi, -prod_lo)
        b_e = jnp.where(marg, b_m, 0.0)
        b_e_lo = jnp.where(marg, b_l, 0.0)
        cb_hi, cb_lo = df64.df_matvec(corr_hi, corr_lo, b_e)
        cb_lo = cb_lo + _mm(corr_hi, b_e_lo)
        b_k, b_k_lo = df64.df_add(jnp.where(keep, b_m, 0.0),
                                  jnp.where(keep, b_l, 0.0),
                                  -cb_hi, -cb_lo)
        h_kk, h_kk_lo = df64.df_scale(*df64.df_add(h_kk, h_kk_lo,
                                                   h_kk.T, h_kk_lo.T), 0.5)

        # compact: permute frame blocks so kept frames occupy the low slots
        idx = (perm[:, None] * BLOCK
               + jnp.arange(BLOCK, dtype=perm.dtype)[None, :]).reshape(-1)
        h_m, h_l = h_kk[idx][:, idx], h_kk_lo[idx][:, idx]
        b_m, b_l = b_k[idx], b_k_lo[idx]

        window = _permute_window(
            window, perm, window.frame_marg & window.frame_valid)

    return dataclasses.replace(window, h_marg=h_m, b_marg=b_m, energy_marg=e_m,
                               h_marg_lo=h_l, b_marg_lo=b_l, energy_marg_lo=e_l)


def marginalize(window: Window, model, opts: PBAOptions = PBAOptions(),
                frame_flags=None, lm_any=None) -> Window:
    """Fold flagged landmarks & frames into the prior ledger, then compact.

    Mirrors updateMarginalizedLinearSystem
    (eigen_photometric_bundle_adjustment_problem.hpp:147-203): compute the
    flagged points' pose information (H_pp − Schur), rebase b at the current
    state, accumulate in the ledger dtype, drop the points; then add the
    flagged frames' prior system and Schur-eliminate their blocks; finally
    compact the frame slots (deque erase → slot permutation).

    ``frame_flags``/``lm_any``: host copies of the flags, when the caller
    already has them (avoids a device→host readback).
    """
    k = window.num_slots
    if lm_any is None:
        lm_any = bool(np.any(np.asarray(window.lm_marg_flag & window.lm_valid)))
    if frame_flags is None:
        frame_flags = np.asarray(window.frame_marg & window.frame_valid)
    any_frame = bool(frame_flags.any())
    if not (lm_any or any_frame):
        return window

    if any_frame:
        kept = np.where(~frame_flags & np.asarray(window.frame_valid))[0]
        dead = [i for i in range(k) if i not in kept]
        perm = np.concatenate([kept, dead]).astype(np.int32)
    else:
        perm = np.arange(k, dtype=np.int32)

    out = _marginalize_device(
        window, model, jnp.asarray(perm), opts, bool(lm_any), any_frame)
    if any_frame:
        object.__setattr__(out, "_frame_count_cache", int(len(kept)))
    return out


# ---------------------------------------------------------------------------
# Frame push (PhotometricBundleAdjustment::pushFrame)
# ---------------------------------------------------------------------------

@jax.jit
def _push_frame_kernel(window: Window, slot, pose_q, pose_t, affine, exposure,
                       fixed, frame_id, uv, patch, idep, lm_count, pixel_map,
                       embed):
    """Device-side frame insertion (single program).

    ``embed``: [C, H, W] channels feeding the patch tables — the intensity
    plane for C=1, frame-embedder channels otherwise."""
    n = window.num_landmark_slots
    valid = jnp.arange(n) < lm_count
    uv = jnp.where(valid[:, None], uv, 0.0)
    patch = jnp.where(valid[:, None], patch, 0.0)
    idep = jnp.where(valid, idep, 0.0)

    status = window.res_status
    status = status.at[slot, :, :].set(RES_OK)
    status = status.at[:, slot, :].set(RES_OK)

    return dataclasses.replace(
        window,
        t_lin_q=window.t_lin_q.at[slot].set(pose_q),
        t_lin_t=window.t_lin_t.at[slot].set(pose_t),
        affine0=window.affine0.at[slot].set(affine),
        eps=window.eps.at[slot].set(0.0),
        exposure=window.exposure.at[slot].set(exposure),
        frame_valid=window.frame_valid.at[slot].set(True),
        frame_fixed=window.frame_fixed.at[slot].set(fixed),
        frame_id=window.frame_id.at[slot].set(frame_id),
        lm_uv=window.lm_uv.at[slot].set(uv),
        lm_patch=window.lm_patch.at[slot].set(patch),
        lm_idepth=window.lm_idepth.at[slot].set(idep),
        lm_valid=window.lm_valid.at[slot].set(valid),
        lm_outlier=window.lm_outlier.at[slot].set(False),
        lm_inliers=window.lm_inliers.at[slot].set(0),
        lm_opt_count=window.lm_opt_count.at[slot].set(0),
        lm_baseline=window.lm_baseline.at[slot].set(0.0),
        res_status=status,
        maps=window.maps.at[slot].set(pixel_map),
        patch=window.patch.at[window.patch_map[slot]].set(
            pack_patch_table_c(embed)),
    )


def push_frame(
    window: Window,
    t_w_c: SE3,
    pixel_map,
    frame_id: int,
    exposure: float = 1.0,
    affine=(0.0, 0.0),
    fixed: bool = False,
    lm_uv=None,
    lm_patch=None,
    lm_idepth=None,
    embed_channels=None,
) -> Window:
    """Insert a keyframe into the next free slot with its active landmarks.

    Residual statuses for all pairs involving the new frame start Ok
    (photometric_bundle_adjustment.cpp pushFrame wires ResidualPoint lists
    from connection statuses; new connections start Ok).

    ``embed_channels``: [C, H, W] frame-embedder channels for a C>1 window
    (``lm_patch`` then carries [N, C·P] channel-major patches); defaults
    to the intensity plane of ``pixel_map`` (C=1).
    """
    slot = window.frame_count()
    k, n = window.num_slots, window.num_landmark_slots
    if slot >= k:
        raise ValueError("window full — marginalize before pushing")
    dtype = window.lm_uv.dtype
    patch_width = window.lm_patch.shape[-1]

    num_lm = 0 if lm_uv is None else min(lm_uv.shape[0], n)

    def pad(x, trailing):
        x = jnp.zeros((n,) + trailing, dtype) if x is None else jnp.asarray(x, dtype)
        if x.shape[0] < n:
            x = jnp.concatenate([x, jnp.zeros((n - x.shape[0],) + trailing, dtype)])
        return x[:n]

    pixel_map = jnp.asarray(pixel_map, dtype)
    embed = (pixel_map[:1] if embed_channels is None
             else jnp.asarray(embed_channels, dtype))

    out = _push_frame_kernel(
        window, jnp.asarray(slot, jnp.int32),
        jnp.asarray(t_w_c.q, dtype), jnp.asarray(t_w_c.t, dtype),
        jnp.asarray(affine, dtype), jnp.asarray(exposure, dtype),
        jnp.asarray(fixed), jnp.asarray(frame_id, jnp.int32),
        pad(lm_uv, (2,)), pad(lm_patch, (patch_width,)), pad(lm_idepth, ()),
        jnp.asarray(num_lm, jnp.int32), pixel_map, embed)
    object.__setattr__(out, "_frame_count_cache", slot + 1)
    return out
