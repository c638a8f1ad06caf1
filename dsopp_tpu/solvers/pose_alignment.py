"""Frontend two-frame direct pose alignment (the J4 job).

JAX analog of the reference ``EigenPoseAlignment``
(reference: src/energy/problems/src/eigen_pose_alignment.cpp:28-275 —
coarse-to-fine GN/LM over the semi-dense reference depth map with a
1-pixel pattern, 6-DoF relative pose + 2 affine-brightness parameters,
whole-point Huber, affine-brightness prior, LM driver
levenberg_marquardt_algorithm.hpp:78).

Batched redesign:

* the per-level solve is ONE jitted ``lax.while_loop`` — residuals over all
  N points are evaluated as a batch, the 8×8 normal system is two einsum
  contractions, accept/reject is branch-free arithmetic on the carry;
* the reference's sequential retry loop (~30 perturbed initializations with
  energy gating, monocular_tracker.cpp:137-243) becomes a **batched
  hypothesis axis**: all candidate initializations run the full
  coarse-to-fine schedule simultaneously via ``vmap``, and the best final
  energy wins — a strictly stronger search at the cost of already-idle
  vector lanes;
* masks and OOB handling are validity weights, not control flow.

State update convention: the relative pose ``t_t_r`` is LEFT-incremented
(t ← exp(δ)·t, like the reference's ``leftIncrement(step)``), affine
parameters (a, b) of the target frame are additive.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dsopp_tpu.core.lie import SE3
from dsopp_tpu.core.reproject import reproject_jacobian
from dsopp_tpu.ops import pack_corners, sample_packed
from dsopp_tpu.solvers.measure import huber_energy_weight

# the normal equations sum ~10^3-10^4 products: TF32 inputs (the GPU's
# default for f32 dots) would cost ~3 decimal digits of H and b
HIGHEST = jax.lax.Precision.HIGHEST


class AlignmentOptions(NamedTuple):
    """LM options (reference fabric.cpp:126-160 defaults)."""

    max_iterations: int = 50
    initial_regularizer: float = 1e-2    # 1 / initial_trust_region_radius (1e2)
    function_tolerance: float = 1e-5
    parameter_tolerance: float = 1e-5
    huber_sigma: float = 20.0            # kHuberLossSigma × √C
    affine_reg_a: float = 1e12           # affine_brightness_regularizer (×C)
    affine_reg_b: float = 1e8
    reg_decrease: float = 2.0
    reg_increase: float = 10.0
    # rotation-prior hook (reference eigen_pose_alignment.cpp:39 — e.g. a
    # gyro-integrated relative rotation): 0 disables; the prior quaternion
    # is passed per call (align_level rotation_prior_q)
    rotation_prior_weight: float = 0.0


class LevelPoints(NamedTuple):
    """Semi-dense reference points at one pyramid level.

    Built by the tracker from the keyframe depth map (create_depth_maps);
    fixed slot count N with a validity mask.
    """

    uv: jnp.ndarray         # [N, 2] pixel coords at this level
    idepth: jnp.ndarray     # [N]
    intensity: jnp.ndarray  # [N] (C=1) or [N, C] reference values at uv
    valid: jnp.ndarray      # [N] bool


class AlignmentResult(NamedTuple):
    t_t_r: SE3
    affine: jnp.ndarray     # [2] target (a, b)
    energy: jnp.ndarray     # final energy (incl. priors)
    num_valid: jnp.ndarray  # int, valid residual count
    rmse: jnp.ndarray       # sqrt(mean residual energy) over valid points


def _rotation_prior_residual(t_t_r: SE3, prior_q):
    """so3 log of R(t) · R(prior)⁻¹ — the left-tangent rotation deviation."""
    dq = (SE3(t_t_r.q, jnp.zeros_like(t_t_r.t))
          @ SE3(prior_q, jnp.zeros_like(t_t_r.t)).inverse())
    return dq.log()[3:]


def _residual_system(pts: LevelPoints, pixel_map, model, t_t_r: SE3, affine,
                     affine_ref, exposure_ratio, opts: AlignmentOptions,
                     with_jacobian: bool, packed=None, rotation_prior_q=None):
    """Batched residuals (and optionally the 8×8 GN system)."""
    a_t, b_t = affine[0], affine[1]
    a_r, b_r = affine_ref[0], affine_ref[1]
    scale = exposure_ratio * jnp.exp(a_t - a_r)

    rj = reproject_jacobian(model, model, pts.uv, pts.idepth, t_t_r)
    if packed is None:
        packed = pack_corners(pixel_map)
    h_px, w_px = pixel_map.shape[-2:]
    patch, inside = sample_packed(packed, rj.uv, h_px, w_px)
    # channel groups [values C | dx C | dy C] (build_pixel_map); C=1 is the
    # historical (intensity, dx, dy).  Reference: pixel_map.hpp C template.
    num_c = patch.shape[-1] // 3
    vals, gx, gy = (patch[..., :num_c], patch[..., num_c:2 * num_c],
                    patch[..., 2 * num_c:])
    ref_int = pts.intensity
    if ref_int.ndim == pts.uv.ndim - 1:          # [N] legacy C=1 layout
        ref_int = ref_int[..., None]             # → [N, 1]

    if num_c == 1:
        # scalar fast path — bitwise-identical to the historical C=1 code
        # (reduction order matters: the batched-vs-solo parity tests pin
        # cross-compilation rounding at tight tolerances)
        vals, gx, gy = vals[..., 0], gx[..., 0], gy[..., 0]
        ref_int = ref_int[..., 0]

    corrected_ref = scale * (ref_int - b_r)      # [N, C] ([N] when C=1)
    r = (vals - b_t) - corrected_ref
    ok = pts.valid & rj.valid & inside

    # whole-point Huber on the channel-summed energy, σ·√C (reference
    # kHuberLossSigma × √C scaling, eigen_pose_alignment.cpp)
    r2 = jnp.where(ok, r * r if num_c == 1 else jnp.sum(r * r, axis=-1), 0.0)
    sigma = opts.huber_sigma * float(num_c) ** 0.5
    energies, weights = huber_energy_weight(r2, sigma)
    energies = jnp.where(ok, energies, 0.0)
    weights = jnp.where(ok, weights, 0.0)

    energy = jnp.sum(energies)
    num_valid = jnp.sum(ok)
    # affine prior on the absolute target affine state (state_priors.hpp)
    reg = jnp.asarray([opts.affine_reg_a, opts.affine_reg_b], r.dtype)
    energy = energy + 0.5 * jnp.sum(reg * affine * affine)
    # rotation prior (eigen_pose_alignment.cpp:39): 0.5·w·‖log(R R_p⁻¹)‖²
    e_rot = None
    if opts.rotation_prior_weight > 0.0 and rotation_prior_q is not None:
        e_rot = _rotation_prior_residual(t_t_r, rotation_prior_q)
        energy = energy + 0.5 * opts.rotation_prior_weight * jnp.sum(
            e_rot * e_rot)

    if not with_jacobian:
        return energy, num_valid, energies

    # d(uv)/d(left tangent of t_t_r) = −d_uv_d_eps_tgt  (see core.reproject)
    duv = -rj.d_uv_d_eps_tgt                     # [N, 2, 6]
    if num_c == 1:
        dr_dpose = gx[..., None] * duv[..., 0, :] + gy[..., None] * duv[..., 1, :]
        dr_da = -corrected_ref
        dr_db = -jnp.ones_like(r)
        j = jnp.concatenate([dr_dpose, dr_da[..., None], dr_db[..., None]],
                            axis=-1)
        jw = j * weights[..., None]
        h = jnp.einsum("ni,nj->ij", jw, j, precision=HIGHEST)
        b = jnp.einsum("ni,n->i", jw, r, precision=HIGHEST)
    else:
        dr_dpose = (gx[..., None] * duv[..., None, 0, :]
                    + gy[..., None] * duv[..., None, 1, :])   # [N, C, 6]
        dr_da = -corrected_ref                                # [N, C]
        dr_db = -jnp.ones_like(r)                             # [N, C]
        j = jnp.concatenate([dr_dpose, dr_da[..., None], dr_db[..., None]],
                            axis=-1)                          # [N, C, 8]
        jw = j * weights[..., None, None]
        h = jnp.einsum("nci,ncj->ij", jw, j, precision=HIGHEST)
        b = jnp.einsum("nci,nc->i", jw, r, precision=HIGHEST)
    # affine prior system
    h = h.at[6, 6].add(reg[0]).at[7, 7].add(reg[1])
    b = b.at[6].add(reg[0] * affine[0]).at[7].add(reg[1] * affine[1])
    if e_rot is not None:
        # left-increment: d log(exp(δ_rot) R R_p⁻¹)/dδ_rot ≈ I at small e
        w_rot = jnp.asarray(opts.rotation_prior_weight, r.dtype)
        rows = jnp.arange(3, 6)
        h = h.at[rows, rows].add(w_rot)
        b = b.at[3:6].add(w_rot * e_rot)
    return energy, num_valid, (h, b)


@partial(jax.jit, static_argnames=("opts",))
def align_level(pts: LevelPoints, pixel_map, model, t_init: SE3, affine_init,
                affine_ref, exposure_ratio, opts: AlignmentOptions = AlignmentOptions(),
                rotation_prior_q=None):
    """LM solve of one pyramid level (jitted; mirrors the reference LM driver).

    One residual pass per iteration: each trial evaluation yields energy AND
    the GN system at the trial point; on accept the system is reused for the
    next step, on reject the retained system is re-damped — identical accept
    semantics to the reference LM driver at half the residual-pass cost.
    """
    dtype = pts.uv.dtype
    # corner-pack ONCE per level solve — the while-loop body then does a
    # single row gather per point instead of 12 scalar gathers (ops/sample.py)
    packed = pack_corners(pixel_map)

    def eval_full(t_q, t_t, affine):
        e, n, (h, b) = _residual_system(
            pts, pixel_map, model, SE3(t_q, t_t), affine, affine_ref,
            exposure_ratio, opts, with_jacobian=True, packed=packed,
            rotation_prior_q=rotation_prior_q,
        )
        return e, n, h, b

    e0, n0, h0, b0 = eval_full(t_init.q, t_init.t, affine_init)

    # carry: q, t, affine, energy, n_valid, h, b, lm_reg, iter, done
    init = (t_init.q, t_init.t, affine_init, e0, n0, h0, b0,
            jnp.asarray(opts.initial_regularizer, dtype),
            jnp.asarray(0, jnp.int32), n0 == 0)

    def cond(carry):
        it, done = carry[8], carry[9]
        return (it < opts.max_iterations) & ~done

    def body(carry):
        q, t, affine, e, n, h, b, reg, it, done = carry
        # damped solve: (H + reg·diag(H)) δ = −b
        diag = jnp.diagonal(h)
        h_d = h + jnp.eye(8, dtype=dtype) * (reg * diag + 1e-24)[None, :]
        step = -jnp.linalg.solve(h_d, b[:, None])[:, 0]
        step = jnp.where(jnp.isfinite(step), step, 0.0)

        t_new = SE3.exp(step[:6]) @ SE3(q, t)
        affine_new = affine + step[6:]
        e_new, n_new, h_new, b_new = eval_full(t_new.q, t_new.t, affine_new)

        accept = (e_new < e) & (n_new > 0) & jnp.isfinite(e_new)
        ftol = jnp.abs(e - e_new) / jnp.maximum(e, 1e-30) < opts.function_tolerance
        state_sq = jnp.sum(affine * affine)
        ptol = jnp.sum(step * step) < opts.parameter_tolerance * (
            state_sq + opts.parameter_tolerance
        )
        converged = (ftol & jnp.isfinite(e_new)) | (accept & ptol)

        q = jnp.where(accept, t_new.q, q)
        t = jnp.where(accept, t_new.t, t)
        affine = jnp.where(accept, affine_new, affine)
        e = jnp.where(accept, e_new, e)
        n = jnp.where(accept, n_new, n)
        h = jnp.where(accept, h_new, h)
        b = jnp.where(accept, b_new, b)
        reg = jnp.where(accept, reg / opts.reg_decrease, reg * opts.reg_increase)
        return (q, t, affine, e, n, h, b, reg, it + 1, done | converged)

    q, t, affine, e, n, _, _, _, _, _ = jax.lax.while_loop(cond, body, init)
    rmse = jnp.sqrt(e / jnp.maximum(n, 1).astype(dtype))
    return AlignmentResult(SE3(q, t), affine, e, n, rmse)


def align_pyramid(points_per_level, pixel_maps, models, t_init: SE3, affine_init,
                  affine_ref, exposure_ratio,
                  opts: AlignmentOptions = AlignmentOptions(),
                  first_level=None, rotation_prior_q=None):
    """Coarse-to-fine alignment over the pyramid.

    ``points_per_level``: list of LevelPoints, index = level (0 finest).
    ``pixel_maps``: target pyramid maps, ``models``: per-level camera models.
    ``t_init`` may carry a leading hypothesis batch axis [B]; all hypotheses
    are refined at every level via vmap, best final energy wins.
    """
    num_levels = len(points_per_level)
    start = num_levels - 1 if first_level is None else first_level
    batched = t_init.q.ndim == 2

    t = t_init
    affine = affine_init
    result = None
    for level in range(start, -1, -1):
        args = (points_per_level[level], pixel_maps[level], models[level])
        if batched:
            result = jax.vmap(
                lambda tq, tt, ab, a=args: align_level(
                    a[0], a[1], a[2], SE3(tq, tt), ab, affine_ref,
                    exposure_ratio, opts, rotation_prior_q=rotation_prior_q)
            )(t.q, t.t, affine)
        else:
            result = align_level(*args, t, affine, affine_ref, exposure_ratio,
                                 opts, rotation_prior_q=rotation_prior_q)
        t = result.t_t_r
        affine = result.affine

    if batched:
        # pick the hypothesis with the best PER-POINT energy among those
        # keeping at least half the best valid count (a spurious minimum
        # that drops most points can have a lower summed energy; the
        # reference's per-try acceptance gates on rmse)
        nv = result.num_valid
        nv_floor = jnp.maximum(1, jnp.max(nv) // 2)
        score = jnp.where(nv >= nv_floor,
                          result.energy / jnp.maximum(nv, 1), jnp.inf)
        best = jnp.argmin(score)
        result = jax.tree_util.tree_map(lambda x: x[best], result)
    return result
