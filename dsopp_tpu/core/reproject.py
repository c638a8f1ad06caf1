"""Reprojection of (pixel, inverse depth) between frames, with Jacobians.

JAX analog of the reference ``ArrayReprojector``
(reference: src/energy/projector/include/energy/projector/camera_reproject.hpp:101
generic path, :195 pinhole+SE3 fast path, reprojectPattern :56-76).

Scale-free formulation (as in DSO): with reference ray ``r = unproject(uv)``
(z = 1) and inverse depth ``d``, the target-frame point is
``X_t = (R r + d t) / d``; projection is invariant to the positive scale
``1/d``, so everything is computed on ``q = R r + d t``, which stays finite
as d → 0 (points at infinity).  Target inverse depth is ``d / q_z``
(camera_model_base.hpp getDepthScale).

Pose Jacobians use the **right-increment** convention: per-frame state update
is ``T_w_c ← T_w_c · exp(ε)`` with tangent order [υ, ω].  For the relative
pose ``T_t_r = T_t⁻¹ T_r``:

    dq/dε_r = R_tr · [ d·I₃ | −r̂ ]          (host-frame increment)
    dq/dε_t = [ −d·I₃ | q̂ ]                  (target-frame increment)

and duv/dε = J_proj(q) · dq/dε.  These are exact (no pattern-sharing
approximation); all ops are batched over arbitrary leading axes so the
pattern axis P is just another batch axis.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from dsopp_tpu.core.camera import MIN_DEPTH, valid_idepth
from dsopp_tpu.core.lie import SE3, quat_rotate


def _scaled_target_point(model_ref, uv, idepth, t_t_r: SE3):
    """q = R r + d t and the reference ray r."""
    ray = model_ref.unproject(uv)
    q = quat_rotate(t_t_r.q, ray) + idepth[..., None] * t_t_r.t
    return q, ray


def _valid_z(q, idepth):
    """Positive-depth test on scaled coordinates: X_z ≥ kMinDepth."""
    return q[..., 2] >= MIN_DEPTH * jnp.maximum(idepth, 0.0) + 1e-12


class Reprojection(NamedTuple):
    uv: jnp.ndarray        # [..., 2] target pixel
    idepth: jnp.ndarray    # [...] target inverse depth
    valid: jnp.ndarray     # [...] bool


class ReprojectionJac(NamedTuple):
    uv: jnp.ndarray          # [..., 2]
    idepth: jnp.ndarray      # [...]
    valid: jnp.ndarray       # [...]
    d_uv_d_idepth: jnp.ndarray  # [..., 2]
    d_uv_d_eps_ref: jnp.ndarray  # [..., 2, 6]
    d_uv_d_eps_tgt: jnp.ndarray  # [..., 2, 6]


def reproject(model_ref, model_tgt, uv, idepth, t_t_r: SE3) -> Reprojection:
    """Map reference pixels+idepths into the target frame.

    ``uv`` [..., 2], ``idepth`` [...], ``t_t_r`` target-from-reference.
    """
    q, _ = _scaled_target_point(model_ref, uv, idepth, t_t_r)
    uv_t, valid_proj = model_tgt.project(q)
    qz = q[..., 2]
    qz_safe = jnp.where(jnp.abs(qz) < 1e-12, 1e-12, qz)
    idepth_t = idepth / qz_safe
    valid = valid_proj & _valid_z(q, idepth) & valid_idepth(idepth)
    return Reprojection(uv_t, idepth_t, valid)


def reproject_jacobian(model_ref, model_tgt, uv, idepth, t_t_r: SE3) -> ReprojectionJac:
    """Reprojection plus analytic Jacobians (the J1 hot-path math).

    The chain is written as broadcast multiply/accumulate and cross
    products instead of per-point matmuls with tiny (2×3·3×6) contraction
    dims: elementwise f32 arithmetic that XLA fuses, exact whatever the
    device's default matmul precision.
    Identities used:  row·ĥ(v) = row × v  (so J·ĥ(v) is a row-wise cross
    product) and  J·[d·R | −R·ĥ(r)] = [d·(J·R) | −(J·R) row-cross r].
    """
    q, ray = _scaled_target_point(model_ref, uv, idepth, t_t_r)
    uv_t, j_proj, valid_proj = model_tgt.project_jacobian(q)

    qz = q[..., 2]
    qz_safe = jnp.where(jnp.abs(qz) < 1e-12, 1e-12, qz)
    idepth_t = idepth / qz_safe
    valid = valid_proj & _valid_z(q, idepth) & valid_idepth(idepth)

    # d(uv)/d(idepth) = J_proj(q) · t   (contraction over 3 → mul+sum)
    d_uv_d_idepth = jnp.sum(j_proj * t_t_r.t[..., None, :], axis=-1)

    # A = J_proj · R_tr  [..., 2, 3] — the only 3-contraction, expanded
    r_tr = _quat_matrix_like(t_t_r, q)
    a = jnp.sum(j_proj[..., :, :, None] * r_tr[..., None, :, :], axis=-2)

    d = idepth[..., None, None]
    ray_b = jnp.broadcast_to(ray[..., None, :], a.shape)
    q_b = jnp.broadcast_to(q[..., None, :], j_proj.shape)
    # dε_ref: [ d·A | −A·ĥ(ray) ] = [ d·A | −(A-rows × ray) ]
    d_uv_d_eps_ref = jnp.concatenate(
        [d * a, -jnp.cross(a, ray_b)], axis=-1)
    # dε_tgt: [ −d·J | J·ĥ(q) ] = [ −d·J | J-rows × q ]
    d_uv_d_eps_tgt = jnp.concatenate(
        [-d * j_proj, jnp.cross(j_proj, q_b)], axis=-1)
    return ReprojectionJac(
        uv_t, idepth_t, valid, d_uv_d_idepth, d_uv_d_eps_ref, d_uv_d_eps_tgt
    )


def _quat_matrix_like(t: SE3, q_pts):
    """Rotation matrix of ``t`` broadcast to the point batch shape."""
    from dsopp_tpu.core.lie import quat_to_matrix

    r = quat_to_matrix(t.q)
    return jnp.broadcast_to(r, q_pts.shape[:-1] + (3, 3))
