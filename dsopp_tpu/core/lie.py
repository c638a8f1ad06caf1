"""Batched SO3/SE3 Lie-group operations on quaternions.

JAX analog of the reference motion layer
(reference: src/energy/motion/include/energy/motion/se3_motion.hpp:16 — an SE3
wrapper over Sophus with right/left increments and Adjoint-based "log
transformers").  Design differences:

* rotations are unit quaternions ``[w, x, y, z]`` stored in plain arrays with
  arbitrary leading batch dimensions — every op is vectorized, nothing assumes
  a single transform;
* tangent vectors are ``[upsilon(3), omega(3)]`` (translation first, Sophus
  convention);
* all branches use Taylor-guarded ``where`` so the ops are differentiable and
  NaN-free at the identity (needed because solvers autodiff through these).

An SE3 is the pair ``(q, t)``: ``x_out = R(q) @ x + t``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_SMALL = 1e-6


def _safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 1e-30))


# ---------------------------------------------------------------------------
# Quaternion primitives ([..., 4], scalar-first [w, x, y, z])
# ---------------------------------------------------------------------------

def quat_multiply(a, b):
    aw, ax, ay, az = jnp.moveaxis(a, -1, 0)
    bw, bx, by, bz = jnp.moveaxis(b, -1, 0)
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conjugate(q):
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_normalize(q):
    return q / _safe_sqrt(jnp.sum(q * q, axis=-1, keepdims=True))


def quat_rotate(q, v):
    """Rotate vectors ``v`` [..., 3] by quaternions ``q`` [..., 4]."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_to_matrix(q):
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """Rotation matrix [..., 3, 3] → quaternion [..., 4] (Shepperd, branch-free).

    Computes all four candidate quaternions and selects the best-conditioned
    one with ``where`` so it vectorizes.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)

    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # [..., 4cand, 4]
    scores = jnp.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        axis=-1,
    )
    best = jnp.argmax(scores, axis=-1)
    q = jnp.take_along_axis(cands, best[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    return quat_normalize(q)


def so3_hat(w):
    """[..., 3] → skew matrices [..., 3, 3]."""
    z = jnp.zeros_like(w[..., 0])
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    m = jnp.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def so3_exp_quat(omega):
    """so3 tangent [..., 3] → unit quaternion."""
    theta_sq = jnp.sum(omega * omega, axis=-1, keepdims=True)
    theta = _safe_sqrt(theta_sq)
    half = 0.5 * theta
    small = theta_sq < _SMALL
    # sin(θ/2)/θ with Taylor fallback 1/2 − θ²/48
    k = jnp.where(small, 0.5 - theta_sq / 48.0, jnp.sin(half) / theta)
    w = jnp.where(small, 1.0 - theta_sq / 8.0, jnp.cos(half))
    return quat_normalize(jnp.concatenate([w, k * omega], axis=-1))


def so3_log(q):
    """Unit quaternion → so3 tangent [..., 3]."""
    q = jnp.where(q[..., :1] < 0, -q, q)  # take w >= 0 branch
    w = q[..., :1]
    v = q[..., 1:]
    s_sq = jnp.sum(v * v, axis=-1, keepdims=True)
    s = _safe_sqrt(s_sq)
    small = s_sq < _SMALL
    angle = 2.0 * jnp.arctan2(s, w)
    # θ/s with Taylor fallback 2/w · (1 + s²/(3w²))
    w_safe = jnp.maximum(w, 1e-12)
    k = jnp.where(small, 2.0 / w_safe * (1.0 + s_sq / (3.0 * w_safe * w_safe)), angle / s)
    return k * v


def _so3_left_jacobian_terms(omega):
    """Coefficients (A, B) with V = I + A ω̂ + B ω̂² (the SO3 left Jacobian)."""
    theta_sq = jnp.sum(omega * omega, axis=-1)
    theta = _safe_sqrt(theta_sq)
    small = theta_sq < _SMALL
    a = jnp.where(small, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(theta)) / jnp.maximum(theta_sq, 1e-30))
    b = jnp.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (theta - jnp.sin(theta)) / jnp.maximum(theta_sq * theta, 1e-30),
    )
    return a, b


def _apply_V(omega, v, sign=1.0):
    """V(ω) v  computed via two cross products (no 3×3 materialization)."""
    a, b = _so3_left_jacobian_terms(omega)
    a = sign * a
    c1 = jnp.cross(omega, v)
    c2 = jnp.cross(omega, c1)
    return v + a[..., None] * c1 + b[..., None] * c2


def _apply_V_inv(omega, t):
    """V(ω)^{-1} t: V^{-1} = I − ½ω̂ + c ω̂²,  c = (1 − A/(2B')) / θ² form."""
    theta_sq = jnp.sum(omega * omega, axis=-1)
    theta = _safe_sqrt(theta_sq)
    small = theta_sq < _SMALL
    half = 0.5 * theta
    # c = 1/θ² (1 − (θ/2)·cot(θ/2))  with Taylor 1/12 + θ²/720
    cot = jnp.cos(half) / jnp.where(small, jnp.ones_like(half), jnp.sin(half))
    c = jnp.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half * cot) / jnp.maximum(theta_sq, 1e-30),
    )
    c1 = jnp.cross(omega, t)
    c2 = jnp.cross(omega, c1)
    return t - 0.5 * c1 + c[..., None] * c2


# ---------------------------------------------------------------------------
# Group types
# ---------------------------------------------------------------------------

class SO3(NamedTuple):
    """Batched rotation: unit quaternion [..., 4] (w, x, y, z)."""

    q: jnp.ndarray

    @staticmethod
    def identity(batch=(), dtype=jnp.float32) -> "SO3":
        q = jnp.broadcast_to(
            jnp.array([1.0, 0, 0, 0], dtype=dtype), batch + (4,)
        )
        return SO3(q)

    @staticmethod
    def exp(omega) -> "SO3":
        return SO3(so3_exp_quat(omega))

    def log(self):
        return so3_log(self.q)

    def apply(self, v):
        return quat_rotate(self.q, v)

    def inverse(self) -> "SO3":
        return SO3(quat_conjugate(self.q))

    def compose(self, other: "SO3") -> "SO3":
        return SO3(quat_normalize(quat_multiply(self.q, other.q)))

    def matrix(self):
        return quat_to_matrix(self.q)


class SE3(NamedTuple):
    """Batched rigid transform: quaternion [..., 4] + translation [..., 3].

    ``apply``: x ↦ R x + t.  Tangent order is [υ(3), ω(3)].
    """

    q: jnp.ndarray
    t: jnp.ndarray

    # -- constructors -------------------------------------------------------
    @staticmethod
    def identity(batch=(), dtype=jnp.float32) -> "SE3":
        return SE3(SO3.identity(batch, dtype).q, jnp.zeros(batch + (3,), dtype))

    @staticmethod
    def from_matrix(m) -> "SE3":
        return SE3(matrix_to_quat(m[..., :3, :3]), m[..., :3, 3])

    @staticmethod
    def exp(xi) -> "SE3":
        """Tangent [..., 6] = [υ, ω] → SE3:  (exp(ω̂), V(ω) υ)."""
        upsilon, omega = xi[..., :3], xi[..., 3:]
        return SE3(so3_exp_quat(omega), _apply_V(omega, upsilon))

    # -- group ops ----------------------------------------------------------
    def log(self):
        omega = so3_log(self.q)
        upsilon = _apply_V_inv(omega, self.t)
        return jnp.concatenate([upsilon, omega], axis=-1)

    def apply(self, x):
        return quat_rotate(self.q, x) + self.t

    def inverse(self) -> "SE3":
        qi = quat_conjugate(self.q)
        return SE3(qi, -quat_rotate(qi, self.t))

    def compose(self, other: "SE3") -> "SE3":
        return SE3(
            quat_normalize(quat_multiply(self.q, other.q)),
            quat_rotate(self.q, other.t) + self.t,
        )

    def __matmul__(self, other):
        if isinstance(other, SE3):
            return self.compose(other)
        return self.apply(other)

    # -- increments (reference se3_motion.hpp right/leftIncrement) ----------
    def right_increment(self, xi) -> "SE3":
        """T · exp(ξ) — the solver-state update convention."""
        return self.compose(SE3.exp(xi))

    def left_increment(self, xi) -> "SE3":
        """exp(ξ) · T."""
        return SE3.exp(xi).compose(self)

    def adjoint(self):
        """Adj(T) [..., 6, 6]: maps right-tangent to left-tangent.

        For tangent order [υ, ω]:  [[R, t̂ R], [0, R]].
        """
        r = quat_to_matrix(self.q)
        th = so3_hat(self.t)
        top = jnp.concatenate(
            [r, jnp.matmul(th, r, precision=jax.lax.Precision.HIGHEST)],
            axis=-1)
        bot = jnp.concatenate([jnp.zeros_like(r), r], axis=-1)
        return jnp.concatenate([top, bot], axis=-2)

    def matrix(self):
        r = quat_to_matrix(self.q)
        top = jnp.concatenate([r, self.t[..., None]], axis=-1)
        last = jnp.broadcast_to(
            jnp.array([0.0, 0, 0, 1.0], dtype=self.q.dtype),
            top.shape[:-2] + (1, 4),
        )
        return jnp.concatenate([top, last], axis=-2)

    def normalized(self) -> "SE3":
        return SE3(quat_normalize(self.q), self.t)

    # -- convenience --------------------------------------------------------
    @property
    def batch_shape(self):
        return self.q.shape[:-1]

    def slice(self, idx) -> "SE3":
        return SE3(self.q[idx], self.t[idx])
