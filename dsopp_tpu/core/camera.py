"""Batched camera models with analytic projection Jacobians.

JAX analog of the reference camera-model layer
(reference: src/energy/camera_model/ — pinhole_camera.hpp:21, simple_radial.hpp,
camera_model_base.hpp).  Behavior parity:

* projection validity = depth >= kMinDepth and pixel inside the image minus a
  kBorderSize margin (camera_model_base.hpp:123 region);
* pyramid-level models divide focal length and principal point by the scale
  (pinhole_camera.hpp:37-41 — no half-pixel shift);
* SimpleRadial distorts radially: r_d = r (1 + k1 r^2 + k2 r^4), with a
  maximum valid radius where the distortion stops being monotonic
  (simple_radial.hpp:53-82).

Design differences from the reference: models are immutable pytrees whose
intrinsics may carry arbitrary leading batch dimensions; project/unproject are
vectorized over points and never branch — validity is returned as a mask, to
be folded into residual masks (the fixed-shape idiom replacing the
reference's bool returns).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax.numpy as jnp

# Reference constants (camera_model_base.hpp).
BORDER_SIZE = 4.0
MIN_DEPTH = 1e-3
MIN_IDEPTH = -1e-4
MAX_IDEPTH = 1.0 / MIN_DEPTH + 10.0


def _inside_roi(uv, image_size, border):
    """uv [..., 2] within [border, size - border - 1]."""
    lo = jnp.asarray(border, uv.dtype)
    hi = image_size - border - 1.0
    return jnp.all((uv >= lo) & (uv <= hi), axis=-1)


def valid_idepth(idepth):
    return (idepth > MIN_IDEPTH) & (idepth < MAX_IDEPTH)


class Pinhole(NamedTuple):
    """Pinhole model: uv = f * xy/z + c.

    Fields broadcast against point batches; ``image_size`` is (width, height).
    """

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    image_size: jnp.ndarray  # [..., 2] (w, h)

    @staticmethod
    def create(image_size, focal, principal, dtype=jnp.float32) -> "Pinhole":
        fx, fy = focal
        cx, cy = principal
        return Pinhole(
            jnp.asarray(fx, dtype), jnp.asarray(fy, dtype),
            jnp.asarray(cx, dtype), jnp.asarray(cy, dtype),
            jnp.asarray(image_size, dtype),
        )

    def scaled(self, scale) -> "Pinhole":
        """Model for a pyramid level downscaled by ``scale`` (2**level)."""
        s = jnp.asarray(scale, self.fx.dtype)
        return Pinhole(
            self.fx / s, self.fy / s, self.cx / s, self.cy / s,
            self.image_size / s,
        )

    def project(self, p3d, border=BORDER_SIZE):
        """[..., 3] → (uv [..., 2], valid [...])."""
        z = p3d[..., 2]
        z_safe = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
        u = self.fx * p3d[..., 0] / z_safe + self.cx
        v = self.fy * p3d[..., 1] / z_safe + self.cy
        uv = jnp.stack([u, v], axis=-1)
        valid = (z >= MIN_DEPTH) & _inside_roi(uv, self.image_size, border)
        return uv, valid

    def project_jacobian(self, p3d, border=BORDER_SIZE):
        """[..., 3] → (uv, J=d(uv)/d(p3d) [..., 2, 3], valid).

        Analytic form mirrors reference pinhole_camera.hpp:101-129.
        """
        x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
        z_safe = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
        iz = 1.0 / z_safe
        iz2 = iz * iz
        uv = jnp.stack([self.fx * x * iz + self.cx, self.fy * y * iz + self.cy], -1)
        zero = jnp.zeros_like(x)
        j = jnp.stack(
            [
                self.fx * iz, zero, -self.fx * x * iz2,
                zero, self.fy * iz, -self.fy * y * iz2,
            ],
            axis=-1,
        ).reshape(x.shape + (2, 3))
        valid = (z >= MIN_DEPTH) & _inside_roi(uv, self.image_size, border)
        return uv, j, valid

    def unproject(self, uv):
        """[..., 2] → ray [..., 3] with z = 1 (reference 'image plane vector')."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return jnp.stack([x, y, jnp.ones_like(x)], axis=-1)

    def unproject_valid(self, uv, border=BORDER_SIZE):
        return self.unproject(uv), _inside_roi(uv, self.image_size, border)

    @property
    def focal(self):
        return jnp.stack([self.fx, self.fy], axis=-1)


class SimpleRadial(NamedTuple):
    """Single-focal radial model: f, cx, cy, k1, k2 (reference simple_radial.hpp).

    Distortion on the normalized plane: r_d = r (1 + k1 r^2 + k2 r^4).
    Outside the monotonic range (past ``max_valid_radius``) the reference
    extends linearly; here projections past it are just marked invalid, which
    is equivalent for residual masking.
    """

    f: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    k1: jnp.ndarray
    k2: jnp.ndarray
    image_size: jnp.ndarray

    @staticmethod
    def create(image_size, f, principal, k1, k2, dtype=jnp.float32) -> "SimpleRadial":
        cx, cy = principal
        return SimpleRadial(
            jnp.asarray(f, dtype), jnp.asarray(cx, dtype), jnp.asarray(cy, dtype),
            jnp.asarray(k1, dtype), jnp.asarray(k2, dtype),
            jnp.asarray(image_size, dtype),
        )

    def scaled(self, scale) -> "SimpleRadial":
        s = jnp.asarray(scale, self.f.dtype)
        # k1, k2 act on the normalized plane — invariant to pixel scaling.
        return SimpleRadial(
            self.f / s, self.cx / s, self.cy / s, self.k1, self.k2,
            self.image_size / s,
        )

    def _max_valid_r2(self):
        """Largest r^2 with d(r_d)/dr = 1 + 3 k1 r^2 + 5 k2 r^4 > 0.

        Mirrors reference simple_radial.hpp:57-66 (smallest positive root of
        the derivative polynomial; +inf when none).
        """
        k1, k2 = self.k1, self.k2
        big = jnp.asarray(1e12, k1.dtype)
        # k2 == 0: root of 1 + 3 k1 r^2 = 0 → r^2 = -1/(3 k1) if k1 < 0.
        lin_root = jnp.where(k1 < 0, -1.0 / (3.0 * jnp.where(k1 < 0, k1, -1.0)), big)
        disc = 9.0 * k1 * k1 - 20.0 * k2
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        k2_safe = jnp.where(jnp.abs(k2) < 1e-12, 1.0, k2)
        r1 = (-3.0 * k1 - sq) / (10.0 * k2_safe)
        r2 = (-3.0 * k1 + sq) / (10.0 * k2_safe)
        # smallest positive root among r1, r2 (they are candidate r^2 values)
        pos_min = jnp.minimum(jnp.where(r1 > 0, r1, big), jnp.where(r2 > 0, r2, big))
        quad_root = jnp.where(disc >= 0, pos_min, big)
        return jnp.where(jnp.abs(self.k2) < 1e-12, lin_root, quad_root)

    def _distort_factor(self, r2):
        return 1.0 + self.k1 * r2 + self.k2 * r2 * r2

    def project(self, p3d, border=BORDER_SIZE):
        z = p3d[..., 2]
        z_safe = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
        mx = p3d[..., 0] / z_safe
        my = p3d[..., 1] / z_safe
        r2 = mx * mx + my * my
        factor = self._distort_factor(r2)
        u = self.f * factor * mx + self.cx
        v = self.f * factor * my + self.cy
        uv = jnp.stack([u, v], axis=-1)
        valid = (
            (z >= MIN_DEPTH)
            & (r2 <= self._max_valid_r2())
            & _inside_roi(uv, self.image_size, border)
        )
        return uv, valid

    def project_jacobian(self, p3d, border=BORDER_SIZE):
        """Analytic d(uv)/d(p3d) via the distorted-plane chain rule."""
        x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
        z_safe = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
        iz = 1.0 / z_safe
        mx, my = x * iz, y * iz
        r2 = mx * mx + my * my
        factor = self._distort_factor(r2)
        dfac_dr2 = self.k1 + 2.0 * self.k2 * r2
        # d(factor*m)/dm = factor*I + 2 dfac_dr2 * m mᵀ
        a00 = factor + 2.0 * dfac_dr2 * mx * mx
        a01 = 2.0 * dfac_dr2 * mx * my
        a11 = factor + 2.0 * dfac_dr2 * my * my
        # dm/dp3d = [[iz, 0, -x iz²], [0, iz, -y iz²]]
        iz2 = iz * iz
        j00 = self.f * (a00 * iz)
        j01 = self.f * (a01 * iz)
        j02 = self.f * (-(a00 * x + a01 * y) * iz2)
        j10 = self.f * (a01 * iz)
        j11 = self.f * (a11 * iz)
        j12 = self.f * (-(a01 * x + a11 * y) * iz2)
        uv = jnp.stack([self.f * factor * mx + self.cx, self.f * factor * my + self.cy], -1)
        j = jnp.stack([j00, j01, j02, j10, j11, j12], axis=-1).reshape(x.shape + (2, 3))
        valid = (
            (z >= MIN_DEPTH)
            & (r2 <= self._max_valid_r2())
            & _inside_roi(uv, self.image_size, border)
        )
        return uv, j, valid

    def unproject(self, uv, newton_iters: int = 10):
        """Invert the radial distortion with fixed-iteration Newton (jittable).

        Solves r (1 + k1 r² + k2 r⁴) = r_d for r, then rescales.
        """
        dx = (uv[..., 0] - self.cx) / self.f
        dy = (uv[..., 1] - self.cy) / self.f
        rd = jnp.sqrt(jnp.maximum(dx * dx + dy * dy, 1e-30))
        r = rd
        for _ in range(newton_iters):
            r2 = r * r
            fval = r * (1.0 + self.k1 * r2 + self.k2 * r2 * r2) - rd
            fprime = 1.0 + 3.0 * self.k1 * r2 + 5.0 * self.k2 * r2 * r2
            fprime = jnp.where(jnp.abs(fprime) < 1e-8, 1e-8, fprime)
            r = r - fval / fprime
        scale = jnp.where(rd > 1e-12, r / rd, 1.0)
        return jnp.stack([dx * scale, dy * scale, jnp.ones_like(dx)], axis=-1)

    def unproject_valid(self, uv, border=BORDER_SIZE):
        return self.unproject(uv), _inside_roi(uv, self.image_size, border)


class TumFov(NamedTuple):
    """FOV fisheye model (Devernay–Faugeras), used by TUM-mono.

    Mirrors reference tum_fov_model.hpp:72-106:
      r_d = atan2(2 r_u tan(ω/2), z) / ω,  uv = f · (r_d/r_u) · xy + c.
    """

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    fov: jnp.ndarray
    image_size: jnp.ndarray

    @staticmethod
    def create(image_size, focal, principal, fov, dtype=jnp.float32) -> "TumFov":
        fx, fy = focal
        cx, cy = principal
        return TumFov(
            jnp.asarray(fx, dtype), jnp.asarray(fy, dtype),
            jnp.asarray(cx, dtype), jnp.asarray(cy, dtype),
            jnp.asarray(fov, dtype), jnp.asarray(image_size, dtype),
        )

    def scaled(self, scale) -> "TumFov":
        s = jnp.asarray(scale, self.fx.dtype)
        return TumFov(self.fx / s, self.fy / s, self.cx / s, self.cy / s,
                      self.fov, self.image_size / s)

    def _project_core(self, p3d):
        x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
        r_u = jnp.sqrt(jnp.maximum(x * x + y * y, 1e-30))
        tan_half = jnp.tan(self.fov / 2.0)
        r_d = jnp.arctan2(2.0 * r_u * tan_half, z) / self.fov
        k = r_d / r_u
        uv = jnp.stack([self.fx * k * x + self.cx, self.fy * k * y + self.cy], -1)
        # at the optical axis the limit is the principal point
        centered = r_u < 1e-8
        uv = jnp.where(
            centered[..., None],
            jnp.stack([jnp.broadcast_to(self.cx, x.shape),
                       jnp.broadcast_to(self.cy, x.shape)], -1), uv)
        return uv

    def project(self, p3d, border=BORDER_SIZE):
        uv = self._project_core(p3d)
        valid = (p3d[..., 2] >= MIN_DEPTH) & _inside_roi(uv, self.image_size, border)
        return uv, valid

    def project_jacobian(self, p3d, border=BORDER_SIZE):
        """d(uv)/d(p3d) via forward-mode autodiff of the closed form (the
        reference uses ceres::Jet for the same purpose)."""
        import jax

        uv = self._project_core(p3d)
        basis = jnp.eye(3, dtype=p3d.dtype)
        cols = [
            jax.jvp(self._project_core, (p3d,),
                    (jnp.broadcast_to(basis[i], p3d.shape),))[1]
            for i in range(3)
        ]
        j = jnp.stack(cols, axis=-1)
        valid = (p3d[..., 2] >= MIN_DEPTH) & _inside_roi(uv, self.image_size, border)
        return uv, j, valid

    def unproject(self, uv):
        """tum_fov_model.hpp:93-106."""
        mx = (uv[..., 0] - self.cx) / self.fx
        my = (uv[..., 1] - self.cy) / self.fy
        r_d = jnp.sqrt(jnp.maximum(mx * mx + my * my, 1e-30))
        tan_half = jnp.tan(self.fov / 2.0)
        z = 1.0 / jnp.tan(r_d * self.fov)
        s = 1.0 / (2.0 * r_d * tan_half)
        ray = jnp.stack([mx * s, my * s, z], -1)
        centered = r_d < 1e-8
        axis = jnp.broadcast_to(
            jnp.asarray([0.0, 0.0, 1.0], uv.dtype), ray.shape)
        ray = jnp.where(centered[..., None], axis, ray)
        # normalize to z = 1 convention used throughout the framework
        zs = ray[..., 2:3]
        return ray / jnp.where(jnp.abs(zs) < 1e-9, 1e-9, zs)

    def unproject_valid(self, uv, border=BORDER_SIZE):
        return self.unproject(uv), _inside_roi(uv, self.image_size, border)


class Division(NamedTuple):
    """Division fisheye model (reference fisheye/division_model.hpp:80-87).

    Projection of the undistorted normalized point m with parameter λ:
    uv = f · α(m) · m + c  with  α = (z − √(z² − 4 λ ‖xy‖²)) / (2 λ ‖xy‖²).
    """

    f: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    lam: jnp.ndarray
    image_size: jnp.ndarray

    @staticmethod
    def create(image_size, f, principal, lam, dtype=jnp.float32) -> "Division":
        cx, cy = principal
        return Division(
            jnp.asarray(f, dtype), jnp.asarray(cx, dtype),
            jnp.asarray(cy, dtype), jnp.asarray(lam, dtype),
            jnp.asarray(image_size, dtype))

    def scaled(self, scale) -> "Division":
        s = jnp.asarray(scale, self.f.dtype)
        return Division(self.f / s, self.cx / s, self.cy / s, self.lam,
                        self.image_size / s)

    def _project_core(self, p3d):
        x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
        r2 = x * x + y * y
        lam_r2 = self.lam * r2
        disc = jnp.maximum(z * z - 4.0 * lam_r2, 0.0)
        denom = jnp.where(jnp.abs(lam_r2) < 1e-12, 1e-12, 2.0 * lam_r2)
        alpha = (z - jnp.sqrt(disc)) / denom
        # λ→0 limit: α = 1/z
        z_safe = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
        alpha = jnp.where(jnp.abs(lam_r2) < 1e-12, 1.0 / z_safe, alpha)
        return jnp.stack([self.f * alpha * x + self.cx,
                          self.f * alpha * y + self.cy], -1)

    def project(self, p3d, border=BORDER_SIZE):
        uv = self._project_core(p3d)
        x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
        disc_ok = z * z - 4.0 * self.lam * (x * x + y * y) >= 0
        valid = (z >= MIN_DEPTH) & disc_ok & _inside_roi(uv, self.image_size, border)
        return uv, valid

    def project_jacobian(self, p3d, border=BORDER_SIZE):
        import jax

        uv, valid = self.project(p3d, border)
        basis = jnp.eye(3, dtype=p3d.dtype)
        cols = [
            jax.jvp(self._project_core, (p3d,),
                    (jnp.broadcast_to(basis[i], p3d.shape),))[1]
            for i in range(3)
        ]
        return uv, jnp.stack(cols, axis=-1), valid

    def unproject(self, uv):
        """Inverse (division_model.hpp): ray = [m, 1 + λ‖m‖²], z-normalized."""
        mx = (uv[..., 0] - self.cx) / self.f
        my = (uv[..., 1] - self.cy) / self.f
        z = 1.0 + self.lam * (mx * mx + my * my)
        z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        return jnp.stack([mx / z_safe, my / z_safe, jnp.ones_like(mx)], -1)

    def unproject_valid(self, uv, border=BORDER_SIZE):
        return self.unproject(uv), _inside_roi(uv, self.image_size, border)


class Atan(NamedTuple):
    """Theta-polynomial fisheye (reference fisheye/atan_camera.hpp:98-128,
    the Kannala–Brandt form also used by the IOS model):

        r_d = θ · (1 + Σᵢ kᵢ θ^(i+1)),   θ = atan2(‖xy‖, z)

    ``poly`` is the static coefficient tuple (k₁ … k_m).  Unprojection
    inverts the polynomial with fixed-iteration Newton (jittable).
    """

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    poly: tuple       # static python floats
    image_size: jnp.ndarray

    @staticmethod
    def create(image_size, focal, principal, poly, dtype=jnp.float32) -> "Atan":
        fx, fy = focal
        cx, cy = principal
        return Atan(
            jnp.asarray(fx, dtype), jnp.asarray(fy, dtype),
            jnp.asarray(cx, dtype), jnp.asarray(cy, dtype),
            tuple(float(p) for p in poly), jnp.asarray(image_size, dtype))

    def scaled(self, scale) -> "Atan":
        s = jnp.asarray(scale, self.fx.dtype)
        return Atan(self.fx / s, self.fy / s, self.cx / s, self.cy / s,
                    self.poly, self.image_size / s)

    def _distort(self, theta):
        acc = jnp.zeros_like(theta)
        for k in reversed(self.poly):
            acc = acc * theta + k
        return theta * (1.0 + acc * theta)

    def _distort_deriv(self, theta):
        # d(r_d)/dθ of θ(1 + Σ kᵢ θ^{i+1}) = 1 + Σ kᵢ (i+2) θ^{i+1}
        acc = jnp.zeros_like(theta)
        for i in reversed(range(len(self.poly))):
            acc = acc * theta + self.poly[i] * (i + 2)
        return 1.0 + acc * theta

    def _project_core(self, p3d):
        n = jnp.sqrt(jnp.maximum(jnp.sum(p3d * p3d, axis=-1), 1e-30))
        ray = p3d / n[..., None]
        x, y, z = ray[..., 0], ray[..., 1], ray[..., 2]
        radius = jnp.sqrt(jnp.maximum(x * x + y * y, 1e-30))
        theta = jnp.arctan2(radius, z)
        r_d = self._distort(theta)
        k = r_d / radius
        uv = jnp.stack([self.fx * k * x + self.cx, self.fy * k * y + self.cy], -1)
        centered = radius < 1e-6
        pp = jnp.stack([jnp.broadcast_to(self.cx, x.shape),
                        jnp.broadcast_to(self.cy, x.shape)], -1)
        return jnp.where(centered[..., None], pp, uv)

    def project(self, p3d, border=BORDER_SIZE):
        uv = self._project_core(p3d)
        valid = (p3d[..., 2] >= MIN_DEPTH) & _inside_roi(uv, self.image_size, border)
        return uv, valid

    def project_jacobian(self, p3d, border=BORDER_SIZE):
        import jax

        uv, valid = self.project(p3d, border)
        basis = jnp.eye(3, dtype=p3d.dtype)
        cols = [
            jax.jvp(self._project_core, (p3d,),
                    (jnp.broadcast_to(basis[i], p3d.shape),))[1]
            for i in range(3)
        ]
        return uv, jnp.stack(cols, axis=-1), valid

    def unproject(self, uv, newton_iters: int = 12):
        mx = (uv[..., 0] - self.cx) / self.fx
        my = (uv[..., 1] - self.cy) / self.fy
        r_d = jnp.sqrt(jnp.maximum(mx * mx + my * my, 1e-30))
        theta = r_d
        for _ in range(newton_iters):
            fval = self._distort(theta) - r_d
            fprime = self._distort_deriv(theta)
            fprime = jnp.where(jnp.abs(fprime) < 1e-8, 1e-8, fprime)
            theta = jnp.clip(theta - fval / fprime, 0.0, jnp.pi)
        tan_t = jnp.tan(jnp.clip(theta, 0.0, jnp.pi / 2 - 1e-6))
        s = tan_t / r_d
        return jnp.stack([mx * s, my * s, jnp.ones_like(mx)], -1)

    def unproject_valid(self, uv, border=BORDER_SIZE):
        return self.unproject(uv), _inside_roi(uv, self.image_size, border)


class IOSCamera(NamedTuple):
    """iOS-device model: pinhole + lookup-table radial magnifier
    (reference pinhole/ios_camera_model.hpp — ARKit lens-distortion LUT).

    A pixel at scaled radius ``r = |f ⊙ m|`` (m = hnormalized ray) is
    displaced radially by ``1 / mag(r / R)`` where ``mag`` linearly
    interpolates the device lookup table (+1) over [0, R] and ``R`` is the
    max in-image radius.  Projection divides by the magnifier, unprojection
    runs a fixed-iteration Gauss-Newton refinement on the z=1 plane (the
    reference uses 7 GN iterations on the ray, ios_camera_model.hpp:80-91).
    """

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    lut: jnp.ndarray          # [L] distortion magnifier table (mag = lut+1)
    max_radius: jnp.ndarray   # scalar R
    image_size: jnp.ndarray

    @staticmethod
    def create(image_size, focal, principal, lut, dtype=jnp.float32) -> "IOSCamera":
        fx, fy = focal
        cx, cy = principal
        w, h = float(image_size[0]), float(image_size[1])
        # per-axis max(center, size − center), like the reference ctor
        # (ios_camera_model.cpp:16-19) — corners taken at (w, h), not (w−1, h−1)
        rx = max(float(cx), w - float(cx))
        ry = max(float(cy), h - float(cy))
        max_r = float(np.hypot(rx, ry))
        return IOSCamera(
            jnp.asarray(fx, dtype), jnp.asarray(fy, dtype),
            jnp.asarray(cx, dtype), jnp.asarray(cy, dtype),
            jnp.asarray(lut, dtype), jnp.asarray(max_r, dtype),
            jnp.asarray(image_size, dtype))

    def scaled(self, scale) -> "IOSCamera":
        s = jnp.asarray(scale, self.fx.dtype)
        # the LUT is indexed by r/R — invariant to uniform pixel scaling
        return IOSCamera(self.fx / s, self.fy / s, self.cx / s, self.cy / s,
                         self.lut, self.max_radius / s, self.image_size / s)

    def _magnifier(self, r_ratio):
        """mag(r/R) = interp(lut)(r/R) + 1 and its d/d(r_ratio)."""
        n = self.lut.shape[0]
        x = jnp.clip(r_ratio, 0.0, 1.0) * (n - 1)
        idx = jnp.clip(x.astype(jnp.int32), 0, n - 2)
        frac = x - idx.astype(x.dtype)
        lo = self.lut[idx]
        hi = self.lut[idx + 1]
        mag = lo * (1.0 - frac) + hi * frac + 1.0
        # constant extension beyond the table → zero slope there
        dmag = jnp.where((r_ratio >= 0.0) & (r_ratio <= 1.0),
                         (hi - lo) * (n - 1), 0.0)
        return mag, dmag

    def _project_core(self, p3d):
        z = p3d[..., 2]
        z_safe = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
        sx = self.fx * p3d[..., 0] / z_safe
        sy = self.fy * p3d[..., 1] / z_safe
        r = jnp.sqrt(jnp.maximum(sx * sx + sy * sy, 1e-30))
        mag, _ = self._magnifier(r / self.max_radius)
        return jnp.stack([sx / mag + self.cx, sy / mag + self.cy], -1)

    def project(self, p3d, border=BORDER_SIZE):
        z = p3d[..., 2]
        z_safe = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
        sx = self.fx * p3d[..., 0] / z_safe
        sy = self.fy * p3d[..., 1] / z_safe
        r = jnp.sqrt(jnp.maximum(sx * sx + sy * sy, 1e-30))
        r_ratio = r / self.max_radius
        mag, _ = self._magnifier(r_ratio)
        uv = jnp.stack([sx / mag + self.cx, sy / mag + self.cy], -1)
        # no r_ratio gate: the reference projects beyond the LUT range using
        # the constant-extended last entry (distortion_magnifier.hpp) and
        # gates only on insideCameraROI; the clip in _magnifier reproduces
        # the constant extension
        valid = (z >= MIN_DEPTH) & _inside_roi(uv, self.image_size, border)
        return uv, valid

    def project_jacobian(self, p3d, border=BORDER_SIZE):
        """Full-chain analytic Jacobian (incl. d(mag)/dr of the LUT)."""
        x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
        z_safe = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
        iz = 1.0 / z_safe
        sx, sy = self.fx * x * iz, self.fy * y * iz
        r = jnp.sqrt(jnp.maximum(sx * sx + sy * sy, 1e-30))
        r_ratio = r / self.max_radius
        mag, dmag = self._magnifier(r_ratio)
        uv = jnp.stack([sx / mag + self.cx, sy / mag + self.cy], -1)
        # d(s/mag)/ds = I/mag − s sᵀ · dmag/(R r mag²)
        g = dmag / (self.max_radius * r * mag * mag)
        a00 = 1.0 / mag - g * sx * sx
        a01 = -g * sx * sy
        a11 = 1.0 / mag - g * sy * sy
        # ds/dp3d = [[fx iz, 0, −fx x iz²], [0, fy iz, −fy y iz²]]
        iz2 = iz * iz
        j00 = a00 * self.fx * iz
        j01 = a01 * self.fy * iz
        j02 = -(a00 * self.fx * x + a01 * self.fy * y) * iz2
        j10 = a01 * self.fx * iz
        j11 = a11 * self.fy * iz
        j12 = -(a01 * self.fx * x + a11 * self.fy * y) * iz2
        j = jnp.stack([j00, j01, j02, j10, j11, j12], -1).reshape(
            x.shape + (2, 3))
        valid = (z >= MIN_DEPTH) & _inside_roi(uv, self.image_size, border)
        return uv, j, valid

    def unproject(self, uv, gn_iters: int = 7):
        """LUT-undistort initial guess + ``gn_iters`` Gauss-Newton steps on
        the z=1 plane (well-posed 2×2 system; reference uses 7 iterations)."""
        px = uv[..., 0] - self.cx
        py = uv[..., 1] - self.cy
        r_d = jnp.sqrt(jnp.maximum(px * px + py * py, 1e-30))
        mag0, _ = self._magnifier(r_d / self.max_radius)
        mx = px * mag0 / self.fx
        my = py * mag0 / self.fy
        for _ in range(gn_iters):
            p3d = jnp.stack([mx, my, jnp.ones_like(mx)], -1)
            proj, jac, _ = self.project_jacobian(p3d, border=-1e9)
            rx = uv[..., 0] - proj[..., 0]
            ry = uv[..., 1] - proj[..., 1]
            # 2x2 solve on the (x, y) columns of J
            a, b = jac[..., 0, 0], jac[..., 0, 1]
            c, d = jac[..., 1, 0], jac[..., 1, 1]
            det = a * d - b * c
            det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
            mx = mx + (d * rx - b * ry) / det
            my = my + (a * ry - c * rx) / det
        return jnp.stack([mx, my, jnp.ones_like(mx)], -1)

    def unproject_valid(self, uv, border=BORDER_SIZE):
        return self.unproject(uv), _inside_roi(uv, self.image_size, border)


CAMERA_MODELS = {"pinhole": Pinhole, "simple_radial": SimpleRadial,
                 "tum_fov": TumFov, "division": Division, "atan": Atan,
                 "ios": IOSCamera}
