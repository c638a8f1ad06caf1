"""Two-view / multi-view geometry for the bootstrap initializer.

Mirrors the reference's RANSAC sub-steps (reference:
src/feature_based_slam/ — estimate_so3xs2 essential-matrix RANSAC,
estimate_se3_pnp, estimate_so3_inlier_count standstill detection,
triangulate_points, ransac/ransac.hpp generic driver; the reference uses
OpenGV solvers).  Implemented from scratch with vectorized hypothesis
scoring — minimal-set sampling on host, batched residual evaluation over
all hypotheses × points (the batched RANSAC shape).

All functions take **normalized image coordinates** (z = 1 rays).
"""

from __future__ import annotations

import numpy as np


def _normalize_rows(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# Essential matrix (8-point) + decomposition
# ---------------------------------------------------------------------------

def essential_8pt(m1, m2):
    """Least-squares essential matrix from ≥8 normalized correspondences.

    ``m1``/``m2``: [N, 2] normalized coords in view 1 / view 2 with
    m2ᵀ E m1 = 0.  Returns E with the (1, 1, 0) singular-value projection.
    """
    x1, y1 = m1[:, 0], m1[:, 1]
    x2, y2 = m2[:, 0], m2[:, 1]
    a = np.stack([
        x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, np.ones_like(x1),
    ], axis=1)
    _, _, vt = np.linalg.svd(a)
    e = vt[-1].reshape(3, 3)
    u, s, vt = np.linalg.svd(e)
    return u @ np.diag([1.0, 1.0, 0.0]) @ vt


def sampson_distance(e, m1, m2):
    """First-order geometric (Sampson) distance of correspondences to E."""
    p1 = np.concatenate([m1, np.ones((len(m1), 1))], axis=1)
    p2 = np.concatenate([m2, np.ones((len(m2), 1))], axis=1)
    ep1 = p1 @ e.T            # E x1
    etp2 = p2 @ e              # Eᵀ x2
    num = np.sum(p2 * ep1, axis=1) ** 2
    den = ep1[:, 0] ** 2 + ep1[:, 1] ** 2 + etp2[:, 0] ** 2 + etp2[:, 1] ** 2
    return num / np.maximum(den, 1e-18)


def ransac_essential(m1, m2, threshold, iterations=300, seed=0):
    """→ (E, inlier mask).  threshold in normalized-coordinate units."""
    rng = np.random.default_rng(seed)
    n = len(m1)
    best_e, best_inliers = None, np.zeros(n, bool)
    if n < 8:
        return None, best_inliers
    thr2 = threshold * threshold
    for _ in range(iterations):
        idx = rng.choice(n, 8, replace=False)
        try:
            e = essential_8pt(m1[idx], m2[idx])
        except np.linalg.LinAlgError:
            continue
        inliers = sampson_distance(e, m1, m2) < thr2
        if inliers.sum() > best_inliers.sum():
            best_inliers = inliers
            best_e = e
    if best_e is not None and best_inliers.sum() >= 8:
        best_e = essential_8pt(m1[best_inliers], m2[best_inliers])
        best_inliers = sampson_distance(best_e, m1, m2) < thr2
    return best_e, best_inliers


def decompose_essential(e, m1, m2):
    """E → (R, t) with the cheirality check (most points in front).

    Returns (r, t, mask) mapping view-1 coords into view 2:
    x2 ∝ R x1 + t, ‖t‖ = 1.
    """
    u, _, vt = np.linalg.svd(e)
    if np.linalg.det(u) < 0:
        u = -u
    if np.linalg.det(vt) < 0:
        vt = -vt
    w = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    candidates = []
    for r in (u @ w @ vt, u @ w.T @ vt):
        for t in (u[:, 2], -u[:, 2]):
            pts, valid = triangulate(r, t, m1, m2)
            candidates.append((valid.sum(), r, t, pts, valid))
    candidates.sort(key=lambda c: -c[0])
    _, r, t, pts, valid = candidates[0]
    return r, t, pts, valid


def triangulate(r, t, m1, m2):
    """Midpoint-free DLT triangulation in view-1 frame.

    x2 ∝ R x1 + t.  Returns ([N, 3] points, in-front-of-both mask).
    """
    n = len(m1)
    pts = np.zeros((n, 3))
    p1 = np.hstack([np.eye(3), np.zeros((3, 1))])
    p2 = np.hstack([r, t.reshape(3, 1)])
    for i in range(n):
        a = np.stack([
            m1[i, 0] * p1[2] - p1[0],
            m1[i, 1] * p1[2] - p1[1],
            m2[i, 0] * p2[2] - p2[0],
            m2[i, 1] * p2[2] - p2[1],
        ])
        _, _, vt = np.linalg.svd(a)
        x = vt[-1]
        pts[i] = x[:3] / x[3] if abs(x[3]) > 1e-12 else np.full(3, np.nan)
    z1 = pts[:, 2]
    z2 = (pts @ r.T + t)[:, 2]
    valid = np.isfinite(z1) & (z1 > 1e-6) & (z2 > 1e-6)
    return pts, valid


# ---------------------------------------------------------------------------
# Rotation-only fit (standstill detection)
# ---------------------------------------------------------------------------

def so3_fit(m1, m2):
    """Best rotation aligning bearing vectors (Kabsch)."""
    v1 = _normalize_rows(np.concatenate([m1, np.ones((len(m1), 1))], axis=1))
    v2 = _normalize_rows(np.concatenate([m2, np.ones((len(m2), 1))], axis=1))
    h = v1.T @ v2
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    return vt.T @ np.diag([1.0, 1.0, d]) @ u.T


def so3_inlier_ratio(m1, m2, threshold, iterations=100, seed=0):
    """Fraction of correspondences explained by pure rotation
    (reference estimate_so3_inlier_count — standstill RANSAC)."""
    rng = np.random.default_rng(seed)
    n = len(m1)
    if n < 2:
        return 1.0
    v1 = _normalize_rows(np.concatenate([m1, np.ones((n, 1))], axis=1))
    v2 = _normalize_rows(np.concatenate([m2, np.ones((n, 1))], axis=1))
    best = 0
    for _ in range(iterations):
        idx = rng.choice(n, min(2, n), replace=False)
        r = so3_fit(m1[idx], m2[idx])
        rot = v1 @ r.T
        # angular reprojection error on the normalized plane
        proj = rot[:, :2] / np.maximum(rot[:, 2:3], 1e-9)
        err = np.linalg.norm(proj - m2, axis=1)
        best = max(best, int((err < threshold).sum()))
    return best / n


# ---------------------------------------------------------------------------
# PnP (DLT minimal solver + RANSAC)
# ---------------------------------------------------------------------------

def pnp_dlt(points3d, m):
    """DLT pose from ≥6 3D–2D correspondences → (R, t): x ∝ R X + t."""
    n = len(points3d)
    a = np.zeros((2 * n, 12))
    for i, (X, u) in enumerate(zip(points3d, m)):
        xh = np.append(X, 1.0)
        a[2 * i, 0:4] = xh
        a[2 * i, 8:12] = -u[0] * xh
        a[2 * i + 1, 4:8] = xh
        a[2 * i + 1, 8:12] = -u[1] * xh
    _, _, vt = np.linalg.svd(a)
    p = vt[-1].reshape(3, 4)
    r_raw = p[:, :3]
    u_, s_, vt_ = np.linalg.svd(r_raw)
    r = u_ @ vt_
    scale = np.mean(s_)
    if np.linalg.det(r) < 0:
        r = -r
        scale = -scale
    t = p[:, 3] / scale
    return r, t


def ransac_pnp(points3d, m, threshold, iterations=200, seed=0):
    """→ (R, t, inlier mask): robust camera pose from 3D–2D matches."""
    rng = np.random.default_rng(seed)
    n = len(points3d)
    best = (None, None, np.zeros(n, bool))
    if n < 6:
        return best
    for _ in range(iterations):
        idx = rng.choice(n, 6, replace=False)
        try:
            r, t = pnp_dlt(points3d[idx], m[idx])
        except np.linalg.LinAlgError:
            continue
        cam = points3d @ r.T + t
        ok_z = cam[:, 2] > 1e-6
        proj = cam[:, :2] / np.maximum(cam[:, 2:3], 1e-9)
        err = np.linalg.norm(proj - m, axis=1)
        inliers = ok_z & (err < threshold)
        if inliers.sum() > best[2].sum():
            best = (r, t, inliers)
    r, t, inliers = best
    if r is not None and inliers.sum() >= 6:
        r, t = pnp_dlt(points3d[inliers], m[inliers])
        cam = points3d @ r.T + t
        proj = cam[:, :2] / np.maximum(cam[:, 2:3], 1e-9)
        err = np.linalg.norm(proj - m, axis=1)
        inliers = (cam[:, 2] > 1e-6) & (err < threshold)
    return r, t, inliers


# ---------------------------------------------------------------------------
# SO3×S2 Sampson refinement (+ focal autocalibration)
# ---------------------------------------------------------------------------

def _spherical_to_unit(theta, phi):
    import jax.numpy as jnp

    st = jnp.sin(theta)
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), jnp.cos(theta)])


def sampson_distance_pixels(e, pc_ref, pc_tgt, inv_focal):
    """Sampson residual in PIXELS for centered pixel coords (reference
    sampsonDistance, cost_functors/sampson_distance_cost.hpp:17-28)."""
    import jax.numpy as jnp

    ones = jnp.ones(pc_ref.shape[:-1] + (1,), pc_ref.dtype)
    r = jnp.concatenate([pc_ref * inv_focal, ones], axis=-1)
    t = jnp.concatenate([pc_tgt * inv_focal, ones], axis=-1)
    er = r @ e.T
    te = t @ e
    top = jnp.sum(t * er, axis=-1)
    bottom = (jnp.sum((er[..., :2] * inv_focal) ** 2, axis=-1)
              + jnp.sum((te[..., :2] * inv_focal) ** 2, axis=-1))
    return jnp.where(bottom < 1e-16, top,
                     top / jnp.sqrt(jnp.maximum(bottom, 1e-16)))


def so3xs2_refine(pc_ref, pc_tgt, r0, t0, focal, threshold,
                  optimize_focal=False, iterations=40):
    """Refine (R, unit-t[, focal]) by Huber'd pixel Sampson distances.

    Mirrors ``refineSO3xS2`` (so3xs2_refinement.cpp:11-49): S2 spherical
    local parameterization (local_parameterization_s2.hpp:27-62), Huber loss
    with ``threshold`` px, LM (Ceres defaults).  ``optimize_focal=True`` is
    the autocalibration variant (estimate_so3xs2_autocalibration.hpp —
    implementation hidden in the reference; re-derived here).

    ``pc_ref``/``pc_tgt``: [N, 2] PRINCIPAL-POINT-CENTERED pixel coords.
    Returns (r [3,3], t_unit [3], focal, rms_px).
    """
    import jax
    import jax.numpy as jnp

    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    pc_ref = jnp.asarray(pc_ref, dtype)
    pc_tgt = jnp.asarray(pc_tgt, dtype)
    r_cur = jnp.asarray(r0, dtype)
    t_cur = jnp.asarray(t0, dtype)
    t_cur = t_cur / jnp.linalg.norm(t_cur)
    f_cur = jnp.asarray(focal, dtype)
    thr = jnp.asarray(threshold, dtype)
    n_par = 6 if optimize_focal else 5

    def hat(v):
        return jnp.array([[0.0, -v[2], v[1]],
                          [v[2], 0.0, -v[0]],
                          [-v[1], v[0], 0.0]], v.dtype)

    def rodrigues(w):
        # series-safe at w = 0 (jacfwd through ‖w‖ alone is NaN there)
        th2 = jnp.sum(w * w)
        th = jnp.sqrt(th2 + 1e-30)
        a = jnp.sin(th) / th
        b = (1.0 - jnp.cos(th)) / (th2 + 1e-30)
        k = hat(w)
        return jnp.eye(3, dtype=w.dtype) + a * k + b * (k @ k)

    def residuals(params, r_c, t_c, f_c):
        from dsopp_tpu.solvers.s2 import s2_plus

        r = r_c @ rodrigues(params[:3])
        # S2 local parameterization (solvers/s2.py — the standalone analog
        # of the reference LocalParameterizationS2)
        t = s2_plus(t_c, params[3:5])
        f = f_c + (params[5] if optimize_focal else 0.0)
        e = hat(t) @ r
        return sampson_distance_pixels(e, pc_ref, pc_tgt, 1.0 / f), (r, t, f)

    def huber_we(res):
        a = thr
        ab = jnp.abs(res)
        w = jnp.where(ab <= a, 1.0, a / jnp.maximum(ab, 1e-30))
        rho = jnp.where(ab <= a, res * res, 2.0 * a * ab - a * a)
        return w, jnp.sum(rho)

    def energy_of(r_c, t_c, f_c):
        res, _ = residuals(jnp.zeros(n_par, dtype), r_c, t_c, f_c)
        return huber_we(res)[1]

    jac = jax.jacfwd(lambda p, r_c, t_c, f_c: residuals(p, r_c, t_c, f_c)[0])

    def body(_, state):
        r_c, t_c, f_c, e, lam = state
        p0 = jnp.zeros(n_par, dtype)
        res, _ = residuals(p0, r_c, t_c, f_c)
        j = jac(p0, r_c, t_c, f_c)
        w, _ = huber_we(res)
        h = (j * w[:, None]).T @ j
        g = (j * w[:, None]).T @ res
        h_d = h + lam * jnp.diag(jnp.diagonal(h)) + 1e-18 * jnp.eye(n_par, dtype=h.dtype)
        step = -jnp.linalg.solve(h_d, g)
        step = jnp.where(jnp.isfinite(step), step, 0.0)
        _, (r_n, t_n, f_n) = residuals(step, r_c, t_c, f_c)
        e_n = energy_of(r_n, t_n, f_n)
        acc = e_n < e
        return (jnp.where(acc, r_n, r_c), jnp.where(acc, t_n, t_c),
                jnp.where(acc, f_n, f_c), jnp.where(acc, e_n, e),
                jnp.where(acc, lam * 0.5, lam * 4.0))

    # the products are tiny; full f32 keeps the GPU's default TF32 inputs
    # from rounding E and the normal equations
    with jax.default_matmul_precision("highest"):
        state = (r_cur, t_cur, f_cur, energy_of(r_cur, t_cur, f_cur),
                 jnp.asarray(1e-4, dtype))
        r_c, t_c, f_c, e, _ = jax.lax.fori_loop(0, iterations, body, state)
    rms = jnp.sqrt(e / max(len(np.asarray(pc_ref)), 1))
    return (np.asarray(r_c), np.asarray(t_c), float(f_c), float(rms))


class AutocalibrationSelector:
    """Aggregates per-pair autocalibration estimates and selects the robust
    consensus (reference autocalibration_selector.hpp — implementation
    hidden; median selection re-derived)."""

    def __init__(self):
        self.focal_lengths = []
        self.k1 = []
        self.k2 = []

    def add_result(self, focal_length, k=(0.0, 0.0)):
        self.focal_lengths.append(float(focal_length))
        self.k1.append(float(k[0]))
        self.k2.append(float(k[1]))

    def reset(self):
        self.focal_lengths.clear()
        self.k1.clear()
        self.k2.clear()

    def get_focal_length(self):
        return float(np.median(self.focal_lengths))

    def get_distortion_coeffs(self):
        return np.array([np.median(self.k1), np.median(self.k2)])

    def __len__(self):
        return len(self.focal_lengths)
