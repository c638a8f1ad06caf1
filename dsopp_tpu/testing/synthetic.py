"""Synthetic ground-truth sequence renderer.

Replaces the reference's ``track30seconds`` fixture (a rendered video with GT
poses `gt.tum` and dense GT depth used by ``test_tools::SolverTestData``,
reference: test/tools/src/solver_test_data.cpp:31-90), which is fetched from
the network and is unavailable in this environment.  Instead we render our
own scene analytically, which gives *exact* ground truth:

* scene: a textured corridor (floor/ceiling/side walls/back wall), each plane
  carrying a smooth multi-octave value-noise texture so photometric gradients
  exist everywhere (a requirement for direct methods);
* camera: pinhole, flying forward with a lateral sinusoid and gentle yaw/roll
  wobble — enough parallax for depth estimation and enough rotation to
  exercise the SE3 paths;
* outputs per frame: intensity image, dense depth (+ inverse depth), exact
  pose T_wc (camera-to-world).

Rendering is plain NumPy float64 (host-side test fixture); ``backend="jax"``
renders the same scene in float32 on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from dsopp_tpu.core.camera import Pinhole
from dsopp_tpu.core.lie import SE3

import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Procedural texture: multi-octave bilinear value noise, wraps around.
# ---------------------------------------------------------------------------

class _ValueNoise:
    def __init__(self, rng: np.random.Generator, tile: int = 64):
        self.tile = tile
        self.grid = rng.standard_normal((tile, tile))

    def __call__(self, u, v):
        t = self.tile
        iu = np.floor(u).astype(np.int64)
        iv = np.floor(v).astype(np.int64)
        fu = u - iu
        fv = v - iv
        # smoothstep for C1 continuity (so image gradients are smooth too)
        fu = fu * fu * (3.0 - 2.0 * fu)
        fv = fv * fv * (3.0 - 2.0 * fv)
        g = self.grid
        v00 = g[iv % t, iu % t]
        v01 = g[iv % t, (iu + 1) % t]
        v10 = g[(iv + 1) % t, iu % t]
        v11 = g[(iv + 1) % t, (iu + 1) % t]
        return (
            v00 * (1 - fu) * (1 - fv)
            + v01 * fu * (1 - fv)
            + v10 * (1 - fu) * fv
            + v11 * fu * fv
        )


class _Texture:
    """Sum of value-noise octaves mapped to intensities around 128."""

    def __init__(self, seed: int, octaves: Sequence[float] = (0.7, 1.9, 4.3, 9.1)):
        rng = np.random.default_rng(seed)
        self.noises = [_ValueNoise(rng) for _ in octaves]
        self.freqs = octaves

    def __call__(self, s, r):
        out = np.zeros_like(s)
        amp = 1.0
        for noise, f in zip(self.noises, self.freqs):
            out += amp * noise(s * f, r * f)
            amp *= 0.55
        return 128.0 + 45.0 * out / 1.8


# ---------------------------------------------------------------------------
# Scene: textured planes
# ---------------------------------------------------------------------------

@dataclass
class _Plane:
    point: np.ndarray   # a point on the plane
    normal: np.ndarray  # unit normal (pointing towards the viewable side)
    e1: np.ndarray      # in-plane texture axes
    e2: np.ndarray
    texture: _Texture


def _corridor_scene(seed: int = 7):
    ex = np.array([1.0, 0, 0])
    ey = np.array([0, 1.0, 0])
    ez = np.array([0, 0, 1.0])
    return [
        _Plane(np.array([0, 1.5, 0.0]), -ey, ex, ez, _Texture(seed + 0)),   # floor
        _Plane(np.array([0, -1.5, 0.0]), ey, ex, ez, _Texture(seed + 1)),   # ceiling
        _Plane(np.array([-2.0, 0, 0.0]), ex, ey, ez, _Texture(seed + 2)),   # left wall
        _Plane(np.array([2.0, 0, 0.0]), -ex, ey, ez, _Texture(seed + 3)),   # right wall
        _Plane(np.array([0, 0, 14.0]), -ez, ex, ey, _Texture(seed + 4)),    # back wall
    ]


def _render_view(camera: Pinhole, t_wc: SE3, planes, height: int, width: int):
    """Ray-cast all planes, keep the nearest positive hit per pixel."""
    ys, xs = np.meshgrid(np.arange(height, dtype=np.float64),
                         np.arange(width, dtype=np.float64), indexing="ij")
    uv = jnp.asarray(np.stack([xs, ys], axis=-1))
    rays_c = np.asarray(camera.unproject(uv))          # z=1 rays, camera frame
    r_wc = np.asarray(SE3(t_wc.q, jnp.zeros_like(t_wc.t)).matrix())[:3, :3]
    rays_w = rays_c @ r_wc.T
    origin = np.asarray(t_wc.t)

    best_t = np.full((height, width), np.inf)
    image = np.zeros((height, width))
    for plane in planes:
        denom = rays_w @ plane.normal
        # hit from the viewable side only (denominator < 0 w.r.t. outward normal)
        num = (plane.point - origin) @ plane.normal
        with np.errstate(divide="ignore", invalid="ignore"):
            t_hit = num / denom
        valid = (denom < -1e-9) & (t_hit > 1e-6) & (t_hit < best_t)
        if not np.any(valid):
            continue
        hit = origin + t_hit[..., None] * rays_w
        s = (hit - plane.point) @ plane.e1
        r = (hit - plane.point) @ plane.e2
        tex = plane.texture(s, r)
        image = np.where(valid, tex, image)
        best_t = np.where(valid, t_hit, best_t)

    # depth = z-coordinate in camera frame = t_hit * ray_c_z (ray_c_z == 1)
    depth = best_t * rays_c[..., 2]
    return image, depth


# ---------------------------------------------------------------------------
# Trajectory + sequence
# ---------------------------------------------------------------------------

def _so3_exp_quat_np(omega):
    """Rotation-only exp in NumPy f64 → quaternion [w, x, y, z].

    Host-side so the fixture never requests f64 from JAX (which warns and
    truncates where x64 is off); under the CPU x64 oracle the
    resulting SE3 keeps full f64 precision.
    """
    omega = np.asarray(omega, np.float64)
    theta = np.linalg.norm(omega)
    if theta < 1e-12:
        return np.array([1.0, 0.0, 0.0, 0.0])
    axis = omega / theta
    return np.concatenate([[np.cos(0.5 * theta)], np.sin(0.5 * theta) * axis])


def corridor_trajectory(num_frames: int, advance: float = 0.08):
    """Smooth forward flight with lateral sinusoid and yaw/roll wobble."""
    poses = []
    for i in range(num_frames):
        z = advance * i
        x = 0.35 * np.sin(0.05 * i)
        y = 0.12 * np.sin(0.083 * i + 1.0)
        yaw = 0.06 * np.sin(0.041 * i + 0.5)
        pitch = 0.025 * np.sin(0.071 * i)
        roll = 0.02 * np.sin(0.031 * i + 2.0)
        # translation/rotation split so translation is exact (not V-coupled);
        # the quaternion is computed host-side in f64 (see _so3_exp_quat_np)
        q = _so3_exp_quat_np([pitch, yaw, roll])
        poses.append(SE3(jnp.asarray(q), jnp.asarray(np.array([x, y, z]))))
    return poses


@dataclass
class SyntheticSequence:
    """Rendered GT sequence: the test-time replacement for track30seconds."""

    camera: Pinhole                # float64 model at level 0
    images: np.ndarray             # [F, H, W] intensities 0..255
    depths: np.ndarray             # [F, H, W] camera-frame z depth
    poses: list                    # list[SE3] camera-to-world (T_wc)
    timestamps: np.ndarray         # [F] seconds

    @property
    def num_frames(self):
        return self.images.shape[0]

    @property
    def idepths(self):
        with np.errstate(divide="ignore"):
            return 1.0 / self.depths

    def pose_t_wc(self, i) -> SE3:
        return self.poses[i]

    def t_target_ref(self, target: int, ref: int) -> SE3:
        """Relative pose mapping ref-camera coords into target-camera coords."""
        return self.poses[target].inverse() @ self.poses[ref]


def _render_views_jax(planes, q, t, fx, fy, cx, cy, height, width):
    """All frames in one jitted program (float32; ~100x the numpy path).

    Plane/texture constants are baked in via closure; the per-frame loop is
    a vmap, the per-plane/octave loops unroll at trace time.  Used by the
    benchmarks/profilers at VGA scale — tests keep the float64 numpy oracle.
    """
    import jax

    def mm(a, b):
        # full f32: TF32 inputs would bend every ray by ~1e-3 rad
        return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)

    grids = [jnp.asarray(np.stack([n.grid for n in p.texture.noises]),
                         jnp.float32) for p in planes]

    def noise(grid, u, v):
        tile = grid.shape[0]
        iu = jnp.floor(u)
        iv = jnp.floor(v)
        fu = u - iu
        fv = v - iv
        fu = fu * fu * (3.0 - 2.0 * fu)
        fv = fv * fv * (3.0 - 2.0 * fv)
        iu = iu.astype(jnp.int32) % tile
        iv = iv.astype(jnp.int32) % tile
        flat = grid.reshape(-1)
        v00 = jnp.take(flat, iv * tile + iu)
        v01 = jnp.take(flat, iv * tile + (iu + 1) % tile)
        v10 = jnp.take(flat, ((iv + 1) % tile) * tile + iu)
        v11 = jnp.take(flat, ((iv + 1) % tile) * tile + (iu + 1) % tile)
        return (v00 * (1 - fu) * (1 - fv) + v01 * fu * (1 - fv)
                + v10 * (1 - fu) * fv + v11 * fu * fv)

    ys, xs = jnp.meshgrid(jnp.arange(height, dtype=jnp.float32),
                          jnp.arange(width, dtype=jnp.float32), indexing="ij")
    rays_c = jnp.stack([(xs - cx) / fx, (ys - cy) / fy,
                        jnp.ones_like(xs)], -1)

    def one(qf, tf):
        r_wc = SE3(qf, jnp.zeros(3, jnp.float32)).matrix()[:3, :3]
        rays_w = mm(rays_c, r_wc.T)
        best = jnp.full((height, width), jnp.inf, jnp.float32)
        image = jnp.zeros((height, width), jnp.float32)
        for p, g in zip(planes, grids):
            n = jnp.asarray(p.normal, jnp.float32)
            p0 = jnp.asarray(p.point, jnp.float32)
            denom = mm(rays_w, n)
            num = mm(p0 - tf, n)
            t_hit = num / denom
            valid = (denom < -1e-9) & (t_hit > 1e-6) & (t_hit < best)
            hit = tf + t_hit[..., None] * rays_w
            s = mm(hit - p0, jnp.asarray(p.e1, jnp.float32))
            r = mm(hit - p0, jnp.asarray(p.e2, jnp.float32))
            tex = jnp.zeros_like(s)
            amp = 1.0
            for k, f in enumerate(p.texture.freqs):
                tex = tex + amp * noise(g[k], s * f, r * f)
                amp *= 0.55
            tex = 128.0 + 45.0 * tex / 1.8
            image = jnp.where(valid, tex, image)
            best = jnp.where(valid, t_hit, best)
        return image, best * rays_c[..., 2]

    return jax.jit(jax.vmap(one))(q, t)


_CACHE = {}


def render_sequence(
    num_frames: int = 24,
    height: int = 240,
    width: int = 320,
    focal: float = 260.0,
    seed: int = 7,
    advance: float = 0.08,
    cache: bool = True,
    backend: str = "numpy",
) -> SyntheticSequence:
    """``backend="numpy"``: float64 oracle render (tests).  ``"jax"``: f32
    jitted render on the device, ~100x faster at VGA scale (bench,
    profiling, ``chip_smoke.py``).  Sequences are cached in-process."""
    import jax

    key = (num_frames, height, width, focal, seed, advance, backend)
    if cache and key in _CACHE:
        return _CACHE[key]
    # f64 model under the CPU x64 oracle; f32 where x64 is off — asking
    # for f64 there only triggers a truncation warning, never real precision
    cam_dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    camera = Pinhole.create(
        (float(width), float(height)), (focal, focal),
        (width / 2.0 - 0.5, height / 2.0 - 0.5), cam_dtype,
    )
    planes = _corridor_scene(seed)
    poses = corridor_trajectory(num_frames, advance)

    if backend == "jax":
        q = jnp.asarray(np.stack([np.asarray(p.q) for p in poses]), jnp.float32)
        t = jnp.asarray(np.stack([np.asarray(p.t) for p in poses]), jnp.float32)
        images, depths = _render_views_jax(
            planes, q, t, focal, focal,
            width / 2.0 - 0.5, height / 2.0 - 0.5, height, width)
        images = np.asarray(images, np.float64)
        depths = np.asarray(depths, np.float64)
    else:
        images = np.zeros((num_frames, height, width))
        depths = np.zeros((num_frames, height, width))
        for i, pose in enumerate(poses):
            images[i], depths[i] = _render_view(camera, pose, planes,
                                                height, width)
    seq = SyntheticSequence(
        camera, images, depths, poses, np.arange(num_frames) / 30.0
    )
    if cache:
        _CACHE[key] = seq
    return seq
