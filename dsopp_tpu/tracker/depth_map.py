"""Semi-dense reference depth maps for the frontend (create_depth_maps).

JAX analog of reference src/tracker/tracker/src/create_depth_maps.cpp:
project every active landmark of every active keyframe into the NEWEST
keyframe, scatter-accumulate (idepth·w, w) into a level-0 grid, pool to
coarser levels, and dilate into empty neighbors.  The result seeds the next
frames' pose alignment.

All steps are jitted scatter/pool ops; the landmark loop is a batched
reproject + one ``.at[].add`` scatter.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from dsopp_tpu.core.lie import SE3
from dsopp_tpu.core.reproject import reproject
from dsopp_tpu.solvers.pba import Window, active_lm_mask
from dsopp_tpu.solvers.pose_alignment import LevelPoints


@partial(jax.jit, static_argnames=("height", "width", "num_levels"))
def build_depth_maps(window: Window, model, height: int, width: int,
                     num_levels: int = 5):
    """(idepth, weight) pyramids of the newest keyframe.

    Returns two tuples of [H_l, W_l] arrays.  Mirrors fillFineDepthMap —
    idepth is rescaled into the target frame via the depth scale; weights
    are uniform (the reference weights by idepth variance, which we do not
    track yet).
    """
    k = window.num_slots
    newest = jnp.sum(window.frame_valid) - 1
    poses = window.poses()
    t_w_newest = jax.tree_util.tree_map(lambda x: x[newest], poses)
    t_n = SE3(t_w_newest.q, t_w_newest.t).inverse()

    # relative pose newest ← each frame
    t_rel = SE3(t_n.q[None].repeat(k, 0), t_n.t[None].repeat(k, 0)).compose(poses)

    lm_mask = active_lm_mask(window) & ~window.lm_outlier
    # exclude landmarks anchored in the newest frame itself? the reference
    # skips the newest frame in the loop; its landmarks are usually not yet
    # activated, so the mask below reproduces that.
    anchor_ids = jnp.arange(k)
    lm_mask = lm_mask & (anchor_ids != newest)[:, None]

    rp = reproject(
        model, model, window.lm_uv,
        window.lm_idepth,
        SE3(t_rel.q[:, None, :], t_rel.t[:, None, :]),
    )
    ok = lm_mask & rp.valid

    xs = jnp.clip(jnp.round(rp.uv[..., 0]).astype(jnp.int32), 0, width - 1)
    ys = jnp.clip(jnp.round(rp.uv[..., 1]).astype(jnp.int32), 0, height - 1)
    w = jnp.where(ok, 1.0, 0.0).reshape(-1)
    idep_w = (jnp.where(ok, rp.idepth, 0.0) * jnp.where(ok, 1.0, 0.0)).reshape(-1)
    flat = (ys * width + xs).reshape(-1)

    idepth0 = jnp.zeros(height * width, window.lm_uv.dtype).at[flat].add(idep_w)
    weight0 = jnp.zeros(height * width, window.lm_uv.dtype).at[flat].add(w)
    idepth0 = idepth0.reshape(height, width)
    weight0 = weight0.reshape(height, width)

    # 2x2 sum-pool per level (one reduce_window)
    def pool(x):
        h2 = (x.shape[0] // 2) * 2
        w2 = (x.shape[1] // 2) * 2
        return jax.lax.reduce_window(
            x[:h2, :w2], jnp.zeros((), x.dtype), jax.lax.add,
            (2, 2), (2, 2), "VALID")

    idepths, weights = [idepth0], [weight0]
    for _ in range(1, num_levels):
        idepths.append(pool(idepths[-1]))
        weights.append(pool(weights[-1]))

    # dilate: empty pixels take the 3×3 neighborhood accumulation
    def dilate(i, w):
        def box3(x):
            return jax.lax.reduce_window(
                x, jnp.zeros((), x.dtype), jax.lax.add,
                (3, 3), (1, 1), "SAME")

        empty = w == 0
        return jnp.where(empty, box3(i), i), jnp.where(empty, box3(w), w)

    out_i, out_w = [], []
    for i, w_ in zip(idepths, weights):
        di, dw = dilate(i, w_)
        out_i.append(di)
        out_w.append(dw)
    return tuple(out_i), tuple(out_w)


# Fixed slot count of the compact flow-statistic point set.  The level-0
# depth map has weight > 0 only at projected-landmark pixels plus their
# dilation ring (≤ ~5× the ≤2000-landmark budget); 8192 slots cover that
# with headroom, and on overflow the top-weight (densest-evidence) pixels
# are kept.
FLOW_CAP = 8192


@partial(jax.jit, static_argnames=("height", "width", "num_levels",
                                   "max_points"))
def build_frontend_state(window: Window, model, maps, height: int, width: int,
                         num_levels: int, max_points: int):
    """Depth-map pyramids + per-level frontend points + flow set, fused.

    Fuses ``build_depth_maps`` with ``depth_map_level_points`` over every
    level — one program instead of one eager dispatch per level.
    ``maps``: tuple of the new
    keyframe's per-level pixel maps.  The fourth output is the compact
    [FLOW_CAP] point set for the per-frame flow statistic: extracting the
    weight>0 pixels once per KEYFRAME turns the per-frame flow pass from
    2×H·W lanes into 2×FLOW_CAP (the r4 ledger's 1.4 ms → ~0.1 ms).
    """
    idep, wei = build_depth_maps(window, model, height, width, num_levels)
    points = tuple(
        depth_map_level_points(idep[l], wei[l], maps[l], max_points)
        for l in range(num_levels)
    )
    flow_pts = depth_map_level_points(idep[0], wei[0], maps[0], FLOW_CAP)
    return idep, wei, points, flow_pts


@jax.jit
def mean_square_flows(pts: LevelPoints, model, t_t_r: SE3, border: int = 4):
    """(flow, flow_without_rotation) in ONE pass over the compact flow set.

    Same statistic as :func:`mean_square_optical_flow` on the dense map
    (calculateMeanSquareOpticalFlow, monocular_tracker.cpp:105-134), sharing
    the source-ray unprojection between the two poses.
    """
    uv = pts.uv
    w = model.image_size[..., 0]
    h = model.image_size[..., 1]
    valid = (pts.valid & (pts.idepth > 1e-6)
             & (uv[..., 0] >= border) & (uv[..., 0] < w - border)
             & (uv[..., 1] >= border) & (uv[..., 1] < h - border))
    ray0 = model.unproject(uv)

    def one(t):
        rp = reproject(model, model, uv, pts.idepth, t)
        ray1 = model.unproject(rp.uv)
        ok = valid & rp.valid
        d2 = jnp.sum((ray0 - ray1) ** 2, axis=-1)
        n = jnp.maximum(jnp.sum(ok), 1)
        return jnp.sqrt(jnp.sum(jnp.where(ok, d2, 0.0)) / n.astype(d2.dtype))

    no_rot = SE3(jnp.asarray([1.0, 0, 0, 0], uv.dtype), t_t_r.t)
    return one(t_t_r), one(no_rot)


def depth_map_level_points(idepth_map, weight_map, pixel_map, max_points: int):
    """Turn one (idepth, weight) level into fixed-slot frontend LevelPoints.

    Selects up to ``max_points`` pixels with weight > 0 (deterministic
    top-k by weight), normalizing accumulated idepth.
    """
    h, w = idepth_map.shape
    flat_w = weight_map.reshape(-1)
    k = min(max_points, flat_w.shape[0])
    top_w, idx = jax.lax.top_k(flat_w, k)
    ys = (idx // w).astype(idepth_map.dtype)
    xs = (idx % w).astype(idepth_map.dtype)
    uv = jnp.stack([xs, ys], axis=-1)
    idep = idepth_map.reshape(-1)[idx] / jnp.maximum(top_w, 1e-12)
    vals = pixel_map[0].reshape(-1)[idx]
    valid = (top_w > 0) & (idep > 1e-6)
    pad = max_points - k
    if pad > 0:
        uv = jnp.concatenate([uv, jnp.zeros((pad, 2), uv.dtype)])
        idep = jnp.concatenate([idep, jnp.zeros((pad,), idep.dtype)])
        vals = jnp.concatenate([vals, jnp.zeros((pad,), vals.dtype)])
        valid = jnp.concatenate([valid, jnp.zeros((pad,), bool)])
    return LevelPoints(uv, idep, vals, valid)


@jax.jit
def mean_square_optical_flow(idepth_map, weight_map, model, t_t_r: SE3,
                             border: int = 4):
    """RMS ray-space flow of the depth-map pixels under ``t_t_r``
    (calculateMeanSquareOpticalFlow, monocular_tracker.cpp:105-134)."""
    h, w = idepth_map.shape
    ys, xs = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    uv = jnp.stack([xs, ys], -1).astype(idepth_map.dtype)
    weight = weight_map
    idep = idepth_map / jnp.maximum(weight, 1e-12)
    valid = (
        (weight > 0) & (idep > 1e-6)
        & (xs >= border) & (xs < w - border) & (ys >= border) & (ys < h - border)
    )
    rp = reproject(model, model, uv, idep, t_t_r)
    ray0 = model.unproject(uv)
    ray1 = model.unproject(rp.uv)
    ok = valid & rp.valid
    d2 = jnp.sum((ray0 - ray1) ** 2, axis=-1)
    n = jnp.maximum(jnp.sum(ok), 1)
    return jnp.sqrt(jnp.sum(jnp.where(ok, d2, 0.0)) / n.astype(d2.dtype))
