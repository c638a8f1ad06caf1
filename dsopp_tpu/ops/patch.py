"""Patch-table sampling — ONE 128-lane row gather per pattern group.

The BA/refine residual pass needs (intensity, dx, dy) bilinearly sampled at
every reprojected pattern point: K·K·N·P ≈ 200k scattered samples per
evaluation.  Instead of one gathered row per sample, this module packs, per
image pixel, the 10×10 intensity window centered on it into one 128-lane
row ([H·W, 128], lanes 100..127 zero).  The 8 pattern points of one
(anchor, target, landmark) group cluster within a few pixels, so ONE row
fetch per group yields every corner AND the ±1 gradient halo; bilinear
values and the precomputed-central-difference gradients are then
reconstructed in registers:

    value(p)  = Σ_corners w_c · I[c]
    dx(p)     = Σ_corners w_c · ½(I[c+(1,0)] − I[c−(1,0)])
    dy(p)     = Σ_corners w_c · ½(I[c+(0,1)] − I[c−(0,1)])

— numerically identical (same formulas, fp-reassociated) to sampling the
[3, H, W] pixel map of interpolate.build_pixel_map at interior pixels.
Points whose corners+halo escape the 10×10 window (extreme warp) are
reported invalid; callers already require ≥4 px ROI border for validity
(camera BORDER_SIZE), which this window covers at warp stretch ≤ ~1.5×.

The layout trades 128× the image's bytes per table for 8× fewer gathered
rows; whether that trade pays on a given device is measured, not assumed
(PERF.md).

Reference analog: PixelMap::Evaluate over a PatternPatch
(src/features/include/features/camera/pixel_map.hpp:227-300) — the
reference's contiguous Eigen layout exploits the same pattern locality
through the CPU cache; here it is explicit in the row layout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PATCH_WIN = 10      # window side: pattern ±2, bilinear +1, gradient halo ±1
PATCH_LO = 4        # window top-left = floor(center) − PATCH_LO
PATCH_LANES = 128   # one physical f32 tile row


def pack_patch_table(image):
    """[H, W] intensity image → [H·W, 128] per-pixel 10×10 window rows.

    Row p (pixel y, x) holds pixels (y−4..y+5, x−4..x+5) dy-major in lanes
    0..99 (zeros outside the image), lanes 100..127 zero.

    Built from 100 shifted slices of the zero-padded image stacked on the
    lane axis: a copy, exact by construction, which XLA emits as one
    fusion.
    """
    h, w = image.shape
    hi = PATCH_WIN - 1 - PATCH_LO
    padded = jnp.pad(image, ((PATCH_LO, hi), (PATCH_LO, hi)))
    lanes = [padded[ky:ky + h, kx:kx + w]
             for ky in range(PATCH_WIN) for kx in range(PATCH_WIN)]
    lanes += [jnp.zeros_like(image)] * (PATCH_LANES - len(lanes))
    return jnp.stack(lanes, axis=-1).reshape(h * w, PATCH_LANES)


def pack_patch_table_c(channels):
    """[C, H, W] embedder channels → [C·H·W, 128] channel-major table.

    Channel c's rows occupy the block ``c·H·W .. (c+1)·H·W`` — the
    residual pass fetches C rows per pattern group via
    ``(frame·C + c)·H·W + pixel`` flat indices (C=1 reduces to
    :func:`pack_patch_table`).  Reference analog: the ``template <int C>``
    PixelMap (pixel_map.hpp:17) carrying frame-embedder channels
    (frame_embedding_extractor.hpp).
    """
    return jnp.concatenate([pack_patch_table(ch) for ch in channels])


def _axis_weights(frac, idx):
    """One-hot bilinear weights along one window axis.

    ``idx`` [..., P] in-window integer position, ``frac`` [..., P] ∈ [0, 1).
    Returns w [..., P, 10] with (1−f) at idx and f at idx+1, plus the
    central-difference weight profile wg[u] = ½·(w[u−1] − w[u+1]).
    """
    grid = jax.lax.broadcasted_iota(jnp.int32, idx.shape + (PATCH_WIN,),
                                    idx.ndim)
    w = (jnp.where(grid == idx[..., None], (1.0 - frac)[..., None], 0.0)
         + jnp.where(grid == idx[..., None] + 1, frac[..., None], 0.0))
    zero = jnp.zeros_like(w[..., :1])
    wg = 0.5 * (jnp.concatenate([zero, w[..., :-1]], axis=-1)
                - jnp.concatenate([w[..., 1:], zero], axis=-1))
    return w, wg


def patch_center_row(center, height, width):
    """Row index + window base for a group center [..., 2].

    Returns (row [...], bx [...], by [...]) — ``row`` indexes a [H·W, 128]
    table (add ``frame·H·W`` for a flat multi-frame bank).
    """
    cx = jnp.clip(jnp.floor(center[..., 0]).astype(jnp.int32), 0, width - 1)
    cy = jnp.clip(jnp.floor(center[..., 1]).astype(jnp.int32), 0, height - 1)
    return cy * width + cx, cx - PATCH_LO, cy - PATCH_LO


def sample_pattern_rows(rows, uv, bx, by, height, width):
    """Pattern values + gradients from already-fetched window rows.

    ``rows``: [..., 128] patch rows; ``uv``: [..., P, 2]; ``bx``/``by``:
    window base from :func:`patch_center_row`.
    Returns (vals [..., P], gx [..., P], gy [..., P], inside [..., P]).
    """
    dtype = rows.dtype
    x = uv[..., 0]
    y = uv[..., 1]
    inside = (x >= 0) & (y >= 0) & (x <= width - 1) & (y <= height - 1)
    ix = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, width - 2)
    iy = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, height - 2)
    fx = x - ix.astype(dtype)
    fy = y - iy.astype(dtype)

    win = rows[..., : PATCH_WIN * PATCH_WIN].reshape(
        rows.shape[:-1] + (PATCH_WIN, PATCH_WIN))        # [..., 10y, 10x]

    dxi = ix - bx[..., None]                              # [..., P]
    dyi = iy - by[..., None]
    # corners at dxi..dxi+1 plus the ±1 gradient halo must stay in-window
    in_win = (dxi >= 1) & (dxi <= PATCH_WIN - 3) & \
             (dyi >= 1) & (dyi <= PATCH_WIN - 3)

    dxi = jnp.clip(dxi, 1, PATCH_WIN - 3)
    dyi = jnp.clip(dyi, 1, PATCH_WIN - 3)
    wx, wxg = _axis_weights(fx, dxi)                      # [..., P, 10]
    wy, wyg = _axis_weights(fy, dyi)

    # contract y then x (and x then y for dy) — mul+sum over the 10-axis;
    # XLA fuses the broadcast products into the reduction (no [P,10,10]
    # materialization), and the 10-wide contraction stays exact f32
    win_b = win[..., None, :, :]                          # [..., 1, 10y, 10x]
    tmp_y = jnp.sum(win_b * wy[..., :, :, None], axis=-2)   # [..., P, 10x]
    tmp_x = jnp.sum(win_b * wx[..., :, None, :], axis=-1)   # [..., P, 10y]
    vals = jnp.sum(tmp_y * wx, axis=-1)                     # [..., P]
    gx = jnp.sum(tmp_y * wxg, axis=-1)
    gy = jnp.sum(tmp_x * wyg, axis=-1)
    return vals, gx, gy, inside & in_win


def sample_values_rows(rows, uv, bx, by, height, width):
    """Bilinear VALUES of many points from already-fetched window rows.

    Like :func:`sample_pattern_rows` but values-only: no gradient halo is
    needed, so the usable window is the full 10×10 (corners may sit at
    window index 0..9 → base offset ∈ [0, 8] instead of [1, 7]).  This is
    the epipolar-sweep workhorse: one row serves a GROUP of consecutive
    epiline samples × pattern points (reference findBest SSD walk,
    depth_estimation.cpp:36-77, needs intensities only).

    ``rows``: [..., 128]; ``uv``: [..., M, 2] sample positions sharing the
    row; ``bx``/``by``: window base from :func:`patch_center_row`.
    Returns (vals [..., M], inside [..., M]).
    """
    dtype = rows.dtype
    x = uv[..., 0]
    y = uv[..., 1]
    inside = (x >= 0) & (y >= 0) & (x <= width - 1) & (y <= height - 1)
    ix = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, width - 2)
    iy = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, height - 2)
    fx = x - ix.astype(dtype)
    fy = y - iy.astype(dtype)

    win = rows[..., : PATCH_WIN * PATCH_WIN].reshape(
        rows.shape[:-1] + (PATCH_WIN, PATCH_WIN))        # [..., 10y, 10x]

    dxi = ix - bx[..., None]                              # [..., M]
    dyi = iy - by[..., None]
    in_win = (dxi >= 0) & (dxi <= PATCH_WIN - 2) & \
             (dyi >= 0) & (dyi <= PATCH_WIN - 2)
    dxi = jnp.clip(dxi, 0, PATCH_WIN - 2)
    dyi = jnp.clip(dyi, 0, PATCH_WIN - 2)

    grid = jax.lax.broadcasted_iota(jnp.int32, dxi.shape + (PATCH_WIN,),
                                    dxi.ndim)
    wx = (jnp.where(grid == dxi[..., None], (1.0 - fx)[..., None], 0.0)
          + jnp.where(grid == dxi[..., None] + 1, fx[..., None], 0.0))
    wy = (jnp.where(grid == dyi[..., None], (1.0 - fy)[..., None], 0.0)
          + jnp.where(grid == dyi[..., None] + 1, fy[..., None], 0.0))
    tmp_y = jnp.sum(win[..., None, :, :] * wy[..., :, :, None], axis=-2)
    vals = jnp.sum(tmp_y * wx, axis=-1)                   # [..., M]
    return vals, inside & in_win


def sample_pattern_patch(table, uv, center, height, width):
    """Values + gradients of a pattern group from one patch-table row.

    ``table``: [H·W, 128]; ``uv``: [..., P, 2] pattern positions;
    ``center``: [..., 2] group center (chooses the row).
    Returns (vals [..., P], gx [..., P], gy [..., P], inside [..., P]).
    """
    row, bx, by = patch_center_row(center, height, width)
    rows = jnp.take(table, row, axis=0)                   # [..., 128]
    return sample_pattern_rows(rows, uv, bx, by, height, width)
