"""Neighborhood-packed bilinear sampling — one gather per pattern GROUP.

An epipolar SSD sweep that gathers one row per (landmark, sample,
pattern-point) issues 230k+ rows per tick.  The 8 pattern
points of one (landmark, sample) cluster within a few pixels, so packing
each pixel's 8×8 neighborhood into one row lets the whole pattern be
fetched with a SINGLE central gather: 8× fewer rows, then the bilinear
interpolation runs as dense one-hot contractions on already-local data.

Reference analog: PixelMap::Evaluate over a PatternPatch
(src/features/include/features/camera/pixel_map.hpp:227-300 +
pattern_patch.hpp) — the reference's contiguous Eigen layout exploits the
same pattern locality through the cache; here it is explicit in the layout.

Semantics note: a pattern point whose bilinear corners fall outside its
group's 8×8 window (extreme warp, only possible at degenerate depth-scale
samples) is reported invalid, where the flat path would still sample it.
Such samples are garbage matches in both designs; accuracy tests gate this.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# neighborhood window: base = floor(center) - (WIN//2 - 1) covers corner
# columns floor(center)+[-3, +4] — the ±2 px DSO pattern with subpixel
# positions and warp-induced stretch up to ~1.7x; 8 keeps rows lane-aligned
WIN = 8


def pack_neighborhood(channel_map):
    """[H, W] map → [H*W, 128] neighborhood rows.

    Row p holds the WIN×WIN block whose top-left pixel has flat index p
    (dy-major) in lanes 0..WIN²-1, zeros beyond.  Rows within WIN-1 of the
    right/bottom edge hold zero padding there; they are never addressed
    (bases are clamped).  Built from WIN² shifted slices of the padded map
    stacked on the lane axis: a copy, exact by construction.
    """
    h, w = channel_map.shape
    padded = jnp.pad(channel_map, ((0, WIN - 1), (0, WIN - 1)))
    lanes = [padded[dy:dy + h, dx:dx + w]
             for dy in range(WIN) for dx in range(WIN)]
    lanes += [jnp.zeros_like(channel_map)] * (128 - len(lanes))
    return jnp.stack(lanes, axis=-1).reshape(h * w, 128)


def sample_nbhd(nb, uv, center, height, width):
    """Bilinear samples of a pattern group from neighborhood rows.

    ``nb``: [H*W, 36] packed map; ``uv``: [..., P, 2] pattern positions;
    ``center``: [..., 2] the group's central position (chooses the window).
    Returns (values [..., P], inside [..., P]).  Corner index/weight math
    matches interpolate.bilinear_weights; points escaping the window are
    invalid (see module docstring).
    """
    dtype = uv.dtype   # compute dtype; nb rows may be stored bf16
    x = uv[..., 0]
    y = uv[..., 1]
    inside = (x >= 0) & (y >= 0) & (x <= width - 1) & (y <= height - 1)
    ix = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, width - 2)
    iy = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, height - 2)
    fx = x - ix.astype(dtype)
    fy = y - iy.astype(dtype)

    bx = jnp.clip(jnp.floor(center[..., 0]).astype(jnp.int32) - (WIN // 2 - 1),
                  0, width - WIN)
    by = jnp.clip(jnp.floor(center[..., 1]).astype(jnp.int32) - (WIN // 2 - 1),
                  0, height - WIN)
    rows = jnp.take(nb, by * width + bx, axis=0)        # [..., 128]
    rows = rows[..., : WIN * WIN]                        # drop tile padding

    dx = ix - bx[..., None]                              # [..., P]
    dy = iy - by[..., None]
    in_win = (dx >= 0) & (dx <= WIN - 2) & (dy >= 0) & (dy <= WIN - 2)

    grid = jax.lax.broadcasted_iota(jnp.int32, dx.shape + (WIN,), dx.ndim)
    wx = (jnp.where(grid == dx[..., None], (1.0 - fx)[..., None], 0.0)
          + jnp.where(grid == dx[..., None] + 1, fx[..., None], 0.0))
    wy = (jnp.where(grid == dy[..., None], (1.0 - fy)[..., None], 0.0)
          + jnp.where(grid == dy[..., None] + 1, fy[..., None], 0.0))
    # factorized y-then-x contraction: the [..., P, WIN²] outer-product
    # weight build moved ~0.5 GB/tick at the sweep's 256k-group scale
    win2 = rows.astype(dtype).reshape(
        rows.shape[:-1] + (WIN, WIN))                     # [..., WINy, WINx]
    tmp = jnp.sum(win2[..., None, :, :] * wy[..., :, :, None].astype(dtype),
                  axis=-2)                                # [..., P, WINx]
    vals = jnp.sum(tmp * wx.astype(dtype), axis=-1)       # [..., P]
    return vals, inside & in_win
