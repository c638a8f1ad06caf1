"""Corner-packed bilinear sampling — one gathered row per sample point.

Numerically identical to :func:`dsopp_tpu.core.interpolate.sample` (same
corner weights, same summation order); only the memory layout of the gather
changes.  The naive path gathers 4 corners x C channels as independent
scalar elements (``take`` over a ``[C, H*W]`` map); packing the 4C values a
sample needs into ONE row of a ``[H*W, 4C]`` array turns 4C scalar gathers
into a single contiguous row gather.

Reference analog: PixelMap::Evaluate / interpolateLinear
(src/features/include/features/camera/pixel_map.hpp:227-300) — the
reference's Eigen layout keeps each pixel's (value, dx, dy) contiguous for
the same locality reason.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _corner_base(uv, height, width):
    """Shared index/weight math (identical to interpolate.bilinear_weights)."""
    x = uv[..., 0]
    y = uv[..., 1]
    ix = jnp.floor(x)
    iy = jnp.floor(y)
    fx = x - ix
    fy = y - iy
    inside = (x >= 0) & (y >= 0) & (x <= width - 1) & (y <= height - 1)
    ix = jnp.clip(ix.astype(jnp.int32), 0, width - 2)
    iy = jnp.clip(iy.astype(jnp.int32), 0, height - 2)
    base = iy * width + ix
    w00 = (1.0 - fx) * (1.0 - fy)
    w01 = fx * (1.0 - fy)
    w10 = (1.0 - fx) * fy
    w11 = fx * fy
    weights = jnp.stack([w00, w01, w10, w11], axis=-1)
    return base, weights, inside


def pack_corners(pixel_map):
    """``[C, H, W]`` map → ``([H*W, 4*C]`` packed corners, (H, W)).

    Row ``p`` holds the 4 bilinear corners of the cell whose top-left flat
    index is ``p``, channel-major per corner:
        ``packed[p] = [m[c=0..C-1, p], m[c, p+1], m[c, p+W], m[c, p+W+1]]``
    i.e. packed.reshape(H*W, 4, C)[p, k, c] = corner k of channel c.

    The bottom row / right column cells are never addressed (indices are
    clamped to ``W-2`` / ``H-2``), so the wrap-around of ``roll`` there is
    harmless.
    """
    c, h, w = pixel_map.shape
    flat = pixel_map.reshape(c, h * w)
    corners = jnp.stack(
        [
            flat,
            jnp.roll(flat, -1, axis=1),
            jnp.roll(flat, -w, axis=1),
            jnp.roll(flat, -(w + 1), axis=1),
        ],
        axis=1,
    )  # [C, 4, H*W]
    return corners.transpose(2, 1, 0).reshape(h * w, 4 * c)


def sample_packed(packed, uv, height, width, channels=None):
    """Sample a packed-corner map at ``uv [..., 2]`` → (``[..., C]``, inside).

    Bit-for-bit the same result as ``interpolate.sample`` on the unpacked
    map: the per-corner weighted sum runs in the same corner order.
    ``channels``: real channel count when the rows carry zero padding
    beyond ``4*channels`` lanes.
    """
    base, weights, inside = _corner_base(uv, height, width)
    rows = jnp.take(packed, base, axis=0)               # [..., 4C(+pad)]
    c = packed.shape[-1] // 4 if channels is None else channels
    rows = rows[..., : 4 * c].reshape(rows.shape[:-1] + (4, c))
    weights = weights.astype(packed.dtype)
    out = jnp.einsum("...kc,...k->...c", rows, weights,
                     precision=jax.lax.Precision.HIGHEST)
    return out, inside


def sample_packed_intensity(packed_i, uv, height, width):
    """Intensity-only variant over a ``[H*W, 4]`` packed map → ([...], inside).

    Used by the epipolar SSD search, which never needs the gradient
    channels (depth_estimation.cpp:36-77 samples intensities only).
    """
    base, weights, inside = _corner_base(uv, height, width)
    rows = jnp.take(packed_i, base, axis=0)             # [..., 4]
    out = jnp.sum(rows * weights.astype(packed_i.dtype), axis=-1)
    return out, inside
