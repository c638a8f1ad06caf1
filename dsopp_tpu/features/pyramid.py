"""Image pyramids with per-level (intensity, dx, dy) pixel maps.

JAX analog of the reference ``PixelDataFrame`` pyramid
(reference: src/features/include/features/camera/pixel_data_frame.hpp:80 file,
downscale_image.hpp — 2×2 average downscale).  The photometric correction
(inverse response / vignetting) lives in ``dsopp_tpu.sensors.photometric`` and
is applied before this.

Everything here is jittable with static shapes: a pyramid is a tuple of
arrays (one per level), levels halve exactly (odd trailing row/col dropped,
as the reference's ``height/2`` integer division does).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from dsopp_tpu.core.interpolate import build_pixel_map

# Reference PixelDataFrame::kMaxPyramidDepth-equivalent default.
NUM_PYRAMID_LEVELS = 5


def downscale(image):
    """2×2 average downscale, [..., H, W] → [..., H//2, W//2].

    Matches reference downscaleImage (downscale_image.hpp:16-33).
    Implemented as one ``reduce_window`` over 2×2 windows.
    """
    h = (image.shape[-2] // 2) * 2
    w = (image.shape[-1] // 2) * 2
    im = image[..., :h, :w]
    k = im.ndim - 2
    return 0.25 * jax.lax.reduce_window(
        im, jnp.zeros((), im.dtype), jax.lax.add,
        (1,) * k + (2, 2), (1,) * k + (2, 2), "VALID")


def build_pyramid(image, num_levels: int = NUM_PYRAMID_LEVELS):
    """[..., H, W] → tuple of ``num_levels`` images, level 0 = input."""
    levels = [image]
    for _ in range(num_levels - 1):
        levels.append(downscale(levels[-1]))
    return tuple(levels)


def build_pyramid_maps(image, num_levels: int = NUM_PYRAMID_LEVELS):
    """[H, W] → tuple of [3, H_l, W_l] pixel maps (intensity, dx, dy)."""
    return tuple(build_pixel_map(lvl) for lvl in build_pyramid(image, num_levels))
