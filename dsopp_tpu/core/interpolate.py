"""Bilinear grid sampling of (intensity, dx, dy) pixel maps.

JAX analog of the reference ``PixelMap``/``PixelInfo`` layer
(reference: src/features/include/features/camera/pixel_map.hpp:17-142 and
calculate_pixelinfo.cpp).  Behavior parity:

* per-pixel image gradients are **precomputed** (central differences in the
  interior, one-sided at borders — calculate_pixelinfo.cpp) and then
  bilinearly interpolated together with intensity (pixel_map.hpp:31-38), NOT
  obtained by differentiating the interpolant;
* interpolation uses the corner weights (1-dx)(1-dy), … with (x, y) pixel
  coordinates, ix = floor(x).

Design: a pixel map is a dense ``[3, H, W]`` array (channels:
intensity, d/dx, d/dy); sampling is a batched flat gather over ``H*W``.
Callers guarantee coordinates are inside the camera ROI border (≥ 4 px), so
index clamping never changes in-ROI results; a validity mask is still
returned for belt-and-braces masking.

The scattered gather is the hardest op of the pipeline for an accelerator
(SURVEY §7 "hard parts"); this file is the plain reference implementation,
and ``dsopp_tpu.ops`` holds the packed layouts (plain JAX too) that the hot
path uses instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def image_gradients(image):
    """Per-pixel gradients [..., H, W] → (dx, dy).

    Central differences × 0.5 in the interior; one-sided (undivided)
    differences at the first/last row/column, mirroring the reference kernel
    (calculate_pixelinfo.cpp:99-103).
    """
    left = image[..., :, :-2]
    right = image[..., :, 2:]
    dx_int = 0.5 * (right - left)
    dx_first = image[..., :, 1:2] - image[..., :, 0:1]
    dx_last = image[..., :, -1:] - image[..., :, -2:-1]
    dx = jnp.concatenate([dx_first, dx_int, dx_last], axis=-1)

    top = image[..., :-2, :]
    bottom = image[..., 2:, :]
    dy_int = 0.5 * (bottom - top)
    dy_first = image[..., 1:2, :] - image[..., 0:1, :]
    dy_last = image[..., -1:, :] - image[..., -2:-1, :]
    dy = jnp.concatenate([dy_first, dy_int, dy_last], axis=-2)
    return dx, dy


def build_pixel_map(image):
    """[H, W] or [C, H, W] frame → [3C, H, W] pixel map.

    Channel groups: ``[values (C), d/dx (C), d/dy (C)]`` — for C=1 exactly
    the historical (intensity, dx, dy) layout.  C>1 carries frame-embedder
    channels (reference: pixel_map.hpp:17 ``template <int C>`` +
    frame_embedding_extractor.hpp); per-channel gradients are precomputed
    the same way the C=1 path does.
    """
    if image.ndim == 2:
        image = image[None]
    dx, dy = image_gradients(image)
    return jnp.concatenate([image, dx, dy], axis=0)


def bilinear_weights(uv, height, width):
    """Corner indices and weights for points ``uv`` [..., 2] in (x, y).

    Returns (flat_idx [..., 4] into H*W, weights [..., 4], inside [...]).
    Corner order: (iy,ix), (iy,ix+1), (iy+1,ix), (iy+1,ix+1).
    """
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
    flat_idx = jnp.stack([base, base + 1, base + width, base + width + 1], axis=-1)
    w00 = (1.0 - fx) * (1.0 - fy)
    w01 = fx * (1.0 - fy)
    w10 = (1.0 - fx) * fy
    w11 = fx * fy
    weights = jnp.stack([w00, w01, w10, w11], axis=-1)
    return flat_idx, weights, inside


def sample(pixel_map, uv):
    """Sample a ``[C, H, W]`` map at ``uv`` [..., 2] → ([..., C], inside [...]).

    For the standard 3-channel map the output channels are
    (intensity, dx, dy) interpolated independently (pixel_map.hpp Evaluate).
    """
    c, h, w = pixel_map.shape
    flat_idx, weights, inside = bilinear_weights(uv, h, w)
    flat = pixel_map.reshape(c, h * w)
    gathered = jnp.take(flat, flat_idx, axis=1)  # [C, ..., 4]
    weights = weights.astype(pixel_map.dtype)
    out = jnp.einsum("c...k,...k->...c", gathered, weights,
                     precision=jax.lax.Precision.HIGHEST)
    return out, inside


def sample_intensity(image, uv):
    """Sample a single-channel ``[H, W]`` image at ``uv`` → ([...], inside)."""
    out, inside = sample(image[None], uv)
    return out[..., 0], inside
