"""Candidate-point selection (the J8 job).

JAX analog of the reference extractors
(reference: src/features/src/eigen_tracking_features_extractor.cpp:99-340 —
DSO's region-histogram threshold + block-max selection; and
sobel_tracking_features_extractor.cpp:26-77 — Sobel quantile variant).

Fixed-shape redesign: instead of data-dependent scans with adaptive re-runs,
selection is one fixed-shape reduction pass —

1. gradient energy g² = dx² + dy² from the level-0 pixel map;
2. per-region (32×32) robust threshold: median(g²) · factor (the analog of
   the reference's per-region gradient-histogram median threshold);
3. the image is tiled into small blocks sized so that the number of blocks
   ≈ ``overscan`` × the requested count; each block contributes its argmax-g²
   pixel if it beats its region threshold and the mask (block-max ≈ the
   reference's window scan, but branch-free);
4. a global ``top_k`` keeps exactly ``num_points`` winners → fixed-shape
   output [N, 2] with a validity mask (dead slots), replacing the
   reference's adaptive-threshold retry loop.

The output is deterministic, jittable, and vmappable over frame batches.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

REGION = 32  # region size for the robust threshold (reference uses 32px regions)


class Candidates(NamedTuple):
    uv: jnp.ndarray        # [N, 2] pixel coordinates (x, y), float
    grad2: jnp.ndarray     # [N] gradient energy at the point
    valid: jnp.ndarray     # [N] bool — slot holds a real point


MAX_GRADIENT_BIN = 50  # reference kMaxGradientLength (integer histogram bins)


def _region_threshold(g2, factor):
    """Per-pixel threshold: histogram-median gradient of the 32×32 region,
    squared, × factor.

    The reference computes exactly this integer-binned histogram median of
    the gradient MAGNITUDE per region (eigen_tracking_features_extractor.cpp
    fillGradientThresholdMap: 50 unit bins, ``computeMedian`` over counts);
    binned counts avoid a sort, and median commutes with the g→g² monotone
    map up to the 1-unit bin quantization.
    """
    h, w = g2.shape
    rh, rw = h // REGION, w // REGION
    crop = g2[: rh * REGION, : rw * REGION]
    g = jnp.minimum(jnp.sqrt(crop), float(MAX_GRADIENT_BIN - 1))
    idx = g.astype(jnp.int32)
    regions = idx.reshape(rh, REGION, rw, REGION).transpose(0, 2, 1, 3)
    regions = regions.reshape(rh, rw, REGION * REGION)
    counts = jnp.sum(
        regions[..., None] == jnp.arange(MAX_GRADIENT_BIN)[None, None, None, :],
        axis=2)                                          # [rh, rw, 50]
    csum = jnp.cumsum(counts, axis=-1)
    half = csum[..., -1:] // 2
    med = jnp.argmax(csum > half, axis=-1).astype(g2.dtype)
    thr = med * med * factor
    # broadcast back to full size (edge pixels take the nearest region)
    yy = jnp.clip(jnp.arange(h) // REGION, 0, rh - 1)
    xx = jnp.clip(jnp.arange(w) // REGION, 0, rw - 1)
    return thr[yy[:, None], xx[None, :]]


@partial(jax.jit, static_argnames=("num_points", "block", "border"))
def select_candidates(
    pixel_map,
    num_points: int,
    mask=None,
    block: int = 0,
    border: int = 4,
    threshold_factor: float = 2.0,
) -> Candidates:
    """Select ``num_points`` well-spread high-gradient pixels.

    ``pixel_map``: [3, H, W] level-0 map.  ``mask``: optional [H, W] bool of
    allowed pixels.  ``block``: tile size; 0 → derived from the image area so
    that #blocks ≈ 2× num_points.
    """
    _, h, w = pixel_map.shape
    dx, dy = pixel_map[1], pixel_map[2]
    g2 = dx * dx + dy * dy

    if block == 0:
        block = max(2, int((h * w / (2.0 * num_points)) ** 0.5))

    yy = jnp.arange(h)
    xx = jnp.arange(w)
    in_border = (
        (yy[:, None] >= border) & (yy[:, None] < h - border)
        & (xx[None, :] >= border) & (xx[None, :] < w - border)
    )
    allowed = in_border if mask is None else (in_border & mask)

    thresh = _region_threshold(g2, threshold_factor)
    score = jnp.where(allowed & (g2 > thresh), g2, -1.0)

    bh, bw = h // block, w // block
    crop = score[: bh * block, : bw * block]
    tiles = crop.reshape(bh, block, bw, block).transpose(0, 2, 1, 3).reshape(bh, bw, -1)
    best_in_tile = jnp.argmax(tiles, axis=-1)
    best_score = jnp.take_along_axis(tiles, best_in_tile[..., None], axis=-1)[..., 0]

    ty = best_in_tile // block
    tx = best_in_tile % block
    py = jnp.arange(bh)[:, None] * block + ty
    px = jnp.arange(bw)[None, :] * block + tx

    flat_score = best_score.reshape(-1)
    flat_xy = jnp.stack([px, py], axis=-1).reshape(-1, 2)

    k = min(num_points, flat_score.shape[0])
    top_score, top_idx = jax.lax.top_k(flat_score, k)
    uv = flat_xy[top_idx].astype(pixel_map.dtype)
    valid = top_score > 0

    if k < num_points:  # pad to the fixed slot count
        pad = num_points - k
        uv = jnp.concatenate([uv, jnp.zeros((pad, 2), uv.dtype)])
        top_score = jnp.concatenate([top_score, jnp.full((pad,), -1.0, top_score.dtype)])
        valid = jnp.concatenate([valid, jnp.zeros((pad,), bool)])
    return Candidates(uv, jnp.maximum(top_score, 0.0), valid)
