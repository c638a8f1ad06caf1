"""Patch-table sampling == pixel-map sampling on interior points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dsopp_tpu.core.interpolate import build_pixel_map, sample
from dsopp_tpu.core.pattern import PATTERN_CENTER, shift_pattern
from dsopp_tpu.ops.patch import (PATCH_LANES, PATCH_WIN, pack_patch_table,
                                 sample_pattern_patch)


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(3)
    return jnp.asarray(rng.uniform(0, 255, (60, 80)), jnp.float64)


def test_table_layout(image):
    h, w = image.shape
    t = pack_patch_table(image)
    assert t.shape == (h * w, PATCH_LANES)
    # row of pixel (y, x): lane (dy*10+dx) = image[y-4+dy, x-4+dx]
    y, x = 17, 33
    row = np.asarray(t[y * w + x])
    win = np.asarray(image[y - 4:y + 6, x - 4:x + 6]).reshape(-1)
    assert np.array_equal(row[:PATCH_WIN * PATCH_WIN], win)
    assert np.all(row[PATCH_WIN * PATCH_WIN:] == 0.0)
    # border rows zero-pad outside the image
    row0 = np.asarray(t[0])
    assert row0[0] == 0.0 and row0[4 * PATCH_WIN + 4] == image[0, 0]


def _conv_patch_table(image):
    """The earlier build: two one-hot convolutions at full precision."""
    h, w = image.shape
    lo, hi, n = 4, PATCH_WIN - 5, PATCH_WIN * PATCH_WIN
    kv = np.zeros((PATCH_WIN, 1, 1, PATCH_WIN))
    kv[np.arange(PATCH_WIN), 0, 0, np.arange(PATCH_WIN)] = 1.0
    ov = jax.lax.conv_general_dilated(
        image[None, :, :, None], jnp.asarray(kv, image.dtype), (1, 1),
        [(lo, hi), (0, 0)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    kh = np.zeros((1, PATCH_WIN, PATCH_WIN, n))
    for ky in range(PATCH_WIN):
        for kx in range(PATCH_WIN):
            kh[0, kx, ky, ky * PATCH_WIN + kx] = 1.0
    out = jax.lax.conv_general_dilated(
        ov, jnp.asarray(kh, image.dtype), (1, 1), [(0, 0), (lo, hi)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    return jnp.pad(out[0].reshape(h * w, n), ((0, 0), (0, PATCH_LANES - n)))


@pytest.mark.parametrize("shape", [(60, 80), (7, 5), (33, 48)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_table_equals_conv_build(shape, dtype):
    img = jnp.asarray(np.random.default_rng(1).uniform(0, 255, shape), dtype)
    got = pack_patch_table(img)
    assert got.dtype == dtype
    assert np.array_equal(np.asarray(got), np.asarray(_conv_patch_table(img)))


def test_matches_pixel_map_sampling(image):
    h, w = image.shape
    rng = np.random.default_rng(5)
    pm = build_pixel_map(image)
    table = pack_patch_table(image)

    centers = jnp.asarray(rng.uniform(8, [w - 9, h - 9], (200, 2)), jnp.float64)
    uv = shift_pattern(centers)                     # [200, P, 2]
    # subpixel scatter of each pattern point (mimics exact reprojection)
    uv = uv + jnp.asarray(rng.uniform(-0.49, 0.49, uv.shape), jnp.float64)

    ref, ref_inside = sample(pm, uv)                # [200, P, 3]
    vals, gx, gy, inside = sample_pattern_patch(
        table, uv, uv[..., PATTERN_CENTER, :], h, w)

    assert bool(jnp.all(inside))
    np.testing.assert_allclose(np.asarray(vals), np.asarray(ref[..., 0]),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(gx), np.asarray(ref[..., 1]),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(gy), np.asarray(ref[..., 2]),
                               rtol=0, atol=1e-9)


def test_escaped_points_masked(image):
    h, w = image.shape
    table = pack_patch_table(image)
    center = jnp.asarray([[40.0, 30.0]], jnp.float64)
    # one point far from its group center → in-window test fails
    uv = jnp.asarray([[[40.0, 30.0], [52.0, 30.0]]], jnp.float64)
    _, _, _, inside = sample_pattern_patch(table, uv, center, h, w)
    got = np.asarray(inside[0])
    assert got[0] and not got[1]


def test_out_of_image_masked(image):
    h, w = image.shape
    table = pack_patch_table(image)
    center = jnp.asarray([[-5.0, 30.0]], jnp.float64)
    uv = jnp.asarray([[[-5.0, 30.0]]], jnp.float64)
    _, _, _, inside = sample_pattern_patch(table, uv, center, h, w)
    assert not bool(inside[0, 0])


def test_jit_vmap(image):
    h, w = image.shape
    table = pack_patch_table(image)
    uv = shift_pattern(jnp.asarray([[30.0, 25.0], [50.0, 40.0]], jnp.float64))

    f = jax.jit(lambda t, u: sample_pattern_patch(t, u, u[..., 4, :], h, w))
    vals, gx, gy, inside = f(table, uv)
    assert vals.shape == (2, 8) and bool(jnp.all(inside))
    vm = jax.vmap(lambda u: sample_pattern_patch(table, u, u[4], h, w))(uv)
    np.testing.assert_array_equal(np.asarray(vm[0]), np.asarray(vals))
