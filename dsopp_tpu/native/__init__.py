"""Native (C++) host-side kernels with Python ctypes bindings.

The reference's performance-critical CPU kernels (AVX2 gradient maps,
pyramid downscale, photometric LUT — calculate_pixelinfo.cpp,
downscale_image.hpp) have native equivalents here for the HOST data path:
while the device computes on frame t, the CPU prepares frame t+1.  The shared
library is rebuilt from source on import if missing (g++ -O3 -march=native);
all entry points have pure-NumPy fallbacks so the package works without a
toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libpixelmap.so")
_SRC = os.path.join(_DIR, "pixelmap.cpp")

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO) and os.path.exists(_SRC):
        try:
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-o", _SO, _SRC],
                check=True, capture_output=True)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.photometric_correct.argtypes = [f32p, f32p, f32p, f32p, ctypes.c_int64]
    lib.downscale2.argtypes = [f32p, ctypes.c_int, ctypes.c_int, f32p]
    lib.pixel_map.argtypes = [f32p, ctypes.c_int, ctypes.c_int, f32p]
    lib.pyramid_pixel_maps.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(f32p), f32p, f32p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def photometric_correct(image, lut256, vignette=None):
    """Host photometric correction → float32 [H, W]."""
    lib = _load()
    img = np.ascontiguousarray(image, np.float32)
    lut = np.ascontiguousarray(lut256, np.float32)
    out = np.empty_like(img)
    if lib is None:
        idx = np.clip(img, 0, 255)
        lo = np.floor(idx).astype(np.int32)
        hi = np.minimum(lo + 1, 255)
        frac = idx - lo
        out = lut[lo] * (1 - frac) + lut[hi] * frac
        if vignette is not None:
            out = out / np.maximum(vignette, 1e-3)
        return out.astype(np.float32)
    vig = (np.ascontiguousarray(vignette, np.float32)
           if vignette is not None else None)
    lib.photometric_correct(
        _ptr(img), _ptr(lut),
        _ptr(vig) if vig is not None else None, _ptr(out), img.size)
    return out


def pixel_map(image):
    """[H, W] float32 → [3, H, W] (intensity, dx, dy) pixel map."""
    lib = _load()
    img = np.ascontiguousarray(image, np.float32)
    h, w = img.shape
    if lib is None:
        from dsopp_tpu.core.interpolate import build_pixel_map
        import jax.numpy as jnp

        return np.asarray(build_pixel_map(jnp.asarray(img)))
    out = np.empty((3, h, w), np.float32)
    lib.pixel_map(_ptr(img), h, w, _ptr(out))
    return out


def pyramid_pixel_maps(image, levels: int):
    """[H, W] float32 → list of [3, h_l, w_l] pixel maps (native one-call)."""
    lib = _load()
    img = np.ascontiguousarray(image, np.float32)
    h, w = img.shape
    if lib is None:
        from dsopp_tpu.features.pyramid import build_pyramid_maps
        import jax.numpy as jnp

        return [np.asarray(m) for m in build_pyramid_maps(jnp.asarray(img), levels)]
    outs = []
    ch, cw = h, w
    for _ in range(levels):
        outs.append(np.empty((3, ch, cw), np.float32))
        ch //= 2
        cw //= 2
    arr = (ctypes.POINTER(ctypes.c_float) * levels)(*[_ptr(o) for o in outs])
    scratch_a = np.empty(h * w // 4 + 1, np.float32)
    scratch_b = np.empty(h * w // 16 + 1, np.float32)
    lib.pyramid_pixel_maps(_ptr(img), h, w, levels, arr,
                           _ptr(scratch_a), _ptr(scratch_b))
    return outs
