"""dsopp_tpu.ops — packed sampling layouts (the J6 hot path).

The scattered bilinear patch gather is the hardest op of the pipeline for
an accelerator (SURVEY §7 "hard parts"); this package holds packed layouts
of it, in plain JAX, each checked against ``core.interpolate.sample``:

* :mod:`dsopp_tpu.ops.sample` — the corner-packed row-gather layout: one
  gather row per sample point instead of 4 corners x C channels of scalar
  gathers.
* :mod:`dsopp_tpu.ops.nbhd` — the neighborhood-packed layout: ONE gather
  row per pattern group (8x fewer rows).
* :mod:`dsopp_tpu.ops.patch` — the 10×10-window patch table used by the
  BA residual pass and the epipolar sweep.

Reference analog: PixelMap::Evaluate / interpolateLinear
(src/features/include/features/camera/pixel_map.hpp:227-300).
"""

from dsopp_tpu.ops.nbhd import (
    pack_neighborhood,
    sample_nbhd,
)
from dsopp_tpu.ops.sample import (
    pack_corners,
    sample_packed,
    sample_packed_intensity,
)

__all__ = [
    "pack_corners",
    "pack_neighborhood",
    "sample_nbhd",
    "sample_packed",
    "sample_packed_intensity",
]
