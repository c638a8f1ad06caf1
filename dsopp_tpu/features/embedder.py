"""Frame embedders: [H, W] intensity → [C, H, W] feature channels.

JAX analog of the reference frame-embedding extractor interface
(reference: src/features/include/features/camera/frame_embedding_extractor.hpp
— GN-Net-style learned embeddings, hidden behind an extractor; the shipped
pipeline uses the identity).  The embedded frame feeds
``core.interpolate.build_pixel_map`` which produces the ``[3C, H, W]``
value/gradient pixel map (pixel_map.hpp:17 ``template <int C>``), and the
direct-alignment residual runs per channel with whole-point Huber at σ·√C
(solvers/pose_alignment.py).

Embedders are pure jittable callables; a learned embedder is any function
(e.g. a Flax module's ``apply``) with the same signature.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


class IdentityEmbedder:
    """C=1: the raw photometric frame (the reference's default path)."""

    channels = 1

    def __call__(self, image):
        return image[None] if image.ndim == 2 else image


class FilterBankEmbedder:
    """Fixed linear filter bank: C channels via depthwise 3×3 convolution.

    A stand-in for learned GN-Net embeddings with the same contract.  The
    default bank is the identity plus two lightly-smoothed mixtures —
    channels whose gradient structure stays close to the intensity plane.
    Measured (r5): hand-crafted high-frequency banks (Scharr, box blur)
    genuinely DEGRADE the photometric BA on this content (0.04 → 0.11–0.18 m
    on the corridor suite; the C>1 machinery itself is exact — three
    identical channels track at C=1 parity), which is precisely why the
    reference's gn_net channels are learned, not hand-crafted.  Pass
    ``filters`` explicitly for a custom bank (e.g. Scharr for testing).
    """

    def __init__(self, filters=None):
        if filters is None:
            ident = jnp.zeros((3, 3)).at[1, 1].set(1.0)
            blur = jnp.ones((3, 3)) / 9.0
            filters = jnp.stack([ident,
                                 0.85 * ident + 0.15 * blur,
                                 0.7 * ident + 0.3 * blur])
        self.filters = jnp.asarray(filters)
        self.channels = int(self.filters.shape[0])

    def __call__(self, image):
        dtype = image.dtype
        x = image[None, None].astype(jnp.float32)      # [1, 1, H, W]
        k = self.filters[:, None].astype(jnp.float32)  # [C, 1, 3, 3]
        out = jax.lax.conv_general_dilated(
            x, k, (1, 1), "SAME",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            precision=jax.lax.Precision.HIGHEST)
        return out[0].astype(dtype)                    # [C, H, W]


def make_embedder(name: str = "identity", **kw):
    """Embedder registry (config fabric hook)."""
    if name == "identity":
        return IdentityEmbedder()
    if name == "filter_bank":
        return FilterBankEmbedder(**kw)
    raise ValueError(f"unknown embedder '{name}'")
