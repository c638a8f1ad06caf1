"""Distinct-feature extraction + matching for the FBS bootstrap.

JAX analog of the reference distinct-features stack
(reference: src/feature_based_slam/features/src/
distinct_features_extractor_orb.cpp — ORB keypoints + descriptors;
correspondences_finder.hpp — the matching API the initializer consumes).
Detection/matching runs on host (OpenCV), like the reference; only the
geometric estimation downstream is JAX.

Two correspondence engines exist, selected by ``InitializerOptions.matcher``:

* ``"lk"`` — pyramidal Lucas-Kanade chaining from the previous frame
  (reference optical_flow.cpp).  Fast, but a feature lost once is lost
  forever and large baselines break the chain.
* ``"orb"`` — per-frame ORB re-detection matched against the FIRST frame's
  descriptors (Hamming distance, Lowe ratio + cross-check).  Survives
  large frame gaps and full re-detections per keyframe, like the
  reference's distinct-features path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class DistinctFeaturesFrame:
    """Keypoints + descriptors of one frame."""

    points: np.ndarray        # [N, 2] pixel positions
    descriptors: np.ndarray   # [N, 32] uint8 ORB descriptors


class OrbExtractor:
    """ORB keypoint/descriptor extractor (distinct_features_extractor_orb)."""

    def __init__(self, num_features: int = 1000):
        import cv2

        self._orb = cv2.ORB_create(nfeatures=num_features)

    def extract(self, image) -> DistinctFeaturesFrame:
        import cv2

        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        kps, desc = self._orb.detectAndCompute(img, None)
        if desc is None or len(kps) == 0:
            return DistinctFeaturesFrame(np.zeros((0, 2), np.float32),
                                         np.zeros((0, 32), np.uint8))
        pts = np.asarray([kp.pt for kp in kps], np.float32)
        return DistinctFeaturesFrame(pts, np.asarray(desc, np.uint8))


def match_descriptors(ref: DistinctFeaturesFrame,
                      tgt: DistinctFeaturesFrame,
                      ratio: float = 0.8) -> np.ndarray:
    """Hamming kNN match with Lowe ratio + cross-check.

    Returns ``tgt_points_for_ref`` [N_ref, 2] — the matched target position
    of every reference keypoint, NaN where unmatched (the correspondences
    layout the initializer's point table uses).
    """
    import cv2

    out = np.full((len(ref.points), 2), np.nan, np.float32)
    if len(ref.points) == 0 or len(tgt.points) == 0:
        return out
    matcher = cv2.BFMatcher(cv2.NORM_HAMMING)
    fwd = matcher.knnMatch(ref.descriptors, tgt.descriptors, k=2)
    bwd = matcher.match(tgt.descriptors, ref.descriptors)
    back = {m.queryIdx: m.trainIdx for m in bwd}
    for cand in fwd:
        if len(cand) == 0:
            continue
        best = cand[0]
        if len(cand) > 1 and best.distance >= ratio * cand[1].distance:
            continue
        if back.get(best.trainIdx, -1) != best.queryIdx:
            continue
        out[best.queryIdx] = tgt.points[best.trainIdx]
    return out
