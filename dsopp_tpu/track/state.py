"""Live odometry-track state.

JAX analog of the reference track layer
(reference: src/track/ — ActiveOdometryTrack with an active window +
marginalized frames, ActiveKeyframe with attached non-key frames,
unloadMarginalizedResources).  Here the ACTIVE window lives in the PBA
``Window`` (single source of truth — no updateFrame/updateLocalFrame sync);
this module keeps the host-side history: marginalized keyframes with their
final landmark snapshots, and attached (non-key) frames for the full-rate
trajectory.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from dsopp_tpu.core.lie import SE3


@dataclass
class AttachedFrame:
    """Non-keyframe tracked against its reference keyframe."""

    frame_id: int
    timestamp: float
    keyframe_id: int
    t_keyframe_frame: np.ndarray  # 4x4 relative pose (kf → frame)
    exposure: float = 1.0
    affine: np.ndarray = field(default_factory=lambda: np.zeros(2))
    flow: float = 0.0
    flow_without_rotation: float = 0.0
    rmse: float = 0.0


@dataclass
class MarginalizedKeyframe:
    """Keyframe dropped from the active window (final state snapshot)."""

    frame_id: int
    timestamp: float
    t_wc: np.ndarray              # 4x4 camera-to-world
    affine: np.ndarray
    exposure: float
    lm_uv: np.ndarray             # [M, 2]
    lm_idepth: np.ndarray         # [M]
    lm_valid: np.ndarray          # [M] bool (active at marginalization)
    lm_outlier: np.ndarray        # [M] bool
    lm_baseline: np.ndarray       # [M]
    attached: List[AttachedFrame] = field(default_factory=list)
    # per-landmark semantic class id, attached at marginalization time
    # (reference monocular_tracker.cpp:263-305 addSemanticObservations;
    # here sampled from the host keyframe's class-id image — one
    # observation instead of the reference's per-frame vote history)
    lm_semantic: Optional[np.ndarray] = None  # [M] int


def sample_semantics(semantic_image, uv):
    """Nearest-pixel class ids at ``uv`` [M, 2] from a [H, W] id image."""
    sem = np.asarray(semantic_image)
    h, w = sem.shape
    u = np.clip(np.rint(np.asarray(uv)[:, 0]).astype(int), 0, w - 1)
    v = np.clip(np.rint(np.asarray(uv)[:, 1]).astype(int), 0, h - 1)
    return sem[v, u].astype(np.int64)


@dataclass
class OdometryTrack:
    """Host-side track history + live keyframe bookkeeping."""

    marginalized: List[MarginalizedKeyframe] = field(default_factory=list)
    # attached frames of still-active keyframes, keyed by keyframe id
    attached: dict = field(default_factory=dict)
    keyframe_timestamps: dict = field(default_factory=dict)
    # relative-pose covariances keyed by (reference_id, target_id) → 6×6
    # (reference FrameConnection covariance, connection.proto field 5)
    connections: dict = field(default_factory=dict)
    # registered output observers (output/observers.py; reference
    # TrackOutputInterface set) — events fire from both the host loop and
    # the device-loop batched bookkeeping; excluded from checkpoints
    observers: List = field(default_factory=list)

    def attach_frame(self, frame: AttachedFrame):
        self.attached.setdefault(frame.keyframe_id, []).append(frame)

    def on_keyframe(self, frame_id: int, timestamp: float):
        self.keyframe_timestamps[frame_id] = timestamp
        for obs in self.observers:
            obs.on_keyframe(frame_id, timestamp)

    def on_marginalize(self, kf: MarginalizedKeyframe):
        kf.attached = self.attached.pop(kf.frame_id, [])
        self.marginalized.append(kf)
        for obs in self.observers:
            obs.on_marginalize(kf)

    def trajectory(self, window=None):
        """Full-rate (timestamp, T_wc 4x4) list: marginalized + active
        keyframes with their attached frames, time-ordered."""
        entries = []

        def add_keyframe(frame_id, timestamp, t_wc, attached):
            entries.append((timestamp, t_wc))
            for a in attached:
                entries.append((a.timestamp, t_wc @ a.t_keyframe_frame))

        for kf in self.marginalized:
            add_keyframe(kf.frame_id, kf.timestamp, kf.t_wc, kf.attached)
        if window is not None:
            import jax.numpy as jnp

            poses = window.poses()
            ids = np.asarray(window.frame_id)
            for pos in range(window.frame_count()):
                fid = int(ids[pos])
                t = np.asarray(SE3(poses.q[pos], poses.t[pos]).matrix())
                add_keyframe(
                    fid, self.keyframe_timestamps.get(fid, 0.0), t,
                    self.attached.get(fid, []))
        entries.sort(key=lambda e: e[0])
        return entries
