"""Monocular direct tracker: the per-frame ``tick`` orchestration.

JAX analog of the reference ``MonocularTracker``
(reference: src/tracker/tracker/src/monocular_tracker.cpp:425-530 tick,
:105-174 flow statistic + initialization poses, :176-250 estimatePose with
re-tracking).  Flow per frame:

1. build the photometric pyramid (device);
2. frontend pose alignment against the last keyframe's semi-dense depth
   map — the reference's sequential multi-initialization retry loop is a
   batched hypothesis axis (const motion, double, half, zero, zero-from-kf,
   + rotation perturbations), gated by the 2.5× energy-ratio test;
3. epipolar depth update of every active keyframe's immature bank (vmapped
   over the window slot axis);
4. optical-flow statistics → keyframe decision;
5. non-keyframe: attach to the last keyframe.  Keyframe: push into the PBA
   window, activate immature landmarks, windowed solve, marginalization
   policy + fold, rebuild the frontend depth maps.

Host code only takes decisions from scalar summaries; all per-pixel and
per-landmark work is jitted.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from dsopp_tpu.core.interpolate import sample
from dsopp_tpu.core.lie import SE3
from dsopp_tpu.core.pattern import shift_pattern
from dsopp_tpu.features.extractor import select_candidates
from dsopp_tpu.features.pyramid import build_pyramid_maps
from dsopp_tpu.solvers.pba import (
    PBAOptions,
    Window,
    empty_window,
    marginalize as pba_marginalize,
    push_frame,
    solve_window,
)
from dsopp_tpu.solvers.pose_alignment import AlignmentOptions, align_pyramid
from dsopp_tpu.track.state import AttachedFrame, MarginalizedKeyframe, OdometryTrack
from dsopp_tpu.tracker.activation import LandmarksActivator
from dsopp_tpu.tracker.depth_estimation import (
    ImmaturePoints,
    estimate_depths,
    make_immature_points,
)
from dsopp_tpu.tracker.depth_map import (
    build_frontend_state,
    mean_square_flows,
)
from dsopp_tpu.tracker.keyframe_strategy import OpticalFlowKeyframeStrategy
from dsopp_tpu.tracker.marginalization import SparseMarginalizationStrategy

ENERGY_RATIO_THRESHOLD = 2.5  # re-track gate (monocular_tracker.cpp:185)


# Coarse jit wrappers: every eager op is its own dispatch, so each tick
# phase is a single device program.
@partial(jax.jit, static_argnames=("num_levels",))
def _jit_pyramid_maps(image, num_levels):
    return build_pyramid_maps(image, num_levels)


@partial(jax.jit, static_argnames=("num_points",))
def _jit_immature_inputs(pixel_map, num_points, mask):
    cands = select_candidates(pixel_map, num_points, mask=mask)
    patches, _ = sample(pixel_map, shift_pattern(cands.uv))
    grads, _ = sample(pixel_map, cands.uv)
    return cands, patches[..., 0], grads[..., 1:]


@partial(jax.jit, static_argnames=("with_perturbations",))
def _jit_hypotheses(last_q, last_t, prev_q, prev_t, kf_q, kf_t,
                    with_perturbations):
    t_w_last = SE3(last_q, last_t)
    t_prev_rel = SE3(prev_q, prev_t)
    t_w_kf = SE3(kf_q, kf_t)
    hyps = _initialization_hypotheses(
        t_w_last, t_prev_rel, t_w_kf, with_perturbations, last_q.dtype)
    kf_b = SE3(jnp.broadcast_to(kf_q, hyps.q.shape),
               jnp.broadcast_to(kf_t, hyps.t.shape))
    t_t_kf = hyps.inverse().compose(kf_b)
    return t_t_kf


@dataclass
class TrackerConfig:
    num_frame_slots: int = 8
    landmarks_per_frame: int = 300
    immature_per_frame: int = 500
    desired_points: int = 2000
    pyramid_levels: int = 5
    frontend_points: int = 2000      # semi-dense points per level for alignment
    keyframe_factor: float = 1.0
    window_min: int = 5
    window_max: int = 7
    max_marginalized_fraction: float = 0.95
    huber_sigma: float = 20.0
    use_rotation_perturbations: bool = True
    estimate_uncertainty: bool = False   # pose-pose covariance per solve
    refine_activation: bool = True       # idepth GN on activation (REFINE)
    # frame embedder (YAML frame_embedder:, reference camera_fabric.cpp:41-50):
    # C>1 channels feed the PBA window; frontend alignment and the epipolar
    # tracer stay C=1 exactly like the reference (monocular_tracker.hpp:58-60,
    # monocular_tracker.cpp:470 estimateDepths<..., Grid2D, 1>)
    embedder: str = "identity"
    # solver overrides (reference fabric.cpp readAffineBrightnessRegularizers
    # + max_iterations keys; the 1e12/1e8 defaults freeze (a, b) — relax via
    # YAML for uncalibrated/exposure-varying footage)
    pba_max_iterations: int = 7
    pba_affine_reg: tuple = (1e12, 1e8)
    align_affine_reg: tuple = (1e12, 1e8)


def _initialization_hypotheses(t_w_last: SE3, t_prev_rel: SE3, t_w_kf: SE3,
                               with_perturbations: bool, dtype):
    """Batched initial poses T_w_t (initializationPoses, :137-171)."""
    cands = [
        t_w_last @ t_prev_rel,                                # const motion
        t_w_last @ t_prev_rel @ t_prev_rel,                   # double
        t_w_last @ SE3.exp(0.5 * t_prev_rel.log()),           # half
        t_w_last,                                             # zero
        t_w_kf,                                               # zero from kf
    ]
    if with_perturbations:
        base = cands[0]
        deg = math.pi / 180.0
        for delta in (1.0 * deg, 1.5 * deg, 2.0 * deg, 2.5 * deg):
            for dx in (0.0, delta, -delta):
                for dy in (0.0, delta, -delta):
                    for dz in (0.0, delta, -delta):
                        if dx == dy == dz == 0.0:
                            continue
                        xi = jnp.asarray([0, 0, 0, dx, dy, dz], dtype)
                        cands.append(base @ SE3.exp(xi))
    return SE3(jnp.stack([c.q for c in cands]), jnp.stack([c.t for c in cands]))


_estimate_depths_banked = jax.vmap(
    estimate_depths,
    in_axes=(0, None, None, 0, 0, None, 0, None, None),
)


class MonocularTracker:
    """Direct sparse odometry over one camera stream."""

    def __init__(self, camera, config: TrackerConfig = TrackerConfig(),
                 dtype=jnp.float32, image_shape=None, mask=None):
        self.camera = camera
        self.config = config
        self.dtype = dtype
        h = int(np.asarray(camera.image_size)[1])
        w = int(np.asarray(camera.image_size)[0])
        self.image_shape = (h, w) if image_shape is None else image_shape
        # candidate-selection validity mask (reference CameraMask,
        # camera_mask.hpp:21-117); all-valid when the sensor supplies none
        self.base_mask = (jnp.ones(self.image_shape, bool) if mask is None
                          else jnp.asarray(mask, bool))
        self.mask = self.base_mask
        self.semantic_filter: tuple = ()   # class ids masked out per frame
        self._last_semantics = None        # newest frame's class-id image
        self._kf_semantics = {}            # keyframe id → class-id image
        # cast the camera to the tracker dtype: an f64 (oracle) model fed to
        # an f32 tracker would otherwise promote every downstream op under
        # x64 (array fields only — static fields like Atan.poly stay tuples)
        camera = type(camera)(*[
            jnp.asarray(f, dtype)
            if hasattr(f, "dtype") and jnp.issubdtype(f.dtype, jnp.floating)
            else f
            for f in camera])
        self.camera = camera
        self.models = [camera.scaled(float(2 ** l)) for l in range(config.pyramid_levels)]

        from dsopp_tpu.features.embedder import make_embedder

        self.embedder = make_embedder(config.embedder)
        self.window: Window = empty_window(
            config.num_frame_slots, config.landmarks_per_frame,
            (3,) + self.image_shape, dtype=dtype,
            channels=self.embedder.channels)
        self.immature: Optional[ImmaturePoints] = None  # [K] bank
        self.track = OdometryTrack()

        self.keyframe_strategy = OpticalFlowKeyframeStrategy(config.keyframe_factor)
        self.marg_strategy = SparseMarginalizationStrategy(
            config.window_min, config.window_max, config.max_marginalized_fraction)
        self.activator = LandmarksActivator(
            config.desired_points, refine=config.refine_activation,
            huber_sigma=config.huber_sigma)
        c = self.embedder.channels
        self.pba_opts = PBAOptions(
            huber_sigma=config.huber_sigma,
            max_iterations=config.pba_max_iterations,
            affine_reg_a=float(config.pba_affine_reg[0]) * c,
            affine_reg_b=float(config.pba_affine_reg[1]) * c)
        self.align_opts = AlignmentOptions(
            huber_sigma=config.huber_sigma,
            affine_reg_a=float(config.align_affine_reg[0]),
            affine_reg_b=float(config.align_affine_reg[1]))

        # frontend state
        self.level_points = None       # list[LevelPoints] from last keyframe
        self.depth_maps = None         # ((idepth,...), (weight,...))
        self.flow_points = None        # compact [FLOW_CAP] flow set
        self.rmse_last = [1e8] * config.pyramid_levels
        self.t_w_last: Optional[SE3] = None
        self.t_prev_rel = SE3.identity((), dtype)
        self.last_affine = jnp.zeros(2, dtype)
        self.num_keyframes = 0

    # ------------------------------------------------------------------
    def is_initialized(self) -> bool:
        return self.num_keyframes >= 2

    def _kf_pose(self) -> SE3:
        # cached: only changes when a keyframe is pushed/solved
        cached = getattr(self, "_kf_pose_cache", None)
        if cached is None:
            pos = self.window.frame_count() - 1
            poses = self.window.poses()
            cached = SE3(poses.q[pos], poses.t[pos])
            self._kf_pose_cache = cached
        return cached

    def _kf_id(self) -> int:
        # host-cached: ids are known at push time; reading window.frame_id
        # back would cost a device→host transfer per frame
        cached = getattr(self, "_kf_id_cache", None)
        if cached is None:
            pos = self.window.frame_count() - 1
            cached = int(np.asarray(self.window.frame_id)[pos])
            self._kf_id_cache = cached
        return cached

    # ------------------------------------------------------------------
    def tick(self, frame_id: int, timestamp: float, image,
             known_pose: Optional[SE3] = None, force_keyframe: bool = False,
             semantics=None, exposure: float = 1.0):
        """Process one frame.  ``known_pose``: precalculated T_w_c (the
        reference's PrecalculatedPoseAlignment path, used by the
        initializer).  ``semantics``: optional [H, W] class-id image —
        filtered classes are masked out of candidate selection and class
        ids are attached to landmarks on marginalization.  ``exposure``:
        the provider's exposure time (brightness model ratio; reference
        CameraDataFrame exposure → every solver)."""
        self._cur_exposure = float(exposure)
        if semantics is not None:
            self._last_semantics = np.asarray(semantics)
            if self.semantic_filter:
                from dsopp_tpu.sensors.masks import filter_semantic_objects

                self.mask = filter_semantic_objects(
                    self.base_mask, jnp.asarray(self._last_semantics),
                    self.semantic_filter)
        image = jnp.asarray(image, self.dtype)
        maps = _jit_pyramid_maps(image, self.config.pyramid_levels)

        if self.window.frame_count() == 0:
            pose = known_pose if known_pose is not None else SE3.identity((), self.dtype)
            self._push_keyframe(frame_id, timestamp, pose, maps, first=True)
            self.t_w_last = pose
            return {"keyframe": True, "pose": pose, "bootstrap": True}

        # ---- frontend pose estimation --------------------------------
        reliable = True
        if known_pose is not None:
            t_w_t = known_pose
            rmse0 = 0.0
            t_w_kf = self._kf_pose()
            t_t_kf = t_w_t.inverse() @ t_w_kf   # new ← keyframe
            self._estimate_depths(maps[0], t_w_t)
            flow, flow_no_rot = self._flow_stats(t_t_kf)
        else:
            t_w_t, t_t_kf, rmse0, reliable, flow, flow_no_rot, maps = (
                self._fused_estimate(image))
            t_w_kf = self._kf_pose()
        need_kf = force_keyframe or self.keyframe_strategy.need_new_keyframe(
            flow, flow_no_rot, rmse0, reliable=reliable)

        self.t_prev_rel = (
            self.t_w_last.inverse() @ t_w_t if self.t_w_last is not None
            else SE3.identity((), self.dtype))
        self.t_w_last = t_w_t

        if not need_kf:
            t_kf_t_mat = (self._last_kf_frame_mat if known_pose is None else
                          np.asarray((t_w_kf.inverse() @ t_w_t).matrix(),
                                     np.float64))
            self.track.attach_frame(AttachedFrame(
                frame_id, timestamp, self._kf_id(), t_kf_t_mat,
                flow=flow, flow_without_rotation=flow_no_rot, rmse=rmse0))
            return {"keyframe": False, "pose": t_w_t, "rmse": rmse0}

        # ---- keyframe path -------------------------------------------
        stats = self._push_keyframe(frame_id, timestamp, t_w_t, maps)
        return {"keyframe": True, "pose": self._kf_pose(), "rmse": rmse0, **stats}

    # ------------------------------------------------------------------
    def _estimate_pose(self, maps):
        t_w_kf = self._kf_pose()
        t_t_kf_hyps = _jit_hypotheses(
            self.t_w_last.q, self.t_w_last.t,
            self.t_prev_rel.q, self.t_prev_rel.t,
            t_w_kf.q, t_w_kf.t,
            self.config.use_rotation_perturbations)

        res = align_pyramid(
            self.level_points, maps, self.models, t_t_kf_hyps,
            jnp.broadcast_to(self.last_affine, t_t_kf_hyps.q.shape[:1] + (2,)),
            self.last_affine, 1.0, self.align_opts)

        rmse = float(res.rmse)
        reliable = rmse < ENERGY_RATIO_THRESHOLD * self.rmse_last[0] and int(res.num_valid) > 0
        if reliable:
            self.rmse_last[0] = rmse
        else:
            self.rmse_last[0] *= ENERGY_RATIO_THRESHOLD
        t_w_t = self._kf_pose() @ res.t_t_r.inverse()
        self.last_affine = res.affine
        return t_w_t, rmse, reliable

    def _fused_estimate(self, image):
        """One-device-program regular tick (pose + depths + flow)."""
        from dsopp_tpu.tracker.fused_tick import fused_regular_tick

        poses = self.window.poses()
        kf_slot = jnp.asarray(self.window.frame_count() - 1, jnp.int32)
        idep0, wei0 = self.depth_maps[0][0], self.depth_maps[1][0]
        out = fused_regular_tick(
            image, tuple(self.level_points), self.flow_points,
            poses.q, poses.t, self.window.affine(), self.window.exposure,
            jnp.asarray(getattr(self, "_cur_exposure", 1.0), self.dtype),
            kf_slot,
            self.immature,
            self.t_w_last.q, self.t_w_last.t,
            self.t_prev_rel.q, self.t_prev_rel.t,
            self.last_affine, tuple(self.models),
            self.align_opts, self.config.use_rotation_perturbations,
            self.config.pyramid_levels, self.config.huber_sigma,
            rmse_last0=jnp.asarray(self.rmse_last[0], self.dtype))

        # single batched readback of the scalar summaries + attach matrix
        rmse, num_valid, flow, flow_nr, t_kf_frame_mat = jax.device_get(
            (out.rmse, out.num_valid, out.flow, out.flow_no_rot,
             out.t_kf_frame_mat))
        rmse = float(rmse)
        reliable = (rmse < ENERGY_RATIO_THRESHOLD * self.rmse_last[0]
                    and int(num_valid) > 0)
        if reliable:
            self.rmse_last[0] = rmse
        else:
            self.rmse_last[0] *= ENERGY_RATIO_THRESHOLD
        self.last_affine = out.affine
        self.immature = out.immature
        self._last_kf_frame_mat = np.asarray(t_kf_frame_mat, np.float64)
        t_w_t = SE3(out.pose_q, out.pose_t)
        t_t_kf = SE3(out.t_t_kf_q, out.t_t_kf_t)
        return (t_w_t, t_t_kf, rmse, reliable, float(flow), float(flow_nr),
                out.maps)

    def _estimate_depths(self, target_map, t_w_t: SE3):
        if self.immature is None:
            return
        poses = self.window.poses()
        k = self.window.num_slots
        t_inv = t_w_t.inverse()
        t_rel = SE3(
            jnp.broadcast_to(t_inv.q, (k, 4)),
            jnp.broadcast_to(t_inv.t, (k, 3))).compose(poses)
        affines = self.window.affine()
        ratios = (jnp.asarray(getattr(self, "_cur_exposure", 1.0), self.dtype)
                  / jnp.maximum(self.window.exposure, 1e-12))
        self.immature = _estimate_depths_banked(
            self.immature, target_map, self.camera, t_rel,
            affines, self.last_affine, ratios,
            self.config.huber_sigma, 32)

    def _flow_stats(self, t_t_kf: SE3):
        if self.flow_points is None:
            return 0.0, 0.0
        flow, flow_nr = mean_square_flows(self.flow_points, self.camera, t_t_kf)
        return float(flow), float(flow_nr)

    # ------------------------------------------------------------------
    def _make_immature_bank(self, maps):
        cands, patches, grads = _jit_immature_inputs(
            maps[0], self.config.immature_per_frame, self.mask)
        bank = make_immature_points(cands.uv, patches, grads, dtype=self.dtype)
        return bank._replace(valid=bank.valid & cands.valid)

    def _push_keyframe(self, frame_id, timestamp, pose: SE3, maps, first=False):
        cfg = self.config
        pose = SE3(jnp.asarray(pose.q, self.dtype), jnp.asarray(pose.t, self.dtype))

        self.track.on_keyframe(frame_id, timestamp)
        self.num_keyframes += 1
        self._kf_id_cache = frame_id
        self._kf_pose_cache = None
        if self._last_semantics is not None:
            self._kf_semantics[frame_id] = self._last_semantics
        stats = {}

        if first:
            embed = (None if self.embedder.channels == 1
                     else self.embedder(maps[0][0]))
            self.window = push_frame(
                self.window, pose, maps[0], frame_id=frame_id, fixed=True,
                affine=(0.0, 0.0),
                exposure=getattr(self, "_cur_exposure", 1.0),
                embed_channels=embed)
            new_bank = self._make_immature_bank(maps)
            if self.immature is None:
                self.immature = jax.tree_util.tree_map(
                    lambda x: jnp.zeros((cfg.num_frame_slots,) + x.shape,
                                        x.dtype), new_bank)
            slot = self.window.frame_count() - 1
            self.immature = jax.tree_util.tree_map(
                lambda bank, new: bank.at[slot].set(new),
                self.immature, new_bank)
        else:
            # push + immature bank + activation + solve + readback bundle
            # fused into one device program (one dispatch, one transfer)
            from dsopp_tpu.tracker.fused_keyframe import fused_keyframe_push

            prev_count = self.window.frame_count()
            if prev_count >= cfg.num_frame_slots:
                raise ValueError("window full — marginalize before pushing")
            out = fused_keyframe_push(
                self.window, self.camera, self.immature, maps[0],
                pose.q, pose.t, jnp.asarray(self.last_affine, self.dtype),
                jnp.asarray(frame_id, jnp.int32),
                jnp.asarray(self.activator.min_distance_to_neighbor,
                            self.dtype),
                self.pba_opts, self.activator.refine,
                self.config.huber_sigma, cfg.immature_per_frame,
                mask=self.mask,
                exposure=jnp.asarray(getattr(self, "_cur_exposure", 1.0),
                                     self.dtype),
                embed=(None if self.embedder.channels == 1
                       else self.embedder(maps[0][0])))
            self.window, self.immature, batch = (
                out.window, out.immature, dict(out.batch))
            object.__setattr__(self.window, "_frame_count_cache",
                               prev_count + 1)
            if cfg.estimate_uncertainty:
                from dsopp_tpu.solvers.pba import pose_covariances

                _, batch["cov_rel"] = pose_covariances(
                    self.window, self.camera, self.pba_opts)
            host = jax.device_get(batch)
            self.last_affine = jnp.asarray(host["new_affine"], self.dtype)
            host["poses_t"] = host["poses_mat"][:, :3, 3]

            self.activator.note_active_count(int(host["n_active"]))
            stats = {
                "energy": float(host["energy"]),
                "num_valid": int(host["num_valid"]),
                "activated": int(host["n_activated"]),
                "active": int(host["n_active"]),
                "min_distance": self.activator.min_distance_to_neighbor,
            }

            if cfg.estimate_uncertainty:
                cov_rel = np.asarray(host["cov_rel"], np.float64)
                ids = host["frame_id"]
                for i in np.where(host["frame_valid"])[0]:
                    for j in np.where(host["frame_valid"])[0]:
                        if i != j:
                            self.track.connections[
                                (int(ids[i]), int(ids[j]))] = cov_rel[i, j]

            frame_flags, lm_flags, new_outliers = self.marg_strategy.flags(
                self.window, host["imm_counts"], host=host)
            self.window = dataclasses.replace(
                self.window,
                lm_outlier=self.window.lm_outlier | jnp.asarray(new_outliers),
            )
            if frame_flags.any() or lm_flags.any():
                self._snapshot_marginalized(host, frame_flags, timestamp)
                self.window = dataclasses.replace(
                    self.window,
                    frame_marg=jnp.asarray(frame_flags),
                    lm_marg_flag=jnp.asarray(lm_flags),
                )
                self.window = pba_marginalize(
                    self.window, self.camera, self.pba_opts,
                    frame_flags=np.asarray(frame_flags),
                    lm_any=bool(np.asarray(lm_flags).any()))
                self._permute_immature(host["frame_valid"], frame_flags)

        self._kf_pose_cache = None
        # rebuild frontend reference depth maps + per-level points (fused:
        # one device program instead of 1 + num_levels dispatches)
        h, w = self.image_shape
        idep, wei, points, flow_pts = build_frontend_state(
            self.window, self.camera, tuple(maps), h, w,
            cfg.pyramid_levels, cfg.frontend_points)
        self.depth_maps = (idep, wei)
        self.level_points = list(points)
        self.flow_points = flow_pts
        return stats

    def _snapshot_marginalized(self, host, frame_flags, timestamp):
        """Record dropped keyframes from the batched host snapshot (no
        additional device readbacks)."""
        from dsopp_tpu.track.state import sample_semantics

        ids = host["frame_id"]
        for pos in np.where(frame_flags)[0]:
            fid = int(ids[pos])
            sem_img = self._kf_semantics.pop(fid, None)
            self.track.on_marginalize(MarginalizedKeyframe(
                frame_id=fid,
                timestamp=self.track.keyframe_timestamps.get(fid, timestamp),
                t_wc=np.asarray(host["poses_mat"][pos], np.float64),
                affine=np.asarray(host["affine"][pos], np.float64),
                exposure=float(host["exposure"][pos]),
                lm_uv=host["lm_uv"][pos],
                lm_idepth=host["lm_idepth"][pos],
                lm_valid=host["lm_valid"][pos],
                lm_outlier=host["lm_outlier"][pos],
                lm_baseline=host["lm_baseline"][pos],
                lm_semantic=(None if sem_img is None else
                             sample_semantics(sem_img, host["lm_uv"][pos])),
            ))

    def _permute_immature(self, frame_valid, frame_flags):
        """Reorder immature banks to match the compacted window slots (same
        kept-first permutation the marginalizer applies)."""
        k = self.window.num_slots
        kept = np.where(~np.asarray(frame_flags) & np.asarray(frame_valid))[0]
        dead = [i for i in range(k) if i not in kept]
        perm = jnp.asarray(np.concatenate([kept, dead]).astype(np.int32))
        self.immature = jax.tree_util.tree_map(lambda x: x[perm], self.immature)
        dead_mask = np.zeros(k, bool)
        dead_mask[len(kept):] = True
        self.immature = self.immature._replace(
            valid=self.immature.valid & ~jnp.asarray(dead_mask)[:, None])

    # ------------------------------------------------------------------
    def initialize(self, frames):
        """Bootstrap from externally provided poses (the reference's
        precalculated initializer path: replay frames with known poses,
        forcing the last one to become a keyframe)."""
        for i, (frame_id, timestamp, image, pose) in enumerate(frames):
            last = i == len(frames) - 1
            self.tick(frame_id, timestamp, image, known_pose=pose,
                      force_keyframe=last)
