"""Fully device-resident tracking loop: one program per frame, no readbacks.

The host loop in ``monocular.MonocularTracker.tick`` reads scalar summaries
back after every frame to take the keyframe decision, and runs the
marginalization policy on host — every such device→host transfer
synchronizes the host with the device and leaves the device idle until the
next dispatch.  This module moves the ENTIRE per-frame control flow on
device (reference flow: monocular_tracker.cpp:425-530):

* the keyframe decision (``MeanSquareOpticalFlowAndRmse`` strategy,
  mean_square_optical_flow_and_rmse_keyframe_strategy.cpp:28-43) and the
  frontend re-track energy ledger (monocular_tracker.cpp:185) become device
  scalars carried in :class:`DeviceTrackerState`;
* the keyframe path (push → activation → windowed BA → marginalization
  policy + fold → frontend depth-map rebuild) runs under ``lax.cond`` so
  regular frames never pay for it;
* the host enqueues ``device_tick`` calls back-to-back (dispatch is async)
  and fetches the per-frame diagnostics bundle in batches, purely for track
  bookkeeping/export — nothing on the host feeds back into the device loop.

The per-frame host round-trip is what caps pipeline throughput once the
kernels are fast.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dsopp_tpu.core.lie import SE3
from dsopp_tpu.solvers.pba import PBAOptions, Window, _marginalize_device
from dsopp_tpu.solvers.pose_alignment import AlignmentOptions
from dsopp_tpu.track.state import AttachedFrame, MarginalizedKeyframe
from dsopp_tpu.tracker.activation import (
    MAX_DISTANCE,
    MIN_DISTANCE,
    P_GAIN,
)
from dsopp_tpu.tracker.depth_map import build_frontend_state
from dsopp_tpu.tracker.fused_keyframe import fused_keyframe_push
from dsopp_tpu.tracker.fused_tick import fused_regular_tick
from dsopp_tpu.tracker.keyframe_strategy import OpticalFlowKeyframeStrategy
from dsopp_tpu.tracker.marginalization import flags_device, kept_first_perm
from dsopp_tpu.tracker.monocular import ENERGY_RATIO_THRESHOLD


class DeviceLoopConfig(NamedTuple):
    """Static (hashable) configuration of the device loop."""

    align_opts: AlignmentOptions
    pba_opts: PBAOptions
    num_levels: int
    with_perturbations: bool
    huber_sigma: float
    refine: bool
    embedder: str              # frame-embedder kind ("identity" = C=1)
    immature_per_frame: int
    frontend_points: int
    desired_points: float
    keyframe_factor: float
    window_min: int
    window_max: int
    max_marg_fraction: float
    height: int
    width: int


class DeviceTrackerState(NamedTuple):
    """Everything the per-frame loop needs, resident on device."""

    window: Window
    immature: object          # ImmaturePoints bank [K]
    depth_idepth: tuple       # per-level [H_l, W_l]
    depth_weight: tuple
    level_points: tuple       # per-level LevelPoints
    flow_points: object       # compact [FLOW_CAP] flow-statistic set
    last_q: jnp.ndarray       # T_w_last
    last_t: jnp.ndarray
    prev_q: jnp.ndarray       # previous relative motion
    prev_t: jnp.ndarray
    last_affine: jnp.ndarray  # [2]
    rmse_last0: jnp.ndarray   # frontend re-track ledger (scalar)
    kf_rmse: jnp.ndarray      # keyframe-strategy rmse memory (−1 = unset)
    min_distance: jnp.ndarray  # activation density P-controller state


class TickDiag(NamedTuple):
    """Per-frame diagnostics bundle (host bookkeeping/export only)."""

    is_keyframe: jnp.ndarray
    escalated: jnp.ndarray     # perturbation re-track fired this tick
    pose_q: jnp.ndarray
    pose_t: jnp.ndarray
    affine: jnp.ndarray
    rmse: jnp.ndarray
    flow: jnp.ndarray
    flow_no_rot: jnp.ndarray
    num_valid_align: jnp.ndarray
    t_kf_frame_mat: jnp.ndarray
    # keyframe-path fields (zeros on regular frames)
    energy: jnp.ndarray
    num_valid_solve: jnp.ndarray
    n_active: jnp.ndarray
    n_activated: jnp.ndarray
    min_distance: jnp.ndarray
    frame_flags: jnp.ndarray   # [K] marginalized this tick (pre-permute slots)
    kf_frame_id: jnp.ndarray   # [K]
    kf_poses_mat: jnp.ndarray  # [K, 4, 4] post-solve
    kf_affine: jnp.ndarray     # [K, 2]
    kf_exposure: jnp.ndarray   # [K]
    lm_uv: jnp.ndarray         # [K, N, 2]
    lm_idepth: jnp.ndarray     # [K, N]
    lm_valid: jnp.ndarray      # [K, N]
    lm_outlier: jnp.ndarray    # [K, N]
    lm_baseline: jnp.ndarray   # [K, N]


def _frontend_core(state: DeviceTrackerState, image, force_kf, models,
                   cfg: DeviceLoopConfig, exposure=None):
    """Per-frame frontend: fused regular tick + reliability ledger +
    keyframe decision → (base_state, need_kf, front).

    ``front`` is the FusedTickResult with ``immature`` stripped (it lives
    in ``base``; keeping one copy lets both split-program arguments be
    donated without aliasing the same buffer twice)."""
    dtype = image.dtype
    window = state.window
    poses = window.poses()
    kf_slot = jnp.sum(window.frame_valid).astype(jnp.int32) - 1
    exposure = (jnp.asarray(1.0, dtype) if exposure is None
                else jnp.asarray(exposure, dtype))

    out = fused_regular_tick(
        image, state.level_points, state.flow_points,
        poses.q, poses.t, window.affine(), window.exposure, exposure, kf_slot,
        state.immature, state.last_q, state.last_t, state.prev_q,
        state.prev_t, state.last_affine, models, cfg.align_opts,
        cfg.with_perturbations, cfg.num_levels, cfg.huber_sigma,
        rmse_last0=state.rmse_last0)

    # ---- frontend reliability gate (monocular_tracker.cpp:185) ---------
    rmse = out.rmse
    reliable = (rmse < ENERGY_RATIO_THRESHOLD * state.rmse_last0) & (out.num_valid > 0)
    rmse_last0 = jnp.where(
        reliable, rmse, state.rmse_last0 * ENERGY_RATIO_THRESHOLD).astype(dtype)

    # ---- keyframe decision (flow+rmse strategy) -------------------------
    ks = OpticalFlowKeyframeStrategy
    kf_rmse_eff = jnp.where(state.kf_rmse < 0, rmse, state.kf_rmse)
    need_strategy = (
        (cfg.keyframe_factor
         * (ks.MAX_SHIFT_WEIGHT * out.flow
            + ks.MAX_SHIFT_NO_ROT_WEIGHT * out.flow_no_rot)
         > ks.THRESHOLD)
        | (rmse / jnp.maximum(kf_rmse_eff, 1e-12) > ks.MAX_EXCESS_ENERGY)
    ) & reliable
    called = ~force_kf  # host short-circuit: `force or strategy(...)`
    kf_rmse = jnp.where(
        called, jnp.where(need_strategy, -1.0, kf_rmse_eff),
        state.kf_rmse).astype(dtype)
    need_kf = force_kf | (called & need_strategy)

    t_w_t = SE3(out.pose_q, out.pose_t)
    t_prev_rel = SE3(state.last_q, state.last_t).inverse() @ t_w_t
    base = state._replace(
        immature=out.immature,
        last_q=t_w_t.q, last_t=t_w_t.t,
        prev_q=t_prev_rel.q, prev_t=t_prev_rel.t,
        last_affine=out.affine,
        rmse_last0=rmse_last0, kf_rmse=kf_rmse)
    return base, need_kf, out._replace(immature=None)


def _backend_core(base: DeviceTrackerState, out, need_kf, frame_id, models,
                  mask, cfg: DeviceLoopConfig, exposure):
    """Keyframe-or-passthrough backend → (state', diag)."""
    dtype = base.last_affine.dtype
    rmse = out.rmse
    k = base.window.num_slots
    n = base.window.num_landmark_slots

    def _diag(is_kf, min_distance, energy, num_valid_solve, n_active,
              n_activated, frame_flags, kf_frame_id, kf_poses_mat, kf_affine,
              kf_exposure, lm_uv, lm_idepth, lm_valid, lm_outlier,
              lm_baseline):
        return TickDiag(
            is_keyframe=jnp.asarray(is_kf, bool),
            escalated=jnp.asarray(out.escalated, bool),
            pose_q=out.pose_q, pose_t=out.pose_t, affine=out.affine,
            rmse=rmse.astype(dtype), flow=out.flow.astype(dtype),
            flow_no_rot=out.flow_no_rot.astype(dtype),
            num_valid_align=out.num_valid.astype(jnp.int32),
            t_kf_frame_mat=out.t_kf_frame_mat.astype(dtype),
            energy=jnp.asarray(energy, dtype),
            num_valid_solve=jnp.asarray(num_valid_solve, jnp.int32),
            n_active=jnp.asarray(n_active, jnp.int32),
            n_activated=jnp.asarray(n_activated, jnp.int32),
            min_distance=jnp.asarray(min_distance, dtype),
            frame_flags=jnp.asarray(frame_flags, bool),
            kf_frame_id=jnp.asarray(kf_frame_id, jnp.int32),
            kf_poses_mat=jnp.asarray(kf_poses_mat, dtype),
            kf_affine=jnp.asarray(kf_affine, dtype),
            kf_exposure=jnp.asarray(kf_exposure, dtype),
            lm_uv=jnp.asarray(lm_uv, dtype),
            lm_idepth=jnp.asarray(lm_idepth, dtype),
            lm_valid=jnp.asarray(lm_valid, bool),
            lm_outlier=jnp.asarray(lm_outlier, bool),
            lm_baseline=jnp.asarray(lm_baseline, dtype),
        )

    def keyframe_branch(_):
        # frame-embedder channels feed the PBA window's patch tables; the
        # frontend/tracer stay C=1 like the reference
        # (monocular_tracker.hpp:58-60, :470 estimateDepths<...,1>)
        embed = None
        if cfg.embedder != "identity":
            from dsopp_tpu.features.embedder import make_embedder

            embed = make_embedder(cfg.embedder)(out.maps[0][0])
        kf_out = fused_keyframe_push(
            base.window, models[0], base.immature, out.maps[0],
            out.pose_q, out.pose_t, out.affine,
            frame_id.astype(jnp.int32), base.min_distance,
            cfg.pba_opts, cfg.refine, cfg.huber_sigma,
            cfg.immature_per_frame, mask=mask, exposure=exposure,
            embed=embed)
        win, immature, batch = kf_out.window, kf_out.immature, dict(kf_out.batch)

        # activation density P-controller (recalculateMinDistanceToNeighbor)
        min_distance = jnp.clip(
            base.min_distance
            + (batch["n_active"].astype(dtype) - cfg.desired_points) * P_GAIN,
            MIN_DISTANCE, MAX_DISTANCE).astype(dtype)

        # marginalization policy (device port, bit-parity tested)
        imm_counts = jnp.sum(immature.valid, axis=1)
        frame_flags, lm_flags, new_outliers = flags_device(
            win, imm_counts, cfg.window_min, cfg.window_max,
            cfg.max_marg_fraction)

        # snapshot BEFORE the fold/permute — host export of dropped frames
        snap = dict(
            frame_flags=frame_flags, kf_frame_id=win.frame_id,
            kf_poses_mat=batch["poses_mat"], kf_affine=win.affine(),
            kf_exposure=win.exposure, lm_uv=win.lm_uv,
            lm_idepth=win.lm_idepth, lm_valid=win.lm_valid,
            lm_outlier=win.lm_outlier, lm_baseline=win.lm_baseline)

        win = dataclasses.replace(
            win,
            lm_outlier=win.lm_outlier | new_outliers,
            frame_marg=frame_flags, lm_marg_flag=lm_flags)
        perm = kept_first_perm(win.frame_valid, frame_flags)
        win = _marginalize_device(win, models[0], perm, cfg.pba_opts,
                                  True, True)
        immature = jax.tree_util.tree_map(lambda x: x[perm], immature)
        immature = immature._replace(
            valid=immature.valid & win.frame_valid[:, None])

        idep, wei, points, flow_pts = build_frontend_state(
            win, models[0], out.maps, cfg.height, cfg.width,
            cfg.num_levels, cfg.frontend_points)

        st = base._replace(
            window=win, immature=immature, depth_idepth=idep,
            depth_weight=wei, level_points=points, flow_points=flow_pts,
            min_distance=min_distance,
            # host parity: after a keyframe solve the frontend carries the
            # new keyframe's POST-solve affine (monocular.py _push_keyframe
            # sets last_affine = batch["new_affine"])
            last_affine=jnp.asarray(batch["new_affine"], dtype))
        diag = _diag(True, min_distance, batch["energy"], batch["num_valid"],
                     batch["n_active"], batch["n_activated"], **snap)
        return st, diag

    def regular_branch(_):
        diag = _diag(False, base.min_distance, 0.0, 0, 0, 0,
                     jnp.zeros((k,), bool), jnp.zeros((k,), jnp.int32),
                     jnp.zeros((k, 4, 4), dtype), jnp.zeros((k, 2), dtype),
                     jnp.zeros((k,), dtype), jnp.zeros((k, n, 2), dtype),
                     jnp.zeros((k, n), dtype), jnp.zeros((k, n), bool),
                     jnp.zeros((k, n), bool), jnp.zeros((k, n), dtype))
        return base, diag

    return jax.lax.cond(need_kf, keyframe_branch, regular_branch, None)


@partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def device_tick(state: DeviceTrackerState, image, frame_id, force_kf,
                models, mask, cfg: DeviceLoopConfig, exposure=None):
    """One tracked frame as ONE device program → (state', diag).

    ``state`` is DONATED: the ~1.6 GB window banks (patch tables, maps)
    alias into the output instead of being copied through the keyframe
    ``lax.cond`` select on every regular frame; callers must treat the
    passed state as consumed — the pipelined drivers always overwrite it.

    ``mask``: [H, W] bool candidate-selection mask (CameraMask, possibly
    semantic-filtered for this frame); ``exposure``: the frame's exposure
    time from the provider (1.0 when absent).

    This is the largest program of the tracker; its compile time is
    reported as ``first tick`` by ``app.main`` and as ``compile_s`` by
    ``bench.py``.  The persistent compilation cache
    (:func:`dsopp_tpu.runtime.enable_compile_cache`) serves it to later
    processes."""
    dtype = image.dtype
    exposure = (jnp.asarray(1.0, dtype) if exposure is None
                else jnp.asarray(exposure, dtype))
    base, need_kf, front = _frontend_core(
        state, image, force_kf, models, cfg, exposure)
    return _backend_core(base, front, need_kf, frame_id, models, mask, cfg,
                         exposure)


class PipelinedTracker:
    """Host driver of the device loop: async dispatch, batched readbacks.

    Wraps an initialized :class:`~dsopp_tpu.tracker.monocular.MonocularTracker`
    (≥2 keyframes, frontend state built).  ``tick`` enqueues one device
    program and returns immediately; diagnostics are fetched every
    ``flush_every`` frames in one transfer and folded into the host track.
    ``finalize`` writes the device state back into the wrapped tracker so
    exporters/checkpointing keep working unchanged.
    """

    def __init__(self, tracker, flush_every: int = 16):
        if tracker.level_points is None or tracker.t_w_last is None:
            raise ValueError("tracker must be initialized (≥2 keyframes)")
        cfgt = tracker.config
        if cfgt.num_frame_slots < cfgt.window_max + 2:
            raise ValueError("device loop needs num_frame_slots ≥ window_max+2")
        self.tracker = tracker
        self.dtype = tracker.dtype
        self.models = tuple(tracker.models)
        self.cfg = DeviceLoopConfig(
            align_opts=tracker.align_opts,
            pba_opts=tracker.pba_opts,
            num_levels=cfgt.pyramid_levels,
            with_perturbations=cfgt.use_rotation_perturbations,
            huber_sigma=cfgt.huber_sigma,
            refine=cfgt.refine_activation,
            embedder=cfgt.embedder,
            immature_per_frame=cfgt.immature_per_frame,
            frontend_points=cfgt.frontend_points,
            desired_points=float(cfgt.desired_points),
            keyframe_factor=cfgt.keyframe_factor,
            window_min=cfgt.window_min,
            window_max=cfgt.window_max,
            max_marg_fraction=cfgt.max_marginalized_fraction,
            height=tracker.image_shape[0],
            width=tracker.image_shape[1],
        )
        d = self.dtype
        # the state is DONATED into every device_tick — copy the leaves so
        # the wrapped tracker's own arrays (window banks etc.) survive the
        # first tick (finalize() writes the latest state back)
        self.state = jax.tree_util.tree_map(
            jnp.copy, DeviceTrackerState(
            window=tracker.window,
            immature=tracker.immature,
            depth_idepth=tuple(tracker.depth_maps[0]),
            depth_weight=tuple(tracker.depth_maps[1]),
            level_points=tuple(tracker.level_points),
            flow_points=tracker.flow_points,
            last_q=jnp.asarray(tracker.t_w_last.q, d),
            last_t=jnp.asarray(tracker.t_w_last.t, d),
            prev_q=jnp.asarray(tracker.t_prev_rel.q, d),
            prev_t=jnp.asarray(tracker.t_prev_rel.t, d),
            last_affine=jnp.asarray(tracker.last_affine, d),
            rmse_last0=jnp.asarray(tracker.rmse_last[0], d),
            kf_rmse=jnp.asarray(tracker.keyframe_strategy._rmse, d),
            min_distance=jnp.asarray(
                tracker.activator.min_distance_to_neighbor, d),
        ))
        self.mask = tracker.mask
        self.cur_kf = tracker._kf_id()
        self.num_keyframes = tracker.num_keyframes
        self.flush_every = flush_every
        self.pending = []
        # host-side semantics bookkeeping: per pending frame until the
        # keyframe flag is known, then per keyframe until marginalization
        self._sem_pending = {}
        self._kf_semantics = dict(tracker._kf_semantics)

    # ------------------------------------------------------------------
    def tick(self, frame_id: int, timestamp: float, image,
             force_keyframe: bool = False, semantics=None,
             exposure: float = 1.0):
        if semantics is not None:
            self._sem_pending[frame_id] = np.asarray(semantics)
            if self.tracker.semantic_filter:
                from dsopp_tpu.sensors.masks import filter_semantic_objects

                self.mask = filter_semantic_objects(
                    self.tracker.base_mask, jnp.asarray(semantics),
                    self.tracker.semantic_filter)
        image = jnp.asarray(image, self.dtype)
        self.state, diag = device_tick(
            self.state, image, jnp.asarray(frame_id, jnp.int32),
            jnp.asarray(bool(force_keyframe)), self.models, self.mask,
            self.cfg, exposure=jnp.asarray(float(exposure), self.dtype))
        self.pending.append((frame_id, timestamp, diag))
        if len(self.pending) >= self.flush_every:
            self.drain()

    def drain(self):
        """Fetch pending diagnostics in ONE transfer and fold into the track."""
        if not self.pending:
            return
        diags = jax.device_get([d for (_, _, d) in self.pending])
        items = [(f, t) for (f, t, _) in self.pending]
        self.pending = []
        for (fid, ts), d in zip(items, diags):
            self._bookkeep(fid, ts, d)

    def _bookkeep(self, fid, ts, d: TickDiag):
        from dsopp_tpu.track.state import sample_semantics

        track = self.tracker.track
        sem = self._sem_pending.pop(fid, None)
        if bool(d.is_keyframe):
            track.on_keyframe(fid, ts)
            self.cur_kf = fid
            self.num_keyframes += 1
            if sem is not None:
                self._kf_semantics[fid] = sem
            for pos in np.where(np.asarray(d.frame_flags))[0]:
                kfid = int(d.kf_frame_id[pos])
                sem_img = self._kf_semantics.pop(kfid, None)
                track.on_marginalize(MarginalizedKeyframe(
                    frame_id=kfid,
                    timestamp=track.keyframe_timestamps.get(kfid, ts),
                    t_wc=np.asarray(d.kf_poses_mat[pos], np.float64),
                    affine=np.asarray(d.kf_affine[pos], np.float64),
                    exposure=float(d.kf_exposure[pos]),
                    lm_uv=np.asarray(d.lm_uv[pos]),
                    lm_idepth=np.asarray(d.lm_idepth[pos]),
                    lm_valid=np.asarray(d.lm_valid[pos]),
                    lm_outlier=np.asarray(d.lm_outlier[pos]),
                    lm_baseline=np.asarray(d.lm_baseline[pos]),
                    lm_semantic=(None if sem_img is None else
                                 sample_semantics(sem_img,
                                                  np.asarray(d.lm_uv[pos]))),
                ))
        else:
            track.attach_frame(AttachedFrame(
                fid, ts, self.cur_kf,
                np.asarray(d.t_kf_frame_mat, np.float64),
                flow=float(d.flow),
                flow_without_rotation=float(d.flow_no_rot),
                rmse=float(d.rmse)))

    # ------------------------------------------------------------------
    def finalize(self):
        """Flush bookkeeping and write device state back into the tracker."""
        self.drain()
        t = self.tracker
        st = self.state
        t.window = st.window
        t.immature = st.immature
        t.depth_maps = (st.depth_idepth, st.depth_weight)
        t.level_points = list(st.level_points)
        t.t_w_last = SE3(st.last_q, st.last_t)
        t.t_prev_rel = SE3(st.prev_q, st.prev_t)
        t.last_affine = st.last_affine
        t.rmse_last[0] = float(st.rmse_last0)
        t.keyframe_strategy._rmse = float(st.kf_rmse)
        t.activator.min_distance_to_neighbor = float(st.min_distance)
        t.num_keyframes = self.num_keyframes
        t._kf_id_cache = self.cur_kf
        t._kf_pose_cache = None
        t._kf_semantics = dict(self._kf_semantics)
        t.mask = self.mask
        return t
