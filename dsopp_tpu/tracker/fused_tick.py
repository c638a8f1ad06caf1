"""Fused regular-frame tick: one device program per tracked frame.

Every dispatch and readback costs host time and a device synchronization,
so the per-frame hot path (pyramid → hypothesis batch → coarse-to-fine
alignment → epipolar depth update → flow statistics) is fused into a single
jitted program returning only scalar summaries + updated state.  The host
reads the scalars once and takes the keyframe decision (reference
monocular_tracker.cpp tick structure, SURVEY §7 "host↔device loop latency").
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dsopp_tpu.core.lie import SE3
from dsopp_tpu.features.pyramid import build_pyramid_maps
from dsopp_tpu.solvers.pose_alignment import AlignmentOptions, align_level
from dsopp_tpu.tracker.depth_estimation import estimate_depths
from dsopp_tpu.tracker.depth_map import mean_square_flows
from dsopp_tpu.tracker.monocular import (ENERGY_RATIO_THRESHOLD,
                                         _initialization_hypotheses)


class FusedTickResult(NamedTuple):
    maps: tuple                # pyramid maps of this frame
    pose_q: jnp.ndarray        # best T_w_t
    pose_t: jnp.ndarray
    affine: jnp.ndarray        # [2]
    rmse: jnp.ndarray          # scalar
    num_valid: jnp.ndarray     # scalar int
    flow: jnp.ndarray
    flow_no_rot: jnp.ndarray
    immature: object           # updated banks
    t_t_kf_q: jnp.ndarray
    t_t_kf_t: jnp.ndarray
    t_kf_frame_mat: jnp.ndarray  # 4x4 keyframe→frame (attach bookkeeping)
    escalated: jnp.ndarray     # bool — perturbation re-track ran this tick


@partial(jax.jit, static_argnames=("align_opts", "with_perturbations",
                                   "num_levels", "huber_sigma"))
def fused_regular_tick(
    image,
    level_points,          # tuple of LevelPoints (static length)
    flow_points,           # compact [FLOW_CAP] flow-statistic LevelPoints
    window_poses_q,        # [K, 4] current keyframe poses
    window_poses_t,        # [K, 3]
    window_affines,        # [K, 2]
    window_exposures,      # [K] keyframe exposure times
    exposure,              # scalar: this frame's exposure time
    kf_slot,               # scalar int: newest keyframe slot
    immature,              # ImmaturePoints bank [K]
    last_q, last_t,        # previous frame pose
    prev_q, prev_t,        # previous relative motion
    last_affine,           # [2]
    models,                # per-level camera models (static tuple)
    align_opts: AlignmentOptions,
    with_perturbations: bool,
    num_levels: int,
    huber_sigma: float,
    rmse_last0=None,       # frontend reliability ledger (escalation gate)
) -> FusedTickResult:
    dtype = image.dtype
    maps = build_pyramid_maps(image, num_levels)

    # ---- batched hypothesis alignment, coarse → fine ------------------
    kf_q = window_poses_q[kf_slot]
    kf_t = window_poses_t[kf_slot]
    # exposure ratio target/reference for the brightness model (reference
    # passes provider exposure times into every solver — fabric/monocular
    # tracker; 1.0 when the provider supplies none)
    exp_ratio_kf = exposure / jnp.maximum(window_exposures[kf_slot], 1e-12)

    def run_chunk(chunk_q, chunk_t):
        """One hypothesis CHUNK through the full coarse-to-fine schedule.

        Coarse levels refine every hypothesis in the chunk (vmap); level 0
        — the expensive one — runs only the chunk's coarse winner (the
        L1 per-point-energy ranking decides).  Scored by PER-POINT energy with a
        valid-count floor: a spurious minimum that drops most points can
        have a lower SUMMED energy than the true pose (the reference's
        per-try acceptance gates on rmse — monocular_tracker.cpp:185).
        """
        hyps = SE3(chunk_q, chunk_t)
        t_w_kf = SE3(jnp.broadcast_to(kf_q, hyps.q.shape),
                     jnp.broadcast_to(kf_t, hyps.t.shape))
        t = hyps.inverse().compose(t_w_kf)  # hypotheses of new ← keyframe
        affine = jnp.broadcast_to(last_affine, t.q.shape[:1] + (2,))
        result = None
        for level in range(num_levels - 1, 0, -1):
            result = jax.vmap(
                lambda tq, tt, ab, lvl=level: align_level(
                    level_points[lvl], maps[lvl], models[lvl], SE3(tq, tt),
                    ab, last_affine, exp_ratio_kf, align_opts)
            )(t.q, t.t, affine)
            t = result.t_t_r
            affine = result.affine
        if result is not None:
            nv = result.num_valid
            nv_floor = jnp.maximum(1, jnp.max(nv) // 2)
            score1 = jnp.where(nv >= nv_floor,
                               result.energy / jnp.maximum(nv, 1), jnp.inf)
            best = jnp.argmin(score1)
            t = SE3(t.q[best], t.t[best])
            affine = affine[best]
            res0 = align_level(level_points[0], maps[0], models[0], t,
                               affine, last_affine, exp_ratio_kf, align_opts)
        else:                       # num_levels == 1: no coarse ranking —
            res = jax.vmap(         # refine every hypothesis at L0
                lambda tq, tt, ab: align_level(
                    level_points[0], maps[0], models[0], SE3(tq, tt), ab,
                    last_affine, exp_ratio_kf, align_opts)
            )(t.q, t.t, affine)
            nv = res.num_valid
            nv_floor = jnp.maximum(1, jnp.max(nv) // 2)
            sc = jnp.where(nv >= nv_floor,
                           res.energy / jnp.maximum(nv, 1), jnp.inf)
            best = jnp.argmin(sc)
            res0 = jax.tree_util.tree_map(lambda x: x[best], res)
        score0 = jnp.where(res0.num_valid > 0,
                           res0.energy / jnp.maximum(res0.num_valid, 1),
                           jnp.inf)
        return (res0.t_t_r.q, res0.t_t_r.t, res0.affine,
                res0.rmse.astype(dtype),
                res0.num_valid.astype(jnp.int32), score0.astype(dtype))

    base = _initialization_hypotheses(
        SE3(last_q, last_t), SE3(prev_q, prev_t), SE3(kf_q, kf_t),
        False, dtype)
    chunk_size = base.q.shape[0]

    escalated = jnp.asarray(False)
    if not with_perturbations:
        bq, bt, b_affine, b_rmse, b_valid, b_score = run_chunk(base.q, base.t)
    else:
        # reference semantics (monocular_tracker.cpp:137-243): the ±1..3°
        # rotation-perturbed re-track runs only when the plain
        # initializations FAIL the reliability gate.  All hypotheses are
        # arranged as [num_chunks, chunk_size] and processed by a lax.scan
        # whose body contains the ONE align-chain instance in the whole
        # program (r4 compiled the chain twice — base + escalation — which
        # dominated the 50.9 s cold compile of this tick): chunk 0 is the
        # plain batch and always runs; later chunks run under lax.cond only
        # when chunk 0 failed the 2.5× gate, so the steady state pays one
        # chunk and ~21 skipped conds.
        thr = jnp.asarray(jnp.inf if rmse_last0 is None else
                          ENERGY_RATIO_THRESHOLD * rmse_last0, dtype)
        pert = _initialization_hypotheses(
            SE3(last_q, last_t), SE3(prev_q, prev_t), SE3(kf_q, kf_t),
            True, dtype)                      # [5 base + 104 perturbed]
        total = pert.q.shape[0]
        pad = (-total) % chunk_size
        pad_idx = jnp.concatenate(
            [jnp.arange(total), jnp.zeros((pad,), jnp.int32)])
        chunks_q = pert.q[pad_idx].reshape(-1, chunk_size, 4)
        chunks_t = pert.t[pad_idx].reshape(-1, chunk_size, 3)
        nchunks = chunks_q.shape[0]

        # while_loop (not scan): the steady state runs chunk 0 and ONE
        # condition check — a scan paid ~21 dead skip-iterations per frame
        def loop_cond(carry):
            i, run_rest = carry[0], carry[1]
            return (i < nchunks) & ((i == 0) | run_rest)

        def loop_body(carry):
            (i, run_rest, cq, ct, c_aff, c_rmse, c_valid, c_score) = carry
            oq, ot, o_aff, o_rmse, o_valid, o_score = run_chunk(
                jax.lax.dynamic_index_in_dim(chunks_q, i, keepdims=False),
                jax.lax.dynamic_index_in_dim(chunks_t, i, keepdims=False))
            is0 = i == 0
            # chunk 0 initializes the running best and decides escalation
            failed = (o_valid == 0) | (o_rmse >= thr)
            run_rest = jnp.where(is0, failed, run_rest)
            take = is0 | (o_score < c_score)
            cq = jnp.where(take, oq, cq)
            ct = jnp.where(take, ot, ct)
            c_aff = jnp.where(take, o_aff, c_aff)
            c_rmse = jnp.where(take, o_rmse, c_rmse)
            c_valid = jnp.where(take, o_valid, c_valid)
            c_score = jnp.where(take, o_score, c_score)
            return (i + 1, run_rest, cq, ct, c_aff, c_rmse, c_valid,
                    c_score)

        init = (jnp.asarray(0, jnp.int32), jnp.asarray(False),
                jnp.zeros(4, dtype), jnp.zeros(3, dtype),
                jnp.zeros(2, dtype), jnp.asarray(jnp.inf, dtype),
                jnp.asarray(0, jnp.int32), jnp.asarray(jnp.inf, dtype))
        carry = jax.lax.while_loop(loop_cond, loop_body, init)
        (_, escalated, bq, bt, b_affine, b_rmse, b_valid, b_score) = carry

    t_t_kf = SE3(bq, bt)
    best_affine = b_affine
    rmse = b_rmse
    num_valid = b_valid

    t_w_t = SE3(kf_q, kf_t) @ t_t_kf.inverse()

    # ---- epipolar depth update over all keyframe banks ----------------
    k = window_poses_q.shape[0]
    t_inv = t_w_t.inverse()
    t_rel = SE3(jnp.broadcast_to(t_inv.q, (k, 4)),
                jnp.broadcast_to(t_inv.t, (k, 3))).compose(
        SE3(window_poses_q, window_poses_t))
    immature = jax.vmap(
        estimate_depths,
        in_axes=(0, None, None, 0, 0, None, 0, None, None),
    )(immature, maps[0], models[0], t_rel, window_affines, best_affine,
      exposure / jnp.maximum(window_exposures, 1e-12), huber_sigma, 32)

    # ---- flow statistics ---------------------------------------------
    flow, flow_nr = mean_square_flows(flow_points, models[0], t_t_kf)

    return FusedTickResult(
        maps=maps, pose_q=t_w_t.q, pose_t=t_w_t.t, affine=best_affine,
        rmse=rmse, num_valid=num_valid, flow=flow, flow_no_rot=flow_nr,
        immature=immature, t_t_kf_q=t_t_kf.q, t_t_kf_t=t_t_kf.t,
        t_kf_frame_mat=t_t_kf.inverse().matrix(), escalated=escalated,
    )
