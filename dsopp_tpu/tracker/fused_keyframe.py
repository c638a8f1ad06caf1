"""Fused keyframe push: the whole keyframe device path as ONE program.

Every dispatch costs host time; the keyframe path previously ran ~6 device programs plus a dozen small dispatches
(push → immature-bank insert → activation kernel → idepth refinement →
activation scatter → windowed LM solve → readback bundle).  This module
composes them into a single jitted program returning the updated state and
the complete host-decision bundle in one transfer (reference structure:
monocular_tracker.cpp:489-509 keyframe branch of ``tick``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dsopp_tpu.core.interpolate import sample
from dsopp_tpu.core.pattern import shift_pattern
from dsopp_tpu.features.extractor import select_candidates
from dsopp_tpu.solvers.pba import (
    PBAOptions,
    Window,
    _push_frame_kernel,
    _solve_loop_device,
)
from dsopp_tpu.tracker.activation import (
    _activation_kernel,
    _activation_scatter,
    _refine_idepth_kernel,
)
from dsopp_tpu.tracker.depth_estimation import make_immature_points


class FusedKeyframeResult(NamedTuple):
    window: Window
    immature: object           # updated [K] banks
    batch: dict                # host-decision bundle (single device_get)


@partial(jax.jit, static_argnames=("opts", "refine", "huber_sigma",
                                   "immature_per_frame"))
def fused_keyframe_push(
    window: Window,
    model,
    immature,                  # ImmaturePoints bank [K]
    pixel_map0,                # [3, H, W] level-0 map of the new keyframe
    pose_q, pose_t,            # T_w_c of the new keyframe
    affine,                    # [2] brightness state carried from frontend
    frame_id,                  # scalar int32
    min_distance,              # activation spacing (P-controller state)
    opts: PBAOptions,
    refine: bool,
    huber_sigma: float,
    immature_per_frame: int,
    mask=None,                 # [H, W] bool candidate-selection mask
    exposure=None,             # scalar exposure time of the new keyframe
    embed=None,                # [C, H, W] frame-embedder channels (C>1)
) -> FusedKeyframeResult:
    n = window.num_landmark_slots
    dtype = window.lm_uv.dtype
    slot = jnp.sum(window.frame_valid).astype(jnp.int32)
    exposure = (jnp.asarray(1.0, dtype) if exposure is None
                else jnp.asarray(exposure, dtype))
    embed = pixel_map0[:1] if embed is None else embed
    if embed.shape[0] != window.num_channels:
        raise ValueError(
            f"embedder produced {embed.shape[0]} channels for a "
            f"{window.num_channels}-channel window")

    # ---- push the frame (no landmarks yet; activation fills them) -----
    window = _push_frame_kernel(
        window, slot, pose_q, pose_t, affine,
        exposure, jnp.asarray(False), frame_id,
        jnp.zeros((n, 2), dtype), jnp.zeros((n, window.lm_patch.shape[-1]), dtype),
        jnp.zeros((n,), dtype), jnp.asarray(0, jnp.int32), pixel_map0,
        embed)

    # ---- fresh immature bank from the new frame's candidates ----------
    # mask = the sensor's CameraMask (semantic-filtered upstream);
    # reference extractors consult it per candidate (camera_mask.hpp:21-117)
    cands = select_candidates(pixel_map0, immature_per_frame, mask=mask)
    patches, _ = sample(pixel_map0, shift_pattern(cands.uv))
    grads, _ = sample(pixel_map0, cands.uv)
    bank = make_immature_points(cands.uv, patches[..., 0], grads[..., 1:],
                                dtype=dtype)
    bank = bank._replace(valid=bank.valid & cands.valid)
    immature = jax.tree_util.tree_map(
        lambda b, new: b.at[slot].set(new), immature, bank)

    # ---- activation (landmarks_activator.cpp:351) ----------------------
    activate, delete, n_active = _activation_kernel(
        window, model, immature, min_distance)
    if refine:
        idepth, activate, selected = _refine_idepth_kernel(
            window, model, immature, activate, huber_sigma)
        # beyond-cap candidates stay immature (advisor r4): only
        # refine-rejected members of the cap'd bank are deleted
        delete = delete | (selected & ~activate)
        immature = immature._replace(
            idepth_min=jnp.where(activate, idepth, immature.idepth_min),
            idepth_max=jnp.where(activate, idepth, immature.idepth_max))
    window, immature, n_activated = _activation_scatter(
        window, immature, activate, delete)

    # ---- windowed LM solve (EigenPBA::solve) ---------------------------
    window, energy, num_valid = _solve_loop_device(window, model, opts)

    # ---- host-decision bundle (ONE transfer) ---------------------------
    batch = dict(
        energy=energy, num_valid=num_valid,
        n_active=n_active, n_activated=n_activated,
        imm_counts=jnp.sum(immature.valid, axis=1),
        frame_valid=window.frame_valid, frame_id=window.frame_id,
        lm_valid=window.lm_valid, lm_outlier=window.lm_outlier,
        lm_opt_count=window.lm_opt_count, lm_inliers=window.lm_inliers,
        res_status=window.res_status, poses_mat=window.poses().matrix(),
        affine=window.affine(), exposure=window.exposure,
        lm_uv=window.lm_uv, lm_idepth=window.lm_idepth,
        lm_baseline=window.lm_baseline,
        new_affine=window.affine()[slot],
    )
    return FusedKeyframeResult(window=window, immature=immature, batch=batch)
