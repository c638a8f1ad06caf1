"""Sharded multi-sequence bundle-adjustment step.

Scaling design (SURVEY §2.8): the distributed part of DSO-style BA is
residual/Jacobian evaluation and Hessian/Schur **accumulation** — sums over
landmarks.  We therefore:

* stack B independent sequences' windows on a leading axis and shard it over
  the ``seq`` mesh axis (data parallelism — batched multi-sequence
  tracking);
* shard the landmark slot axis N over the ``lm`` mesh axis (model
  parallelism): each device evaluates its landmark shard's residuals,
  Jacobians and partial H/b, and XLA's SPMD partitioner inserts the
  ``psum`` over ICI for the contraction to the tiny (K·8)² pose system —
  exactly the "annotate shardings, let XLA insert collectives" recipe;
* the dense pose solve is replicated on every device (64×64 — negligible);
  the idepth back-substitution is landmark-local, so it stays sharded.

No explicit collectives appear in this file: the sharding annotations on the
window pytree are the whole distribution strategy.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from dsopp_tpu.parallel.mesh import LM_AXIS, SEQ_AXIS
from dsopp_tpu.solvers.pba import (
    PBAOptions,
    Window,
    _energy,
    _fej_cache,
    _pba_iteration,
    active_lm_mask,
)


def window_pspec(batched: bool = True) -> Window:
    """PartitionSpec pytree for a (stacked) Window.

    Landmark-indexed arrays shard their N axis over ``lm``; everything else
    is replicated within a sequence group.  With ``batched`` the leading
    sequence axis shards over ``seq``.
    """
    s = (SEQ_AXIS,) if batched else ()

    def spec(*axes):
        return P(*(s + axes))

    frame = spec(None)          # [K, ...]
    lm2 = spec(None, LM_AXIS)   # [K, N, ...]
    res = spec(None, None, LM_AXIS)  # [K, K, N]
    return Window(
        t_lin_q=frame, t_lin_t=frame, affine0=frame, eps=frame,
        exposure=frame, frame_valid=frame, frame_fixed=frame,
        frame_marg=frame, frame_id=frame,
        lm_uv=lm2, lm_patch=lm2, lm_idepth=lm2, lm_valid=lm2,
        lm_marg_flag=lm2, lm_outlier=lm2, lm_inliers=lm2,
        lm_opt_count=lm2, lm_baseline=lm2,
        res_status=res,
        h_marg=spec(), b_marg=spec(), energy_marg=spec(),
        h_marg_lo=spec(), b_marg_lo=spec(), energy_marg_lo=spec(),
        maps=frame, patch=frame, patch_map=frame,
    )


def shard_windows(windows: Window, mesh) -> Window:
    """Place a stacked Window (leading B axis) onto the mesh."""
    specs = window_pspec(batched=True)
    return jax.tree_util.tree_map(
        lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), windows, specs)


def _single_step(window: Window, model, regularizer, opts: PBAOptions):
    """One LM iteration + energy for one sequence (jit/vmap-able)."""
    lm_mask = active_lm_mask(window)
    fej = _fej_cache(window, model)
    eps, idepth, step_sq = _pba_iteration(
        window, model, fej, window.eps, window.lm_idepth, lm_mask,
        regularizer, opts)
    energy, n_valid, _ = _energy(window, model, eps, idepth, lm_mask, opts)
    return eps, idepth, energy, n_valid, step_sq


@partial(jax.jit, static_argnames=("opts",))
def batched_train_step(windows: Window, model, regularizer,
                       opts: PBAOptions = PBAOptions()):
    """One BA iteration over a batch of sequences (the dp×mp "train step").

    ``windows``: Window pytree with a leading [B] sequence axis, placed with
    :func:`shard_windows`.  Returns (eps [B,K,8], idepth [B,K,N],
    energy [B], n_valid [B], step_sq [B]).
    """
    return jax.vmap(
        lambda w: _single_step(w, model, regularizer, opts)
    )(windows)


def stack_windows(windows) -> Window:
    """Stack a list of same-shape Windows on a new leading axis."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *windows)
