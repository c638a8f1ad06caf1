"""Batched multi-sequence tracking: B independent odometry streams per chip.

The throughput lever (SURVEY §2.8, BASELINE config 4 "8 TUM-mono
sequences, one host, linear-ish scaling"): the per-frame device program of
:mod:`dsopp_tpu.tracker.device_loop` is almost entirely latency-bound at the
single-sequence operating point (small tensors, long op chains), so vmapping
the WHOLE tick over a leading ``[B]`` sequence axis multiplies per-op work
while the op count — and hence the wall-clock of the latency-bound chain —
stays nearly constant.  Aggregate frames/s/chip scales accordingly.

Semantics: ``jax.vmap`` turns the keyframe ``lax.cond`` into a select, so
every batched tick executes both branches and keeps each sequence's branch
result — sequence b's trajectory is IDENTICAL to running sequence b alone
through ``device_tick`` (parity-tested in
tests/tracker/test_batched_loop.py).  There is no cross-sequence
interaction of any kind: the batch is pure data parallelism inside one
chip, and composes with the ``seq`` mesh axis of
:mod:`dsopp_tpu.parallel.sharded` across chips.

Reference analog: none — the reference is a single-process, single-sequence
CPU pipeline (SURVEY §2.8); this is the batched replacement for "run N
processes".
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from dsopp_tpu.tracker.device_loop import (
    DeviceLoopConfig,
    DeviceTrackerState,
    PipelinedTracker,
    device_tick,
)

# state, image, frame_id, force_kf, exposure batched; models+mask+cfg shared
_batched_tick = jax.vmap(
    device_tick, in_axes=(0, 0, 0, 0, None, None, None, 0))


@partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def batched_device_tick(states, images, frame_ids, force_kfs, models, mask,
                        cfg: DeviceLoopConfig, exposures=None):
    """One tracked frame for B sequences as ONE device program.

    ``states`` is DONATED (see ``device_tick`` — the nested donation does
    not apply once inlined here, so the batched entry point donates too);
    callers must treat the passed states as consumed."""
    if exposures is None:
        exposures = jnp.ones(images.shape[0], images.dtype)
    return _batched_tick(states, images, frame_ids, force_kfs, models, mask,
                         cfg, exposures)


def stack_states(states: List[DeviceTrackerState]) -> DeviceTrackerState:
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)


def unstack_state(states: DeviceTrackerState, b: int) -> DeviceTrackerState:
    return jax.tree_util.tree_map(lambda x: x[b], states)


class BatchedPipelinedTracker:
    """Host driver for B concurrent sequences on one chip.

    Wraps B initialized :class:`MonocularTracker`s sharing one camera
    model/config; every ``tick`` dispatches a single [B]-batched device
    program and the per-sequence diagnostics are drained in batches into
    each tracker's host-side track, exactly like
    :class:`~dsopp_tpu.tracker.device_loop.PipelinedTracker` does for one.
    """

    def __init__(self, trackers, flush_every: int = 16):
        if not trackers:
            raise ValueError("need at least one tracker")
        self.pipes = [PipelinedTracker(t, flush_every=10 ** 9)
                      for t in trackers]
        cfgs = {p.cfg for p in self.pipes}
        if len(cfgs) != 1:
            raise ValueError("all trackers must share one config")
        self.cfg = self.pipes[0].cfg
        self.models = self.pipes[0].models
        self.mask = self.pipes[0].mask
        self.dtype = self.pipes[0].dtype
        self.states = stack_states([p.state for p in self.pipes])
        self.flush_every = flush_every
        self.pending = []   # (frame_ids, timestamps, diag[B])

    @property
    def batch(self) -> int:
        return len(self.pipes)

    def tick(self, frame_ids, timestamps, images, force_keyframes=None,
             exposures=None):
        """Advance every sequence by one frame.

        ``frame_ids``: [B] ints; ``timestamps``: [B] floats; ``images``:
        [B, H, W] array (or list of [H, W]); ``force_keyframes``: [B] bools;
        ``exposures``: [B] provider exposure times (default 1.0).
        """
        b = self.batch
        if force_keyframes is None:
            force_keyframes = [False] * b
        images = jnp.asarray(jnp.stack([jnp.asarray(im, self.dtype)
                                        for im in images])
                             if not hasattr(images, "ndim") or images.ndim != 3
                             else images, self.dtype)
        self.states, diag = batched_device_tick(
            self.states, images,
            jnp.asarray(np.asarray(frame_ids, np.int32)),
            jnp.asarray(np.asarray(force_keyframes, bool)),
            self.models, self.mask, self.cfg,
            exposures=(None if exposures is None else
                       jnp.asarray(np.asarray(exposures, np.float64),
                                   self.dtype)))
        self.pending.append((list(frame_ids), list(timestamps), diag))
        if len(self.pending) >= self.flush_every:
            self.drain()

    def drain(self):
        if not self.pending:
            return
        diags = jax.device_get([d for (_, _, d) in self.pending])
        items = [(f, t) for (f, t, _) in self.pending]
        self.pending = []
        for (fids, tss), d in zip(items, diags):
            for b, pipe in enumerate(self.pipes):
                db = jax.tree_util.tree_map(lambda x: x[b], d)
                pipe._bookkeep(fids[b], tss[b], db)

    def finalize(self):
        """Drain bookkeeping and write each sequence's device state back."""
        self.drain()
        out = []
        for b, pipe in enumerate(self.pipes):
            pipe.state = unstack_state(self.states, b)
            # propagate keyframe counters collected via _bookkeep
            out.append(pipe.finalize())
        return out
