"""Aggregate frames/s/chip probe: B concurrent sequences per device.

Measures the batched device tick (dsopp_tpu/tracker/batched_loop.py) at the
reference operating point (640x480, ~2000 pts, W=7) for a sweep of batch
sizes.  Sequences are offset copies of the synthetic corridor (different
frame phase per stream) so keyframe schedules and LM iteration counts
de-synchronize like independent streams would.

Not part of the test suite — a perf tool.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def make_tracker(seq, cam, cfg, init=6, offset=0):
    from dsopp_tpu.core.lie import SE3
    from dsopp_tpu.tracker.monocular import MonocularTracker

    tracker = MonocularTracker(cam, cfg, dtype=jnp.float32)
    for j in range(init):
        i = offset + j
        pose = SE3(jnp.asarray(seq.pose_t_wc(i).q, jnp.float32),
                   jnp.asarray(seq.pose_t_wc(i).t, jnp.float32))
        tracker.tick(i, float(seq.timestamps[i]), seq.images[i],
                     known_pose=pose, force_keyframe=(j == init - 1))
    return tracker


def main():
    from dsopp_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--frames", type=int, default=40)
    args = ap.parse_args()

    from dsopp_tpu.core.camera import Pinhole
    from dsopp_tpu.testing import render_sequence
    from dsopp_tpu.tracker.batched_loop import BatchedPipelinedTracker
    from dsopp_tpu.tracker.monocular import TrackerConfig

    H, W, FOCAL = 480, 640, 520.0
    INIT = 6
    max_b = max(args.batches)
    total = INIT + (max_b - 1) + args.frames + 2
    t0 = time.time()
    seq = render_sequence(num_frames=total, height=H, width=W,
                          focal=FOCAL, advance=0.08, backend="jax")
    print(f"render {total} frames: {time.time()-t0:.1f}s")

    cam = Pinhole.create((float(W), float(H)), (FOCAL, FOCAL),
                         (W / 2 - 0.5, H / 2 - 0.5), jnp.float32)
    cfg = TrackerConfig(
        num_frame_slots=9, landmarks_per_frame=320, immature_per_frame=800,
        desired_points=2000, frontend_points=2000, keyframe_factor=3.0,
        window_min=5, window_max=7, use_rotation_perturbations=False,
    )
    images = [jnp.asarray(seq.images[i], jnp.float32) for i in range(total)]
    jax.block_until_ready(images[-1])

    for b in args.batches:
        trackers = [make_tracker(seq, cam, cfg, INIT, offset=k)
                    for k in range(b)]
        pipe = BatchedPipelinedTracker(trackers, flush_every=10 ** 9)

        def step(j):
            fids = [INIT + k + j for k in range(b)]
            pipe.tick(fids, [float(seq.timestamps[f]) for f in fids],
                      jnp.stack([images[f] for f in fids]))

        t0 = time.time()
        step(0)
        jax.block_until_ready(pipe.states.window.eps)
        print(f"B={b}: compile+first tick {time.time()-t0:.1f}s")

        # synchronized per-tick latency
        lat = []
        for j in range(1, 6):
            t0 = time.time()
            step(j)
            jax.block_until_ready(pipe.states.window.eps)
            lat.append(time.time() - t0)
        print(f"B={b}: sync tick p50 {np.percentile(lat, 50)*1e3:.1f} ms")

        # pipelined steady state
        t0 = time.time()
        n = 0
        for j in range(6, args.frames):
            step(j)
            n += 1
        jax.block_until_ready(pipe.states.window.eps)
        dt = time.time() - t0
        print(f"B={b}: {n} ticks x {b} seqs in {dt:.2f}s -> "
              f"{n*b/dt:.2f} frames/s aggregate ({n/dt:.2f} ticks/s)")


if __name__ == "__main__":
    main()
