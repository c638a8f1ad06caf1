"""Multi-sequence fleet throughput on one chip (BASELINE config 4 datum).

The r3 measurement killed vmap-BATCHED multi-sequence tracking on one chip
(the keyframe `lax.cond` lowers to select under vmap and pays the keyframe
branch every frame — PERF.md §5).  The production fleet shape is instead
B independent sequences as independent program INSTANCES — on B chips that
is trivially linear; this harness measures the one-chip version of that
claim: B sequences interleaved through the SAME compiled per-frame
programs (no recompilation, no select tax), reporting aggregate and
per-sequence throughput.  Aggregate ≈ the single-sequence rate means the
chip time-slices cleanly and the per-chip scale-out story holds.

Run: python scripts/fleet_throughput.py [--b 4] [--frames 60]
"""

import argparse
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HEIGHT, WIDTH, FOCAL = 480, 640, 520.0
INIT = 6


def main():
    from dsopp_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=4)
    ap.add_argument("--frames", type=int, default=60)
    args = ap.parse_args()

    from dsopp_tpu.core.camera import Pinhole
    from dsopp_tpu.core.lie import SE3
    from dsopp_tpu.testing import render_sequence
    from dsopp_tpu.tracker.device_loop import PipelinedTracker
    from dsopp_tpu.tracker.monocular import MonocularTracker, TrackerConfig

    cam = Pinhole.create((float(WIDTH), float(HEIGHT)), (FOCAL, FOCAL),
                         (WIDTH / 2 - 0.5, HEIGHT / 2 - 0.5), jnp.float32)
    cfg = TrackerConfig(
        num_frame_slots=10, landmarks_per_frame=250, immature_per_frame=800,
        desired_points=2000, frontend_points=2000, keyframe_factor=1.25,
        window_min=5, window_max=8, use_rotation_perturbations=True)

    total = INIT + args.frames
    for b_count in (1, 2, args.b):
        seqs = [render_sequence(num_frames=total, height=HEIGHT, width=WIDTH,
                                focal=FOCAL, seed=7 + 4 * b,
                                advance=0.08, backend="jax")
                for b in range(b_count)]
        pipes = []
        for seq in seqs:
            tr = MonocularTracker(cam, cfg, dtype=jnp.float32)
            for i in range(INIT):
                pose = SE3(jnp.asarray(seq.pose_t_wc(i).q, jnp.float32),
                           jnp.asarray(seq.pose_t_wc(i).t, jnp.float32))
                tr.tick(i, float(seq.timestamps[i]), seq.images[i],
                        known_pose=pose, force_keyframe=(i == INIT - 1))
            pipes.append(PipelinedTracker(tr, flush_every=10 ** 6))
        images = [[jnp.asarray(s.images[i], jnp.float32)
                   for i in range(INIT, total)] for s in seqs]
        jax.block_until_ready(images)

        # warm (compile cached across b_count loops — same program)
        for b, p in enumerate(pipes):
            p.tick(INIT, float(seqs[b].timestamps[INIT]), images[b][0])
        jax.block_until_ready(pipes[-1].state.window.eps)

        t0 = time.time()
        n = 0
        for j in range(1, args.frames):
            for b, p in enumerate(pipes):
                p.tick(INIT + j, float(seqs[b].timestamps[INIT + j]),
                       images[b][j])
                n += 1
        for p in pipes:
            jax.block_until_ready(p.state.window.eps)
        dt = time.time() - t0
        print(f"B={b_count}: aggregate {n/dt:6.2f} f/s "
              f"({n/dt/b_count:6.2f} per sequence, {n} frames {dt:.2f}s)",
              flush=True)


if __name__ == "__main__":
    main()
