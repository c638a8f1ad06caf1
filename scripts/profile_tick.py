"""Per-stage timing probe for the device loop at the reference operating point.

Times, on the real chip:
  * regular-frame device_tick dispatch + sync (pipelined, back-to-back),
  * keyframe-path device_tick,
  * the component programs (fused_regular_tick, fused_keyframe_push,
    _solve_loop_device) in isolation.

Not part of the test suite — a steerable perf tool.
"""

import argparse
import os
import time

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from dsopp_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--landmarks", type=int, default=320)
    ap.add_argument("--immature", type=int, default=800)
    ap.add_argument("--window-max", type=int, default=7)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--trace-dir", type=str, default="")
    args = ap.parse_args()

    from dsopp_tpu.core.camera import Pinhole
    from dsopp_tpu.core.lie import SE3
    from dsopp_tpu.testing import render_sequence
    from dsopp_tpu.tracker.device_loop import PipelinedTracker, device_tick
    from dsopp_tpu.tracker.monocular import MonocularTracker, TrackerConfig

    h, w = args.height, args.width
    print(f"devices: {jax.devices()}")
    t0 = time.time()
    seq = render_sequence(num_frames=args.frames, height=h, width=w,
                          focal=520.0, advance=0.08, backend="jax")
    print(f"render: {time.time()-t0:.1f}s")

    cam = Pinhole.create((float(w), float(h)), (520.0, 520.0),
                         (w / 2 - 0.5, h / 2 - 0.5), jnp.float32)
    cfg = TrackerConfig(
        num_frame_slots=args.window_max + 2,
        landmarks_per_frame=args.landmarks,
        immature_per_frame=args.immature,
        desired_points=2000,
        frontend_points=2000,
        keyframe_factor=3.0,
        window_min=5,
        window_max=args.window_max,
        use_rotation_perturbations=False,
    )
    tracker = MonocularTracker(cam, cfg, dtype=jnp.float32)
    INIT = 6
    for i in range(INIT):
        pose = SE3(jnp.asarray(seq.pose_t_wc(i).q, jnp.float32),
                   jnp.asarray(seq.pose_t_wc(i).t, jnp.float32))
        tracker.tick(i, float(seq.timestamps[i]), seq.images[i],
                     known_pose=pose, force_keyframe=(i == INIT - 1))

    pipe = PipelinedTracker(tracker, flush_every=1000)
    images = [jnp.asarray(seq.images[i], jnp.float32)
              for i in range(INIT, args.frames)]
    for img in images:
        jax.block_until_ready(img)

    # ---- warm-up: compile both branches ---------------------------------
    t0 = time.time()
    pipe.tick(INIT, float(seq.timestamps[INIT]), images[0])
    jax.block_until_ready(pipe.state.window.eps)
    print(f"first tick (compile): {time.time()-t0:.1f}s")
    t0 = time.time()
    pipe.tick(INIT + 1, float(seq.timestamps[INIT + 1]), images[1],
              force_keyframe=True)
    jax.block_until_ready(pipe.state.window.eps)
    print(f"first forced-KF tick (compile): {time.time()-t0:.1f}s")

    # ---- per-frame timing, synchronized (isolates program latency) ------
    per_frame = []
    kf_flags = []
    for j, i in enumerate(range(INIT + 2, args.frames)):
        t0 = time.time()
        pipe.tick(i, float(seq.timestamps[i]), images[j + 2])
        jax.block_until_ready(pipe.state.window.eps)
        dt = time.time() - t0
        is_kf = bool(jax.device_get(pipe.pending[-1][2].is_keyframe))
        per_frame.append(dt)
        kf_flags.append(is_kf)
    reg = [d for d, k in zip(per_frame, kf_flags) if not k]
    kfs = [d for d, k in zip(per_frame, kf_flags) if k]
    print(f"regular frames: n={len(reg)} mean={np.mean(reg)*1e3:.1f}ms "
          f"p50={np.percentile(reg,50)*1e3:.1f}ms")
    if kfs:
        print(f"keyframe frames: n={len(kfs)} mean={np.mean(kfs)*1e3:.1f}ms "
              f"p50={np.percentile(kfs,50)*1e3:.1f}ms")

    # ---- pipelined throughput (async dispatch, one sync at the end) -----
    pipe2 = PipelinedTracker(tracker, flush_every=1000)
    # warm
    pipe2.tick(INIT, float(seq.timestamps[INIT]), images[0])
    jax.block_until_ready(pipe2.state.window.eps)
    t0 = time.time()
    n = 0
    for j, i in enumerate(range(INIT + 1, args.frames)):
        pipe2.tick(i, float(seq.timestamps[i]), images[j + 1])
        n += 1
    jax.block_until_ready(pipe2.state.window.eps)
    dt = time.time() - t0
    print(f"pipelined: {n} frames in {dt:.2f}s -> {n/dt:.2f} f/s")

    # ---- component isolation --------------------------------------------
    if args.trace_dir:
        with jax.profiler.trace(args.trace_dir):
            for j, i in enumerate(range(INIT + 1, min(INIT + 9, args.frames))):
                pipe2.tick(i + 1000, float(seq.timestamps[i]), images[j + 1])
            jax.block_until_ready(pipe2.state.window.eps)
        print(f"trace written to {args.trace_dir}")


if __name__ == "__main__":
    main()
