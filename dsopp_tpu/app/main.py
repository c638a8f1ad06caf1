"""dsopp_main-equivalent CLI.

Mirrors the reference application (reference:
src/application/dsopp_main.cpp:26-118): flags for config path, output path,
determinism; ``--config.*`` dot-path overrides; runs the pipeline, reports
an FPS status line (dsopp.cpp:45-73), writes the track and a TUM trajectory.

Usage::

    python -m dsopp_tpu.app.main --config_file_path mono.yaml \
        --output_file_path track.npz [--config.tracker.keyframe_strategy.factor=2]
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    parser = argparse.ArgumentParser(description="dsopp_tpu direct odometry")
    parser.add_argument("--config_file_path", required=True)
    parser.add_argument("--output_file_path", default="track.npz")
    parser.add_argument("--track_bin_path", default=None,
                        help="optional reference-format track.bin output")
    parser.add_argument("--trajectory_file_path", default=None,
                        help="optional TUM trajectory output")
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--deterministic", action="store_true",
                        help="single-device deterministic execution")
    parser.add_argument("--visualization", action="store_true",
                        help="serve the live 3D viewer over HTTP while "
                             "tracking (reference dsopp_main.cpp:28 "
                             "visualization flag; headless-ready)")
    parser.add_argument("--visualization_port", type=int, default=8642)
    parser.add_argument("--refine_calibration", action="store_true",
                        help="optimize the camera calibration over a frame "
                             "segment and print the refined model instead "
                             "of tracking (reference dsopp_main.cpp:30)")
    parser.add_argument("--start_frame", type=int, default=0,
                        help="first frame of the calibration segment")
    parser.add_argument("--frames_number", type=int, default=80,
                        help="number of frames in the calibration segment")
    parser.add_argument("--fix_focal", action="store_true",
                        help="keep focal fixed during calibration refinement")
    parser.add_argument("--fix_center", action="store_true",
                        help="keep the principal point fixed during "
                             "calibration refinement")
    parser.add_argument("--host-loop", action="store_true",
                        help="drive the per-frame loop from the host instead "
                             "of the device-resident pipeline (debug escape "
                             "hatch; the device loop is the production path)")
    parser.add_argument("--float64", action="store_true",
                        help="run in float64 (CPU oracle mode)")
    parser.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                        help="require this JAX platform; exits with an error "
                             "when it is not available (default: whatever "
                             "JAX picks)")
    args, unknown = parser.parse_known_args(argv)

    overrides = [a for a in unknown if a.startswith("--config.")]
    bad = [a for a in unknown if not a.startswith("--config.")]
    if bad:
        parser.error(f"unknown arguments: {bad}")

    import jax

    if args.platform:
        # no effect once a backend is up (an in-process caller already
        # chose it); the check below holds either way
        jax.config.update("jax_platforms", args.platform)
        try:
            found = jax.devices()[0].platform
        except RuntimeError as e:
            parser.error(f"--platform {args.platform}: {e}")
        if found != args.platform:
            parser.error(f"--platform {args.platform}: JAX runs on {found}")
    from dsopp_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    if args.float64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from dsopp_tpu.config import apply_overrides, build_application, load_config
    from dsopp_tpu.output.storage import save_track
    from dsopp_tpu.output.tum import export_tum

    config = load_config(args.config_file_path)
    config = apply_overrides(config, overrides)
    base_dir = os.path.dirname(os.path.abspath(args.config_file_path))
    app = build_application(
        config, base_dir, jnp.float64 if args.float64 else jnp.float32)
    if args.host_loop:
        app.use_device_loop = False

    if args.refine_calibration:
        return _refine_calibration(app, args)

    viewer = None
    if args.visualization:
        from dsopp_tpu.output.live_viewer import LiveViewer

        viewer = LiveViewer(app.camera.camera_model(),
                            port=args.visualization_port)
        print(f"live viewer: http://localhost:{viewer.port}/", flush=True)

    t0 = time.time()
    frame_times = []
    tracked = []    # (time before, time after) of each device-loop tick

    def on_frame(frame, result):
        now = time.time()
        if result.get("pipelined"):
            tracked.append((frame_times[-1] if frame_times else t0, now))
        frame_times.append(now)
        window = frame_times[-50:]
        if len(window) >= 2:
            fps = (len(window) - 1) / max(window[-1] - window[0], 1e-9)
        else:
            fps = 0.0
        kind = "KF" if result.get("keyframe") else "  "
        print(f"frame {frame.frame_id} {kind} fps(50)={fps:5.1f}", flush=True)

    n = app.run(max_frames=args.max_frames, on_frame=on_frame,
                observers=[viewer] if viewer else None)
    t_end = time.time()     # run() returns after the device loop drained
    app.finish()
    total = time.time() - t0
    print(f"processed {n} frames in {total:.1f}s "
          f"({n / max(total, 1e-9):.2f} fps total)")
    if len(tracked) >= 2:
        # the first device-loop tick traces and compiles its program; the
        # steady state runs from its return to the drained end of the run
        first = tracked[0][1] - tracked[0][0]
        steady = (len(tracked) - 1) / max(t_end - tracked[0][1], 1e-9)
        print(f"device loop: {len(tracked)} frames, "
              f"{app.tracker.num_keyframes} keyframes, first tick "
              f"{first:.3f}s (includes compile), steady state "
              f"{steady:.3f} frames/s")
    if app.sanity_checker is not None and app.sanity_checker.results:
        print(f"sanity violations: {dict(app.sanity_checker.results)}")

    model = app.camera.camera_model()
    camera_info = {
        "fx": float(model.fx), "fy": float(model.fy),
        "cx": float(model.cx), "cy": float(model.cy),
    }
    save_track(args.output_file_path, app.tracker.track, app.tracker.window,
               camera_info)
    print(f"track written to {args.output_file_path}")

    if args.track_bin_path:
        from dsopp_tpu.output.protobuf_track import save_track_bin

        save_track_bin(args.track_bin_path, app.tracker.track,
                       app.tracker.window, camera=model,
                       model=app.camera.settings.calibration,
                       sanity_results=(app.sanity_checker.results
                                       if app.sanity_checker else None))
        print(f"reference-format track written to {args.track_bin_path}")

    if args.trajectory_file_path:
        entries = app.tracker.track.trajectory(app.tracker.window)
        export_tum(args.trajectory_file_path, entries)
        print(f"trajectory written to {args.trajectory_file_path}")
    return 0


def _refine_calibration(app, args):
    """Optimize the pinhole calibration over a frame segment and print the
    refined model (reference DSOPP::refineCalibration, dsopp.hpp:86 — the
    gflags segment [start_frame, start_frame+frames_number) feeds the
    geometric BA's intrinsics refinement)."""
    import numpy as np

    from dsopp_tpu.fbs.geometric_ba import refine_intrinsics
    from dsopp_tpu.fbs.initializer import InitializerOptions, MonocularInitializer

    model = app.camera.camera_model()
    opts = InitializerOptions(max_frames=max(args.frames_number, 5))
    init = MonocularInitializer(camera=model, options=opts)

    n = 0
    seen = 0
    while True:
        frame = app._next_frame()
        if frame is None or seen >= args.start_frame + args.frames_number:
            break
        seen += 1
        if seen <= args.start_frame:
            continue
        done = init.process(frame.frame_id, frame.timestamp,
                            np.asarray(frame.image))
        n += 1
        if done:
            break
    if not getattr(init, "calib_data", None):
        print("calibration refinement failed: initializer did not converge "
              f"({n} frames)")
        return 1
    poses_r, poses_t, pts, obs_f, obs_p, obs_px = init.calib_data
    _, _, _, (fx, fy, cx, cy), rms = refine_intrinsics(
        poses_r, poses_t, pts, obs_f, obs_p, obs_px,
        model.fx, model.fy, model.cx, model.cy,
        fix_focal=args.fix_focal, fix_center=args.fix_center)
    print(f"refined camera model: pinhole fx={fx:.4f} fy={fy:.4f} "
          f"cx={cx:.4f} cy={cy:.4f} (rms {rms:.3f} px over {n} frames)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
