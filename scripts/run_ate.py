"""End-to-end ATE harness — the mega-performance-test analog.

Mirrors the reference harness
(test/performance/application/run_mega_performance_test.py:31-56): for
each dataset, run the full application CLI (JSON config → ``.npy`` frames →
precalculated bootstrap → device-loop tracker → track.npz/track.bin),
convert the saved track to a TUM trajectory (app/track2trajectory),
associate against ground truth and report ATE statistics (output/ate.py —
the evaluate_ate.py metric), plus wall-clock per dataset.

Datasets are synthetic corridor sequences (testing/synthetic.py) with varied
texture seed, motion rate and exposure profile, written by
``dsopp_tpu.testing.dataset.write_dataset``: neither PyYAML nor OpenCV is
needed.

Usage::

    python scripts/run_ate.py [--sequences 3] [--frames 96] [--cpu]
                              [--out ATE.md] [--workdir DIR]

Writes a markdown table and prints one summary line per sequence.
"""

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEQUENCES = [
    # (name, seed, advance, exposure profile)
    ("corridor-a", 7, 0.08, None),
    ("corridor-b-fast", 11, 0.13, None),
    ("corridor-c-exposure", 23, 0.06, "vignette"),
]


def build_dataset(root, name, seed, advance, exposure, num_frames, height,
                  width, focal, init_frames):
    from dsopp_tpu.testing import render_sequence
    from dsopp_tpu.testing.dataset import write_dataset

    seq = render_sequence(num_frames=num_frames, height=height, width=width,
                          focal=focal, seed=seed, advance=advance,
                          backend="jax")
    exposures = np.ones(num_frames)
    images = np.clip(np.asarray(seq.images), 0, 255)
    if exposure == "vignette":
        # slow global exposure oscillation (affine-brightness stressor);
        # the exposure TIME goes into times.txt like TUM-mono's — the
        # pipeline corrects brightness by the exposure ratio (reference
        # CameraDataFrame exposure → every solver), and the −4 offset
        # remains as the affine-b stressor
        exposures = 1.0 + 0.12 * np.sin(0.35 * np.arange(num_frames))
        images = np.clip(images * exposures[:, None, None] - 4.0, 0, 255)
    # 8-bit frames, as the image files of a real dataset are
    seq = dataclasses.replace(seq, images=np.round(images))
    return write_dataset(os.path.join(root, name), seq, init_frames,
                         exposures=exposures)


def evaluate_sequence(config_path, max_frames, platform):
    import numpy as np

    from dsopp_tpu.app.main import main as app_main
    from dsopp_tpu.app.track2trajectory import main as t2t_main
    from dsopp_tpu.output.ate import absolute_trajectory_error
    from dsopp_tpu.output.tum import load_tum

    dataset_dir = os.path.dirname(config_path)
    track_path = os.path.join(dataset_dir, "track.npz")
    bin_path = os.path.join(dataset_dir, "track.bin")
    traj_path = os.path.join(dataset_dir, "trajectory.tum")
    t0 = time.time()
    app_main(["--config_file_path", config_path,
              "--output_file_path", track_path,
              "--track_bin_path", bin_path, "--platform", platform]
             + (["--max_frames", str(max_frames)] if max_frames else []))
    wall = time.time() - t0
    t2t_main([track_path, traj_path])

    est = load_tum(traj_path)
    gt = load_tum(os.path.join(dataset_dir, "gt_full.tum"))
    stats = absolute_trajectory_error(est, gt, with_scale=True)
    stats["wall_s"] = wall
    stats["frames"] = len(est)
    return stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sequences", type=int, default=3)
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--focal", type=float, default=520.0)
    ap.add_argument("--init-frames", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="CPU float64 oracle run (small shapes advised)")
    ap.add_argument("--out", default="")
    ap.add_argument("--workdir", default=None,
                    help="where the datasets are written (default: a "
                         "temporary directory, removed afterwards)")
    args = ap.parse_args()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    from dsopp_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    platform = "cpu" if args.cpu else "gpu"

    with tempfile.TemporaryDirectory() as tmp:
        rows = run(args, args.workdir or tmp, platform)
    write_table(args.out, rows)


def run(args, workdir, platform):
    rows = []
    for name, seed, advance, exposure in SEQUENCES[: args.sequences]:
        config = build_dataset(workdir, name, seed, advance, exposure,
                               args.frames, args.height, args.width,
                               args.focal, args.init_frames)
        stats = evaluate_sequence(config, args.frames, platform)
        rows.append((name, advance, exposure or "-", stats))
        print(f"{name}: ATE rmse={stats['rmse']:.4f}m "
              f"mean={stats['mean']:.4f} median={stats['median']:.4f} "
              f"max={stats['max']:.4f} n={stats['frames']} "
              f"wall={stats['wall_s']:.1f}s", flush=True)
    return rows


def write_table(out, rows):
    if out:
        dev = jax.devices()[0]
        with open(out, "w") as f:
            f.write("# ATE — end-to-end accuracy (synthetic corridor suite)\n\n")
            f.write(f"Device: {dev.device_kind} ({dev.platform}).  ")
            f.write("Full app path: config → bootstrap → device loop → "
                    "track.bin → track2trajectory → ATE vs ground truth "
                    "(scale-aligned, monocular).  Harness: "
                    "`python scripts/run_ate.py`.  Reference analog: "
                    "run_mega_performance_test.py.\n\n")
            f.write("| sequence | advance | exposure | ATE rmse (m) | mean | "
                    "median | max | frames | wall (s) | cache |\n")
            f.write("|---|---|---|---|---|---|---|---|---|---|\n")
            min_wall = min(s["wall_s"] for _, _, _, s in rows)
            for name, advance, exposure, s in rows:
                # the first sequence of a process pays any cold XLA compile;
                # label it so the wall column isn't read as steady-state
                cache = ("cold compile" if s["wall_s"] > min_wall + 30.0
                         else "warm")
                f.write(f"| {name} | {advance} | {exposure} | "
                        f"{s['rmse']:.4f} | {s['mean']:.4f} | "
                        f"{s['median']:.4f} | {s['max']:.4f} | "
                        f"{s['frames']} | {s['wall_s']:.1f} | {cache} |\n")
        print(f"table written to {out}")


if __name__ == "__main__":
    main()
