"""Smoke run of the tracker on the GPU.

    python chip_smoke.py           # one card: phases 0, 1 and 2
    python chip_smoke.py --multi   # four cards: the sharded paths only

Phase 0 requires a GPU (there is no CPU fallback) and prints the card.
Phase 1 checks each fast layout and each precision-sensitive contraction on
the card, at the VGA standart shapes, against a plain reference: the plain
sampler, the same program run on the CPU in float64, or NumPy float64.
Phase 2 renders a synthetic corridor, writes it as an ``.npy`` dataset with
a JSON config at the reference's standart.yaml operating point, runs it
through ``dsopp_tpu.app.main`` in this process, and gates the trajectory
error.  ``--multi`` runs the landmark-sharded solver and the
sequence-sharded tracker on four cards against their unsharded runs.

Every failed check exits non-zero.  The last line of a passing run is one
JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

HEIGHT, WIDTH, FOCAL = 480, 640, 520.0
PRECISION_POLICY = ("explicit precision=HIGHEST on every f32 dot and "
                    "convolution (per call, no process-wide flag)")


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(name, err, bound, why):
    """Print ``err`` beside its bound and fail unless err <= bound."""
    print(f"  {name}: {err:.3e}  (bound {bound:.1e}: {why})", flush=True)
    if not err <= bound:      # NaN fails too
        fail(f"{name}: {err:.3e} exceeds {bound:.1e}")


def max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def rel_fro(a, b):
    """Relative Frobenius error of ``a`` against the reference ``b``."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@contextlib.contextmanager
def x64():
    """float64 for the CPU oracle only; the card runs the f32 program."""
    import jax

    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


def to_cpu64(tree):
    """Copy a pytree to the CPU, floats widened to float64 (under x64)."""
    import jax

    cpu = jax.devices("cpu")[0]

    def conv(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating):
            x = x.astype(np.float64)
        return jax.device_put(x, cpu)

    return jax.tree_util.tree_map(conv, tree)


# ---------------------------------------------------------------------------
# Phase 0: the device
# ---------------------------------------------------------------------------

def phase0(count):
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        fail(f"no GPU: JAX runs on {devices[0].platform}")
    if len(devices) < count:
        fail(f"{count} GPUs needed, {len(devices)} found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        print(f"card: {line.strip()}")

    import dsopp_tpu
    from dsopp_tpu import native
    from dsopp_tpu.runtime import enable_compile_cache

    pkg = os.path.dirname(os.path.abspath(dsopp_tpu.__file__))
    if pkg != os.path.join(HERE, "dsopp_tpu"):
        fail(f"dsopp_tpu imported from {pkg}, not from this checkout")
    print(f"jax {jax.__version__}; device_kind {devices[0].device_kind}; "
          f"{len(devices)} device(s); native host kernels loaded: "
          f"{native.available()}; compile cache {enable_compile_cache()}",
          flush=True)
    return devices


# ---------------------------------------------------------------------------
# Phase 1: fast layouts and contractions against plain references
# ---------------------------------------------------------------------------

def check_sampling(rng):
    """Patch-table and corner-packed sampling against the plain sampler."""
    import jax
    import jax.numpy as jnp

    from dsopp_tpu.core.interpolate import build_pixel_map, sample
    from dsopp_tpu.core.pattern import PATTERN_CENTER, shift_pattern
    from dsopp_tpu.ops import pack_corners, sample_packed
    from dsopp_tpu.ops.patch import pack_patch_table, sample_pattern_patch

    image = rng.uniform(0, 255, (HEIGHT, WIDTH)).astype(np.float32)
    # 25k pattern groups x 8 points: one BA evaluation's worth of samples
    centers = rng.uniform(8, [WIDTH - 9, HEIGHT - 9], (25_000, 2))
    uv = np.asarray(shift_pattern(jnp.asarray(centers)))
    uv = (uv + rng.uniform(-0.49, 0.49, uv.shape)).astype(np.float32)

    @jax.jit
    def run(image, uv):
        pm = build_pixel_map(image)
        ref, _ = sample(pm, uv)
        vals, gx, gy, inside = sample_pattern_patch(
            pack_patch_table(image), uv, uv[..., PATTERN_CENTER, :],
            HEIGHT, WIDTH)
        packed, _ = sample_packed(pack_corners(pm), uv, HEIGHT, WIDTH)
        return ref, jnp.stack([vals, gx, gy], -1), inside, packed

    ref, patch, inside, packed = run(jnp.asarray(image), jnp.asarray(uv))
    if not bool(jnp.all(inside)):
        fail("patch-table sampling marked interior points invalid")
    with x64():
        ref64, _ = jax.jit(lambda im, p: sample(build_pixel_map(im), p))(
            *to_cpu64((image, uv)))
    why = "a few f32 ulp at 255 after reassociation; TF32 would be ~1e-1"
    check("plain sampler (card) vs CPU float64, max|d|",
          max_abs(ref, ref64), 1e-3, why)
    check("patch-table sampling vs plain sampler, max|d|",
          max_abs(patch, ref), 1e-3, why)
    check("corner-packed sampling vs plain sampler, max|d|",
          max_abs(packed, ref), 1e-3, why)


def check_pba(seq):
    """One PBA linearize + Schur + step at standart shapes vs CPU float64.

    The window holds 9 keyframes of the rendered corridor in K=10 slots with
    N=250 landmarks each (P=8), seeded from ground truth with pose and
    depth noise, as a keyframe solve sees it.  Residuals, weights and
    Jacobians are evaluated once on the card; the systems and the step are
    then built from those same arrays on the card and on the CPU, so the
    comparison isolates the contractions and the solve."""
    import jax
    import jax.numpy as jnp

    from dsopp_tpu.solvers.pba import (PBAOptions, _evaluate, _fej_cache,
                                       _linearize_from_ev, _solve_step,
                                       active_lm_mask)
    from dsopp_tpu.testing.fixtures import build_test_window

    opts = PBAOptions()
    window = build_test_window(seq, list(range(0, 36, 4)), num_landmarks=250,
                               slots=10, pose_noise=0.01, idepth_noise=0.05,
                               dtype=jnp.float32)
    cam = seq.camera      # float32: the render runs with x64 off

    @jax.jit
    def evaluate(window, cam):
        fej = _fej_cache(window, cam)
        ev = _evaluate(window, cam, window.eps, window.lm_idepth,
                       active_lm_mask(window), opts, with_gradients=True)
        return fej, ev

    @jax.jit
    def systems(window, fej, ev, reg):
        photo = _linearize_from_ev(window, fej, ev, window.eps, opts,
                                   with_prior=False)
        full = _linearize_from_ev(window, fej, ev, window.eps, opts)
        eps, idepth, _, _ = _solve_step(window, full, window.eps,
                                        window.lm_idepth, reg, opts)
        return (photo.h_pose, photo.b_pose, photo.h_schur, photo.b_schur,
                eps - window.eps, idepth - window.lm_idepth)

    fej, ev = evaluate(window, cam)
    args = (window, fej, ev, np.float32(1e-5))
    got = systems(*args)
    cpu32 = systems(*jax.device_put(args, jax.devices("cpu")[0]))
    with x64():
        want = systems(*to_cpu64(args))
    why = "f32 sums of ~10^5 products; TF32 inputs would be ~1e-3"
    for i, name in enumerate(("H", "b", "H_schur", "b_schur")):
        check(f"PBA {name} vs CPU float64, rel. Frobenius",
              rel_fro(got[i], want[i]), 1e-4, why)
    # the damped system is ill-conditioned (affine priors 1e12, fixed frame
    # 1e16), so an f32 solve loses digits wherever it runs: the card's f32
    # step may be no further from float64 than the CPU's f32 step, x4 for
    # summation order
    for i, name in ((4, "pose"), (5, "idepth")):
        base = rel_fro(cpu32[i], want[i])
        check(f"PBA {name} step vs CPU float64, rel. Frobenius",
              rel_fro(got[i], want[i]), 4 * base,
              f"4x the CPU f32 program's {base:.2e}")


def check_alignment(rng):
    """Pose-alignment normal equations and LM step vs CPU float64."""
    import jax
    import jax.numpy as jnp

    from dsopp_tpu.core.camera import Pinhole
    from dsopp_tpu.core.interpolate import build_pixel_map
    from dsopp_tpu.core.lie import SE3
    from dsopp_tpu.solvers.pose_alignment import (AlignmentOptions,
                                                  LevelPoints,
                                                  _residual_system)

    n = 2000     # frontend points at the standart operating point
    # smooth texture: a sum of sinusoids keeps gradients informative
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH].astype(np.float64)
    image = 128.0
    for _ in range(6):
        fx, fy, ph = rng.uniform(0.02, 0.2), rng.uniform(0.02, 0.2), rng.uniform(0, 6)
        image = image + 15.0 * np.sin(fx * xx + fy * yy + ph)
    image = image.astype(np.float32)
    pts = LevelPoints(
        uv=rng.uniform(20, [WIDTH - 20, HEIGHT - 20], (n, 2)).astype(np.float32),
        idepth=rng.uniform(0.2, 1.0, n).astype(np.float32),
        intensity=rng.uniform(60, 200, n).astype(np.float32),
        valid=np.ones(n, bool))
    xi = np.asarray([0.01, -0.005, 0.02, 0.002, -0.003, 0.001], np.float32)
    opts = AlignmentOptions()

    @jax.jit
    def run(pts, image, cam, xi):
        pm = build_pixel_map(image)
        t = SE3.exp(xi)
        affine = jnp.zeros(2, image.dtype)
        _, _, (h, b) = _residual_system(
            pts, pm, cam, t, affine, affine, jnp.asarray(1.0, image.dtype),
            opts, with_jacobian=True)
        h_d = h + jnp.eye(8, dtype=h.dtype) * (1e-2 * jnp.diagonal(h))[None, :]
        return h, b, -jnp.linalg.solve(h_d, b)

    cam = Pinhole.create((float(WIDTH), float(HEIGHT)), (FOCAL, FOCAL),
                         (WIDTH / 2 - 0.5, HEIGHT / 2 - 0.5), jnp.float32)
    got = run(pts, image, cam, xi)
    with x64():
        want = run(*to_cpu64((pts, image, cam, xi)))
    why = "f32 sums of 2000 products; TF32 inputs would be ~1e-3"
    check("alignment H vs CPU float64, rel. Frobenius", rel_fro(got[0], want[0]),
          1e-4, why)
    check("alignment b vs CPU float64, rel. Frobenius", rel_fro(got[1], want[1]),
          1e-4, why)
    check("alignment step vs CPU float64, rel. Frobenius",
          rel_fro(got[2], want[2]), 1e-3,
          "f32 solve of the damped 8x8 system (affine priors 1e12, 1e8)")


def check_df64(rng):
    """Double-float primitives in f32 on the card against NumPy float64."""
    import jax
    import jax.numpy as jnp

    from dsopp_tpu.core import df64

    n = 1 << 20
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)).astype(np.float32)
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)).astype(np.float32)
    p, e = jax.jit(df64.two_prod)(jnp.asarray(a), jnp.asarray(b))
    exact = a.astype(np.float64) * b.astype(np.float64)   # exact in f64
    pair = np.asarray(p, np.float64) + np.asarray(e, np.float64)
    check("df64 two_prod: max |p + e - a*b| / |a*b|",
          float(np.max(np.abs(pair - exact) / np.abs(exact))), 0.0,
          "an error-free transformation: exact unless a multiply and the "
          "add after it were fused")

    k = 72     # the ledger's [K*8, K*8] at K = 9
    def pair_of(shape):
        hi = rng.standard_normal(shape).astype(np.float32)
        lo = (hi * rng.uniform(-2.0 ** -25, 2.0 ** -25, shape)).astype(np.float32)
        return hi, lo

    (ah, al), (bh, bl) = pair_of((k, k)), pair_of((k, k))
    mh, ml = jax.jit(df64.df_matmul)(*map(jnp.asarray, (ah, al, bh, bl)))
    a64 = ah.astype(np.float64) + al
    b64 = bh.astype(np.float64) + bl
    err = np.abs(np.asarray(mh, np.float64) + np.asarray(ml) - a64 @ b64)
    scale = np.abs(a64) @ np.abs(b64)
    check("df64 df_matmul: max |err| / (|A||B|)", float(np.max(err / scale)),
          k * 2.0 ** -46, "pair precision ~2^-48 per term over k = 72 terms")

    # heavy cancellation: the pair sum must keep what plain f32 loses
    terms = rng.standard_normal((64, 256)).astype(np.float32) * 1e6
    terms[:, -1] = -terms[:, :-1].astype(np.float64).sum(axis=1).astype(np.float32)
    sh, sl = jax.jit(lambda x: df64.df_sum(x, jnp.zeros_like(x), axis=-1))(
        jnp.asarray(terms))
    want = terms.astype(np.float64).sum(axis=1)
    err = np.abs(np.asarray(sh, np.float64) + np.asarray(sl) - want)
    check("df64 df_sum: max |err| / sum|terms|",
          float(np.max(err / np.abs(terms.astype(np.float64)).sum(axis=1))),
          256 * 2.0 ** -46, "pair precision over 256 terms")


def render_corridor():
    """corridor-a: the sequence of phase 2, rendered on the device."""
    from dsopp_tpu.testing import render_sequence

    t0 = time.time()
    seq = render_sequence(num_frames=96, height=HEIGHT, width=WIDTH,
                          focal=FOCAL, seed=7, advance=0.08, backend="jax")
    print(f"rendered corridor-a, 96 frames, in {time.time() - t0:.1f}s",
          flush=True)
    return seq


def phase1(seq):
    print("phase 1: fast layouts and contractions vs plain references",
          flush=True)
    rng = np.random.default_rng(0)
    check_sampling(rng)
    check_alignment(rng)
    check_pba(seq)
    check_df64(rng)


# ---------------------------------------------------------------------------
# Phase 2: the main path through the application entry point
# ---------------------------------------------------------------------------

class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def track_sequence(root, seq, platform, init_frames=8, tracker=None):
    """Write ``seq`` under ``root``, track it through ``app.main`` and score
    it → (ATE stats, device-loop summary dict)."""
    from dsopp_tpu.app.main import main as app_main
    from dsopp_tpu.app.track2trajectory import main as t2t_main
    from dsopp_tpu.output.ate import absolute_trajectory_error
    from dsopp_tpu.output.tum import load_tum
    from dsopp_tpu.testing.dataset import STANDART_TRACKER, write_dataset

    config = write_dataset(root, seq, init_frames,
                           STANDART_TRACKER if tracker is None else tracker)
    track = os.path.join(root, "track.npz")
    traj = os.path.join(root, "trajectory.tum")
    log = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, log)):
        rc = app_main(["--config_file_path", config,
                       "--output_file_path", track,
                       "--track_bin_path", os.path.join(root, "track.bin"),
                       "--platform", platform])
        if rc != 0:
            fail(f"app.main returned {rc}")
        t2t_main([track, traj])
    m = re.search(r"device loop: (\d+) frames, (\d+) keyframes, first tick "
                  r"([\d.]+)s \(includes compile\), steady state ([\d.]+) "
                  r"frames/s", log.getvalue())
    if m is None:
        fail("app.main printed no device-loop summary")
    summary = dict(frames=int(m[1]), keyframes=int(m[2]),
                   first_tick_s=float(m[3]), fps=float(m[4]))
    stats = absolute_trajectory_error(
        load_tum(traj), load_tum(os.path.join(root, "gt_full.tum")),
        with_scale=True)
    return stats, summary


def phase2(seq):
    print("phase 2: corridor-a through app.main at the standart point",
          flush=True)
    with tempfile.TemporaryDirectory() as root:
        stats, s = track_sequence(root, seq, "gpu")
    print(f"  precision policy: {PRECISION_POLICY}")
    print(f"  frames tracked on the device loop: {s['frames']}; keyframes: "
          f"{s['keyframes']}; first tick (compile) {s['first_tick_s']}s; "
          f"steady state {s['fps']} frames/s")
    print(f"  ATE rmse {stats['rmse']!r} m, max {stats['max']!r} m "
          f"(gates 2.2e-2, 3.5e-2)", flush=True)
    if not stats["rmse"] < 2.2e-2:
        fail(f"ATE rmse {stats['rmse']} m")
    if not stats["max"] < 3.5e-2:
        fail(f"ATE max {stats['max']} m")


# ---------------------------------------------------------------------------
# --multi: the sharded paths on four cards
# ---------------------------------------------------------------------------

def phase_multi(count):
    import __graft_entry__ as ge

    print(f"multi: landmark-sharded solver on {count} cards vs device 0 "
          f"(float64, bound 1e-6 relative)", flush=True)
    for name, err in ge._dryrun_sharded_solver(count).items():
        print(f"  {name}: max rel. |d| {err:.3e}", flush=True)
    print(f"multi: sequence-sharded tracker on {count} cards vs unsharded",
          flush=True)
    first, final = ge._dryrun_tracked_segment(count)
    print(f"  poses after one tick: max |d| {first:.3e} "
          f"(bound {ge.FIRST_TICK_TOL:.0e}, f32 rounding)", flush=True)
    print(f"  poses after 20 frames: max |d| {final:.3e} "
          f"(bound {ge.FINAL_POSE_TOL:.0e}, tracking-quality level)",
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)
    count = 4 if args.multi else 1
    devices = phase0(count)
    if args.multi:
        phase_multi(count)
    else:
        seq = render_corridor()
        phase1(seq)
        phase2(seq)
    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
