"""Per-stage device timing with a roofline account, on an H100.

Each stage is jitted, warmed up, dispatched ``reps`` times and timed up to
``jax.block_until_ready`` on the last result.  Bytes and FLOPs come from
XLA's cost analysis of the compiled stage; the achieved rates are divided
by the card's published peaks (:data:`PEAKS`, keyed by ``device_kind``).
A device that is not in the table is an error.

Run: python scripts/truebench.py [--section ba|align|depth|gather|extract|all]
"""

import argparse
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dsopp_tpu.runtime import enable_compile_cache  # noqa: E402

# device_kind -> (device-memory GB/s, f32 GFLOP/s outside the tensor cores).
# NVIDIA H100 data sheet, dense rates at the full power limit (SXM 700 W,
# PCIe 350 W); the stages run f32 at Precision.HIGHEST, so the f32 rate is
# the compute roof.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (3350.0, 67e3),   # SXM
    "NVIDIA H100 PCIe": (2000.0, 51e3),
}

H, W = 480, 640
K, N, P = 10, 250, 8


def timeit(fn, *args, reps=100, warmup=3):
    """Per-rep wall time (ms) of ``reps`` back-to-back dispatches."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def _cost(fn, *args):
    """(flops, bytes) from XLA cost analysis of the compiled program."""
    try:
        cost = jax.jit(fn).lower(*args).compile().cost_analysis()
        if isinstance(cost, list):
            cost = cost[0]
        return float(cost.get("flops", 0.0)), \
            float(cost.get("bytes accessed", 0.0))
    except Exception:  # noqa: BLE001 — cost analysis is best-effort
        return 0.0, 0.0


def report(name, ms):
    print(f"{name:42s} {ms:8.3f} ms")


def stage(name, fn, *args, reps=100):
    """Roofline-accounted stage report: device ms, bytes moved, achieved
    GB/s and GFLOP/s against the card's peaks, and the BINDING resource —
    'memory' or 'compute' when either exceeds 20% of its peak, else
    'latency/serial'.
    """
    peak_gbs, peak_gflops = PEAKS[jax.devices()[0].device_kind]
    jitted = jax.jit(fn)
    ms = timeit(jitted, *args, reps=reps)
    flops, nbytes = _cost(fn, *args)
    if nbytes:
        gbs = nbytes / (ms * 1e-3) / 1e9
        gflops = flops / (ms * 1e-3) / 1e9
        mem_pct = 100.0 * gbs / peak_gbs
        flop_pct = 100.0 * gflops / peak_gflops
        binding = ("memory" if mem_pct >= max(flop_pct, 20.0) else
                   "compute" if flop_pct >= 20.0 else "latency/serial")
        print(f"{name:42s} {ms:8.3f} ms  {nbytes/1e6:8.1f} MB "
              f"{gbs:7.1f} GB/s ({mem_pct:4.1f}% mem) "
              f"{gflops:8.1f} GFLOP/s ({flop_pct:4.1f}% f32) -> {binding}")
    else:
        print(f"{name:42s} {ms:8.3f} ms  (cost analysis unavailable)")
    return ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--section", default="all")
    args = ap.parse_args()
    kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        sys.exit(f"truebench.py: no peak rates for device {kind!r}; "
                 f"known: {sorted(PEAKS)}")
    enable_compile_cache()
    print(f"device: {kind}")
    rng = np.random.default_rng(0)

    from dsopp_tpu.core.camera import Pinhole
    from dsopp_tpu.core.lie import SE3

    cam = Pinhole.create((float(W), float(H)), (520.0, 520.0),
                         (W / 2 - 0.5, H / 2 - 0.5), jnp.float32)

    tiny = jnp.ones((8, 128), jnp.float32)
    base = timeit(jax.jit(lambda x: x * 2.0), tiny)
    report("dispatch baseline (tiny op)", base)

    if args.section in ("gather", "all"):
        from dsopp_tpu.ops import sample_packed

        HW = H * W
        packed = jnp.asarray(rng.standard_normal((K, HW, 12)), jnp.float32)
        uv = jnp.asarray(rng.uniform(1, 400, (K, K, N, P, 2)), jnp.float32)
        prod = lambda pk, u: jax.vmap(
            lambda p_, u_: sample_packed(p_, u_, H, W),
            in_axes=(0, 1), out_axes=1)(pk, u)
        stage("vmapped sample_packed [K,K,N,P]", prod, packed, uv)

        idx = jnp.asarray(rng.integers(0, HW - W - 2, K * K * N * P), jnp.int32)
        stage("flat row take 200k x12",
              lambda t, i: jnp.take(t, i, axis=0), packed[0], idx)

    if args.section in ("ba", "all"):
        import dataclasses

        from dsopp_tpu.core.reproject import reproject, reproject_jacobian
        from dsopp_tpu.solvers.pba import (
            PBAOptions, _energy, _fej_cache, _linearize, _solve_loop_device,
            active_lm_mask, empty_window)

        uvp = jnp.asarray(rng.uniform(8, 400, (K, 1, N, P, 2)), jnp.float32)
        idp = jnp.asarray(rng.uniform(0.2, 2.0, (K, 1, N, 1)), jnp.float32)
        q4 = jnp.broadcast_to(jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                              (K, K, 1, 1, 4))
        t3 = jnp.asarray(rng.normal(0, 0.1, (K, K, 1, 1, 3)), jnp.float32)
        stage("reproject_jacobian [K,K,N,P]",
              lambda u, d, tq, tt: reproject_jacobian(
                  cam, cam, u, d, SE3(tq, tt)), uvp, idp, q4, t3)
        stage("reproject [K,K,N,P]",
              lambda u, d, tq, tt: reproject(
                  cam, cam, u, d, SE3(tq, tt)), uvp, idp, q4, t3)

        img = jnp.asarray(rng.standard_normal((H, W)) * 40 + 128, jnp.float32)
        win = empty_window(K, N, (3, H, W), jnp.float32)
        win = dataclasses.replace(
            win,
            t_lin_t=jnp.asarray(rng.normal(0, 0.3, (K, 3)), jnp.float32),
            frame_valid=jnp.ones(K, bool).at[-1:].set(False),
            frame_fixed=jnp.zeros(K, bool).at[0].set(True),
            frame_id=jnp.arange(K, dtype=jnp.int32),
            lm_uv=jnp.asarray(rng.uniform((8, 8), (W - 9, H - 9), (K, N, 2)),
                              jnp.float32),
            lm_patch=jnp.asarray(rng.uniform(60, 200, (K, N, P)), jnp.float32),
            lm_idepth=jnp.asarray(rng.uniform(0.2, 2.0, (K, N)), jnp.float32),
            lm_valid=jnp.ones((K, N), bool),
            maps=jnp.broadcast_to(jnp.stack([img, img * 0.1, img * 0.1]),
                                  (K, 3, H, W)).astype(jnp.float32) + 0.0,
        )
        from dsopp_tpu.ops.patch import pack_patch_table

        win = dataclasses.replace(
            win, patch=jnp.broadcast_to(
                pack_patch_table(img), (K,) + pack_patch_table(img).shape
            ).astype(jnp.float32) + 0.0)
        popts = PBAOptions()
        mask = active_lm_mask(win)
        fj = lambda w_: _fej_cache(w_, cam)
        stage("FEJ cache", fj, win, reps=50)
        fej = jax.jit(fj)(win)
        stage("linearize (evaluate+systems)",
              lambda w_, f_: _linearize(
                  w_, cam, f_, w_.eps, w_.lm_idepth, mask, popts),
              win, fej, reps=50)
        stage("energy pass",
              lambda w_: _energy(w_, cam, w_.eps, w_.lm_idepth, mask, popts),
              win, reps=50)
        stage("PBA solve loop (7 it)",
              lambda w_: _solve_loop_device(w_, cam, popts), win, reps=20)

    if args.section in ("align", "all"):
        from dsopp_tpu.solvers.pose_alignment import (
            AlignmentOptions, LevelPoints, _residual_system, align_level)

        img = jnp.asarray(rng.standard_normal((H, W)) * 40 + 128, jnp.float32)
        from dsopp_tpu.features.pyramid import build_pyramid_maps

        maps0 = jax.jit(lambda im: build_pyramid_maps(im, 5))(img)[0]
        NPTS, NHYP = 2000, 5
        pts = LevelPoints(
            uv=jnp.asarray(rng.uniform((8, 8), (W - 9, H - 9), (NPTS, 2)),
                           jnp.float32),
            idepth=jnp.asarray(rng.uniform(0.2, 2.0, NPTS), jnp.float32),
            intensity=jnp.asarray(rng.uniform(60, 200, NPTS), jnp.float32),
            valid=jnp.ones(NPTS, bool))
        opts = AlignmentOptions()
        tq = jnp.tile(jnp.asarray([1.0, 0, 0, 0], jnp.float32), (NHYP, 1))
        tt = jnp.asarray(rng.normal(0, 0.01, (NHYP, 3)), jnp.float32)
        ab = jnp.zeros((NHYP, 2), jnp.float32)
        stage("align_level L0 (2000x5 LM loop)",
              jax.vmap(lambda q, t, a: align_level(
                  pts, maps0, cam, SE3(q, t), a, jnp.zeros(2, jnp.float32),
                  1.0, opts)), tq, tt, ab, reps=50)
        stage("align_level L0 single-lane (2000x1)",
              lambda q, t, a: align_level(
                  pts, maps0, cam, SE3(q, t), a, jnp.zeros(2, jnp.float32),
                  1.0, opts), tq[0], tt[0], ab[0], reps=50)
        stage("one GN system (2000x5)",
              jax.vmap(lambda q, t, a: _residual_system(
                  pts, maps0, cam, SE3(q, t), a, jnp.zeros(2, jnp.float32),
                  1.0, opts, True)), tq, tt, ab)

    if args.section in ("depth", "all"):
        from dsopp_tpu.features.pyramid import build_pyramid_maps
        from dsopp_tpu.tracker.depth_estimation import (
            estimate_depths, make_immature_points)

        img = jnp.asarray(rng.standard_normal((H, W)) * 40 + 128, jnp.float32)
        maps0 = jax.jit(lambda im: build_pyramid_maps(im, 5))(img)[0]
        NIMM = 800
        uvi = jnp.asarray(rng.uniform((8, 8), (W - 9, H - 9), (K, NIMM, 2)),
                          jnp.float32)
        patches = jnp.asarray(rng.uniform(60, 200, (K, NIMM, 8)), jnp.float32)
        grads = jnp.asarray(rng.normal(0, 10, (K, NIMM, 2)), jnp.float32)
        bank = jax.vmap(lambda u, p, g: make_immature_points(u, p, g))(
            uvi, patches, grads)
        t_rel_q = jnp.tile(jnp.asarray([1.0, 0, 0, 0], jnp.float32), (K, 1))
        t_rel_t = jnp.asarray(rng.normal(0, 0.05, (K, 3)), jnp.float32)
        affines = jnp.zeros((K, 2), jnp.float32)
        stage("estimate_depths (10x800x32)",
              jax.vmap(lambda b, trq, trt, af: estimate_depths(
                  b, maps0, cam, SE3(trq, trt), af, jnp.zeros(2, jnp.float32),
                  1.0, 20.0, 32)),
              bank, t_rel_q, t_rel_t, affines, reps=50)

    if args.section in ("extract", "all"):
        from dsopp_tpu.features.extractor import select_candidates
        from dsopp_tpu.features.pyramid import build_pyramid_maps

        img = jnp.asarray(rng.standard_normal((H, W)) * 40 + 128, jnp.float32)
        pm = jax.jit(lambda im: build_pyramid_maps(im, 5))(img)[0]
        stage("select_candidates (800)",
              lambda m: select_candidates(m, 800), pm, reps=50)


if __name__ == "__main__":
    main()
