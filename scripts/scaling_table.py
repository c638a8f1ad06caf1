"""Sharded-solver scaling smoke on the virtual CPU mesh.

Measures the STRUCTURE of the distributed BA step — how wall time changes
as the landmark axis shards over 1..8 virtual CPU devices — to verify the
collective pattern (psum'd Hessian/Schur over ``lm``) adds bounded
overhead rather than serializing.  CPU timings do NOT predict scaling
across GPUs; they bound the partitioner/collective overhead.

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     JAX_PLATFORMS=cpu python scripts/scaling_table.py
"""

import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "graft_entry",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "__graft_entry__.py"))
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)

    from dsopp_tpu.parallel.mesh import make_mesh
    from dsopp_tpu.parallel.sharded import (batched_train_step, shard_windows,
                                            stack_windows)
    from dsopp_tpu.solvers.pba import PBAOptions

    opts = PBAOptions()
    reg = jnp.asarray(1e-5, jnp.float32)
    win, cam = graft._tiny_problem(landmarks=256, size=64)
    stacked = stack_windows([win])

    print("| lm shards | step ms | vs 1 |")
    print("|---|---|---|")
    base = None
    for n_lm in (1, 2, 4, 8):
        mesh = make_mesh(1, n_lm)
        sharded = shard_windows(stacked, mesh)
        with mesh:
            f = jax.jit(lambda w: batched_train_step(w, cam, reg, opts))
            out = f(sharded)
            jax.block_until_ready(out)
            t0 = time.time()
            for _ in range(20):
                out = f(sharded)
            jax.block_until_ready(out)
            ms = (time.time() - t0) / 20 * 1e3
        if base is None:
            base = ms
        print(f"| {n_lm} | {ms:.2f} | {ms/base:.2f}x |")


if __name__ == "__main__":
    main()
