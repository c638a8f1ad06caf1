"""Device-mesh construction for distributed bundle adjustment.

The reference is a single-process CPU pipeline (SURVEY §2.8: oneTBB only).
The scaling axes replacing its thread pool are:

* ``seq``  — data parallelism over independent camera sequences (batched
  multi-sequence tracking; each sequence's window is independent);
* ``lm``   — model parallelism over landmark slots: residual/Jacobian
  evaluation and Hessian/Schur accumulation shard over landmarks, reduced
  with ``psum`` over the device interconnect (the analog of the reference's mutex-merged TBB
  accumulators, hessian_block_evaluation.hpp:102-246).

The (K·8)² pose system is tiny and solved replicated on every device.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

SEQ_AXIS = "seq"
LM_AXIS = "lm"


def make_mesh(num_seq: int = 1, num_lm: int = 0, devices=None) -> Mesh:
    """Mesh over (seq, lm).  ``num_lm`` = 0 → use all remaining devices."""
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if num_lm == 0:
        num_lm = n // num_seq
    assert num_seq * num_lm <= n, (num_seq, num_lm, n)
    grid = np.asarray(devices[: num_seq * num_lm]).reshape(num_seq, num_lm)
    return Mesh(grid, (SEQ_AXIS, LM_AXIS))


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None):
    """Multi-host runtime bring-up (jax.distributed).

    Call once per host before any device use.  With no arguments the
    environment-based auto-detection is used (cluster launchers set the
    variables);
    a no-op when already initialized or single-process.
    """
    if jax.process_count() > 1:
        return  # already initialized
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id)
    except (ValueError, RuntimeError):
        pass  # single-process / already initialized


def make_hybrid_mesh(num_seq: int = 0, num_lm: int = 0) -> Mesh:
    """(seq, lm) mesh laid out so that the ``lm`` axis (which carries the
    per-iteration psum of partial Hessians) stays within each host's
    devices (NVLink between GPUs), and the ``seq`` axis (independent
    sequences — no per-iteration traffic) spans hosts over the network.

    Single-process fallback: a plain :func:`make_mesh`.
    """
    n_proc = jax.process_count()
    if n_proc == 1:
        return make_mesh(max(num_seq, 1), num_lm)

    from jax.experimental import mesh_utils

    local = jax.local_device_count()
    if num_lm == 0:
        num_lm = local
    if num_seq == 0:
        num_seq = (n_proc * local) // num_lm
    mesh_shape = (num_seq // n_proc if num_seq >= n_proc else 1, num_lm)
    dcn_shape = (n_proc if num_seq >= n_proc else num_seq, 1)
    try:
        grid = mesh_utils.create_hybrid_device_mesh(
            mesh_shape=mesh_shape, dcn_mesh_shape=dcn_shape)
    except ValueError:
        # no slice topology (e.g. multi-process CPU or GPU):
        # group by process instead — each process is one DCN granule
        grid = mesh_utils.create_hybrid_device_mesh(
            mesh_shape=mesh_shape, dcn_mesh_shape=dcn_shape,
            process_is_granule=True)
    return Mesh(grid, (SEQ_AXIS, LM_AXIS))
