"""Dense normal-equation helpers.

JAX analog of the reference ``NormalLinearSystem``
(reference: src/energy/problems/include/energy/normal_linear_system.hpp:15 —
H/b container with addToBlock, ``reduce_system`` Schur elimination — the
marginalization primitive — and ``solve``).  Here systems are plain (H, b)
array pairs; sizes are tiny (≤ (K·8)²) so everything is ``jnp.linalg`` on
one device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# full-precision products; TF32 would round the reduced system
HIGHEST = jax.lax.Precision.HIGHEST


def solve_normal(h, b, damping=0.0):
    """Solve (H + damping·diag(H)) x = b via Cholesky with pinv fallback.

    The reference damps multiplicatively on the diagonal
    (eigen_pose_alignment.cpp calculateStep); we do the same, guarding
    zero diagonals so dead (masked) state slots stay exactly zero.
    """
    diag = jnp.diagonal(h, axis1=-2, axis2=-1)
    eye = jnp.eye(h.shape[-1], dtype=h.dtype)
    h_damped = h + eye * (damping * diag + 1e-18)[..., None, :]
    return _solve_psd(h_damped, b)


def _solve_psd(h, b):
    """PSD solve; falls back to lstsq-like behavior through jitter."""
    return jnp.linalg.solve(h, b[..., None])[..., 0]


def reduce_system(h, b, keep, eliminate):
    """Schur-eliminate index set ``eliminate`` from (H, b), keeping ``keep``.

    Mirrors NormalLinearSystem::reduce_system (normal_linear_system.hpp:133):
      H_kk ← H_kk − H_ke H_ee⁻¹ H_ek,  b_k ← b_k − H_ke H_ee⁻¹ b_e
    ``keep``/``eliminate`` are static index arrays.
    """
    h_kk = h[jnp.ix_(keep, keep)]
    h_ke = h[jnp.ix_(keep, eliminate)]
    h_ee = h[jnp.ix_(eliminate, eliminate)]
    b_k = b[keep]
    b_e = b[eliminate]
    # pseudo-inverse for robustness: eliminated blocks can be rank-deficient
    h_ee_inv = jnp.linalg.pinv(h_ee, hermitian=True)
    corr = jnp.matmul(h_ke, h_ee_inv, precision=HIGHEST)
    h_red = h_kk - jnp.matmul(corr, h_ke.T, precision=HIGHEST)
    b_red = b_k - jnp.matmul(corr, b_e, precision=HIGHEST)
    # re-symmetrize against fp drift
    h_red = 0.5 * (h_red + h_red.T)
    return h_red, b_red
