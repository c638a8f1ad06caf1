"""Double-float ("df") arithmetic: near-double precision from float32 pairs.

The device path runs in float32: the whole program stays in one dtype
(no x64 mode, which would widen every default), and a GPU's float64 rate
is a small fraction of its float32 rate.  The reference deliberately keeps
its marginalization ledger in double (``system_marginalized_``,
reference: src/energy/problems/include/energy/problems/
photometric_bundle_adjustment/eigen_photometric_bundle_adjustment_problem.hpp:147-203)
because the ledger accumulates hundreds of Schur folds over a run and the
``b -= H·state`` rebasing cancels catastrophically in single precision.

The float32 equivalent is an unevaluated pair ``hi + lo`` with
``|lo| <= ulp(hi)/2`` (a "double-float"), using the classic error-free
transformations:

* ``two_sum``  (Knuth 1969)  — exact error of a float add,
* ``two_prod`` (Dekker 1971) — exact error of a float multiply via
  26/12-bit splitting (no FMA dependency),

composed into compensated vector/matrix ops.  All ledger matrices here are
tiny ([K·8, K·8] ≤ 72×72), so the ~10× flop overhead is invisible next to
the [K,K,N,P] residual kernels; what matters is that the pair arithmetic
is elementwise f32 work on the device, with no host round-trips and no x64
flag.

The transformations are exact only if every multiply and the add after it
round separately: a compiler that fuses them into one FMA breaks Dekker's
split.  ``chip_smoke.py`` checks ``two_prod`` for exactness on the GPU.

All functions operate on (hi, lo) array pairs of equal shape.  The same code
runs in float64 pairs under the CPU x64 oracle, where it is effectively
quad-precision — the cross-precision drift test in
tests/core/test_df64.py (test_ledger_drift_pairs_beat_plain_f32) exploits
that, and tests/tracker/test_ledger_drift_tracker.py gates pose drift of the
f32+df64 tracker path against the CPU-x64 oracle over a long sequence.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "two_sum", "two_prod", "df_add", "df_add_flat", "df_neg", "df_scale",
    "df_sum", "df_dot", "df_matvec", "df_matmul", "df_take", "value",
]


def two_sum(a, b):
    """Error-free float add: returns (s, e) with s = fl(a+b), a+b = s+e exactly."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def _split(a):
    """Dekker split of a float into two non-overlapping halves (no FMA)."""
    a = jnp.asarray(a)
    # 2^13 + 1 for float32 (24-bit mantissa), 2^27 + 1 for float64 (53-bit).
    c = jnp.asarray(134217729.0 if a.dtype == jnp.float64 else 8193.0, a.dtype)
    t = c * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free float multiply: (p, e) with p = fl(a*b), a*b = p+e exactly."""
    p = a * b
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def df_add(x_hi, x_lo, y_hi, y_lo):
    """Pair + pair → normalized pair (Dekker add2)."""
    s, e = two_sum(x_hi, y_hi)
    e = e + x_lo + y_lo
    hi, lo = two_sum(s, e)
    return hi, lo


def df_add_flat(x_hi, x_lo, y):
    """Pair + plain float array → normalized pair."""
    s, e = two_sum(x_hi, y)
    hi, lo = two_sum(s, e + x_lo)
    return hi, lo


def df_neg(x_hi, x_lo):
    return -x_hi, -x_lo


def df_scale(x_hi, x_lo, a):
    """Pair × plain scalar/array (elementwise) → normalized pair."""
    # coerce python scalars to the pair dtype: jnp.asarray(0.5) inside
    # _split would otherwise become float64 under the x64 oracle and
    # silently promote an f32 ledger
    a = jnp.asarray(a, x_hi.dtype)
    p, pe = two_prod(x_hi, a)
    hi, lo = two_sum(p, pe + x_lo * a)
    return hi, lo


def df_sum(x_hi, x_lo, axis):
    """Compensated reduction of a pair array along ``axis`` → pair.

    Sequential two_sum accumulation via ``lax.scan`` over the reduced axis —
    the axis lengths here are ≤ a few hundred, so the scan is cheap and the
    result is exact to pair precision regardless of term cancellation.
    """
    xh = jnp.moveaxis(x_hi, axis, 0)
    xl = jnp.moveaxis(x_lo, axis, 0)

    def step(carry, term):
        acc_hi, acc_lo = carry
        t_hi, t_lo = term
        hi, lo = df_add(acc_hi, acc_lo, t_hi, t_lo)
        return (hi, lo), None

    init = (jnp.zeros_like(xh[0]), jnp.zeros_like(xl[0]))
    (hi, lo), _ = jax.lax.scan(step, init, (xh, xl))
    return hi, lo


def df_dot(x_hi, x_lo, y):
    """Compensated dot(pair vector, plain vector) → scalar pair."""
    p_hi, p_lo = two_prod(x_hi, y)
    p_lo = p_lo + x_lo * y
    return df_sum(p_hi, p_lo, axis=-1)


def df_matvec(m_hi, m_lo, v):
    """Pair matrix [..., n, k] @ plain vector [k] → pair [..., n]."""
    p_hi, p_lo = two_prod(m_hi, v)
    p_lo = p_lo + m_lo * v
    return df_sum(p_hi, p_lo, axis=-1)


def df_matmul(a_hi, a_lo, b_hi, b_lo):
    """Pair matrix product [n,k]×[k,m] → pair [n,m] (compensated over k)."""
    ah = a_hi[:, :, None]
    al = a_lo[:, :, None]
    bh = b_hi[None, :, :]
    bl = b_lo[None, :, :]
    p_hi, p_lo = two_prod(ah, bh)
    p_lo = p_lo + ah * bl + al * bh
    return df_sum(p_hi, p_lo, axis=1)


def df_take(x_hi, x_lo, idx, axis=0):
    return jnp.take(x_hi, idx, axis=axis), jnp.take(x_lo, idx, axis=axis)


def value(x_hi, x_lo, dtype=None):
    """Collapse a pair to a plain array (hi already carries the rounding)."""
    out = x_hi + x_lo
    return out if dtype is None else out.astype(dtype)
