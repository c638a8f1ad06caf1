"""Every f32 contraction on the tracker path states its precision.

On a GPU, XLA runs float32 dots and convolutions with TF32 inputs (about 10
mantissa bits) unless the operation says otherwise.  These tests trace the
precision-sensitive programs and require ``Precision.HIGHEST`` on every
``dot_general`` and ``conv_general_dilated`` they contain.
"""

import dataclasses

import jax
import jax.extend.core
import jax.numpy as jnp
import numpy as np
import pytest

from __graft_entry__ import _tiny_problem
from dsopp_tpu.core.camera import Pinhole
from dsopp_tpu.core.interpolate import build_pixel_map, sample
from dsopp_tpu.core.lie import SE3
from dsopp_tpu.solvers.pba import (PBAOptions, _fej_cache, _linearize,
                                   _marginalize_device, _pba_iteration,
                                   active_lm_mask)
from dsopp_tpu.solvers.pose_alignment import (AlignmentOptions, LevelPoints,
                                              _residual_system)

HIGHEST = jax.lax.Precision.HIGHEST
CONTRACTIONS = ("dot_general", "conv_general_dilated")


def _eqns(jaxpr):
    """All equations of a jaxpr, sub-jaxprs (jit, while, cond, scan) included."""
    for eqn in jaxpr.eqns:
        yield eqn
        for param in eqn.params.values():
            for sub in (param if isinstance(param, (list, tuple)) else [param]):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    yield from _eqns(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    yield from _eqns(sub)


def contraction_precisions(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    out = []
    for eqn in _eqns(jaxpr.jaxpr):
        if eqn.primitive.name in CONTRACTIONS:
            prec = eqn.params["precision"]
            out.append(prec if isinstance(prec, tuple) else (prec, prec))
    return out


def _window():
    return _tiny_problem(jnp.float32, slots=4, landmarks=32, size=32)


def _alignment_system():
    rng = np.random.default_rng(0)
    cam = Pinhole.create((48.0, 32.0), (40.0, 40.0), (24.0, 16.0),
                         jnp.float32)
    pts = LevelPoints(
        uv=jnp.asarray(rng.uniform(8, [40, 24], (64, 2)), jnp.float32),
        idepth=jnp.full((64,), 0.5, jnp.float32),
        intensity=jnp.asarray(rng.uniform(60, 200, 64), jnp.float32),
        valid=jnp.ones(64, bool))
    pm = build_pixel_map(jnp.asarray(rng.uniform(0, 255, (32, 48)),
                                     jnp.float32))
    t = SE3.exp(jnp.asarray([0.01, 0, 0, 0, 0, 0], jnp.float32))
    zero = jnp.zeros(2, jnp.float32)

    def fn(pts, pm, t, affine):
        return _residual_system(pts, pm, cam, t, affine, zero,
                                jnp.asarray(1.0, jnp.float32),
                                AlignmentOptions(), with_jacobian=True)[2]

    return fn, (pts, pm, t, zero)


def _pba_hessian():
    window, cam = _window()

    def fn(window):
        fej = _fej_cache(window, cam)
        return _linearize(window, cam, fej, window.eps, window.lm_idepth,
                          active_lm_mask(window), PBAOptions())

    return fn, (window,)


def _pba_step():
    window, cam = _window()

    def fn(window):
        fej = _fej_cache(window, cam)
        return _pba_iteration(window, cam, fej, window.eps, window.lm_idepth,
                              active_lm_mask(window),
                              jnp.asarray(1e-5, jnp.float32), PBAOptions())

    return fn, (window,)


def _ledger_fold():
    window, cam = _window()
    flags = jnp.zeros(window.frame_valid.shape, bool).at[1].set(True)
    window = dataclasses.replace(window, frame_marg=flags,
                                 lm_marg_flag=window.lm_valid & flags[:, None])
    perm = jnp.asarray([0, 2, 3, 1], jnp.int32)

    def fn(window):
        return _marginalize_device(window, cam, perm, PBAOptions(), True, True)

    return fn, (window,)


def _plain_sampler():
    pm = jnp.ones((3, 16, 16), jnp.float32)
    return (lambda pm, uv: sample(pm, uv)[0],
            (pm, jnp.full((5, 2), 3.5, jnp.float32)))


def _packed_sampler():
    from dsopp_tpu.ops import pack_corners, sample_packed

    pm = jnp.ones((3, 16, 16), jnp.float32)
    return (lambda pm, uv: sample_packed(pack_corners(pm), uv, 16, 16)[0],
            (pm, jnp.full((5, 2), 3.5, jnp.float32)))


def _embedder():
    from dsopp_tpu.features.embedder import FilterBankEmbedder

    return FilterBankEmbedder(), (jnp.ones((16, 16), jnp.float32),)


def _adjoint():
    return (lambda q, t: SE3(q, t).adjoint(),
            (jnp.asarray([1.0, 0, 0, 0], jnp.float32),
             jnp.ones(3, jnp.float32)))


def _pose_covariances():
    from dsopp_tpu.solvers.pba import pose_covariances

    window, cam = _window()
    return (lambda w: pose_covariances(w, cam)), (window,)


@pytest.mark.parametrize("build", [
    _alignment_system, _pba_hessian, _pba_step, _ledger_fold,
    _plain_sampler, _packed_sampler, _embedder, _adjoint,
    _pose_covariances,
], ids=lambda b: b.__name__.lstrip("_"))
def test_contractions_at_highest(build):
    fn, args = build()
    precisions = contraction_precisions(fn, *args)
    assert precisions, "expected at least one contraction"
    assert all(p == (HIGHEST, HIGHEST) for p in precisions), precisions


@pytest.mark.parametrize("pack", ["patch", "nbhd"])
def test_packed_tables_have_no_contraction(pack):
    """The window tables are copies: no contraction can round them."""
    from dsopp_tpu.ops.nbhd import pack_neighborhood
    from dsopp_tpu.ops.patch import pack_patch_table

    fn = {"patch": pack_patch_table, "nbhd": pack_neighborhood}[pack]
    assert contraction_precisions(fn, jnp.ones((16, 16), jnp.float32)) == []
