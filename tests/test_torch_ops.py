"""The port's grid operations (py21cmfast_torch/ops) against the JAX package's.

Same float32 inputs (numpy, seeded) through both.  Tolerance: 1e-6 relative
to the largest magnitude of the JAX result (float32 rounding of transforms
and transcendentals taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py21cmfast_torch.ops import cic as tcic
from py21cmfast_torch.ops import fft as tfft
from py21cmfast_torch.ops import filters as tfilters
from py21cmfast_torch.ops import grids as tgrids
from py21cmfast_tpu.ops import cic as jcic
from py21cmfast_tpu.ops import fft as jfft
from py21cmfast_tpu.ops import filters as jfilters
from py21cmfast_tpu.ops import grids as jgrids

RTOL = 1e-6
SHAPE = (8, 10, 12)
BOX = (10.0, 12.5, 15.0)


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale)


def _field(seed=0, shape=SHAPE):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def test_rfft3_matches_jax():
    x = _field()
    _close(tfft.rfft3(torch.from_numpy(x)).numpy(), jfft.rfft3(jnp.asarray(x)))


def test_irfft3_matches_jax_and_inverts():
    x = _field(1)
    k = np.array(jfft.rfft3(jnp.asarray(x)))
    got = tfft.irfft3(torch.from_numpy(k), SHAPE).numpy()
    _close(got, jfft.irfft3(jnp.asarray(k), SHAPE))
    _close(got, x)


def test_k_grids_match_jax():
    for t, j in zip(tgrids.k_axes(SHAPE, BOX, "cpu"), jgrids.k_axes(SHAPE, BOX)):
        _close(t.numpy(), j)
    _close(tgrids.ksq_grid(SHAPE, BOX, "cpu").numpy(), jgrids.ksq_grid(SHAPE, BOX))
    _close(tgrids.kmag_grid(SHAPE, BOX, "cpu").numpy(), jgrids.kmag_grid(SHAPE, BOX))


@pytest.mark.parametrize("ftype", [tfilters.TOPHAT, tfilters.SHARPK, tfilters.GAUSSIAN])
def test_filter_kbox_matches_jax(ftype):
    """1e-6 relative, except that the tophat's 3 (sin x - x cos x) / x^3
    cancels at small x = kR: there float32 sin/cos of two libraries, each
    within an ulp, differ by up to ~3 eps / x^2 in W, so W may differ by
    12 eps / x^2 as well (measured 3.5e-6 at x = 0.29)."""
    k = np.array(jfft.rfft3(jnp.asarray(_field(2))))
    kmag_t = tgrids.kmag_grid(SHAPE, BOX, "cpu")
    kmag_j = jgrids.kmag_grid(SHAPE, BOX)
    eps = np.finfo(np.float32).eps
    for R in (0.7, 2.3, 6.0):
        got = tfilters.filter_kbox(torch.from_numpy(k), kmag_t, ftype, R).numpy()
        ref = np.asarray(jfilters.filter_kbox(jnp.asarray(k), kmag_j, ftype, R))
        x = np.maximum(kmag_t.double().numpy() * R, 1e-4)
        tol_w = 12 * eps / x**2 if ftype == tfilters.TOPHAT else 0.0
        bound = RTOL * np.abs(ref).max() + tol_w * np.abs(k)
        assert np.all(np.abs(got - ref) <= bound), (R, np.abs(got - ref).max())


def test_unported_filters_raise():
    kmag = tgrids.kmag_grid(SHAPE, BOX, "cpu")
    for ftype in (tfilters.EXP_MFP, tfilters.SHELL):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tfilters.filter_weights(kmag, ftype, 2.0)


@pytest.mark.parametrize("out_shape", [(4, 5, 6), (3, 4, 5), (8, 10, 12)])
def test_subsample_matches_jax(out_shape):
    x = _field(3)
    got = tgrids.subsample(torch.from_numpy(x), out_shape).numpy()
    np.testing.assert_array_equal(got, np.asarray(jgrids.subsample(jnp.asarray(x), out_shape)))


def test_uniform_lerp_matches_jax():
    rng = np.random.default_rng(4)
    table = rng.normal(0, 1, 64).astype(np.float32)
    x = rng.uniform(-1.0, 8.0, (5, 6, 7)).astype(np.float32)  # below, inside and above
    x0, inv_dx = np.float32(0.3), np.float32(9.0)
    got = tgrids.uniform_lerp(torch.from_numpy(x), float(x0), float(inv_dx), torch.from_numpy(table))
    _close(got.numpy(), jgrids.uniform_lerp(jnp.asarray(x), x0, inv_dx, jnp.asarray(table)))


def test_cic_scatter_and_read_match_jax():
    rng = np.random.default_rng(5)
    shape = (5, 6, 7)
    pos = [rng.uniform(-9, 14, 500).astype(np.float32) for _ in range(3)]
    w = rng.uniform(0.5, 1.5, 500).astype(np.float32)
    got = tcic.cic_scatter_flat(
        torch.zeros(int(np.prod(shape))), *(torch.from_numpy(p) for p in pos),
        torch.from_numpy(w), shape,
    )
    ref = jcic.cic_scatter_flat(
        jnp.zeros(int(np.prod(shape)), jnp.float32), *(jnp.asarray(p) for p in pos),
        jnp.asarray(w), shape,
    )
    _close(got.numpy(), ref)
    box = _field(6, shape)
    got_r = tcic.cic_read(torch.from_numpy(box), *(torch.from_numpy(p) for p in pos))
    _close(got_r.numpy(), jcic.cic_read(jnp.asarray(box), *(jnp.asarray(p) for p in pos)))
