"""The port's initial conditions (py21cmfast_torch/models/ics.py) against the
JAX package's, at golden size (HII_DIM=24, DIM=72, BOX_LEN=36).

The two packages draw their white noise from different generators, so the
parity runs hand both the same hires density (made with numpy from a seed)
through `initial_density=`.  Tolerance: max-abs <= 1e-5 max|field| (float32
FFTs and the float32 tophat taken by two libraries).
"""

import numpy as np
import pytest
import torch

import py21cmfast_torch as t21
from py21cmfast_torch.models import ics as tics
from py21cmfast_tpu.inputs import InputParameters
from py21cmfast_tpu.models import ics as jics
from py21cmfast_tpu.ops import ps

GOLDEN = dict(HII_DIM=24, DIM=72, BOX_LEN=36.0, ZPRIME_STEP_FACTOR=1.25, Z_HEAT_MAX=25.0,
              SOURCE_MODEL="E-INTEGRAL")
FIELDS = ["lowres_density", "vx", "vy", "vz", "vx_2LPT", "vy_2LPT", "vz_2LPT"]


def numpy_grf(inputs, seed):
    """A z=0 Gaussian density with the inputs' P(k), from numpy white noise."""
    so = inputs.simulation_options
    shape, lens = so.hires_shape, so.box_lens
    white = np.random.default_rng(seed).standard_normal(shape)
    kx, ky = (np.fft.fftfreq(n) * n * 2 * np.pi / L for n, L in zip(shape[:2], lens[:2]))
    kz = np.fft.rfftfreq(shape[2]) * shape[2] * 2 * np.pi / lens[2]
    k = np.sqrt(kx[:, None, None] ** 2 + ky[None, :, None] ** 2 + kz[None, None, :] ** 2)
    amp = np.zeros_like(k)
    amp[k > 0] = np.sqrt(inputs.cosmology.power_in_k(k[k > 0]) * np.prod(shape) / np.prod(lens))
    return np.fft.irfftn(np.fft.rfftn(white) * amp, s=shape).astype(np.float32)


def jax_inputs(seed=1234, **over):
    return InputParameters(random_seed=seed).evolve_input_structs(**{**GOLDEN, **over})


def port_inputs(jinp):
    """The port's InputParameters for the JAX package's, carried by interop."""
    import attrs

    d = {g: attrs.asdict(getattr(jinp, g)) for g in
         ("cosmo_params", "matter_options", "simulation_options", "astro_options", "astro_params")}
    return t21.interop.inputs_from_dict(
        {**d, "random_seed": jinp.random_seed, "node_redshifts": jinp.node_redshifts}
    )


def _assert_field_close(got, ref, name):
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= 1e-5 * scale, f"{name}: max-abs {err:.3e} > 1e-5 x {scale:.3e}"


@pytest.fixture(scope="module")
def shared():
    jinp = jax_inputs()
    dens = numpy_grf(jinp, seed=5)
    j = jics.compute_initial_conditions(jinp, initial_density=dens)
    t = tics.compute_initial_conditions(port_inputs(jinp), initial_density=dens, device="cpu")
    return j, t


def test_interop_inputs_hash_alike():
    jinp = jax_inputs(seed=99)
    assert port_inputs(jinp).full_hash == jinp.full_hash


@pytest.mark.parametrize("name", FIELDS)
def test_ics_from_shared_density_match_jax(shared, name):
    j, t = shared
    assert isinstance(getattr(t, name), torch.Tensor)
    _assert_field_close(getattr(t, name).numpy(), getattr(j, name), name)


def test_truncated_2lpt_matches_jax(monkeypatch):
    """Above its cell threshold the JAX package takes the 2LPT source from a
    spectrally truncated d_k; the port keeps the same rule, checked here with
    the threshold lowered in both packages (truncation to 48^3 of 72^3)."""
    assert (tics._2LPT_MAX_INHBM_CELLS, tics._2LPT_TRUNC_DIM) == (
        jics._2LPT_MAX_INHBM_CELLS, jics._2LPT_TRUNC_DIM)
    for mod in (tics, jics):
        monkeypatch.setattr(mod, "_2LPT_MAX_INHBM_CELLS", 1)
        monkeypatch.setattr(mod, "_2LPT_TRUNC_DIM", 48)
    jinp = jax_inputs()
    dens = numpy_grf(jinp, seed=6)
    j = jics.compute_initial_conditions(jinp, initial_density=dens)
    t = tics.compute_initial_conditions(port_inputs(jinp), initial_density=dens, device="cpu")
    for name in ("vx_2LPT", "vy_2LPT", "vz_2LPT"):
        _assert_field_close(getattr(t, name).numpy(), getattr(j, name), name)


def test_seeded_ics_recover_input_power():
    """As tests/test_ics.py: the port's own seeded hires density recovers the
    input P(k) within cosmic variance (5 sigma per bin, at least 5%)."""
    inp = t21.InputParameters(random_seed=42).evolve_input_structs(HII_DIM=32, DIM=96, BOX_LEN=96.0)
    so = inp.simulation_options
    ics = t21.compute_initial_conditions(inp, device="cpu")
    k, pk, counts = ps.power_spectrum_1d(ics.hires_density.numpy(), so.box_lens, n_bins=12)
    good = counts > 200
    ratio = pk[good] / inp.cosmology.power_in_k(k[good])
    tol = 5 * np.sqrt(2.0 / counts[good])
    assert np.all(np.abs(ratio - 1) < np.maximum(tol, 0.05)), ratio


def test_same_seed_gives_identical_fields():
    inp = t21.InputParameters(random_seed=3).evolve_input_structs(
        HII_DIM=8, DIM=24, BOX_LEN=16.0, SOURCE_MODEL="E-INTEGRAL")
    a = tics.compute_initial_conditions(inp, device="cpu").to_numpy()
    b = tics.compute_initial_conditions(inp, device="cpu").to_numpy()
    c = tics.compute_initial_conditions(
        inp.evolve_input_structs(random_seed=4), device="cpu").to_numpy()
    for name, v in a.items():
        if v is not None:
            np.testing.assert_array_equal(v, b[name])
    assert not np.array_equal(a["hires_density"], c["hires_density"])


def test_truncate_dk_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(8)
    hi, tr = (16, 12, 20), (8, 6, 10)
    dk = (rng.normal(size=(16, 12, 11)) + 1j * rng.normal(size=(16, 12, 11))).astype(np.complex64)
    got = tics._truncate_dk(torch.from_numpy(dk), hi_shape=hi, trunc_shape=tr).numpy()
    ref = np.asarray(jics._truncate_dk(jnp.asarray(dk), hi_shape=hi, trunc_shape=tr))
    np.testing.assert_array_equal(got, ref)
