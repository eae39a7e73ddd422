"""The port's RSDs (py21cmfast_torch/rsds.py) against the device path of the
JAX package's (py21cmfast_tpu/rsds.py), and the Ts + INHOMOGENEOUS lightcone
(the tau_21 branch of the velocity-gradient correction) against JAX
run_lightcone, on the CPU at golden size.

Tolerances:
  _gradient_last_axis           max-abs <= 1e-5 max|gradient| (float32; the
      periodic form goes through two FFT libraries);
  include_dvdr_in_tau21         max-abs <= 1e-5 max|Tb| against the JAX device
      path (jax arrays in) and <= 1e-4 max|Tb| against its float64 numpy
      path, with and without tau_21;
  rsds_shift, apply_rsds        max-abs <= 1e-5 max|field|, periodic or not,
      1-4 sub-cells; and the three properties of tests/test_lightcone.py:50-72
      (mass conserved, zero shift is the identity, a one-pixel shift rolls);
  the Ts + INHOMOGENEOUS lightcone (5 nodes, z=27.1 -> 10.5; one JAX chain in
      this file, from one numpy hires density)   the gates of
      tests/test_golden.py:32-45, at most 1e-3 of the cells of each cone
      differ by more than 1e-3 of its maximum, global quantities per node
      within 1e-3 (xH) and 1e-3 max|Tb|.
"""

import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ics import jax_inputs, numpy_grf, port_inputs
from test_torch_lightcone import assert_cone_share

import py21cmfast_tpu as j21
import py21cmfast_torch as t21
from py21cmfast_torch import rsds as trsds
from py21cmfast_tpu import rsds as jrsds
from py21cmfast_tpu.ops import ps


@pytest.fixture(scope="module")
def inputs():
    """JAX and port inputs of the golden size with Ts and recombinations."""
    jinp = jax_inputs(
        USE_TS_FLUCT=True, RECOMB_MODEL="INHOMOGENEOUS", R_BUBBLE_MAX=20.0
    ).with_logspaced_redshifts(10.5, 25.0)
    return jinp, port_inputs(jinp)


def _cone_fields(inp, n_slices=160, seed=0):
    """Tb, LoS velocity and tau_21 on a (6, 5, n_slices) cone with the
    magnitudes of a real one: a smooth periodic velocity (8 Fourier modes a
    sightline) whose |dv/dr| / H reaches ~0.85, beyond the MAX_DVDR clip of
    0.2 but away from 1 + dv/dr/H = 0, where the optical-depth factor is
    singular; tau from 0 to 0.1 with some cells below 1e-10."""
    rng = np.random.default_rng(seed)
    z = np.linspace(10.0, 14.0, n_slices)
    H = inp.cosmology.hubble(z)
    cell = inp.simulation_options.box_len / inp.simulation_options.HII_DIM
    shape = (6, 5, n_slices)
    bt = rng.normal(-20, 15, shape).astype(np.float32)
    amp = rng.normal(size=(6, 5, 8, 1))
    arg = (2 * np.pi * np.arange(1, 9)[:, None] * np.arange(n_slices) / n_slices
           + rng.uniform(0, 2 * np.pi, (6, 5, 8, 1)))
    dvds = (amp * 2 * np.pi * np.arange(1, 9)[:, None] / n_slices * np.cos(arg)).sum(axis=2)
    norm = 0.7 * np.median(H) * cell / np.abs(dvds).max()
    vel = ((amp * np.sin(arg)).sum(axis=2) * norm).astype(np.float32)
    tau = rng.uniform(0, 0.1, shape).astype(np.float32)
    tau[rng.uniform(size=shape) < 0.05] = 1e-12
    return bt, vel, tau, z


@pytest.mark.parametrize("periodic", [False, True])
def test_gradient_matches_jax(periodic):
    rng = np.random.default_rng(1)
    arr = np.cumsum(rng.normal(size=(4, 3, 64)), axis=-1).astype(np.float32)
    ref = np.asarray(jrsds._gradient_last_axis(jnp.asarray(arr), 1.5, periodic))
    got = trsds._gradient_last_axis(torch.from_numpy(arr), 1.5, periodic)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("with_tau", [False, True])
@pytest.mark.parametrize("periodic", [False, True])
def test_dvdr_matches_jax(inputs, with_tau, periodic):
    jinp, tinp = inputs
    if not with_tau:
        jinp = jinp.evolve_input_structs(USE_TS_FLUCT=False)
        tinp = tinp.evolve_input_structs(USE_TS_FLUCT=False)
    bt, vel, tau, z = _cone_fields(tinp)
    tau_t = torch.from_numpy(tau) if with_tau else None
    got = trsds.include_dvdr_in_tau21(
        torch.from_numpy(bt), torch.from_numpy(vel), z, tinp, periodic, tau_21=tau_t).numpy()
    dev = np.asarray(jrsds.include_dvdr_in_tau21(
        jnp.asarray(bt), jnp.asarray(vel), z, jinp, periodic,
        tau_21=jnp.asarray(tau) if with_tau else None))
    host = np.asarray(jrsds.include_dvdr_in_tau21(
        bt, vel, z, jinp, periodic, tau_21=tau if with_tau else None))
    scale = np.abs(bt).max()
    assert not np.allclose(dev, bt, rtol=1e-3), "the correction changed nothing"
    assert np.abs(got - dev).max() <= 1e-5 * scale
    assert np.abs(got - host).max() <= 1e-4 * scale


def test_dvdr_needs_tau_with_ts(inputs):
    _, tinp = inputs
    bt, vel, _, z = _cone_fields(tinp)
    with pytest.raises(ValueError, match="tau_21 required"):
        trsds.include_dvdr_in_tau21(torch.from_numpy(bt), torch.from_numpy(vel), z, tinp, False)


def _shift_inputs(n_slices=48, n_coords=7, seed=2):
    rng = np.random.default_rng(seed)
    field = rng.normal(10, 5, (n_slices, n_coords)).astype(np.float32)
    disp = (1.5 * np.cumsum(rng.normal(0, 0.4, (n_slices, n_coords)), axis=0)).astype(np.float32)
    return field, disp


@pytest.mark.parametrize("n_sub", [1, 2, 3, 4])
@pytest.mark.parametrize("periodic", [False, True])
def test_rsds_shift_matches_jax(periodic, n_sub):
    field, disp = _shift_inputs()
    ref = np.asarray(jrsds.rsds_shift(field, disp, n_rsd_subcells=n_sub, periodic=periodic))
    got = trsds.rsds_shift(torch.from_numpy(field), torch.from_numpy(disp),
                           n_rsd_subcells=n_sub, periodic=periodic)
    assert tuple(got.shape) == field.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_rsds_shift_conserves_mass():
    rng = np.random.default_rng(0)
    field = rng.uniform(1, 2, size=(32, 10)).astype(np.float32)
    disp = rng.normal(0, 0.5, size=(32, 10)).astype(np.float32)
    out = trsds.rsds_shift(field, disp, periodic=True, device="cpu").numpy()
    np.testing.assert_allclose(out.sum(axis=0), field.sum(axis=0), rtol=1e-5)


def test_rsds_zero_displacement_identity():
    rng = np.random.default_rng(1)
    field = rng.uniform(1, 2, size=(16, 4)).astype(np.float32)
    out = trsds.rsds_shift(field, np.zeros_like(field), periodic=True, device="cpu").numpy()
    np.testing.assert_allclose(out, field, rtol=1e-5, atol=1e-6)


def test_rsds_uniform_shift_periodic():
    """A uniform +1 pixel displacement rolls the field by one slice."""
    field = np.zeros((16, 1), np.float32)
    field[5, 0] = 1.0
    out = trsds.rsds_shift(field, np.ones_like(field), periodic=True, device="cpu").numpy()
    assert np.argmax(out[:, 0]) == 6
    np.testing.assert_allclose(out.sum(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("periodic", [False, True])
def test_apply_rsds_matches_jax(inputs, monkeypatch, periodic):
    """The whole cone, chunked over sightlines: a scratch budget small enough
    for several chunks and a last one that is shorter."""
    jinp, tinp = inputs
    bt, vel, _, z = _cone_fields(tinp)
    ref = np.asarray(jrsds.apply_rsds(jnp.asarray(bt), jnp.asarray(vel), z, jinp, periodic))
    monkeypatch.setattr(trsds, "_RSD_CHUNK_BYTES", 4 * trsds._RSD_BYTES_PER_FINE_CELL * 160 * 4)
    got = trsds.apply_rsds(torch.from_numpy(bt), torch.from_numpy(vel), z, tinp, periodic)
    assert tuple(got.shape) == bt.shape
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_numpy_input_becomes_a_tensor_on_the_device(inputs):
    _, tinp = inputs
    bt, vel, _, z = _cone_fields(tinp)
    out = trsds.apply_rsds(bt, vel, z, tinp, False, device="cpu")
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"


@pytest.fixture(scope="module")
def ts_lightcones(inputs):
    """The Ts + INHOMOGENEOUS lightcone in both packages from one numpy
    hires density."""
    jinp, tinp = inputs
    dens = numpy_grf(jinp, seed=5)
    j_lc = j21.run_lightcone(
        jinp, initial_conditions=j21.compute_initial_conditions(jinp, initial_density=dens))
    t_ics = t21.compute_initial_conditions(tinp, initial_density=dens, device="cpu")
    t_lc = t21.run_lightcone(tinp, initial_conditions=t_ics, device="cpu")
    return j_lc, t_lc


def test_ts_lightcone_meets_golden_gates_against_jax(inputs, ts_lightcones):
    jinp, _ = inputs
    j_lc, t_lc = ts_lightcones
    assert len(t_lc.node_redshifts) == 5
    bt, bt_ref = t_lc.brightness_temp.numpy(), np.asarray(j_lc.brightness_temp)
    xh, xh_ref = t_lc.global_quantities["neutral_fraction"], j_lc.global_quantities["neutral_fraction"]
    np.testing.assert_allclose(xh, xh_ref, atol=5e-3)
    assert xh_ref[-1] < 0.95
    np.testing.assert_allclose(np.nanmean(bt), np.nanmean(bt_ref), rtol=5e-3, atol=0.05)
    so = jinp.simulation_options
    _, p, _ = ps.power_spectrum_1d(bt[:, :, : so.HII_DIM], so.box_lens, n_bins=8)
    _, p_ref, _ = ps.power_spectrum_1d(bt_ref[:, :, : so.HII_DIM], so.box_lens, n_bins=8)
    good = np.isfinite(p_ref) & (p_ref > 0)
    np.testing.assert_allclose(p[good], p_ref[good], rtol=1e-2)


@pytest.mark.parametrize("quantity", ["brightness_temp", "tau_21", "velocity_z"])
def test_ts_lightcone_cells_match_jax(ts_lightcones, quantity):
    j_lc, t_lc = ts_lightcones
    assert set(t_lc.lightcones) == set(j_lc.lightcones) == {"brightness_temp", "tau_21", "velocity_z"}
    assert_cone_share(t_lc.lightcones[quantity].numpy(), j_lc.lightcones[quantity], quantity)


def test_ts_lightcone_global_quantities_match_jax(ts_lightcones):
    j_lc, t_lc = ts_lightcones
    t_gq, j_gq = t_lc.global_quantities, j_lc.global_quantities
    np.testing.assert_allclose(t_gq["neutral_fraction"], j_gq["neutral_fraction"], atol=1e-3)
    tb_max = np.abs(j_lc.brightness_temp).max()
    np.testing.assert_allclose(t_gq["brightness_temp"], j_gq["brightness_temp"], atol=1e-3 * tb_max)
