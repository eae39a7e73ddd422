"""The port's photon-conservation corrections (models/photoncons.py and the
terms of ionization) against the JAX package, on the CPU, at HII_DIM=12,
DIM=36, BOX_LEN=24 (E-INTEGRAL, inhomogeneous recombinations,
R_BUBBLE_MAX=15, PERTURB_DEPOSIT="SCATTER": the port deposits through the
same kernel either way, and the JAX package's SWEPT route re-plans and
recompiles its staged deposit at every redshift of the calibration).  One
JAX chain: the Z-PHOTONCONS calibration from a shared numpy hires density,
whose ICs are handed to the port's calibration.  Tolerances:

  _noisy_sigma_table, euler_q,        the same host numpy code: within 1e-12
  analytic_Q_history (E-INTEGRAL and  of their value
  CONST-ION-EFF)
  calibrate_photon_cons               the same z grid (the step branches on
                                      the mean xH at 0.9, 0.3 and 0.01); the
                                      mean xH of every step within 1e-3 (the
                                      thresholded field's gate)
  setup_photon_cons, Z-, ALPHA- and   with one calibration handed to both:
  F-PHOTONCONS                        every field within 1e-12
  ionization under the ALPHA and F    the xH gates below, mean_f_coll within
  fits (z=10, one perturbed field)    1e-6 of its value
  the Z-PHOTONCONS chain (4 nodes,    per node: the share of cells with
  z=16.6 -> 8, one state handed to    |dxH| > 1e-3 at most 1e-3 and the
  both)                               global xH within 1e-3; Tb within 1e-5
                                      of max|Tb| where xH agrees; the golden
                                      gates (tests/test_golden.py:32-45)
"""

import _torch_threads  # noqa: F401
import dataclasses

import jax
import jax.numpy as jnp  # noqa: F401
import numpy as np
import pytest
from test_torch_ics import numpy_grf, port_inputs
from test_torch_minihalos import _gates, _numpy

import py21cmfast_torch as t21
from py21cmfast_torch import interop
from py21cmfast_torch.drivers import coeval as tcoeval
from py21cmfast_torch.models import ics as tics
from py21cmfast_torch.models import ionization as tion
from py21cmfast_torch.models import photoncons as tpc
from py21cmfast_tpu.drivers.coeval import run_coeval as j_run_coeval
from py21cmfast_tpu.inputs import InputParameters as JInputs
from py21cmfast_tpu.models import ics as jics
from py21cmfast_tpu.models import ionization as jion
from py21cmfast_tpu.models import perturb as jpert
from py21cmfast_tpu.models import photoncons as jpc

SIZE = dict(HII_DIM=12, DIM=36, BOX_LEN=24.0, ZPRIME_STEP_FACTOR=1.25, Z_HEAT_MAX=25.0,
            SOURCE_MODEL="E-INTEGRAL", RECOMB_MODEL="INHOMOGENEOUS", R_BUBBLE_MAX=15.0,
            PERTURB_DEPOSIT="SCATTER")
THRESHOLDS = (0.9, 0.3, 0.01)


def jax_inputs(pc="Z-PHOTONCONS", **over):
    return JInputs(random_seed=21).evolve_input_structs(
        **{**SIZE, **over}, PHOTON_CONS_TYPE=pc).with_logspaced_redshifts(8.0, 14.0)


def _xh_gates(got, ref, ctx):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    flipped = np.mean(np.abs(got - ref) > 1e-3)
    assert flipped <= 1e-3, f"{ctx}: {flipped:.2e} of cells differ by > 1e-3"
    assert abs(got.mean() - ref.mean()) <= 1e-3, (ctx, got.mean(), ref.mean())


@pytest.fixture(scope="module")
def cal():
    """The JAX package's Z-PHOTONCONS calibration from a numpy density and
    the port's from the same ICs, carried across."""
    jinp = jax_inputs()
    tinp = port_inputs(jinp)
    dens = numpy_grf(jinp, seed=8)
    j_ics = {}
    original = jics.compute_initial_conditions

    def shared(inputs, **kw):
        j_ics["ics"] = original(inputs, initial_density=dens)
        return j_ics["ics"]

    z_ana, q_ana = jpc.analytic_Q_history(jinp)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jics, "compute_initial_conditions", shared)
        z_cal, xh_cal = jpc.calibrate_photon_cons(jinp, z_ana, q_ana)
        handed = interop.initial_conditions_from_numpy(_numpy(j_ics["ics"]), "cpu")
        mp.setattr(tics, "compute_initial_conditions", lambda inputs, device: handed)
        tz, txh = tpc.calibrate_photon_cons(tinp, z_ana, q_ana, device="cpu")
    return dict(jinp=jinp, tinp=tinp, dens=dens, z_ana=z_ana, q_ana=q_ana, z_cal=z_cal,
                xh_cal=xh_cal, port=(tz, txh))


@pytest.mark.parametrize("source_model", ["E-INTEGRAL", "CONST-ION-EFF"])
def test_analytic_history_matches_jax(source_model):
    jinp = jax_inputs(SOURCE_MODEL=source_model)
    tinp = port_inputs(jinp)
    lnm = np.linspace(np.log(1e6), np.log(1e15), 97)
    np.testing.assert_allclose(tpc._noisy_sigma_table(tinp).dsigmasq_of_lnm(lnm),
                               jpc._noisy_sigma_table(jinp).dsigmasq_of_lnm(lnm), rtol=1e-12)
    for got, ref in zip(tpc.analytic_Q_history(tinp), jpc.analytic_Q_history(jinp)):
        np.testing.assert_allclose(got, ref, rtol=1e-12)
    for got, ref in zip(tpc.euler_q(lambda z: np.exp(-z / 3.0), 0.7, z_end=5.0),
                        jpc.euler_q(lambda z: np.exp(-z / 3.0), 0.7, z_end=5.0)):
        np.testing.assert_array_equal(got, ref)


def test_calibration_matches_jax(cal):
    """The same z grid and, step by step, the mean neutral fraction; the
    JAX package's means keep clear of the step thresholds by more than the
    two packages differ, so the grids agree by margin, not by luck."""
    tz, txh = cal["port"]
    np.testing.assert_array_equal(tz, cal["z_cal"])
    diff = np.abs(txh - cal["xh_cal"])
    assert diff.max() <= 1e-3, diff.max()
    margin = min(np.abs(cal["xh_cal"] - t).min() for t in THRESHOLDS)
    assert margin > diff.max(), (margin, diff.max())
    assert cal["xh_cal"][0] > 0.9 and cal["xh_cal"][-1] < 0.01


@pytest.mark.parametrize("pc", ["Z-PHOTONCONS", "ALPHA-PHOTONCONS", "F-PHOTONCONS"])
def test_setup_photon_cons_matches_jax(cal, monkeypatch, pc):
    """setup_photon_cons with the JAX calibration handed to both packages:
    the Z state (deltaz over xH) or the ALPHA/F fit, field by field; the
    port's state also from the JAX package's through interop."""
    jinp, tinp = jax_inputs(pc), port_inputs(jax_inputs(pc))

    def handed(inputs, z_ana=None, q_ana=None, **kw):
        return cal["z_cal"], cal["xh_cal"]

    for mod in (jpc, tpc):
        monkeypatch.setattr(mod, "calibrate_photon_cons", handed)
        monkeypatch.setattr(mod, "_state_cache", {})
    ref = jpc.setup_photon_cons(jinp)
    got = tpc.setup_photon_cons(tinp, device="cpu")
    assert type(got).__name__ == type(ref).__name__
    carried = interop.photoncons_state_from_dict(dataclasses.asdict(ref))
    for state in (got, carried):
        for f in dataclasses.fields(ref):
            a, b = getattr(state, f.name), getattr(ref, f.name)
            if isinstance(b, str):
                assert a == b
            else:
                np.testing.assert_allclose(a, b, rtol=1e-12, err_msg=f.name)
    assert tpc.setup_photon_cons(tinp, device="cpu") is got  # cached
    if pc == "Z-PHOTONCONS":
        z = 8.0
        assert got.adjusted_redshift(z) == ref.adjusted_redshift(z) < z
    else:
        assert got.value_at(8.0) == ref.value_at(8.0)


def test_z_photoncons_chain_matches_jax(cal, monkeypatch):
    """run_coeval down the 4 nodes of z=16.6 -> 8 under Z-PHOTONCONS, both
    packages from one hires density and one state (the JAX calibration's):
    per node xH and Tb; each box keeps its node's redshift while the
    correction shifts the one it is computed at."""
    jinp, tinp = cal["jinp"], cal["tinp"]

    def handed(inputs, z_ana=None, q_ana=None, **kw):
        return cal["z_cal"], cal["xh_cal"]

    monkeypatch.setattr(jpc, "calibrate_photon_cons", handed)
    monkeypatch.setattr(jpc, "_state_cache", {})
    state = jpc.setup_photon_cons(jinp)
    carried = interop.photoncons_state_from_dict(dataclasses.asdict(state))
    monkeypatch.setattr(tcoeval, "setup_photon_cons", lambda inputs, device: carried)
    zs = list(jinp.node_redshifts)
    assert len(zs) == 4 and carried.adjusted_redshift(zs[-1]) < zs[-1]
    j_ics = jics.compute_initial_conditions(jinp, initial_density=cal["dens"])
    t_ics = t21.compute_initial_conditions(tinp, initial_density=cal["dens"], device="cpu")
    ref = j_run_coeval(jinp, zs, initial_conditions=j_ics)
    got = t21.run_coeval(tinp, zs, initial_conditions=t_ics, device="cpu")
    for j, t in zip(ref, got):
        z = float(j.redshift)
        assert float(t.ionized_box.redshift) == float(j.ionized_box.redshift) == np.float32(z)
        xh, xh_ref = t.neutral_fraction.numpy(), np.asarray(j.ionized_box.neutral_fraction)
        _xh_gates(xh, xh_ref, f"xH z={z}")
        tb, tb_ref = t.brightness_temp.numpy(), np.asarray(j.brightness_temperature.brightness_temp)
        same = np.abs(xh - xh_ref) <= 1e-6
        assert np.abs(tb - tb_ref)[same].max() <= 1e-5 * np.abs(tb_ref).max(), z
        _gates(xh.astype(np.float64).mean(), xh_ref.astype(np.float64).mean(), tb, tb_ref,
               jinp.simulation_options.box_lens, f"z={z}")
    assert 0.0 < float(got[-1].neutral_fraction.double().mean()) < 0.9


@pytest.mark.parametrize("pc", ["ALPHA-PHOTONCONS", "F-PHOTONCONS"])
def test_fit_variants_ionize_as_jax(cal, monkeypatch, pc):
    """One ionization step at z=10 under the ALPHA or F fit of the JAX
    calibration, handed to both packages with one perturbed field: the fit
    replaces the escape parameter in both alike."""
    jinp = jax_inputs(pc)
    tinp = port_inputs(jinp)
    monkeypatch.setattr(jpc, "calibrate_photon_cons",
                        lambda inputs, *a, **kw: (cal["z_cal"], cal["xh_cal"]))
    monkeypatch.setattr(jpc, "_state_cache", {})
    fit = jpc.setup_photon_cons(jinp)
    j_ics = jics.compute_initial_conditions(jinp, initial_density=cal["dens"])
    pf = jpert.perturb_field(10.0, jinp, j_ics)
    ref = jion.compute_ionization_field(10.0, jinp, pf, photoncons_state=fit)
    plain = jion.compute_ionization_field(10.0, jinp, pf)
    got = tion.compute_ionization_field(
        10.0, tinp, interop.perturbed_field_from_numpy(_numpy(pf), "cpu"),
        photoncons_state=interop.photoncons_state_from_dict(dataclasses.asdict(fit)), device="cpu")
    assert float(ref.mean_f_coll) != float(plain.mean_f_coll)
    np.testing.assert_allclose(got.mean_f_coll, ref.mean_f_coll, rtol=1e-6)
    _xh_gates(got.neutral_fraction.numpy(), ref.neutral_fraction, pc)
