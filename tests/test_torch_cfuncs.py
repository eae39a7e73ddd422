"""The port's cfuncs, power spectra, luminosity function, CLASS helpers and
Boltzmann copy against the JAX package's, on the CPU.

  host tables   every host-table function of `cfuncs` on the same inputs:
                within 1e-6 of the JAX package's value (both build float64
                tables from the same code);
  halo props    `convert_halo_properties` with the same draws: every
                property within 1e-5 of its value (float32 on both sides);
  halo samples  `sample_halos_from_conditions` (torch draws, so other halos
                than the JAX package's key gives): the count and four mass
                octaves within 5 sigma of the conditional MF's expectation;
  UV LF         `compute_luminosity_function`, `acg` and `mcg`: within 1e-6;
  P(k)          `power_spectrum_1d` and `dimensionless_power` (float32 FFT
                of two libraries, float64 bins) and `reference_binned_power`
                (numpy in both): each bin within 1e-6 of its value;
  CLASS         `run_classy` raises without classy; `compute_rms` and
                `find_redshift_kinematic_decoupling` within 1e-10;
  Boltzmann     the copy's code equals the JAX package's, and its solve at
                two k (density at z=0, v_cb at decoupling) is equal to 1e-12.
"""

import _torch_threads  # noqa: F401
import ast
import inspect
import warnings

import numpy as np
import pytest
import torch
from test_torch_ics import jax_inputs, port_inputs

import py21cmfast_torch as t21
from py21cmfast_torch import cfuncs as tcf
from py21cmfast_torch.cosmology import boltzmann as tboltz
from py21cmfast_torch.cosmology import classy_interface as tclassy
from py21cmfast_torch.ops import ps as tps
from py21cmfast_tpu import cfuncs as jcf
from py21cmfast_tpu.cosmology import boltzmann as jboltz
from py21cmfast_tpu.cosmology import classy_interface as jclassy
from py21cmfast_tpu.ops import ps as jps

HOST_REL = 1e-6


def _pair(**over):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jinp = jax_inputs(**over)
        return jinp, port_inputs(jinp)


@pytest.fixture(scope="module")
def inputs():
    return _pair()


@pytest.fixture(scope="module")
def mini_inputs():
    return _pair(USE_MINI_HALOS=True, USE_TS_FLUCT=True)


MASSES = np.logspace(8, 13, 17)
DELTAS = np.linspace(-0.8, 1.2, 9)
HOST_CALLS = {
    "evaluate_sigma": lambda inp: (inp, MASSES),
    "return_uhmf_value": lambda inp: (inp, 8.0, MASSES),
    "return_chmf_value": lambda inp: (inp, 8.0, MASSES[:12], 3e12, 0.4),
    "evaluate_condition_integrals": lambda inp: (inp, 8.0, MASSES[8:], DELTAS),
    "evaluate_SFRD_cond": lambda inp: (inp, 8.0, 1e12, DELTAS),
    "evaluate_Nion_cond": lambda inp: (inp, 8.0, 1e12, DELTAS),
    "evaluate_inverse_table": lambda inp: (inp, 8.0, 1e12, DELTAS[:4], [1e-3, 0.1, 0.5, 0.9]),
    "compute_tau": lambda inp: (inp, [5.0, 6.0, 7.0, 8.0, 10.0, 14.0], [0.0, 0.1, 0.4, 0.7, 0.95, 1.0]),
    "compute_mturns": lambda inp: (inp, 9.0, 0.5, 20.0, 0.3, 11.0),
    "evaluate_FgtrM_cond": lambda inp: (inp, 8.0, 1e12, DELTAS),
    "evaluate_SFRD_z": lambda inp: (inp, [6.0, 9.0, 14.0], [6.0, 6.5, 7.0]),
    "evaluate_Nion_z": lambda inp: (inp, [6.0, 9.0, 14.0], [6.0, 6.5, 7.0]),
    "get_condition_mass": lambda inp: (inp, 2.5),
    "get_delta_crit": lambda inp: (inp, 1e11, 8.0),
    "get_delta_crit_nu": lambda inp: (1, 2.3, 0.12),
    "get_expected_nhalo": lambda inp: (inp, 8.0),
    "get_growth_factor": lambda inp: (inp, 8.0),
    "get_halo_catalog_buffer_size": lambda inp: (inp, 8.0),
    "get_matter_power_values": lambda inp: (inp, np.logspace(-3, 1, 9)),
    "get_vcb_power_values": lambda inp: (inp, np.logspace(-3, 1, 9)),
    "integrate_chmf_interval": lambda inp: (inp, 8.0, 1e9, 1e11, 3e12, DELTAS),
}


def _flat(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _flat(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for e in x for v in _flat(e)]
    return [x]


def test_every_cfuncs_name_is_ported():
    assert sorted(tcf.__all__) == sorted(jcf.__all__)
    host = set(HOST_CALLS) | {"convert_halo_properties", "sample_halos_from_conditions",
                              "compute_luminosity_function"}
    assert host == set(jcf.__all__)


@pytest.mark.parametrize("name", sorted(HOST_CALLS))
def test_host_functions_match_jax(name, inputs, mini_inputs):
    """Each host-table function, on the inputs of the JAX package and of
    the port (with minihalos where they change the answer)."""
    pair = mini_inputs if name in ("compute_mturns", "evaluate_SFRD_z", "evaluate_Nion_z") else inputs
    ref = getattr(jcf, name)(*HOST_CALLS[name](pair[0]))
    got = getattr(tcf, name)(*HOST_CALLS[name](pair[1]))
    assert type(got) is type(ref) or np.ndim(ref) > 0
    for g, r in zip(_flat(got), _flat(ref), strict=True):
        if r is None:
            assert g is None
            continue
        r = np.asarray(r, np.float64)
        assert np.isfinite(r).all() and np.asarray(g).shape == r.shape
        np.testing.assert_allclose(np.asarray(g, np.float64), r, rtol=HOST_REL, atol=0, err_msg=name)


@pytest.mark.parametrize("template", ["latest-discrete", "minihalos-discrete"])
def test_convert_halo_properties_match_jax(template):
    import py21cmfast_tpu as p21

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jinp = p21.InputParameters.from_template(template, random_seed=4)
    tinp = port_inputs(jinp)
    rng = np.random.default_rng(11)
    m = np.exp(rng.uniform(np.log(1e8), np.log(1e12), 4096)).astype(np.float32)
    rngs = rng.standard_normal((3, m.size)).astype(np.float32)
    ref = jcf.convert_halo_properties(jinp, 8.0, m, *rngs)
    got = tcf.convert_halo_properties(tinp, 8.0, torch.from_numpy(m), *rngs, device="cpu")
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        r = np.asarray(r, np.float64)
        assert got[name].dtype == np.float32 and np.all(np.isfinite(got[name]))
        assert np.all(np.abs(got[name] - r) <= 1e-5 * np.abs(r)), name
    zero = tcf.convert_halo_properties(tinp, 8.0, m[:16], device="cpu")
    zref = jcf.convert_halo_properties(jinp, 8.0, m[:16])
    np.testing.assert_allclose(zero["stellar_mass"], zref["stellar_mass"], rtol=1e-5)


def _octave_gate(inp, z, counts, deltas, m_cell, label):
    """The sample's count and its four mass octaves from SAMPLER_MIN_MASS,
    each within 5 sigma (Poisson) of the conditional MF's expectation."""
    m_min = inp.simulation_options.SAMPLER_MIN_MASS
    edges = m_min * 2.0 ** np.arange(5)
    uniq, mult = np.unique(deltas, return_counts=True)
    expect = np.array([
        (tcf.integrate_chmf_interval(inp, z, lo, hi, m_cell, uniq) * mult).sum()
        for lo, hi in zip(edges[:-1], edges[1:])])
    n_all = (tcf.evaluate_condition_integrals(inp, z, np.full(uniq.size, m_cell), uniq)[0] * mult).sum()
    got = np.histogram(counts, bins=edges)[0]
    sig = (got - expect) / np.sqrt(expect)
    assert np.all(np.abs(sig) <= 5.0), (label, got, expect, sig)
    assert abs(len(counts) - n_all) <= 5.0 * np.sqrt(n_all), (label, len(counts), n_all)


def test_sample_halos_from_conditions_follow_the_cmf(inputs):
    tinp = inputs[1].evolve_input_structs(SAMPLER_MIN_MASS=1e8)
    so = tinp.simulation_options
    m_cell = tinp.cosmology.rho_mean * (so.box_len / so.HII_DIM) ** 3
    deltas = np.repeat([-0.3, 0.0, 0.5], 300)
    out = tcf.sample_halos_from_conditions(tinp, 8.0, deltas, seed=5, device="cpu")
    assert out["n_halos"] == len(out["halo_masses"]) > 1000
    assert out["halo_masses"].max() <= m_cell * 1.0001
    _octave_gate(tinp, 8.0, out["halo_masses"], deltas, m_cell, "grid")
    again = tcf.sample_halos_from_conditions(tinp, 8.0, deltas, seed=5, device="cpu")
    np.testing.assert_array_equal(again["halo_masses"], out["halo_masses"])
    # progenitors of 2000 descendants of 1e11 Msun from z=8 to z=8.5: every
    # one's mass sits below its descendant's, and the total does not exceed it
    prog = tcf.sample_halos_from_conditions(tinp, 8.5, np.full(2000, 1e11), seed=6,
                                            redshift_prev=8.0, device="cpu")
    assert prog["n_halos"] > 2000 and prog["halo_masses"].max() < 1e11
    assert prog["halo_masses"].sum() < 2000 * 1e11


@pytest.mark.parametrize("component", ["acg", "mcg"])
def test_luminosity_function_matches_jax(mini_inputs, component):
    jinp, tinp = mini_inputs
    zs = [6.0, 8.0, 10.0]
    ref = jcf.compute_luminosity_function(zs, jinp, nbins=40, component=component)
    got = t21.compute_luminosity_function(zs, tinp, nbins=40, component=component)
    for g, r, name in zip(got, ref, ("Muv", "Mhalo", "lfunc")):
        assert g.shape == (3, 40)
        np.testing.assert_allclose(g, r, rtol=HOST_REL, atol=0, err_msg=name)
    assert np.isfinite(got[2]).all() and got[2].max() > -30


@pytest.fixture(scope="module")
def field():
    return np.random.default_rng(8).normal(-5.0, 12.0, (24, 20, 18)).astype(np.float32)


@pytest.mark.parametrize("fn, kw", [("power_spectrum_1d", {}),
                                    ("power_spectrum_1d", dict(n_bins=7, log_bins=False)),
                                    ("dimensionless_power", dict(n_bins=10))],
                         ids=["log", "linear", "dimensionless"])
def test_power_spectra_match_jax(field, fn, kw):
    lens = (36.0, 30.0, 27.0)
    ref = getattr(jps, fn)(field, lens, **kw)
    for arg in (torch.from_numpy(field), field):  # a tensor, and an array moved to the CPU
        got = getattr(tps, fn)(arg, lens, device="cpu", **kw)
        for g, r in zip(got, ref):
            ok = np.isfinite(r)
            assert ok.sum() >= 5
            np.testing.assert_array_equal(np.isfinite(g), ok)
            np.testing.assert_allclose(g[ok], r[ok], rtol=1e-6, atol=0)


def test_reference_binned_power_matches_jax(field):
    ref = jps.reference_binned_power(field, 36.0)
    got = tps.reference_binned_power(torch.from_numpy(field), 36.0)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=0)


def test_run_classy_raises_without_classy():
    with pytest.raises(ImportError, match="register_class_transfer"):
        t21.run_classy(h=0.7)


@pytest.mark.parametrize("kind, radius, zs", [("d_m", 8.0 / 0.6766, [0.0]),
                                              ("d_m", 2.0, [0.0, 6.0, 20.0]),
                                              ("v_cb", 0.0, [1100.0])])
def test_compute_rms_matches_jax(inputs, kind, radius, zs):
    jinp, tinp = inputs
    ref = jclassy.compute_rms(kind=kind, redshifts=zs, smoothing_radius=radius, inputs=jinp)
    got = t21.compute_rms(kind=kind, redshifts=zs, smoothing_radius=radius, inputs=tinp)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=0)
    if kind == "d_m" and radius > 5:
        # sigma_8 is what the power spectrum is normalised to
        np.testing.assert_allclose(got[0], tinp.cosmo_params.sigma_8_effective, rtol=2e-2)


def test_kinematic_decoupling_matches_jax(inputs):
    jinp, tinp = inputs
    got = tclassy.find_redshift_kinematic_decoupling(inputs=tinp)
    assert got == pytest.approx(jclassy.find_redshift_kinematic_decoupling(inputs=jinp), rel=1e-10)
    assert 1000 < got < 1150


def _code_after_docstring(module):
    tree = ast.parse(inspect.getsource(module))
    tree.body = tree.body[1:]  # the module docstring
    return ast.dump(tree)


def test_boltzmann_copy_is_the_jax_code_and_solves_alike():
    assert _code_after_docstring(tboltz) == _code_after_docstring(jboltz)
    np.testing.assert_array_equal(tboltz.REFERENCE_K_TRANSFER, jboltz.REFERENCE_K_TRANSFER)
    z_dec = 1069.6
    got = tboltz.BoltzmannSolver(OMm=0.30964)
    ref = jboltz.BoltzmannSolver(OMm=0.30964)
    for k in (0.05, 0.1):
        g = got.solve_k(k, z_out=(0.0, z_dec))
        r = ref.solve_k(k, z_out=(0.0, z_dec))
        for gz, rz in zip(g, r):
            for name in ("delta_m", "v_cb"):
                np.testing.assert_allclose(gz[name], rz[name], rtol=1e-12, atol=0, err_msg=f"{k} {name}")
