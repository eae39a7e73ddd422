"""The port's sharded drivers and the box means taken over the ranks, on the
CPU: the port on gloo ranks spawned by tests/_torch_parallel.py, at
HII_DIM=16, DIM=32, BOX_LEN=32.

  run_sharded_coeval (E-INTEGRAL,      against the JAX package's
  2LPT, USE_TS_FLUCT, INHOMOGENEOUS,   run_sharded_coeval on make_mesh(p)
  3 nodes) at p=2 and p=4, from the    of the virtual CPU mesh, per node:
  JAX package's white noise (the       density RMS < 1e-4 sigma + 1e-6,
  port's `white=`)                     <xH> within 1e-3, < 0.5% of the cells
                                       with another round(xH, 3) (the gates
                                       of tests/test_parallel.py:97-100); Ts
                                       max-abs <= 1e-4 of its max; Tb
                                       max-abs <= 1e-4 of max|Tb| where xH
                                       agrees within 1e-5
  run_sharded_lightcone (the same      against the port's single-device
  options) at p=2, its white noise     generate_lightcone, which draws the
  drawn from random_seed               same white noise: each cone's cells
                                       off by > 1e-3 of its max at most 1e-3
                                       of them, the global quantities within
                                       1e-3 of max |value|
  the box means over the ranks (the    at p=2, on fields whose slabs differ,
  turnover means of ionization and     the mesh's values against the
  the fixed grids, <x_e>, x_HI, the    single-device port's on the whole
  homogeneous recombinations, the      fields: the turnover means within 4
  fixed grids' mean fix)               float32 ulps, grids max-abs <= 1e-5
                                       of their max (1e-4 for Ts and xH's
                                       share of flips <= 1e-3)
"""

import _torch_threads  # noqa: F401
import jax
import numpy as np
import pytest
import torch
from _torch_parallel import collect, result, stage_reductions, start_ranks
from test_torch_ics import port_inputs

import py21cmfast_torch as t21
from py21cmfast_tpu.inputs import InputParameters as JInputs
from py21cmfast_tpu.parallel.driver import run_sharded_coeval as j_run_sharded_coeval
from py21cmfast_tpu.parallel.mesh import make_mesh as j_make_mesh

SIZE = dict(HII_DIM=16, DIM=32, BOX_LEN=32.0)
WORLDS = (2, 4)
Z, Z_PREV = 9.0, 10.5


def _slice_inputs():
    return JInputs(random_seed=4).evolve_input_structs(
        **SIZE, SOURCE_MODEL="E-INTEGRAL", PERTURB_ALGORITHM="2LPT", USE_TS_FLUCT=True,
        RECOMB_MODEL="inhomogeneous", R_BUBBLE_MAX=16.0, ZPRIME_STEP_FACTOR=1.3,
        Z_HEAT_MAX=12.0).with_logspaced_redshifts(8.0)


def _jax_white(jinp):
    """The white noise of the JAX package's sharded driver (driver.py:73-75)."""
    key = jax.random.PRNGKey(jinp.random_seed)
    return np.asarray(jax.random.normal(key, jinp.simulation_options.hires_shape,
                                        dtype=jax.numpy.float32))


def _stage_inputs():
    base = t21.InputParameters(random_seed=2).evolve_input_structs(**SIZE)
    return dict(
        mini=base.evolve_input_structs(SOURCE_MODEL="E-INTEGRAL", USE_MINI_HALOS=True,
                                       USE_TS_FLUCT=True, V_CB_MODEL="FLUCTS", M_TURN=5.0,
                                       Z_HEAT_MAX=15.0),
        homog=base.evolve_input_structs(SOURCE_MODEL="E-INTEGRAL", RECOMB_MODEL="HOMOGENEOUS"),
        lagr_ms=base.evolve_input_structs(SOURCE_MODEL="L-INTEGRAL", USE_TS_FLUCT=True,
                                          LYA_MULTIPLE_SCATTERING=True, Z_HEAT_MAX=15.0),
        fixed=base.evolve_input_structs(SOURCE_MODEL="L-INTEGRAL", USE_MINI_HALOS=True,
                                        USE_TS_FLUCT=True, HMF="WATSON", M_TURN=5.0),
    )


def _stage_fields():
    """Fields whose slabs differ: each carries a ramp along x."""
    rng = np.random.default_rng(11)
    shape = (16, 16, 16)
    ramp = np.linspace(-1.0, 1.0, 16)[:, None, None]

    def f(lo, hi, slope=0.0):
        return (rng.uniform(lo, hi, shape) + slope * ramp).astype(np.float32)

    return dict(
        density=f(-0.5, 0.5, 0.4), prev_density=f(-0.5, 0.5, 0.3), velocity_z=f(-1e-13, 1e-13),
        ts=f(20.0, 40.0, 5.0), xe=f(1e-4, 3e-4, 1e-4), tk=f(15.0, 30.0, 4.0),
        j21=f(0.0, 1.0, 0.5), xh=f(0.3, 1.0, 0.0), g12=f(0.0, 0.5, 0.3),
        zre=np.where(rng.uniform(size=shape) + 0.3 * ramp > 0.6, 11.0, -1.0).astype(np.float32),
        rec=f(0.0, 0.2, 0.1), vcb=f(5.0, 50.0, 10.0), vx=f(-2.0, 2.0, 1.0), vy=f(-2.0, 2.0),
        vz=f(-2.0, 2.0), sfr=f(0.0, 1e-9, 5e-10), xray=f(0.0, 1e-3, 4e-4),
        lowres_density=f(-0.3, 0.3, 0.2), mt_a=f(7.5, 8.5, 0.3), mt_m=f(5.5, 6.5, 0.3),
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks at p=2 and p=4, started together, and the JAX
    package's sharded chains, run in this process while they work."""
    jinp = _slice_inputs()
    tinp = port_inputs(jinp)
    nodes = list(jinp.node_redshifts)
    white = _jax_white(jinp)
    started = {}
    for p in WORLDS:
        jobs = [("coeval_job", (tinp, nodes, white))]
        if p == 2:
            jobs += [("lightcone_job", (tinp, None)),
                     ("reductions_job", (_stage_inputs(), _stage_fields(), Z, Z_PREV))]
        started[p] = start_ranks(p, jobs, tmp_path_factory.mktemp(f"slice{p}"))
    jax_nodes = {p: j_run_sharded_coeval(jinp, nodes, mesh=j_make_mesh(p)) for p in WORLDS}
    port = {p: dict(zip(["coeval", "lightcone", "reductions"], collect(run)))
            for p, run in started.items()}
    return port, jax_nodes


@pytest.fixture(scope="module")
def port(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_nodes(runs):
    return runs[1]


def _result(port, p, name):
    return result(port[p][name])


@pytest.mark.parametrize("p", WORLDS)
@pytest.mark.parametrize("node", [0, 1, 2])
def test_sharded_coeval_matches_jax(port, jax_nodes, p, node):
    got = _result(port, p, "coeval")[node]
    ref = jax_nodes[p][node]
    assert abs(got["redshift"] - ref.redshift) < 1e-8
    d1, ds = np.asarray(ref.density), got["density"]
    assert np.sqrt(np.mean((ds - d1) ** 2)) < 1e-4 * d1.std() + 1e-6
    x1, xs = np.asarray(ref.neutral_fraction), got["neutral_fraction"]
    assert abs(xs.mean() - x1.mean()) < 1e-3
    assert np.mean(np.round(xs, 3) != np.round(x1, 3)) < 5e-3
    ts1 = np.asarray(ref.spin_temperature)
    assert np.abs(got["spin_temperature"] - ts1).max() <= 1e-4 * np.abs(ts1).max()
    tb1 = np.asarray(ref.brightness_temp)
    same = np.abs(xs - x1) <= 1e-5
    assert same.mean() > 0.99
    assert np.abs(got["brightness_temp"] - tb1)[same].max() <= 1e-4 * np.abs(tb1).max()


def test_sharded_lightcone_matches_single_device(port):
    """run_sharded_lightcone at p=2 against generate_lightcone on one
    device, both drawing their white noise from random_seed."""
    got = _result(port, 2, "lightcone")
    ref = t21.run_lightcone(port_inputs(_slice_inputs()), device="cpu")
    assert sorted(got["lightcones"]) == sorted(ref.lightcones)
    for q, cone in ref.lightcones.items():
        r = cone.numpy()
        g = got["lightcones"][q]
        assert g.shape == r.shape
        off = np.abs(g - r) > 1e-3 * np.abs(r).max()
        assert off.mean() <= 1e-3, (q, off.mean())
    for q, v in ref.global_quantities.items():
        v = np.asarray(v)
        np.testing.assert_allclose(got["global_quantities"][q], v, rtol=0,
                                   atol=1e-3 * np.abs(v).max())


@pytest.fixture(scope="module")
def single_stages():
    fields = {k: torch.as_tensor(v) for k, v in _stage_fields().items()}
    out = stage_reductions(_stage_inputs(), fields, Z, Z_PREV)
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in out.items()}


@pytest.mark.parametrize("name", ["ion_l10", "fixed_l10"])
def test_turnover_means_over_ranks(port, single_stages, name):
    got = _result(port, 2, "reductions")[name]
    for g, r in zip(got, single_stages[name]):
        assert abs(g - r) <= 4 * np.spacing(np.float32(r)), (name, got, single_stages[name])


@pytest.mark.parametrize("name", ["homog_rec", "xe", "xs_sfr", "fixed_nion", "fixed_sfr", "ts"])
def test_stage_grids_over_ranks(port, single_stages, name):
    """The grids that read a box mean: the homogeneous recombinations (mean
    xH and Gamma12), x_e and Ts (<x_e>, the mean MCG turnover), the
    XraySourceBox shells (x_HI), the fixed grids (the mean fix and their
    displacement across the slab borders)."""
    got = _result(port, 2, "reductions")[name]
    ref = single_stages[name]
    assert got.shape == ref.shape
    rel = 1e-4 if name == "ts" else 1e-5
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (name, err, np.abs(ref).max())


def test_ionization_over_ranks(port, single_stages):
    got = _result(port, 2, "reductions")["ion_xh"]
    ref = single_stages["ion_xh"]
    assert 0.0 < ref.mean() < 1.0
    assert np.mean(np.abs(got - ref) > 1e-3) <= 1e-3
