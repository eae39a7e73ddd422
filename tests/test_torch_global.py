"""The port's global 0-D driver (drivers/global_evolution.py) against the
JAX package, on the CPU: the inputs of tests/test_global_evolution.py
(USE_TS_FLUCT, E-INTEGRAL, ZPRIME_STEP_FACTOR=1.1, Z_HEAT_MAX=35, down to
z=5.5: 19 nodes), every quantity per node within 1e-5 of its value plus
1e-5 of the series' largest magnitude (the 1-cell Ts step's float32
state), and the h5 round trip; then the validation and the saturated-Ts
CONST-ION-EFF branch (the filling factor from Fcoll alone).
"""

import _torch_threads  # noqa: F401
import numpy as np
import pytest
from test_torch_ics import port_inputs

import py21cmfast_torch as t21
import py21cmfast_tpu as p21

REL = 1e-5


def _inputs(**over):
    return p21.InputParameters(random_seed=1).evolve_input_structs(
        USE_TS_FLUCT=True, SOURCE_MODEL="E-INTEGRAL", ZPRIME_STEP_FACTOR=1.1, Z_HEAT_MAX=35.0,
        **over)


def _assert_quantities(got, ref):
    assert sorted(got.quantities) == sorted(ref.quantities)
    for name, r in ref.quantities.items():
        r = np.asarray(r, np.float64)
        g = np.asarray(got.quantities[name], np.float64)
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g, r, rtol=REL, atol=REL * np.abs(r).max(), err_msg=name)


@pytest.fixture(scope="module")
def runs():
    jinp = _inputs()
    ref = p21.run_global_evolution(jinp, min_redshift=5.5)
    got = t21.run_global_evolution(port_inputs(jinp), min_redshift=5.5, device="cpu")
    return ref, got


def test_global_evolution_matches_jax(runs):
    ref, got = runs
    np.testing.assert_array_equal(got.node_redshifts, ref.node_redshifts)
    assert len(got.node_redshifts) == 19
    _assert_quantities(got, ref)
    # the history is a history: xH falls, Tk first cools and then heats
    x_hi = got.neutral_fraction
    assert x_hi[0] > 0.99 and x_hi[-1] < x_hi[0]
    assert np.argmin(got.kinetic_temperature) not in (0, len(x_hi) - 1)


def test_global_evolution_h5_round_trip(runs, tmp_path):
    _, got = runs
    path = tmp_path / "global.h5"
    got.save(path)
    back = t21.GlobalEvolution.from_file(path)
    assert back.inputs == got.inputs
    for name, v in got.quantities.items():
        np.testing.assert_array_equal(back.quantities[name], v, err_msg=name)
    with pytest.raises(ValueError, match="not a global_evolution file"):
        import h5py

        with h5py.File(tmp_path / "other.h5", "w") as fl:
            fl.attrs["other"] = True
        t21.GlobalEvolution.from_file(tmp_path / "other.h5")


def test_global_evolution_const_ion_eff_matches_jax():
    """The saturated-Ts branch: CONST-ION-EFF from z=20 to 6 at
    ZPRIME_STEP_FACTOR=1.2 (filling factor and Tb only)."""
    jinp = p21.InputParameters(random_seed=1).evolve_input_structs(
        SOURCE_MODEL="CONST-ION-EFF", ZPRIME_STEP_FACTOR=1.2, Z_HEAT_MAX=20.0)
    ref = p21.run_global_evolution(jinp, min_redshift=6.0)
    got = t21.run_global_evolution(port_inputs(jinp), min_redshift=6.0, device="cpu")
    _assert_quantities(got, ref)
    assert "spin_temperature" not in got.quantities


@pytest.mark.parametrize("over, source_model, match", [
    (dict(SOURCE_MODEL="CHMF-SAMPLER"), None, "discrete halos"),
    ({}, "DEXM-ESF", "'source_model' must be one of"),
])
def test_global_evolution_validation(over, source_model, match):
    inp = t21.InputParameters(random_seed=1).evolve_input_structs(**over)
    with pytest.raises(ValueError, match=match):
        t21.run_global_evolution(inp, source_model=source_model, device="cpu")
