"""The port's perturb paths beyond the default SWEPT deposit, against the JAX
package on the CPU: PERTURB_DEPOSIT="SCATTER", PERTURB_ON_HIGH_RES and a
non-integer DIM/HII_DIM (DIM=40: 2.5), at HII_DIM=16, DIM=32, BOX_LEN=24.

Both packages get the same hires density (numpy, from a seed) through
`initial_density=`.  In the port every integer-ratio path is one function,
ops/deposit.cic_deposit_swept (on the CPU its plain version), and a
non-integer ratio takes the resample-and-scatter route
(`perturb._displace_and_scatter`); the JAX package takes its slab scatter
(`_displace_and_deposit`) for all three.
Tolerances, as tests/test_torch_ics.py and tests/test_torch_slice.py state
them for the SWEPT path:
  ICs fields           max-abs <= 1e-5 max|field| (float32 FFTs and tophat of
                       two libraries);
  density, velocity_z  max-abs <= 1e-4 std (float32 CIC sums in another order,
                       positions c + s/R + d against (h + d_hi)/R, and FFTs of
                       another library);
  whole coeval         global xH within 5e-3, mean Tb within 0.5% + 0.05 mK
                       (the gates of tests/test_golden.py).
"""

import _torch_threads  # noqa: F401
import numpy as np
import pytest
from test_torch_ics import FIELDS, jax_inputs, numpy_grf, port_inputs

import py21cmfast_torch as t21
from py21cmfast_torch import interop
from py21cmfast_torch.models import perturb as tpert
from py21cmfast_tpu.drivers.coeval import run_coeval as j_run_coeval
from py21cmfast_tpu.models import ics as jics
from py21cmfast_tpu.models import perturb as jpert

SMALL = dict(HII_DIM=16, DIM=32, BOX_LEN=24.0)
MODES = {
    "SCATTER": dict(PERTURB_DEPOSIT="SCATTER"),
    "ON_HIGH_RES": dict(PERTURB_ON_HIGH_RES=True),
    "NON_INTEGER": dict(DIM=40),
}
REDSHIFTS = [8.0, 10.5]


@pytest.fixture(scope="module")
def states():
    """Per mode: inputs of both packages and both packages' ICs from one density."""
    out = {}
    for mode, over in MODES.items():
        jinp = jax_inputs(**{**SMALL, **over})
        tinp = port_inputs(jinp)
        dens = numpy_grf(jinp, seed=21)
        out[mode] = dict(
            jinp=jinp, tinp=tinp,
            j_ics=jics.compute_initial_conditions(jinp, initial_density=dens),
            t_ics=t21.compute_initial_conditions(tinp, initial_density=dens, device="cpu"),
        )
    return out


def _numpy(struct):
    return {k: (None if v is None else np.asarray(v)) for k, v in vars(struct).items()}


@pytest.mark.parametrize("name", FIELDS)
@pytest.mark.parametrize("mode", MODES)
def test_ics_fields_match_jax(states, mode, name):
    """The displacement fields live on the grid the perturb deposits onto:
    lowres (filtered) for SCATTER, hires (unfiltered) for PERTURB_ON_HIGH_RES."""
    st = states[mode]
    so = st["tinp"].simulation_options
    got, ref = getattr(st["t_ics"], name).numpy(), np.asarray(getattr(st["j_ics"], name))
    want = so.hires_shape if mode == "ON_HIGH_RES" and name != "lowres_density" else so.lowres_shape
    assert got.shape == ref.shape == want
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= 1e-5 * scale, f"{name}: max-abs {err:.3e} > 1e-5 x {scale:.3e}"


@pytest.mark.parametrize("z", REDSHIFTS)
@pytest.mark.parametrize("mode", MODES)
def test_perturb_matches_jax(states, mode, z):
    """perturb_field of both packages from the JAX package's own ICs."""
    st = states[mode]
    ref = jpert.perturb_field(z, st["jinp"], st["j_ics"])
    ics = interop.initial_conditions_from_numpy(_numpy(st["j_ics"]), "cpu")
    got = tpert.perturb_field(z, st["tinp"], ics, device="cpu")
    for name in ("density", "velocity_z"):
        r = np.asarray(getattr(ref, name))
        g = getattr(got, name).numpy()
        assert g.shape == r.shape == st["tinp"].simulation_options.lowres_shape
        err = np.abs(g - r).max()
        assert err <= 1e-4 * r.std(), f"{name} z={z}: max-abs {err:.3e} > 1e-4 x {r.std():.3e}"


@pytest.mark.parametrize("mode", MODES)
def test_run_coeval_matches_jax(states, mode):
    """The port's run_coeval on the CPU from its own ICs against the JAX
    package's on its own: density stage, then the golden gates on xH and Tb."""
    st = states[mode]
    z = 8.0
    ref = j_run_coeval(st["jinp"], z, initial_conditions=st["j_ics"])
    got = t21.run_coeval(st["tinp"], z, initial_conditions=st["t_ics"], device="cpu")
    dens, dens_ref = got.density.numpy(), np.asarray(ref.density)
    assert np.abs(dens - dens_ref).max() <= 1e-4 * dens_ref.std()
    xh, xh_ref = got.neutral_fraction.numpy().mean(), np.asarray(ref.neutral_fraction).mean()
    assert 0.0 < xh_ref < 1.0
    np.testing.assert_allclose(xh, xh_ref, atol=5e-3)
    np.testing.assert_allclose(
        got.brightness_temp.numpy().mean(), np.asarray(ref.brightness_temp).mean(),
        rtol=5e-3, atol=0.05)


def test_scatter_and_swept_are_one_function_in_the_port(states):
    """At an integer ratio the port sends both deposit options to the same
    deposit, so their fields are identical."""
    st = states["SCATTER"]
    swept = st["tinp"].evolve_input_structs(PERTURB_DEPOSIT="SWEPT")
    a = tpert.perturb_field(8.0, st["tinp"], st["t_ics"], device="cpu")
    b = tpert.perturb_field(8.0, swept, st["t_ics"], device="cpu")
    np.testing.assert_array_equal(a.density.numpy(), b.density.numpy())


def test_on_high_res_differs_from_lowres_perturb(states):
    """PERTURB_ON_HIGH_RES is another estimate of the same field: correlated
    with the lowres perturb, not equal to it."""
    st = states["ON_HIGH_RES"]
    lowres = st["tinp"].evolve_input_structs(PERTURB_ON_HIGH_RES=False)
    ics = t21.compute_initial_conditions(
        lowres, initial_density=st["t_ics"].hires_density.numpy(), device="cpu")
    a = tpert.perturb_field(8.0, st["tinp"], st["t_ics"], device="cpu").density.numpy()
    b = tpert.perturb_field(8.0, lowres, ics, device="cpu").density.numpy()
    assert not np.allclose(a, b, atol=1e-3)
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.8


@pytest.mark.parametrize("over", [dict(DIM=20), dict(DIM=20, PERTURB_DEPOSIT="SCATTER")],
                         ids=["SWEPT", "SCATTER"])
def test_non_integer_ratio_still_raises(over):
    """A non-integer DIM/HII_DIM (2.5) no longer raises: both deposit
    options take the scatter route, decided from the shapes, and give one
    field; with the deposit on the hires grid the kernel's ratio is 1."""
    inp = t21.InputParameters(random_seed=1).evolve_input_structs(
        HII_DIM=8, DIM=16, BOX_LEN=16.0, SOURCE_MODEL="E-INTEGRAL").evolve_input_structs(**over)
    assert not tpert.uses_swept_deposit(inp)
    cv = t21.run_coeval(inp, 8.0, device="cpu")
    other = inp.evolve_input_structs(
        PERTURB_DEPOSIT="SWEPT" if over.get("PERTURB_DEPOSIT") else "SCATTER")
    pf = tpert.perturb_field(8.0, other, cv.initial_conditions, device="cpu")
    np.testing.assert_array_equal(pf.density.numpy(), cv.density.numpy())
    assert np.isfinite(cv.brightness_temp.numpy()).all()
    assert 0.0 < float(cv.neutral_fraction.mean()) <= 1.0
    # with the deposit on the hires grid the ratio is 1 whatever DIM/HII_DIM is
    on_hires = inp.evolve_input_structs(PERTURB_ON_HIGH_RES=True)
    assert tpert.uses_swept_deposit(on_hires)
    cv = t21.run_coeval(on_hires, 8.0, device="cpu")
    assert tuple(cv.density.shape) == inp.simulation_options.lowres_shape
