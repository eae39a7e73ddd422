"""The port's ionization with a spin-temperature box and with recombinations
against the JAX package, at golden size (HII_DIM=24, DIM=72, BOX_LEN=36,
ZPRIME_STEP_FACTOR=1.25, Z_HEAT_MAX=25), on the CPU.

One JAX chain (USE_TS_FLUCT, RECOMB_MODEL="INHOMOGENEOUS", R_BUBBLE_MAX=20)
runs down the golden ladder; its previous IonizedBox (with N_rec), TsBox and
perturbed field at z=10.5 cross through interop, and one ionization step of
each variant is compared on that identical state:
  xH          share of cells with |dxH| > 1e-3 at most 1e-3, global xH within
              1e-3 (thresholded cells flip on float32 rounding of fcoll);
  N_rec, Tk   max-abs <= 1e-5 of the field's maximum on cells whose
              ionization state agrees;
  recombination-rate tables, _recomb_update: relative 1e-12 (copies) and
              max-abs <= 1e-6 of the maximum.
"""

import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ics import jax_inputs, numpy_grf, port_inputs

from py21cmfast_torch import interop
from py21cmfast_torch.models import ionization as tion
from py21cmfast_torch.models import recomb as trecomb
from py21cmfast_tpu.models import ics as jics
from py21cmfast_tpu.models import ionization as jion
from py21cmfast_tpu.models import perturb as jpert
from py21cmfast_tpu.models import recomb as jrecomb
from py21cmfast_tpu.models import spintemp as jsp


def _numpy(struct):
    return {k: (None if v is None else np.asarray(v)) for k, v in vars(struct).items()}


@pytest.fixture(scope="module")
def chain():
    """The JAX chain; per node the perturbed field, TsBox, IonizedBox and the
    previous node's IonizedBox and redshift."""
    jinp = jax_inputs(
        USE_TS_FLUCT=True, RECOMB_MODEL="INHOMOGENEOUS", R_BUBBLE_MAX=20.0
    ).with_logspaced_redshifts(10.5, 25.0)
    ics = jics.compute_initial_conditions(jinp, initial_density=numpy_grf(jinp, seed=7))
    nodes, state, prev_ion, prev_z = [], None, None, None
    for z in jinp.node_redshifts:
        pf = jpert.perturb_field(z, jinp, ics)
        ts, state = jsp.compute_spin_temperature(z, jinp, pf, prev_state=state, prev_redshift=prev_z)
        ion = jion.compute_ionization_field(
            z, jinp, pf, previous_ionized_box=prev_ion, spin_temp=ts, prev_redshift=prev_z)
        nodes.append(dict(z=z, pf=pf, ts=ts, ion=ion, prev_ion=prev_ion, prev_z=prev_z))
        prev_ion, prev_z = ion, z
    return dict(jinp=jinp, nodes=nodes)


def _xh_gates(got, ref, ctx):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    flipped = np.mean(np.abs(got - ref) > 1e-3)
    assert flipped <= 1e-3, f"{ctx}: {flipped:.2e} of cells differ by > 1e-3"
    assert abs(got.mean() - ref.mean()) <= 1e-3, (ctx, got.mean(), ref.mean())


def _step_both(chain, node, with_ts, **over):
    """One ionization step of both packages from the chain's state."""
    nd = chain["nodes"][node]
    jinp = chain["jinp"].evolve_input_structs(**over) if over else chain["jinp"]
    ref = jion.compute_ionization_field(
        nd["z"], jinp, nd["pf"], previous_ionized_box=nd["prev_ion"],
        spin_temp=nd["ts"] if with_ts else None, prev_redshift=nd["prev_z"])
    got = tion.compute_ionization_field(
        nd["z"], port_inputs(jinp),
        interop.perturbed_field_from_numpy(_numpy(nd["pf"]), "cpu"),
        previous_ionized_box=(
            interop.ionized_box_from_numpy(_numpy(nd["prev_ion"]), "cpu")
            if nd["prev_ion"] is not None else None),
        spin_temp=interop.ts_box_from_numpy(_numpy(nd["ts"]), "cpu") if with_ts else None,
        prev_redshift=nd["prev_z"], device="cpu")
    return got, ref


def _assert_step_matches(got, ref, ctx):
    xh, xh_ref = got.neutral_fraction.numpy(), np.asarray(ref.neutral_fraction)
    _xh_gates(xh, xh_ref, ctx)
    np.testing.assert_allclose(got.mean_f_coll, ref.mean_f_coll, rtol=1e-6)
    same = np.abs(xh - xh_ref) <= 1e-6
    assert same.mean() > 0.99
    for name in ("cumulative_recombinations", "kinetic_temperature"):
        r = np.asarray(getattr(ref, name))
        g = getattr(got, name).numpy()
        err = np.abs(g - r)[same].max()
        assert err <= 1e-5 * np.abs(r).max(), f"{ctx} {name}: {err:.3e} vs max {np.abs(r).max():.3e}"


@pytest.mark.parametrize("with_ts", [True, False], ids=["TsBox", "no-TsBox"])
@pytest.mark.parametrize("cell_recomb", [True, False], ids=["CELL_RECOMB", "filtered-N_rec"])
@pytest.mark.parametrize("model", ["INHOMOGENEOUS", "HOMOGENEOUS"])
def test_ionization_step_matches_jax(chain, model, cell_recomb, with_ts):
    """The last node from the JAX package's previous box (N_rec up to ~3 per
    baryon), with and without the TsBox: the xH gates; N_rec and Tk max-abs
    <= 1e-5 of the maximum on cells whose ionization state agrees."""
    got, ref = _step_both(chain, -1, with_ts, RECOMB_MODEL=model, CELL_RECOMB=cell_recomb)
    assert 0.0 < ref.global_xH < 1.0
    assert float(np.asarray(chain["nodes"][-1]["prev_ion"].cumulative_recombinations).max()) > 0.1
    _assert_step_matches(got, ref, f"{model} cell={cell_recomb} ts={with_ts}")
    n_rec = got.cumulative_recombinations.numpy()
    assert np.all(n_rec >= 0) and n_rec.max() > 0


def test_ionization_step_const_ion_eff_matches_jax(chain):
    """CONST-ION-EFF (closed-form erfc) with the TsBox and filtered N_rec."""
    got, ref = _step_both(chain, -1, True, SOURCE_MODEL="CONST-ION-EFF", CELL_RECOMB=False)
    assert 0.0 < ref.global_xH < 1.0
    _assert_step_matches(got, ref, "CONST-ION-EFF")


def test_recombinations_change_the_answer(chain):
    """The previous box's N_rec, filtered at each R, reaches the criterion:
    with fifty times the recombinations fewer cells ionize, in the port as in
    the JAX package (same gates).  (With CELL_RECOMB the last step's partial
    ionization, which reads no N_rec, ionizes the same cells regardless.)"""
    import dataclasses

    base, _ = _step_both(chain, -1, True, CELL_RECOMB=False)
    prev = chain["nodes"][-1]["prev_ion"]
    heavy = dataclasses.replace(
        prev, cumulative_recombinations=prev.cumulative_recombinations * 50.0)
    nd = dict(chain["nodes"][-1], prev_ion=heavy)
    got, ref = _step_both(dict(chain, nodes=[nd]), 0, True, CELL_RECOMB=False)
    assert float(got.neutral_fraction.mean()) > float(base.neutral_fraction.mean()) + 1e-3
    assert int((got.neutral_fraction == 0).sum()) < int((base.neutral_fraction == 0).sum())
    _assert_step_matches(got, ref, "50 x N_rec")


def test_early_exit_takes_xh_from_the_ts_box(chain):
    """Where nothing ionizes yet (first node) xH = 1 - x_e of the TsBox, and
    no N_rec is made."""
    got, ref = _step_both(chain, 0, True)
    np.testing.assert_allclose(got.neutral_fraction.numpy(), np.asarray(ref.neutral_fraction), rtol=1e-7)
    assert got.cumulative_recombinations is None and ref.cumulative_recombinations is None
    assert float(got.neutral_fraction.max()) < 1.0


def test_recomb_tables_match_jax(chain):
    """The recombination-rate table and its evaluation: relative 1e-12."""
    jinp = chain["jinp"]
    ref = jrecomb.get_recomb_tables(jinp.cosmology)
    got = trecomb.get_recomb_tables(port_inputs(jinp).cosmology)
    np.testing.assert_allclose(got.table, ref.table, rtol=1e-12)
    np.testing.assert_allclose(got.ln_gamma, ref.ln_gamma, rtol=1e-12)
    z, g = np.array([6.3, 10.5, 17.0]), np.array([1e-3, 0.2, 5.0])
    np.testing.assert_allclose(got.evaluate(z, g), ref.evaluate(z, g), rtol=1e-12)


def test_recomb_update_matches_jax(chain):
    """_recomb_update on random grids: max-abs <= 1e-6 of the maximum where
    both pick the same redshift row of the table (the row is the nearest
    neighbour in z_eff, so a cell on a row boundary may take the other)."""
    rng = np.random.default_rng(4)
    shape = (12, 12, 12)
    rec = rng.uniform(0, 2, shape).astype(np.float32)
    dens = rng.normal(0, 0.6, shape).clip(-0.95).astype(np.float32)
    gamma = np.exp(rng.uniform(-12, 3, shape)).astype(np.float32)
    gamma[rng.uniform(size=shape) < 0.2] = 0.0
    xh = rng.uniform(0, 1, shape).astype(np.float32)
    rt = jrecomb.get_recomb_tables(chain["jinp"].cosmology)
    scal = [np.float32(v) for v in
            (rt.ln_gamma[0], jrecomb.RR_DEL_LNGAMMA, jrecomb.RR_DEL_Z, 10.5, 0.37)]
    ref = np.asarray(jion._recomb_update(
        *(jnp.asarray(a) for a in (rec, dens, gamma, xh)), jnp.asarray(rt.table, jnp.float32), *scal))
    got = tion._recomb_update(
        *(torch.from_numpy(a) for a in (rec, dens, gamma, xh)),
        torch.from_numpy(rt.table.astype(np.float32)), *(float(s) for s in scal)).numpy()
    z_eff = 11.5 * np.cbrt(1.0 + dens.astype(np.float64)) - 1.0
    off_boundary = np.abs((z_eff / 0.2) % 1.0 - 0.5) > 1e-4
    assert off_boundary.mean() > 0.99 and (ref > rec).mean() > 0.5
    assert np.abs(got - ref)[off_boundary].max() <= 1e-6 * ref.max()
