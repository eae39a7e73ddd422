"""The port's lightcone (py21cmfast_torch/lightconers.py, drivers/lightcone.py)
against the JAX package, on the golden "lightcone" configuration
(tests/produce_golden_data.py: HII_DIM=24, DIM=72, BOX_LEN=36, E-INTEGRAL,
saturated Ts, nodes z=14.6 -> 9), on the CPU.

Both packages run from the JAX package's own ICs of seed 1234, carried
across by py21cmfast_torch.interop (one JAX chain in this file).  Tolerances:
  lc_distances, lc_redshifts, slice schedule   identical;
  slice interpolation of one JAX coeval pair   max-abs <= 1e-6 max|field|
      (both interpolation kinds; float32 `lo (1 - w) + hi w` in two
      libraries);
  AngularLightconer.like_rectilinear           max-abs <= 1e-6 max|field|;
  the finished cone                            the gates of
      tests/test_golden.py:32-45 (global xH atol 5e-3, mean Tb rtol 5e-3 /
      atol 0.05, Tb power spectrum rtol 1e-2) against the stored gold and
      against JAX run_lightcone on the same ICs, and at most 1e-3 of the
      cells differ from JAX by more than 1e-3 max|Tb|;
  global quantities per node                   xH atol 1e-3, Tb 1e-3 max|Tb|;
  a checkpoint resumed after node 1            bit-identical to the
      uninterrupted run (port-written), or holding exactly the slices and
      means of the JAX-written file.
"""

import _torch_threads  # noqa: F401
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from produce_golden_data import BASE, GOLDEN_DIR, SEED
from test_torch_ics import port_inputs

import py21cmfast_tpu as j21
import py21cmfast_torch as t21
from py21cmfast_torch import interop
from py21cmfast_torch.drivers import lightcone as tlc
from py21cmfast_tpu.lightconers import AngularLightconer as JAngular
from py21cmfast_tpu.lightconers import RectilinearLightconer as JRect
from py21cmfast_tpu.ops import ps

REPO = Path(__file__).resolve().parent.parent


def _numpy(struct):
    return None if struct is None else {
        k: (None if v is None else np.asarray(v)) for k, v in vars(struct).items()}


def port_coeval(jcv):
    """A JAX Coeval carried into the port's Coeval on the CPU."""
    return interop.coeval_from_numpy(
        {"redshift": jcv.redshift,
         **{name: _numpy(getattr(jcv, name)) for name in (
             "initial_conditions", "perturbed_field", "ionized_box",
             "brightness_temperature", "spin_temp")}},
        "cpu",
    )


@pytest.fixture(scope="module")
def golden():
    """The golden "lightcone" run in both packages from the JAX ICs of seed
    1234, with the JAX coevals of every node."""
    jinp = j21.InputParameters(random_seed=SEED).evolve_input_structs(
        **BASE, SOURCE_MODEL="E-INTEGRAL").with_logspaced_redshifts(9.0, 14.0)
    j_ics = j21.compute_initial_conditions(jinp)
    j_cvs, j_lc = [], None
    for z, cv, j_lc in j21.generate_lightcone(jinp, initial_conditions=j_ics):
        if z is not None:
            j_cvs.append(cv)
    tinp = port_inputs(jinp)
    t_ics = interop.initial_conditions_from_numpy(_numpy(j_ics), "cpu")
    t_lc = t21.run_lightcone(tinp, initial_conditions=t_ics, device="cpu")
    return dict(jinp=jinp, tinp=tinp, j_ics=j_ics, t_ics=t_ics, j_cvs=j_cvs, j_lc=j_lc, t_lc=t_lc)


def _gold_numbers(lc, inputs):
    """What tests/produce_golden_data.py:run_config stores for a lightcone."""
    bt = np.asarray(lc.brightness_temp)
    so = inputs.simulation_options
    k, pk, _ = ps.power_spectrum_1d(bt[:, :, : so.HII_DIM], so.box_lens, n_bins=8)
    return dict(k=k, power=pk, global_xh=lc.global_quantities["neutral_fraction"],
                mean_tb=np.array([np.nanmean(bt)]))


def _assert_golden_gates(got, ref, ctx):
    """tests/test_golden.py:32-45."""
    np.testing.assert_allclose(got["global_xh"], ref["global_xh"], atol=5e-3, err_msg=ctx)
    np.testing.assert_allclose(got["mean_tb"], ref["mean_tb"], rtol=5e-3, atol=0.05, err_msg=ctx)
    g, p = np.asarray(ref["power"]), np.asarray(got["power"])
    good = np.isfinite(g) & (g > 0)
    np.testing.assert_allclose(p[good], g[good], rtol=1e-2, err_msg=ctx)


def assert_cone_share(got, ref, ctx, share=1e-3, rel=1e-3):
    """At most `share` of the cells differ by more than `rel` max|ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, ctx
    off = np.mean(np.abs(got - ref) > rel * np.abs(ref).max())
    assert off <= share, f"{ctx}: {off:.2e} of the cells differ by > {rel} max|ref|"


def test_lc_distances_and_redshifts_identical(golden):
    jinp, tinp = golden["jinp"], golden["tinp"]
    for z_lo, z_hi, res in ((9.0, 14.625, None), (5.0, 35.37, 1.5), (10.5, 27.1, 0.7)):
        j = JRect.with_equal_cdist_slices(z_lo, z_hi, jinp, resolution=res)
        t = t21.RectilinearLightconer.with_equal_cdist_slices(z_lo, z_hi, tinp, resolution=res)
        np.testing.assert_array_equal(t.lc_distances, j.lc_distances)
        np.testing.assert_array_equal(t.lc_redshifts(tinp.cosmology), j.lc_redshifts(jinp.cosmology))
    np.testing.assert_array_equal(golden["t_lc"].lc_redshifts, golden["j_lc"].lc_redshifts)


def test_slice_schedule_identical(golden):
    """Per node pair: the same slice indices, LoS pixels and float32 weights
    (the JAX package's are padded to a power of two)."""
    jinp, tinp = golden["jinp"], golden["tinp"]
    j_lcr, t_lcr = golden["j_lc"].lightconer, golden["t_lc"].lightconer
    cvs = golden["j_cvs"]
    n_written = 0
    for hi, lo in zip(cvs[:-1], cvs[1:]):
        j_idx, j_pix, j_w = j_lcr._slice_schedule(lo, hi, jinp.cosmology, jinp)
        t_idx, t_pix, t_w = t_lcr._slice_schedule(lo, hi, tinp.cosmology, tinp)
        n = len(j_idx)
        np.testing.assert_array_equal(t_idx, j_idx)
        np.testing.assert_array_equal(t_pix, j_pix[:n])
        np.testing.assert_array_equal(t_w, j_w[:n])
        assert t_w.dtype == np.float32
        n_written += n
    # every slice but one that lands exactly on the top node's distance
    assert n_written >= t_lcr.n_slices - 1


@pytest.mark.parametrize(
    "quantity", ["brightness_temp", "velocity_z", "density", "neutral_fraction", "z_reion"])
def test_slice_interpolation_matches_jax(golden, quantity):
    """The rectilinear slices of the same JAX coeval pair; z_reion takes the
    "mean_max" rule (-1 sentinels beside real redshifts), the rest "mean"."""
    jinp, tinp = golden["jinp"], golden["tinp"]
    hi, lo = golden["j_cvs"][-2], golden["j_cvs"][-1]
    j_idx, ref = golden["j_lc"].lightconer.make_lightcone_slices(lo, hi, jinp.cosmology, jinp, quantity)
    lcr = golden["t_lc"].lightconer
    assert lcr.interp_kinds.get(quantity, "mean") == ("mean_max" if quantity == "z_reion" else "mean")
    idx, vals = lcr.make_lightcone_slices(port_coeval(lo), port_coeval(hi), tinp.cosmology, tinp, quantity)
    assert isinstance(vals, torch.Tensor) and vals.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    if quantity == "z_reion":
        lo_f, hi_f = np.asarray(lo.ionized_box.z_reion), np.asarray(hi.ionized_box.z_reion)
        assert np.any(lo_f * hi_f < 0), "no cell straddles the sentinel"
    err = np.abs(vals.numpy() - ref).max()
    assert err <= 1e-6 * np.abs(ref).max(), f"{quantity}: {err:.3e}"


@pytest.mark.parametrize("quantity", ["brightness_temp", "density"])
def test_angular_like_rectilinear_matches_jax(golden, quantity):
    jinp, tinp = golden["jinp"], golden["tinp"]
    hi, lo = golden["j_cvs"][-2], golden["j_cvs"][-1]
    z_lo, z_hi = lo.redshift, golden["j_cvs"][0].redshift
    j_ang = JAngular.like_rectilinear(z_lo, z_hi, jinp)
    t_ang = t21.AngularLightconer.like_rectilinear(z_lo, z_hi, tinp)
    np.testing.assert_array_equal(t_ang.sightlines, j_ang.sightlines)
    assert t_ang.shape2d == j_ang.shape2d
    j_idx, ref = j_ang.make_lightcone_slices(lo, hi, jinp.cosmology, jinp, quantity)
    idx, vals = t_ang.make_lightcone_slices(port_coeval(lo), port_coeval(hi), tinp.cosmology, tinp, quantity)
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    assert tuple(vals.shape) == ref.shape and vals.dtype == torch.float32
    assert np.abs(vals.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


def test_golden_lightcone_meets_gold_gates(golden):
    gold = np.load(GOLDEN_DIR / "lightcone.npz")
    _assert_golden_gates(_gold_numbers(golden["t_lc"], golden["tinp"]), gold, "port vs gold")


def test_golden_lightcone_matches_jax(golden):
    t_lc, j_lc = golden["t_lc"], golden["j_lc"]
    _assert_golden_gates(_gold_numbers(t_lc, golden["tinp"]),
                         _gold_numbers(j_lc, golden["jinp"]), "port vs JAX")
    assert set(t_lc.lightcones) == set(j_lc.lightcones) == {"brightness_temp", "velocity_z"}
    for q, ref in j_lc.lightcones.items():
        assert_cone_share(t_lc.lightcones[q].numpy(), ref, q)
    np.testing.assert_array_equal(t_lc.node_redshifts, j_lc.node_redshifts)


def test_global_quantities_match_jax(golden):
    t_gq, j_gq = golden["t_lc"].global_quantities, golden["j_lc"].global_quantities
    assert set(t_gq) == set(j_gq) == {"brightness_temp", "neutral_fraction"}
    for q in t_gq:
        assert t_gq[q].dtype == np.float64 and len(t_gq[q]) == len(golden["j_cvs"]) == 3
    np.testing.assert_allclose(t_gq["neutral_fraction"], j_gq["neutral_fraction"], atol=1e-3)
    tb_max = np.abs(golden["j_lc"].brightness_temp).max()
    np.testing.assert_allclose(t_gq["brightness_temp"], j_gq["brightness_temp"], atol=1e-3 * tb_max)
    assert golden["t_lc"].global_xH[-1] < golden["t_lc"].global_xH[0]


def test_lightcone_structure(golden):
    lc, tinp = golden["t_lc"], golden["tinp"]
    assert lc.shape == (24, 24, lc.lightconer.n_slices) == golden["j_lc"].shape
    for t in lc.lightcones.values():
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        assert torch.isfinite(t).all()
    out = lc.to_numpy()
    np.testing.assert_array_equal(out["brightness_temp"], lc.brightness_temp.numpy())
    assert np.all(np.diff(lc.lc_distances) > 0) and np.all(np.diff(lc.lc_redshifts) > 0)
    assert abs(lc.lc_redshifts[0] - 9.0) < 1e-3  # a 4096-point redshift grid
    # every slice but the top boundary one holds a velocity
    written = (lc.lightcones["velocity_z"] != 0).any(dim=0).any(dim=0).numpy()
    assert written[:-1].all()


def _run_to_node(gen, k):
    """Advance a generate_lightcone generator through node k, then close it."""
    for i, (z, _, _) in enumerate(gen):
        if i == k:
            break
    gen.close()


def test_port_checkpoint_resume_equals_uninterrupted(golden, tmp_path):
    tinp, t_ics = golden["tinp"], golden["t_ics"]
    path = tmp_path / "lc.h5"
    _run_to_node(t21.generate_lightcone(
        tinp, initial_conditions=t_ics, checkpoint_path=path, device="cpu"), 1)
    import h5py

    with h5py.File(path, "r") as f:
        assert f.attrs["_last_completed_node"] == 1 and f.attrs["full_hash"] == tinp.full_hash
        assert len(f["global_quantities"]["neutral_fraction"]) == 2
    resumed = t21.run_lightcone(tinp, initial_conditions=t_ics, checkpoint_path=path, device="cpu")
    full = golden["t_lc"]
    for q, t in full.lightcones.items():
        np.testing.assert_array_equal(resumed.lightcones[q].numpy(), t.numpy(), err_msg=q)
    for q, v in full.global_quantities.items():
        np.testing.assert_array_equal(resumed.global_quantities[q], v)


def test_jax_checkpoint_resumes_in_port(golden, tmp_path):
    """A JAX-written checkpoint after node 1 (same inputs, same hash): the
    port resumes from it, so the slices written up to node 1 and the means
    of nodes 0-1 are the file's, bit for bit, and the later slices are the
    port's own (finalization off, to read the raw slices)."""
    jinp, tinp, t_ics = golden["jinp"], golden["tinp"], golden["t_ics"]
    path = tmp_path / "jax_lc.h5"
    _run_to_node(j21.generate_lightcone(
        jinp, initial_conditions=golden["j_ics"], checkpoint_path=str(path)), 1)
    import h5py

    with h5py.File(path, "r") as f:
        assert f.attrs["_last_completed_node"] == 1
        saved = {q: f["lightcones"][q][...] for q in f["lightcones"]}
        saved_gq = {q: f["global_quantities"][q][...] for q in f["global_quantities"]}
    raw = dict(include_dvdr_in_tau21=False, apply_rsds=False, initial_conditions=t_ics, device="cpu")
    resumed = t21.run_lightcone(tinp, checkpoint_path=path, **raw)
    own = t21.run_lightcone(tinp, **raw)
    bt_saved = saved["brightness_temp"]
    from_file = (bt_saved != 0).any(axis=(0, 1))
    assert from_file.any() and not from_file.all()
    got = resumed.lightcones["brightness_temp"].numpy()
    np.testing.assert_array_equal(got[:, :, from_file], bt_saved[:, :, from_file])
    np.testing.assert_array_equal(got[:, :, ~from_file], own.lightcones["brightness_temp"].numpy()[:, :, ~from_file])
    for q, v in saved_gq.items():
        np.testing.assert_array_equal(resumed.global_quantities[q][:2], v)
        np.testing.assert_array_equal(resumed.global_quantities[q][2:], own.global_quantities[q][2:])


def test_checkpoint_of_other_inputs_is_ignored(golden, tmp_path):
    tinp, t_ics = golden["tinp"], golden["t_ics"]
    path = tmp_path / "lc.h5"
    other = tinp.evolve_input_structs(random_seed=tinp.random_seed + 1)
    tlc._checkpoint_save(path, other, {"brightness_temp": torch.ones(2, 2, 2)}, {}, 5)
    cones = {"brightness_temp": torch.zeros(2, 2, 2)}
    assert tlc._checkpoint_load(path, tinp, cones, {}) == -1
    assert not cones["brightness_temp"].any()
    assert tlc._checkpoint_load(path, other, cones, {}) == 5
    assert cones["brightness_temp"].all()


def test_h5py_is_imported_only_for_a_checkpoint():
    code = (
        "import sys, py21cmfast_torch as t; "
        "inp = t.InputParameters(random_seed=2).evolve_input_structs(HII_DIM=8, DIM=16, "
        "BOX_LEN=16.0, SOURCE_MODEL='E-INTEGRAL').with_logspaced_redshifts(8.0, 10.0); "
        "lc = t.run_lightcone(inp, device='cpu'); "
        "assert lc.shape[:2] == (8, 8), lc.shape; "
        "sys.exit(1 if 'h5py' in sys.modules else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
