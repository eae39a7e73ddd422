"""The port's evolving coeval (node-redshift scroll) against the JAX package,
at golden size (HII_DIM=24, DIM=72, BOX_LEN=36, ZPRIME_STEP_FACTOR=1.25,
Z_HEAT_MAX=25, z=10.5), on the CPU.

Both packages run the whole chain through `run_coeval` from ICs made of one
shared numpy hires density, under the gates of tests/test_golden.py:
  global xH atol 5e-3; mean Tb rtol 5e-3 / atol 0.05; Tb power spectrum rtol
  1e-2;
with a spin temperature also, at the last node:
  mean Tk and mean Ts within 1e-3 of the JAX package's mean, and every cell
  of Tk, Ts within 1e-4 of its own value.  (Tk is heavy-tailed: at z=10.5 a
  few cells next to sources reach 4000 K against a mean of 29 K, so float32
  rounding of 4e-6 in such a cell is 0.6e-3 of the mean; a per-cell max-abs
  against the mean would measure the tail, not the agreement.)
Plus the scroll's own contract: which redshifts it visits and yields, what it
hands from node to node, and what it still refuses.
"""

import _torch_threads  # noqa: F401
import numpy as np
import pytest
from test_torch_ics import jax_inputs, numpy_grf, port_inputs

import py21cmfast_torch as t21
from py21cmfast_torch.drivers import coeval as tcoeval
from py21cmfast_torch.models import spintemp as tsp
from py21cmfast_tpu.drivers.coeval import run_coeval as j_run_coeval
from py21cmfast_tpu.models import ics as jics
from py21cmfast_tpu.ops import ps

REDSHIFT = 10.5
CHAINS = {
    "ts": dict(USE_TS_FLUCT=True),
    "inhomo": dict(RECOMB_MODEL="INHOMOGENEOUS", R_BUBBLE_MAX=20.0),
    "ts+inhomo": dict(USE_TS_FLUCT=True, RECOMB_MODEL="INHOMOGENEOUS", R_BUBBLE_MAX=20.0),
    "ts+homogeneous,CONST-ION-EFF": dict(
        USE_TS_FLUCT=True, RECOMB_MODEL="HOMOGENEOUS", SOURCE_MODEL="CONST-ION-EFF"),
}


@pytest.mark.filterwarnings("ignore:R_BUBBLE_MAX")
@pytest.mark.parametrize("name", CHAINS)
def test_evolving_coeval_meets_golden_gates_against_jax(name):
    jinp = jax_inputs(**CHAINS[name]).with_logspaced_redshifts(REDSHIFT, 25.0)
    tinp = port_inputs(jinp)
    assert len(tinp.node_redshifts) == 5
    dens = numpy_grf(jinp, seed=5)
    ref = j_run_coeval(
        jinp, REDSHIFT, initial_conditions=jics.compute_initial_conditions(jinp, initial_density=dens))
    ics = t21.compute_initial_conditions(tinp, initial_density=dens, device="cpu")
    got = t21.run_coeval(tinp, REDSHIFT, initial_conditions=ics, device="cpu")

    box_lens = jinp.simulation_options.box_lens
    bt, bt_ref = got.brightness_temp.numpy(), np.asarray(ref.brightness_temp)
    xh_ref = np.asarray(ref.neutral_fraction).mean()
    assert 0.0 < xh_ref < 1.0
    np.testing.assert_allclose(got.neutral_fraction.numpy().mean(), xh_ref, atol=5e-3)
    np.testing.assert_allclose(bt.mean(), bt_ref.mean(), rtol=5e-3, atol=0.05)
    _, p, _ = ps.power_spectrum_1d(bt, box_lens, n_bins=8)
    _, p_ref, _ = ps.power_spectrum_1d(bt_ref, box_lens, n_bins=8)
    good = np.isfinite(p_ref) & (p_ref > 0)
    np.testing.assert_allclose(p[good], p_ref[good], rtol=1e-2)

    if CHAINS[name].get("USE_TS_FLUCT"):
        for field in ("kinetic_temp_neutral", "spin_temperature"):
            g = getattr(got.spin_temp, field).numpy().astype(np.float64)
            r = np.asarray(getattr(ref.spin_temp, field), np.float64)
            np.testing.assert_allclose(g.mean(), r.mean(), rtol=1e-3, err_msg=field)
            np.testing.assert_allclose(g, r, rtol=1e-4, err_msg=field)
        assert got.brightness_temperature.tau_21 is not None
    else:
        assert got.spin_temp is None
    if "RECOMB_MODEL" in CHAINS[name]:
        n_rec = got.ionized_box.cumulative_recombinations.numpy()
        n_ref = np.asarray(ref.ionized_box.cumulative_recombinations)
        assert n_ref.max() > 0
        np.testing.assert_allclose(n_rec.mean(), n_ref.mean(), rtol=5e-3)


def _small_inputs(**over):
    base = dict(HII_DIM=8, DIM=16, BOX_LEN=16.0, SOURCE_MODEL="E-INTEGRAL",
                ZPRIME_STEP_FACTOR=1.3, Z_HEAT_MAX=20.0, N_STEP_TS=6)
    return t21.InputParameters(random_seed=3).evolve_input_structs(**{**base, **over})


@pytest.fixture
def calls(monkeypatch):
    """Records the redshift of every perturb / Ts / prefetch / ionize call of
    generate_coeval, and what each ionize and Ts call was handed."""
    log = {"perturb": [], "ts": [], "prefetch": [], "ionize": [], "order": []}
    perturb_field = tcoeval.perturb.perturb_field
    compute_ts = tsp.compute_spin_temperature
    prefetch = tsp.prefetch_sfrd_tables
    ionize = tcoeval.ionization.compute_ionization_field

    def rec_perturb(z, *a, **kw):
        log["perturb"].append(z)
        log["order"].append(("perturb", z))
        return perturb_field(z, *a, **kw)

    def rec_ts(z, *a, **kw):
        log["ts"].append((z, kw["prev_state"], kw["prev_redshift"]))
        log["order"].append(("ts", z))
        return compute_ts(z, *a, **kw)

    def rec_prefetch(z, inputs):
        log["prefetch"].append(z)
        log["order"].append(("prefetch", z))
        return prefetch(z, inputs)

    def rec_ionize(z, *a, **kw):
        log["ionize"].append((z, kw["previous_ionized_box"], kw["spin_temp"], kw["prev_redshift"]))
        log["order"].append(("ionize", z))
        return ionize(z, *a, **kw)

    monkeypatch.setattr(tcoeval.perturb, "perturb_field", rec_perturb)
    monkeypatch.setattr(tsp, "compute_spin_temperature", rec_ts)
    monkeypatch.setattr(tsp, "prefetch_sfrd_tables", rec_prefetch)
    monkeypatch.setattr(tcoeval.ionization, "compute_ionization_field", rec_ionize)
    return log


def test_scroll_visits_every_node_and_yields_only_the_requested(calls):
    """Requested 9.0 (on no node) and the last node: the union is visited
    highest first with one perturb per node, two Coevals come out."""
    inp = _small_inputs(USE_TS_FLUCT=True).with_logspaced_redshifts(7.0, 14.0)
    nodes = list(inp.node_redshifts)
    assert len(nodes) >= 3 and 9.0 not in nodes
    out = list(t21.generate_coeval(inp, [nodes[-1], 9.0], device="cpu"))
    visited = sorted(nodes + [9.0], reverse=True)
    assert calls["perturb"] == visited
    assert [c.redshift for c in out] == [9.0, nodes[-1]]
    assert all(c.spin_temp is not None and float(c.spin_temp.redshift) == np.float32(c.redshift)
               for c in out)
    assert all(c.initial_conditions is out[0].initial_conditions for c in out)


def test_scroll_call_order_and_carried_state(calls):
    """perturb -> Ts -> prefetch of the next node -> ionize at every node; the
    Ts state, the slimmed previous IonizedBox and the previous redshift are
    what the next node gets."""
    inp = _small_inputs(
        USE_TS_FLUCT=True, RECOMB_MODEL="INHOMOGENEOUS", R_BUBBLE_MAX=5.0
    ).with_logspaced_redshifts(7.0, 14.0)
    nodes = list(inp.node_redshifts)
    out = t21.run_coeval(inp, nodes[-1], device="cpu")
    assert out.redshift == nodes[-1]
    expect = []
    for i, z in enumerate(nodes):
        expect += [("perturb", z), ("ts", z)]
        if i + 1 < len(nodes):
            expect.append(("prefetch", nodes[i + 1]))
        expect.append(("ionize", z))
    assert calls["order"] == expect
    assert not tsp._SFRD_PREFETCH["futs"]  # every prefetched table was taken

    assert calls["ts"][0][1:] == (None, None) and calls["ionize"][0][1] is None
    for i in range(1, len(nodes)):
        z, prev_state, prev_z = calls["ts"][i]
        assert prev_z == nodes[i - 1] and float(prev_state.redshift) == np.float32(nodes[i - 1])
        z, prev_ion, ts, prev_z = calls["ionize"][i]
        assert prev_z == nodes[i - 1] and float(ts.redshift) == np.float32(z)
        assert float(prev_ion.redshift) == np.float32(nodes[i - 1])
        assert prev_ion.neutral_fraction is None and prev_ion.kinetic_temperature is None
        assert prev_ion.mean_free_path is None and prev_ion.z_reion is not None
        assert prev_ion.cumulative_recombinations is not None
    assert out.ionized_box.neutral_fraction is not None
    assert out.ionized_box.cumulative_recombinations is not None


def test_no_requested_redshift_yields_every_node(calls):
    inp = _small_inputs().with_logspaced_redshifts(7.0, 10.0)
    out = list(t21.generate_coeval(inp, device="cpu"))
    assert [c.redshift for c in out] == list(inp.node_redshifts) == calls["perturb"]
    assert not calls["ts"] and all(c.spin_temp is None for c in out)
    # the nodes couple the snapshots: z_reion is carried down the ladder
    assert all(ion[1] is not None for ion in calls["ionize"][1:])
    z_re = out[-1].ionized_box.z_reion
    assert float(z_re.max()) > out[-1].redshift


def test_no_evolution_means_no_coupling(calls):
    """Without nodes, Ts and recombinations every redshift is on its own."""
    out = t21.run_coeval(_small_inputs(), [8.0, 7.0], device="cpu")
    assert [c.redshift for c in out] == [8.0, 7.0]
    assert all(ion[1] is None for ion in calls["ionize"])


@pytest.mark.parametrize(
    "over, item",
    [
        (dict(USE_TS_FLUCT=True, USE_MINI_HALOS=True), None),
        (dict(USE_TS_FLUCT=True, SOURCE_MODEL="L-INTEGRAL"), None),
        (dict(USE_TS_FLUCT=True, HEAT_FILTER="SHARP-K"), None),
        (dict(RECOMB_MODEL="INHOMOGENEOUS", IONISE_ENTIRE_SPHERE=True, R_BUBBLE_MAX=5.0), None),
        (dict(USE_TS_FLUCT=True, SOURCE_MODEL="CHMF-SAMPLER"), None),
        (dict(USE_TS_FLUCT=True, SOURCE_MODEL="CHMF-SAMPLER", SAMPLE_METHOD="NUMBER-LIMITED",
              USE_MINI_HALOS=True), None),
        (dict(USE_TS_FLUCT=True, SOURCE_MODEL="CHMF-SAMPLER", SAMPLE_METHOD="PARTITION"), None),
        (dict(USE_TS_FLUCT=True, PHOTON_CONS_TYPE="Z-PHOTONCONS"), None),
        (dict(USE_TS_FLUCT=True, SOURCE_MODEL="DEXM-ESF", SAMPLE_METHOD="BINARY-SPLIT"), None),
        (dict(USE_TS_FLUCT=True), 16),
        (dict(USE_TS_FLUCT=True), 17),
    ],
    # the CHMF-SAMPLER, PARTITION and Z-PHOTONCONS cases keep the ids they
    # had while they raised
    ids=["minihalos", "L-INTEGRAL", "sharp-k-heat-filter-runs", "IONISE_ENTIRE_SPHERE",
         "CHMF-SAMPLER-raises", "CHMF-SAMPLER+NUMBER-LIMITED+minihalos", "PARTITION-raises",
         "Z-PHOTONCONS-raises", "BINARY-SPLIT", "cache-raises", "mesh-raises"],
)
def test_evolving_options_outside_the_slice_raise(over, item, tmp_path):
    """Every evolving option runs down the node ladder.  A device mesh (item
    17) runs too: the sharded scroll on a gloo mesh of one rank meets the
    single-device scroll, and a mesh that is not a parallel.mesh.Mesh
    raises.  The output cache (item 16) runs:
    a scroll with one writes every node, a second run resumes from it to the
    same boxes, and a cache that is not an OutputCache raises."""
    inp = _small_inputs(**over).with_logspaced_redshifts(8.0, 12.0)
    if item == 16:
        cache = t21.OutputCache(tmp_path)
        first = t21.run_coeval(inp, 8.0, cache=cache, device="cpu")
        assert t21.RunCache(cache, inp).last_complete_node() == len(inp.node_redshifts) - 1
        again = t21.run_coeval(inp, 8.0, cache=cache, device="cpu")
        np.testing.assert_array_equal(again.brightness_temp.numpy(), first.brightness_temp.numpy())
        np.testing.assert_array_equal(again.spin_temp.spin_temperature.numpy(),
                                      first.spin_temp.spin_temperature.numpy())
        with pytest.raises(TypeError, match="OutputCache"):
            t21.run_coeval(inp, 8.0, cache=object(), device="cpu")
        return
    if item is None:
        out = t21.run_coeval(inp, 8.0, device="cpu")
        if inp.astro_options.PHOTON_CONS_TYPE != "NO-PHOTONCONS":
            # the box keeps its node's redshift, computed at the shifted one
            state = t21.setup_photon_cons(inp, device="cpu")
            assert state.adjusted_redshift(8.0) < 8.0 and float(out.ionized_box.redshift) == 8.0
        if inp.matter_options.source_model_uses_halo_sampler:
            assert float(out.halobox.count.sum()) > 0.0
        assert np.isfinite(out.brightness_temp.numpy()).all()
        if out.spin_temp is not None:
            assert np.isfinite(out.spin_temp.spin_temperature.numpy()).all()
        if inp.matter_options.source_model_uses_lagrangian_grids:
            # the fixed-grid or sampled sources: a HaloBox at every node
            assert np.isfinite(out.halobox.halo_sfr.numpy()).all()
            assert float(out.halobox.halo_xray.max()) > 0.0
        if inp.astro_options.IONISE_ENTIRE_SPHERE:
            assert float(out.ionized_box.neutral_fraction.min()) == 0.0
        if inp.astro_options.USE_MINI_HALOS:
            # the minihalo state is carried down the node ladder
            assert np.isfinite(out.spin_temp.J_21_LW.numpy()).all()
            assert float(out.spin_temp.J_21_LW.max()) > 0.0
            if inp.matter_options.source_model_uses_lagrangian_grids:
                # the MCG sources come with the HaloBox
                assert float(out.halobox.halo_sfr_mini.max()) > 0.0
                assert float(out.halobox.log10_Mcrit_MCG_ave) > 5.0
            else:
                assert out.ionized_box.unnormalised_nion_mini.ndim == 4
                assert float(out.ionized_box.log10_Mturnover_MINI_ave) > 5.0
        return
    from _torch_parallel import one_rank_mesh

    from py21cmfast_torch.parallel.driver import run_sharded_coeval

    assert item == 17
    with one_rank_mesh(tmp_path) as mesh:
        (got,) = run_sharded_coeval(inp, [8.0], mesh=mesh)
    ref = t21.run_coeval(inp, 8.0, device="cpu")
    ts, ts_ref = got.spin_temperature.numpy(), ref.spin_temp.spin_temperature.numpy()
    assert np.abs(ts - ts_ref).max() <= 1e-4 * np.abs(ts_ref).max()
    xh, xh_ref = got.neutral_fraction.numpy(), ref.neutral_fraction.numpy()
    assert abs(xh.mean() - xh_ref.mean()) < 1e-3
    assert np.mean(np.round(xh, 3) != np.round(xh_ref, 3)) < 5e-3
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        tsp.compute_spin_temperature(8.0, inp, None, mesh=object(), device="cpu")
