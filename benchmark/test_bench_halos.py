"""The reference's halo-sampler path: a golden-size cone of upstream's
`latest-discrete` (CHMF-SAMPLER sources, MASS-LIMITED progenitors, the spin
temperature, inhomogeneous recombinations, dvdr and RSDs) through the
harness's whole run on the CPU, from a cell built here, against the
reference fed the cone's own catalogs, with the bfloat16 control and the
catalog gate; and that no halo code runs for the configurations without a
sampler.
"""

import math
import time

import numpy as np
import pytest
import torch
from conftest import SEED

from harness import cells, compare, loop, reference

CPU = torch.device("cpu")
# latest-256-768's [params] with upstream latest-discrete's sources, at a
# golden box: 16^3 cells of 3.125 Mpc (BOX_LEN as R_BUBBLE_MAX allows), DIM
# 48, and a short ladder: Z_HEAT_MAX 17 and steps of 1.05 in (1 + z) down
# to z = 13, where the lowest node holds some 6e4 halos
GOLDEN = dict(HII_DIM=16, DIM=48, BOX_LEN=50.0, SOURCE_MODEL="CHMF-SAMPLER", USE_TS_FLUCT=True,
              RECOMB_MODEL="INHOMOGENEOUS", R_BUBBLE_MAX=50.0, USE_EXP_FILTER=True,
              CELL_RECOMB=True, MINIMIZE_MEMORY=False, Z_HEAT_MAX=17.0, ZPRIME_STEP_FACTOR=1.05)
TRAFFIC = dict(loop="closed", z_min=13.0, include_dvdr_in_tau21=True, apply_rsds=True,
               quantities=["brightness_temp", "density", "spin_temperature",
                           "xray_ionised_fraction", "neutral_fraction"])
# each number's limit, lower^(1/3) upper^(2/3) as the cells' own, from the
# largest reading of the program against the reference (lower) and the
# smallest of the control (upper) over the seeds SEED to SEED + 5
LIMITS = {"ics": 1.5e-4, "Tb": 3e-4, "density": 1.8e-4, "Ts": 1e-4, "x_e": 9e-5, "xH": 8e-5,
          "tau21": 2e-4, "v_z": 1.2e-4}
SEEDS = (SEED, SEED + 1, SEED + 2)
GATE = {"halo_count", "halo_octaves", "step_octaves", "rng_mean", "rng_var"}


def golden_cell(params=None):
    bench = cells.load_benchmark()
    return cells.Cell(
        name="golden-discrete", chips=1, config_name="golden-discrete",
        config={"params": dict(GOLDEN, **(params or {}))}, traffic_name="golden",
        traffic=dict(TRAFFIC), end_to_end=tuple(bench["end_to_end"]), per_layer=(),
        limits={k: {"limit": v} for k, v in LIMITS.items()})


def run_golden(seed, monkeypatch=None, cell=None):
    """The harness's whole run of the golden cell at `seed`; returns the
    result and the reference's cone and catalogs."""
    kept = {}
    plain = reference.cone

    def cone(*a, **kw):
        kept["cone"], kept["catalogs"] = plain(*a, **kw), kw.get("catalogs")
        return kept["cone"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(reference, "cone", cone)
        result, lines = loop.run(cell or golden_cell(), seed, 0.0, False, CPU, time.perf_counter())
    return result, lines, kept


@pytest.fixture(scope="module")
def golden_runs():
    """Each seed's result and the control's readings against the same
    reference cone, the control fed the same catalogs."""
    out = []
    cell = golden_cell()
    for seed in SEEDS:
        result, lines, kept = run_golden(seed, cell=cell)
        ref_ics = reference.initial_conditions(cell, seed, CPU)
        ctl_ics = reference.initial_conditions(cell, seed, CPU, precision="bfloat16")
        control = {"ics": compare.ics_reading(ctl_ics, ref_ics)}
        control.update(compare.cone_readings(reference.cone(
            cell, seed, ctl_ics, CPU, precision="bfloat16", catalogs=kept["catalogs"]),
            kept["cone"]))
        out.append((seed, result, lines, control))
    return out


def test_the_golden_discrete_cone_is_correct(golden_runs):
    for seed, result, lines, _ in golden_runs:
        assert result["attempted"] == 1 and result["failed"] == 0
        assert set(result["checks"]) == set(LIMITS) | GATE, seed
        assert result["correct"] is True, (seed, lines)


def test_the_program_reads_ten_times_under_the_control(golden_runs):
    for seed, result, _, control in golden_runs:
        for name in LIMITS:
            prog = result["checks"][name]["value"]
            assert control[name] > LIMITS[name], (seed, name, control[name])
            assert 10 * prog <= control[name], (seed, name, prog, control[name])


def test_the_lowest_node_holds_halos_enough_for_the_gate(golden_runs):
    """The gate's count tells a 3% loss: its limit lies under 3%."""
    for seed, result, _, _ in golden_runs:
        assert result["checks"]["halo_count"]["limit"] < 0.02, seed


def _inputs(cls, workload):
    return cells.build_inputs(cls, cells.resolve(workload), SEED)


@pytest.mark.parametrize("workload", ["latest-dawn", "simple-eor", "faithful-dawn", "latest-eor"])
def test_no_halo_code_runs_for_the_cells_without_a_sampler(workload):
    import py21cmfast_torch as p21
    import ref21cm

    for cls in (p21.InputParameters, ref21cm.InputParameters):
        assert not _inputs(cls, workload).matter_options.source_model_uses_halo_sampler


def test_the_reference_cone_of_a_cell_without_a_sampler_takes_no_halo_path(monkeypatch):
    from conftest import TINY
    from ref21cm import halos

    def refused(*a, **kw):
        raise AssertionError("halo code ran")

    for name in ("perturb_catalog", "halo_box", "xray_source_box"):
        monkeypatch.setattr(halos, name, refused)
    cell = cells.resolve("simple-eor")
    tiny = TINY[cell.config_name]
    ics = reference.initial_conditions(cell, SEED, CPU, tiny)
    cone = reference.cone(cell, SEED, ics, CPU, tiny)
    assert all(bool(torch.isfinite(t).all()) for t in cone.values())


@pytest.mark.parametrize("params,what", [
    (dict(SOURCE_MODEL="L-INTEGRAL", USE_UPPER_STELLAR_TURNOVER=False), "SOURCE_MODEL"),
    (dict(SOURCE_MODEL="DEXM-ESF"), "SOURCE_MODEL"),
    (dict(USE_MINI_HALOS=True, M_TURN=8.0), "USE_MINI_HALOS"),
])
def test_the_reference_refuses_what_it_does_not_cover(params, what):
    import ref21cm
    from ref21cm import plain

    inputs = ref21cm.InputParameters(random_seed=SEED).evolve_input_structs(
        **dict(GOLDEN, **params))
    with pytest.raises(NotImplementedError, match=what):
        plain._check(inputs)


def test_the_gate_reads_the_reference_own_dexm_levels():
    """DexM's level masses lead the lowest catalog: the gate finds them."""
    import ref21cm
    from ref21cm import gate

    inputs = cells.build_inputs(ref21cm.InputParameters, golden_cell(), SEED)
    levels = gate.dexm_levels(inputs)
    assert levels.dtype == np.float32 and np.all(np.diff(levels) > 0)
    so = inputs.simulation_options
    cell_mass = inputs.cosmology.rho_mean * (so.box_len / so.dim) ** 3
    assert math.isclose(levels[0], cell_mass, rel_tol=1e-6)


def test_a_configuration_no_cell_names_resolves_from_its_files(tmp_path):
    """`calibrate.py --config --traffic` reads a configuration before its
    cell exists."""
    import ref21cm

    path = tmp_path / "golden-discrete.toml"
    path.write_text('name = "golden-discrete"\nsource = "test"\nreduced = []\n[params]\n'
                    + "".join(f"{k} = {str(v).lower() if isinstance(v, bool) else repr(v)}\n"
                              for k, v in GOLDEN.items()).replace("'", '"'))
    cell = cells.from_files(path, "dawn")
    assert (cell.name, cell.chips, cell.limits) == ("golden-discrete.dawn", 1, {})
    assert cell.config["params"] == GOLDEN and cell.traffic["z_min"] == 22.0
    inputs = cells.build_inputs(ref21cm.InputParameters, cell, SEED)
    assert inputs.matter_options.source_model_uses_halo_sampler
