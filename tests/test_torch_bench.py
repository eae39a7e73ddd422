"""bench_torch.py, the port's benchmark, against bench.py, and the
MINIMIZE_MEMORY path that its faithful segment (full1024) runs, against the
JAX package.

MINIMIZE_MEMORY drops IonizedBox.kinetic_temperature and the per-cell mean
free path (py21cmfast_torch/models/ionization.py, as
py21cmfast_tpu/models/ionization.py).  The chain here runs bench.py's
physics (_headline_inputs: E-INTEGRAL, USE_TS_FLUCT, INHOMOGENEOUS,
R_BUBBLE_MAX=50, no exp filter, no cell recombinations) with MINIMIZE_MEMORY
on at DIM = 4 HII_DIM, the faithful segment's ratio: HII_DIM=16, DIM=64 in
BOX_LEN=50 (the smallest box that R_BUBBLE_MAX=50 allows in both packages),
5 nodes from z=22 to z=5.  Both packages' generate_coeval run from one numpy
hires density, node by node, with the tolerances of
tests/test_torch_parity_scale.py (its 2**-24 / tau term included); x_e, which
that file does not compare, has Tk's rule.

The JAX package's scroll frees the hires density after the first perturb
under MINIMIZE_MEMORY (release_hires, py21cmfast_tpu/drivers/coeval.py:203-259),
but its staged deposit, which runs off the TPU and on any lowres grid whose z
extent is no multiple of 128 (py21cmfast_tpu/models/perturb.py:394-430),
reads that density at every node: the chain raises at its second node.  The
JAX chain is therefore handed its ICs with the hires density as a numpy
array, which the release skips (it deletes only what has a `delete`).  The
port keeps no release_hires.

run_full_lightcone runs on the CPU at the smallest box bench.py's rule
BOX_LEN = 1.5 HII_DIM allows with R_BUBBLE_MAX=50 (HII_DIM=34, DIM=136 in 51
Mpc, MINIMIZE_MEMORY on), 3 nodes.
"""

import _torch_threads  # noqa: F401
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import attrs
import numpy as np
import pytest
import torch
from test_torch_ics import numpy_grf, port_inputs
from test_torch_parity_scale import CAP_SHARE, DELTA_T, HEADLINE, _assert_parity, _node, _report

import bench
import bench_torch
import py21cmfast_torch as t21
from py21cmfast_tpu.drivers.coeval import generate_coeval as j_generate_coeval
from py21cmfast_tpu.inputs import InputParameters as JInputs
from py21cmfast_tpu.models import ics as jics

REPO = Path(__file__).resolve().parent.parent
BENCH_KEYS = {"total_s", "t_ics_s", "n_nodes", "node_median_s", "node_p90_s", "finalize_s",
              "global_xh_end"}
CHAIN_BOX = dict(HII_DIM=16, DIM=64, BOX_LEN=50.0, Z_HEAT_MAX=20.0, ZPRIME_STEP_FACTOR=1.4,
                 MINIMIZE_MEMORY=True)
# (z_min, Z_HEAT_MAX, ZPRIME_STEP_FACTOR) of the CPU lightcone: 3 nodes
LC_SIZE, LC_LADDER = (34, 136), (8.0, 14.0, 1.3)
GROUPS = ("cosmo_params", "matter_options", "simulation_options", "astro_options", "astro_params")


def _plain(inputs):
    return {**{g: attrs.asdict(getattr(inputs, g)) for g in GROUPS},
            "random_seed": inputs.random_seed, "node_redshifts": list(inputs.node_redshifts)}


@pytest.mark.parametrize("hii_dim, dim", [(256, 768), (256, 1024)])
def test_headline_inputs_equal_bench_py(hii_dim, dim):
    args = (hii_dim, dim, 3, 5.0, 35.0, 1.02)
    got, ref = _plain(bench_torch._headline_inputs(*args)), _plain(bench._headline_inputs(*args))
    assert got == ref
    assert got["matter_options"]["MINIMIZE_MEMORY"] is (dim == 1024)
    assert len(got["node_redshifts"]) == 92


@pytest.mark.filterwarnings("ignore:R_BUBBLE_MAX")
def test_minimize_memory_ratio4_chain_matches_jax():
    jinp = JInputs(random_seed=1234).evolve_input_structs(
        **HEADLINE, **CHAIN_BOX).with_logspaced_redshifts(5.0)
    tinp = port_inputs(jinp)
    assert tinp.matter_options.MINIMIZE_MEMORY and len(jinp.node_redshifts) == 5
    dens = numpy_grf(jinp, seed=5)
    t_ics = t21.compute_initial_conditions(tinp, initial_density=dens.copy(), device="cpu")
    j_ics = jics.compute_initial_conditions(jinp, initial_density=dens)
    j_ics = dataclasses.replace(j_ics, hires_density=np.asarray(j_ics.hires_density))
    nodes, prev_ts = [], None
    for jcv, tcv in zip(j_generate_coeval(jinp, (), j_ics),
                        t21.generate_coeval(tinp, (), t_ics, device="cpu"), strict=True):
        assert jcv.redshift == tcv.redshift
        for ion in (jcv.ionized_box, tcv.ionized_box):
            assert ion.kinetic_temperature is None and ion.mean_free_path is None
        nodes.append(_node(jinp, jcv.redshift, jcv, tcv, prev_ts))
        x_j = np.asarray(jcv.spin_temp.xray_ionised_fraction, np.float64)
        x_t = tcv.spin_temp.xray_ionised_fraction.double().numpy()
        assert np.mean(np.abs(x_t - x_j) / np.abs(x_j) > DELTA_T) <= CAP_SHARE, jcv.redshift
        prev_ts = jcv.spin_temp
    _report("MINIMIZE_MEMORY, 16^3 / 64^3", nodes)
    _assert_parity(nodes, density_tol=1e-5)
    assert nodes[0]["xH"][0] > 0.99 and nodes[-1]["xH"][0] < 1e-2


@pytest.fixture(scope="module")
def cpu_run():
    return bench_torch.run_full_lightcone(*LC_SIZE, seed=3, device="cpu", ladder=LC_LADDER)


def test_run_full_lightcone_on_cpu_equals_generate_lightcone(cpu_run):
    assert BENCH_KEYS <= set(cpu_run)
    lc = cpu_run["lightcone"]
    inputs = bench_torch._headline_inputs(*LC_SIZE, 3, *LC_LADDER)
    assert inputs.matter_options.MINIMIZE_MEMORY
    assert cpu_run["n_nodes"] == len(inputs.node_redshifts) == 3
    assert cpu_run["deposit_launches"] == 0 and cpu_run["peak_gib"] is None
    assert cpu_run["global_xh_end"] == lc.global_quantities["neutral_fraction"][-1]
    ref = t21.run_lightcone(inputs, apply_rsds=True, device="cpu")
    assert set(lc.lightcones) == set(ref.lightcones)
    for q, t in ref.lightcones.items():
        assert torch.equal(lc.lightcones[q], t), q
    for q, v in ref.global_quantities.items():
        np.testing.assert_array_equal(lc.global_quantities[q], v)


def test_banked_line_parses(cpu_run):
    line = json.loads(json.dumps(bench_torch.measured_line(
        "hii34_dim136", cpu_run, extra={"card": "none", "device_count": 0})))
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert line["metric"] == "ts_recomb_lightcone_measured_hii34_dim136_seconds"
    assert line["value"] == cpu_run["total_s"] > 0 and line["unit"] == "s"
    assert line["vs_baseline"] == bench_torch.BASELINE_S / cpu_run["total_s"]
    assert BENCH_KEYS <= set(line["detail"]) and "lightcone" not in line["detail"]


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


@pytest.mark.parametrize("argv", [[], ["--segment", "full1024"], ["--trace"]])
def test_main_without_a_card_exits_nonzero(no_cuda, argv):
    with pytest.raises(SystemExit) as exit_:
        bench_torch.main(argv)
    assert exit_.value.code not in (0, None)
    assert "NVIDIA GPU" in str(exit_.value.code)


def test_script_without_a_card_exits_nonzero_and_prints_no_result(no_cuda):
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr
