"""The MINIMIZE_MEMORY path that the faithful 4x-resolution lightcone runs
(bench.py's full1024, the benchmark's faithful-dawn cell), against the JAX
package.

MINIMIZE_MEMORY drops IonizedBox.kinetic_temperature and the per-cell mean
free path (py21cmfast_torch/models/ionization.py, as
py21cmfast_tpu/models/ionization.py).  The chain here runs bench.py's
physics (_headline_inputs: E-INTEGRAL, USE_TS_FLUCT, INHOMOGENEOUS,
R_BUBBLE_MAX=50, no exp filter, no cell recombinations) with MINIMIZE_MEMORY
on at DIM = 4 HII_DIM, the faithful ratio: HII_DIM=16, DIM=64 in
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
"""

import _torch_threads  # noqa: F401
import dataclasses

import numpy as np
import pytest
from test_torch_ics import numpy_grf, port_inputs
from test_torch_parity_scale import CAP_SHARE, DELTA_T, HEADLINE, _assert_parity, _node, _report

import py21cmfast_torch as t21
from py21cmfast_tpu.drivers.coeval import generate_coeval as j_generate_coeval
from py21cmfast_tpu.inputs import InputParameters as JInputs
from py21cmfast_tpu.models import ics as jics

CHAIN_BOX = dict(HII_DIM=16, DIM=64, BOX_LEN=50.0, Z_HEAT_MAX=20.0, ZPRIME_STEP_FACTOR=1.4,
                 MINIMIZE_MEMORY=True)


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
