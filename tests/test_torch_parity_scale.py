"""The port against the JAX package past the golden box: the headline's
physics down to z=5, where R_BUBBLE_MAX ends the ionization ladder and
reionization finishes, on the CPU.

At the golden box (BOX_LEN=36) the ladder's top radius is set by the box,
r_max = min(R_BUBBLE_MAX, l_factor * BOX_LEN) ~ 22 Mpc
(py21cmfast_tpu/models/ionization.py:103), and the chains stop at z~10.
Here BOX_LEN=96 puts l_factor * BOX_LEN above R_BUBBLE_MAX=50, as in every
full-size run, and the chains run down to z=5.  Both packages run
`generate_coeval` over every node from one numpy hires density (the two
RNGs differ), in lockstep, and every node is compared:

  density     max-abs <= 1e-5 of its max (as the ICs; 2e-5 at 192^3 hires,
              where the two libraries' float32 FFTs differ by 1.07e-5)
  xH          at most FLIP_SHARE of the cells off by 1e-3 (a thresholded
              field); <xH> within 5e-3
  Tk          every cell within DELTA_T of its own value, but at most
              CAP_SHARE of the cells (below)
  Ts          every cell within DELTA_T + 2 * 2**-24 / tau_21 of its own
              value (below), but at most CAP_SHARE of the cells
  Tb          in the cells where Tk and Ts agree and xH agrees within 1e-5
              (Tb is proportional to xH, which is continuous in partly
              ionized cells), within DELTA_TB of max|Tb| + 2 * 2**-24 / tau
              of its own value (below) + what the cell's Ts difference
              moves it by, |Tb| T_CMB / |Ts - T_CMB| |dTs| / Ts (near
              T_CMB a Ts difference within its bound moves Tb by more than
              DELTA_TB of max|Tb|); <Tb> rtol 5e-3 / atol 0.05
              (tests/test_golden.py:32-45)

The rounding terms.  Both packages take 1 - exp(-tau) in float32 twice:
in the Ts step's CMB coupling x_CMB = (1 - exp(-tau_21)) / tau_21
(py21cmfast_tpu/models/spintemp.py:842-853, tau_21 from the previous
node's Ts and x_e) and in Tb = (1 - exp(-tau)) (Ts - T_CMB) / (1 + z)
(py21cmfast_tpu/models/brightness.py:33-41, tau the box's tau_21).  The
subtraction is exact, so each package's exp, within 2**-24 below 1, puts
2**-24 / tau of the result in doubt: in the hot cells of z < 7 tau falls to
~4e-5 and that is ~4e-4.  Each package is that far from a float64
evaluation (a Ts cell at z=5 of the tier-1 chain: JAX +5.3e-4 and the port
-5.6e-4 off the float64 value of the port's inputs).  In the tier-1 chain
the two differed by at most 0.77 * 2**-24 / tau_21 in Ts, while Tk, x_e,
J_alpha and the shell accumulators of the Ts step agreed within 1e-5 of
their maxima.

The SFRD cap.  Each Ts shell's conditional SFRD jumps from its table to the
fully collapsed value where the filtered density reaches the table's top,
0.99 delta_crit (`where(delta_zpp >= dhi, cap, fcoll)`,
py21cmfast_tpu/models/spintemp.py:591).  A cell whose filtered density lies
within float32 rounding of that edge in one shell takes the cap in one
package and the table in the other: every accumulator of the cell moves by
~1%, and its Tk keeps the difference down the chain (at 64^3 a cell at
z=8.46 whose shell-3 density was 1.469118 in the port and 1.469115 in the
JAX package, against an edge of 1.469118, moved Tk by 1.48e-3).  Like the
flipped xH cells these are a share of the cells, not a bound on each.

Tier 1: the headline lightcone's physics (bench.py:73-91: E-INTEGRAL,
USE_TS_FLUCT, INHOMOGENEOUS, R_BUBBLE_MAX=50, 2LPT with the swept deposit)
at HII_DIM=32, DIM=96, BOX_LEN=96, Z_HEAT_MAX=20, ZPRIME_STEP_FACTOR=1.3:
6 nodes from z=20 to z=5.

Slow (tier 2, `-m slow`): HII_DIM=64, DIM=192, BOX_LEN=96 down the
headline's own ladder (Z_HEAT_MAX=35, ZPRIME_STEP_FACTOR=1.02, 92 nodes to
z=5) for the headline's physics, Munoz21 (the "EOS21" template, its
R_BUBBLE_MAX=50 kept above BOX_LEN/3 as both packages allow with
`config["ignore_R_BUBBLE_MAX_error"]`) and fixed-halos; each prints <xH>
at z=5 of both packages and the largest per-node differences:

    python -m pytest tests/test_torch_parity_scale.py -m slow -q -s -p no:cacheprovider
"""

import _torch_threads  # noqa: F401
import numpy as np
import pytest
from test_torch_ics import numpy_grf, port_inputs

import py21cmfast_torch as t21
import py21cmfast_tpu as j21
from py21cmfast_tpu.cosmology.constants import physconst
from py21cmfast_tpu.drivers.coeval import generate_coeval as j_generate_coeval
from py21cmfast_tpu.inputs import InputParameters as JInputs
from py21cmfast_tpu.models import ics as jics

# the headline's physics (bench.py:73-91)
HEADLINE = dict(SOURCE_MODEL="E-INTEGRAL", USE_TS_FLUCT=True, RECOMB_MODEL="inhomogeneous",
                R_BUBBLE_MAX=50.0, USE_EXP_FILTER=False, CELL_RECOMB=False)
TIER1_BOX = dict(HII_DIM=32, DIM=96, BOX_LEN=96.0, Z_HEAT_MAX=20.0, ZPRIME_STEP_FACTOR=1.3)
SLOW_BOX = dict(HII_DIM=64, DIM=192, BOX_LEN=96.0, Z_HEAT_MAX=35.0, ZPRIME_STEP_FACTOR=1.02)
Z_END = 5.0

DELTA_T = 1e-4
DELTA_TB = 1e-4
EXP_ULPS = 2.0
FLIP_SHARE = 1e-3
CAP_SHARE = 1e-3


def _inputs(template, box):
    if template is None:
        jinp = JInputs(random_seed=1234).evolve_input_structs(**HEADLINE, **box)
    else:
        jinp = JInputs.from_template(template, random_seed=1234).evolve_input_structs(**box)
    return jinp.with_logspaced_redshifts(Z_END)


def _tau21(jinp, z, prev):
    """tau_21 of the Ts step at `z` from the previous node's TsBox (the
    JAX package's), as both packages' cell update takes it."""
    cosmo = jinp.cosmology
    n_z = cosmo.rho_crit_cgs * cosmo.OMb * (1 - cosmo.Y_He) / physconst.m_p * (1 + z) ** 3
    pre = (3 * physconst.h_p * physconst.A10 * physconst.c_cms * physconst.lambda_21**2
           / 32.0 / np.pi / physconst.k_B)
    x_e = np.asarray(prev.xray_ionised_fraction, np.float64)
    t_s = np.asarray(prev.spin_temperature, np.float64)
    return pre * (1 - x_e) * n_z / t_s / float(cosmo.hubble(z))


def _node(jinp, z, jcv, tcv, prev_ts):
    """The differences of one node, as float64 numbers; `prev_ts` is the JAX
    package's TsBox of the node before (None at the first)."""
    def pair(get):
        return np.asarray(get(jcv), np.float64), get(tcv).double().numpy()

    d_j, d_t = pair(lambda c: c.perturbed_field.density)
    x_j, x_t = pair(lambda c: c.ionized_box.neutral_fraction)
    b_j, b_t = pair(lambda c: c.brightness_temperature.brightness_temp)
    k_j, k_t = pair(lambda c: c.spin_temp.kinetic_temp_neutral)
    s_j, s_t = pair(lambda c: c.spin_temp.spin_temperature)
    tk_rel = np.abs(k_t - k_j) / np.abs(k_j)
    ts_rel = np.abs(s_t - s_j) / np.abs(s_j)
    ts_bound = DELTA_T
    if prev_ts is not None:
        ts_bound = DELTA_T + EXP_ULPS * 2.0**-24 / _tau21(jinp, z, prev_ts)
    tau = np.maximum(np.asarray(jcv.brightness_temperature.tau_21, np.float64), 1e-30)
    t_cmb = physconst.T_cmb * (1 + z)
    tb_bound = (DELTA_TB * np.abs(b_j).max() + EXP_ULPS * 2.0**-24 / tau * np.abs(b_j)
                + np.abs(b_j) * t_cmb / np.maximum(np.abs(s_j - t_cmb), 1e-30) * ts_rel)
    same_x = np.abs(x_t - x_j) <= 1e-3
    agree = (np.abs(x_t - x_j) <= 1e-5) & (tk_rel <= DELTA_T) & (ts_rel <= ts_bound)
    return dict(
        z=z, xH=(x_j.mean(), x_t.mean()), Tb=(b_j.mean(), b_t.mean()),
        density=np.abs(d_t - d_j).max() / np.abs(d_j).max(),
        flips=float(np.mean(~same_x)),
        Tk=float(tk_rel.max()), Ts=float(ts_rel.max()),
        Tk_off=float(np.mean(tk_rel > DELTA_T)), Ts_off=float(np.mean(ts_rel > ts_bound)),
        # Tb's largest share of its bound in the cells where the rest agrees
        Tb_of_bound=float((np.abs(b_t - b_j) / np.maximum(tb_bound, 1e-30))[agree].max(
            initial=0.0)),
    )


def _run_both(jinp):
    """Both packages' chains over every node, compared node by node."""
    tinp = port_inputs(jinp)
    dens = numpy_grf(jinp, seed=5)
    j_ics = jics.compute_initial_conditions(jinp, initial_density=dens)
    t_ics = t21.compute_initial_conditions(tinp, initial_density=dens, device="cpu")
    del dens
    nodes, prev_ts = [], None
    for jcv, tcv in zip(j_generate_coeval(jinp, (), j_ics),
                        t21.generate_coeval(tinp, (), t_ics, device="cpu"), strict=True):
        assert jcv.redshift == tcv.redshift
        nodes.append(_node(jinp, jcv.redshift, jcv, tcv, prev_ts))
        prev_ts = jcv.spin_temp
    assert [n["z"] for n in nodes] == list(jinp.node_redshifts)
    return nodes


def _report(label, nodes):
    worst = {k: f"{max(n[k] for n in nodes):.3e}"
             for k in ("density", "flips", "Tk", "Tk_off", "Ts", "Ts_off", "Tb_of_bound")}
    dxh = max(abs(n["xH"][1] - n["xH"][0]) for n in nodes)
    last = nodes[-1]
    print(f"\n[parity-scale] {label}: {len(nodes)} nodes {nodes[0]['z']:.3f} -> {last['z']:.3f}; "
          f"<xH> at z={last['z']:.3f}: JAX {last['xH'][0]:.6f}, port {last['xH'][1]:.6f}; "
          f"<Tb> JAX {last['Tb'][0]:.5f} mK, port {last['Tb'][1]:.5f} mK; largest per-node "
          f"|d<xH>| {dxh:.3e}; largest per node: {worst}")


def _assert_parity(nodes, density_tol):
    for n in nodes:
        where = f"z={n['z']:.3f}"
        assert n["density"] <= density_tol, (where, n["density"])
        assert n["flips"] <= FLIP_SHARE, (where, n["flips"])
        np.testing.assert_allclose(n["xH"][1], n["xH"][0], atol=5e-3, err_msg=where)
        assert n["Tk_off"] <= CAP_SHARE and n["Ts_off"] <= CAP_SHARE, (where, n)
        assert n["Tb_of_bound"] <= 1.0, (where, n["Tb_of_bound"])
        np.testing.assert_allclose(n["Tb"][1], n["Tb"][0], rtol=5e-3, atol=0.05, err_msg=where)


@pytest.mark.filterwarnings("ignore:R_BUBBLE_MAX")
def test_headline_physics_down_to_z5_where_r_bubble_max_ends_the_ladder():
    jinp = _inputs(None, TIER1_BOX)
    so, ao, ap = jinp.simulation_options, jinp.astro_options, jinp.astro_params
    assert len(jinp.node_redshifts) == 6 and jinp.node_redshifts[-1] == Z_END
    # the ladder's top radius is R_BUBBLE_MAX, not the box
    assert physconst.l_factor * so.box_len > ap.r_bubble_max(ao) == 50.0
    nodes = _run_both(jinp)
    _report("headline physics, 32^3", nodes)
    _assert_parity(nodes, density_tol=1e-5)
    # no cell off at this size: every Tk and Ts cell within its bound
    assert max(n["Tk_off"] + n["Ts_off"] for n in nodes) == 0.0
    # reionization starts and finishes inside the chain
    assert nodes[0]["xH"][0] > 0.99 and nodes[-1]["xH"][0] < 1e-2


@pytest.mark.slow
@pytest.mark.filterwarnings("ignore:R_BUBBLE_MAX")
@pytest.mark.parametrize("template", [None, "EOS21", "fixed-halos"],
                         ids=["headline", "Munoz21", "fixed-halos"])
def test_full_ladder_at_64(template, monkeypatch):
    # Munoz21's SHARP-K ladder keeps R_BUBBLE_MAX=50 as at full size, above
    # BOX_LEN/3 here: both packages then warn instead of raising
    monkeypatch.setitem(j21.config, "ignore_R_BUBBLE_MAX_error", True)
    monkeypatch.setitem(t21.config, "ignore_R_BUBBLE_MAX_error", True)
    jinp = _inputs(template, SLOW_BOX)
    nodes = _run_both(jinp)
    _report(f"{template or 'headline'}, 64^3", nodes)
    _assert_parity(nodes, density_tol=2e-5)
