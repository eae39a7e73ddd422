"""The port's minihalo path (USE_MINI_HALOS with Lyman-Werner and
streaming-velocity feedback) against the JAX package, at golden size
(HII_DIM=24, DIM=72, BOX_LEN=36, ZPRIME_STEP_FACTOR=1.25, Z_HEAT_MAX=25,
R_BUBBLE_MAX=12, 5 nodes from z=27.08 to 10.5), on the CPU.

Two configurations: the "EOS21" template (`templates/Munoz21.toml`:
V_CB_MODEL="FLUCTS", SHARP-K, USE_TS_FLUCT, INHOMOGENEOUS recombinations; the
template name "Munoz21" itself resolves to "minihalos" in both packages'
manifest) and the "minihalos" template (V_CB_MODEL="AVG-DEBUG").  Both
packages start from one shared numpy hires density.  Tolerances:

  _mcrit_kernel, scalar and box v_cb     max-abs <= 2e-6 (2 float32 ulps of
                                         log10 M ~ 8)
  lowres_vcb                             max-abs <= 1e-5 max (as the ICs)
  host tables (ionization's 3D Nion
  tables; the Ts MCG SFRD tables, mean
  SFRD, tau_X horizons, folded prefactor
  groups, s_lw) given the JAX means      relative 1e-12 after float32
  Ts shell loop, cell update from the
  JAX package's own arguments            each accumulator, Ts, Tk, x_e and
                                         J_21_LW max-abs <= 2e-5 of the max
  one ionization step from JAX-carried   xH, G12: at most 1e-3 of the cells
  state (Nion history tracked)           off by 1e-3 (xH) or 1e-4 max (G12:
                                         it is set at a cell's first
                                         crossing); the Nion stacks: max-abs
                                         <= 1e-4 of the max; the turnover
                                         boxes 2e-6 and their means within
                                         5e-6 of the exact mean; mean_f_coll
                                         (_MINI) within 2e-3 relative
  one Ts step from JAX-carried state     Ts, Tk, x_e, J_21_LW max-abs <= 1e-4
                                         of the max
  the chains (EOS21 lightcone, minihalos
  coeval)                                per node global xH atol 5e-3 and
                                         mean Tb rtol 5e-3 / atol 0.05; the
                                         last node's Tb power rtol 1e-2
                                         (tests/test_golden.py:32-45)
  the EOS21 lightcone                    the same gates on the cone, at most
                                         1e-3 of the cells off by 1e-3 max

The box means.  Both packages take the mean of the log10 turnover boxes in
float32.  The JAX package's CPU mean is a sequential float32 sum: on the
ACG box, whose cells mostly sit at one floor value, its rounding errors add
up to 1.0e-3 off the exact mean at node 2 (the port's torch mean within
2.4e-6, three ulps); that moves 10^<log10 Mturn> by 0.23% and the global Nion
normalization mean_f_coll by 1.5e-3, hence the 2e-3 above.  On the MCG box
(LW feedback varies per cell) the two means differ by ~1e-5.  The Ts step
rounds max(<log10 Mcrit_MCG>, clip) to 3 decimals as the key of its MCG
tau_X curve: a difference d of the means changes the key when the mean lies
within d of a x.xxx5 boundary, at odds of ~2d/1e-3, ~2% a node here.  The
one-step test asserts the keys agree at its nodes, so the Ts tolerance holds
without a flipped key; a flipped key moves the MCG tau_X horizons by 0.23%
in Mturn.
"""

import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ics import GOLDEN, numpy_grf, port_inputs
from test_torch_lightcone import assert_cone_share
from test_torch_spintemp import Recorder

import py21cmfast_torch as t21
from py21cmfast_torch import interop
from py21cmfast_torch.models import hmf as thmf
from py21cmfast_torch.models import ics as tics
from py21cmfast_torch.models import ionization as tion
from py21cmfast_torch.models import spintemp as tsp
from py21cmfast_tpu.drivers.coeval import generate_coeval as j_generate_coeval
from py21cmfast_tpu.drivers.lightcone import generate_lightcone as j_generate_lightcone
from py21cmfast_tpu.inputs import InputParameters as JInputs
from py21cmfast_tpu.models import hmf as jhmf
from py21cmfast_tpu.models import ics as jics
from py21cmfast_tpu.models import ionization as jion
from py21cmfast_tpu.models import spintemp as jsp
from py21cmfast_tpu.ops import ps

SIZE = dict(GOLDEN, R_BUBBLE_MAX=12.0)  # SHARP-K needs R_BUBBLE_MAX <= BOX_LEN/3
ION_FIELDS = ("neutral_fraction", "z_reion", "ionisation_rate_G12", "cumulative_recombinations",
              "unnormalised_nion", "unnormalised_nion_mini")
TS_FIELDS = ("spin_temperature", "kinetic_temp_neutral", "xray_ionised_fraction", "J_21_LW")


def jax_template_inputs(name):
    return JInputs.from_template(name, random_seed=1234).evolve_input_structs(
        **SIZE).with_logspaced_redshifts(10.5, 25.0)


def _numpy(struct):
    return {k: (None if v is None else np.asarray(v)) for k, v in vars(struct).items()}


def _close(got, ref, limit, name):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= limit * scale, f"{name}: max-abs {err:.3e} > {limit} x {scale:.3e}"


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _node_dict(cv):
    return dict(z=float(cv.redshift), pf=_numpy(cv.perturbed_field), ion=_numpy(cv.ionized_box),
                ts=_numpy(cv.spin_temp))


@pytest.fixture(scope="module")
def eos21():
    """The EOS21 lightcone in both packages from one density, with every
    node's boxes as numpy."""
    jinp = jax_template_inputs("EOS21")
    tinp = port_inputs(jinp)
    assert (tinp.matter_options.V_CB_MODEL, tinp.astro_options.HII_FILTER) == ("FLUCTS", "SHARP-K")
    assert tinp.astro_options.USE_MINI_HALOS and len(tinp.node_redshifts) == 5
    dens = numpy_grf(jinp, seed=5)
    j_ics = jics.compute_initial_conditions(jinp, initial_density=dens)
    t_ics = tics.compute_initial_conditions(tinp, initial_density=dens, device="cpu")
    runs = {}
    for name, gen in (
        ("jax", j_generate_lightcone(jinp, initial_conditions=j_ics)),
        ("port", t21.generate_lightcone(tinp, initial_conditions=t_ics, device="cpu")),
    ):
        nodes = []
        for z, cv, lc in gen:
            if z is not None:
                nodes.append(_node_dict(cv))
        runs[name] = dict(nodes=nodes, lc=lc)
    return dict(jinp=jinp, tinp=tinp, j_ics=_numpy(j_ics), t_ics=t_ics, **runs)


def test_mcrit_kernel_matches_jax():
    """_mcrit_kernel on seeded random grids (half the cells never ionized),
    with a scalar v_cb and with a v_cb box: max-abs <= 2e-6."""
    rng = np.random.default_rng(3)
    shape = (12, 12, 12)
    g12 = rng.lognormal(-1.0, 1.5, shape).astype(np.float32)
    zre = np.where(rng.random(shape) < 0.5, -1.0, rng.uniform(10.5, 14.0, shape)).astype(np.float32)
    j21 = rng.lognormal(-1.0, 1.0, shape).astype(np.float32)
    vcb = rng.rayleigh(20.0, shape).astype(np.float32)
    scalars = dict(redshift=10.0, mturn_a_nofb=2.5e8, mturn_m_nofb=3.1e6, a_lw=2.0, beta_lw=0.6,
                   a_vcb=1.0, beta_vcb=1.8, sigmavcb=27.0 * np.sqrt(3.0 * np.pi / 8.0))
    f32 = {k: np.float32(v) for k, v in scalars.items()}
    for v in (np.float32(25.86), vcb):
        ref = jion._mcrit_kernel(g12, zre, j21, f32["redshift"], f32["mturn_a_nofb"],
                                 f32["mturn_m_nofb"], jnp.asarray(v), f32["a_lw"], f32["beta_lw"],
                                 f32["a_vcb"], f32["beta_vcb"], f32["sigmavcb"])
        got = tion._mcrit_kernel(_t(g12), _t(zre), _t(j21), **{k: _t(x) for k, x in f32.items()
                                 if k != "redshift"}, redshift=_t(f32["redshift"]), vcb=_t(v))
        for g, r in zip(got, ref):
            assert np.abs(np.asarray(r)).max() > 5.0
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=2e-6)


def test_lowres_vcb_matches_jax(eos21):
    """FLUCTS: the |v_cb| box from the same hires density, max-abs <= 1e-5 max."""
    ref = eos21["j_ics"]["lowres_vcb"]
    got = eos21["t_ics"].lowres_vcb
    assert isinstance(got, torch.Tensor) and got.shape == ref.shape
    assert ref.min() >= 0 and ref.max() > 0
    _close(got.numpy(), ref, 1e-5, "lowres_vcb")


def test_nion_tables_mini_match_jax(eos21):
    """_build_nion_tables_mini: relative 1e-12 (host copies)."""
    jinp, tinp = eos21["jinp"], eos21["tinp"]
    z = 13.375
    out = []
    for mod, hmf, m_inp in ((jion, jhmf, jinp), (tion, thmf, tinp)):
        m_min = hmf.minimum_source_mass(z, m_inp, xray=False)
        out.append(mod._build_nion_tables_mini(
            m_inp, mod.setup_radii(m_inp, m_min), mod._get_sigma_table(m_inp),
            float(m_inp.cosmology.dicke(z)), m_min, hmf.set_scaling_constants(z, m_inp),
            np.linspace(5.0, 10.0, 24)))
    for r, g in zip(*out):
        np.testing.assert_allclose(g, r, rtol=1e-12)
    assert out[1][2].shape == (len(out[1][0]), 24, tion.N_DELTA_TABLE)


@pytest.mark.parametrize("node", [2, 4])
def test_ionization_step_matches_jax(eos21, node):
    """One ionization step from the JAX package's node-(k-1) boxes (the Nion
    history is tracked at these nodes) and its node-k TsBox."""
    jn, prev = eos21["jax"]["nodes"][node], eos21["jax"]["nodes"][node - 1]
    tinp = eos21["tinp"]
    got = tion.compute_ionization_field(
        jn["z"], tinp, interop.perturbed_field_from_numpy(jn["pf"], "cpu"),
        previous_ionized_box=interop.ionized_box_from_numpy(prev["ion"], "cpu"),
        spin_temp=interop.ts_box_from_numpy(jn["ts"], "cpu"),
        prev_redshift=prev["z"],
        previous_perturbed_field=interop.perturbed_field_from_numpy(prev["pf"], "cpu"),
        vcb_box=eos21["t_ics"].lowres_vcb, device="cpu",
    )
    ref = jn["ion"]
    assert prev["ion"]["unnormalised_nion"] is not None
    xh, xh_ref = got.neutral_fraction.numpy(), ref["neutral_fraction"]
    flipped = np.mean(np.abs(xh - xh_ref) > 1e-3)
    assert flipped <= 1e-3, flipped
    assert 0.0 < xh_ref.mean() < 1.0
    # Gamma12 is set where a cell first crosses: a flipped crossing changes it
    g12 = got.ionisation_rate_G12.numpy()
    assert_cone_share(g12, ref["ionisation_rate_G12"], "G12", share=1e-3, rel=1e-4)
    for name in ("unnormalised_nion", "unnormalised_nion_mini"):
        assert getattr(got, name).shape == ref[name].shape
        _close(getattr(got, name).numpy(), ref[name], 1e-4, f"{name} z={jn['z']}")
    # the log10 turnover means: the port's float32 mean is within 5e-6 of
    # the exact mean of the JAX kernel's boxes on these inputs; the JAX
    # package's own (a sequential float32 sum on the CPU) within 2e-3
    boxes = tion.mcrit_boxes(
        jn["z"], tinp, thmf.set_scaling_constants(jn["z"], tinp),
        interop.ionized_box_from_numpy(prev["ion"], "cpu"), interop.ts_box_from_numpy(jn["ts"], "cpu"),
        eos21["t_ics"].lowres_vcb, "cpu")
    j_boxes = jion._mcrit_kernel(*(np.asarray(b) for b in (
        prev["ion"]["ionisation_rate_G12"], prev["ion"]["z_reion"], jn["ts"]["J_21_LW"])),
        *(np.float32(b.item()) for b in _mcrit_scalars(tinp, jn["z"])), eos21["j_ics"]["lowres_vcb"],
        *(np.float32(b.item()) for b in _mcrit_scalars(tinp, jn["z"], tail=True)))
    for name, box, j_box in zip(("log10_Mturnover_ave", "log10_Mturnover_MINI_ave"), boxes, j_boxes):
        np.testing.assert_allclose(box.numpy(), np.asarray(j_box), rtol=0, atol=2e-6)
        exact = np.asarray(j_box, np.float64).mean()
        np.testing.assert_allclose(float(getattr(got, name)), exact, rtol=0, atol=5e-6, err_msg=name)
        np.testing.assert_allclose(float(ref[name]), exact, rtol=0, atol=2e-3, err_msg=name)
    for name in ("mean_f_coll", "mean_f_coll_MINI"):
        assert float(ref[name]) > 0
        np.testing.assert_allclose(float(getattr(got, name)), float(ref[name]), rtol=2e-3, err_msg=name)


def _mcrit_scalars(inputs, z, tail=False):
    """The float32 scalars of _mcrit_kernel around its v_cb argument."""
    sc, ap = thmf.set_scaling_constants(z, inputs), inputs.astro_params
    vals = ((ap.A_LW, ap.BETA_LW, ap.A_VCB, ap.BETA_VCB, sc.v_cb_avg * np.sqrt(3.0 * np.pi / 8.0))
            if tail else (z, sc.mturn_a_nofb, sc.mturn_m_nofb))
    return [np.float32(v) for v in vals]


def _jax_ts_step(monkeypatch, eos21, node):
    """The JAX package's Ts step at `node` from its own node-(k-1) boxes,
    with its shell loop and cell update recorded."""
    jinp = eos21["jinp"]
    jn, prev = eos21["jax"]["nodes"][node], eos21["jax"]["nodes"][node - 1]
    from py21cmfast_tpu.outputs import InitialConditions, IonizedBox, PerturbedField, TsBox

    def struct(cls, d):
        return cls(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray) and v.ndim else v)
                      for k, v in d.items()})

    scan, cell = Recorder(jsp._ts_shell_scan), Recorder(jsp._ts_cell_update)
    monkeypatch.setattr(jsp, "_ts_shell_scan", scan)
    monkeypatch.setattr(jsp, "_ts_cell_update", cell)
    jsp.compute_spin_temperature(
        jn["z"], jinp, struct(PerturbedField, jn["pf"]), prev_state=struct(TsBox, prev["ts"]),
        prev_redshift=prev["z"], initial_conditions=struct(InitialConditions, eos21["j_ics"]),
        previous_ionized_box=struct(IonizedBox, prev["ion"]))
    monkeypatch.undo()
    return scan.args, scan.out, cell.args, cell.out


@pytest.mark.parametrize("node", [2, 4])
def test_ts_step_matches_jax(eos21, node):
    """One Ts step from the JAX package's node-(k-1) TsBox and IonizedBox and
    the ICs' v_cb (all carried by interop), with the 3-decimal key of the MCG
    tau_X curve the same in both packages."""
    jn, prev = eos21["jax"]["nodes"][node], eos21["jax"]["nodes"][node - 1]
    tinp = eos21["tinp"]
    ics = interop.initial_conditions_from_numpy(eos21["j_ics"], "cpu")
    assert ics.lowres_vcb is not None
    got, _ = tsp.compute_spin_temperature(
        jn["z"], tinp, interop.perturbed_field_from_numpy(jn["pf"], "cpu"),
        prev_state=interop.ts_box_from_numpy(prev["ts"], "cpu"), prev_redshift=prev["z"],
        initial_conditions=ics, previous_ionized_box=interop.ionized_box_from_numpy(prev["ion"], "cpu"),
        device="cpu")
    for name in TS_FIELDS:
        _close(getattr(got, name).numpy(), jn["ts"][name], 1e-4, f"{name} z={jn['z']}")
    assert jn["ts"]["J_21_LW"].max() > 0
    # the MCG tau_X key, from the same turnover box by each package's mean
    _, box = tion.mcrit_boxes(
        jn["z"], tinp, thmf.set_scaling_constants(jn["z"], tinp),
        interop.ionized_box_from_numpy(prev["ion"], "cpu"), interop.ts_box_from_numpy(prev["ts"], "cpu"),
        ics.lowres_vcb, "cpu")
    clip = np.log10(thmf.lyman_werner_threshold(jn["z"], 0.0, 0.0, tinp.astro_params))
    keys = [round(max(m, clip), 3) for m in (float(box.mean()), float(jnp.mean(box.numpy())))]
    assert keys[0] == keys[1], keys


def test_ts_host_tables_shell_loop_and_cell_update_match_jax(eos21, monkeypatch):
    """At node 3: ts_host_tables given the JAX package's <x_e> and <log10
    Mcrit> equals the float32 arrays the JAX package hands its device code
    (relative 1e-12); the port's shell loop and cell update on the JAX
    package's own arguments: max-abs <= 2e-5 of each field's maximum."""
    node = 3
    jn, prev = eos21["jax"]["nodes"][node], eos21["jax"]["nodes"][node - 1]
    a, scan_out, c, cell_out = _jax_ts_step(monkeypatch, eos21, node)
    x_e_ave = float(jnp.mean(jnp.asarray(prev["ts"]["xray_ionised_fraction"])))
    ave_mcrit = float(jnp.mean(a["mcrit_box"]))
    h = tsp.ts_host_tables(
        jn["z"], eos21["tinp"], float(jn["pf"]["redshift"]), prev["z"], x_e_ave, ave_mcrit)
    pairs = dict(
        sfrd_tables_mini="sfrd_tables_mini", mean_sfrd_mini="mean_sfrd_mini",
        starlya_mini_pref="pref_starlya_mini", lya_cont_mini_pref="pref_lya_cont_mini",
        lya_inj_mini_pref="pref_lya_inj_mini", lw_pref="pref_lw", lw_mini_pref="pref_lw_mini",
        tbl_heat="tbl_heat", tbl_ion="tbl_ion", tbl_lya="tbl_lya", starlya_pref="pref_starlya",
    )
    for name, jname in pairs.items():
        np.testing.assert_allclose(np.asarray(h[name], np.float32), np.asarray(a[jname]),
                                   rtol=1e-12, err_msg=name)
    assert np.abs(h["lw_pref"]).max() == 1.0 or np.abs(h["lw_mini_pref"]).max() == 1.0
    np.testing.assert_allclose(np.float32(h["consts"]["s_lw"]), float(a["consts"][-1]), rtol=1e-12)
    np.testing.assert_allclose(np.float32(h["mcrit_clip"]), float(a["mcrit_clip"]), rtol=1e-12)
    for name in ("fstar7", "lx_ratio"):
        np.testing.assert_allclose(np.float32(h[name]), float(a[name]), rtol=1e-12)

    # the shell loop on the JAX package's arguments
    def f(name, i):
        return float(np.asarray(a[name])[i])

    gather = not a["use_cheby"]
    shells = [
        dict(
            R=f("r_values", i), do_filter=bool(np.asarray(a["do_filter"])[i]),
            growth=f("zpp_growth", i), zfac=f("z_edge_factor", i), xr_fac=f("xray_r_factor", i),
            d_lo=f("sfrd_dlo", i), d_hi=f("sfrd_dhi", i), cap=f("sfrd_caps", i),
            cheb=[float(v) for v in np.asarray(a["sfrd_cheby"])[i]],
            cheb_edge=f("sfrd_edge", i), mean_sfrd=f("mean_sfrd", i),
            p_star=f("pref_starlya", i), p_cont=f("pref_lya_cont", i), p_inj=f("pref_lya_inj", i),
            table=_t(a["sfrd_tables"][i]) if gather else None, table_fc=None,
            tbl_heat=_t(a["tbl_heat"][i]), tbl_ion=_t(a["tbl_ion"][i]), tbl_lya=_t(a["tbl_lya"][i]),
            table_mini=_t(np.asarray(a["sfrd_tables_mini"][i]).reshape(-1)),
            mean_sfrd_mini=f("mean_sfrd_mini", i), p_star_mini=f("pref_starlya_mini", i),
            p_cont_mini=f("pref_lya_cont_mini", i), p_inj_mini=f("pref_lya_inj_mini", i),
            p_lw=f("pref_lw", i), p_lw_mini=f("pref_lw_mini", i),
        )
        for i in range(len(np.asarray(a["r_values"])))
    ]
    flags = {k: a[k] for k in ("use_xray_heat", "use_lya_heat", "use_cheby", "const_model")}
    accs = tsp._ts_shell_scan(
        _t(a["density_pf"]), _t(a["prev_xe"]), shells, float(a["inv_growth_pf"]),
        float(a["fstar10"]), shape=a["shape"], box_lens=a["box_lens"],
        heat_filter=a["heat_filter"], mcrit_box=_t(a["mcrit_box"]),
        mcrit_clip=float(a["mcrit_clip"]), fstar7=float(a["fstar7"]),
        lx_ratio=float(a["lx_ratio"]), **flags)
    names = tsp._accumulator_names(a["use_xray_heat"], a["use_lya_heat"], True)
    assert len(accs) == len(scan_out) == len(names) and names[-1] == "dstarlw"
    for name, g, r in zip(names, accs, scan_out):
        assert np.abs(np.asarray(r)).max() > 0, name
        _close(g.numpy(), r, 2e-5, name)

    # the cell update on the JAX package's accumulators and constants
    consts = dict(zip(
        "zp dzp growth_zp inv_growth_pf dgrowth_dzp dt_dzp hubble_zp trad nb_zp n_zp xc_inverse "
        "xa_tilde_prefactor ts_prefactor dcomp_prefactor clump fH fHe no_total nb0_total s_heat "
        "s_ion s_lya s_star s_cont s_inj s_lw".split(), (float(v) for v in c["consts"])))
    consts.update(gp_norm=float(c["gp_norm"]), dcmb_prefactor=0.0)
    got = tsp._ts_cell_update(
        *(_t(c[n]) for n in ("density_pf", "prev_ts", "prev_tk", "prev_xe")),
        tuple(_t(x) for x in c["accs"]), _t(c["lya_tbl_cont"]), _t(c["lya_tbl_inj"]), consts,
        tuple(_t(k) for k in c["kappa_knots"]),
        **{k: c[k] for k in ("use_xray_heat", "use_cmb_heat", "use_lya_heat", "use_minihalos")})
    assert not c["use_cmb_heat"] and c["use_minihalos"]
    for name, g, r in zip(("Ts", "Tk", "x_e", "J_Lya", "J_21_LW"), got, cell_out):
        _close(g.numpy(), r, 2e-5, name)


def _gates(got_xh, ref_xh, got_tb, ref_tb, box_lens, ctx):
    """tests/test_golden.py's gates on global xH, mean Tb and the Tb power."""
    np.testing.assert_allclose(got_xh, ref_xh, atol=5e-3, err_msg=ctx)
    np.testing.assert_allclose(got_tb.mean(), ref_tb.mean(), rtol=5e-3, atol=0.05, err_msg=ctx)
    _, p, _ = ps.power_spectrum_1d(got_tb, box_lens, n_bins=8)
    _, p_ref, _ = ps.power_spectrum_1d(ref_tb, box_lens, n_bins=8)
    good = np.isfinite(p_ref) & (p_ref > 0)
    np.testing.assert_allclose(p[good], p_ref[good], rtol=1e-2, err_msg=ctx)


def _chain_gates(j_nodes, t_nodes, jinp):
    assert [n["z"] for n in t_nodes] == [n["z"] for n in j_nodes] == list(jinp.node_redshifts)
    for j, t in zip(j_nodes, t_nodes):
        xh = t["ion"]["neutral_fraction"].astype(np.float64).mean()
        xh_ref = j["ion"]["neutral_fraction"].astype(np.float64).mean()
        np.testing.assert_allclose(xh, xh_ref, atol=5e-3, err_msg=f"xH z={j['z']}")
        assert np.isfinite(t["ts"]["J_21_LW"]).all()
    xh_last = j_nodes[-1]["ion"]["neutral_fraction"].astype(np.float64).mean()
    assert 0.0 < xh_last < 0.95


def test_eos21_chain_meets_golden_gates_against_jax(eos21):
    """Per node the global xH; the minihalo outputs are carried node to node."""
    _chain_gates(eos21["jax"]["nodes"], eos21["port"]["nodes"], eos21["jinp"])
    last = eos21["port"]["nodes"][-1]
    assert last["ion"]["unnormalised_nion"].shape[1:] == (24, 24, 24)
    assert float(last["ion"]["log10_Mturnover_MINI_ave"]) > 5.0
    assert last["ts"]["J_21_LW"].max() > 0


def test_eos21_lightcone_matches_jax(eos21):
    """The golden gates on the cone (its first HII_DIM slices for the power)
    and per node; at most 1e-3 of the cells off by 1e-3 max of each cone."""
    j_lc, t_lc = eos21["jax"]["lc"], eos21["port"]["lc"]
    so = eos21["jinp"].simulation_options
    bt, bt_ref = t_lc.brightness_temp.numpy(), np.asarray(j_lc.brightness_temp)
    t_gq, j_gq = t_lc.global_quantities, j_lc.global_quantities
    _gates(t_gq["neutral_fraction"], j_gq["neutral_fraction"], bt[:, :, : so.HII_DIM],
           bt_ref[:, :, : so.HII_DIM], so.box_lens, "EOS21 lightcone")
    np.testing.assert_allclose(np.nanmean(bt), np.nanmean(bt_ref), rtol=5e-3, atol=0.05)
    assert set(t_lc.lightcones) == set(j_lc.lightcones) == {"brightness_temp", "tau_21", "velocity_z"}
    for q, t in t_lc.lightcones.items():
        assert_cone_share(t.numpy(), j_lc.lightcones[q], q)
    np.testing.assert_allclose(t_gq["brightness_temp"], j_gq["brightness_temp"],
                               atol=1e-3 * np.abs(bt_ref).max())


def test_minihalos_chain_meets_golden_gates_against_jax():
    """The "minihalos" template (V_CB_MODEL="AVG-DEBUG", spherical tophat):
    per node the global xH, and the golden gates on the last node's Tb."""
    jinp = jax_template_inputs("minihalos")
    tinp = port_inputs(jinp)
    assert tinp.matter_options.V_CB_MODEL == "AVG-DEBUG" and tinp.astro_options.USE_MINI_HALOS
    dens = numpy_grf(jinp, seed=7)
    j_nodes = [_node_dict(cv) | dict(tb=np.asarray(cv.brightness_temp)) for cv in j_generate_coeval(
        jinp, initial_conditions=jics.compute_initial_conditions(jinp, initial_density=dens))]
    t_ics = tics.compute_initial_conditions(tinp, initial_density=dens, device="cpu")
    assert t_ics.lowres_vcb is None
    t_nodes = [_node_dict(cv) | dict(tb=cv.brightness_temp.numpy())
               for cv in t21.generate_coeval(tinp, initial_conditions=t_ics, device="cpu")]
    _chain_gates(j_nodes, t_nodes, jinp)
    j, t = j_nodes[-1], t_nodes[-1]
    _gates(t["ion"]["neutral_fraction"].astype(np.float64).mean(),
           j["ion"]["neutral_fraction"].astype(np.float64).mean(), t["tb"], j["tb"],
           jinp.simulation_options.box_lens, "minihalos z=10.5")


def test_interop_carries_the_minihalo_state(eos21):
    """lowres_vcb, J_21_LW and the 4-D Nion stacks cross from the JAX
    package's numpy arrays into the port's structs unchanged."""
    node = eos21["jax"]["nodes"][-1]
    ics = interop.initial_conditions_from_numpy(eos21["j_ics"], "cpu")
    ion = interop.ionized_box_from_numpy(node["ion"], "cpu")
    ts = interop.ts_box_from_numpy(node["ts"], "cpu")
    for got, ref in ((ics.lowres_vcb, eos21["j_ics"]["lowres_vcb"]),
                     (ts.J_21_LW, node["ts"]["J_21_LW"]),
                     (ion.unnormalised_nion, node["ion"]["unnormalised_nion"]),
                     (ion.unnormalised_nion_mini, node["ion"]["unnormalised_nion_mini"])):
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)
    assert ion.unnormalised_nion.ndim == 4
    assert isinstance(ion.mean_f_coll_MINI, np.float32)


@pytest.mark.parametrize("name", ["minihalos", "EOS21", "Qin20"])
def test_minihalo_templates_run(name):
    """Every minihalo template of the repo runs through run_lightcone on the
    CPU (8³, 3 nodes; run_coeval of minihalos is tests/test_torch_slice.py's
    and test_torch_scroll.py's) with finite outputs and the minihalo state
    filled at the last node ("Munoz21" itself names "minihalos" in the
    manifest; its own file is reached as "EOS21")."""
    inp = t21.InputParameters.from_template(name, random_seed=1).evolve_input_structs(
        HII_DIM=8, DIM=16, BOX_LEN=16.0, R_BUBBLE_MAX=5.0, N_STEP_TS=6, ZPRIME_STEP_FACTOR=1.3,
    ).with_logspaced_redshifts(8.0, 12.0)
    assert inp.astro_options.USE_MINI_HALOS and len(inp.node_redshifts) == 3
    last = None
    for z, cv, lc in t21.generate_lightcone(inp, device="cpu"):
        last = cv if z is not None else last
    assert last.redshift == 8.0 and np.isfinite(last.brightness_temp.numpy()).all()
    assert float(last.spin_temp.J_21_LW.min()) > 0.0
    assert float(last.ionized_box.log10_Mturnover_MINI_ave) > 5.0
    assert last.ionized_box.unnormalised_nion_mini.shape[1:] == (8, 8, 8)
    vcb = last.initial_conditions.lowres_vcb
    assert (vcb is not None) == (inp.matter_options.V_CB_MODEL == "FLUCTS")
    assert all(np.isfinite(t.numpy()).all() for t in lc.lightcones.values())
    assert lc.global_quantities["neutral_fraction"][-1] < lc.global_quantities["neutral_fraction"][0]
