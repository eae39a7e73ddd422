"""The port's spin-temperature module against the JAX package, at golden size
(HII_DIM=24, DIM=72, BOX_LEN=36, ZPRIME_STEP_FACTOR=1.25, Z_HEAT_MAX=25), on
the CPU.

One JAX Ts chain runs down the golden "ts" ladder (27.08 -> 10.5, 5 nodes)
from a numpy Gaussian density; the arguments and results of the JAX package's
`_ts_shell_scan` and `_ts_cell_update` are recorded at every node, so each of
the port's functions is held to the JAX one on identical inputs:
  host tables          relative 1e-12 (float64 copies); the folded, peak-
                       normalised groups equal the float32 arrays the JAX
                       package hands to its device code;
  _ts_shell_scan       each accumulator max-abs <= 2e-5 of its maximum;
  _ts_cell_update,     Ts, Tk, x_e, J_Lya max-abs <= 2e-5 of the field's
  _init_first_ts       maximum;
  compute_spin_temperature, one step from the JAX package's previous TsBox:
                       max-abs <= 1e-4 of the field's maximum.
"""

import inspect

import _torch_threads  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ics import jax_inputs, numpy_grf, port_inputs

from py21cmfast_torch import interop, tracing
from py21cmfast_torch.cosmology.constants import physconst
from py21cmfast_torch.outputs import XraySourceBox
from py21cmfast_torch.models import heating as theat
from py21cmfast_torch.models import lya_heating as tlya
from py21cmfast_torch.models import spintemp as tsp
from py21cmfast_tpu.models import heating as jheat
from py21cmfast_tpu.models import ics as jics
from py21cmfast_tpu.models import ionization as jion
from py21cmfast_tpu.models import lya_heating as jlya
from py21cmfast_tpu.models import perturb as jpert
from py21cmfast_tpu.models import spintemp as jsp

CONST_NAMES = (
    "zp dzp growth_zp inv_growth_pf dgrowth_dzp dt_dzp hubble_zp trad nb_zp n_zp "
    "xc_inverse xa_tilde_prefactor ts_prefactor dcomp_prefactor clump fH fHe no_total "
    "nb0_total s_heat s_ion s_lya s_star s_cont s_inj s_lw"
).split()
TS_FIELDS = ("spin_temperature", "kinetic_temp_neutral", "xray_ionised_fraction", "J_Lya")


def _numpy(struct):
    return {k: (None if v is None else np.asarray(v)) for k, v in vars(struct).items()}


class Recorder:
    """Wraps a JAX-package function: records the bound arguments and the
    result of its last call and passes both through."""

    def __init__(self, fn):
        self.fn, self.sig = fn, inspect.signature(fn)
        self.args = self.out = None

    def __call__(self, *a, **kw):
        self.args = dict(self.sig.bind(*a, **kw).arguments)
        self.out = self.fn(*a, **kw)
        return self.out


def jax_ts_step(monkeypatch, jinp, z, pf, prev_state, prev_z):
    """One JAX Ts step; returns (TsBox, shell-scan recorder, cell-update recorder)."""
    scan, cell = Recorder(jsp._ts_shell_scan), Recorder(jsp._ts_cell_update)
    monkeypatch.setattr(jsp, "_ts_shell_scan", scan)
    monkeypatch.setattr(jsp, "_ts_cell_update", cell)
    box, _ = jsp.compute_spin_temperature(z, jinp, pf, prev_state=prev_state, prev_redshift=prev_z)
    monkeypatch.undo()
    return box, scan, cell


@pytest.fixture(scope="module")
def chain():
    """The JAX Ts chain: per node the perturbed field, TsBox and the records."""
    jinp = jax_inputs(USE_TS_FLUCT=True).with_logspaced_redshifts(10.5, 25.0)
    dens = numpy_grf(jinp, seed=11)
    ics = jics.compute_initial_conditions(jinp, initial_density=dens)
    nodes, state, prev_z = [], None, None
    with pytest.MonkeyPatch.context() as mp:
        for z in jinp.node_redshifts:
            pf = jpert.perturb_field(z, jinp, ics)
            box, scan, cell = jax_ts_step(mp, jinp, z, pf, state, prev_z)
            nodes.append(dict(z=z, prev_z=prev_z, pf=pf, ts=box, prev=state, scan=scan, cell=cell))
            state, prev_z = box, z
    return dict(jinp=jinp, tinp=port_inputs(jinp), nodes=nodes)


def _close(got, ref, limit, name):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= limit * scale, f"{name}: max-abs {err:.3e} > {limit} x {scale:.3e}"


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def shells_from_jax(a, flags):
    """The port's per-shell list from the JAX `_ts_shell_scan` arguments."""
    def f(name, i):
        return float(np.asarray(a[name])[i])

    gather = not flags["use_cheby"]
    return [
        dict(
            R=f("r_values", i), do_filter=bool(np.asarray(a["do_filter"])[i]),
            growth=f("zpp_growth", i), zfac=f("z_edge_factor", i), xr_fac=f("xray_r_factor", i),
            d_lo=f("sfrd_dlo", i), d_hi=f("sfrd_dhi", i), cap=f("sfrd_caps", i),
            cheb=[float(v) for v in np.asarray(a["sfrd_cheby"])[i]],
            cheb_edge=f("sfrd_edge", i), mean_sfrd=f("mean_sfrd", i),
            p_star=f("pref_starlya", i), p_cont=f("pref_lya_cont", i), p_inj=f("pref_lya_inj", i),
            table=_t(a["sfrd_tables"][i]) if gather else None,
            table_fc=_t(a["sfrd_tables_fc"][i]) if flags["const_model"] else None,
            tbl_heat=_t(a["tbl_heat"][i]), tbl_ion=_t(a["tbl_ion"][i]), tbl_lya=_t(a["tbl_lya"][i]),
        )
        for i in range(len(np.asarray(a["r_values"])))
    ]


def port_shell_scan(a):
    flags = {k: a[k] for k in ("use_xray_heat", "use_lya_heat", "use_cheby", "const_model")}
    return tsp._ts_shell_scan(
        _t(a["density_pf"]), _t(a["prev_xe"]), shells_from_jax(a, flags),
        float(a["inv_growth_pf"]), float(a["fstar10"]),
        shape=a["shape"], box_lens=a["box_lens"], heat_filter=a["heat_filter"], **flags,
    )


def port_cell_update(a, dcmb_prefactor):
    c = {n: float(v) for n, v in zip(CONST_NAMES, a["consts"])}
    c.update(gp_norm=float(a["gp_norm"]), dcmb_prefactor=float(np.float32(dcmb_prefactor)))
    return tsp._ts_cell_update(
        *(_t(a[n]) for n in ("density_pf", "prev_ts", "prev_tk", "prev_xe")),
        tuple(_t(x) for x in a["accs"]), _t(a["lya_tbl_cont"]), _t(a["lya_tbl_inj"]), c,
        tuple(_t(k) for k in a["kappa_knots"]),
        **{k: a[k] for k in ("use_xray_heat", "use_cmb_heat", "use_lya_heat")},
    )


def _host(tinp, node):
    x_e_ave = float(jnp.mean(node["prev"].xray_ionised_fraction))
    return tsp.ts_host_tables(
        node["z"], tinp, float(node["pf"].redshift), node["prev_z"], x_e_ave)


# ------------------------------------------------------------------ host side


def test_shell_ladder_and_spectral_prefactors_match_jax(chain):
    """setup_z_edges and spectral_prefactors: relative 1e-12 (copies)."""
    z = chain["nodes"][-1]["z"]
    ref = jsp.setup_z_edges(z, chain["jinp"])
    got = tsp.setup_z_edges(z, chain["tinp"])
    for name, r in vars(ref).items():
        np.testing.assert_allclose(getattr(got, name), r, rtol=1e-12, err_msg=name)
    ref_s = jsp.spectral_prefactors(z, ref, chain["jinp"])
    got_s = tsp.spectral_prefactors(z, got, chain["tinp"])
    assert ref_s.keys() == got_s.keys()
    for name, r in ref_s.items():
        np.testing.assert_allclose(got_s[name], r, rtol=1e-12, err_msg=name)
    assert np.any(ref_s["starlya"] > 0)


SFRD_CASES = [(h, m) for h in ("ST", "PS", "DELOS") for m in ("GAUSS-LEGENDRE", "GAMMA-APPROX")]


@pytest.mark.parametrize("hmf_name,method", SFRD_CASES)
def test_sfrd_tables_match_jax(chain, hmf_name, method):
    """_build_sfrd_tables, one batched quadrature over the shell ladder
    (GAMMA-APPROX: the per-shell loop), against the JAX package's per-shell
    loop: d_lo, d_hi, tables and caps relative 1e-12, the Chebyshev fit
    against `_fit_log_cheby` of the JAX tables, and the shells the batch
    built."""
    z = chain["nodes"][-1]["z"]
    jinp = chain["jinp"].evolve_input_structs(HMF=hmf_name, INTEGRATION_METHOD_ATOMIC=method)
    tinp = port_inputs(jinp)
    ref = jsp._build_sfrd_tables(
        jinp, jsp.setup_z_edges(z, jinp), jsp._get_sigma_table(jinp), None)
    got = tsp._build_sfrd_tables(tinp, tsp.setup_z_edges(z, tinp), tsp._get_sigma_table(tinp))
    for name, r in zip(("d_lo", "d_hi", "tables", "caps"), ref):
        np.testing.assert_allclose(getattr(got, name), r, rtol=1e-12, err_msg=name)
    cheby, edge, ok = jion._fit_log_cheby(np.asarray(ref[2]), np.asarray(ref[3]))
    np.testing.assert_allclose(got.cheby, cheby, rtol=1e-12, atol=1e-12 * np.abs(cheby).max())
    np.testing.assert_allclose(got.edge, edge, rtol=1e-12)
    assert got.use_cheby == ok
    n_r = tinp.astro_params.N_STEP_TS
    assert got.tables.shape == (n_r, tsp.N_DELTA_SFRD)
    assert got.batched_shells == (0 if method == "GAMMA-APPROX" else n_r)


@pytest.mark.parametrize("hmf_name", ["PS", "ST", "DELOS", "WATSON"])
def test_nion_conditional_ladder_matches_the_per_row_integral(hmf_name):
    """hmf.nion_conditional_ladder against a loop of hmf.nion_conditional,
    to the last bit, over rows that reach the cap (one halo at the
    condition mass), that integrate below the condition mass (the cap is
    then 0), that hold nodes with sigma < sigma_cond, and with
    ln_lo >= ln_hi; WATSON takes the EPS fallback."""
    from py21cmfast_torch.inputs import InputParameters
    from py21cmfast_torch.models import hmf

    inputs = InputParameters(random_seed=1).evolve_input_structs(SOURCE_MODEL="E-INTEGRAL")
    table = tsp._get_sigma_table(inputs)
    h = hmf.HMF_NAMES[hmf_name]
    zs = np.array([30.0, 20.0, 15.0, 12.0, 9.0])
    growth = np.array([float(inputs.cosmology.dicke(z)) for z in zs])
    scs = [hmf.set_scaling_constants(z, inputs) for z in zs[:1]] + [
        hmf.set_scaling_constants(z, inputs).without_esc() for z in zs[1:]]
    mturn = np.array([sc.mturn_a_nofb for sc in scs])
    ln_lo = np.log([1e8, 5e7, 2e8, 1e8, 1e13])
    ln_cond = np.log([1e11, 3e11, 1e12, 1e12, 1e12])
    ln_hi = ln_cond - np.array([0.0, 0.0, 1.0, 0.0, 0.0])
    # row 3: a condition sigma of 1e11 Msun, above sigma at the nodes over it
    sigma_cond = table.sigma_of_lnm(ln_cond - np.array([0.0, 0.0, 0.0, np.log(10.0), 0.0]))
    eff = h if h in (hmf.HMF_PS, hmf.HMF_ST, hmf.HMF_DELOS) else hmf.HMF_PS
    d_crit = hmf.get_delta_crit(eff, sigma_cond, growth)
    deltas = np.linspace(-1.0 + 1e-6, 1.2 * d_crit, 60, axis=1)
    got = hmf.nion_conditional_ladder(
        table, h, growth, ln_lo, ln_cond, sigma_cond, deltas, mturn, scs, ln_hi=ln_hi)
    for i, sc in enumerate(scs):
        ref = hmf.nion_conditional(table, h, growth[i], ln_lo[i], ln_cond[i], sigma_cond[i],
                                   deltas[i], mturn[i], sc, ln_hi=ln_hi[i])
        np.testing.assert_array_equal(got[i], ref, err_msg=f"row {i}")
    capped = deltas > hmf.MAX_DELTAC_FRAC * d_crit[:, None]
    assert capped[:4].any(axis=1).all() and (~capped[:4]).any(axis=1).all()
    cap = hmf.nion_weight(ln_cond[:1], scs[0], mturn[0])[0] / np.exp(ln_cond[0])
    np.testing.assert_allclose(got[0][capped[0]], cap, rtol=1e-12)
    assert (got[2][capped[2]] == 0).all() and (got[2][~capped[2]] > 0).all()
    x, _ = hmf._gl_nodes(ln_lo[3], ln_hi[3])
    assert (table.sigma_of_lnm(x) < sigma_cond[3]).any()
    assert (got[4] == 0).all()


def test_heating_tables_match_jax(chain):
    """freq_integrals, nu_tau_one, kappa_tables, the Ly-a heating tables and
    the x_int deposition tables read from the port's own data: relative 1e-12."""
    jinp, tinp = chain["jinp"], chain["tinp"]
    np.testing.assert_array_equal(theat.X_INT_XHII, jheat.X_INT_XHII)
    lims = np.geomspace(2e17, 2e18, 5)
    for g, r in zip(
        theat.freq_integrals(12.0, theat.X_INT_XHII, lims, tinp.astro_params, 0.245),
        jheat.freq_integrals(12.0, jheat.X_INT_XHII, lims, jinp.astro_params, 0.245),
    ):
        np.testing.assert_allclose(g, r, rtol=1e-12)

    def nion(z):
        return 1e-3 * np.exp(-0.3 * np.asarray(z))

    cj, ct = jinp.cosmology, tinp.cosmology
    ref = jheat.nu_tau_one(12.0, 14.0, 1e-3, nion, 30.0, cj.N_b0, cj.dtdz, cj.Y_He)
    got = theat.nu_tau_one(12.0, 14.0, 1e-3, nion, 30.0, ct.N_b0, ct.dtdz, ct.Y_He)
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    for name, ref_k in jheat.kappa_tables().items():
        for g, r in zip(theat.kappa_tables()[name][:2], ref_k[:2]):
            np.testing.assert_allclose(g, r, rtol=1e-12)
    ref_l, got_l = jlya.get_lya_heat_tables(), tlya.get_lya_heat_tables()
    np.testing.assert_allclose(got_l.de_cont, ref_l.de_cont, rtol=1e-12)
    np.testing.assert_allclose(got_l.de_inj, ref_l.de_inj, rtol=1e-12)


def _nion(z):
    return 1e-3 * np.exp(-0.3 * np.asarray(z))


def _flat(value):
    return lambda z: np.full(np.shape(z), value)


# <x_e>-bound host tables of a whole ladder: (<x_e>, nion_of_z, the minihalo
# curves as one list of per-shell curves or None, their efficiency).
# "early-exits" puts the 3 nearest shells under a curve that floors the
# filling factor (tau_X at nu_HeI < 1: nu_HeI) and the 7 farthest under one
# that drives it far past any physical value (tau_X at 1 MeV > 1: 1 MeV).
XE_CASES = {
    "eulerian": (None, _nion, None, 0.0),
    "one-minihalo-curve": (None, _nion, "one", 5.0),
    "per-shell-curves": (None, _nion, "three", 5.0),
    "zero-fcoll-in-tau": (None, lambda z: np.zeros_like(np.asarray(z, np.float64)), None, 0.0),
    "xe-above-0.9999": (0.99995, _nion, None, 0.0),
    "early-exits": (None, _nion, "exits", 1.0),
    "nu-lo-above-nu-max": (None, _nion, None, 0.0),
    "nodes-below-the-table": (None, _nion, None, 0.0),
}


@pytest.mark.parametrize("case", sorted(XE_CASES))
def test_ladder_horizons_and_frequency_integrals_match_jax_per_shell(chain, case):
    """The port's one batched call for a real 40-shell dawn ladder against the
    JAX package's nu_tau_one shell by shell and its freq_integrals: relative
    1e-12."""
    nd, jinp, tinp = chain["nodes"][1], chain["jinp"], chain["tinp"]
    zp, ap = nd["z"], tinp.astro_params
    zpp = tsp.setup_z_edges(zp, tinp).zpp
    n_r = len(zpp)
    assert n_r == 40
    x_e, nion, curves, eff_mini = XE_CASES[case]
    if x_e is None:
        x_e = float(jnp.mean(nd["prev"].xray_ionised_fraction))
    per_shell = {
        None: [None] * n_r,
        "one": [_flat(0.08)] * n_r,
        "three": [[_flat(0.1), lambda z: 0.15 * np.exp(-0.3 * (np.asarray(z) - 20)), _flat(0.0)][i % 3]
                  for i in range(n_r)],
        "exits": [_flat(10.0)] * 3 + [_flat(0.0)] * (n_r - 10) + [_flat(-1e22)] * 7,
    }[curves]
    cj, ct = jinp.cosmology, tinp.cosmology
    ref = np.array([
        jheat.nu_tau_one(zp, zpp[i], x_e, nion, 30.0, cj.N_b0, cj.dtdz, cj.Y_He,
                         nion_mini_of_z=per_shell[i], ion_eff_mini=eff_mini)
        for i in range(n_r)
    ])
    got = theat.nu_tau_one(zp, zpp, x_e, nion, 30.0, ct.N_b0, ct.dtdz, ct.Y_He,
                           nion_mini_of_z=None if curves is None else per_shell,
                           ion_eff_mini=eff_mini)
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    if curves in ("one", "three"):  # each curve moves its shells' horizons
        plain = theat.nu_tau_one(zp, zpp, x_e, nion, 30.0, ct.N_b0, ct.dtdz, ct.Y_He)
        moved = np.ones(n_r, bool) if curves == "one" else np.arange(n_r) % 3 != 2
        assert (got != plain)[moved].all() and (got == plain)[~moved].all()
    at_floor = got == physconst.nu_ion_HeI
    at_top = got == np.exp(np.log(1e6 * physconst.eV_to_Hz))
    if case == "xe-above-0.9999":
        assert at_floor.all()
    elif case == "early-exits":
        assert at_floor[:3].all() and at_top[-7:].all() and not (at_floor | at_top)[3:-7].any()
    else:
        assert not (at_floor | at_top).any()

    nu_th = ap.NU_X_THRESH * physconst.eV_to_Hz
    lims = np.maximum(got, nu_th)
    if case == "nu-lo-above-nu-max":
        lims[[5, 17]] = ap.NU_X_MAX * physconst.eV_to_Hz * np.array([1.0, 1.5])
    if case == "nodes-below-the-table":  # HI's electrons start under 10 eV
        lims[[0, 9]] = physconst.nu_ion_HI * np.array([1.2, 1.5])
    tabs = [
        heat.freq_integrals(zp, heat.X_INT_XHII, lims, inp.astro_params, 0.245)
        for heat, inp in ((theat, tinp), (jheat, jinp))
    ]
    for g, r in zip(*tabs):
        np.testing.assert_allclose(g, r, rtol=1e-12)
    if case == "nu-lo-above-nu-max":
        assert not tabs[0][0][[5, 17]].any() and tabs[0][0][[4, 16]].all()


HOST_TO_JAX = dict(
    filter_R="r_values", do_filter="do_filter", growth="zpp_growth",
    z_edge_factor="z_edge_factor", xray_r_factor="xray_r_factor", d_lo="sfrd_dlo",
    d_hi="sfrd_dhi", sfrd_tables="sfrd_tables", sfrd_caps="sfrd_caps",
    sfrd_cheby="sfrd_cheby", sfrd_edge="sfrd_edge", mean_sfrd="mean_sfrd",
    tbl_heat="tbl_heat", tbl_ion="tbl_ion", tbl_lya="tbl_lya", starlya_pref="pref_starlya",
    lya_cont_pref="pref_lya_cont", lya_inj_pref="pref_lya_inj",
    lya_tbl_cont="lya_tbl_cont", lya_tbl_inj="lya_tbl_inj",
)


@pytest.mark.parametrize("node", [1, 4])
def test_folded_normalised_groups_match_jax(chain, node):
    """ts_host_tables given the JAX package's <x_e>: every per-shell array,
    rounded to float32, equals the array the JAX package passes to its device
    code (relative 1e-12), each normalised group peaks at 1.0 and its true
    peak is the s_* constant."""
    nd = chain["nodes"][node]
    h = _host(chain["tinp"], nd)
    a = nd["scan"].args
    for name, jname in HOST_TO_JAX.items():
        got = np.asarray(h[name], bool if name == "do_filter" else np.float32)
        np.testing.assert_allclose(got, np.asarray(a[jname]), rtol=1e-12, err_msg=name)
    for name in ("tbl_heat", "tbl_ion", "tbl_lya", "starlya_pref", "lya_cont_pref", "lya_inj_pref"):
        assert np.abs(h[name]).max() == 1.0, name
    consts = dict(zip(CONST_NAMES, (float(v) for v in a["consts"])))
    for name, ref in consts.items():
        if name != "s_lw":
            np.testing.assert_allclose(np.float32(h["consts"][name]), ref, rtol=1e-12, err_msg=name)
    np.testing.assert_allclose(np.float32(h["consts"]["gp_norm"]), float(a["gp_norm"]), rtol=1e-12)
    np.testing.assert_allclose(np.float32(h["fstar10"]), float(a["fstar10"]), rtol=1e-12)
    for got, ref in zip(h["kappa_knots"], a["kappa_knots"]):
        np.testing.assert_allclose(np.float32(got), np.asarray(ref), rtol=1e-12)
    assert h["use_cheby"] == a["use_cheby"] and h["const_model"] == a["const_model"]
    assert 1e-37 < consts["s_heat"] < 1e37 and consts["s_heat"] != 1.0


# ---------------------------------------------------------------- device side


def _variant_step(chain, monkeypatch, **over):
    """A JAX step at the chain's node 13.375 with some options changed."""
    nd = chain["nodes"][3]
    jinp = chain["jinp"].evolve_input_structs(**over) if over else chain["jinp"]
    _, scan, cell = jax_ts_step(monkeypatch, jinp, nd["z"], nd["pf"], nd["prev"], nd["prev_z"])
    return jinp, nd, scan, cell


@pytest.mark.parametrize("branch", ["chebyshev", "table-gather", "CONST-ION-EFF"])
def test_ts_shell_scan_matches_jax(chain, monkeypatch, branch):
    """Each accumulator of the shell loop, given the JAX package's own
    arguments: max-abs <= 2e-5 of its maximum."""
    if branch == "chebyshev":
        scan = chain["nodes"][3]["scan"]
    else:
        if branch == "table-gather":
            fit = jion._fit_log_cheby
            monkeypatch.setattr(jion, "_fit_log_cheby", lambda t, c: (*fit(t, c)[:2], False))
            over = {}
        else:
            over = dict(SOURCE_MODEL="CONST-ION-EFF")
        _, _, scan, _ = _variant_step(chain, monkeypatch, **over)
    a = scan.args
    assert a["use_cheby"] == (branch == "chebyshev")
    assert a["const_model"] == (branch == "CONST-ION-EFF")
    got = port_shell_scan(a)
    names = tsp._accumulator_names(a["use_xray_heat"], a["use_lya_heat"])
    assert len(got) == len(scan.out) == len(names) == 6
    for name, g, r in zip(names, got, scan.out):
        assert np.abs(np.asarray(r)).max() > 0, name
        _close(g.numpy(), r, 2e-5, f"{branch} {name}")


CELL_VARIANTS = {
    "default": {},
    "no-lya-heating": dict(USE_LYA_HEATING=False),
    "no-cmb-heating": dict(USE_CMB_HEATING=False),
    "no-xray-heating": dict(USE_X_RAY_HEATING=False),
}


@pytest.mark.parametrize("variant", CELL_VARIANTS)
def test_ts_cell_update_matches_jax(chain, monkeypatch, variant):
    """Ts, Tk, x_e and J_Lya of the per-cell update, given the JAX package's
    accumulators and constants: max-abs <= 2e-5 of the field's maximum, with
    USE_LYA_HEATING, USE_CMB_HEATING and USE_X_RAY_HEATING each on and off.
    The accumulators of a variant also pass through the port's shell loop."""
    over = CELL_VARIANTS[variant]
    jinp, nd, scan, cell = _variant_step(chain, monkeypatch, **over)
    a = cell.args
    for flag, opt in (("use_lya_heat", "USE_LYA_HEATING"), ("use_cmb_heat", "USE_CMB_HEATING"),
                      ("use_xray_heat", "USE_X_RAY_HEATING")):
        assert a[flag] == over.get(opt, True)
    h = _host(port_inputs(jinp), nd)
    got = port_cell_update(a, h["consts"]["dcmb_prefactor"])
    for name, g, r in zip(("Ts", "Tk", "x_e", "J_Lya"), got, cell.out):
        _close(g.numpy(), r, 2e-5, f"{variant} {name}")
    for g, r in zip(port_shell_scan(scan.args), scan.out):
        _close(g.numpy(), r, 2e-5, f"{variant} accumulator")


@pytest.mark.parametrize("adiabatic", [True, False])
def test_init_first_ts_matches_jax(chain, adiabatic):
    """The first node's RECFAST-like state: max-abs <= 2e-5 of the maximum."""
    nd = chain["nodes"][0]
    jinp = chain["jinp"].evolve_input_structs(USE_ADIABATIC_FLUCTUATIONS=adiabatic)
    ref, _ = jsp._init_first_ts(nd["z"], jinp, nd["pf"])
    pf = interop.perturbed_field_from_numpy(_numpy(nd["pf"]), "cpu")
    got, state = tsp._init_first_ts(nd["z"], port_inputs(jinp), pf, device="cpu")
    assert state is got and got.J_Lya is None and got.J_21_LW is None
    for name in TS_FIELDS[:3]:
        _close(getattr(got, name).numpy(), getattr(ref, name), 2e-5, name)


@pytest.mark.parametrize("node", [2, 4])
def test_compute_spin_temperature_one_step_matches_jax(chain, node):
    """One step from the JAX package's previous TsBox (carried by interop):
    max-abs <= 1e-4 of the field's maximum."""
    nd = chain["nodes"][node]
    pf = interop.perturbed_field_from_numpy(_numpy(nd["pf"]), "cpu")
    prev = interop.ts_box_from_numpy(_numpy(nd["prev"]), "cpu")
    got, state = tsp.compute_spin_temperature(
        nd["z"], chain["tinp"], pf, prev_state=prev, prev_redshift=nd["prev_z"], device="cpu")
    assert state is got and float(got.redshift) == float(nd["ts"].redshift)
    for name in TS_FIELDS:
        _close(getattr(got, name).numpy(), getattr(nd["ts"], name), 1e-4, f"{name} z={nd['z']}")


def test_first_node_and_z_heat_max_give_the_initial_state(chain):
    """Without a previous state, and at z >= Z_HEAT_MAX with one, the step is
    _init_first_ts."""
    nd = chain["nodes"][0]
    pf = interop.perturbed_field_from_numpy(_numpy(nd["pf"]), "cpu")
    first, _ = tsp.compute_spin_temperature(nd["z"], chain["tinp"], pf, device="cpu")
    again, _ = tsp.compute_spin_temperature(
        nd["z"], chain["tinp"], pf, prev_state=first, prev_redshift=30.0, device="cpu")
    assert nd["z"] >= chain["tinp"].simulation_options.Z_HEAT_MAX
    for name in TS_FIELDS[:3]:
        np.testing.assert_array_equal(getattr(first, name).numpy(), getattr(again, name).numpy())
        _close(getattr(first, name).numpy(), getattr(nd["ts"], name), 2e-5, name)


@pytest.mark.parametrize(
    "kwargs, over, match",
    [(dict(source_box="empty"), dict(SOURCE_MODEL="CHMF-SAMPLER"), None),
     (dict(mesh="one rank"), dict(), None)],
    ids=["source_box", "mesh"],
)
def test_arguments_outside_the_slice_raise(chain, kwargs, over, match, tmp_path):
    """Both arguments once raised and run now.  A device mesh (item 17):
    the step on a gloo mesh of one rank, which is not sharded, gives the
    single-device TsBox exactly (the sharded step runs in
    tests/test_torch_parallel_slice.py), and a mesh that is not a
    parallel.mesh.Mesh raises.  A source box runs for the fixed-grid
    sources (tests/test_torch_fixed_halos.py) and, since the discrete-halo
    slice, for the halo sampler's (tests/test_torch_halos.py): here a box
    with no sources in any shell gives a finite TsBox."""
    nd, prev = chain["nodes"][2], chain["nodes"][1]
    pf = interop.perturbed_field_from_numpy(_numpy(nd["pf"]), "cpu")
    inputs = chain["tinp"].evolve_input_structs(**over) if over else chain["tinp"]
    if "mesh" in kwargs:
        from _torch_parallel import one_rank_mesh

        state = dict(prev_state=interop.ts_box_from_numpy(_numpy(prev["ts"]), "cpu"),
                     prev_redshift=prev["z"])
        ref, _ = tsp.compute_spin_temperature(nd["z"], inputs, pf, device="cpu", **state)
        with one_rank_mesh(tmp_path) as mesh:
            got, _ = tsp.compute_spin_temperature(nd["z"], inputs, pf, mesh=mesh, device="cpu",
                                                  **state)
        for name in ("spin_temperature", "kinetic_temp_neutral", "xray_ionised_fraction"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(ref, name).numpy())
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            tsp.compute_spin_temperature(nd["z"], inputs, pf, mesh=object(), device="cpu")
        return
    n_shells = len(tsp.setup_z_edges(nd["z"], inputs).R)
    shells = torch.zeros((n_shells,) + inputs.simulation_options.lowres_shape)
    box = XraySourceBox(redshift=np.float32(nd["z"]), filtered_sfr=shells,
                        filtered_xray=shells)
    ts, _ = tsp.compute_spin_temperature(
        nd["z"], inputs, pf, prev_state=interop.ts_box_from_numpy(_numpy(prev["ts"]), "cpu"),
        prev_redshift=prev["z"], source_box=box, device="cpu")
    assert np.isfinite(ts.spin_temperature.numpy()).all()
    assert float(ts.kinetic_temp_neutral.min()) > 0.0


def test_trilerp_matches_jax():
    """One 8-corner gather per table against the JAX package's _trilerp and
    its paired row gather: max-abs <= 1e-6 of the table's maximum."""
    rng = np.random.default_rng(2)
    tbl = rng.normal(size=(5, 6, 7, 2)).astype(np.float32)
    t, s, g = (rng.uniform(-0.2, 1.2, (4, 4, 4)).astype(np.float32) for _ in range(3))
    ax = (0.0, 1.0)
    pair = jsp._trilerp_pair(jnp.asarray(tbl), *(jnp.asarray(v) for v in (t, s, g)), ax, ax, ax)
    for p in (0, 1):
        ref = jsp._trilerp(jnp.asarray(tbl[..., p]), *(jnp.asarray(v) for v in (t, s, g)), ax, ax, ax)
        got = tsp._trilerp(_t(tbl[..., p]), _t(t), _t(s), _t(g), ax, ax, ax)
        _close(got.numpy(), ref, 1e-6, "trilerp")
        _close(got.numpy(), pair[p], 1e-6, "trilerp pair")


def test_prefetch_builds_the_tables_a_node_then_takes(chain):
    """prefetch_sfrd_tables builds on its worker what _sfrd_tables_for then
    hands to the node, the fit included, identical to a synchronous build;
    the recorder books the worker's seconds as `ts.sfrd_build`, and the
    counter `ts.sfrd_batched_shells` in the book of the thread that takes
    the tables: the ladder's 40 shells, 0 under GAMMA-APPROX."""
    z = 13.375

    @tracing.traced_run
    def take(inputs):
        ladder = tsp.setup_z_edges(z, inputs)
        direct = tsp._build_sfrd_tables(inputs, ladder, tsp._get_sigma_table(inputs))
        tsp.prefetch_sfrd_tables(z, inputs)
        assert len(tsp._SFRD_PREFETCH["futs"]) == 1
        tracing.begin_node(0, z)
        yield direct, tsp._sfrd_tables_for(z, inputs, ladder, tsp._get_sigma_table(inputs))

    for inputs, shells in ((chain["tinp"], 40),
                           (chain["tinp"].evolve_input_structs(
                               INTEGRATION_METHOD_ATOMIC="GAMMA-APPROX"), 0)):
        (direct, taken), = take(inputs)
        run = tracing.runs(last=1)[0]
        assert run["nodes"][0]["counters"]["ts.sfrd_batched_shells"] == {None: shells}
        assert "ts.sfrd_batched_shells" not in run["counters"]
        assert not tsp._SFRD_PREFETCH["futs"]
        assert tracing.totals()["spans"]["ts.sfrd_build"][1] > 0
        assert taken.batched_shells == direct.batched_shells == shells
        assert taken.use_cheby == direct.use_cheby
        for g, r in zip(taken, direct):
            np.testing.assert_array_equal(g, r)
    tsp.prefetch_sfrd_tables(z, chain["tinp"].evolve_input_structs(SOURCE_MODEL="CONST-ION-EFF"))
    assert not tsp._SFRD_PREFETCH["futs"]
