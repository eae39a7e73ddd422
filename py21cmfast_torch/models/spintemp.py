"""Spin-temperature box: X-ray heating, Lyman-alpha coupling, IGM thermal state.

Equivalent of reference SpinTemperatureBox.c (ts_main:1387-1949), following
py21cmfast_tpu/models/spintemp.py for the Eulerian density path
(E-INTEGRAL and CONST-ION-EFF sources, with or without minihalos) and the
Lagrangian one (L-INTEGRAL: the sources come pre-filtered per shell in an
XraySourceBox, models/xray_source.py, and replace the density-conditioned
SFRD of the shell loop):

 * Host (numpy float64, once per snapshot, `ts_host_tables`): the z'' shell
   ladder (setup_z_edges:312), Lyman-series spectral prefactors
   (calculate_spectral_factors:364), global Nion/SFRD curves, tau_X=1 horizons
   and X-ray frequency-integral tables (fill_freqint_tables:810), and per-shell
   conditional-SFRD(delta) tables (calculate_sfrd_from_grid:1010).  Unit
   conversions are folded into the tables and every table group is scaled to
   peak 1.0, so that no float32 quantity on the device is a denormal.
 * Device (float32 tensors): a Python loop over the N_STEP_TS shells doing
   filter -> inverse FFT -> conditional-SFRD lookup -> accumulate of the
   radiative terms (`_ts_shell_scan`, the reference's R-loop :1562-1803), then
   the elementwise per-cell ODE step and Wouthuysen-Field Ts solve
   (`_ts_cell_update`, get_Ts_fast:1210-1384).
 * With USE_MINI_HALOS, a per-cell log10 MCG turnover box (Lyman-Werner,
   streaming-velocity and reionization feedback; ionization._mcrit_kernel) is
   filtered per shell and drives a second, (log10 Mturn, delta) SFRD gather
   for the Pop III stars, whose Lyman-Werner flux gives J_21_LW.

Known approximations vs the reference (as in the JAX package):
 * Ly-a heating tables are generated from the Fokker-Planck solution
   (models/lya_heating.py) rather than read from an external table.
 * RECFAST initial conditions come from the package's own Peebles solver.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from ..cosmology.constants import FRACT_FLOAT_ERR, physconst
from ..cosmology.recombination import RecombinationHistory
from ..inputs import InputParameters
from ..ops import filters
from ..ops.gridops import SINGLE, for_mesh
from ..outputs import PerturbedField, TsBox
from . import heating, hmf, lya_heating
from .ionization import (
    CHEBY_DEG,
    CHEBY_X_SAFE,
    MTURN_BOUNDS,
    N_MTURN_TABLE,
    _clenshaw,
    _fit_log_cheby,
    _gather2d,
    _get_sigma_table,
    mcrit_boxes,
)

__all__ = ["compute_spin_temperature", "prefetch_sfrd_tables"]

MAX_TK = 5e4
N_DELTA_SFRD = 400
# Shell-filter radius attribution for the Eulerian Ts ladder.  The flux from
# shell [R_inner, R_outer] carries density structure at scales between the two
# edges; smoothing at the geometric mid-radius is second-order accurate in the
# shell width, where the outer-edge choice (reference fill_Rbox_table) is
# first-order and under-resolves the Lya/X-ray flux structure at N_STEP_TS=40.
_FILTER_RADIUS_MODE = "mid"   # "outer" | "mid" | "inner"

_f32 = np.float32

# ---------------------------------------------------------------------------
# host-side shell setup


@dataclasses.dataclass
class ShellLadder:
    """The N_STEP_TS concentric shells and their emission redshifts."""

    R: np.ndarray  # outer radius of each shell [Mpc]
    R_inner: np.ndarray
    zpp_edge: np.ndarray  # redshift at the outer edge
    zpp: np.ndarray  # shell-centre redshift
    dzpp: np.ndarray
    dtdz: np.ndarray
    growth: np.ndarray
    m_min: np.ndarray
    m_max: np.ndarray


def setup_z_edges(zp: float, inputs: InputParameters) -> ShellLadder:
    """Reference setup_z_edges (SpinTemperatureBox.c:312-362)."""
    so = inputs.simulation_options
    ap = inputs.astro_params
    cosmo = inputs.cosmology
    n_step = ap.N_STEP_TS

    cell = 1.5 if so.HII_DIM == 1 else so.box_len / so.HII_DIM
    R = physconst.l_factor * cell
    R_factor = (ap.R_MAX_TS / R) ** (1.0 / n_step)

    Rs, R_in, z_edges, zpps, dzpps, dtdzs, growths = [], [], [], [], [], [], []
    prev_zpp, prev_R = zp, 0.0
    for _ in range(n_step):
        drdz = (1.0 + prev_zpp) * physconst.c_cms * cosmo.dtdz(prev_zpp)  # cm per dz
        z_edge = prev_zpp - (R - prev_R) * physconst.cm_per_Mpc / drdz
        zpp = 0.5 * (z_edge + prev_zpp)
        Rs.append(R)
        R_in.append(prev_R)
        z_edges.append(z_edge)
        zpps.append(zpp)
        dzpps.append(prev_zpp - z_edge)
        dtdzs.append(float(cosmo.dtdz(zpp)))
        growths.append(float(cosmo.dicke(zpp)))
        prev_zpp, prev_R = z_edge, R
        R = R * R_factor

    zpps = np.array(zpps)
    m_min = np.array([hmf.minimum_source_mass(z, inputs, xray=True) for z in zpps])
    m_max = np.asarray(cosmo.RtoM(np.array(Rs)))
    return ShellLadder(
        R=np.array(Rs),
        R_inner=np.array(R_in),
        zpp_edge=np.array(z_edges),
        zpp=zpps,
        dzpp=np.array(dzpps),
        dtdz=np.array(dtdzs),
        growth=np.array(growths),
        m_min=m_min,
        m_max=m_max,
    )


def spectral_prefactors(zp, ladder: ShellLadder, inputs: InputParameters):
    """Lyman-n recycling sums per shell (calculate_spectral_factors:364-499).

    Returns a dict with per-shell prefactor arrays: starlya/cont/inj (Pop II),
    starlya_mini (Pop III), lw and lw_mini (Lyman-Werner bands)."""
    ap = inputs.astro_params
    ao = inputs.astro_options
    spectra = heating.StellarSpectra(ap.POP2_ION, ap.POP3_ION)
    n_r = len(ladder.R)
    starlya = np.zeros(n_r)
    cont = np.zeros(n_r)
    inj = np.zeros(n_r)
    starlya_mini = np.zeros(n_r)
    cont_mini = np.zeros(n_r)
    inj_mini = np.zeros(n_r)
    lw = np.zeros(n_r)
    lw_mini = np.zeros(n_r)
    nu_lw_norm = 2.70331197e15 / 3.288465e15  # nu_LW_thresh / nu_ion_HI

    sum_prev = ly2_prev = lynto2_prev = 0.0
    mini_prev = ly2_mini_prev = lynto2_mini_prev = 0.0
    first_radii, first_zero = True, True
    prev_zpp = 0.0
    for i in range(n_r):
        zpp = ladder.zpp[i]
        sum_ly2 = sum_lynto2 = 0.0
        sum_mini = sum_ly2_mini = sum_lynto2_mini = sum_lw = sum_lw_mini = 0.0
        # n=2 (continuum photons that redshift into Lya)
        if zpp < heating.zmax_lyn(zp, 2):
            nuprime = heating.nu_n(2) * (1 + zpp) / (1 + zp)
            sum_ly2 = heating.frecycle(2) * spectra.emissivity(nuprime, 2)
            if ao.USE_MINI_HALOS:
                sum_ly2_mini = heating.frecycle(2) * spectra.emissivity(nuprime, 3)
                sum_mini += sum_ly2_mini
                nu_lw = max(nuprime, nu_lw_norm)
                if nu_lw < heating.nu_n(3):
                    sum_lw += (1 - ap.F_H2_SHIELD) * spectra.emissivity_band_integral(nu_lw, 2, 2)
                    sum_lw_mini += (1 - ap.F_H2_SHIELD) * spectra.emissivity_band_integral(nu_lw, 2, 3)
        # n>=3 (injected at line centre after cascade)
        for n in range(heating.NSPEC_MAX, 2, -1):
            if zpp > heating.zmax_lyn(zp, n):
                continue
            nuprime = heating.nu_n(n) * (1 + zpp) / (1 + zp)
            sum_lynto2 += heating.frecycle(n) * spectra.emissivity(nuprime, 2)
            if ao.USE_MINI_HALOS:
                _mini_n = heating.frecycle(n) * spectra.emissivity(nuprime, 3)
                sum_lynto2_mini += _mini_n
                sum_mini += _mini_n
                nu_lw = max(nuprime, nu_lw_norm)
                if nu_lw < heating.nu_n(n + 1):
                    sum_lw += (1 - ap.F_H2_SHIELD) * spectra.emissivity_band_integral(nu_lw, n, 2)
                    sum_lw_mini += (1 - ap.F_H2_SHIELD) * spectra.emissivity_band_integral(nu_lw, n, 3)
        sum_lyn = sum_ly2 + sum_lynto2

        # partial-shell edge correction (reference :439-463)
        if i > 1 and sum_lyn == 0.0 and sum_prev > 0.0 and first_radii:
            weight = 0.0
            n_pts = 1000
            for ii in range(n_pts):
                trial = prev_zpp + (zpp - prev_zpp) * ii / (n_pts - 1)
                counter = sum(
                    1 for n in range(heating.NSPEC_MAX, 1, -1)
                    if trial <= heating.zmax_lyn(zp, n)
                )
                if counter == 0 and first_zero:
                    first_zero = False
                    weight = ii / n_pts
            sum_lyn = weight * sum_prev
            sum_ly2 = weight * ly2_prev
            sum_lynto2 = weight * lynto2_prev
            if ao.USE_MINI_HALOS:
                # the reference corrects the Pop III sums in the same branch
                # (SpinTemperatureBox.c:456-459)
                sum_mini = weight * mini_prev
                sum_ly2_mini = weight * ly2_mini_prev
                sum_lynto2_mini = weight * lynto2_mini_prev
            first_radii = False

        zpp_integrand = (1 + zp) ** 2 * (1 + zpp)
        starlya[i] = zpp_integrand * sum_lyn
        cont[i] = zpp_integrand * sum_ly2
        inj[i] = zpp_integrand * sum_lynto2
        starlya_mini[i] = zpp_integrand * sum_mini
        cont_mini[i] = zpp_integrand * sum_ly2_mini
        inj_mini[i] = zpp_integrand * sum_lynto2_mini
        lw[i] = zpp_integrand * sum_lw
        lw_mini[i] = zpp_integrand * sum_lw_mini

        sum_prev, ly2_prev, lynto2_prev = sum_lyn, sum_ly2, sum_lynto2
        mini_prev, ly2_mini_prev, lynto2_mini_prev = (
            sum_mini, sum_ly2_mini, sum_lynto2_mini
        )
        prev_zpp = zpp
    return {"starlya": starlya, "cont": cont, "inj": inj,
            "starlya_mini": starlya_mini, "cont_mini": cont_mini,
            "inj_mini": inj_mini, "lw": lw, "lw_mini": lw_mini}


def _build_sfrd_tables(inputs, ladder, sigma_table, sc_zp):
    """Per-shell conditional SFRD(delta) tables (E-INTEGRAL path).

    Table axis is delta *at zpp* in [-1+eps, 0.99*delta_crit]."""
    n_r = len(ladder.R)
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    eff_hmf = hmf_int if hmf_int in (hmf.HMF_PS, hmf.HMF_ST, hmf.HMF_DELOS) else hmf.HMF_PS
    d_lo = np.full(n_r, -1.0 + 1e-6)
    d_hi = np.empty(n_r)
    tables = np.empty((n_r, N_DELTA_SFRD))
    caps = np.empty(n_r)
    sigma_cond = sigma_table.sigma_of_lnm(np.log(ladder.m_max))
    for i in range(n_r):
        growth = ladder.growth[i]
        sc = hmf.set_scaling_constants(ladder.zpp[i], inputs).without_esc()
        dcrit = float(hmf.get_delta_crit(eff_hmf, sigma_cond[i], growth))
        d_hi[i] = dcrit * hmf.MAX_DELTAC_FRAC
        deltas = np.linspace(d_lo[i], d_hi[i], N_DELTA_SFRD)
        tables[i] = hmf.nion_conditional(
            sigma_table,
            hmf_int,
            growth,
            float(np.log(ladder.m_min[i])),
            float(np.log(ladder.m_max[i])),
            sigma_cond[i],
            deltas,
            sc.mturn_a_nofb,
            sc,
            method=inputs.astro_options.INTEGRATION_METHOD_ATOMIC,
        )
        caps[i] = (
            hmf.nion_weight(np.array([np.log(ladder.m_max[i])]), sc, sc.mturn_a_nofb)[0]
            / ladder.m_max[i]
        )
    return d_lo, d_hi, tables, caps



# Next-node SFRD-table prefetch: the per-shell tables are pure-numpy host work
# that would otherwise serialize with the device work.  A single worker thread
# builds the NEXT node's tables while the main thread runs this node (numpy
# releases the GIL, and CUDA launches are asynchronous).  `stats` counts the
# seconds the worker spent building and the seconds a node waited for it.
_SFRD_PREFETCH: dict = {"pool": None, "futs": {}, "stats": {"build_s": 0.0, "wait_s": 0.0}}


def prefetch_sfrd_tables(zp: float, inputs: InputParameters) -> None:
    """Start building the E-INTEGRAL per-shell SFRD tables for a future node
    on a worker thread.  No-op for source models that don't use them."""
    if inputs.matter_options.SOURCE_MODEL != "E-INTEGRAL":
        return
    import concurrent.futures
    import time

    if _SFRD_PREFETCH["pool"] is None:
        _SFRD_PREFETCH["pool"] = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="sfrd-prefetch"
        )
    key = (round(float(zp), 9), inputs.full_hash)
    futs = _SFRD_PREFETCH["futs"]
    if key in futs:
        return
    if len(futs) > 4:  # stale entries of runs that stopped early
        futs.clear()

    def work():
        t0 = time.perf_counter()
        ladder = setup_z_edges(float(zp), inputs)
        out = _build_sfrd_tables(
            inputs, ladder, _get_sigma_table(inputs),
            hmf.set_scaling_constants(float(zp), inputs),
        )
        _SFRD_PREFETCH["stats"]["build_s"] += time.perf_counter() - t0
        return out

    futs[key] = _SFRD_PREFETCH["pool"].submit(work)


def _sfrd_tables_for(zp, inputs, ladder, sigma_table, sc_zp):
    """The prefetched tables when available, a synchronous build otherwise."""
    import time

    fut = _SFRD_PREFETCH["futs"].pop(
        (round(float(zp), 9), inputs.full_hash), None
    )
    if fut is not None:
        t0 = time.perf_counter()
        out = fut.result()
        _SFRD_PREFETCH["stats"]["wait_s"] += time.perf_counter() - t0
        return out
    return _build_sfrd_tables(inputs, ladder, sigma_table, sc_zp)


# ---------------------------------------------------------------------------
# device side


def _accumulator_names(
    use_xray_heat: bool, use_lya_heat: bool, use_minihalos: bool = False
) -> list[str]:
    """The radiative accumulators the static flags use, in the order the shell
    loop returns them and the cell update reads them."""
    names = ["dxion", "dxlya", "dstarlya"]
    if use_xray_heat:
        names.insert(0, "dxheat")
    if use_lya_heat:
        names += ["dlya_cont", "dlya_inj"]
    if use_minihalos:
        names.append("dstarlw")
    return names


def _trilerp(tbl, t, s, g, t_ax, s_ax, g_ax):
    """Trilinear gather on a (nt, ns, ng) table with uniform axes given as
    (min, max) bounds (reference interpolate_heating_efficiencies,
    heating_helper_progs.c:1260-1331)."""
    def _idx(v, lo, hi, n):
        u = (torch.clamp(v, lo, hi) - lo) / (hi - lo) * (n - 1)
        # u >= 0 after the clamp: truncation is a floor
        i0 = torch.clamp(u.to(torch.int64), 0, n - 2)
        return i0, u - i0

    nt, ns, ng = tbl.shape
    it, ft = _idx(t, t_ax[0], t_ax[1], nt)
    is_, fs = _idx(s, s_ax[0], s_ax[1], ns)
    ig, fg = _idx(g, g_ax[0], g_ax[1], ng)
    flat = tbl.reshape(-1)
    base = (it * ns + is_) * ng + ig
    out = 0.0
    for dt_ in (0, 1):
        wt = ft if dt_ else 1.0 - ft
        for ds_ in (0, 1):
            ws = fs if ds_ else 1.0 - fs
            for dg_ in (0, 1):
                wg = fg if dg_ else 1.0 - fg
                out = out + flat[base + ((dt_ * ns + ds_) * ng + dg_)] * (wt * ws * wg)
    return out


def _ts_shell_scan(
    density_pf, prev_xe, shells, inv_growth_pf, fstar10, *,
    shape, box_lens, heat_filter, use_xray_heat, use_lya_heat, use_cheby, const_model,
    mcrit_box=None, mcrit_clip=0.0, fstar7=0.0, lx_ratio=0.0, source=None, gops=SINGLE,
):
    """The radiative accumulators summed over the shells.

    `shells` is a list of per-shell dicts: float32-rounded Python scalars
    (R, do_filter, growth, zfac, xr_fac, d_lo, d_hi, cap, cheb, cheb_edge,
    mean_sfrd, p_star, p_cont, p_inj) and float32 tensors (table, table_fc,
    tbl_heat, tbl_ion, tbl_lya; the last three are the shell's 14-point
    frequency integrals).  `inv_growth_pf` and `fstar10` are float32-rounded
    scalars.  With minihalos, `mcrit_box` is the log10 MCG turnover box,
    filtered per shell and clipped below at `mcrit_clip`, and each shell also
    holds table_mini (its flattened (N_MTURN_TABLE, N_DELTA_SFRD) SFRD table),
    mean_sfrd_mini, p_star_mini, p_cont_mini, p_inj_mini, p_lw and p_lw_mini.

    `source` (Lagrangian sources) holds the XraySourceBox's already filtered
    shell stacks: `sfr`, `xray`, and with minihalos `sfr_mini` (then each
    shell also holds the Pop III and LW prefactors) and, under the Lya
    multiple-scattering window, the straight-line `sfr_lw` and `sfr_mini_lw`;
    the densities are then not read.  `gops` takes the FFTs, |k| and the
    shell means (ops/gridops.py; on a mesh the grids are x-slabs).
    Returns the accumulators named by `_accumulator_names`."""
    lagrangian = source is not None
    use_minihalos = mcrit_box is not None
    use_mini_terms = use_minihalos or (lagrangian and source.get("sfr_mini") is not None)
    if not lagrangian:
        kmag = gops.kmag(shape, box_lens, density_pf.device)
        d_k = gops.rfft3(density_pf * inv_growth_pf)
        mc_k = gops.rfft3(mcrit_box) if use_minihalos else None

    # per-cell x_e interpolation index into the 14-point deposition-fraction
    # axis: the count of nodes <= x_e, less one
    xhii = np.asarray(heating.X_INT_XHII, np.float32)
    xhii_grid = torch.as_tensor(xhii, device=density_pf.device)
    lo, hi = float(xhii[0] * _f32(1.001)), float(xhii[-1] * _f32(0.999))
    xe_call = torch.clamp(prev_xe, lo, hi)
    xidx = torch.clamp(torch.bucketize(xe_call, xhii_grid, right=True) - 1, 0, 12)
    ival = (xe_call - xhii_grid[xidx]) / (xhii_grid[xidx + 1] - xhii_grid[xidx])

    def freq(tbl):
        """A shell's 14-point frequency integrals at each cell's x_e."""
        return tbl[xidx] + ival * (tbl[xidx + 1] - tbl[xidx])

    names = _accumulator_names(use_xray_heat, use_lya_heat, use_mini_terms)
    acc = {n: torch.zeros_like(prev_xe) for n in names}

    for i, sh in enumerate(shells):
        if lagrangian:
            # halo-model shells are already filtered (XraySourceBox); units
            # folded on the host: sfr_term dimensionless, xray_sfr in table
            # units.  MCG X-rays are inside halo_xray, so only the Lya/LW SFR
            # splits out; the LW photons travel in straight lines and have
            # shells of their own under the multiple-scattering window
            # (SpinTemperatureBox.c:1676-1683, 1698-1706)
            sfr_term = source["sfr"][i] * sh["zfac"]
            xray_sfr = source["xray"][i] * float(_f32(sh["zfac"]) * _f32(sh["xr_fac"]))
            sfr_term_mini = source["sfr_mini"][i] * sh["zfac"] if use_mini_terms else None
            if source.get("sfr_lw") is not None:
                sfr_term_lw = source["sfr_lw"][i] * sh["zfac"]
                sfr_term_mini_lw = source["sfr_mini_lw"][i] * sh["zfac"]
            else:
                sfr_term_lw, sfr_term_mini_lw = sfr_term, sfr_term_mini
        else:
            sfr_term, sfr_term_mini, xray_sfr = _eulerian_shell_terms(
                sh, d_k, mc_k, kmag, inv_growth_pf, fstar10, fstar7, lx_ratio, shape=shape,
                heat_filter=heat_filter, use_cheby=use_cheby, const_model=const_model,
                mcrit_clip=mcrit_clip, gops=gops)
            sfr_term_lw, sfr_term_mini_lw = sfr_term, sfr_term_mini

        if use_xray_heat:
            acc["dxheat"] += xray_sfr * freq(sh["tbl_heat"])
        acc["dxion"] += xray_sfr * freq(sh["tbl_ion"])
        acc["dxlya"] += xray_sfr * freq(sh["tbl_lya"])
        acc["dstarlya"] += sfr_term * sh["p_star"]
        if use_lya_heat:
            # continuum (n=2 band) / injected (n>=3 cascades) Ly-a split
            # (reference SpinTemperatureBox.c:1730-1737)
            acc["dlya_cont"] += sfr_term * sh["p_cont"]
            acc["dlya_inj"] += sfr_term * sh["p_inj"]
            if use_mini_terms:
                acc["dlya_cont"] += sfr_term_mini * sh["p_cont_mini"]
                acc["dlya_inj"] += sfr_term_mini * sh["p_inj_mini"]
        if use_mini_terms:
            acc["dstarlya"] += sfr_term_mini * sh["p_star_mini"]
            acc["dstarlw"] += sfr_term_lw * sh["p_lw"]
            acc["dstarlw"] += sfr_term_mini_lw * sh["p_lw_mini"]
    return tuple(acc[n] for n in names)


def _eulerian_shell_terms(sh, d_k, mc_k, kmag, inv_growth_pf, fstar10, fstar7, lx_ratio, *,
                          shape, heat_filter, use_cheby, const_model, mcrit_clip, gops=SINGLE):
    """One shell's SFR terms (ACG, MCG or None) and X-ray source term from
    the filtered density (and with minihalos the filtered log10-Mcrit box):
    the conditional SFRD gathers, mean-fixed to the shell's global SFRD."""
    use_minihalos = mc_k is not None
    d_r = filters.filter_kbox(d_k, kmag, heat_filter, sh["R"]) if sh["do_filter"] else d_k
    delta0 = gops.irfft3(d_r, shape)
    if use_minihalos:
        # the filtered log10-Mcrit shell (reference fill_Rbox_table of
        # log10_Mcrit_LW, SpinTemperatureBox.c:1464-1473), clipped below at
        # the no-feedback LW threshold
        mc_r = mc_k if not sh["do_filter"] else filters.filter_kbox(
            mc_k, kmag, heat_filter, sh["R"])
        mc_r = torch.clamp_min(gops.irfft3(mc_r, shape), mcrit_clip)
    # aliasing clip at delta = -1 in PERTURBED-FIELD-redshift units, i.e.
    # BEFORE the 1/D(z_pf) extrapolation factor (fill_Rbox_table:619-625).
    # delta0 is z=0-normalized, so the floor is -1/D(z_pf).
    delta0 = torch.clamp_min(delta0, -inv_growth_pf)
    delta_zpp = delta0 * sh["growth"]
    span = float(_f32(sh["d_hi"]) - _f32(sh["d_lo"]))

    # conditional SFRD: log-Chebyshev Clenshaw when the host fit passed,
    # table gather otherwise (see models/ionization)
    if use_cheby:
        xch = torch.clamp((delta_zpp - sh["d_lo"]) / span * 2.0 - 1.0, -1.0, 1.0)
        flog = _clenshaw(sh["cheb"], torch.clamp_max(xch, CHEBY_X_SAFE), CHEBY_DEG)
        blend = torch.clamp((xch - CHEBY_X_SAFE) / (1.0 - CHEBY_X_SAFE), 0.0, 1.0)
        fcoll = torch.exp(flog * (1.0 - blend) + sh["cheb_edge"] * blend)
    else:
        t = (delta_zpp - sh["d_lo"]) / span * (N_DELTA_SFRD - 1)
        t = torch.clamp(t, 0.0, N_DELTA_SFRD - 1.001)
        i0 = t.to(torch.int64)  # t >= 0 after the clamp: truncation is a floor
        frac = t - i0
        table = sh["table"]
        fcoll = table[i0] * (1 - frac) + table[i0 + 1] * frac
    fcoll = torch.where(delta_zpp >= sh["d_hi"], sh["cap"], fcoll)
    fcoll = torch.clamp_min(fcoll, 1e-35)

    if const_model:
        # `table` holds -dfcoll/dz (the SFRD proxy); the mean fix uses the
        # plain fcoll grid (calculate_sfrd_from_grid:1061-1073)
        table_fc = sh["table_fc"]
        fc = table_fc[i0] * (1 - frac) + table_fc[i0 + 1] * frac
        fc = torch.where(delta_zpp >= sh["d_hi"], 1.0, fc)
        ave_fcoll = torch.clamp_min(gops.mean(fc, shape), 1e-35)
    else:
        ave_fcoll = torch.clamp_min(gops.mean(fcoll, shape), 1e-35)
    # form the O(1) grid/mean ratio BEFORE scaling by the global
    # expectation: mean_sfrd/ave_fcoll overflows float32 when the shell's
    # conditional SFRD is ~0 everywhere
    scale = float(_f32(sh["zfac"]) * _f32(sh["mean_sfrd"]) * _f32(fstar10))
    sfr_term = (1.0 + delta_zpp) * (fcoll / ave_fcoll) * scale
    # L_X * s/yr and the unit conversions are folded into the tables (host)
    if use_minihalos:
        if use_cheby:
            t = (delta_zpp - sh["d_lo"]) / span * (N_DELTA_SFRD - 1)
            t = torch.clamp(t, 0.0, N_DELTA_SFRD - 1.001)
            i0 = t.to(torch.int64)  # t >= 0 after the clamp: truncation is a floor
            frac = t - i0
        # bilinear (log10 Mcrit, delta) gather from the shell's 2D MCG SFRD
        # table (reference calculate_sfrd_from_grid:1010-1060), with its
        # own mean fix
        fcoll_mini = _gather2d(sh["table_mini"], N_DELTA_SFRD, mc_r, i0, frac)
        fcoll_mini = torch.clamp_min(fcoll_mini, 1e-35)
        ave_mini = torch.clamp_min(gops.mean(fcoll_mini, shape), 1e-35)
        scale_mini = float(_f32(sh["zfac"]) * _f32(sh["mean_sfrd_mini"]) * _f32(fstar7))
        sfr_term_mini = (1.0 + delta_zpp) * (fcoll_mini / ave_mini) * scale_mini
        xray_sfr = (sfr_term + sfr_term_mini * lx_ratio) * sh["xr_fac"]
    else:
        sfr_term_mini = None
        xray_sfr = sfr_term * sh["xr_fac"]
    return sfr_term, sfr_term_mini, xray_sfr


def _small_interp(x, xs, ys):
    """Piecewise-linear interpolation over a small non-uniform knot table;
    the index is the count of knots <= x, less one."""
    n = xs.shape[0]
    i0 = torch.clamp(torch.bucketize(x, xs, right=True) - 1, 0, n - 2)
    x0_, x1_ = xs[i0], xs[i0 + 1]
    y0_, y1_ = ys[i0], ys[i0 + 1]
    f = torch.clamp((x - x0_) / (x1_ - x0_), 0.0, 1.0)
    return y0_ * (1.0 - f) + y1_ * f


def _interp_kappa(logt_knots, logk_knots, log_t, hh_slope=None):
    out = _small_interp(log_t, logt_knots, logk_knots)
    if hh_slope is None:
        hh_slope = (logk_knots[-1] - logk_knots[-2]) / (logt_knots[-1] - logt_knots[-2])
    # power-law extrapolation above the last knot (kappa_10:439-442)
    out = torch.where(
        log_t > logt_knots[-1], logk_knots[-1] + hh_slope * (log_t - logt_knots[-1]), out
    )
    return torch.exp(out)


def _ts_cell_update(
    density_pf, prev_ts, prev_tk, prev_xe, accs, lya_tbl_cont, lya_tbl_inj, c, kappa_knots,
    *, use_xray_heat, use_cmb_heat, use_lya_heat, use_minihalos=False,
):
    """Per-cell x_e/Tk ODE + WF spin-temperature solve (get_Ts_fast,
    SpinTemperatureBox.c:1210-1384).

    `c` is the dict of per-snapshot constants, float32-rounded Python scalars
    (see `ts_host_tables`); the reference's unit prefactors span 1e-64..1e66
    individually and are folded on the host so that every quantity here stays
    within float32's normal range.  Returns (Ts, Tk, x_e, J_alpha, J_21_LW);
    J_21_LW is None without minihalos."""
    acc = dict(zip(_accumulator_names(use_xray_heat, use_lya_heat, use_minihalos), accs))
    zp, dzp, dt_dzp, trad = c["zp"], c["dzp"], c["dt_dzp"], c["trad"]
    fH, fHe = c["fH"], c["fHe"]

    delta = density_pf * float(_f32(c["growth_zp"]) * _f32(c["inv_growth_pf"]))
    delta = torch.clamp_min(delta, -1.0 + FRACT_FLOAT_ERR)

    # the tables were peak-normalized on the host; rescale each accumulator
    # ONCE here
    dxion_dt = acc["dxion"] * c["s_ion"]
    dxlya_dt = acc["dxlya"] * (1.0 + delta) * c["s_lya"]
    dstarlya_dt = acc["dstarlya"] * c["s_star"]

    # --- x_e evolution ---
    logT = torch.log(torch.clamp(prev_tk, 1e-2, 1e6) / 1.1604505e4)
    alpha_a = torch.exp(
        -28.6130338
        - 0.72411256 * logT
        - 2.02604473e-2 * logT**2
        - 2.38086188e-3 * logT**3
        - 3.21260521e-4 * logT**4
        - 1.42150291e-5 * logT**5
        + 4.98910892e-6 * logT**6
        + 5.75561414e-7 * logT**7
        - 1.85676704e-8 * logT**8
        - 3.07113524e-9 * logT**9
    )
    dxion_sink = alpha_a * c["clump"] * prev_xe * prev_xe * fH * c["nb_zp"] * (1.0 + delta)
    dxe_dzp = dt_dzp * (dxion_dt - dxion_sink)
    x_e = torch.clamp(prev_xe + dxe_dzp * dzp, 0.0, 1.0 - FRACT_FLOAT_ERR)

    # --- Tk evolution ---
    dadia = 3.0 / (1.0 + zp) + torch.where(
        torch.abs(delta) > FRACT_FLOAT_ERR,
        c["dgrowth_dzp"] / (c["growth_zp"] * (1.0 / delta + 1.0)),
        0.0,
    )
    dadia = dadia * (2.0 / 3.0) * prev_tk
    dspec = -dxe_dzp * prev_tk / (1.0 + prev_xe)
    dcomp = c["dcomp_prefactor"] * (prev_xe / (1.0 + prev_xe + fHe)) * (trad - prev_tk)
    dxheat_dzp = dcmb = dlya = 0.0
    if use_xray_heat:
        # 1/k_B is folded into the heat table on the host
        dxheat_dzp = acc["dxheat"] * c["s_heat"] * dt_dzp * 2.0 / 3.0 / (1.0 + prev_xe)
    if use_cmb_heat:
        # eps_cmb (2/3/k_B/(1+x_e)) / H / (1+zp), its scalar factors (which
        # multiply to ~1e-44 before 1/k_B) folded into one float64 on the host
        dcmb = c["dcmb_prefactor"] * (1.0 + 2.0 * prev_tk / physconst.T_21) / (1.0 + prev_xe)
    if use_lya_heat:
        # Ly-a heating (reference SpinTemperatureBox.c:1270-1293): the energy
        # transfer per photon crossing the resonance is gathered from the
        # Fokker-Planck tables at (prev_Tk, prev_Ts, tau_GP); the tables come
        # in pre-scaled by 4 pi nu_a/(c n_b (1+zp)) * 2/(3 k_B) so the device
        # term is just flux * dE / ((1+delta)(1+x_e)).
        taugp = c["gp_norm"] * (1.0 + delta) * (1.0 - prev_xe)
        t_lo, t_hi = 10.0**lya_heating.LOG_T_MIN, 10.0**lya_heating.LOG_T_MAX
        lt = torch.log10(torch.clamp(prev_tk, t_lo, t_hi))
        ls = torch.log10(torch.clamp(prev_ts, t_lo, t_hi))
        lg = torch.log10(torch.clamp(
            taugp, 10.0**lya_heating.LOG_GP_MIN, 10.0**lya_heating.LOG_GP_MAX))
        t_ax = (lya_heating.LOG_T_MIN, lya_heating.LOG_T_MAX)
        g_ax = (lya_heating.LOG_GP_MIN, lya_heating.LOG_GP_MAX)
        e_cont = _trilerp(lya_tbl_cont, lt, ls, lg, t_ax, t_ax, g_ax)
        e_inj = _trilerp(lya_tbl_inj, lt, ls, lg, t_ax, t_ax, g_ax)
        dlya = -(
            acc["dlya_cont"] * c["s_cont"] * e_cont + acc["dlya_inj"] * c["s_inj"] * e_inj
        ) / ((1.0 + delta) * (1.0 + prev_xe))

    dtk_total = dxheat_dzp + dcomp + dspec + dadia + dcmb + dlya
    tk = torch.where(prev_tk < MAX_TK, prev_tk + dtk_total * dzp, prev_tk)
    tk = torch.where(tk < 0, trad, tk)

    # --- spin temperature (WF + collisional couplings) ---
    tau21 = (
        (3 * physconst.h_p * physconst.A10 * physconst.c_cms * physconst.lambda_21**2
         / 32.0 / np.pi / physconst.k_B)
        * ((1.0 - prev_xe) * c["n_zp"])
        / prev_ts
        / c["hubble_zp"]
    )
    xcmb = torch.where(
        tau21 > 1e-8,
        (1.0 - torch.exp(-tau21)) / torch.clamp_min(tau21, 1e-30),
        1.0 - tau21 / 2 * (1 - tau21 / 3 * (1 - tau21 / 4)),
    )

    hh_t, hh_k, eh_t, eh_k, ph_t, ph_k = kappa_knots
    log_tk = torch.log(torch.clamp(tk, 1.0, 1e12))
    kappa_hh = _interp_kappa(hh_t, hh_k, log_tk, hh_slope=0.381)
    kappa_eh = _interp_kappa(eh_t, eh_k, log_tk)
    kappa_ph = _interp_kappa(ph_t, ph_k, log_tk)

    no_total, nb0_total = c["no_total"], c["nb0_total"]
    xc = (
        (1.0 + delta)
        * c["xc_inverse"]
        * ((1.0 - x_e) * no_total * kappa_hh + x_e * nb0_total * kappa_eh
           + x_e * no_total * kappa_ph)
    )

    j_alpha = dstarlya_dt + dxlya_dt
    t_inv = 1.0 / tk
    t_inv_sq = t_inv * t_inv
    # the cube root's argument is non-negative by construction
    xi = c["ts_prefactor"] * torch.pow((1.0 + delta) * (1.0 - x_e) * t_inv_sq, 1.0 / 3.0)
    xa_arg = (
        c["xa_tilde_prefactor"]
        * j_alpha
        / (1.0 + 2.98394 * xi + 1.53583 * xi**2 + 3.85289 * xi**3)
    )

    ts = torch.full_like(density_pf, trad)
    for _ in range(10):
        ts_inv = 1.0 / ts
        xa = (
            1.0
            - 0.0631789 * t_inv
            + 0.115995 * t_inv_sq
            - 0.401403 * t_inv * ts_inv
            + 0.336463 * t_inv_sq * ts_inv
        ) * xa_arg
        ts = (xcmb + xa + xc) / (
            xcmb / trad + xa * (t_inv + 0.405535 * t_inv * ts_inv - 0.405535 * t_inv_sq)
            + xc * t_inv
        )
    ts_coll = (xcmb + xc) / (xcmb / trad + xc * t_inv)
    ts = torch.abs(torch.where(j_alpha > 1e-20, ts, ts_coll))
    j_lw = acc["dstarlw"] * c["s_lw"] if use_minihalos else None
    return ts, tk, x_e, j_alpha, j_lw


# ---------------------------------------------------------------------------
# public entry


def _init_first_ts(redshift, inputs, perturbed_field, device="cuda"):
    """First snapshot / z >= Z_HEAT_MAX: RECFAST-like adiabatic state
    (reference init_first_Ts:892-926)."""
    dev = resolve_device(device)
    cosmo = inputs.cosmology
    rec = RecombinationHistory(cosmo)
    xe = float(rec.x_e(redshift))
    tk = float(rec.Tk(redshift))
    # adiabatic Tk fluctuations at init, gated like the reference
    # (init_first_Ts, SpinTemperatureBox.c:900-904)
    ct_ad = (
        float(rec.cT_approx(redshift))
        if inputs.astro_options.USE_ADIABATIC_FLUCTUATIONS
        else 0.0
    )
    growth_zp = float(cosmo.dicke(redshift))
    inv_growth_pf = 1.0 / float(cosmo.dicke(float(perturbed_field.redshift)))

    dens = perturbed_field.density.to(dev) * float(_f32(growth_zp * inv_growth_pf))
    tk_box = float(_f32(tk)) * (1.0 + float(_f32(ct_ad)) * dens)

    # collisional-only Ts (get_Ts with Jalpha=0, heating_helper:738-740)
    trad = physconst.T_cmb * (1 + redshift)
    no = cosmo.rho_crit_cgs * cosmo.OMb * (1 - cosmo.Y_He) / physconst.m_p
    nb0 = cosmo.N_b0

    kt = heating.kappa_tables()
    log_tk = np.log(np.maximum(tk, 1.0))
    kap_hh, kap_eh, kap_ph = (
        float(_f32(np.exp(np.interp(log_tk, kt[name][0], kt[name][1]))))
        for name in ("HH", "eH", "pH")
    )
    zp3 = (1.0 + redshift) ** 3

    nH = (1 - xe) * no * zp3 * (1.0 + dens)
    ne = xe * nb0 * zp3 * (1.0 + dens)
    npr = xe * no * zp3 * (1.0 + dens)
    xc = (
        physconst.T_21
        / trad
        * (nH * kap_hh + ne * kap_eh + npr * kap_ph)
        / physconst.A10
    )
    ts = (1.0 + xc) / (1.0 / trad + xc / tk_box)

    box = TsBox(
        redshift=np.float32(redshift),
        spin_temperature=ts,
        xray_ionised_fraction=torch.full_like(dens, xe),
        kinetic_temp_neutral=tk_box,
        J_21_LW=torch.zeros_like(dens) if inputs.astro_options.USE_MINI_HALOS else None,
    )
    return box, box


def _norm_group(*arrs):
    """Scale a group of folded tables to peak 1.0; returns the scaled arrays
    and the peak.  Groups that add into the same accumulator share one scale."""
    peak = max(float(np.max(np.abs(np.asarray(a, np.float64)))) for a in arrs)
    if peak > 1e37:
        raise FloatingPointError(
            f"folded Ts table peaks at {peak:.2e} — beyond float32 range;"
            " rebalance the unit folding (see the fold note in ts_host_tables)"
        )
    if peak < 1e-37:
        # the whole group is numerically negligible even after descale
        # (~40 orders below the signal terms); zero it explicitly rather
        # than let the device flush it
        return tuple(
            np.zeros_like(np.asarray(a, np.float64)) for a in arrs
        ) + (0.0,)
    return tuple(np.asarray(a, np.float64) / peak for a in arrs) + (peak,)


def ts_host_tables(redshift, inputs, pf_redshift, prev_redshift, x_e_ave, ave_mcrit=0.0,
                   lagrangian=False, lagr_mcrit=None, lagr_mini=False):
    """Everything the device side of one Ts step needs from the host, float64.

    `x_e_ave` is the mean x_e of the previous state (it sets the tau_X = 1
    horizons); with minihalos `ave_mcrit` is the mean of the log10 MCG
    turnover box (it sets the MCG tau_X term and mean SFRD).  Returns a dict with the per-shell arrays (`filter_R`,
    `do_filter`, `growth`, `z_edge_factor`, `xray_r_factor`, `d_lo`, `d_hi`,
    `sfrd_tables`, `sfrd_tables_fc`, `sfrd_caps`, `sfrd_cheby`, `sfrd_edge`,
    `mean_sfrd`, `tbl_heat`, `tbl_ion`, `tbl_lya`, `starlya_pref`,
    `lya_cont_pref`, `lya_inj_pref`), the Ly-a heating tables, the flags
    `use_cheby` / `const_model` / `use_lya_heat`, `fstar10`, `kappa_knots`,
    and `consts`, the per-snapshot scalars of `_ts_cell_update` with the
    peaks `s_*` of the normalised table groups.  With minihalos also
    `mcrit_clip`, `sfrd_tables_mini`, `mean_sfrd_mini`, the Pop III and LW
    prefactors (`starlya_mini_pref`, `lya_cont_mini_pref`,
    `lya_inj_mini_pref`, `lw_pref`, `lw_mini_pref`), `fstar7` and
    `lx_ratio`.

    `lagrangian` (sources from an XraySourceBox): no SFRD tables, the shell
    factor |dz'' dt/dz| and the emissivity units of the halo grids folded
    into the tables (set_zp_consts:1171-1175); `lagr_mcrit` is the box's
    per-shell mean log10 MCG turnover (each shell's MCG tau_X curve is keyed
    on it) and `lagr_mini` says that the box carries minihalo shells, whose
    Pop III and LW prefactors are then returned as with minihalos.  The flag
    `mini_terms` says whether the minihalo accumulators are used."""
    so = inputs.simulation_options
    ao = inputs.astro_options
    ap = inputs.astro_params
    cosmo = inputs.cosmology

    # CONST-ION-EFF: SFRD from the fcoll redshift derivative, not the
    # scaling-relation Nion integrals (reference calculate_sfrd_from_grid:
    # 1061-1067, global_reion_properties:927-943)
    const_model = not lagrangian and inputs.matter_options.SOURCE_MODEL == "CONST-ION-EFF"

    ladder = setup_z_edges(redshift, inputs)
    n_r = len(ladder.R)
    sigma_table = _get_sigma_table(inputs)
    sc_zp = hmf.set_scaling_constants(redshift, inputs)
    sc_sfrd = sc_zp.without_esc()
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]

    spec = spectral_prefactors(redshift, ladder, inputs)
    starlya_pref = spec["starlya"]
    lya_cont_pref = spec["cont"]
    lya_inj_pref = spec["inj"]

    # global Nion(z) for the tau_X filling factor + mean SFRD per shell
    z_grid = np.linspace(redshift * 0.999, ladder.zpp[-1] * 1.001, 128)
    ln_mmin_zp = np.log(hmf.minimum_source_mass(redshift, inputs, xray=True))
    ln_mmax = np.log(hmf.M_MAX_INTEGRAL)
    if const_model:
        # constant ionizing efficiency: Nion == fcoll, zeta == HII_EFF_FACTOR
        # (reference global_reion_properties:985-991)
        nion_vals = np.array(
            [
                hmf.fcoll_general(sigma_table, cosmo, hmf_int, z, ln_mmin_zp, ln_mmax)
                for z in z_grid
            ]
        )
        # EvaluateSFRD for SOURCE_MODEL=CONST-ION-EFF is Fcoll_General over
        # [minimum_source_mass(zpp, xray), M_MAX] (interp_tables.c:923-943)
        mean_sfrd = np.array(
            [
                hmf.fcoll_general(
                    sigma_table, cosmo, hmf_int, ladder.zpp[i],
                    float(np.log(ladder.m_min[i])), ln_mmax,
                )
                for i in range(n_r)
            ]
        )
        ion_eff = float(ap.HII_EFF_FACTOR)
    elif lagrangian:
        # the halo grids carry the SFR: only the global Nion(z) of tau_X
        nion_vals = np.array(
            [
                hmf.nion_general(sigma_table, cosmo, hmf_int, z, ln_mmin_zp, ln_mmax,
                                 sc_zp.mturn_a_nofb, sc_zp)
                for z in z_grid
            ]
        )
        mean_sfrd = np.zeros(n_r)
        ion_eff = sc_zp.pop2_ion * sc_zp.fstar_10 * sc_zp.fesc_10
    else:
        nion_vals = np.array(
            [
                hmf.nion_general(sigma_table, cosmo, hmf_int, z, ln_mmin_zp, ln_mmax,
                                 sc_zp.mturn_a_nofb, sc_zp)
                for z in z_grid
            ]
        )
        mean_sfrd = np.array(
            [
                hmf.nion_general(
                    sigma_table, cosmo, hmf_int, ladder.zpp[i],
                    float(np.log(ladder.m_min[i])), ln_mmax,
                    sc_sfrd.mturn_a_nofb, sc_sfrd,
                )
                for i in range(n_r)
            ]
        )
        ion_eff = sc_zp.pop2_ion * sc_zp.fstar_10 * sc_zp.fesc_10

    def nion_of_z(z):
        return np.interp(z, z_grid, nion_vals)

    # MCG contribution to the tau_X filling factor (nu_tau_one_MINI,
    # heating_helper_progs.c:901-941 + fill_freqint_tables:838): per shell,
    # the global MCG Nion(z) at that shell's mean LW turnover mass, its log10
    # rounded to 3 decimals as the key of one curve.  Eulerian: the box's mean
    # for every shell (the shell filter keeps the mean); Lagrangian: the
    # source box's per-shell means, and no MCG term without them (ts_main:1481)
    use_minihalos = bool(ao.USE_MINI_HALOS) and not lagrangian
    mini_terms = use_minihalos or (lagrangian and lagr_mini)
    mcrit_clip = 0.0
    nion_mini_shells = [None] * n_r
    ion_eff_mini = 0.0
    if use_minihalos:
        mcrit_clip = float(np.log10(hmf.lyman_werner_threshold(redshift, 0.0, 0.0, ap)))
    if ao.USE_MINI_HALOS and not const_model and (not lagrangian or lagr_mcrit is not None):
        ion_eff_mini = sc_zp.pop3_ion * sc_zp.fstar_7 * sc_zp.fesc_7
        if lagrangian:
            shell_mcrit = np.asarray(lagr_mcrit, np.float64)
        else:
            shell_mcrit = np.full(n_r, max(ave_mcrit, mcrit_clip))
        zg_mini = np.linspace(redshift * 0.999, ladder.zpp[-1] * 1.001, 48)
        curves = {}
        for i in range(n_r):
            key = round(float(shell_mcrit[i]), 3)
            if key not in curves:
                vals = np.array([
                    hmf.nion_general_mini(
                        sigma_table, cosmo, hmf_int, z,
                        float(np.log(hmf.minimum_source_mass(z, inputs, xray=True))),
                        ln_mmax, 10.0 ** key, sc_zp,
                    )
                    for z in zg_mini
                ])
                curves[key] = lambda zz, v=vals: np.interp(zz, zg_mini, v)
            nion_mini_shells[i] = curves[key]

    # tau_X = 1 horizons and frequency-integral tables.  Single-cell (0-D
    # global evolution) runs zero the collapsed fractions in the tau_X
    # integrand while <x_e> is still tiny, exactly like the reference
    # (tauX_integrand, heating_helper_progs.c:914-923).
    zero_fcoll_in_tau = so.HII_DIM == 1 and x_e_ave < so.MIN_XE_FOR_FCOLL_IN_TAUX
    nion_of_z_tau = (lambda z: np.zeros_like(np.asarray(z, np.float64))) \
        if zero_fcoll_in_tau else nion_of_z
    nu_th = ap.NU_X_THRESH * physconst.eV_to_Hz
    lower_limits = np.array(
        [
            max(
                heating.nu_tau_one(
                    redshift, ladder.zpp[i], x_e_ave, nion_of_z_tau, ion_eff,
                    cosmo.N_b0, cosmo.dtdz, cosmo.Y_He,
                    nion_mini_of_z=None if zero_fcoll_in_tau else nion_mini_shells[i],
                    ion_eff_mini=0.0 if zero_fcoll_in_tau else ion_eff_mini,
                ),
                nu_th,
            )
            for i in range(n_r)
        ]
    )
    tbl_heat, tbl_ion, tbl_lya = heating.freq_integrals(
        redshift, heating.X_INT_XHII, lower_limits, ap, cosmo.Y_He
    )

    # conditional SFRD tables
    use_cheby = False
    sfrd_cheby = np.zeros((n_r, CHEBY_DEG + 1))
    sfrd_edge = np.zeros(n_r)
    sfrd_tables_fc = np.zeros((n_r, 2))
    if lagrangian:
        d_lo, d_hi = np.zeros(n_r), np.ones(n_r)
        sfrd_tables = np.zeros((n_r, N_DELTA_SFRD))
        sfrd_caps = np.zeros(n_r)
        # Lagrangian shells carry SFR density directly (ts_main:1570-1572)
        z_edge_factor = np.abs(ladder.dzpp * ladder.dtdz)
    elif const_model:
        # CONST-ION-EFF: per-shell closed-form EPS tables of fcoll (for the
        # mean fix) and -dfcoll/dz (the SFRD; calculate_sfrd_from_grid:
        # 1061-1067); z_edge_factor is just the shell dz (ts_main:1566-1567)
        d_lo = np.full(n_r, -1.0 + 1e-6)
        d_hi = np.empty(n_r)
        sfrd_tables = np.empty((n_r, N_DELTA_SFRD))
        sfrd_tables_fc = np.empty((n_r, N_DELTA_SFRD))
        sfrd_caps = np.empty(n_r)
        sigma_cond_r = sigma_table.sigma_of_lnm(np.log(ladder.m_max))
        sigma_min_r = sigma_table.sigma_of_lnm(np.log(ladder.m_min))
        for i in range(n_r):
            d_hi[i] = physconst.delta_c_sph * hmf.MAX_DELTAC_FRAC
            deltas = np.linspace(d_lo[i], d_hi[i], N_DELTA_SFRD)
            sfrd_tables[i] = -hmf.dfcoll_dz(
                cosmo, float(ladder.zpp[i]), deltas, sigma_min_r[i], sigma_cond_r[i]
            )
            sfrd_tables_fc[i] = hmf.fcoll_conditional_eps(
                float(ladder.growth[i]), deltas, sigma_min_r[i], sigma_cond_r[i]
            )
            sfrd_caps[i] = sfrd_tables[i][-1]
        z_edge_factor = np.abs(ladder.dzpp)
    else:
        d_lo, d_hi, sfrd_tables, sfrd_caps = _sfrd_tables_for(
            redshift, inputs, ladder, sigma_table, sc_zp
        )
        sfrd_cheby, sfrd_edge, use_cheby = _fit_log_cheby(sfrd_tables, sfrd_caps)
        # z-edge factors (ts_main:1566-1572, E-INTEGRAL branch)
        z_edge_factor = np.abs(ladder.dzpp * ladder.dtdz) * np.asarray(
            cosmo.hubble(ladder.zpp)
        ) / ap.t_STAR
    xray_r_factor = (1 + ladder.zpp) ** (-ap.X_RAY_SPEC_INDEX)

    # minihalo (MCG) SFRD: 2D (log10 Mcrit, delta) tables per shell, gathered
    # at the filtered turnover box (reference calculate_sfrd_from_grid)
    sfrd_tables_mini = np.zeros((n_r, 2, N_DELTA_SFRD))
    mean_sfrd_mini = np.zeros(n_r)
    if use_minihalos:
        mturn_axis = np.linspace(*MTURN_BOUNDS, N_MTURN_TABLE)
        sfrd_tables_mini = np.zeros((n_r, N_MTURN_TABLE, N_DELTA_SFRD))
        for i in range(n_r):
            zpp = float(ladder.zpp[i])
            sc_pp = hmf.set_scaling_constants(zpp, inputs).without_esc()
            sigma_cond = float(sigma_table.sigma_of_lnm(np.log(ladder.m_max[i])))
            deltas = np.linspace(d_lo[i], d_hi[i], N_DELTA_SFRD)
            sfrd_tables_mini[i] = hmf.build_nion_mturn_tables(
                sigma_table, hmf_int, ladder.growth[i],
                float(np.log(ladder.m_min[i])),
                float(np.log(ladder.m_max[i])), sigma_cond, deltas,
                mturn_axis, sc_pp, mini=True,
                method=ao.INTEGRATION_METHOD_MINI,
            )
            mean_sfrd_mini[i] = hmf.nion_general_mini(
                sigma_table, cosmo, hmf_int, zpp,
                float(np.log(ladder.m_min[i])), ln_mmax,
                10.0 ** max(ave_mcrit, mcrit_clip), sc_pp,
            )

    # ---------------- per-snapshot constants (set_zp_consts:1098-1183) -------
    zp = redshift
    dzp = zp - prev_redshift
    growth_zp = float(cosmo.dicke(zp))
    inv_growth_pf = 1.0 / float(cosmo.dicke(float(pf_redshift)))
    hubble_zp = float(cosmo.hubble(zp))
    trad = physconst.T_cmb * (1 + zp)

    if abs(ap.X_RAY_SPEC_INDEX - 1.0) < 1e-6:
        lum_conv = 1.0 / (nu_th * np.log(ap.NU_X_BAND_MAX / ap.NU_X_THRESH))
    else:
        lum_conv = (ap.NU_X_BAND_MAX * physconst.eV_to_Hz) ** (1 - ap.X_RAY_SPEC_INDEX) - (
            nu_th
        ) ** (1 - ap.X_RAY_SPEC_INDEX)
        lum_conv = (1.0 / lum_conv) * nu_th ** (-ap.X_RAY_SPEC_INDEX) * (
            1 - ap.X_RAY_SPEC_INDEX
        )
    lum_conv /= physconst.h_p
    xray_prefactor = (
        lum_conv / nu_th * physconst.c_cms * (1 + zp) ** (ap.X_RAY_SPEC_INDEX + 3)
    )

    no_total = cosmo.rho_crit_cgs * cosmo.OMb * (1 - cosmo.Y_He) / physconst.m_p
    nb0_total = cosmo.N_b0
    nb_zp = nb0_total * (1 + zp) ** 3
    n_zp = no_total * (1 + zp) ** 3
    lya_star_prefactor = (
        physconst.c_cms / (4 * np.pi) * physconst.Msun / physconst.m_p
        * (1 - 0.75 * cosmo.Y_He)
    )
    volunit_inv = cosmo.OMb * cosmo.rho_crit / physconst.cm_per_Mpc**3

    ts_prefactor = (1e-7 * (1.342881e-7 / hubble_zp) * no_total * (1 + zp) ** 3) ** (1 / 3)
    gamma_alpha = physconst.f_alpha * (
        physconst.nu_Ly_alpha * physconst.e_charge / (physconst.c_cms / 10.0)
    ) ** 2
    gamma_alpha /= (
        6.0 * (physconst.m_e / 1000.0) * (physconst.c_cms / 100.0) ** 3 * physconst.vac_perm
    )
    xa_tilde_prefactor = (
        8.0 * np.pi * (physconst.lambda_Ly_alpha * 1e-8) ** 2 * gamma_alpha * physconst.T_21
    ) / (9.0 * physconst.A10 * trad)
    xc_inverse = (1 + zp) ** 3 * physconst.T_21 / (trad * physconst.A10)
    dcomp_prefactor = (
        -1.51e-4 / (hubble_zp / (cosmo.hlittle * 3.2407e-18)) / cosmo.hlittle
        * trad**4 / (1 + zp)
    )
    fH = heating.h_frac(cosmo.Y_He)
    fHe = heating.he_frac(cosmo.Y_He)
    dgrowth_dzp = float(cosmo.ddicke_dz(zp))
    dt_dzp = float(cosmo.dtdz(zp))
    # CMB heating: every scalar factor of eps_cmb (2/3/k_B) / H / (1+zp) in
    # one float64 (their partial products pass through ~1e-44)
    dcmb_prefactor = -(
        (3.0 / 4.0) * (trad / physconst.T_21) * physconst.A10 * fH
        * (physconst.h_p**2 / physconst.lambda_21**2 / physconst.m_p)
        * (2.0 / 3.0 / physconst.k_B) / hubble_zp / (1.0 + zp)
    )

    # Fold unit conversions into the tables (float64 on the host) so all
    # device-side scalars are float32-safe: the raw prefactors span
    # ~1e-64..1e66.  NOTE on the 1/k_B fold: the heating frequency integral is
    # ~1e-15 in raw units, 9-11 orders below the ion/lya integrals; folding
    # the consumer's 1/k_B (7.2e15) here keeps the float32 heat table
    # comfortably normal, and the device-side Tk update no longer divides by
    # k_B.
    if lagrangian:
        # halo grids are Msun/s/Mpc^3 (SFR) and 1e38 erg/s/Mpc^3 (X-ray);
        # the emissivity-to-per-baryon conversion is 1/cm_per_Mpc^3
        # (set_zp_consts:1171-1175).  The heat table lands near 1e-43 before
        # `_norm_group` scales it to peak 1.
        volunit_inv = physconst.cm_per_Mpc**-3
        xray_norm = xray_prefactor * volunit_inv * 1e38
        lya_norm = lya_star_prefactor * volunit_inv
        tbl_heat = tbl_heat * (xray_norm / physconst.k_B)
        tbl_ion = tbl_ion * xray_norm
        tbl_lya = tbl_lya * (xray_norm * nb_zp)
    else:
        xray_norm = xray_prefactor * volunit_inv
        lya_norm = lya_star_prefactor * volunit_inv
        lx_lin = ap.l_x * physconst.s_per_yr  # L_X * s/yr
        tbl_heat = tbl_heat * (xray_norm * lx_lin / physconst.k_B)
        tbl_ion = tbl_ion * (xray_norm * lx_lin)
        tbl_lya = tbl_lya * (xray_norm * lx_lin * nb_zp)  # (1+delta) applied on device
    starlya_pref = starlya_pref * lya_norm
    lya_cont_mini_pref = spec["cont_mini"]
    lya_inj_mini_pref = spec["inj_mini"]

    # --- Ly-a heating tables (Fokker-Planck, see models/lya_heating.py) ---
    use_lya_heat = bool(ao.USE_LYA_HEATING)
    if use_lya_heat:
        lht = lya_heating.get_lya_heat_tables()
        # fold 4 pi nu_a / (c n_b (1+zp)) * 2/(3 k_B) into the dE tables
        # (reference Ndot_alpha_* and eps_Lya_*, SpinTemperatureBox.c:1283-1293)
        e_norm = (
            4.0 * np.pi * physconst.nu_Ly_alpha
            / (physconst.c_cms * nb_zp * (1.0 + zp))
            * 2.0 / (3.0 * physconst.k_B)
        )
        lya_tbl_cont = lht.de_cont * e_norm
        lya_tbl_inj = lht.de_inj * e_norm
        gp_norm = lya_heating.gunn_peterson_coef() / hubble_zp * n_zp
        lya_cont_pref = lya_cont_pref * lya_norm
        lya_inj_pref = lya_inj_pref * lya_norm
        lya_cont_mini_pref = lya_cont_mini_pref * lya_norm
        lya_inj_mini_pref = lya_inj_mini_pref * lya_norm
    else:
        lya_tbl_cont = np.zeros((2, 2, 2))
        lya_tbl_inj = np.zeros((2, 2, 2))
        gp_norm = 0.0
        lya_cont_pref = np.zeros_like(lya_cont_pref)
        lya_inj_pref = np.zeros_like(lya_inj_pref)
        lya_cont_mini_pref = np.zeros_like(lya_cont_mini_pref)
        lya_inj_mini_pref = np.zeros_like(lya_inj_mini_pref)

    cell_R = physconst.l_factor * so.box_len / so.HII_DIM
    if _FILTER_RADIUS_MODE == "inner":
        filter_R = np.where(ladder.R_inner > 0, ladder.R_inner, ladder.R)
    elif _FILTER_RADIUS_MODE == "mid":
        filter_R = np.sqrt(np.maximum(ladder.R_inner, cell_R / 10.0) * ladder.R)
    else:
        filter_R = ladder.R
    do_filter = filter_R > cell_R

    # ---- float32 dynamic-range normalization --------------------------------
    # The folded tables/prefactors can land anywhere in ~[1e-44, 1e0]
    # depending on the astro params.  Normalize each group to peak 1.0 for
    # the float32 device code and hand the true peaks to _ts_cell_update via
    # `consts`; each accumulator is rescaled exactly once on consumption, so
    # no device quantity is a float32 denormal whatever the flush mode.
    # Groups that add into the same accumulator (the ACG and MCG prefactor
    # pairs) share one scale; the LW pair is J_21_LW's, in units of 1e-21.
    starlya_mini_f = spec["starlya_mini"] * lya_norm
    lw_f = spec["lw"] * lya_norm * physconst.h_p * 1e21
    lw_mini_f = spec["lw_mini"] * lya_norm * physconst.h_p * 1e21
    tbl_heat, s_heat = _norm_group(tbl_heat)
    tbl_ion, s_ion = _norm_group(tbl_ion)
    tbl_lya, s_lya = _norm_group(tbl_lya)
    starlya_pref, starlya_mini_f, s_star = _norm_group(starlya_pref, starlya_mini_f)
    lya_cont_pref, lya_cont_mini_pref, s_cont = _norm_group(lya_cont_pref, lya_cont_mini_pref)
    lya_inj_pref, lya_inj_mini_pref, s_inj = _norm_group(lya_inj_pref, lya_inj_mini_pref)
    lw_f, lw_mini_f, s_lw = _norm_group(lw_f, lw_mini_f)

    consts = dict(
        zp=zp, dzp=dzp, growth_zp=growth_zp, inv_growth_pf=inv_growth_pf,
        dgrowth_dzp=dgrowth_dzp, dt_dzp=dt_dzp, hubble_zp=hubble_zp, trad=trad,
        nb_zp=nb_zp, n_zp=n_zp, xc_inverse=xc_inverse,
        xa_tilde_prefactor=xa_tilde_prefactor, ts_prefactor=ts_prefactor,
        dcomp_prefactor=dcomp_prefactor, clump=ap.CLUMPING_FACTOR, fH=fH, fHe=fHe,
        no_total=no_total, nb0_total=nb0_total,
        s_heat=s_heat, s_ion=s_ion, s_lya=s_lya, s_star=s_star, s_cont=s_cont,
        s_inj=s_inj, s_lw=s_lw, gp_norm=gp_norm, dcmb_prefactor=dcmb_prefactor,
    )
    kt = heating.kappa_tables()
    kappa_knots = tuple(
        np.asarray(a, np.float64)
        for a in (kt["HH"][0], kt["HH"][1], kt["eH"][0], kt["eH"][1], kt["pH"][0], kt["pH"][1])
    )
    return dict(
        filter_R=filter_R, do_filter=do_filter, growth=ladder.growth,
        z_edge_factor=z_edge_factor, xray_r_factor=xray_r_factor,
        d_lo=d_lo, d_hi=d_hi, sfrd_tables=sfrd_tables, sfrd_tables_fc=sfrd_tables_fc,
        sfrd_caps=sfrd_caps, sfrd_cheby=sfrd_cheby, sfrd_edge=sfrd_edge,
        mean_sfrd=mean_sfrd, tbl_heat=tbl_heat, tbl_ion=tbl_ion, tbl_lya=tbl_lya,
        starlya_pref=starlya_pref, lya_cont_pref=lya_cont_pref, lya_inj_pref=lya_inj_pref,
        lya_tbl_cont=lya_tbl_cont, lya_tbl_inj=lya_tbl_inj,
        use_cheby=use_cheby, const_model=const_model, use_lya_heat=use_lya_heat,
        fstar10=sc_zp.fstar_10, consts=consts, kappa_knots=kappa_knots,
        use_minihalos=use_minihalos, mini_terms=mini_terms, mcrit_clip=mcrit_clip,
        sfrd_tables_mini=sfrd_tables_mini, mean_sfrd_mini=mean_sfrd_mini,
        starlya_mini_pref=starlya_mini_f, lya_cont_mini_pref=lya_cont_mini_pref,
        lya_inj_mini_pref=lya_inj_mini_pref, lw_pref=lw_f, lw_mini_pref=lw_mini_f,
        fstar7=sc_zp.fstar_7, lx_ratio=ap.l_x_mini / max(ap.l_x, 1e-30),
    )


def shells_from_tables(h, device):
    """The per-shell list `_ts_shell_scan` takes, from `ts_host_tables`' dict:
    scalars rounded to float32 on the host, tables as float32 tensors."""
    def f(v):
        return float(_f32(v))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    gather = not h["use_cheby"]
    shells = []
    for i in range(len(h["filter_R"])):
        shells.append(dict(
            R=f(h["filter_R"][i]),
            do_filter=bool(h["do_filter"][i]),
            growth=f(h["growth"][i]),
            zfac=f(h["z_edge_factor"][i]),
            xr_fac=f(h["xray_r_factor"][i]),
            d_lo=f(h["d_lo"][i]),
            d_hi=f(h["d_hi"][i]),
            cap=f(h["sfrd_caps"][i]),
            cheb=[f(v) for v in h["sfrd_cheby"][i]],
            cheb_edge=f(h["sfrd_edge"][i]),
            mean_sfrd=f(h["mean_sfrd"][i]),
            p_star=f(h["starlya_pref"][i]),
            p_cont=f(h["lya_cont_pref"][i]),
            p_inj=f(h["lya_inj_pref"][i]),
            table=t(h["sfrd_tables"][i]) if gather else None,
            table_fc=t(h["sfrd_tables_fc"][i]) if h["const_model"] else None,
            tbl_heat=t(h["tbl_heat"][i]),
            tbl_ion=t(h["tbl_ion"][i]),
            tbl_lya=t(h["tbl_lya"][i]),
        ))
        if h["use_minihalos"]:
            shells[-1].update(
                table_mini=t(h["sfrd_tables_mini"][i].reshape(-1)),
                mean_sfrd_mini=f(h["mean_sfrd_mini"][i]),
            )
        if h["mini_terms"]:
            shells[-1].update(
                p_star_mini=f(h["starlya_mini_pref"][i]),
                p_cont_mini=f(h["lya_cont_mini_pref"][i]),
                p_inj_mini=f(h["lya_inj_mini_pref"][i]),
                p_lw=f(h["lw_pref"][i]),
                p_lw_mini=f(h["lw_mini_pref"][i]),
            )
    return shells


def compute_spin_temperature(
    redshift: float,
    inputs: InputParameters,
    perturbed_field: PerturbedField,
    prev_state: TsBox | None = None,
    prev_redshift: float | None = None,
    initial_conditions=None,
    source_box=None,
    previous_ionized_box=None,
    mesh=None,
    *,
    device="cuda",
):
    """Compute the TsBox at `redshift`, evolving from the previous snapshot.

    Returns (ts_box, state); `state` is passed back as `prev_state`.  With
    minihalos `initial_conditions` gives the |v_cb| box (FLUCTS) and
    `previous_ionized_box` the reionization feedback.  `source_box` (an
    XraySourceBox, SOURCE_MODEL 'L-INTEGRAL') brings the Lagrangian sources:
    its filtered shells replace the density-conditioned SFRD.  With `mesh`
    (a parallel.mesh.Mesh) the fields are this rank's x-slabs, the shell
    scan takes the slab FFT and <x_e> and the turnover mean are taken over
    the ranks.  The fields are moved to `device` if they live elsewhere."""
    dev = resolve_device(device)
    gops = for_mesh(mesh)
    so = inputs.simulation_options
    ao = inputs.astro_options

    if prev_state is None or redshift >= so.Z_HEAT_MAX:
        return _init_first_ts(redshift, inputs, perturbed_field, device=dev)

    if prev_redshift is None:
        prev_redshift = (1 + redshift) * so.ZPRIME_STEP_FACTOR - 1

    prev_ts = prev_state.spin_temperature.to(dev)
    prev_tk = prev_state.kinetic_temp_neutral.to(dev)
    prev_xe = prev_state.xray_ionised_fraction.to(dev)
    density = perturbed_field.density.to(dev)

    lagrangian = source_box is not None
    source = lagr_mcrit = None
    if lagrangian:
        source = dict(sfr=source_box.filtered_sfr.to(dev), xray=source_box.filtered_xray.to(dev))
        if ao.USE_MINI_HALOS and source_box.filtered_sfr_mini is not None:
            source["sfr_mini"] = source_box.filtered_sfr_mini.to(dev)
            if source_box.filtered_sfr_lw is not None:
                # straight-line LW shells (multiple scattering + minihalos)
                source["sfr_lw"] = source_box.filtered_sfr_lw.to(dev)
                source["sfr_mini_lw"] = source_box.filtered_sfr_mini_lw.to(dev)
        if source_box.mean_log10_Mcrit_LW is not None:
            lagr_mcrit = source_box.mean_log10_Mcrit_LW.double().cpu().numpy()

    # minihalos: the per-cell log10 MCG turnover mass under LW, streaming and
    # reionization feedback, from the previous J_21_LW, the ICs' |v_cb| and
    # the previous IonizedBox's Gamma12 and z_reion
    mcrit_box = None
    if ao.USE_MINI_HALOS and not lagrangian:
        _, mcrit_box = mcrit_boxes(
            redshift, inputs, hmf.set_scaling_constants(redshift, inputs),
            previous_ionized_box, prev_state, getattr(initial_conditions, "lowres_vcb", None),
            dev, gops.local_shape(so.lowres_shape),
        )

    # the one host sync of the step: <x_e> feeds the tau_X = 1 root finds,
    # the float32 mean of the turnover box the MCG terms
    means = gops.means([prev_xe.double()] + ([mcrit_box] if mcrit_box is not None else []),
                       so.lowres_shape)
    x_e_ave, ave_mcrit = means[0], (means[1] if mcrit_box is not None else 0.0)
    h = ts_host_tables(
        redshift, inputs, float(perturbed_field.redshift), prev_redshift, x_e_ave, ave_mcrit,
        lagrangian=lagrangian, lagr_mcrit=lagr_mcrit,
        lagr_mini=source is not None and "sfr_mini" in source,
    )
    consts = {k: float(_f32(v)) for k, v in h["consts"].items()}

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    flags = dict(use_xray_heat=bool(ao.USE_X_RAY_HEATING), use_lya_heat=h["use_lya_heat"])
    mini = {}
    if mcrit_box is not None:
        mini = dict(mcrit_box=mcrit_box, mcrit_clip=float(_f32(h["mcrit_clip"])),
                    fstar7=float(_f32(h["fstar7"])), lx_ratio=float(_f32(h["lx_ratio"])))
    scan_args = (density, prev_xe, shells_from_tables(h, dev), consts["inv_growth_pf"],
                 float(_f32(h["fstar10"])))
    scan_kwargs = dict(
        shape=so.lowres_shape, box_lens=so.box_lens, heat_filter=ao.heat_filter_int,
        use_cheby=h["use_cheby"], const_model=h["const_model"], source=source, **flags, **mini,
    )
    if mesh is not None:
        from ..parallel.shardcall import sharded_kernel_call

        accs = sharded_kernel_call(mesh, _ts_shell_scan, scan_args, scan_kwargs, so.lowres_shape)
    else:
        accs = _ts_shell_scan(*scan_args, **scan_kwargs)
    del scan_args, scan_kwargs
    del mcrit_box, mini, source
    ts, tk, x_e, j_lya, j_lw = _ts_cell_update(
        density, prev_ts, prev_tk, prev_xe, accs,
        tensor(h["lya_tbl_cont"]), tensor(h["lya_tbl_inj"]), consts,
        tuple(tensor(a) for a in h["kappa_knots"]),
        use_cmb_heat=bool(ao.USE_CMB_HEATING), use_minihalos=h["mini_terms"], **flags,
    )

    box = TsBox(
        redshift=np.float32(redshift),
        spin_temperature=ts,
        xray_ionised_fraction=x_e,
        kinetic_temp_neutral=tk,
        J_21_LW=j_lw,
        J_Lya=j_lya,
    )
    return box, box


_sigma_table_cache = {}


def _get_sigma_table(inputs: InputParameters):
    key = inputs.matter_cosmo_hash
    if key not in _sigma_table_cache:
        _sigma_table_cache[key] = inputs.cosmology.build_sigma_table(m_min=1e2, m_max=1e20)
    return _sigma_table_cache[key]
