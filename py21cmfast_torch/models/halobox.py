"""HaloBox: source grids from a discrete halo catalog or from the
fixed-grid (expectation-value) source model.

Equivalent of reference HaloBox.c (ComputeHaloBox:563-880, set_fixed_grids:
297-436, get_cell_integrals:245-296) and map_mass.c (do_cic_interpolation:
19-100, move_grid_galprops:215-344, move_halo_galprops:346-470), following
py21cmfast_tpu/models/halobox.py:

 * Discrete halos (`compute_halo_grid`, SOURCE_MODEL 'CHMF-SAMPLER' and
   'DEXM-ESF'): per-halo galaxy properties from the stochastic scaling
   relations (`_halo_props_kernel`, float32 elementwise ops in the JAX
   package's order), CIC-deposited onto the lowres grid as one (P, n_cells)
   stack through `ops/cic.cic_scatter_flat`.  With USE_MINI_HALOS the
   per-cell feedback turnover grids are CIC-read at each halo.  The sources
   below SAMPLER_MIN_MASS come from the fixed-grid integrals up to that mass.
 * Fixed grids (`compute_fixed_halo_grid`, SOURCE_MODEL 'L-INTEGRAL', and
   the sub-sampler part above).  Host (numpy float64, once per snapshot):
   the conditional Nion and SFRD integrals of a cell over 400 Lagrangian
   densities, and over 24 log10 turnover masses with USE_MINI_HALOS
   (`fixed_grid_tables`).  Device (float32 tensors): a per-cell gather from
   those tables at the lowres IC density (bilinear in (log10 Mturn, delta)
   with minihalos, the turnovers coming from the feedback grids of
   `_mcrit_grids`), the source prefactors, and the velocity displacement of
   the grids from Lagrangian to Eulerian positions by a CIC scatter
   (`_displace_grids`, torch `index_add_`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._device import resolve_device
from ..cosmology.constants import physconst
from ..inputs import InputParameters
from ..ops import cic
from ..ops.gridops import for_mesh
from ..ops.grids import true_div
from ..outputs import HaloBox, PerturbedHaloCatalog
from . import hmf
from .ionization import MTURN_BOUNDS, N_MTURN_TABLE, _gather2d, _get_sigma_table, mcrit_boxes
from .perturb import _displacement_factors

__all__ = ["compute_halo_grid", "halo_properties", "compute_fixed_halo_grid"]

# the (log10 Mturn, delta) axes of the tables: ionization's Mturn axis
# (N_MTURN_TABLE points over MTURN_BOUNDS), which its `_gather2d` reads
N_MT_FIXED = N_MTURN_TABLE
N_DELTA_FIXED = 400

_f32 = np.float32


def _mcrit_grids(redshift, inputs, sc, previous_spin_temp, previous_ionized_box,
                 lowres_vcb, device="cuda", shape=None):
    """Per-cell log10 feedback turnover grids (get_log10_turnovers,
    HaloBox.c:465-517), through ionization's `_mcrit_kernel`: the previous
    TsBox's J_21_LW and IonizedBox's Gamma12 and z_reion once the heating has
    started (redshift < Z_HEAT_MAX), and the |v_cb| box under FLUCTS.
    `shape` is that of grids filled in for missing boxes (this rank's slab
    on a mesh)."""
    started = redshift < inputs.simulation_options.Z_HEAT_MAX
    vcb = lowres_vcb if inputs.matter_options.V_CB_MODEL == "FLUCTS" else None
    return mcrit_boxes(
        redshift, inputs, sc,
        previous_ionized_box if started else None,
        previous_spin_temp if started else None,
        vcb, resolve_device(device), shape,
    )


def _displace_grids(props, vel, vel_2lpt, fac_za, fac_2lpt, disp_to_cells):
    """Move per-cell property grids from Lagrangian to Eulerian positions
    (reference move_grid_galprops, map_mass.c:215-344): each cell's value is
    carried to `index + psi(cell) * factor` and CIC-deposited.  `vel` and
    `vel_2lpt` (or None) are the lowres (vx, vy, vz) displacement fields; the
    factors are float32-rounded floats."""
    shape = props[0].shape
    dev = props[0].device
    pos = []
    for a in range(3):
        d = vel[a] * fac_za
        if vel_2lpt is not None:
            d = d + vel_2lpt[a] * fac_2lpt
        view = [1, 1, 1]
        view[a] = shape[a]
        idx = torch.arange(shape[a], dtype=torch.float32, device=dev).reshape(view)
        pos.append(idx + d * disp_to_cells)
    acc = torch.zeros((len(props), props[0].numel()), dtype=torch.float32, device=dev)
    cic.cic_scatter_flat(acc, *pos, torch.stack(props), shape)
    # grids of their own: a view would keep the whole stack alive for as
    # long as any one grid is held (generate_coeval's history keeps two a node)
    return [g.reshape(shape).clone() for g in acc.unbind(0)]


def fixed_grid_tables(redshift, inputs: InputParameters, m_max: float | None = None):
    """The host part of `compute_fixed_halo_grid` (float64): the delta axis,
    the conditional Nion/SFRD tables (2D over log10 Mturn with minihalos) of
    the halos between the minimum source mass and min(m_max, cell mass),
    the mean-fix factors' global integrals over the same range and the
    source prefactors; None when the mass range is empty."""
    so = inputs.simulation_options
    ao = inputs.astro_options
    cosmo = inputs.cosmology
    sc = hmf.set_scaling_constants(redshift, inputs)
    sc_sfrd = sc.without_esc()
    sigma_table = _get_sigma_table(inputs)
    growth = float(cosmo.dicke(redshift))
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    use_mini = bool(ao.USE_MINI_HALOS)

    cell_len = so.box_len / so.HII_DIM
    m_cell = cosmo.rho_mean * cell_len**3
    m_min = hmf.minimum_source_mass(redshift, inputs)
    ln_mmin, ln_mcell = np.log(m_min), np.log(m_cell)
    ln_hi = ln_mcell if m_max is None else min(np.log(m_max), ln_mcell)
    if ln_mmin >= ln_hi:
        return None
    sigma_cell = float(sigma_table.sigma_of_lnm(ln_mcell))
    eff_hmf = hmf_int if hmf_int in (0, 1, 4) else 0
    dcrit = float(hmf.get_delta_crit(eff_hmf, sigma_cell, growth))
    d_lo, d_hi = -1.0 + 1e-6, dcrit * hmf.MAX_DELTAC_FRAC
    deltas = np.linspace(d_lo, d_hi, N_DELTA_FIXED)

    def table(mturn, consts, mini=False):
        return hmf.nion_conditional(
            sigma_table, hmf_int, growth, ln_mmin, ln_mcell, sigma_cell, deltas, mturn,
            consts, mini=mini, ln_hi=ln_hi,
            method=ao.INTEGRATION_METHOD_MINI if mini else ao.INTEGRATION_METHOD_ATOMIC,
        )

    tabs = {}
    if use_mini:
        mturns = 10.0 ** np.linspace(*MTURN_BOUNDS, N_MT_FIXED)
        tabs["nion"] = np.stack([table(m, sc) for m in mturns])
        tabs["sfrd"] = np.stack([table(m, sc_sfrd) for m in mturns])
        tabs["nion_mini"] = np.stack([table(m, sc, mini=True) for m in mturns])
        tabs["sfrd_mini"] = np.stack([table(m, sc_sfrd, mini=True) for m in mturns])
    else:
        tabs["nion"] = table(sc.mturn_a_nofb, sc)
        tabs["sfrd"] = table(sc_sfrd.mturn_a_nofb, sc_sfrd)

    # mean fix (reference mean_fix_grids:207-244): HMFs with no conditional
    # form fall back to the EPS CMF above, so the box means are rescaled to
    # the chosen HMF's unconditional integrals over the same mass range
    mean_fix = None
    if hmf_int in (hmf.HMF_WATSON, hmf.HMF_WATSON_Z, hmf.HMF_REED07, hmf.HMF_YUNG24):
        mean_fix = (
            hmf.nion_general(sigma_table, cosmo, hmf_int, redshift, ln_mmin, ln_hi,
                             sc.mturn_a_nofb, sc),
            hmf.nion_general(sigma_table, cosmo, hmf_int, redshift, ln_mmin, ln_hi,
                             sc_sfrd.mturn_a_nofb, sc_sfrd),
        )

    pref_stars = cosmo.rho_crit * cosmo.OMb * sc.fstar_10
    pref_sfr = pref_stars / sc.t_star / sc.t_h
    pref_stars_mini = cosmo.rho_crit * cosmo.OMb * sc.fstar_7
    pref_sfr_mini = pref_stars_mini / sc.t_star / sc.t_h
    prefactors = dict(
        nion=cosmo.rho_crit * cosmo.OMb * sc.fstar_10 * sc.fesc_10 * sc.pop2_ion,
        stars=pref_stars,
        sfr=pref_sfr,
        wsfr=pref_sfr * sc.fesc_10 * sc.pop2_ion,
        xray=sc.l_x * pref_sfr * physconst.s_per_yr,  # 1e38 erg/s/Mpc^3
        stars_mini=pref_stars_mini,
        sfr_mini=pref_sfr_mini,
        nion_mini=pref_stars_mini * sc.fesc_7 * sc.pop3_ion,
        wsfr_mini=pref_sfr_mini * sc.fesc_7 * sc.pop3_ion,
        xray_mini=sc.l_x_mini * pref_sfr_mini * physconst.s_per_yr,
    )
    return dict(
        growth=growth, d_lo=d_lo, d_hi=d_hi, tables=tabs, mean_fix=mean_fix,
        prefactors=prefactors, use_mini=use_mini,
        l10_mturn_a_nofb=float(np.log10(sc.mturn_a_nofb)),
        l10_mturn_m_nofb=float(np.log10(max(sc.mturn_m_nofb, 1.0))),
    )


def _gather_cells(h, delta_l, mt_a_grid, mt_m_grid, one_plus_delta: bool):
    """The per-cell table gathers at the Lagrangian density (reference
    get_cell_integrals, HaloBox.c:245-296), times (1+delta) when the grids
    stay at their Lagrangian positions.  Returns the float32 (nion, sfrd,
    nion_mini, sfrd_mini) grids; the last two are None without minihalos."""
    dev = delta_l.device
    d_lo, d_hi = h["d_lo"], h["d_hi"]
    # the JAX package's closure constants: float32 d_lo, d_hi and growth,
    # and the float32 rounding of the float64 span
    d = torch.clamp(delta_l * float(_f32(h["growth"])), float(_f32(d_lo)), float(_f32(d_hi)))
    t = (d - float(_f32(d_lo))) / float(_f32(d_hi - d_lo)) * (N_DELTA_FIXED - 1)
    # t >= 0 after the clamp of d: truncation is a floor
    i0 = torch.clamp(t.to(torch.int64), 0, N_DELTA_FIXED - 2)
    fr = t - i0
    one_p = 1.0 + d if one_plus_delta else None

    def upload(a):
        return torch.as_tensor(np.asarray(a, np.float32).reshape(-1), device=dev)

    def finish(v):
        return v * one_p if one_p is not None else v

    tabs = h["tables"]
    if not h["use_mini"]:
        out = []
        for name in ("nion", "sfrd"):
            tab = upload(tabs[name])
            out.append(finish(tab[i0] * (1 - fr) + tab[i0 + 1] * fr))
        return out[0], out[1], None, None
    return tuple(
        finish(_gather2d(upload(tabs[name]), N_DELTA_FIXED, mt, i0, fr))
        for name, mt in (("nion", mt_a_grid), ("sfrd", mt_a_grid),
                         ("nion_mini", mt_m_grid), ("sfrd_mini", mt_m_grid))
    )


def compute_fixed_halo_grid(
    redshift: float,
    inputs: InputParameters,
    lagrangian_delta,
    m_max: float | None = None,
    mt_a_grid=None,
    mt_m_grid=None,
    ics=None,
    mesh=None,
    *,
    device="cuda",
) -> HaloBox | None:
    """Deterministic (expectation-value) source grids (reference
    set_fixed_grids:297-436) from the lowres IC density `lagrangian_delta`
    (z=0 normalization): of every halo below the cell mass for SOURCE_MODEL
    'L-INTEGRAL' (m_max None), or of the halos below m_max =
    SAMPLER_MIN_MASS, too small for the halo sampler, whose grids
    `compute_halo_grid` adds to the sampled deposit (HaloBox.c:624-640).

    With USE_MINI_HALOS, `mt_a_grid`/`mt_m_grid` (log10 per-cell turnovers,
    `_mcrit_grids`; the no-feedback constants when None) select the table row
    by a bilinear (Mturn, delta) gather, and the MCG integrals fill
    halo_sfr_mini/halo_stars_mini.  When `ics` carries lowres displacement
    fields the grids are velocity-displaced to Eulerian positions (bare cell
    integrals; the CIC deposit makes the pile-up), otherwise they are scaled
    by (1+delta).  Returns None when the mass range is empty (the minimum
    source mass above min(m_max, cell mass)).  With `mesh` (a
    parallel.mesh.Mesh) the grids are this rank's x-slabs: the mean fix and
    the turnover means are taken over the ranks and the displacement
    deposits across the slab borders."""
    dev = resolve_device(device)
    gops = for_mesh(mesh)
    so = inputs.simulation_options
    h = fixed_grid_tables(redshift, inputs, m_max)
    if h is None:
        return None
    use_mini = h["use_mini"]
    lshape = gops.local_shape(so.lowres_shape)
    delta_l = lagrangian_delta.to(dev)
    if use_mini:
        if mt_a_grid is None:
            mt_a_grid = torch.full(lshape, float(_f32(h["l10_mturn_a_nofb"])),
                                   dtype=torch.float32, device=dev)
        if mt_m_grid is None:
            mt_m_grid = torch.full(lshape, float(_f32(h["l10_mturn_m_nofb"])),
                                   dtype=torch.float32, device=dev)
        mt_a_grid, mt_m_grid = mt_a_grid.to(dev), mt_m_grid.to(dev)

    will_displace = ics is not None and ics.vx is not None and tuple(ics.vx.shape) == lshape
    nion_rel, sfrd_rel, nion_rel_mini, sfrd_rel_mini = _gather_cells(
        h, delta_l, mt_a_grid, mt_m_grid, one_plus_delta=not will_displace)

    if h["mean_fix"] is not None:
        nion_u, sfrd_u = h["mean_fix"]
        nion_mean, sfrd_mean = gops.means([nion_rel, sfrd_rel], so.lowres_shape)
        if nion_mean > 0:
            nion_rel = nion_rel * float(_f32(nion_u / nion_mean))
        if sfrd_mean > 0:
            sfrd_rel = sfrd_rel * float(_f32(sfrd_u / sfrd_mean))

    p = {k: float(_f32(v)) for k, v in h["prefactors"].items()}
    n_ion = nion_rel * p["nion"]
    halo_sfr = sfrd_rel * p["sfr"]
    whalo_sfr = nion_rel * p["wsfr"]
    halo_xray = sfrd_rel * p["xray"]
    halo_stars = sfrd_rel * p["stars"]
    halo_sfr_mini = halo_stars_mini = None
    if use_mini:
        n_ion = n_ion + nion_rel_mini * p["nion_mini"]
        whalo_sfr = whalo_sfr + nion_rel_mini * p["wsfr_mini"]
        halo_xray = halo_xray + sfrd_rel_mini * p["xray_mini"]
        halo_sfr_mini = sfrd_rel_mini * p["sfr_mini"]
        halo_stars_mini = sfrd_rel_mini * p["stars_mini"]
    del nion_rel, sfrd_rel, nion_rel_mini, sfrd_rel_mini

    if will_displace:
        _, _, fac_za, fac_2lpt = _displacement_factors(inputs, redshift)
        use_2lpt = (
            inputs.matter_options.PERTURB_ALGORITHM == "2LPT" and ics.vx_2LPT is not None
        )
        props = [n_ion, halo_sfr, whalo_sfr, halo_xray, halo_stars]
        if use_mini:
            props += [halo_sfr_mini, halo_stars_mini]
        displace = _displace_grids
        if gops.sharded:
            from ..parallel.perturb import displace_grids_slab

            displace = functools.partial(displace_grids_slab, mesh)
        moved = displace(
            props,
            tuple(v.to(dev) for v in (ics.vx, ics.vy, ics.vz)),
            tuple(v.to(dev) for v in (ics.vx_2LPT, ics.vy_2LPT, ics.vz_2LPT)) if use_2lpt else None,
            float(_f32(fac_za)), float(_f32(fac_2lpt)), float(_f32(so.HII_DIM / so.box_len)),
        )
        del props
        n_ion, halo_sfr, whalo_sfr, halo_xray, halo_stars = moved[:5]
        if use_mini:
            halo_sfr_mini, halo_stars_mini = moved[5:]

    # box-level turnover means of the feedback grids (get_log10_turnovers,
    # HaloBox.c:511-517), one float32 mean each; the no-feedback constants
    # without minihalos
    if use_mini:
        l10_a, l10_m = gops.means([mt_a_grid, mt_m_grid], so.lowres_shape)
    else:
        l10_a, l10_m = h["l10_mturn_a_nofb"], h["l10_mturn_m_nofb"]
    return HaloBox(
        redshift=np.float32(redshift),
        n_ion=n_ion,
        halo_sfr=halo_sfr,
        whalo_sfr=whalo_sfr,
        halo_xray=halo_xray,
        halo_stars=halo_stars,
        halo_sfr_mini=halo_sfr_mini,
        halo_stars_mini=halo_stars_mini,
        log10_Mcrit_ACG_ave=np.float32(l10_a),
        log10_Mcrit_MCG_ave=np.float32(l10_m),
    )



# ---------------------------------------------------------------------------
# Discrete halos


def _scaling_consts_dict(sc, cosmo, redshift, ao):
    """The scaling relations' constants as numpy float32 scalars, as the JAX
    package hands them to its kernel; scalar-only expressions of them are
    then evaluated in float32 as there."""
    return {
        k: np.float32(v)
        for k, v in dict(
            fstar_10=sc.fstar_10, alpha_star=sc.alpha_star, sigma_star=sc.sigma_star,
            alpha_upper=sc.alpha_upper, pivot_upper=sc.pivot_upper,
            upper_ratio=sc.upper_pivot_ratio, t_star=sc.t_star, t_h=sc.t_h,
            sigma_sfr_lim=sc.sigma_sfr_lim, sigma_sfr_idx=sc.sigma_sfr_idx,
            l_x=sc.l_x, l_x_mini=sc.l_x_mini, sigma_xray=sc.sigma_xray,
            fesc_10=sc.fesc_10, alpha_esc=sc.alpha_esc, fesc_7=sc.fesc_7,
            pop2_ion=sc.pop2_ion, pop3_ion=sc.pop3_ion,
            fstar_7=sc.fstar_7, alpha_star_mini=sc.alpha_star_mini,
            acg_thresh=sc.acg_thresh, mturn_a=sc.mturn_a_nofb,
            mturn_m=sc.mturn_m_nofb,
            baryon_ratio=cosmo.OMb / cosmo.OMm, redshift=redshift,
            median_flag=1.0 if ao.HALO_SCALING_RELATIONS_MEDIAN else 0.0,
        ).items()
    }


_LN10_F32 = float(np.log(np.float32(10.0)))
_S_PER_YR = float(np.float32(physconst.s_per_yr))


def _halo_props_kernel(masses, star_rng, sfr_rng, xray_rng, mturn_a, mturn_m, c, *,
                       use_upper, use_mini, use_metal_lx=True):
    """The stochastic scaling relations of every halo (set_halo_properties,
    scaling_relations.c:326-501), float32 elementwise ops in the JAX
    package's order; `mturn_a`/`mturn_m` are per-halo turnover masses
    (linear Msun).  Returns a dict of per-halo stellar, sfr, n_ion, wsfr,
    xray38 (1e38 erg/s), stellar_mini and sfr_mini."""
    f = {k: float(v) for k, v in c.items()}
    m = masses
    median = c["median_flag"] > 0
    stoc_adj = 0.0 if median else float(c["sigma_star"] ** 2 / np.float32(2.0))
    # ACG stellar fraction: double power law with the upper turnover, or one
    if use_upper:
        mp = m / f["pivot_upper"]
        mu_fstar = float(c["fstar_10"] * c["upper_ratio"]) / (
            mp ** float(-c["alpha_star"]) + mp ** float(-c["alpha_upper"]))
    else:
        mu_fstar = f["fstar_10"] * (m / 1e10) ** f["alpha_star"]
    f_sample = mu_fstar * torch.exp(-mturn_a / m + star_rng * f["sigma_star"] - stoc_adj)
    stellar = torch.clamp(f_sample, max=1.0) * m * f["baryon_ratio"]

    if use_mini:
        mu_fstar_mini = f["fstar_7"] * (m / 1e7) ** f["alpha_star_mini"]
        f_mini = mu_fstar_mini * torch.exp(
            -mturn_m / m - m / f["acg_thresh"] + star_rng * f["sigma_star"] - stoc_adj)
        stellar_mini = torch.clamp(f_mini, max=1.0) * m * f["baryon_ratio"]
    else:
        stellar_mini = torch.zeros_like(stellar)

    # SFR with a lognormal scatter that widens with the (total) stellar mass
    stellar_tot = stellar + stellar_mini
    if c["sigma_sfr_lim"] > 0:
        sigma_sfr = torch.clamp(
            f["sigma_sfr_idx"] * (torch.log(torch.clamp(stellar_tot, min=1e-30) / 1e10) / _LN10_F32)
            + f["sigma_sfr_lim"], min=f["sigma_sfr_lim"])
    else:
        sigma_sfr = torch.zeros_like(stellar)
    stoc_adj_sfr = 0.0 if median else sigma_sfr ** 2 / 2.0
    sfr_scatter = torch.exp(sfr_rng * sigma_sfr - stoc_adj_sfr)
    inv_tstar_th = float(np.float32(1.0) / (c["t_star"] * c["t_h"]))
    sfr = stellar * inv_tstar_th * sfr_scatter  # Msun/s
    sfr_mini = stellar_mini * inv_tstar_th * sfr_scatter

    # L_X/SFR: a double power law in metallicity (Eq. 14-15 of 2504.17254)
    # only with USE_UPPER_STELLAR_TURNOVER; the constant L_X otherwise
    # (get_lx_on_sfr, scaling_relations.c:315-324)
    if use_metal_lx:
        sfr_tot = sfr + sfr_mini
        z_scaling = float(np.float32(10.0) ** (np.float32(-0.056) * c["redshift"] + np.float32(0.064)))
        m0 = 1.28825e10 * torch.clamp(sfr_tot * _S_PER_YR, min=1e-30) ** 0.56
        stellar_term = (1.0 + (torch.clamp(stellar_tot, min=1e-30) / m0) ** -2.1) ** -0.148
        metallicity = 1.23 * stellar_term * z_scaling

        def lx_on_sfr(lnorm):
            return float(lnorm * np.float32(2.0)) / ((metallicity / 0.05) ** 0.64 + 1.0)
    else:
        def lx_on_sfr(lnorm):
            return float(lnorm)

    mu_x = lx_on_sfr(c["l_x"]) * sfr * _S_PER_YR
    if use_mini:
        mu_x = mu_x + lx_on_sfr(c["l_x_mini"]) * sfr_mini * _S_PER_YR
    stoc_adj_x = 0.0 if median else float(c["sigma_xray"] ** 2 / np.float32(2.0))
    xray38 = mu_x * torch.exp(xray_rng * f["sigma_xray"] - stoc_adj_x)

    # escape fractions (no scatter, as the reference)
    fesc = torch.clamp(f["fesc_10"] * (m / 1e10) ** f["alpha_esc"], max=1.0)
    n_ion = stellar * f["pop2_ion"] * fesc
    wsfr = sfr * f["pop2_ion"] * fesc
    if use_mini:
        fesc_mini = torch.clamp(f["fesc_7"] * (m / 1e7) ** f["alpha_esc"], max=1.0)
        n_ion = n_ion + stellar_mini * f["pop3_ion"] * fesc_mini
        wsfr = wsfr + sfr_mini * f["pop3_ion"] * fesc_mini
    return dict(stellar=stellar, sfr=sfr, n_ion=n_ion, wsfr=wsfr, xray38=xray38,
                stellar_mini=stellar_mini, sfr_mini=sfr_mini)


def _cic_deposit(masses, pos_cells, props, shape):
    """CIC scatter of per-halo properties onto the grid (map_mass.c:19-100;
    positions in cell units, cell 0 centred at the origin): one (P, n_cells)
    stack, one `index_add_` a corner.  Halos with mass <= 0 weigh nothing.
    Returns P grids of their own."""
    dev = masses.device
    acc = torch.zeros((len(props), int(np.prod(shape))), dtype=torch.float32, device=dev)
    weights = torch.where(masses > 0, torch.stack(props), 0.0)
    cic.cic_scatter_flat(acc, pos_cells[:, 0], pos_cells[:, 1], pos_cells[:, 2], weights, shape)
    del weights
    return [g.reshape(shape) for g in acc.unbind(0)]


def _halo_turnovers(redshift, inputs, sc, n_like, pos_cells, previous_spin_temp,
                    previous_ionized_box, lowres_vcb, dev):
    """Per-halo ACG/MCG turnover masses and the log10 box means.  With
    minihalos the feedback grids (`_mcrit_grids`) are CIC-read at each halo
    (move_halo_galprops, map_mass.c:412-414) and their means are one float32
    mean each; otherwise the no-feedback constants."""
    if inputs.astro_options.USE_MINI_HALOS:
        mt_a_grid, mt_m_grid = _mcrit_grids(redshift, inputs, sc, previous_spin_temp,
                                            previous_ionized_box, lowres_vcb, dev)
        l10_a, l10_m = torch.stack([mt_a_grid.mean(), mt_m_grid.mean()]).tolist()
        px, py, pz = pos_cells.unbind(1)
        halo_mt_a = 10.0 ** cic.cic_read(mt_a_grid, px, py, pz)
        halo_mt_m = 10.0 ** cic.cic_read(mt_m_grid, px, py, pz)
        return halo_mt_a, halo_mt_m, l10_a, l10_m, (mt_a_grid, mt_m_grid)
    l10_a = float(np.log10(sc.mturn_a_nofb))
    l10_m = float(np.log10(max(sc.mturn_m_nofb, 1.0)))
    halo_mt_a = torch.full_like(n_like, float(_f32(sc.mturn_a_nofb)))
    halo_mt_m = torch.full_like(n_like, float(_f32(sc.mturn_m_nofb)))
    return halo_mt_a, halo_mt_m, l10_a, l10_m, (None, None)


def _props_flags(sc, ao):
    return dict(
        use_upper=bool(ao.USE_UPPER_STELLAR_TURNOVER) and sc.alpha_star > sc.alpha_upper,
        use_mini=bool(ao.USE_MINI_HALOS),
        use_metal_lx=bool(ao.USE_UPPER_STELLAR_TURNOVER),
    )


def compute_halo_grid(
    redshift: float,
    inputs: InputParameters,
    pt_halos: PerturbedHaloCatalog,
    previous_spin_temp=None,
    previous_ionized_box=None,
    lagrangian_delta=None,
    lowres_vcb=None,
    ics=None,
    *,
    device="cuda",
) -> HaloBox:
    """Grid a perturbed halo catalog into source fields (reference
    ComputeHaloBox:563).

    With USE_MINI_HALOS, `previous_spin_temp` (J_21_LW), `previous_ionized_box`
    (Gamma12, z_reion) and `lowres_vcb` feed the per-cell feedback turnover
    grids, which are CIC-read at each halo and set its ACG and MCG
    properties.  When `lagrangian_delta` (the lowres IC density) is given,
    the expected sources of the halos below SAMPLER_MIN_MASS are added from
    the conditional integrals (`compute_fixed_halo_grid` up to that mass,
    displaced by `ics`; HaloBox.c:626-640).  An empty catalog gives zero
    halo grids."""
    dev = resolve_device(device)
    so = inputs.simulation_options
    ao = inputs.astro_options
    sc = hmf.set_scaling_constants(redshift, inputs)
    shape = so.lowres_shape
    use_mini = bool(ao.USE_MINI_HALOS)

    masses = pt_halos.halo_masses.to(dev)
    pos_cells = true_div(pt_halos.halo_coords.to(dev), so.box_len / so.HII_DIM)
    halo_mt_a, halo_mt_m, l10_a, l10_m, mt_grids = _halo_turnovers(
        redshift, inputs, sc, masses, pos_cells, previous_spin_temp, previous_ionized_box,
        lowres_vcb, dev)
    props = _halo_props_kernel(
        masses, pt_halos.star_rng.to(dev), pt_halos.sfr_rng.to(dev), pt_halos.xray_rng.to(dev),
        halo_mt_a, halo_mt_m, _scaling_consts_dict(sc, inputs.cosmology, redshift, ao),
        **_props_flags(sc, ao))
    del halo_mt_a, halo_mt_m
    dep = [props["n_ion"], props["sfr"], props["wsfr"], props["xray38"], props["stellar"],
           torch.ones_like(masses)]
    if use_mini:
        dep += [props["sfr_mini"], props["stellar_mini"]]
    del props
    grids = _cic_deposit(masses, pos_cells, dep, shape)
    del dep
    inv_vol = float(_f32(1.0 / (so.box_len / so.HII_DIM) ** 3))
    dens = [g * inv_vol for i, g in enumerate(grids) if i != 5]
    fields = dict(zip(("n_ion", "halo_sfr", "whalo_sfr", "halo_xray", "halo_stars",
                       "halo_sfr_mini", "halo_stars_mini"), dens))
    count = grids[5].clone()
    del grids, dens

    if lagrangian_delta is not None:
        sub = compute_fixed_halo_grid(
            redshift, inputs, lagrangian_delta, m_max=so.SAMPLER_MIN_MASS,
            mt_a_grid=mt_grids[0], mt_m_grid=mt_grids[1], ics=ics, device=dev)
        if sub is not None:
            for name in list(fields):
                extra = getattr(sub, name)
                if extra is not None:
                    fields[name] = fields[name] + extra
            del sub
    return HaloBox(
        redshift=np.float32(redshift),
        count=count,
        halo_sfr_mini=fields.pop("halo_sfr_mini", None),
        halo_stars_mini=fields.pop("halo_stars_mini", None),
        log10_Mcrit_ACG_ave=np.float32(l10_a),
        log10_Mcrit_MCG_ave=np.float32(l10_m),
        **fields,
    )


def halo_properties(redshift, inputs, catalog, *, device="cuda"):
    """Per-halo (stellar, sfr, n_ion, wsfr, xray38) with the no-feedback
    turnovers (reference convert_halo_props:781)."""
    dev = resolve_device(device)
    sc = hmf.set_scaling_constants(redshift, inputs)
    ao = inputs.astro_options
    masses = catalog.halo_masses.to(dev)
    props = _halo_props_kernel(
        masses, catalog.star_rng.to(dev), catalog.sfr_rng.to(dev), catalog.xray_rng.to(dev),
        torch.full_like(masses, float(_f32(sc.mturn_a_nofb))),
        torch.full_like(masses, float(_f32(sc.mturn_m_nofb))),
        _scaling_consts_dict(sc, inputs.cosmology, redshift, ao), **_props_flags(sc, ao))
    return props["stellar"], props["sfr"], props["n_ion"], props["wsfr"], props["xray38"]
