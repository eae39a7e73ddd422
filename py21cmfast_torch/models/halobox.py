"""HaloBox of the deterministic (fixed-grid) source model, SOURCE_MODEL='L-INTEGRAL'.

Equivalent of reference HaloBox.c (set_fixed_grids:297-436, get_cell_integrals
:245-296) and map_mass.c (move_grid_galprops:215-344), following the
fixed-grid part of py21cmfast_tpu/models/halobox.py:

 * Host (numpy float64, once per snapshot): the conditional Nion and SFRD
   integrals of a cell over 400 Lagrangian densities, and over 24 log10
   turnover masses with USE_MINI_HALOS (`fixed_grid_tables`).
 * Device (float32 tensors): a per-cell gather from those tables at the
   lowres IC density (bilinear in (log10 Mturn, delta) with minihalos, the
   turnovers coming from the feedback grids of `_mcrit_grids`), the source
   prefactors, and the velocity displacement of the grids from Lagrangian to
   Eulerian positions by a CIC scatter (`_displace_grids`, torch
   `index_add_`).

The discrete-halo part (halo properties, the halo CIC and its read) comes with
the halo sampler.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..cosmology.constants import physconst
from ..inputs import InputParameters
from ..ops import cic
from ..outputs import HaloBox
from . import hmf
from .ionization import MTURN_BOUNDS, N_MTURN_TABLE, _gather2d, _get_sigma_table, mcrit_boxes
from .perturb import _displacement_factors

__all__ = ["compute_fixed_halo_grid"]

# the (log10 Mturn, delta) axes of the tables: ionization's Mturn axis
# (N_MTURN_TABLE points over MTURN_BOUNDS), which its `_gather2d` reads
N_MT_FIXED = N_MTURN_TABLE
N_DELTA_FIXED = 400

_f32 = np.float32


def _mcrit_grids(redshift, inputs, sc, previous_spin_temp, previous_ionized_box,
                 lowres_vcb, device="cuda"):
    """Per-cell log10 feedback turnover grids (get_log10_turnovers,
    HaloBox.c:465-517), through ionization's `_mcrit_kernel`: the previous
    TsBox's J_21_LW and IonizedBox's Gamma12 and z_reion once the heating has
    started (redshift < Z_HEAT_MAX), and the |v_cb| box under FLUCTS."""
    started = redshift < inputs.simulation_options.Z_HEAT_MAX
    vcb = lowres_vcb if inputs.matter_options.V_CB_MODEL == "FLUCTS" else None
    return mcrit_boxes(
        redshift, inputs, sc,
        previous_ionized_box if started else None,
        previous_spin_temp if started else None,
        vcb, resolve_device(device),
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


def fixed_grid_tables(redshift, inputs: InputParameters):
    """The host part of `compute_fixed_halo_grid` (float64): the delta axis,
    the conditional Nion/SFRD tables (2D over log10 Mturn with minihalos),
    the mean-fix factors' global integrals and the source prefactors; None
    when the mass range is empty."""
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
    if ln_mmin >= ln_mcell:
        return None
    sigma_cell = float(sigma_table.sigma_of_lnm(ln_mcell))
    eff_hmf = hmf_int if hmf_int in (0, 1, 4) else 0
    dcrit = float(hmf.get_delta_crit(eff_hmf, sigma_cell, growth))
    d_lo, d_hi = -1.0 + 1e-6, dcrit * hmf.MAX_DELTAC_FRAC
    deltas = np.linspace(d_lo, d_hi, N_DELTA_FIXED)

    def table(mturn, consts, mini=False):
        return hmf.nion_conditional(
            sigma_table, hmf_int, growth, ln_mmin, ln_mcell, sigma_cell, deltas, mturn,
            consts, mini=mini,
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
            hmf.nion_general(sigma_table, cosmo, hmf_int, redshift, ln_mmin, ln_mcell,
                             sc.mturn_a_nofb, sc),
            hmf.nion_general(sigma_table, cosmo, hmf_int, redshift, ln_mmin, ln_mcell,
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
    mt_a_grid=None,
    mt_m_grid=None,
    ics=None,
    *,
    device="cuda",
) -> HaloBox | None:
    """Deterministic (expectation-value) source grids of SOURCE_MODEL
    'L-INTEGRAL' (reference set_fixed_grids:297-436) from the lowres IC
    density `lagrangian_delta` (z=0 normalization).

    With USE_MINI_HALOS, `mt_a_grid`/`mt_m_grid` (log10 per-cell turnovers,
    `_mcrit_grids`; the no-feedback constants when None) select the table row
    by a bilinear (Mturn, delta) gather, and the MCG integrals fill
    halo_sfr_mini/halo_stars_mini.  When `ics` carries lowres displacement
    fields the grids are velocity-displaced to Eulerian positions (bare cell
    integrals; the CIC deposit makes the pile-up), otherwise they are scaled
    by (1+delta).  Returns None when the mass range is empty (the minimum
    source mass above a cell's mass)."""
    dev = resolve_device(device)
    so = inputs.simulation_options
    h = fixed_grid_tables(redshift, inputs)
    if h is None:
        return None
    use_mini = h["use_mini"]
    delta_l = lagrangian_delta.to(dev)
    if use_mini:
        if mt_a_grid is None:
            mt_a_grid = torch.full(so.lowres_shape, float(_f32(h["l10_mturn_a_nofb"])),
                                   dtype=torch.float32, device=dev)
        if mt_m_grid is None:
            mt_m_grid = torch.full(so.lowres_shape, float(_f32(h["l10_mturn_m_nofb"])),
                                   dtype=torch.float32, device=dev)
        mt_a_grid, mt_m_grid = mt_a_grid.to(dev), mt_m_grid.to(dev)

    will_displace = (
        ics is not None and ics.vx is not None and tuple(ics.vx.shape) == so.lowres_shape
    )
    nion_rel, sfrd_rel, nion_rel_mini, sfrd_rel_mini = _gather_cells(
        h, delta_l, mt_a_grid, mt_m_grid, one_plus_delta=not will_displace)

    if h["mean_fix"] is not None:
        nion_u, sfrd_u = h["mean_fix"]
        nion_mean, sfrd_mean = torch.stack([nion_rel.mean(), sfrd_rel.mean()]).tolist()
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
        moved = _displace_grids(
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
        l10_a, l10_m = torch.stack([mt_a_grid.mean(), mt_m_grid.mean()]).tolist()
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

