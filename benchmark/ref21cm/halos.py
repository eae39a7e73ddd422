"""The reference's halo path, written for the benchmark from the equations
in float64: a halo catalog moved to its Eulerian positions, gridded into a
HaloBox, and the HaloBoxes of past nodes filtered into the XraySourceBox's
shells, as the frozen spin temperature's Lagrangian branch and the frozen
ionization's HaloBox branch read them.

The catalogs are the compared cone's own (`harness/reference.py`): the halo
sampler is random, so its catalogs are the cone's random input, as a model's
seeded weights are, and `gate.py` holds them to the conditional mass
function.  Everything after a catalog is computed here again.  The stages
compute in float64 and hand their grids on in float32, the precision the
configuration states for its fields.

- `perturb_catalog`: each halo's Lagrangian position moved by the
  displacement of the reference's own ICs, read cloud-in-cell at the halo
  on the lowres grid: D(z) - D(z_init) of the first order, and the second
  order's -3/7 (D^2 - D_init^2) subtracted, as `plain.perturb` moves its
  particles; wrapped into the box.
- `halo_box`: each halo's stellar mass, SFR, ionizing emissivity and X-ray
  luminosity from the scaling relations (a double power law in mass with
  the upper stellar turnover where USE_UPPER_STELLAR_TURNOVER turns it on,
  the lower turnover exp(-M_turn / M), the catalog's lognormal scatters
  `star_rng`, `sfr_rng`, `xray_rng` with their means kept, L_X/SFR by
  metallicity under the upper turnover), deposited cloud-in-cell onto the
  lowres grid as densities; then the sources below SAMPLER_MIN_MASS, each
  lowres cell's conditional integrals from the minimum source mass to
  SAMPLER_MIN_MASS at its Lagrangian density (the frozen `models/hmf.py`,
  on a table of densities), carried with the cell's displacement and
  deposited cloud-in-cell.
- `xray_source_box`: for each shell of the spin temperature's ladder, the
  SFR and X-ray grids at the shell's emission redshift (the comoving
  distance inverted at the shell's edges; linear in z between the two
  nodes that bracket it, none above the oldest node or Z_HEAT_MAX), filtered
  by the annulus between the shell's radii (the innermost shell unfiltered)
  and clipped at 0.

Departures from the program and from upstream 21cmFAST:
- the sources below SAMPLER_MIN_MASS move with the same displacement as
  particles and halos, the second order subtracted; the program (as the JAX
  package) adds the second-order term when it moves those grids;
- the per-halo relations and the deposit are float64, where the program
  forms them in float32;
- the emission redshifts take the distance of the spin temperature's
  ladder, without radiation, summed on 20001 redshifts, where the program
  sums the same on 8192 and upstream inverts astropy's distance, radiation
  included;
- no minihalos and no Lyman-alpha multiple scattering (`plain._check`
  refuses them with a sampler).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import plain
from .cosmology.constants import physconst
from .models import hmf
from .models.ionization import _get_sigma_table
from .models.spintemp import setup_z_edges
from .outputs import HaloBox, XraySourceBox

F64 = torch.float64
N_DELTA = 400  # densities of the sub-sampler table
N_ZPP = 20001  # redshifts of the emission-redshift inversion
# the HMFs without a conditional form, whose sub-sampler grids are
# rescaled to their own box mean
MEAN_FIXED = (hmf.HMF_WATSON, hmf.HMF_WATSON_Z, hmf.HMF_REED07, hmf.HMF_YUNG24)


def _displacement_fields(inputs, ics: plain.ICs, z):
    """The lowres displacement fields (x, y, z) at `z` in Mpc, float64: the
    first order times D(z) - D(z_init), the second order's
    -3/7 (D^2 - D_init^2) subtracted."""
    cosmo = inputs.cosmology
    D = float(cosmo.dicke(z))
    D0 = float(cosmo.dicke(inputs.simulation_options.INITIAL_REDSHIFT))
    out = []
    for v, v2 in zip((ics.vx, ics.vy, ics.vz), (ics.vx_2LPT, ics.vy_2LPT, ics.vz_2LPT)):
        d = v.double() * (D - D0)
        if v2 is not None:
            d = d - v2.double() * ((-3.0 / 7.0) * (D * D - D0 * D0))
        out.append(d)
    return out


def _corners(p, n):
    lo = torch.floor(p)
    f = p - lo
    lo = torch.remainder(lo.long(), n)
    return ((lo, 1.0 - f), (torch.remainder(lo + 1, n), f))


def _cic_read(field, px, py, pz):
    n = field.shape[0]
    out = torch.zeros_like(px)
    for ix, wx in _corners(px, n):
        for iy, wy in _corners(py, n):
            for iz, wz in _corners(pz, n):
                out += field[ix, iy, iz] * wx * wy * wz
    return out


def _cic_deposit(n, px, py, pz, values):
    """Each of `values` (P, m) deposited cloud-in-cell (periodic) at the
    lowres-cell positions; (P, n, n, n) float64."""
    acc = torch.zeros((values.shape[0], n**3), dtype=F64, device=values.device)
    for ix, wx in _corners(px, n):
        for iy, wy in _corners(py, n):
            for iz, wz in _corners(pz, n):
                acc.index_add_(1, (ix * n + iy) * n + iz, values * (wx * wy * wz))
    return acc.reshape(-1, n, n, n)


def perturb_catalog(z, inputs, ics: plain.ICs, catalog):
    """The catalog's halos at their Eulerian positions at `z`: (n, 3) float64
    Mpc on the ICs' device."""
    so = inputs.simulation_options
    n, L = so.HII_DIM, float(so.box_len)
    pos = catalog.halo_coords.to(ics.vx.device, F64)
    p = (pos * (n / L)).unbind(1)
    disp = torch.stack([_cic_read(d, *p) for d in _displacement_fields(inputs, ics, z)], dim=1)
    return torch.remainder(pos + disp, L)


def halo_properties(z, inputs, catalog, dev):
    """Per halo (float64): stellar mass, SFR (Msun/s), ionizing emissivity
    (stellar mass times POP2_ION and the escape fraction), the same of the
    SFR, and the X-ray luminosity (1e38 erg/s)."""
    ao = inputs.astro_options
    sc = hmf.set_scaling_constants(z, inputs)
    cosmo = inputs.cosmology
    m = catalog.halo_masses.to(dev, F64)
    star_rng, sfr_rng, xray_rng = (getattr(catalog, k).to(dev, F64)
                                   for k in ("star_rng", "sfr_rng", "xray_rng"))
    median = bool(ao.HALO_SCALING_RELATIONS_MEDIAN)

    def kept_mean(sigma):
        return 0.0 if median else sigma * sigma / 2.0

    if ao.USE_UPPER_STELLAR_TURNOVER and sc.alpha_star > sc.alpha_upper:
        mp = m / sc.pivot_upper
        f_mean = sc.fstar_10 * sc.upper_pivot_ratio / (mp**-sc.alpha_star + mp**-sc.alpha_upper)
    else:
        f_mean = sc.fstar_10 * (m / 1e10) ** sc.alpha_star
    f_star = f_mean * torch.exp(-sc.mturn_a_nofb / m + star_rng * sc.sigma_star
                                - kept_mean(sc.sigma_star))
    stellar = torch.clamp(f_star, max=1.0) * m * (cosmo.OMb / cosmo.OMm)

    if sc.sigma_sfr_lim > 0:
        log_star = torch.log10(torch.clamp(stellar, min=1e-30) / 1e10)
        sigma_sfr = torch.clamp(sc.sigma_sfr_idx * log_star + sc.sigma_sfr_lim,
                                min=sc.sigma_sfr_lim)
    else:
        sigma_sfr = torch.zeros_like(m)
    sfr = stellar / (sc.t_star * sc.t_h) * torch.exp(sfr_rng * sigma_sfr - kept_mean(sigma_sfr))

    lx_on_sfr = sc.l_x
    if ao.USE_UPPER_STELLAR_TURNOVER:
        # L_X/SFR falls with metallicity (Eq. 14-15 of arXiv:2504.17254)
        m0 = 1.28825e10 * torch.clamp(sfr * physconst.s_per_yr, min=1e-30) ** 0.56
        metallicity = (1.23 * (1.0 + (torch.clamp(stellar, min=1e-30) / m0) ** -2.1) ** -0.148
                       * 10.0 ** (-0.056 * z + 0.064))
        lx_on_sfr = 2.0 * sc.l_x / ((metallicity / 0.05) ** 0.64 + 1.0)
    xray = (lx_on_sfr * sfr * physconst.s_per_yr
            * torch.exp(xray_rng * sc.sigma_xray - kept_mean(sc.sigma_xray)))

    fesc = torch.clamp(sc.fesc_10 * (m / 1e10) ** sc.alpha_esc, max=1.0)
    return dict(stellar=stellar, sfr=sfr, n_ion=stellar * sc.pop2_ion * fesc,
                wsfr=sfr * sc.pop2_ion * fesc, xray=xray)


def _below_sampler(z, inputs, ics: plain.ICs):
    """The sources of the halos below SAMPLER_MIN_MASS, per lowres cell
    (float64 n_ion, halo_sfr, whalo_sfr, halo_xray densities), or None where
    the minimum source mass lies above that mass or the cell mass."""
    so, ao = inputs.simulation_options, inputs.astro_options
    cosmo = inputs.cosmology
    n, L = so.HII_DIM, float(so.box_len)
    m_cell = cosmo.rho_mean * (L / n) ** 3
    ln_lo = math.log(hmf.minimum_source_mass(z, inputs))
    ln_hi = min(math.log(so.SAMPLER_MIN_MASS), math.log(m_cell))
    if ln_lo >= ln_hi:
        return None
    table = _get_sigma_table(inputs)
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    growth = float(cosmo.dicke(z))
    sigma_cell = float(table.sigma_of_lnm(math.log(m_cell)))
    d_hi = float(hmf.get_delta_crit(hmf_int if hmf_int in (0, 1, 4) else 0, sigma_cell, growth)
                 ) * hmf.MAX_DELTAC_FRAC
    deltas = np.linspace(-1.0 + 1e-6, d_hi, N_DELTA)
    sc = hmf.set_scaling_constants(z, inputs)
    sc_sfr = sc.without_esc()

    def integral(consts):
        return hmf.nion_conditional(table, hmf_int, growth, ln_lo, math.log(m_cell), sigma_cell,
                                    deltas, consts.mturn_a_nofb, consts, ln_hi=ln_hi,
                                    method=ao.INTEGRATION_METHOD_ATOMIC)

    dev = ics.lowres_density.device
    delta = (ics.lowres_density.double() * growth).clamp(deltas[0], deltas[-1]).reshape(-1)
    t = (delta - deltas[0]) / (deltas[1] - deltas[0])
    i0 = t.long().clamp(0, N_DELTA - 2)
    fr = t - i0
    rel = []
    for consts in (sc, sc_sfr):
        tab = torch.as_tensor(integral(consts), dtype=F64, device=dev)
        r = tab[i0] * (1.0 - fr) + tab[i0 + 1] * fr
        mean = float(r.mean())
        if hmf_int in MEAN_FIXED and mean > 0:
            # no conditional form: the box mean is the chosen HMF's own
            r = r * (hmf.nion_general(table, cosmo, hmf_int, z, ln_lo, ln_hi,
                                      consts.mturn_a_nofb, consts) / mean)
        rel.append(r)
    nion_rel, sfr_rel = rel
    stars = cosmo.rho_crit * cosmo.OMb * sc.fstar_10
    sfr = stars / sc.t_star / sc.t_h
    values = torch.stack([nion_rel * stars * sc.fesc_10 * sc.pop2_ion, sfr_rel * sfr,
                          nion_rel * sfr * sc.fesc_10 * sc.pop2_ion,
                          sfr_rel * sc.l_x * sfr * physconst.s_per_yr])
    # each cell's sources move with the cell's displacement
    i = torch.arange(n, device=dev, dtype=F64)
    p = [torch.broadcast_to(g, (n, n, n)).reshape(-1)
         for g in (i[:, None, None], i[None, :, None], i[None, None, :])]
    p = [p_a + d.reshape(-1) * (n / L) for p_a, d in zip(p, _displacement_fields(inputs, ics, z))]
    return _cic_deposit(n, *p, values)


def halo_box(z, inputs, ics: plain.ICs, catalog, positions) -> HaloBox:
    """The HaloBox at `z` of the catalog at its Eulerian `positions`
    (`perturb_catalog`): comoving densities of ionizing emissivity, SFR,
    SFR-weighted emissivity and X-ray luminosity, the halos' deposit plus
    the sources below SAMPLER_MIN_MASS; float32 grids, computed in float64."""
    so = inputs.simulation_options
    n, L = so.HII_DIM, float(so.box_len)
    dev = ics.vx.device
    props = halo_properties(z, inputs, catalog, dev)
    p = positions * (n / L)
    grids = _cic_deposit(n, p[:, 0], p[:, 1], p[:, 2], torch.stack(
        [props["n_ion"], props["sfr"], props["wsfr"], props["xray"]])) / (L / n) ** 3
    del props
    below = _below_sampler(z, inputs, ics)
    if below is not None:
        grids += below
    n_ion, sfr, wsfr, xray = (g.float() for g in grids)
    return HaloBox(redshift=np.float32(z), n_ion=n_ion, halo_sfr=sfr, whalo_sfr=wsfr,
                   halo_xray=xray)


def _emission_redshifts(z, inputs, r_outer):
    """Each shell's mean emission redshift: halfway in z between the
    redshifts at which the comoving distance from `z` reaches its inner and
    outer radius, dr/dz = c (1 + z) |dt/dz| of the spin temperature's own
    ladder (matter and Lambda, `cosmology.dtdz`) summed by the trapezoid."""
    cosmo = inputs.cosmology
    zg = np.linspace(z, max(2.0 * float(inputs.simulation_options.Z_HEAT_MAX), z + 10.0), N_ZPP)
    drdz = (1.0 + zg) * physconst.c_cms * np.abs(cosmo.dtdz(zg)) / physconst.cm_per_Mpc
    dist = np.concatenate([[0.0], np.cumsum(0.5 * (drdz[1:] + drdz[:-1]) * np.diff(zg))])
    edges = np.interp(np.asarray(r_outer, np.float64), dist, zg)
    return 0.5 * (edges + np.concatenate([[z], edges[:-1]]))


def _annulus(kmag, r_in, r_out):
    """The k-space window of a uniform spherical shell between r_in and
    r_out, with its series at small k r_out."""
    small = kmag * r_out < 1e-4
    ko = torch.where(small, 1.0, kmag * r_out)
    ki = torch.where(small, 0.5, kmag * r_in)
    w = 3.0 * (torch.sin(ko) - ko * torch.cos(ko) - torch.sin(ki) + ki * torch.cos(ki)) / (
        ko**3 - ki**3)
    x = r_in / r_out
    series = 1.0 - (kmag * r_out) ** 2 / 10.0 * (x**5 - 1.0) / (x**3 - 1.0)
    return torch.where(small, series, w)


def xray_source_box(z, inputs, history) -> XraySourceBox:
    """The filtered SFR and X-ray shells at `z` from `history`, a list of
    (z_node, HaloBox) of this and earlier nodes; float32 stacks
    (N_STEP_TS, n, n, n), computed in float64."""
    so = inputs.simulation_options
    n, L = so.HII_DIM, float(so.box_len)
    ladder = setup_z_edges(z, inputs)
    zpp = _emission_redshifts(z, inputs, ladder.R)
    nodes = sorted(history, key=lambda t: t[0])
    z_nodes = np.array([t[0] for t in nodes], np.float64)
    live = zpp < min(float(z_nodes[-1]), float(so.Z_HEAT_MAX))
    lo = np.clip(np.searchsorted(z_nodes, zpp) - 1, 0, len(z_nodes) - 1)
    hi = np.clip(lo + 1, 0, len(z_nodes) - 1)
    span = np.where(hi > lo, z_nodes[hi] - z_nodes[lo], 1.0)
    w = np.clip((zpp - z_nodes[lo]) / span, 0.0, 1.0)
    dev = nodes[0][1].halo_sfr.device
    _, ksq = plain._kgrid(n, L, dev)
    kmag = torch.sqrt(ksq)
    out = {}
    for name in ("halo_sfr", "halo_xray"):
        grids = [getattr(t[1], name) for t in nodes]
        stack = torch.zeros((len(ladder.R), n, n, n), dtype=torch.float32, device=dev)
        for i in range(len(ladder.R)):
            if not live[i]:
                continue
            g = grids[lo[i]].double() * (1.0 - w[i]) + grids[hi[i]].double() * w[i]
            if ladder.R_inner[i] > 0:
                g = torch.fft.irfftn(torch.fft.rfftn(g) * _annulus(
                    kmag, float(ladder.R_inner[i]), float(ladder.R[i])), s=(n, n, n))
            stack[i] = g.clamp_min(0.0)
        out[name] = stack
    return XraySourceBox(redshift=np.float32(z), filtered_sfr=out["halo_sfr"],
                         filtered_xray=out["halo_xray"])
