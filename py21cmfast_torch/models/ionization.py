"""Excursion-set ionization box, with or without a spin-temperature box and
cumulative recombinations carried from the previous snapshot.

Equivalent of reference IonisationBox.c:1344-1649, following
py21cmfast_tpu/models/ionization.py.  The descending radius ladder
(find_HII_bubbles) is a Python loop over the radii, largest first, carrying the
neutral fraction / Gamma12 / MFP grids; each step filters the density at R,
inverse-FFTs, evaluates the conditional collapsed fraction (closed-form erfc
for CONST-ION-EFF; per-R Chebyshev fit or density-table gather for E-INTEGRAL),
mean-fixes it to the global value and applies the ionization criterion with
first-crossing bookkeeping (IonisationBox.c:1008-1201).

The host precomputes (per snapshot, float64): the radius ladder, sigma(M(R)),
the global Nion/Fcoll normalizations and the per-R conditional-Nion tables
(reference setup_integration_tables:702-768, interp_tables.c:291-579).
Per-R scalars are rounded to float32 on the host, as the JAX package feeds
them to its scan as float32 arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import not_in_slice, resolve_device
from ..cosmology.constants import FRACT_FLOAT_ERR, TINY, physconst
from ..cosmology.recombination import RecombinationHistory
from ..inputs import InputParameters
from ..ops import fft, filters, grids
from ..outputs import IonizedBox, PerturbedField, TsBox
from . import hmf
from . import recomb as recomb_module

__all__ = ["compute_ionization_field", "setup_radii"]

HII_ROUND_ERR = 1e-5
N_DELTA_TABLE = 400
CHEBY_DEG = 16          # degree of the log-Nion Chebyshev fits
CHEBY_X_SAFE = 0.98     # blend to the table edge above this (barrier sliver)

_f32 = np.float32


def _fit_log_cheby(tables, caps):
    """Fit log(Nion) per radius with Chebyshev polynomials.

    A degree-16 Clenshaw evaluation replaces the per-cell table gather.  The
    thin sliver within 1% of the collapse barrier (where log Nion turns
    sharply into the cap) blends linearly to the table's last node — cells
    there have fcoll*zeta >> 1 and ionize regardless.  Returns
    (coeffs[n_r, deg+1], log_edge[n_r], ok) where ok=False (the caller falls
    back to the gather) if the interior residual exceeds 1%."""
    from numpy.polynomial import chebyshev as C

    n_r, n_d = tables.shape
    x = np.linspace(-1.0, 1.0, n_d)
    sel = x <= CHEBY_X_SAFE
    coeffs = np.zeros((n_r, CHEBY_DEG + 1))
    log_edge = np.zeros(n_r)
    ok = True
    for i in range(n_r):
        y = np.log(np.clip(tables[i], 1e-38, None))
        c = C.chebfit(x[sel], y[sel], CHEBY_DEG)
        coeffs[i] = c
        log_edge[i] = y[-1]
        resid = np.max(np.abs(np.expm1(C.chebval(x[sel], c) - y[sel])))
        if resid > 1e-2:
            ok = False
    return coeffs, log_edge, ok


def _clenshaw(coeffs, x, deg):
    """Chebyshev evaluation on a grid; `coeffs` is a sequence of deg+1 floats."""
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    two_x = 2.0 * x
    for k in range(deg, 0, -1):
        b1, b2 = coeffs[k] + two_x * b1 - b2, b1
    return coeffs[0] + x * b1 - b2


@dataclasses.dataclass(frozen=True)
class RadiusLadder:
    """Filter radii (ascending) with per-R mass/sigma (IonisationBox.c:964-1006)."""

    R: np.ndarray
    M_max: np.ndarray
    sigma_max: np.ndarray

    @property
    def n(self):
        return len(self.R)


def setup_radii(inputs: InputParameters, m_min: float) -> RadiusLadder:
    so = inputs.simulation_options
    ap = inputs.astro_params
    ao = inputs.astro_options
    mo = inputs.matter_options
    cosmo = inputs.cosmology

    r_max = min(ap.r_bubble_max(ao), physconst.l_factor * so.box_len)
    pixel = so.box_len / so.HII_DIM
    cell_factor = physconst.l_factor
    if mo.source_model_uses_lagrangian_grids and not ao.IONISE_ENTIRE_SPHERE and pixel < 1:
        cell_factor = 1.0
    r_min = max(ap.R_BUBBLE_MIN, cell_factor * pixel)

    n_r = int(np.log(r_max / r_min) / np.log(ap.DELTA_R_HII_FACTOR) + 1)
    radii = []
    for i in range(n_r):
        r = r_min * ap.DELTA_R_HII_FACTOR**i
        if r > r_max - FRACT_FLOAT_ERR:
            radii.append(r_max)
            break
        radii.append(r)
    radii = np.array(radii)
    m_max = np.asarray(cosmo.RtoM(radii))
    # drop radii whose mass is below the minimum source mass (loop break, :1537)
    keep = m_max >= m_min
    radii, m_max = radii[keep], m_max[keep]
    sigma = cosmo.sigma_z0(m_max)
    return RadiusLadder(R=radii, M_max=m_max, sigma_max=sigma)


def _build_nion_tables(inputs, ladder, sigma_table, growth, m_min, sc):
    """Per-R conditional-Nion(delta) tables + caps for the E-INTEGRAL model.

    Returns (delta_lo[n_R], delta_hi[n_R], tables[n_R, N_DELTA], caps[n_R])
    where the cap applies above 0.99*delta_crit."""
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    ln_m_min = np.log(m_min)
    n_r = ladder.n
    d_lo = np.full(n_r, -1.0 + 1e-6)
    d_hi = np.empty(n_r)
    tables = np.empty((n_r, N_DELTA_TABLE))
    eff_hmf = hmf_int if hmf_int in (hmf.HMF_PS, hmf.HMF_ST, hmf.HMF_DELOS) else hmf.HMF_PS
    for i in range(n_r):
        sig = ladder.sigma_max[i]
        dcrit = float(hmf.get_delta_crit(eff_hmf, sig, growth))
        deltas = np.linspace(d_lo[i], dcrit * hmf.MAX_DELTAC_FRAC, N_DELTA_TABLE)
        tables[i] = hmf.nion_conditional(
            sigma_table,
            hmf_int,
            growth,
            ln_m_min,
            float(np.log(ladder.M_max[i])),
            sig,
            deltas,
            sc.mturn_a_nofb,
            sc,
            method=inputs.astro_options.INTEGRATION_METHOD_ATOMIC,
        )
        d_hi[i] = dcrit * hmf.MAX_DELTAC_FRAC
    # cap value for delta > 0.99 delta_crit: one halo at the condition mass
    caps = np.array(
        [
            hmf.nion_weight(np.array([np.log(m)]), sc, sc.mturn_a_nofb)[0] / m
            for m in ladder.M_max
        ]
    )
    return d_lo, d_hi, tables, caps


def _fcoll_at_radius(delta_r, step, *, mass_dep, use_cheby, sigma_min, growth):
    """Conditional collapsed fraction (or Nion) of the filtered density."""
    if mass_dep and use_cheby:
        # log-Nion Chebyshev evaluation (see _fit_log_cheby)
        xch = torch.clamp((delta_r - step["d_lo"]) / step["span"] * 2.0 - 1.0, -1.0, 1.0)
        flog = _clenshaw(step["cheb"], torch.clamp_max(xch, CHEBY_X_SAFE), CHEBY_DEG)
        blend = torch.clamp((xch - CHEBY_X_SAFE) / (1.0 - CHEBY_X_SAFE), 0.0, 1.0)
        fcoll = torch.exp(flog * (1.0 - blend) + step["cheb_edge"] * blend)
    elif mass_dep:
        # gather from the per-R Nion(delta) table
        t = (delta_r - step["d_lo"]) / step["span"] * (N_DELTA_TABLE - 1)
        t = torch.clamp(t, 0.0, N_DELTA_TABLE - 1.001)
        i0 = t.to(torch.int64)  # t >= 0 after the clamp: truncation is a floor
        frac = t - i0
        table = step["table"]
        fcoll = table[i0] * (1 - frac) + table[i0 + 1] * frac
    else:
        # closed-form conditional EPS erfc (hmf.c:1221-1241) — no tables
        sigdiff = np.sqrt(np.maximum(sigma_min**2 - step["sigma"] ** 2, _f32(1e-30)))
        arg = (physconst.delta_c_sph - delta_r) / float(growth) / float(np.sqrt(_f32(2.0)) * sigdiff)
        return torch.special.erfc(arg)
    fcoll = torch.where(delta_r >= step["d_hi"], step["cap"], fcoll)
    return torch.clamp(fcoll, 1e-40, 1.0)


def _ionize_scan(
    delta, prev_z_reion, steps, *, shape, box_lens, hii_filter, mass_dep, use_cheby,
    track_mfp, mean_fcoll, f_limit, ion_eff, gamma_prefactor, sigma_min, growth, redshift,
    xe_box=None, rec_box=None, filter_recomb=False,
):
    """Descending-R excursion-set loop.  `steps` holds the per-R scalars and
    tables ordered largest R first.  `xe_box` is the x-ray ionized fraction of
    a spin-temperature box; `rec_box` the cumulative recombinations per baryon
    of the previous snapshot, filtered at each R when `filter_recomb`."""
    kmag = grids.kmag_grid(shape, box_lens, delta.device)
    d_k = fft.rfft3(delta)
    xe_k = fft.rfft3(xe_box) if xe_box is not None else None
    rec_k = fft.rfft3(rec_box) if filter_recomb else None
    n_r = len(steps)

    # the neutral-fraction buffer starts at 1 (reference outputs.py:1525)
    xh = torch.ones_like(delta)
    gamma = torch.zeros_like(delta)
    mfp = torch.zeros_like(delta) if track_mfp else None
    for idx, step in enumerate(steps):
        r = step["R"]
        is_last = idx == n_r - 1
        # on the last (smallest-R) step the reference uses the UNFILTERED
        # density (copy_filter_transform, IonisationBox.c:606-633)
        def filtered(k_box, unfiltered):
            if is_last:
                return unfiltered
            return fft.irfft3(filters.filter_kbox(k_box, kmag, hii_filter, r), shape)

        delta_r = torch.clamp_min(filtered(d_k, delta), -1.0 + FRACT_FLOAT_ERR)
        xe_r = torch.clamp(filtered(xe_k, xe_box), 0.0, 0.999) if xe_box is not None else 0.0

        fcoll = _fcoll_at_radius(
            delta_r, step, mass_dep=mass_dep, use_cheby=use_cheby,
            sigma_min=sigma_min, growth=growth,
        )
        # mean fix: normalize the grid mean to the global unconditional value
        grid_mean = torch.clamp_min(fcoll.mean(), f_limit)
        fcoll = fcoll * (mean_fcoll / grid_mean)
        if mass_dep:
            fcoll = torch.clamp_min(fcoll, f_limit)

        # recombinations per baryon: CELL_RECOMB uses the previous snapshot's
        # cumulative N_rec unfiltered, otherwise N_rec is filtered at each R
        # like the other grids (IonisationBox.c:1084-1099)
        if filter_recomb:
            rec = torch.clamp_min(filtered(rec_k, rec_box), 0.0) / (1.0 + delta_r)
        elif rec_box is not None:
            rec = rec_box / (1.0 + delta_r)
        else:
            rec = 0.0

        ionized = fcoll * ion_eff > (1.0 - xe_r) * (1.0 + rec)
        newly = ionized & (xh > FRACT_FLOAT_ERR)
        gamma = torch.where(newly, r * (gamma_prefactor * fcoll), gamma)
        if track_mfp:
            mfp = torch.where(newly, r, mfp)
        xh = torch.where(ionized, 0.0, xh)

        if is_last:
            # partial ionization on the last step (IonisationBox.c:1161-1196)
            res = torch.clamp(1.0 - fcoll * ion_eff - xe_r, 0.0, 1.0)
            xh = torch.where((~ionized) & (xh > TINY), res, xh)

    keep = torch.where(prev_z_reion >= 0, prev_z_reion, -1.0)
    z_reion = torch.where(xh < TINY, torch.where(prev_z_reion >= 0, prev_z_reion, redshift), keep)
    return xh, gamma, mfp, z_reion


def _ionized_temperature(xh, z_reion, density, tk_neutral, t_re, redshift):
    """Kinetic temperature incl. ionized regions (thermochem.c:31-64):
    fully ionized cells follow the McQuinn 2015 evolving-ionized-gas fit from
    their reionization redshift; partially ionized cells mix the neutral and
    reionization temperatures linearly in the residual neutral fraction.
    `t_re` and `redshift` are float32 0-d tensors on the grids' device."""
    delta = torch.clamp_min(density, -1.0 + 1e-9)
    z_re = torch.maximum(z_reion, redshift)
    delta_re = torch.clamp_min(delta * (1.0 + redshift) / (1.0 + z_re), -1.0 + 1e-9)
    res = (
        ((1.0 + delta) / (1.0 + delta_re)) ** 1.1333
        * ((1.0 + redshift) / (1.0 + z_re)) ** 3.4
        * torch.exp(((1.0 + redshift) / 7.1) ** 2.5 - ((1.0 + z_re) / 7.1) ** 2.5)
    )
    res = torch.where(torch.abs(redshift - z_re) < 1e-4, 1.0, res)
    res = res * t_re**1.7 + (1e4 * (1.0 + redshift) / 4.0) ** 1.7 * (1.0 + delta)
    t_full = torch.maximum(res**0.5882, tk_neutral)
    t_partial = tk_neutral * xh + t_re * (1.0 - xh)
    fully = (z_reion > 0) & (xh < TINY)
    return torch.where(fully, t_full, t_partial)


def _recomb_update(
    rec_prev, density, gamma12, xh, rr_table, ln_g_min, dln_g, dz_tab, redshift, dtdz_dz
):
    """dN_rec = RR(z_eff, Gamma12) |dt/dz| dz (1 - xH), z_eff from the local
    density via (1+z_eff) = (1+z)(1+delta)^(1/3) (IonisationBox.c:1277-1335).
    `rr_table` is a float32 tensor, the scalars float32-rounded floats."""
    # the cube root's argument is non-negative: the density is > -1
    z_eff = (1.0 + redshift) * torch.pow(1.0 + density, 1.0 / 3.0) - 1.0
    n_z, n_g = rr_table.shape
    z_idx = torch.clamp(torch.round(z_eff / dz_tab).to(torch.int64), 0, n_z - 1)
    ln_g = torch.log(torch.clamp_min(gamma12, 1e-35))
    t = torch.clamp((ln_g - ln_g_min) / dln_g, 0.0, n_g - 1.001)
    i0 = t.to(torch.int64)  # t >= 0 after the clamp: truncation is a floor
    frac = t - i0
    rr = rr_table[z_idx, i0] * (1 - frac) + rr_table[z_idx, i0 + 1] * frac
    rr = torch.where(ln_g < ln_g_min, 0.0, rr)
    return rec_prev + rr * dtdz_dz * (1.0 - xh)


_sigma_table_cache = {}


def _get_sigma_table(inputs: InputParameters):
    key = inputs.matter_cosmo_hash
    if key not in _sigma_table_cache:
        _sigma_table_cache[key] = inputs.cosmology.build_sigma_table(
            m_min=1e2, m_max=1e20, n=600
        )
    return _sigma_table_cache[key]


def check_inputs(inputs: InputParameters) -> None:
    """Raise NotImplementedError for ionization options outside the port."""
    mo = inputs.matter_options
    ao = inputs.astro_options
    if ao.USE_MINI_HALOS:
        not_in_slice("USE_MINI_HALOS", 11)
    if mo.SOURCE_MODEL == "L-INTEGRAL":
        not_in_slice("SOURCE_MODEL='L-INTEGRAL'", 12)
    if mo.source_model_uses_halo_sampler:
        not_in_slice(f"SOURCE_MODEL={mo.SOURCE_MODEL!r}", 13)
    if ao.PHOTON_CONS_TYPE != "NO-PHOTONCONS":
        not_in_slice(f"PHOTON_CONS_TYPE={ao.PHOTON_CONS_TYPE!r}", 14)
    if ao.IONISE_ENTIRE_SPHERE:
        not_in_slice("IONISE_ENTIRE_SPHERE", 6)


def compute_ionization_field(
    redshift: float,
    inputs: InputParameters,
    perturbed_field: PerturbedField,
    previous_ionized_box: IonizedBox | None = None,
    spin_temp: TsBox | None = None,
    prev_redshift: float | None = None,
    *,
    device="cuda",
) -> IonizedBox:
    """Ionized box at `redshift` from the perturbed density.

    `previous_ionized_box` carries z_reion and, with a recombination model,
    the cumulative recombinations forward (`prev_redshift` then gives the
    step); `spin_temp` brings the x-ray ionized fraction into the criterion
    and the neutral gas's kinetic temperature.  The fields are moved to
    `device` if they live elsewhere."""
    dev = resolve_device(device)
    check_inputs(inputs)
    so = inputs.simulation_options
    mo = inputs.matter_options
    ao = inputs.astro_options
    ap = inputs.astro_params
    cosmo = inputs.cosmology
    shape = so.lowres_shape
    box_lens = so.box_lens
    density = perturbed_field.density.to(dev)

    growth = float(cosmo.dicke(redshift))
    sc = hmf.set_scaling_constants(redshift, inputs)
    m_min = hmf.minimum_source_mass(redshift, inputs, xray=False)
    sigma_min = float(cosmo.sigma_z0(m_min))
    sigma_table = _get_sigma_table(inputs)
    ln_m_min, ln_m_max = np.log(m_min), np.log(hmf.M_MAX_INTEGRAL)
    hmf_int = hmf.HMF_NAMES[mo.HMF]
    mass_dep = mo.source_model_is_mass_dependent
    ion_eff = sc.pop2_ion * sc.fstar_10 * sc.fesc_10 if mass_dep else ap.HII_EFF_FACTOR

    # --- global normalization (set_mean_fcoll, IonisationBox.c:468-529) -----
    if mass_dep:
        mean_fcoll = float(
            hmf.nion_general(
                sigma_table, cosmo, hmf_int, redshift, ln_m_min, ln_m_max,
                sc.mturn_a_nofb, sc,
            )
        )
        f_limit = float(
            hmf.nion_general(
                sigma_table, cosmo, hmf_int, so.Z_HEAT_MAX, ln_m_min, ln_m_max,
                sc.mturn_a_nofb, sc,
            )
        )
        log10_mturn_ave = np.log10(sc.mturn_a_nofb)
    else:
        mean_fcoll = float(
            hmf.fcoll_general(sigma_table, cosmo, hmf_int, redshift, ln_m_min, ln_m_max)
        )
        f_limit = FRACT_FLOAT_ERR
        log10_mturn_ave = np.log10(m_min)

    prev_z_reion = (
        previous_ionized_box.z_reion.to(dev)
        if previous_ionized_box is not None
        else torch.full(shape, -1.0, dtype=torch.float32, device=dev)
    )

    # --- early exit: nothing ionizes (IonisationBox.c:1472-1475) ------------
    if mean_fcoll * ion_eff < HII_ROUND_ERR:
        if spin_temp is not None:
            xh = 1.0 - spin_temp.xray_ionised_fraction.to(dev)
        else:
            rec_hist = RecombinationHistory(cosmo)
            xh = torch.full(
                shape, float(1.0 - rec_hist.x_e(redshift)), dtype=torch.float32, device=dev
            )
        return IonizedBox(
            redshift=np.float32(redshift),
            neutral_fraction=xh,
            z_reion=prev_z_reion,
            ionisation_rate_G12=torch.zeros(shape, dtype=torch.float32, device=dev),
            mean_f_coll=np.float32(mean_fcoll),
            mean_f_coll_MINI=np.float32(0.0),
            log10_Mturnover_ave=np.float32(log10_mturn_ave),
            log10_Mturnover_MINI_ave=np.float32(0.0),
        )

    ladder = setup_radii(inputs, m_min)
    n_r = ladder.n
    if mass_dep:
        d_lo, d_hi, tables, caps = _build_nion_tables(
            inputs, ladder, sigma_table, growth, m_min, sc
        )
        # Chebyshev fits of the per-R log-Nion tables; the gather is the
        # fallback when a fit is poor
        cheby_coeffs, cheby_edge, use_cheby = _fit_log_cheby(tables, caps)
    else:
        d_lo, d_hi = np.zeros(n_r), np.ones(n_r)
        tables, caps = np.zeros((n_r, N_DELTA_TABLE)), np.zeros(n_r)
        cheby_coeffs, cheby_edge, use_cheby = np.zeros((n_r, CHEBY_DEG + 1)), np.zeros(n_r), False

    gamma_prefactor = (
        (1 + redshift) ** 2
        * physconst.cm_per_Mpc
        * physconst.sigma_HI
        * ap.ALPHA_UVB
        / (ap.ALPHA_UVB + 2.75)
        * cosmo.N_b0
        * ion_eff
        / 1.0e-12
    )
    if mass_dep:
        gamma_prefactor /= sc.t_h * sc.t_star

    use_recomb = ao.uses_recombination
    rec_box = None
    if use_recomb:
        if previous_ionized_box is not None and (
            previous_ionized_box.cumulative_recombinations is not None
        ):
            rec_box = previous_ionized_box.cumulative_recombinations.to(dev)
        else:
            rec_box = torch.zeros(shape, dtype=torch.float32, device=dev)

    # descending order (largest R first); every scalar rounded to float32
    steps = []
    for i in np.argsort(ladder.R)[::-1]:
        lo, hi = _f32(d_lo[i]), _f32(d_hi[i])
        steps.append(dict(
            R=float(_f32(ladder.R[i])),
            sigma=_f32(ladder.sigma_max[i]),
            d_lo=float(lo),
            d_hi=float(hi),
            span=float(hi - lo),
            cap=float(_f32(caps[i])),
            cheb=[float(c) for c in cheby_coeffs[i].astype(np.float32)],
            cheb_edge=float(_f32(cheby_edge[i])),
            table=(
                torch.as_tensor(tables[i], dtype=torch.float32, device=dev)
                if mass_dep and not use_cheby else None
            ),
        ))

    xh, gamma, mfp, z_reion = _ionize_scan(
        density, prev_z_reion, steps,
        shape=shape,
        box_lens=box_lens,
        hii_filter=inputs.astro_options.hii_filter_int,
        mass_dep=mass_dep,
        use_cheby=use_cheby,
        track_mfp=not mo.MINIMIZE_MEMORY,
        mean_fcoll=float(_f32(mean_fcoll)),
        f_limit=float(_f32(f_limit)),
        ion_eff=float(_f32(ion_eff)),
        gamma_prefactor=float(_f32(gamma_prefactor)),
        sigma_min=_f32(sigma_min),
        growth=_f32(growth),
        redshift=float(_f32(redshift)),
        xe_box=spin_temp.xray_ionised_fraction.to(dev) if spin_temp is not None else None,
        rec_box=rec_box,
        filter_recomb=use_recomb and not ao.CELL_RECOMB,
    )

    # --- cumulative recombination update (set_recombination_rates:1258-1342) ---
    cumulative_rec = None
    if use_recomb:
        rt = recomb_module.get_recomb_tables(cosmo)
        if prev_redshift is None or prev_redshift < 1:
            dz = (1.0 + redshift) * (so.ZPRIME_STEP_FACTOR - 1.0)
        else:
            dz = prev_redshift - redshift
        fabs_dtdz = abs(float(cosmo.dtdz(redshift))) / 1e15
        if ao.RECOMB_MODEL == "INHOMOGENEOUS":
            cumulative_rec = _recomb_update(
                rec_box, density, gamma, xh,
                torch.as_tensor(np.asarray(rt.table, np.float32), device=dev),
                float(_f32(rt.ln_gamma[0])),
                float(_f32(recomb_module.RR_DEL_LNGAMMA)),
                float(_f32(recomb_module.RR_DEL_Z)),
                float(_f32(redshift)),
                float(_f32(fabs_dtdz * dz)),
            )
        else:  # homogeneous: single global rate broadcast
            global_xh, global_gamma = torch.stack([xh.double().mean(), gamma.double().mean()]).tolist()
            d_nrec = (
                rt.evaluate(redshift, max(global_gamma, 1e-30))[0]
                * fabs_dtdz
                * dz
                * (1.0 - global_xh)
            )
            cumulative_rec = rec_box + float(_f32(d_nrec))

    # kinetic temperature of the (partially) ionized IGM (reference
    # set_ionized_temperatures, IonisationBox.c:1203-1257).  MINIMIZE_MEMORY
    # drops it and the per-cell mean free path (IonisationBox.c:543,1137,1589).
    kinetic_temperature = None
    if not mo.MINIMIZE_MEMORY:
        if spin_temp is not None:
            tk_neutral = spin_temp.kinetic_temp_neutral.to(dev)
        else:
            rec_hist = RecombinationHistory(cosmo)
            tk_neutral = float(_f32(rec_hist.Tk(redshift))) * (
                1.0 + float(_f32(rec_hist.cT_approx(redshift))) * density
            )

        def scalar(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)

        kinetic_temperature = _ionized_temperature(
            xh, z_reion, density, tk_neutral, scalar(ap.T_RE), scalar(redshift)
        )

    return IonizedBox(
        redshift=np.float32(redshift),
        neutral_fraction=xh,
        z_reion=z_reion,
        ionisation_rate_G12=gamma,
        mean_f_coll=np.float32(mean_fcoll),
        mean_f_coll_MINI=np.float32(0.0),
        log10_Mturnover_ave=np.float32(log10_mturn_ave),
        log10_Mturnover_MINI_ave=np.float32(0.0),
        kinetic_temperature=kinetic_temperature,
        mean_free_path=mfp,
        cumulative_recombinations=cumulative_rec,
    )
