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

With USE_MINI_HALOS the sources split into atomic-cooling (ACG) and
molecular-cooling (MCG) halos whose turnover masses vary per cell
(`_mcrit_kernel`: reionization, Lyman-Werner and streaming-velocity feedback);
the collapsed fractions are then bilinear gathers from per-R (log10 Mturn,
delta) tables, and the pre-mean-fix grids of each radius are kept as the
`unnormalised_nion(_mini)` stacks for the next snapshot's trapezoidal Nion
update (IonisationBox.c:834-880).

With a Lagrangian source model (L-INTEGRAL) the HaloBox's ionizing-photon
and ionizing-SFR grids, filtered at each radius (by the exponential-MFP
tophat under USE_EXP_FILTER), take the place of the conditional Nion tables
and of the mean fix (IonisationBox.c:615-621, 1054-1067).  With
IONISE_ENTIRE_SPHERE the whole sphere around each newly ionized cell is
ionized (bubble_helper_progs.c:341).

Photon non-conservation (models/photoncons.py): under Z-PHOTONCONS the box
is computed at the adjusted redshift with the density scaled by the growth
ratio D(z_adj)/D(z) (IonisationBox.c:1389-1407); under ALPHA- and
F-PHOTONCONS the fitted ALPHA_ESC or F_ESC10 replaces the ACG escape
parameter of the scaling constants.

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

from .._device import resolve_device
from ..cosmology.constants import FRACT_FLOAT_ERR, TINY, physconst
from ..cosmology.recombination import RecombinationHistory
from ..inputs import InputParameters
from ..ops import filters
from ..ops.gridops import SINGLE, for_mesh
from ..outputs import HaloBox, IonizedBox, PerturbedField, TsBox
from . import hmf
from . import recomb as recomb_module

__all__ = ["compute_ionization_field", "setup_radii"]

HII_ROUND_ERR = 1e-5
N_DELTA_TABLE = 400
N_MTURN_TABLE = 24
MTURN_BOUNDS = (5.0, 10.0)  # log10 Mturn axis of the minihalo tables (IonisationBox.c:34)
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


def _build_nion_tables_mini(inputs, ladder, sigma_table, growth, m_min, sc, l10_mturns):
    """Per-R (log10 Mturn, delta) conditional-Nion tables for ACG and MCG.

    Returns (delta_lo[n_R], delta_hi[n_R], tables[n_R, n_Mturn, N_DELTA],
    caps[n_R], tables_mini[n_R, n_Mturn, N_DELTA], caps_mini[n_R])."""
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    ln_m_min = np.log(m_min)
    n_r = ladder.n
    n_mt = len(l10_mturns)
    d_lo = np.full(n_r, -1.0 + 1e-6)
    d_hi = np.empty(n_r)
    tables = np.empty((n_r, n_mt, N_DELTA_TABLE))
    tables_mini = np.empty((n_r, n_mt, N_DELTA_TABLE))
    eff_hmf = hmf_int if hmf_int in (hmf.HMF_PS, hmf.HMF_ST, hmf.HMF_DELOS) else hmf.HMF_PS
    for i in range(n_r):
        sig = ladder.sigma_max[i]
        dcrit = float(hmf.get_delta_crit(eff_hmf, sig, growth))
        d_hi[i] = dcrit * hmf.MAX_DELTAC_FRAC
        deltas = np.linspace(d_lo[i], d_hi[i], N_DELTA_TABLE)
        ln_mc = float(np.log(ladder.M_max[i]))
        tables[i] = hmf.build_nion_mturn_tables(
            sigma_table, hmf_int, growth, ln_m_min, ln_mc, sig, deltas, l10_mturns, sc,
            method=inputs.astro_options.INTEGRATION_METHOD_ATOMIC,
        )
        tables_mini[i] = hmf.build_nion_mturn_tables(
            sigma_table, hmf_int, growth, ln_m_min, ln_mc, sig, deltas, l10_mturns,
            sc, mini=True, method=inputs.astro_options.INTEGRATION_METHOD_MINI,
        )
    caps = np.array(
        [hmf.nion_weight(np.array([np.log(m)]), sc, sc.mturn_a_nofb)[0] / m
         for m in ladder.M_max]
    )
    caps_mini = np.array(
        [hmf.nion_weight_mini(np.array([np.log(m)]), sc, sc.mturn_m_nofb)[0] / m
         for m in ladder.M_max]
    )
    return d_lo, d_hi, tables, caps, tables_mini, caps_mini


def _mcrit_kernel(prev_g12, prev_zre, j21, redshift, mturn_a_nofb, mturn_m_nofb, vcb,
                  a_lw, beta_lw, a_vcb, beta_vcb, sigmavcb):
    """Per-cell log10 turnover masses of ACG and MCG halos
    (calculate_mcrit_boxes:403-460 with thermochem.c reionization_feedback and
    lyman_werner_threshold): Sobacchi-Mesinger feedback from the previous
    Gamma12 and z_reion, Lyman-Werner feedback from J_21_LW and the
    streaming-velocity factor.  The scalars are float32 0-d tensors on the
    grids' device; `vcb` is one of them or the lowres |v_cb| box."""
    zfrac = torch.clamp_min(1.0 - ((1.0 + redshift) / (1.0 + prev_zre)) ** 2.0, 0.0)
    mcrit_re = 3e9 * (2.0 * torch.clamp_min(prev_g12, 1e-20)) ** 0.17 * (
        (1.0 + redshift) / 10.0
    ) ** -2.1 * zfrac ** 2.5
    # never-ionized cells carry no reionization feedback; the JAX package
    # writes 1e-40 there (a float32 denormal), 0 takes the same maximum below
    mcrit_re = torch.where(prev_zre <= 1e-19, 0.0, mcrit_re)

    mcrit_nolw = 3.314e7 * (1.0 + redshift) ** -1.5
    f_lw = 1.0 + a_lw * torch.clamp_min(j21, 0.0) ** beta_lw
    f_vcb = (1.0 + a_vcb * vcb / sigmavcb) ** beta_vcb
    mcrit_lw = mcrit_nolw * f_lw * f_vcb

    mt_a = torch.log10(torch.maximum(mcrit_re, mturn_a_nofb))
    mt_m = torch.log10(torch.maximum(mcrit_re, torch.maximum(mcrit_lw, mturn_m_nofb)))
    return mt_a, mt_m


def mcrit_boxes(redshift, inputs, sc, previous_ionized_box, lw_box, vcb_box, device,
                shape=None):
    """`_mcrit_kernel` for one snapshot, its scalars rounded to float32 on
    `device` as the JAX package hands them over.  `previous_ionized_box`
    gives Gamma12 and z_reion (no reionization feedback without one),
    `lw_box` is the TsBox whose J_21_LW sets the LW feedback (none without
    one), `vcb_box` the ICs' lowres |v_cb| (the scaling constants' mean speed
    without one).  `shape` is that of the grids filled in for missing boxes
    (the lowres shape; this rank's slab on a mesh)."""
    ap = inputs.astro_params
    shape = inputs.simulation_options.lowres_shape if shape is None else shape

    def grid(box, name, fill):
        v = getattr(box, name, None) if box is not None else None
        if v is not None:
            return v.to(device)
        return torch.full(shape, fill, dtype=torch.float32, device=device)

    def f32(v):
        return torch.tensor(float(_f32(v)), dtype=torch.float32, device=device)

    return _mcrit_kernel(
        grid(previous_ionized_box, "ionisation_rate_G12", 0.0),
        grid(previous_ionized_box, "z_reion", -1.0),
        grid(lw_box, "J_21_LW", 0.0),
        f32(redshift), f32(sc.mturn_a_nofb), f32(sc.mturn_m_nofb),
        vcb_box.to(device) if vcb_box is not None else f32(sc.vcb_const),
        f32(ap.A_LW), f32(ap.BETA_LW), f32(ap.A_VCB), f32(ap.BETA_VCB),
        f32(sc.v_cb_avg * np.sqrt(3.0 * np.pi / 8.0)),
    )


def _gather2d(flat, n_delta, mt_r, i_d, f_d):
    """Bilinear (log10 Mturn, delta) gather from one radius' (or Ts shell's)
    flattened (N_MTURN_TABLE, n_delta) table, at the delta index `i_d` and
    weight `f_d`."""
    lo, hi = MTURN_BOUNDS
    tm = (torch.clamp(mt_r, lo, hi) - lo) / (hi - lo)
    tm = torch.clamp(tm * (N_MTURN_TABLE - 1), 0.0, N_MTURN_TABLE - 1.001)
    j0 = tm.to(torch.int64)  # tm >= 0 after the clamp: truncation is a floor
    fm = tm - j0
    base = j0 * n_delta + i_d
    v00, v01 = flat[base], flat[base + 1]
    v10, v11 = flat[base + n_delta], flat[base + n_delta + 1]
    return (v00 * (1 - f_d) + v01 * f_d) * (1 - fm) + (v10 * (1 - f_d) + v11 * f_d) * fm


def _delta_index(delta_r, d_lo, span):
    """Index and weight of a density on a radius' N_DELTA_TABLE axis."""
    t = torch.clamp((delta_r - d_lo) / span * (N_DELTA_TABLE - 1), 0.0, N_DELTA_TABLE - 1.001)
    i0 = t.to(torch.int64)  # t >= 0 after the clamp: truncation is a floor
    return i0, t - i0


def _fcoll_mini_at_radius(delta_r, mta_r, mtm_r, step, prev_r, mini):
    """ACG and MCG conditional Nion of one radius, after the trapezoidal
    update from the previous snapshot when `prev_r` (its filtered density)
    is given: Nion(z) = Nion_prev + Nion(z, Mt) - Nion(z_prev, Mt)."""
    i0, fd = _delta_index(delta_r, step["d_lo"], step["span"])
    fcoll = _gather2d(step["table"], N_DELTA_TABLE, mta_r, i0, fd)
    fcoll = torch.clamp(torch.where(delta_r >= step["d_hi"], step["cap"], fcoll), 1e-40, 1.0)
    fcoll_mini = _gather2d(step["table_mini"], N_DELTA_TABLE, mtm_r, i0, fd)
    fcoll_mini = torch.clamp(
        torch.where(delta_r >= step["d_hi"], step["cap_mini"], fcoll_mini), 1e-40, 1.0)
    if prev_r is None:
        return fcoll, fcoll_mini
    pd_r = torch.clamp_min(prev_r, -1.0 + FRACT_FLOAT_ERR)
    ip, fp = _delta_index(pd_r, step["p_d_lo"], step["p_span"])
    prev_f = _gather2d(step["p_table"], N_DELTA_TABLE, mta_r, ip, fp)
    prev_f = torch.clamp(torch.where(pd_r >= step["p_d_hi"], step["p_cap"], prev_f), 1e-40, 1.0)
    prev_fm = _gather2d(step["p_table_mini"], N_DELTA_TABLE, mtm_r, ip, fp)
    prev_fm = torch.clamp(
        torch.where(pd_r >= step["p_d_hi"], step["p_cap_mini"], prev_fm), 1e-40, 1.0)
    idx = step["idx"]
    fcoll = torch.clamp(mini["prev_nion"][idx] + fcoll - prev_f, 1e-40, 1.0)
    fcoll_mini = torch.clamp(mini["prev_nion_mini"][idx] + fcoll_mini - prev_fm, 1e-40, 1.0)
    return fcoll, fcoll_mini


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
    xe_box=None, rec_box=None, filter_recomb=False, mini=None, lagr=None,
    paint_spheres=False, gops=SINGLE,
):
    """Descending-R excursion-set loop.  `steps` holds the per-R scalars and
    tables ordered largest R first.  `xe_box` is the x-ray ionized fraction of
    a spin-temperature box; `rec_box` the cumulative recombinations per baryon
    of the previous snapshot, filtered at each R when `filter_recomb`.

    `mini` (USE_MINI_HALOS) holds the turnover-mass boxes `mturn_a` and
    `mturn_m`, the MCG scalars (`mean_fcoll_mini`, `f_limit_mini`,
    `ion_eff_mini`, `gamma_prefactor_mini`) and, when the Nion history is
    tracked, the previous snapshot's density `prev_delta` and its stacks
    `prev_nion`, `prev_nion_mini`; the pre-mean-fix grids of every radius are
    then written into the (n_R, N^3) stacks returned as the fifth and sixth
    values (None without minihalos).

    `lagr` (Lagrangian sources, IonisationBox.c:615-621, 1054-1067) holds the
    photon grid `stars` (n_ion / rho_b), the ionizing-SFR grid `wsfr`
    (whalo_sfr / rho_b), the `source_filter` id that filters both (the
    exponential-MFP tophat under USE_EXP_FILTER) and its `mfp`; the collapsed
    fraction is then stars_R / (1 + delta_R), with no mean fix, and Gamma12
    comes from the filtered SFR.  `paint_spheres` (IONISE_ENTIRE_SPHERE)
    ionizes the whole R-sphere around each newly ionized cell.

    `gops` (ops/gridops.py) takes the FFTs, |k| and the grid means: SINGLE
    on one device, the slab FFT and the means over the ranks on a mesh,
    where the grids are this rank's x-slabs and `shape` the global shape."""
    kmag = gops.kmag(shape, box_lens, delta.device)
    d_k = gops.rfft3(delta)
    xe_k = gops.rfft3(xe_box) if xe_box is not None else None
    rec_k = gops.rfft3(rec_box) if filter_recomb else None
    if lagr is not None:
        stars_k, wsfr_k = gops.rfft3(lagr["stars"]), gops.rfft3(lagr["wsfr"])
    n_r = len(steps)
    nion = nion_mini = None
    if mini is not None:
        mta_k, mtm_k = gops.rfft3(mini["mturn_a"]), gops.rfft3(mini["mturn_m"])
        track = mini.get("prev_delta") is not None
        pd_k = gops.rfft3(mini["prev_delta"]) if track else None
        nion = torch.empty((n_r,) + gops.local_shape(shape), dtype=torch.float32,
                           device=delta.device)
        nion_mini = torch.empty_like(nion)

    # the neutral-fraction buffer starts at 1 (reference outputs.py:1525)
    xh = torch.ones_like(delta)
    gamma = torch.zeros_like(delta)
    mfp = torch.zeros_like(delta) if track_mfp else None
    for idx, step in enumerate(steps):
        r = step["R"]
        is_last = idx == n_r - 1
        # on the last (smallest-R) step the reference uses the UNFILTERED
        # grids (copy_filter_transform, IonisationBox.c:606-633)
        def filtered(k_box, unfiltered):
            if is_last:
                return unfiltered
            return gops.irfft3(filters.filter_kbox(k_box, kmag, hii_filter, r), shape)

        delta_r = filtered(d_k, delta)
        xe_r = filtered(xe_k, xe_box) if xe_box is not None else None
        if lagr is not None:
            if is_last:
                stars_r, sfr_r = lagr["stars"], lagr["wsfr"]
            else:
                # one source window serves both grids
                win = filters.filter_weights(kmag, lagr["source_filter"], r, lagr["mfp"])
                stars_r = gops.irfft3(stars_k * win, shape)
                sfr_r = gops.irfft3(wsfr_k * win, shape)
        if mini is not None:
            mta_r = filtered(mta_k, mini["mturn_a"])
            mtm_r = filtered(mtm_k, mini["mturn_m"])
            pd_r = filtered(pd_k, mini["prev_delta"]) if track else None
        delta_r = torch.clamp_min(delta_r, -1.0 + FRACT_FLOAT_ERR)
        xe_r = torch.clamp(xe_r, 0.0, 0.999) if xe_box is not None else 0.0

        if lagr is not None:
            # halo model: filtered ionizing-photon grid -> photons per baryon
            # (no mean fix: the grids already realize the HMF)
            fcoll = torch.clamp_min(stars_r, 0.0) / (1.0 + delta_r)
            sfr_r = torch.clamp_min(sfr_r, 0.0)
        elif mini is not None:
            fcoll, fcoll_mini = _fcoll_mini_at_radius(delta_r, mta_r, mtm_r, step, pd_r, mini)
            # pre-mean-fix grids, for the next snapshot's trapezoid
            nion[idx] = fcoll
            nion_mini[idx] = fcoll_mini
        else:
            fcoll = _fcoll_at_radius(
                delta_r, step, mass_dep=mass_dep, use_cheby=use_cheby,
                sigma_min=sigma_min, growth=growth,
            )
        if lagr is None:
            # mean fix: normalize the grid mean to the global unconditional value
            grid_mean = torch.clamp_min(gops.mean(fcoll, shape), f_limit)
            fcoll = fcoll * (mean_fcoll / grid_mean)
            if mass_dep:
                fcoll = torch.clamp_min(fcoll, f_limit)
        if mini is not None:
            grid_mean_mini = torch.clamp_min(gops.mean(fcoll_mini, shape), mini["f_limit_mini"])
            fcoll_mini = torch.clamp_min(
                fcoll_mini * (mini["mean_fcoll_mini"] / grid_mean_mini), mini["f_limit_mini"])

        # recombinations per baryon: CELL_RECOMB uses the previous snapshot's
        # cumulative N_rec unfiltered, otherwise N_rec is filtered at each R
        # like the other grids (IonisationBox.c:1084-1099)
        if filter_recomb:
            rec = torch.clamp_min(filtered(rec_k, rec_box), 0.0) / (1.0 + delta_r)
        elif rec_box is not None:
            rec = rec_box / (1.0 + delta_r)
        else:
            rec = 0.0

        if mini is not None:
            photons = fcoll * ion_eff + fcoll_mini * mini["ion_eff_mini"]
            g_new = r * (gamma_prefactor * fcoll + mini["gamma_prefactor_mini"] * fcoll_mini)
        elif lagr is not None:
            photons = fcoll * ion_eff
            g_new = float(_f32(r) * _f32(gamma_prefactor)) / (1.0 + delta_r) * sfr_r
        else:
            photons = fcoll * ion_eff
            g_new = r * (gamma_prefactor * fcoll)
        ionized = photons > (1.0 - xe_r) * (1.0 + rec)
        newly = ionized & (xh > FRACT_FLOAT_ERR)
        gamma = torch.where(newly, g_new, gamma)
        if track_mfp:
            mfp = torch.where(newly, r, mfp)
        if paint_spheres:
            xh = _paint_spheres(xh, newly, kmag, r, shape, box_lens, gops)
        else:
            xh = torch.where(ionized, 0.0, xh)

        if is_last:
            # partial ionization on the last step (IonisationBox.c:1161-1196)
            res = 1.0 - fcoll * ion_eff
            if mini is not None:
                res = res - fcoll_mini * mini["ion_eff_mini"]
            res = torch.clamp(res - xe_r, 0.0, 1.0)
            xh = torch.where((~ionized) & (xh > TINY), res, xh)

    keep = torch.where(prev_z_reion >= 0, prev_z_reion, -1.0)
    z_reion = torch.where(xh < TINY, torch.where(prev_z_reion >= 0, prev_z_reion, redshift), keep)
    return xh, gamma, mfp, z_reion, nion, nion_mini


def _paint_spheres(xh, newly, kmag, r, shape, box_lens, gops=SINGLE):
    """IONISE_ENTIRE_SPHERE (reference update_in_sphere,
    bubble_helper_progs.c:341): zero the whole R-sphere around each newly
    ionized cell.  The flag field is convolved with the normalized spherical
    tophat; a cell within R of a flagged centre gets at least 1/N_sphere
    (N_sphere the sphere's volume in cells), and the FFT sidelobes are ~1e-2
    of that, so the threshold is half of it."""
    painted = gops.irfft3(
        filters.filter_kbox(gops.rfft3(newly.to(torch.float32)), kmag, filters.TOPHAT, r), shape)
    # the JAX package's float32 scalars: (4 pi / 3) (R / cell)^3, at least 1
    q = _f32(r) / _f32(box_lens[0] / shape[0])
    n_sph = max(_f32(4.0 * np.pi / 3.0) * (q * (q * q)), _f32(1.0))
    return torch.where(painted > float(_f32(0.5) / n_sph), 0.0, xh)


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


def compute_ionization_field(
    redshift: float,
    inputs: InputParameters,
    perturbed_field: PerturbedField,
    previous_ionized_box: IonizedBox | None = None,
    spin_temp: TsBox | None = None,
    prev_redshift: float | None = None,
    previous_perturbed_field: PerturbedField | None = None,
    vcb_box: torch.Tensor | None = None,
    halobox: HaloBox | None = None,
    photoncons_state=None,
    mesh=None,
    *,
    device="cuda",
) -> IonizedBox:
    """Ionized box at `redshift` from the perturbed density.

    `previous_ionized_box` carries z_reion and, with a recombination model,
    the cumulative recombinations forward (`prev_redshift` then gives the
    step); `spin_temp` brings the x-ray ionized fraction into the criterion
    and the neutral gas's kinetic temperature.  With USE_MINI_HALOS the
    previous box's Gamma12, z_reion and Nion stacks, the TsBox's J_21_LW,
    `previous_perturbed_field` (for the Nion history) and `vcb_box` (the ICs'
    lowres |v_cb|; the scaling constants' mean speed when None) set the
    turnover masses.  With a Lagrangian source model (SOURCE_MODEL
    'L-INTEGRAL') `halobox` brings the source grids: its n_ion and
    whalo_sfr, filtered at each radius, replace the conditional Nion tables.
    `photoncons_state` (from `setup_photon_cons`) applies the photon
    non-conservation correction: a PhotonConsState shifts the redshift the
    box is computed at, a PhotonConsFit the escape parameters.  The box
    keeps `redshift` as its own.  With `mesh` (a parallel.mesh.Mesh) the
    fields are this rank's x-slabs, the scan takes the slab FFT and the box
    means are taken over the ranks.  The fields are moved to `device` if
    they live elsewhere."""
    dev = resolve_device(device)
    gops = for_mesh(mesh)
    so = inputs.simulation_options
    mo = inputs.matter_options
    ao = inputs.astro_options
    ap = inputs.astro_params
    cosmo = inputs.cosmology
    shape = so.lowres_shape
    lshape = gops.local_shape(shape)
    box_lens = so.box_lens
    density = perturbed_field.density.to(dev)

    # photon non-conservation: shift the effective redshift and rescale the
    # density by the growth ratio (IonisationBox.c:1389-1407); the fitted
    # variants flow through the scaling constants instead
    stored_redshift = redshift
    photoncons_factor = 1.0
    photoncons_fit = None
    if photoncons_state is not None:
        if hasattr(photoncons_state, "adjusted_redshift"):
            redshift = photoncons_state.adjusted_redshift(redshift)
            photoncons_factor = float(cosmo.dicke(redshift) / cosmo.dicke(stored_redshift))
        else:
            photoncons_fit, photoncons_state = photoncons_state, None

    growth = float(cosmo.dicke(redshift))
    sc = hmf.set_scaling_constants(redshift, inputs)
    if photoncons_fit is not None:
        # ALPHA/F-PHOTONCONS: the escape parameter's Q-dependent fit (reference
        # get_fesc_fit, photoncons.c), on the ACG scaling relations only
        v = photoncons_fit.value_at(stored_redshift)
        if photoncons_fit.kind == "fesc":
            fesc_new = float(np.clip(v, 1e-6, 1.0))
            sc = dataclasses.replace(
                sc, fesc_10=fesc_new,
                Mlim_Fesc=hmf.mass_limit_where_scaling_hits_unity(sc.alpha_esc, fesc_new))
        else:
            sc = dataclasses.replace(
                sc, alpha_esc=float(v),
                Mlim_Fesc=hmf.mass_limit_where_scaling_hits_unity(float(v), sc.fesc_10))
    m_min = hmf.minimum_source_mass(redshift, inputs, xray=False)
    sigma_min = float(cosmo.sigma_z0(m_min))
    sigma_table = _get_sigma_table(inputs)
    ln_m_min, ln_m_max = np.log(m_min), np.log(hmf.M_MAX_INTEGRAL)
    hmf_int = hmf.HMF_NAMES[mo.HMF]
    mass_dep = mo.source_model_is_mass_dependent
    lagrangian = mo.source_model_uses_lagrangian_grids and halobox is not None
    ion_eff_gl = sc.pop2_ion * sc.fstar_10 * sc.fesc_10 if mass_dep else ap.HII_EFF_FACTOR
    # the halo grids already carry fesc and the pop factors (set_ionbox_constants:172-178)
    ion_eff = 1.0 if lagrangian else ion_eff_gl

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
        else torch.full(lshape, -1.0, dtype=torch.float32, device=dev)
    )

    # --- early exit: nothing ionizes (IonisationBox.c:1472-1475) ------------
    if mean_fcoll * ion_eff_gl < HII_ROUND_ERR:
        if spin_temp is not None:
            xh = 1.0 - spin_temp.xray_ionised_fraction.to(dev)
        else:
            rec_hist = RecombinationHistory(cosmo)
            xh = torch.full(
                lshape, float(1.0 - rec_hist.x_e(redshift)), dtype=torch.float32, device=dev
            )
        return IonizedBox(
            redshift=np.float32(stored_redshift),
            neutral_fraction=xh,
            z_reion=prev_z_reion,
            ionisation_rate_G12=torch.zeros(lshape, dtype=torch.float32, device=dev),
            mean_f_coll=np.float32(mean_fcoll),
            mean_f_coll_MINI=np.float32(0.0),
            log10_Mturnover_ave=np.float32(log10_mturn_ave),
            log10_Mturnover_MINI_ave=np.float32(0.0),
        )

    # --- minihalo turnover-mass grids (calculate_mcrit_boxes:403) -----------
    use_minihalos = ao.USE_MINI_HALOS and mass_dep and not lagrangian
    ion_eff_mini = sc.pop3_ion * sc.fstar_7 * sc.fesc_7
    mean_fcoll_mini = f_limit_mini = 0.0
    log10_mturn_m_ave = 0.0
    prev_mfc = prev_mfc_mini = 0.0
    if use_minihalos:
        mturn_a_box, mturn_m_box = mcrit_boxes(
            redshift, inputs, sc, previous_ionized_box, spin_temp, vcb_box, dev, lshape)
        # the stage's one host sync: the float32 box means, as the JAX
        # package takes them
        log10_mturn_ave, log10_mturn_m_ave = gops.means([mturn_a_box, mturn_m_box], shape)

        # global normalizations at the mean turnovers
        mt_a, mt_m = 10.0 ** log10_mturn_ave, 10.0 ** log10_mturn_m_ave
        mean_fcoll = float(hmf.nion_general(
            sigma_table, cosmo, hmf_int, redshift, ln_m_min, ln_m_max, mt_a, sc))
        f_limit = float(hmf.nion_general(
            sigma_table, cosmo, hmf_int, so.Z_HEAT_MAX, ln_m_min, ln_m_max, mt_a, sc))
        mean_fcoll_mini = float(hmf.nion_general_mini(
            sigma_table, cosmo, hmf_int, redshift, ln_m_min, ln_m_max, mt_m, sc))
        f_limit_mini = float(hmf.nion_general_mini(
            sigma_table, cosmo, hmf_int, so.Z_HEAT_MAX, ln_m_min, ln_m_max, mt_m, sc))

        # trapezoidal update from the previous snapshot (set_mean_fcoll:463-529):
        # MCG star formation follows the Mturn history, so the global Nion is
        # carried as Nion_prev + Nion(z, Mt) - Nion(z_prev, Mt)
        if previous_ionized_box is not None:
            prev_mfc = float(previous_ionized_box.mean_f_coll)
            prev_mfc_mini = float(previous_ionized_box.mean_f_coll_MINI)
        # the previous snapshot's adjusted redshift (Z-PHOTONCONS, which the
        # inputs refuse with USE_MINI_HALOS: kept as the JAX package has it)
        prev_z_adj = prev_redshift
        if photoncons_state is not None and prev_redshift is not None:
            prev_z_adj = photoncons_state.adjusted_redshift(prev_redshift)
        if prev_z_adj is not None and prev_mfc * ion_eff_gl > 1e-4:
            f_prev = float(hmf.nion_general(
                sigma_table, cosmo, hmf_int, prev_z_adj, ln_m_min, ln_m_max, mt_a, sc))
            mean_fcoll = prev_mfc + mean_fcoll - f_prev
        if prev_z_adj is not None and prev_mfc_mini * ion_eff_mini > 1e-4:
            f_prev_mini = float(hmf.nion_general_mini(
                sigma_table, cosmo, hmf_int, prev_z_adj, ln_m_min, ln_m_max, mt_m, sc))
            mean_fcoll_mini = prev_mfc_mini + mean_fcoll_mini - f_prev_mini

    track_nion = bool(
        use_minihalos
        and previous_ionized_box is not None
        and previous_perturbed_field is not None
        and prev_redshift is not None
        and previous_ionized_box.unnormalised_nion is not None
        and (prev_mfc * ion_eff_gl + prev_mfc_mini * ion_eff_mini) > 1e-4
    )

    ladder = setup_radii(inputs, m_min)
    n_r = ladder.n
    if track_nion and previous_ionized_box.unnormalised_nion.shape[0] != n_r:
        track_nion = False  # the radius ladder changed (m_min moved): restart
    order = np.argsort(ladder.R)[::-1]  # descending: largest R first
    l10_mturns = np.linspace(*MTURN_BOUNDS, N_MTURN_TABLE)
    use_cheby = False
    cheby_coeffs, cheby_edge = np.zeros((n_r, CHEBY_DEG + 1)), np.zeros(n_r)
    if use_minihalos:
        d_lo, d_hi, tables, caps, tables_mini, caps_mini = _build_nion_tables_mini(
            inputs, ladder, sigma_table, growth, m_min, sc, l10_mturns)
    elif mass_dep and not lagrangian:
        d_lo, d_hi, tables, caps = _build_nion_tables(
            inputs, ladder, sigma_table, growth, m_min, sc
        )
        # Chebyshev fits of the per-R log-Nion tables; the gather is the
        # fallback when a fit is poor
        cheby_coeffs, cheby_edge, use_cheby = _fit_log_cheby(tables, caps)
    else:
        d_lo, d_hi = np.zeros(n_r), np.ones(n_r)
        tables, caps = np.zeros((n_r, N_DELTA_TABLE)), np.zeros(n_r)

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
    if mass_dep and not lagrangian:
        gamma_prefactor /= sc.t_h * sc.t_star
    # Lagrangian: the 1/(rho_crit OMb) absorber factor is applied to the
    # grids below, so gamma_prefactor stays as it is (IonisationBox.c:215-218)

    use_recomb = ao.uses_recombination
    rec_box = None
    if use_recomb:
        if previous_ionized_box is not None and (
            previous_ionized_box.cumulative_recombinations is not None
        ):
            rec_box = previous_ionized_box.cumulative_recombinations.to(dev)
        else:
            rec_box = torch.zeros(lshape, dtype=torch.float32, device=dev)

    def device_rows(a):
        """Per-R table rows in scan order, flattened, as one float32 upload."""
        return torch.as_tensor(
            np.asarray(a[order], np.float32).reshape(n_r, -1), device=dev).unbind(0)

    gather_rows = (
        device_rows(tables) if mass_dep and not use_cheby and not lagrangian else [None] * n_r)
    mini = None
    if use_minihalos:
        mini_rows = device_rows(tables_mini)
        mini = dict(
            mturn_a=mturn_a_box, mturn_m=mturn_m_box,
            mean_fcoll_mini=float(_f32(mean_fcoll_mini)),
            f_limit_mini=float(_f32(f_limit_mini)),
            ion_eff_mini=float(_f32(ion_eff_mini)),
            gamma_prefactor_mini=float(_f32(
                gamma_prefactor * (ion_eff_mini / max(ion_eff_gl, 1e-30)))),
        )
    if track_nion:
        # the previous snapshot's tables, for Nion(z_prev, Mt)
        p_lo, p_hi, p_tables, p_caps, p_tables_mini, p_caps_mini = _build_nion_tables_mini(
            inputs, ladder, sigma_table, float(cosmo.dicke(prev_z_adj)), m_min, sc,
            l10_mturns)
        p_rows, p_rows_mini = device_rows(p_tables), device_rows(p_tables_mini)
        prev_delta = previous_perturbed_field.density.to(dev)
        if photoncons_state is not None:
            prev_delta = prev_delta * float(_f32(cosmo.dicke(prev_z_adj) / cosmo.dicke(prev_redshift)))
        mini.update(
            prev_delta=prev_delta,
            prev_nion=previous_ionized_box.unnormalised_nion.to(dev),
            prev_nion_mini=previous_ionized_box.unnormalised_nion_mini.to(dev),
        )

    lagr = None
    if lagrangian:
        rho_b = float(_f32(cosmo.rho_mean * cosmo.OMb / cosmo.OMm))  # Msun/Mpc^3
        lagr = dict(
            stars=halobox.n_ion.to(dev) / rho_b,
            wsfr=(halobox.whalo_sfr.to(dev) / rho_b if halobox.whalo_sfr is not None
                  else torch.zeros(lshape, dtype=torch.float32, device=dev)),
            source_filter=filters.EXP_MFP if ao.USE_EXP_FILTER else ao.hii_filter_int,
            mfp=float(_f32(25.483241248322766 / cosmo.hlittle)),  # Songaila+10 fit
        )

    # descending order (largest R first); every scalar rounded to float32
    steps = []
    for k, i in enumerate(order):
        lo, hi = _f32(d_lo[i]), _f32(d_hi[i])
        step = dict(
            idx=k,
            R=float(_f32(ladder.R[i])),
            sigma=_f32(ladder.sigma_max[i]),
            d_lo=float(lo),
            d_hi=float(hi),
            span=float(hi - lo),
            cap=float(_f32(caps[i])),
            cheb=[float(c) for c in cheby_coeffs[i].astype(np.float32)],
            cheb_edge=float(_f32(cheby_edge[i])),
            table=gather_rows[k],
        )
        if use_minihalos:
            step.update(table_mini=mini_rows[k], cap_mini=float(_f32(caps_mini[i])))
        if track_nion:
            plo, phi = _f32(p_lo[i]), _f32(p_hi[i])
            step.update(
                p_d_lo=float(plo), p_d_hi=float(phi), p_span=float(phi - plo),
                p_table=p_rows[k], p_cap=float(_f32(p_caps[i])),
                p_table_mini=p_rows_mini[k], p_cap_mini=float(_f32(p_caps_mini[i])),
            )
        steps.append(step)

    # Z-PHOTONCONS: the scan reads the density scaled to the adjusted redshift
    delta_adj = density * float(_f32(photoncons_factor)) if photoncons_factor != 1.0 else density
    scan_kwargs = dict(
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
        mini=mini,
        lagr=lagr,
        paint_spheres=ao.IONISE_ENTIRE_SPHERE,
    )
    if mesh is not None:
        from ..parallel.shardcall import sharded_kernel_call

        scan_out = sharded_kernel_call(
            mesh, _ionize_scan, (delta_adj, prev_z_reion, steps), scan_kwargs, shape)
    else:
        scan_out = _ionize_scan(delta_adj, prev_z_reion, steps, **scan_kwargs)
    xh, gamma, mfp, z_reion, nion_stack, nion_mini_stack = scan_out
    del mini, lagr, delta_adj, scan_kwargs, scan_out

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
            global_xh, global_gamma = gops.means([xh.double(), gamma.double()], shape)
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
            xh, z_reion, density, tk_neutral, scalar(ap.T_RE), scalar(stored_redshift)
        )

    return IonizedBox(
        redshift=np.float32(stored_redshift),
        neutral_fraction=xh,
        z_reion=z_reion,
        ionisation_rate_G12=gamma,
        mean_f_coll=np.float32(mean_fcoll),
        mean_f_coll_MINI=np.float32(mean_fcoll_mini),
        log10_Mturnover_ave=np.float32(log10_mturn_ave),
        log10_Mturnover_MINI_ave=np.float32(log10_mturn_m_ave),
        kinetic_temperature=kinetic_temperature,
        mean_free_path=mfp,
        cumulative_recombinations=cumulative_rec,
        unnormalised_nion=nion_stack,
        unnormalised_nion_mini=nion_mini_stack,
    )
