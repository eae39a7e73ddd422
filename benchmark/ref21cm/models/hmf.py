"""Halo mass functions, conditional MFs and source-weighted integrals.

Host-side (numpy float64, fully vectorized) equivalent of reference hmf.c +
scaling_relations.c:36-240.  On TPU these integrals are *table generators*: the
per-cell work becomes a gather/interp on device (see models/ionization.py,
models/spintemp.py), so the quadratures here run once per (z, R) — vectorized
over the condition axis instead of GSL per-point calls.

Integration uses fixed 100-node Gauss-Legendre in ln M, matching the reference
default INTEGRATION_METHOD=GAUSS-LEGENDRE (hmf.c:86-103, 699-726).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..cosmology.constants import FRACT_FLOAT_ERR, physconst
from ..cosmology.power import Cosmology, SigmaTable

# Sheth-Tormen parameters (Jenkins+01 variant used by the reference, hmf.c:46-60)
SHETH_a = 0.73
SHETH_p = 0.175
SHETH_A = 0.353
JENKINS_a = 0.73
JENKINS_b = 0.34
JENKINS_c = 0.81
SHETH_b_DEXM = 0.15
SHETH_c_DEXM = 0.05

# Watson et al. 2013 FOF fit
WATSON_A, WATSON_ALPHA, WATSON_BETA, WATSON_GAMMA = 0.282, 2.163, 1.406, 1.210

M_MIN_INTEGRAL = 1e5
M_MAX_INTEGRAL = 1e16
MAX_DELTAC_FRAC = 0.99

HMF_PS, HMF_ST, HMF_WATSON, HMF_WATSON_Z, HMF_DELOS, HMF_REED07, HMF_YUNG24 = range(7)
HMF_NAMES = {"PS": 0, "ST": 1, "WATSON": 2, "WATSON-Z": 3, "DELOS": 4, "REED07": 5, "YUNG24": 6}

_N_GL = 100
_GL_X, _GL_W = np.polynomial.legendre.leggauss(_N_GL)


@dataclasses.dataclass
class ScalingConstants:
    """Precomputed galaxy scaling-relation constants at one redshift
    (reference scaling_relations.c:36-119)."""

    redshift: float
    fstar_10: float
    alpha_star: float
    sigma_star: float
    alpha_upper: float
    pivot_upper: float
    upper_pivot_ratio: float
    fstar_7: float
    alpha_star_mini: float
    t_h: float
    t_star: float
    sigma_sfr_lim: float
    sigma_sfr_idx: float
    l_x: float
    l_x_mini: float
    sigma_xray: float
    alpha_esc: float
    fesc_10: float
    fesc_7: float
    pop2_ion: float
    pop3_ion: float
    acg_thresh: float
    mturn_a_nofb: float
    mturn_m_nofb: float
    vcb_const: float
    Mlim_Fstar: float
    Mlim_Fesc: float
    Mlim_Fstar_mini: float = 0.0
    Mlim_Fesc_mini: float = 0.0
    # mean |v_cb| at decoupling [km/s] (cosmo_tables_global->V_CB_AVG):
    # normalizes the Schauer+20 f_vcb in lyman_werner_threshold
    v_cb_avg: float = 27.0

    def without_esc(self) -> "ScalingConstants":
        sc = dataclasses.replace(self)
        sc.fesc_10 = 1.0
        sc.fesc_7 = 1.0
        sc.alpha_esc = 0.0
        sc.Mlim_Fesc = 0.0
        sc.Mlim_Fesc_mini = 0.0
        return sc


def atomic_cooling_threshold(z: float) -> float:
    """Minimum ACG mass: Tvir = 1e4 K halo (thermochem.c)."""
    # M = TtoM(z, 1e4, 0.59) is the reference expression; we need a cosmology
    # instance, so this lives on ScalingConstants construction (see below).
    raise NotImplementedError("use set_scaling_constants")


def mass_limit_where_scaling_hits_unity(alpha: float, norm: float) -> float:
    """M where norm*(M/1e10)^alpha == 1, clamped to the integral limits.

    Closed form of reference Mass_limit_bisection (hmf.c:1274-1314)."""
    if alpha > 0:
        if norm * (M_MAX_INTEGRAL / 1e10) ** alpha <= 1.0:
            return M_MAX_INTEGRAL
        return 1e10 * norm ** (-1.0 / alpha)
    if alpha < 0:
        if norm * (M_MIN_INTEGRAL / 1e10) ** alpha <= 1.0:
            return M_MIN_INTEGRAL
        return 1e10 * norm ** (-1.0 / alpha)
    return 0.0


def lyman_werner_threshold(z, J_21_LW, vcb, astro_params, v_cb_avg=27.0) -> np.ndarray:
    """Minimum MCG mass under LW feedback + relative velocities
    (reference thermochem.c lyman_werner_threshold; Munoz+21 eq. 12)."""
    # Visbal+15 fit: 3.314e7 (1+z)^-1.5 — NOT pivoted at z=20
    # (thermochem.c:281-303)
    mcrit_noLW = 3.314e7 * (1.0 + z) ** -1.5
    f_LW = 1.0 + astro_params.A_LW * np.power(np.maximum(J_21_LW, 0.0), astro_params.BETA_LW)
    mcrit = mcrit_noLW * f_LW
    # vcb normalized by the rms speed at kinematic decoupling:
    # sigma_vcb = V_CB_AVG * sqrt(3 pi / 8) ~ 29.3 km/s for Planck18
    # (thermochem.c:295, reading cosmo_tables_global->V_CB_AVG)
    sigmavcb = v_cb_avg * np.sqrt(3.0 * np.pi / 8.0)
    f_vcb = (1.0 + astro_params.A_VCB * vcb / sigmavcb) ** astro_params.BETA_VCB
    return mcrit * f_vcb


def set_scaling_constants(z: float, inputs, flag_options_esc=True) -> ScalingConstants:
    ap = inputs.astro_params
    ao = inputs.astro_options
    cosmo = inputs.cosmology

    acg_thresh = float(cosmo.TtoM(z, 1e4, 0.59))
    mturn_a = ap.m_turn
    if ao.USE_MINI_HALOS:
        mturn_a = max(acg_thresh, mturn_a)
    # constant relative velocity entering scalar Mturn consumers (reference
    # scaling_relations.c:85-98): the AVG models pin it; FLUCTS uses the
    # per-cell box wherever one is wired, so its CONSTANT must be 0 — using
    # the mean speed here would double-suppress MCGs through the
    # mturn_m_nofb floor (f_vcb(25.86 km/s) ~ 3x)
    if inputs.matter_options.V_CB_MODEL == "AVG-DEBUG":
        vcb_const = ap.V_CB_AVG_DEBUG
    elif inputs.matter_options.V_CB_MODEL == "AVG-AUTO":
        vcb_const = cosmo.V_CB_AVG
    else:  # NONE or FLUCTS
        vcb_const = 0.0
    mturn_m = 0.0
    if ao.USE_MINI_HALOS:
        mturn_m = float(
            lyman_werner_threshold(z, 0.0, vcb_const, ap, v_cb_avg=cosmo.V_CB_AVG)
        )

    fstar_7 = ap.fstar_7
    alpha_mini = ap.alpha_star_mini
    return ScalingConstants(
        redshift=z,
        fstar_10=ap.fstar_10,
        alpha_star=ap.ALPHA_STAR,
        sigma_star=ap.SIGMA_STAR,
        alpha_upper=ap.UPPER_STELLAR_TURNOVER_INDEX,
        pivot_upper=ap.upper_stellar_turnover_mass,
        upper_pivot_ratio=(
            (ap.upper_stellar_turnover_mass / 1e10) ** ap.ALPHA_STAR
            + (ap.upper_stellar_turnover_mass / 1e10) ** ap.UPPER_STELLAR_TURNOVER_INDEX
        ),
        fstar_7=fstar_7,
        alpha_star_mini=alpha_mini,
        t_h=float(cosmo.t_hubble(z)),
        t_star=ap.t_STAR,
        sigma_sfr_lim=ap.SIGMA_SFR_LIM,
        sigma_sfr_idx=ap.SIGMA_SFR_INDEX,
        l_x=ap.l_x * 1e-38,
        l_x_mini=ap.l_x_mini * 1e-38,
        sigma_xray=ap.SIGMA_LX,
        alpha_esc=ap.ALPHA_ESC,
        fesc_10=ap.fesc_10,
        fesc_7=ap.fesc_7,
        pop2_ion=ap.POP2_ION,
        pop3_ion=ap.POP3_ION,
        acg_thresh=acg_thresh,
        mturn_a_nofb=mturn_a,
        mturn_m_nofb=mturn_m,
        vcb_const=vcb_const,
        v_cb_avg=float(cosmo.V_CB_AVG),
        Mlim_Fstar=mass_limit_where_scaling_hits_unity(ap.ALPHA_STAR, ap.fstar_10),
        Mlim_Fesc=mass_limit_where_scaling_hits_unity(ap.ALPHA_ESC, ap.fesc_10),
        Mlim_Fstar_mini=mass_limit_where_scaling_hits_unity(
            alpha_mini, fstar_7 * 1e3**alpha_mini
        ),
        Mlim_Fesc_mini=mass_limit_where_scaling_hits_unity(
            ap.ALPHA_ESC, ap.fesc_7 * 1e3**ap.ALPHA_ESC
        ),
    )


# ---------------------------------------------------------------------------
# Barriers


def sheth_delc_dexm(delta, sigma):
    """ST-like moving barrier fit used by the DexM halo finder (hmf.c:143-146)."""
    return np.sqrt(SHETH_a) * delta * (
        1.0 + SHETH_b_DEXM * (sigma * sigma / (SHETH_a * delta * delta)) ** SHETH_c_DEXM
    )


def sheth_delc_fixed(delta, sigma):
    """Jenkins-parameter moving barrier (hmf.c:151-154)."""
    return np.sqrt(JENKINS_a) * delta * (
        1.0 + JENKINS_b * (sigma * sigma / (JENKINS_a * delta * delta)) ** JENKINS_c
    )


def get_delta_crit(hmf: int, sigma, growthf):
    """Excursion-set barrier for the chosen HMF (hmf.c:166-171)."""
    if hmf == HMF_DELOS:
        return np.broadcast_to(physconst.delta_c_delos, np.shape(sigma)).copy()
    if hmf == HMF_ST:
        return sheth_delc_fixed(physconst.delta_c_sph / growthf, sigma) * growthf
    return np.broadcast_to(physconst.delta_c_sph, np.shape(sigma)).copy()


def euler_to_lagrangian_delta(delta):
    """Mo & White 1996 spherical-evolution fit (hmf.c:174-178)."""
    dp1 = np.asarray(delta) + 1.0
    return (
        -1.35 * dp1 ** (-2.0 / 3.0)
        + 0.78785 * dp1**-0.58661
        - 1.12431 / np.sqrt(dp1)
        + 1.68647
    )


# ---------------------------------------------------------------------------
# Unconditional mass functions: return (1/rho_mean) dn/dlnM * M  == d f_coll/dlnM / M * M
# i.e. integrating `umf(lnM)` over lnM gives number density / rho_mean; multiplying
# the integrand by M gives the collapsed fraction (reference convention).


def _sigma_terms(table: SigmaTable, ln_m, growthf):
    sigma = table.sigma_of_lnm(ln_m) * growthf
    dsigmadm = table.dsigmasq_of_lnm(ln_m) * (growthf**2 / (2.0 * sigma))
    return sigma, dsigmadm


def dNdlnM_PS(table, growthf, ln_m):
    sigma, dsigmadm = _sigma_terms(table, ln_m, growthf)
    dc = physconst.delta_c_sph
    return (
        -np.sqrt(2 / np.pi) * (dc / sigma**2) * dsigmadm * np.exp(-(dc**2) / (2 * sigma**2))
    )


def dNdlnM_ST(table, growthf, ln_m):
    sigma, dsigmadm = _sigma_terms(table, ln_m, growthf)
    nuhat = np.sqrt(SHETH_a) * physconst.delta_c_sph / sigma
    return (
        -(dsigmadm / sigma)
        * np.sqrt(2.0 / np.pi)
        * SHETH_A
        * (1 + nuhat ** (-2 * SHETH_p))
        * nuhat
        * np.exp(-nuhat * nuhat / 2.0)
    )


def dNdlnM_Watson(table, growthf, ln_m):
    sigma, dsigmadm = _sigma_terms(table, ln_m, growthf)
    f_sigma = WATSON_A * ((WATSON_BETA / sigma) ** WATSON_ALPHA + 1.0) * np.exp(
        -WATSON_GAMMA / sigma**2
    )
    return -(dsigmadm / sigma) * f_sigma


def dNdlnM_Watson_z(table, cosmo: Cosmology, z, growthf, ln_m):
    sigma, dsigmadm = _sigma_terms(table, ln_m, growthf)
    om_z = cosmo.omega_mz(z)
    A_z = om_z * (0.990 * (1 + z) ** -3.216 + 0.074)
    alpha_z = om_z * (5.907 * (1 + z) ** -3.058 + 2.349)
    beta_z = om_z * (3.136 * (1 + z) ** -3.599 + 2.344)
    f_sigma = A_z * ((beta_z / sigma) ** alpha_z + 1.0) * np.exp(-1.318 / sigma**2)
    return -(dsigmadm / sigma) * f_sigma


def dNdlnM_Delos(table, growthf, ln_m):
    sigma = table.sigma_of_lnm(ln_m)
    sigma_inv = 1.0 / sigma
    dsigmadm = table.dsigmasq_of_lnm(ln_m) * 0.5 * sigma_inv
    nu = physconst.delta_c_delos * sigma_inv / growthf
    dfdnu = 0.519 * nu**0.582 * np.exp(-0.469 * nu * nu)
    return dfdnu * np.abs(dsigmadm) * sigma_inv


def dNdlnM_Reed07(table, growthf, ln_m):
    sigma0 = table.sigma_of_lnm(ln_m)
    sigma = sigma0 * growthf
    dsigmadm = table.dsigmasq_of_lnm(ln_m) * (growthf**2 / (2.0 * sigma))
    dlnsdlnm = -np.exp(ln_m) * table.dsigmasq_of_lnm(ln_m) / (2.0 * sigma0 * sigma0)
    neff = -3.0 * (2.0 * dlnsdlnm + 1.0)
    nu = physconst.delta_c_sph / sigma
    lnsigma = -np.log(sigma)
    G1 = np.exp(-((lnsigma - 0.4) ** 2) / 0.72)
    G2 = np.exp(-((lnsigma - 0.75) ** 2) / 0.08)
    a_pre = 0.764 / 1.08
    f_sigma = (
        0.3222
        * np.sqrt(2 * a_pre / np.pi)
        * (1.0 + (1.0 / (a_pre * nu * nu)) ** 0.3 + 0.6 * G1 + 0.4 * G2)
        * nu
        * np.exp(-1.08 * a_pre * nu * nu / 2.0 - 0.03 * nu**0.6 / (neff + 3.0) ** 2)
    )
    return -(dsigmadm / sigma) * f_sigma


def dNdlnM_Yung24(table, z, growthf, ln_m):
    sigma = table.sigma_of_lnm(ln_m) * growthf
    dsigmadm = table.dsigmasq_of_lnm(ln_m) * (growthf**2 / (2.0 * sigma))
    A_z = 0.13765772 - 0.01003821 * z + 0.00102964 * z * z
    a_z = 1.06641384 + 0.02475576 * z - 0.00283342 * z * z
    b_z = 4.86693806 + 0.09212356 * z - 0.01426283 * z * z
    c_z = 1.19837952 - 0.00142967 * z - 0.00033074 * z * z
    f_sigma = A_z * ((sigma / b_z) ** -a_z + 1.0) * np.exp(-c_z / sigma**2)
    return -(dsigmadm / sigma) * f_sigma


def unconditional_mf(table, cosmo, hmf: int, z, growthf, ln_m):
    if hmf == HMF_PS:
        return dNdlnM_PS(table, growthf, ln_m)
    if hmf == HMF_ST:
        return dNdlnM_ST(table, growthf, ln_m)
    if hmf == HMF_WATSON:
        return dNdlnM_Watson(table, growthf, ln_m)
    if hmf == HMF_WATSON_Z:
        return dNdlnM_Watson_z(table, cosmo, z, growthf, ln_m)
    if hmf == HMF_DELOS:
        return dNdlnM_Delos(table, growthf, ln_m)
    if hmf == HMF_REED07:
        return dNdlnM_Reed07(table, growthf, ln_m)
    if hmf == HMF_YUNG24:
        return dNdlnM_Yung24(table, z, growthf, ln_m)
    raise ValueError(f"unknown HMF {hmf}")


# ---------------------------------------------------------------------------
# Conditional mass functions (per unit condition Lagrangian mass fraction)


def cond_mf_EPS(table, growthf, ln_m, delta_cond, sigma_cond):
    """EPS conditional MF, constant barrier (hmf.c:317-330).

    delta_cond/sigma_cond broadcast against ln_m."""
    sigma1 = table.sigma_of_lnm(ln_m)
    dsigmasqdm = table.dsigmasq_of_lnm(ln_m)
    sigdiff = sigma1**2 - sigma_cond**2
    sigdiff_inv = np.where(sigdiff > 0, 1.0 / np.where(sigdiff > 0, sigdiff, 1.0), 1e6)
    del_ = (physconst.delta_c_sph - delta_cond) / growthf
    out = (
        -del_
        * dsigmasqdm
        * sigdiff_inv**1.5
        * np.exp(-del_ * del_ * 0.5 * sigdiff_inv)
        / np.sqrt(2.0 * np.pi)
    )
    return np.where(sigma1 < sigma_cond, 0.0, out)


def _st_taylor_factor(sig, sig_cond, growthf):
    """Taylor-expanded moving-barrier factor for the ST CMF (hmf.c:234-267)."""
    a, alpha, beta = JENKINS_a, JENKINS_c, JENKINS_b
    del_ = physconst.delta_c_sph / growthf
    sigsq = sig * sig
    sigsq_inv = 1.0 / sigsq
    sigdiff = np.where(sig == sig_cond, 1e-6, sigsq - sig_cond**2)

    t = np.ones_like(sig)
    result = np.ones_like(sig)
    for i in range(1, 6):
        t = t * (-sigdiff) / i * (alpha - i + 1) * sigsq_inv
        result = result + t
    pre1 = np.sqrt(a) * del_
    pre2 = beta * (sigsq_inv * (a * del_ * del_)) ** -alpha
    barrier = pre1 * (1 + pre2)
    return pre1 * (1 + pre2 * result), barrier


def cond_mf_ST(table, growthf, ln_m, delta_cond, sigma_cond):
    """Sheth-Tormen conditional MF via barrier Taylor expansion (hmf.c:270-285)."""
    sigma1 = table.sigma_of_lnm(ln_m)
    dsigmasqdm = table.dsigmasq_of_lnm(ln_m)
    delta_0 = delta_cond / growthf
    factor, barrier = _st_taylor_factor(sigma1, sigma_cond, growthf)
    factor = factor - delta_0
    sigdiff = sigma1**2 - sigma_cond**2
    sigdiff_inv = np.where(sigdiff > 0, 1.0 / np.where(sigdiff > 0, sigdiff, 1.0), 1e6)
    out = (
        -dsigmasqdm
        * factor
        * sigdiff_inv**1.5
        * np.exp(-((barrier - delta_0) ** 2) * 0.5 * sigdiff_inv)
        / np.sqrt(2.0 * np.pi)
    )
    return np.where(sigma1 < sigma_cond, 0.0, out)


def cond_mf_Delos(table, growthf, ln_m, delta_cond, sigma_cond):
    """Delos 2023 conditional MF (hmf.c:209-229)."""
    sigma = table.sigma_of_lnm(ln_m)
    dsigmadm = table.dsigmasq_of_lnm(ln_m) * 0.5
    sigdiff = sigma**2 - sigma_cond**2
    sigdiff_inv = np.where(sigdiff > 0, 1.0 / np.where(sigdiff > 0, sigdiff, 1.0), 1e6)
    nu = (physconst.delta_c_delos - delta_cond) * np.sqrt(sigdiff_inv) / growthf
    dfdnu = 0.519 * nu**0.582 * np.exp(-0.469 * nu * nu)
    out = dfdnu * np.abs(dsigmadm) * sigdiff_inv
    return np.where(sigma < sigma_cond, 0.0, out)


def conditional_mf(table, hmf: int, growthf, ln_m, delta_cond, sigma_cond):
    if hmf == HMF_ST:
        return cond_mf_ST(table, growthf, ln_m, delta_cond, sigma_cond)
    if hmf == HMF_DELOS:
        return cond_mf_Delos(table, growthf, ln_m, delta_cond, sigma_cond)
    # EPS fallback for all others (normalization applied per-condition upstream)
    return cond_mf_EPS(table, growthf, ln_m, delta_cond, sigma_cond)


# ---------------------------------------------------------------------------
# Scaling-relation weights for the integrands (log-space single power laws with
# saturation at scaling==1; reference scaling_relations.c:209-231)


def _log_pl_limited(ln_m, ln_norm, alpha, ln_pivot, ln_limit):
    raw = alpha * (ln_m - ln_pivot)
    if alpha > 0:
        return np.where(ln_m > ln_limit, -ln_norm, raw)
    if alpha < 0:
        return np.where(ln_m < ln_limit, -ln_norm, raw)
    return np.zeros_like(ln_m)


def nion_weight(ln_m, sc: ScalingConstants, mturn_acg):
    """M * f_star(M)/f_star10 * f_esc(M)/f_esc10 * exp(-Mturn/M)  (hmf.c:462-468)."""
    ln10 = np.log(10.0)
    fstar = _log_pl_limited(ln_m, np.log(sc.fstar_10), sc.alpha_star, 10 * ln10,
                            np.log(max(sc.Mlim_Fstar, 1e-99)))
    fesc = _log_pl_limited(ln_m, np.log(sc.fesc_10), sc.alpha_esc, 10 * ln10,
                           np.log(max(sc.Mlim_Fesc, 1e-99)))
    return np.exp(fstar + fesc - mturn_acg / np.exp(ln_m) + ln_m)


def nion_weight_mini(ln_m, sc: ScalingConstants, mturn_mcg):
    ln10 = np.log(10.0)
    m = np.exp(ln_m)
    fstar = _log_pl_limited(ln_m, np.log(sc.fstar_7), sc.alpha_star_mini, 7 * ln10,
                            np.log(max(sc.Mlim_Fstar_mini, 1e-99)))
    fesc = _log_pl_limited(ln_m, np.log(sc.fesc_7), sc.alpha_esc, 7 * ln10,
                           np.log(max(sc.Mlim_Fesc_mini, 1e-99)))
    return np.exp(fstar + fesc - m / sc.acg_thresh - mturn_mcg / m + ln_m)


# ---------------------------------------------------------------------------
# Integration


def _gl_nodes(ln_lo, ln_hi):
    """GL nodes/weights on [ln_lo, ln_hi]; broadcasts over leading dims of limits."""
    ln_lo = np.asarray(ln_lo, dtype=np.float64)
    ln_hi = np.asarray(ln_hi, dtype=np.float64)
    mid = 0.5 * (ln_hi + ln_lo)
    half = 0.5 * (ln_hi - ln_lo)
    x = mid[..., None] + half[..., None] * _GL_X
    w = half[..., None] * _GL_W
    return x, w


def integrate_umf(table, cosmo, hmf, z, ln_lo, ln_hi, weight_fn=None):
    growthf = float(cosmo.dicke(z))
    x, w = _gl_nodes(ln_lo, ln_hi)
    f = unconditional_mf(table, cosmo, hmf, z, growthf, x)
    if weight_fn is not None:
        f = f * weight_fn(x)
    return np.sum(f * w, axis=-1)


def fcoll_general(table, cosmo, hmf, z, ln_lo, ln_hi):
    """Global collapsed fraction (reference Fcoll_General, hmf.c:945-953)."""
    return integrate_umf(table, cosmo, hmf, z, ln_lo, ln_hi, weight_fn=np.exp)


def nhalo_general(table, cosmo, hmf, z, ln_lo, ln_hi):
    return integrate_umf(table, cosmo, hmf, z, ln_lo, ln_hi)


def nion_general(table, cosmo, hmf, z, ln_lo, ln_hi, mturn_acg, sc: ScalingConstants,
                 method="GAUSS-LEGENDRE"):
    """Global ionizing emissivity integral (reference Nion_General, hmf.c:955-971).

    Returns the *relative* Nion (normalized s.t. scaling relations are 1 at the
    pivots); multiply by pop2_ion*fstar_10*fesc_10 for the efficiency."""
    if method == "GAMMA-APPROX":
        return mf_integral_approx(
            table, float(cosmo.dicke(z)), ln_lo, ln_hi, 0.0, 0.0,
            sc.alpha_star + sc.alpha_esc,
            ln_mturn_l=np.log(np.maximum(np.asarray(mturn_acg, dtype=np.float64), 1.0)),
            ln_pivot_norm=np.log(1e10),
        )
    return integrate_umf(
        table, cosmo, hmf, z, ln_lo, ln_hi, weight_fn=lambda x: nion_weight(x, sc, mturn_acg)
    )


def nion_general_mini(table, cosmo, hmf, z, ln_lo, ln_hi, mturn_mcg, sc: ScalingConstants,
                      method="GAUSS-LEGENDRE"):
    if method == "GAMMA-APPROX":
        return mf_integral_approx(
            table, float(cosmo.dicke(z)), ln_lo, ln_hi, 0.0, 0.0,
            sc.alpha_star_mini + sc.alpha_esc, mini=True,
            ln_mturn_l=np.log(np.maximum(np.asarray(mturn_mcg, dtype=np.float64), 1.0)),
            ln_mturn_u=np.log(sc.acg_thresh),
            ln_pivot_norm=np.log(1e7),
        )
    return integrate_umf(
        table, cosmo, hmf, z, ln_lo, ln_hi,
        weight_fn=lambda x: nion_weight_mini(x, sc, mturn_mcg),
    )


def integrate_cmf(table, hmf, growthf, ln_lo, ln_hi, delta, sigma_cond, weight_fn=None):
    """Conditional-MF integral, vectorized over the condition arrays
    (delta, sigma_cond, and optionally ln_hi share a leading shape)."""
    x, w = _gl_nodes(ln_lo * np.ones_like(np.asarray(delta, dtype=np.float64)), ln_hi)
    d = np.asarray(delta, dtype=np.float64)[..., None]
    s = np.asarray(sigma_cond, dtype=np.float64)[..., None]
    f = conditional_mf(table, hmf, growthf, x, d, s)
    if weight_fn is not None:
        f = f * weight_fn(x)
    return np.sum(f * w, axis=-1)


def nion_conditional(
    table, hmf, growthf, ln_lo, ln_m_cond, sigma_cond, delta, mturn_acg,
    sc: ScalingConstants, mini=False, ln_hi=None, method="GAUSS-LEGENDRE",
):
    """Conditional Nion per condition (reference Nion_ConditionalM, hmf.c:1106-1140),
    vectorized over `delta`.  Handles the delta > 0.99*delta_crit cap by returning
    the single-halo-at-condition-mass value.

    `ln_hi` optionally restricts the integral's upper bound below the condition
    mass (the sub-resolution source-grid range of HaloBox.c:set_fixed_grids,
    [minimum_source_mass, SAMPLER_MIN_MASS] conditioned on the cell mass);
    collapsed cells (delta above the cap) then contribute 0, since the single
    halo at the condition mass lies outside the integral range (hmf.c:1126-1134)."""
    if hmf not in (HMF_PS, HMF_ST, HMF_DELOS):
        hmf = HMF_PS
    if ln_hi is None:
        ln_hi = ln_m_cond
    weight = (lambda x: nion_weight_mini(x, sc, mturn_acg)) if mini else (
        lambda x: nion_weight(x, sc, mturn_acg)
    )
    if method == "GAMMA-APPROX":
        index_base = (sc.alpha_star_mini if mini else sc.alpha_star) + sc.alpha_esc
        out = mf_integral_approx(
            table, growthf, ln_lo, ln_hi, delta, sigma_cond, index_base,
            mini=mini,
            ln_mturn_l=np.log(np.maximum(np.asarray(mturn_acg, dtype=np.float64), 1.0)),
            ln_mturn_u=np.log(sc.acg_thresh) if mini else None,
            ln_pivot_norm=np.log(1e7) if mini else np.log(1e10),
        )
    else:
        out = integrate_cmf(
            table, hmf, growthf, ln_lo, ln_hi, delta, sigma_cond, weight_fn=weight
        )
    delta_crit = get_delta_crit(hmf, sigma_cond, growthf)
    cap_value = (
        weight(np.asarray([ln_m_cond]))[0] / np.exp(ln_m_cond)
        if ln_m_cond * (1.0 - FRACT_FLOAT_ERR) <= ln_hi
        else 0.0
    )
    out = np.where(np.asarray(delta) > MAX_DELTAC_FRAC * delta_crit, cap_value, out)
    return np.where(ln_lo >= ln_hi, 0.0, out)


# ---------------------------------------------------------------------------
# GAMMA-APPROX integration (Munoz+22 2110.13919 app. B; reference
# MFIntegral_Approx, hmf.c:728-895).  EPS-only: assumes sharp turnover cutoffs
# and a triple power-law nu(M), so each mass segment integrates to an upper
# incomplete gamma function.  Valid for single-power-law scaling relations
# (Nhalo/Fcoll/Nion/Nion_MINI) — exactly the integrals the reference's
# INTEGRATION_METHOD_ATOMIC/MINI flags gate.

MPIVOT1 = 1.5e9  # nu(M) power-law pivot masses (hmf.c:97-101)
MPIVOT2 = 5.3e5
AINDEX1 = 9.0  # d lnM / d ln nu * 2 above MPIVOT1
AINDEX2 = 13.6  # between MPIVOT2 and MPIVOT1
AINDEX3 = 21.0  # below MPIVOT2


def _upper_gamma(a: float, x):
    """Unregularized upper incomplete gamma Γ(a, x), scalar `a` (any real,
    gsl_sf_gamma_inc semantics: negative non-integer a allowed), array x>0."""
    from scipy.special import gamma as _gammafn, gammaincc

    x = np.asarray(x, dtype=np.float64)
    n = 0
    while a + n <= 0:
        n += 1
    out = gammaincc(a + n, x) * _gammafn(a + n)
    # downward recurrence Γ(a,x) = (Γ(a+1,x) - x^a e^-x)/a
    for k in range(n, 0, -1):
        ak = a + k - 1
        out = (out - x**ak * np.exp(-x)) / ak
    return out


def _fcoll_approx(nu_min, beta):
    """∫_{νmin}^∞ ν^β e^{-ν/2} / sqrt(2πν) dν  (reference Fcollapprox,
    hmf.c:732-737)."""
    nu_min = np.maximum(np.asarray(nu_min, dtype=np.float64), 1e-14)
    return _upper_gamma(0.5 + beta, 0.5 * nu_min) * 2.0 ** (0.5 + beta) / np.sqrt(2.0 * np.pi)


def _fcoll_approx_condition(nu_min, nu_cond, beta):
    """Tail above the effective condition pivot uses the β=0 (erfc) form
    (reference Fcollapprox_condition, hmf.c:739-746)."""
    return (
        _fcoll_approx(nu_min, beta)
        - _fcoll_approx(nu_cond, beta)
        + _fcoll_approx(nu_cond, 0.0) * np.maximum(nu_cond, 1e-14) ** beta
    )


def mf_integral_approx(
    table,
    growthf,
    ln_lo,
    ln_hi,
    delta,
    sigma_cond,
    index_base,
    mini=False,
    ln_mturn_l=None,
    ln_mturn_u=None,
    ln_pivot_norm=None,
):
    """Gamma-function EPS approximation to the conditional mass-weighted MF
    integral with weight (M/M_norm)^index_base (reference MFIntegral_Approx,
    hmf.c:752-895), vectorized over the condition arrays.

    `index_base` is 0 for fcoll, -1 for nhalo, alpha_star(+_mini)+alpha_esc for
    Nion; turnovers become sharp cutoffs (`ln_mturn_l` lower for Nion,
    `ln_mturn_u` upper for the minihalo atomic threshold).  The unconditional
    integral is the sigma_cond=0, delta=0 special case.

    The reference normalizes the power-law weight at its own nu-pivots; since
    every consumer mean-fixes the grids to a QAG global expectation
    (IonisationBox.c:153 fix_mean, Ts ST_over_PS), only the delta-shape
    matters there.  We additionally rescale by (MPIVOT1/M_norm)^index_base
    (`ln_pivot_norm` = ln M_norm) so magnitudes are directly comparable with
    the GAUSS-LEGENDRE path's pivot convention (1e10 ACG / 1e7 MCG)."""
    d = np.asarray(delta, dtype=np.float64)
    sc_ = np.asarray(sigma_cond, dtype=np.float64)
    lo = np.broadcast_to(np.asarray(ln_lo, dtype=np.float64), np.broadcast_shapes(
        np.shape(ln_lo), d.shape, sc_.shape, np.shape(ln_hi))).copy()
    hi = np.broadcast_to(np.asarray(ln_hi, dtype=np.float64), lo.shape).copy()
    d = np.broadcast_to(d, lo.shape)
    sc_ = np.broadcast_to(sc_, lo.shape)
    if ln_mturn_l is not None:
        lo = np.maximum(lo, np.asarray(ln_mturn_l, dtype=np.float64))
    if mini and ln_mturn_u is not None:
        hi = np.minimum(hi, np.asarray(ln_mturn_u, dtype=np.float64))

    sig_lo = table.sigma_of_lnm(lo)
    sig_hi = table.sigma_of_lnm(hi)
    sig_p1 = float(table.sigma_of_lnm(np.log(MPIVOT1)))
    sig_p2 = float(table.sigma_of_lnm(np.log(MPIVOT2)))
    empty = (lo >= hi) | (sig_lo <= sc_)

    delta_arg = ((physconst.delta_c_sph - d) / growthf) ** 2
    beta1 = index_base * AINDEX1 * 0.5
    beta2 = index_base * AINDEX2 * 0.5
    beta3 = index_base * AINDEX3 * 0.5

    sc2 = sc_**2
    tiny = 1e-20
    # unconditional nu (no sigma_cond subtraction) for the weight normalization
    nu_p1_umf = delta_arg / sig_p1**2
    nu_p2_umf = delta_arg / sig_p2**2
    nu_condition = delta_arg / np.maximum(sc2, tiny)
    # conditional (tilde) nu at the pivots and limits
    nu_p1 = delta_arg / np.maximum(sig_p1**2 - sc2, tiny)
    nu_p2 = delta_arg / np.maximum(sig_p2**2 - sc2, tiny)
    nu_lo = delta_arg / np.maximum(sig_lo**2 - sc2, tiny)
    nu_hi = delta_arg / np.maximum(sig_hi**2 - sc2, tiny)

    if mini:
        # hmf.c:846-864: minihalos never reach the high-mass power law
        res_below = (_fcoll_approx(nu_lo, beta3) - _fcoll_approx(nu_hi, beta3)) * nu_p2_umf ** (
            -beta3
        )
        res_above = -_fcoll_approx(nu_hi, beta2) * nu_p1_umf ** (-beta2) + np.where(
            nu_lo > nu_p2,
            _fcoll_approx(nu_lo, beta2) * nu_p1_umf ** (-beta2),
            _fcoll_approx(nu_p2, beta2) * nu_p1_umf ** (-beta2)
            + (_fcoll_approx(nu_lo, beta3) - _fcoll_approx(nu_p2, beta3)) * nu_p2_umf ** (-beta3),
        )
        fcoll = np.where(nu_hi <= nu_p2, res_below, res_above)
    else:
        # hmf.c:866-889
        res_mid = _fcoll_approx_condition(nu_p1, nu_condition, beta1) * nu_p1_umf ** (
            -beta1
        ) + np.where(
            nu_lo > nu_p2,
            (_fcoll_approx(nu_lo, beta2) - _fcoll_approx(nu_p1, beta2)) * nu_p1_umf ** (-beta2),
            (_fcoll_approx(nu_p2, beta2) - _fcoll_approx(nu_p1, beta2)) * nu_p1_umf ** (-beta2)
            + (_fcoll_approx(nu_lo, beta3) - _fcoll_approx(nu_p2, beta3)) * nu_p2_umf ** (-beta3),
        )
        fcoll = np.where(
            nu_lo >= nu_condition,
            _fcoll_approx(nu_lo, 0.0),
            np.where(
                nu_lo >= nu_p1,
                _fcoll_approx_condition(nu_lo, nu_condition, beta1) * nu_p1_umf ** (-beta1),
                res_mid,
            ),
        )

    fcoll = np.where(empty, 0.0, np.maximum(fcoll, 1e-40))
    if ln_pivot_norm is not None:
        fcoll = fcoll * np.exp(index_base * (np.log(MPIVOT1) - ln_pivot_norm))
    return fcoll


def dfcoll_dz(cosmo, z, delta, sigma_min, sigma_cond, dz=0.001):
    """Redshift derivative of the conditional EPS collapsed fraction
    (reference dfcoll_dz, hmf.c:1253-1266): central difference of
    FgtrM_bias_fast.  Negative (fcoll falls with z); the Ts const-ion-eff
    path multiplies by the (positive) shell dz and flips sign."""
    fc1 = fcoll_conditional_eps(float(cosmo.dicke(z + dz)), delta, sigma_min, sigma_cond)
    fc2 = fcoll_conditional_eps(float(cosmo.dicke(z - dz)), delta, sigma_min, sigma_cond)
    return (fc1 - fc2) / (2.0 * dz)


def fcoll_conditional_eps(growthf, delta, sigma_min, sigma_cond):
    """Closed-form conditional EPS collapsed fraction: the erfc expression used
    for the CONST-ION-EFF fcoll grid (reference FgtrM_bias_fast, hmf.c:1221-1241)."""
    from scipy.special import erfc

    sigdiff = np.sqrt(np.maximum(sigma_min**2 - sigma_cond**2, 1e-30))
    del_ = (physconst.delta_c_sph - delta) / growthf
    out = erfc(del_ / (np.sqrt(2) * sigdiff))
    return np.where(sigma_cond >= sigma_min, 0.0, out)


def minimum_source_mass(z: float, inputs, xray: bool = False) -> float:
    """Reference minimum_source_mass (hmf.c:1319-1348)."""
    ap = inputs.astro_params
    ao = inputs.astro_options
    mo = inputs.matter_options
    if mo.source_model_is_mass_dependent and not ao.USE_MINI_HALOS:
        min_factor = 50.0
    else:
        min_factor = 1.0
    if ao.USE_MINI_HALOS:
        m_min = M_MIN_INTEGRAL
    elif ao.M_MIN_in_Mass:
        m_min = ap.m_turn
    else:
        t_vir = ap.x_ray_tvir_min if xray else ap.ion_tvir_min
        mu = 1.22 if t_vir < 9.99999e3 else 0.6
        m_min = float(inputs.cosmology.TtoM(z, t_vir, mu))
    return m_min / min_factor


# ---------------------------------------------------------------------------
# Halo-sampler tables (reference interp_tables.c:580-800)


def nhalo_conditional(table, hmf_int, growthf, ln_mmin, ln_mcond, sigma_cond, delta):
    """Expected number of halos per condition-mass (integral of the CMF),
    vectorized over the condition arrays."""
    if hmf_int not in (HMF_PS, HMF_ST, HMF_DELOS):
        hmf_int = HMF_PS
    out = integrate_cmf(table, hmf_int, growthf, ln_mmin, ln_mcond, delta, sigma_cond)
    delta_crit = get_delta_crit(hmf_int, sigma_cond, growthf)
    out = np.where(np.asarray(delta) > MAX_DELTAC_FRAC * delta_crit,
                   np.exp(-np.asarray(ln_mcond)), out)
    return np.maximum(out, 0.0)


def mcoll_conditional(table, hmf_int, growthf, ln_mmin, ln_mcond, sigma_cond, delta):
    """Collapsed mass fraction in [M_min, M_cond] per condition, vectorized."""
    if hmf_int not in (HMF_PS, HMF_ST, HMF_DELOS):
        hmf_int = HMF_PS
    out = integrate_cmf(
        table, hmf_int, growthf, ln_mmin, ln_mcond, delta, sigma_cond, weight_fn=np.exp
    )
    delta_crit = get_delta_crit(hmf_int, sigma_cond, growthf)
    out = np.where(np.asarray(delta) > MAX_DELTAC_FRAC * delta_crit, 1.0, out)
    return np.clip(out, 0.0, 1.0)


def build_inverse_cmf_table(
    table, hmf_int, growthf, ln_mmin, ln_mcond, sigma_cond, deltas,
    n_prob=400, min_logprob=-12.0, n_mass=512,
):
    """ln M(delta, ln p) inverse cumulative conditional MF
    (reference initialise_dNdM_inverse_table, interp_tables.c:667-800).

    p = N(>M | condition) / N_total; rows are condition deltas; the ln p axis
    is uniform on [min_logprob, 0].  `ln_mcond`/`sigma_cond` may be scalars
    (grid cells) or arrays matched to `deltas` (progenitor conditions)."""
    if hmf_int not in (HMF_PS, HMF_ST, HMF_DELOS):
        hmf_int = HMF_PS
    deltas = np.atleast_1d(np.asarray(deltas, dtype=np.float64))
    n_cond = len(deltas)
    ln_mcond = np.broadcast_to(np.asarray(ln_mcond, dtype=np.float64), (n_cond,))
    sigma_cond = np.broadcast_to(np.asarray(sigma_cond, dtype=np.float64), (n_cond,))
    ln_p_axis = np.linspace(min_logprob, 0.0, n_prob)

    out = np.empty((n_cond, n_prob))
    for i in range(n_cond):
        lm = np.linspace(ln_mmin, ln_mcond[i], n_mass)
        f = conditional_mf(table, hmf_int, growthf, lm, deltas[i], sigma_cond[i])
        f = np.maximum(f, 0.0)
        # cumulative from the TOP (N(>M)), trapezoid
        dF = 0.5 * (f[1:] + f[:-1]) * np.diff(lm)
        n_above = np.concatenate([np.cumsum(dF[::-1])[::-1], [0.0]])
        total = n_above[0]
        if total <= 0:
            out[i] = ln_mmin
            continue
        p = n_above / total
        # invert: ln M(ln p); p decreasing in M, clip away zeros for log
        lp = np.log(np.maximum(p, 1e-300))
        # make lp strictly decreasing for interp (reverse to increasing)
        out[i] = np.interp(ln_p_axis, lp[::-1], lm[::-1])
    return ln_p_axis, out


def build_nion_mturn_tables(
    table, hmf_int, growthf, ln_mmin, ln_mcond, sigma_cond, deltas, log10_mturns,
    sc: ScalingConstants, mini: bool = False, method: str = "GAUSS-LEGENDRE",
):
    """2D conditional-Nion table over (log10 Mturn, delta) for one condition
    mass (reference initialise_Nion_Conditional_spline with minihalos,
    interp_tables.c:291-579).  Returns array (n_mturn, n_delta).

    The Mturn axis enters only the integrand WEIGHT, not the conditional MF,
    so the table factorizes into one CMF evaluation (n_delta, n_gl) matmul'd
    against the per-Mturn weight matrix (n_mturn, n_gl) — ~n_mturn x faster
    than integrating per row (the round-1 host-table bottleneck for minihalo
    runs)."""
    eff = hmf_int if hmf_int in (HMF_PS, HMF_ST, HMF_DELOS) else HMF_PS
    deltas = np.asarray(deltas, dtype=np.float64)
    weight = nion_weight_mini if mini else nion_weight
    mturns = 10.0 ** np.asarray(log10_mturns, dtype=np.float64)
    if method == "GAMMA-APPROX":
        index_base = (sc.alpha_star_mini if mini else sc.alpha_star) + sc.alpha_esc
        out = mf_integral_approx(
            table, growthf, ln_mmin, ln_mcond,
            deltas[None, :], sigma_cond, index_base, mini=mini,
            ln_mturn_l=np.log(np.maximum(mturns, 1.0))[:, None],
            ln_mturn_u=np.log(sc.acg_thresh) if mini else None,
            ln_pivot_norm=np.log(1e7) if mini else np.log(1e10),
        )  # (n_mt, n_delta)
    else:
        x, w = _gl_nodes(np.float64(ln_mmin), np.float64(ln_mcond))  # (n_gl,)
        cmf = conditional_mf(
            table, eff, growthf, x[None, :], deltas[:, None], sigma_cond
        )  # (n_delta, n_gl)
        base = (cmf * w).T  # (n_gl, n_delta)
        wts = np.stack([weight(x, sc, mt) for mt in mturns])  # (n_mt, n_gl)
        out = wts @ base  # (n_mt, n_delta)

    # collapsed-condition cap: one halo at the condition mass
    delta_crit = get_delta_crit(eff, sigma_cond, growthf)
    capped = deltas > MAX_DELTAC_FRAC * delta_crit
    if capped.any():
        caps = np.array(
            [weight(np.array([ln_mcond]), sc, mt)[0] / np.exp(ln_mcond) for mt in mturns]
        )
        out[:, capped] = caps[:, None]
    if ln_mmin >= ln_mcond:
        out[:] = 0.0
    return out
