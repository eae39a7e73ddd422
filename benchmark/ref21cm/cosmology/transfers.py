"""Matter transfer functions (vectorized numpy, float64, host-side).

Behavioral parity with reference 21cmFAST cosmology.c:52-240 (EH/BBKS/Efstathiou/
Peebles/White + tabulated CLASS), re-implemented as pure vectorized functions.
k is in Mpc^-1 (not h/Mpc).
"""

from __future__ import annotations

import numpy as np

N_NU = 1.0  # number of heavy neutrino species assumed by the EH fit


def eh_parameters(OMm: float, OMb: float, OMn: float, hlittle: float, T_cmb: float):
    """Precompute Eisenstein & Hu (1999) fit constants.

    Returns (sound_horizon, alpha_nu, beta_c, omhh, f_nu, theta_cmb).
    Reference: cosmology.c:458-502 (TFset_parameters).
    """
    omhh = OMm * hlittle * hlittle
    obhh = OMb * hlittle * hlittle
    theta_cmb = T_cmb / 2.7
    f_nu = max(OMn / OMm, 1e-10)
    f_b = max(OMb / OMm, 1e-10)

    z_equality = 25000.0 * omhh * theta_cmb**-4 - 1.0
    k_equality = 0.0746 * omhh / theta_cmb**2

    z_drag = 0.313 * omhh**-0.419 * (1 + 0.607 * omhh**0.674)
    z_drag = 1 + z_drag * obhh ** (0.238 * omhh**0.223)
    z_drag *= 1291.0 * omhh**0.251 / (1 + 0.659 * omhh**0.828)

    y_d = (1 + z_equality) / (1.0 + z_drag)

    R_drag = 31.5 * obhh * theta_cmb**-4 * 1000.0 / (1.0 + z_drag)
    R_equality = 31.5 * obhh * theta_cmb**-4 * 1000.0 / (1.0 + z_equality)

    sound_horizon = (
        2.0
        / 3.0
        / k_equality
        * np.sqrt(6.0 / R_equality)
        * np.log((np.sqrt(1 + R_drag) + np.sqrt(R_drag + R_equality)) / (1.0 + np.sqrt(R_equality)))
    )

    p_c = -(5 - np.sqrt(1 + 24 * (1 - f_nu - f_b))) / 4.0
    p_cb = -(5 - np.sqrt(1 + 24 * (1 - f_nu))) / 4.0
    f_c = 1 - f_nu - f_b
    f_cb = 1 - f_nu
    f_nub = f_nu + f_b

    alpha_nu = (f_c / f_cb) * (2 * (p_c + p_cb) + 5) / (4 * p_cb + 5.0)
    alpha_nu *= 1 - 0.553 * f_nub + 0.126 * f_nub**3
    alpha_nu /= 1 - 0.193 * np.sqrt(f_nu) + 0.169 * f_nu
    alpha_nu *= (1 + y_d) ** (p_c - p_cb)
    alpha_nu *= 1 + (p_cb - p_c) / 2.0 * (1.0 + 1.0 / (4.0 * p_c + 3.0) / (4.0 * p_cb + 7.0)) / (
        1.0 + y_d
    )
    beta_c = 1.0 / (1.0 - 0.949 * f_nub)
    return sound_horizon, alpha_nu, beta_c, omhh, f_nu, theta_cmb


def transfer_EH(k, *, sound_horizon, alpha_nu, beta_c, omhh, f_nu, theta_cmb):
    """Eisenstein & Hu ApJ 1999, 511, 5 fit (reference cosmology.c:52-71)."""
    k = np.asarray(k, dtype=np.float64)
    q = k * theta_cmb**2 / omhh
    gamma_eff = np.sqrt(alpha_nu) + (1.0 - np.sqrt(alpha_nu)) / (1.0 + (0.43 * k * sound_horizon) ** 4)
    q_eff = q / gamma_eff
    TF_m = np.log(np.e + 1.84 * beta_c * np.sqrt(alpha_nu) * q_eff)
    TF_m = TF_m / (TF_m + q_eff**2 * (14.4 + 325.0 / (1.0 + 60.5 * q_eff**1.11)))
    q_nu = 3.92 * q / np.sqrt(f_nu / N_NU)
    TF_m = TF_m * (
        1.0 + (1.2 * f_nu**0.64 * N_NU ** (0.3 + 0.6 * f_nu)) / (q_nu**-1.6 + q_nu**0.8)
    )
    return TF_m


def transfer_BBKS(k, OMm, OMb, hlittle):
    """Bardeen et al 1986 + Sugiyama 1995 baryon correction (cosmology.c:75-83)."""
    gamma = OMm * hlittle * np.exp(-OMb - OMb / OMm)
    q = np.asarray(k, dtype=np.float64) / (hlittle * gamma)
    return (np.log(1.0 + 2.34 * q) / (2.34 * q)) * (
        1.0 + 3.89 * q + (16.1 * q) ** 2 + (5.46 * q) ** 3 + (6.71 * q) ** 4
    ) ** -0.25


def transfer_Efstathiou(k, OMm, hlittle):
    """Efstathiou et al 1992 (cosmology.c:88-96)."""
    gamma = OMm * hlittle * hlittle
    aa = 6.4 / gamma
    bb = 3.0 / gamma
    cc = 1.7 / gamma
    nu = 1.13
    k = np.asarray(k, dtype=np.float64)
    return (1 + (aa * k + (bb * k) ** 1.5 + (cc * k) ** 2) ** nu) ** (-1.0 / nu)


def transfer_Peebles(k, OMm, OMb, hlittle):
    """Peebles 1980 + Sugiyama 1995 (cosmology.c:100-109)."""
    gamma = OMm * hlittle * np.exp(-OMb - OMb / OMm)
    aa = 8.0 / (hlittle * gamma)
    bb = 4.7 / (hlittle * gamma) ** 2
    k = np.asarray(k, dtype=np.float64)
    return 1 + aa * k + bb * k * k


def transfer_White(k, OMm, OMb, hlittle):
    """Davies, Efstathiou, Frenk & White 1985 (cosmology.c:113-122)."""
    gamma = OMm * hlittle * hlittle * np.exp(-OMb - OMb / OMm)
    aa = 1.7 / gamma
    bb = 9.0 / gamma**1.5
    cc = 1.0 / gamma**2
    k = np.asarray(k, dtype=np.float64)
    return 139.284 / (1 + aa * k + bb * k**1.5 + cc * k * k)
