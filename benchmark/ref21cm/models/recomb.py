"""Inhomogeneous recombinations: MHR00 sub-grid density PDF model.

Host-side equivalent of reference recombinations.c:64-383 — builds the
RR(z_eff, Gamma12) lookup (recombination rate per baryon in 1/1e15 s) by
integrating the Miralda-Escude, Haehnelt & Rees 2000 volume-weighted density
PDF with Rahmati+13 self-shielding; the table ships to device as a constant
for per-cell gathers in the ionization kernel.

MHR00 PDF: P_V(D) = A exp[-(D^{-2/3}-C)^2 / (2 (2 delta_0/3)^2)] D^beta with
delta_0 = 7.61/(1+z); C(z) and beta(z) are the published MHR00 fit values,
A from normalization (reference init_A_MHR).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..cosmology.constants import physconst
from .heating import alpha_A

__all__ = ["RecombTables", "get_recomb_tables", "gamma_ss"]

RR_Z_NPTS = 300
RR_DEL_Z = 0.2
RR_LNGAMMA_NPTS = 250
RR_LNGAMMA_MIN = -10.0
RR_DEL_LNGAMMA = 0.1

# MHR00 published fit values on z = 2..13 / 2..6 grids (recombinations.c:308-373)
_C_Z = np.arange(2.0, 14.0)
_C_VALS = np.array(
    [0.558, 0.599, 0.611, 0.769, 0.868, 0.930, 0.964, 0.983, 0.993, 0.998, 0.999, 1.0]
)
_BETA_Z = np.arange(2.0, 7.0)
_BETA_VALS = np.array([-2.23, -2.35, -2.48, -2.49, -2.50])


def C_MHR(z):
    return np.interp(np.clip(z, 2.0, 13.0), _C_Z, _C_VALS)


def beta_MHR(z):
    return np.interp(np.clip(z, 2.0, 6.0), _BETA_Z, _BETA_VALS)


def _pdf_unnorm(delta, z):
    delta_0 = 7.61 / (1.0 + z)
    return (
        np.exp(-0.5 * ((delta ** (-2.0 / 3.0) - C_MHR(z)) / (2.0 * delta_0 / 3.0)) ** 2)
        * delta ** beta_MHR(z)
    )


def A_MHR(z):
    """Normalization: 1 / int P dDelta over (0, inf) (recombinations.c:228-278)."""
    z = np.clip(z, 2.0, 62.0)
    ln_d = np.linspace(np.log(1e-12), np.log(1e12), 6000)
    d = np.exp(ln_d)
    integ = _pdf_unnorm(d, z) * d  # extra D for d lnD
    return 1.0 / np.trapezoid(integ, ln_d)


def gamma_ss(gamma_bg, delta, t4, z):
    """Rahmati et al. 2013 self-shielded photoionization rate [1e-12/s]
    (recombinations.c:144-148)."""
    d_ss = 26.7 * t4**0.17 * ((1 + z) / 10.0) ** -3 * gamma_bg ** (2.0 / 3.0)
    x = delta / d_ss
    return gamma_bg * (0.98 * (1.0 + x**1.64) ** -2.28 + 0.02 * (1.0 + x) ** -0.84)


def _alpha_B(T):
    return physconst.alpha_B_10k * (T / 1e4) ** -0.75


def _neutral_fraction(n_h, t4, gamma12, Y_He, use_case_b=True):
    """Equilibrium neutral fraction chi (thermochem.c neutral_fraction)."""
    corr_he = 1.0 / (4.0 / Y_He - 3.0)
    alpha = _alpha_B(t4 * 1e4) if use_case_b else alpha_A(t4 * 1e4)
    gamma = gamma12 * 1e-12
    chi_small = (1 + corr_he) * n_h * alpha / gamma
    b = -2.0 - gamma / (n_h * (1 + corr_he) * alpha)
    with np.errstate(invalid="ignore"):
        chi_quad = (-b - np.sqrt(b * b - 4.0)) / 2.0
    return np.where(chi_small < 1e-5, chi_small, chi_quad)


def recombination_rate(z, gamma12_bg, no_h, Y_He, t4=1.0, use_case_b=True, n_nodes=256):
    """Recombination rate per baryon [1/1e15 s] for one (z, Gamma12)
    (recombinations.c:182-215), vectorized over gamma12_bg."""
    gamma12_bg = np.atleast_1d(np.asarray(gamma12_bg, dtype=np.float64))
    ln_d = np.linspace(np.log(0.01), np.log(200.0), n_nodes)
    d = np.exp(ln_d)[None, :]
    A = A_MHR(z)
    pdelta = A * _pdf_unnorm(d[0], z)[None, :]
    n_h_mean = no_h * (1 + z) ** 3
    gamma = gamma_ss(gamma12_bg[:, None], d, t4, z)
    n_h = n_h_mean * d
    x_e = 1.0 - _neutral_fraction(n_h, t4, gamma, Y_He, use_case_b)
    alpha = _alpha_B(t4 * 1e4) if use_case_b else alpha_A(t4 * 1e4)
    integrand = 1e15 * n_h * pdelta * alpha * x_e * x_e * d * d  # extra D for dlnD
    return np.trapezoid(integrand, ln_d, axis=-1)


class RecombTables:
    """RR(z, lnGamma) grid for device-side gathers (init_MHR, recombinations.c:92)."""

    def __init__(self, no_h, Y_He):
        self.ln_gamma = RR_LNGAMMA_MIN + np.arange(RR_LNGAMMA_NPTS) * RR_DEL_LNGAMMA
        zs = np.arange(RR_Z_NPTS) * RR_DEL_Z
        table = np.empty((RR_Z_NPTS, RR_LNGAMMA_NPTS))
        gammas = np.exp(self.ln_gamma)
        for i, z in enumerate(zs):
            table[i] = recombination_rate(z, gammas, no_h, Y_He)
        self.z_values = zs
        self.table = table

    def evaluate(self, z_eff, gamma12):
        """Host-side reference lookup (splined_recombination_rate)."""
        z_idx = np.clip(np.round(z_eff / RR_DEL_Z).astype(int), 0, RR_Z_NPTS - 1)
        ln_g = np.log(np.maximum(gamma12, 1e-30))
        out = np.array(
            [
                np.interp(lg, self.ln_gamma, self.table[zi])
                for zi, lg in zip(np.atleast_1d(z_idx), np.atleast_1d(ln_g))
            ]
        )
        return np.where(np.atleast_1d(ln_g) < RR_LNGAMMA_MIN, 0.0, out)


@lru_cache(maxsize=2)
def _cached_tables(no_h: float, y_he: float) -> RecombTables:
    return RecombTables(no_h, y_he)


def get_recomb_tables(cosmo) -> RecombTables:
    no_h = cosmo.rho_crit_cgs * cosmo.OMb * (1 - cosmo.Y_He) / physconst.m_p
    return _cached_tables(round(no_h, 12), round(cosmo.Y_He, 6))
