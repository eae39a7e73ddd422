"""Lyman-alpha heating: energy transfer per photon crossing the resonance.

The reference interpolates a pre-computed table (Energy_Lya_heating,
heating_helper_progs.c:1333-1373; 101x101x51 in log10 Tk, log10 Ts,
log10 tau_GP) that ships as an external download.  Here the table is
*generated* from the underlying physics: the steady-state Fokker-Planck
equation for photons near the Lyman-alpha resonance in an expanding medium
(Chen & Miralda-Escude 2004; Furlanetto & Pritchard 2006; Chuzhoy & Shapiro
2007).

Model
-----
Dimensionless frequency x = (nu - nu_a)/dnu_D with Doppler width
dnu_D = nu_a sqrt(2 k T_k / m_H c^2).  Photons drift redward with the Hubble
flow at unit flux and scatter at tau_GP phi(x) per unit x of redshifting,
where phi is the Voigt profile.  Scattering produces frequency diffusion
(variance ~1 per scattering) plus a systematic drift that relaxes the
spectrum to the gas color temperature: drift-to-diffusion ratio
2 eta_eff = (h dnu_D / k_B) / T_k, with atomic recoil folded in by detailed
balance, plus a (small) spin-flip exchange term ~ (4/27)(E_10/h dnu_D)
(E_10/k_B)(1/T_s - 1/T_k) (Chuzhoy & Shapiro 2007 structure, leading order).

Writing the constant-flux condition once-integrated gives a first-order
linear ODE for the spectrum N(x) (normalized to the flux-equivalent
pure-Hubble spectrum S):

    N + a(x) (N' + 2 eta_eff N) = S,   a(x) = tau_GP phi(x) / 2

with S = 1 everywhere for continuum photons, and S = 1 (x<0), 0 (x>0) for
photons injected at line center.  The net energy given to the gas per photon
crossing the resonance is the area of the spectral distortion:

    dE = h dnu_D * int (S - N) dx

(positive = heating).  The ODE is integrated upward from the far red wing
with an exact exponential integrator (unconditionally stable through the
optically-thick core where a ~ 1e6), vectorized over the whole (Tk, Ts,
tau_GP) table at once.

Known behaviors reproduced: continuum photons always heat (recoil dip),
with dE decreasing in Tk and increasing in tau_GP; injected photons cool
at high Tk (Doppler diffusion of the injection feature) and heat at very
low Tk where recoil dominates.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from ..cosmology.constants import physconst

__all__ = ["solve_delta_e", "LyaHeatTables", "get_lya_heat_tables", "gunn_peterson_coef"]

A_ALPHA = 6.265e8  # Ly-a spontaneous decay rate [1/s]
E_10 = physconst.T_21 * physconst.k_B  # hyperfine splitting [erg]
F_SPIN_FLIP = 4.0 / 27.0  # spin-flip probability per Ly-a scattering (Hirata 2006)

# table axes (match the reference's ranges, heating_helper_progs.c:44-53)
LOG_T_MIN, LOG_T_MAX, N_T = -1.0, 3.0, 33
LOG_GP_MIN, LOG_GP_MAX, N_GP = 1.0, 7.0, 25
N_TS = 17


def gunn_peterson_coef() -> float:
    """3 lambda_a^3 A_a / (8 pi): tau_GP = coef * n_HI / H(z)
    (reference taugp, heating_helper_progs.c:650 — constant 1.342881e-7)."""
    lam = physconst.c_cms / physconst.nu_Ly_alpha
    return 3.0 * lam**3 * A_ALPHA / (8.0 * np.pi)


def _doppler_width(tk):
    """dnu_D [Hz] for gas temperature tk [K]."""
    return physconst.nu_Ly_alpha * np.sqrt(
        2.0 * physconst.k_B * tk / (physconst.m_p * physconst.c_cms**2)
    )


def _voigt_phi(x, a_v):
    """Voigt profile normalized to int phi dx = 1.  Gaussian core plus the
    exact a/(sqrt(pi) x^2) wing (the wing controls the heating integral; the
    core only needs to be optically thick, which it vastly is)."""
    core = np.exp(-np.minimum(x * x, 60.0))
    wing = (a_v / np.sqrt(np.pi)) * x * x / (x**4 + 0.09)
    return (core + wing) / np.sqrt(np.pi)


def _x_grid(x_max: float, n: int):
    """sinh-spaced symmetric grid: dense near line center, stretched wings."""
    u = np.linspace(-1.0, 1.0, n)
    alpha = 5.0
    x = x_max * np.sinh(alpha * u) / np.sinh(alpha)
    return x


def solve_delta_e(tk, ts, tau_gp, n_x: int = 6000):
    """(dE_continuum, dE_injected) in erg per photon crossing the resonance.

    All of tk, ts, tau_gp broadcast; the ODE solve is vectorized over the
    broadcasted parameter set.
    """
    tk, ts, tau_gp = np.broadcast_arrays(
        np.asarray(tk, np.float64), np.asarray(ts, np.float64),
        np.asarray(tau_gp, np.float64),
    )
    shape = tk.shape
    tk, ts, tau = tk.ravel(), ts.ravel(), tau_gp.ravel()

    dnu_d = _doppler_width(tk)
    a_v = A_ALPHA / (4.0 * np.pi * dnu_d)  # Voigt damping parameter
    # drift/diffusion ratio: recoil (relaxation to Tk) + spin-flip exchange
    two_eta = (physconst.h_p * dnu_d / physconst.k_B) / tk + F_SPIN_FLIP * (
        E_10 / (physconst.h_p * dnu_d)
    ) * (E_10 / physconst.k_B) * (1.0 / ts - 1.0 / tk)
    two_eta = np.maximum(two_eta, 1e-12)

    # grid wide enough for the largest distortion in the batch
    scale = np.maximum((a_v * tau) ** (1.0 / 3.0), np.sqrt(two_eta * tau * a_v))
    x_max = float(np.max(np.maximum(50.0, 8.0 * scale)))
    x = _x_grid(x_max, n_x)

    n_cont = np.ones_like(tau)  # N at the far red boundary (= S there)
    n_inj = np.ones_like(tau)
    i_cont = np.zeros_like(tau)  # int (S - N) dx accumulators
    i_inj = np.zeros_like(tau)

    for i in range(n_x - 1):
        dx = x[i + 1] - x[i]
        xm = 0.5 * (x[i] + x[i + 1])
        a = tau * _voigt_phi(xm, a_v) / 2.0
        a = np.maximum(a, 1e-300)
        p = 1.0 / a + two_eta
        s_inj = 1.0 if xm < 0.0 else 0.0
        q_cont = 1.0 / a  # S=1
        q_inj = s_inj / a
        ep = np.exp(-np.minimum(p * dx, 700.0))
        nf_c = q_cont / p
        nf_i = q_inj / p
        n_cont_new = nf_c + (n_cont - nf_c) * ep
        n_inj_new = nf_i + (n_inj - nf_i) * ep
        i_cont += (1.0 - 0.5 * (n_cont + n_cont_new)) * dx
        i_inj += (s_inj - 0.5 * (n_inj + n_inj_new)) * dx
        n_cont, n_inj = n_cont_new, n_inj_new

    de_cont = physconst.h_p * dnu_d * i_cont
    de_inj = physconst.h_p * dnu_d * i_inj
    return de_cont.reshape(shape), de_inj.reshape(shape)


@dataclass(frozen=True)
class LyaHeatTables:
    """dE tables on (log10 Tk, log10 Ts, log10 tau_GP) axes [erg]."""

    log_tk: np.ndarray  # (N_T,)
    log_ts: np.ndarray  # (N_TS,)
    log_gp: np.ndarray  # (N_GP,)
    de_cont: np.ndarray  # (N_T, N_TS, N_GP)
    de_inj: np.ndarray


@lru_cache(maxsize=1)
def get_lya_heat_tables() -> LyaHeatTables:
    """Build (and cache) the heating tables.  Pure atomic physics — no
    cosmology dependence, so one table serves every run."""
    log_tk = np.linspace(LOG_T_MIN, LOG_T_MAX, N_T)
    log_ts = np.linspace(LOG_T_MIN, LOG_T_MAX, N_TS)
    log_gp = np.linspace(LOG_GP_MIN, LOG_GP_MAX, N_GP)
    tk, ts, gp = np.meshgrid(
        10.0**log_tk, 10.0**log_ts, 10.0**log_gp, indexing="ij"
    )
    de_cont, de_inj = solve_delta_e(tk, ts, gp, n_x=4000)
    return LyaHeatTables(
        log_tk=log_tk, log_ts=log_ts, log_gp=log_gp,
        de_cont=de_cont, de_inj=de_inj,
    )
