"""Cosmological recombination history: x_e(z), T_k(z) of the neutral IGM.

Default source is the bundled RECFAST table — the SAME fixed public data file
the reference reads unconditionally (heating_helper_progs.c:94-199 reading
`_data/recfast_LCDM.dat`; the reference does not re-solve recombination for
the run's cosmology, so neither do we by default: the table IS the reference
semantics, and using anything else shifts the thermal initial conditions by
a few percent).  A from-scratch Peebles three-level-atom solve (+ Compton/
adiabatic temperature evolution, RECFAST fudge factor) is kept as the
``source="PEEBLES"`` fallback for cosmologies far from the table's LCDM —
it agrees with RECFAST to ~3% in Tk and ~7% in x_e at 6 < z < 50.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np
from scipy.integrate import solve_ivp

from .constants import physconst

_RECFAST_TABLE = Path(__file__).parent.parent / "_data" / "recfast_LCDM.dat"

_LAMBDA_2S1S = 8.227  # s^-1, 2s->1s two-photon rate
_E_ION_H = 13.605693  # eV
_FUDGE = 1.14  # RECFAST fudge on alpha_B


def _alpha_B(T):
    """Case-B recombination coefficient [cm^3/s] (Pequignot et al. 1991 fit)."""
    t4 = T / 1e4
    return 1e-13 * 4.309 * t4**-0.6166 / (1 + 0.6703 * t4**0.5300)


def _beta_B(T_rad):
    """Photoionization from the 2s level via detailed balance with alpha_B(T_rad)."""
    kT_eV = physconst.k_B * T_rad / 1.60218e-12
    return (
        _alpha_B(T_rad)
        * 2.4147e15  # (2 pi m_e k_B / h^2)^(3/2) in cm^-3 K^-3/2
        * T_rad**1.5
        * np.exp(-_E_ION_H / 4.0 / kT_eV)
    )


@lru_cache(maxsize=4)
def _solve(cosmo_key):
    hlittle, OMm, OMb, OMr, OMl, Y_He = cosmo_key
    Ho = hlittle * 3.2407e-18
    T0 = physconst.T_cmb
    n_H0 = (
        (3.0 * Ho**2 / (8.0 * np.pi * physconst.G)) * OMb * (1 - Y_He) / physconst.m_p
    )  # cm^-3 comoving

    def hubble(z):
        return Ho * np.sqrt(OMm * (1 + z) ** 3 + OMr * (1 + z) ** 4 + OMl)

    z0 = 1500.0
    # Saha initial condition at z0 (fully coupled regime)
    T_rad0 = T0 * (1 + z0)
    kT_eV = physconst.k_B * T_rad0 / 1.60218e-12
    saha_rhs = (
        2.4147e15 * T_rad0**1.5 * np.exp(-_E_ION_H / kT_eV) / (n_H0 * (1 + z0) ** 3)
    )
    x0 = min(0.5 * (-saha_rhs + np.sqrt(saha_rhs**2 + 4 * saha_rhs)), 0.9999)

    lam_a = physconst.c_cms / (physconst.nu_ion_HI * 0.75)
    a_r = 7.5657e-15  # erg cm^-3 K^-4
    f_He = Y_He / (4 * (1 - Y_He))

    # Implicit (backward) Euler in decreasing z: unconditionally stable through
    # the stiff Compton-coupled epoch; Newton iterations for x_e, closed-form
    # linear solve for Tk.
    n_steps = 15000
    z_grid = np.linspace(z0, 0.0, n_steps + 1)
    x = np.empty(n_steps + 1)
    T = np.empty(n_steps + 1)
    x[0], T[0] = x0, T_rad0

    for i in range(n_steps):
        z_new = z_grid[i + 1]
        dz = z_grid[i] - z_new  # positive
        zp1 = 1.0 + z_new
        H = hubble(z_new)
        T_rad = T0 * zp1
        n_H = n_H0 * zp1**3
        K = lam_a**3 / (8 * np.pi * H)
        beta = _beta_B(T_rad)  # photoionization out of the 2s state (E_b = 3.4 eV)
        # effective ionization paired with (1-x): Boltzmann 1s->2s (10.2 eV)
        # times 2s photoionization => full 13.6 eV exponent (Peebles 1968)
        kT_rad_eV = physconst.k_B * T_rad / 1.60218e-12
        beta_eff = beta * np.exp(-0.75 * _E_ION_H / kT_rad_eV)

        # Newton solve: x = x_prev - dz * C(x)/(H zp1) * (alpha x^2 nH - beta_eff(1-x))
        xn = x[i]
        Tk_guess = T[i]
        alpha = _FUDGE * _alpha_B(Tk_guess)
        for _ in range(8):
            n_1s = max(1.0 - xn, 0.0) * n_H
            C = (1 + K * _LAMBDA_2S1S * n_1s) / (1 + K * (_LAMBDA_2S1S + beta) * n_1s)
            g = C / (H * zp1)
            F = xn - x[i] + dz * g * (alpha * xn * xn * n_H - beta_eff * (1 - xn))
            dF = 1.0 + dz * g * (2 * alpha * xn * n_H + beta_eff)
            step = F / dF
            xn = min(max(xn - step, 1e-12), 1.0)
            if abs(step) < 1e-12:
                break
        x[i + 1] = xn

        # Tk implicit: T_new (1 + dz*(2/zp1 + G)) = T_prev + dz*G*T_rad,
        # G = Gamma_compton/(H zp1)
        u_gamma = a_r * T_rad**4
        G = (
            (8.0 / 3.0)
            * physconst.sigma_T
            * u_gamma
            / (physconst.m_e * physconst.c_cms)
            * xn
            / (1 + f_He + xn)
            / (H * zp1)
        )
        T[i + 1] = (T[i] + dz * G * T_rad) / (1.0 + dz * (2.0 / zp1 + G))

    return z_grid[::-1].copy(), np.clip(x[::-1], 1e-10, 1.0), np.maximum(T[::-1], 0.0)


@lru_cache(maxsize=1)
def _load_recfast_table():
    """Columns: z, x_e, T_CMB, T_k (reference T_RECFAST/xion_RECFAST read
    columns 4 and 2 respectively, heating_helper_progs.c:114,166)."""
    dat = np.loadtxt(_RECFAST_TABLE)
    z = dat[::-1, 0].copy()  # ascending z for np.interp
    return z, dat[::-1, 1].copy(), dat[::-1, 3].copy()


class RecombinationHistory:
    """x_e(z) and Tk(z) lookup for one cosmology.

    source="RECFAST-TABLE" (default): the bundled fixed table, exactly as the
    reference.  source="PEEBLES": on-the-fly three-level-atom solve for the
    run's actual cosmology."""

    def __init__(self, cosmo, source: str = "RECFAST-TABLE"):
        if source == "RECFAST-TABLE":
            if not _RECFAST_TABLE.exists():
                # the reference throws IOError here (heating_helper_progs.c:103);
                # silently switching to the Peebles solver would shift thermal
                # ICs by a few percent with no warning
                raise FileNotFoundError(
                    f"bundled RECFAST table missing: {_RECFAST_TABLE} — "
                    "broken install? Pass source='PEEBLES' for the on-the-fly "
                    "three-level-atom solve instead."
                )
            self.z_grid, self.x_e_grid, self.tk_grid = _load_recfast_table()
        else:
            key = (cosmo.hlittle, cosmo.OMm, cosmo.OMb, cosmo.OMr, cosmo.OMl,
                   cosmo.Y_He)
            self.z_grid, self.x_e_grid, self.tk_grid = _solve(key)

    def x_e(self, z):
        return np.interp(z, self.z_grid, self.x_e_grid)

    def Tk(self, z):
        return np.interp(z, self.z_grid, self.tk_grid)

    def cT_approx(self, z):
        """Adiabatic-fluctuation index c_T (Munoz+23 2302.08506 approximation):
        Tk fluctuations delta_Tk = cT * delta at z.  Used for the first-Ts-box
        initialization (SpinTemperatureBox.c:900-903) and the non-Ts kinetic
        temperature (IonisationBox.c:203-205)."""
        # reference cT_approx (heating_helper_progs.c:197): 0.58 - 0.006 (z-10)
        return 0.58 - 0.006 * (z - 10.0)
