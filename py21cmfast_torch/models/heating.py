"""Atomic & X-ray heating physics (host-side, numpy float64).

Equivalent of reference heating_helper_progs.c + elec_interp.c + parts of
thermochem.c.  Everything here produces *tables/prefactors* consumed by the
jitted spin-temperature kernel (models/spintemp.py): frequency integrals of the
X-ray spectrum weighted by secondary-electron deposition fractions, the tau_X=1
horizon, Lyman-series spectral sums, and the 21-cm collisional coupling tables.

Data provenance (published physics tables, see _data/README.md):
 * Furlanetto & Stoever 2010 deposition fractions (x_int_tables/).
 * Barkana & Loeb 2005 stellar spectra fits (stellar_spectra.dat).
 * Zygelman 2005 kappa_HH; Furlanetto & Furlanetto 2007 kappa_eH/pH knots
   (numeric constants below).
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

from ..cosmology.constants import physconst

_DATA = Path(__file__).parent.parent / "_data"

NSPEC_MAX = 23

# ---------------------------------------------------------------------------
# Photoionization cross-sections (H-like exact Kramers form + Verner HeI fit,
# as in reference thermochem.c:114-152)


def sigma_HI(nu):
    nu = np.asarray(nu, dtype=np.float64)
    safe = np.maximum(nu, physconst.nu_ion_HI * (1 + 1e-12))
    eps = np.sqrt(safe / physconst.nu_ion_HI - 1 + 1e-30)
    out = (
        6.3e-18
        * (physconst.nu_ion_HI / safe) ** 4
        * np.exp(4 - 4 * np.arctan(eps) / eps)
        / (1 - np.exp(-2 * np.pi / eps))
    )
    return np.where(nu < physconst.nu_ion_HI, 0.0, out)


def sigma_HeII(nu):
    nu = np.asarray(nu, dtype=np.float64)
    safe = np.maximum(nu, physconst.nu_ion_HeII * (1 + 1e-12))
    eps = np.sqrt(safe / physconst.nu_ion_HeII - 1 + 1e-30)
    out = (
        6.3e-18
        / 4.0
        * (physconst.nu_ion_HeII / safe) ** 4
        * np.exp(4 - 4 * np.arctan(eps) / eps)
        / (1 - np.exp(-2 * np.pi / eps))
    )
    return np.where(nu < physconst.nu_ion_HeII, 0.0, out)


def sigma_HeI(nu):
    """Verner et al. 1996 fit."""
    nu = np.asarray(nu, dtype=np.float64)
    x = nu / physconst.eV_to_Hz / 13.61 - 0.4434
    y = np.sqrt(x * x + 2.136**2)
    out = (
        9.492e-16
        * ((x - 1) ** 2 + 2.039**2)
        * y ** (0.5 * 3.188 - 5.5)
        * (1.0 + np.sqrt(y / 1.469)) ** -3.188
    )
    return np.where(nu < physconst.nu_ion_HeI, 0.0, out)


def h_frac(Y_He):
    return (1.0 - Y_He) / (1.0 - 3.0 * Y_He / 4.0)


def he_frac(Y_He):
    return (Y_He / 4.0) / (1.0 - 3.0 * Y_He / 4.0)


# ---------------------------------------------------------------------------
# Secondary electron deposition (Furlanetto & Stoever 2010 tables)

# ionized fractions of the 14 table files, in order
X_INT_XHII = np.array(
    [1.0e-4, 2.318e-4, 4.677e-4, 1.0e-3, 2.318e-3, 4.677e-3, 1.0e-2, 2.318e-2,
     4.677e-2, 1.0e-1, 0.5, 0.9, 0.99, 0.999]
)
_X_INT_FILES = [
    "log_xi_-4.0.dat", "log_xi_-3.6.dat", "log_xi_-3.3.dat", "log_xi_-3.0.dat",
    "log_xi_-2.6.dat", "log_xi_-2.3.dat", "log_xi_-2.0.dat", "log_xi_-1.6.dat",
    "log_xi_-1.3.dat", "log_xi_-1.0.dat", "xi_0.500.dat", "xi_0.900.dat",
    "xi_0.990.dat", "xi_0.999.dat",
]


class XIntTables:
    """Energy-deposition fractions f_heat/f_ion/n_Lya/n_ion(E, x_e)."""

    def __init__(self):
        energies = None
        cols = {k: [] for k in ("f_ion", "f_heat", "n_lya", "n_ionHI", "n_ionHeI", "n_ionHeII")}
        for fname in _X_INT_FILES:
            raw = np.loadtxt(_DATA / "x_int_tables" / fname, skiprows=3)
            if energies is None:
                energies = raw[:, 0]
            cols["f_ion"].append(raw[:, 1])
            cols["f_heat"].append(raw[:, 2])
            cols["n_lya"].append(raw[:, 4])
            cols["n_ionHI"].append(raw[:, 5])
            cols["n_ionHeI"].append(raw[:, 6])
            cols["n_ionHeII"].append(raw[:, 7])
        self.energies = energies  # eV, 258 values
        self.tables = {k: np.stack(v, axis=0) for k, v in cols.items()}  # (14, 258)

    def _interp(self, key, E_eV, ix_lo, x_frac):
        """Linear interp in E for the two bracketing x_e rows, then blend."""
        tab = self.tables[key]
        lo = np.stack([np.interp(E_eV, self.energies, tab[i]) for i in range(len(X_INT_XHII))])
        # lo: (14, *E.shape); select rows
        v_lo = np.take_along_axis(lo, ix_lo[None], axis=0)[0]
        v_hi = np.take_along_axis(lo, (ix_lo + 1)[None], axis=0)[0]
        out = v_lo + (v_hi - v_lo) * x_frac
        # below minimum tabulated energy the electron deposits everything as heat
        if key == "f_heat":
            out = np.where(E_eV < self.energies[0], 1.0, out)
        else:
            out = np.where(E_eV < self.energies[0], 0.0, out)
        return out

    @staticmethod
    def xe_index(x_e):
        x = np.clip(x_e, X_INT_XHII[0] * 1.001, X_INT_XHII[-1] * 0.999)
        idx = np.searchsorted(X_INT_XHII, x) - 1
        idx = np.clip(idx, 0, len(X_INT_XHII) - 2)
        frac = (x - X_INT_XHII[idx]) / (X_INT_XHII[idx + 1] - X_INT_XHII[idx])
        return idx, frac

    def fheat(self, E_eV, x_e):
        ix, fr = self.xe_index(x_e)
        return self._interp("f_heat", E_eV, np.broadcast_to(ix, np.shape(E_eV)).astype(int),
                            np.broadcast_to(fr, np.shape(E_eV)))

    def n_lya(self, E_eV, x_e):
        ix, fr = self.xe_index(x_e)
        return self._interp("n_lya", E_eV, np.broadcast_to(ix, np.shape(E_eV)).astype(int),
                            np.broadcast_to(fr, np.shape(E_eV)))

    def n_ion_total(self, E_eV, x_e):
        ix = np.broadcast_to(self.xe_index(x_e)[0], np.shape(E_eV)).astype(int)
        fr = np.broadcast_to(self.xe_index(x_e)[1], np.shape(E_eV))
        return (
            self._interp("n_ionHI", E_eV, ix, fr)
            + self._interp("n_ionHeI", E_eV, ix, fr)
            + self._interp("n_ionHeII", E_eV, ix, fr)
        )


@lru_cache(maxsize=1)
def get_xint_tables() -> XIntTables:
    return XIntTables()


# ---------------------------------------------------------------------------
# X-ray frequency integrals (reference integrate_over_nu, heating_helper:755-866)


def freq_integrals(zp, x_e_values, lower_limits_hz, astro_params, Y_He):
    """Compute the heat/ion/lya frequency integrals.

    Returns three arrays of shape (n_R, n_xe): for each filter shell (with its
    tau=1 lower limit) and each tabulated x_e value.  Fixed log-nu quadrature
    (1024 nodes) replaces the reference's adaptive QAG (1% tolerance there).

    The integrals are *linear* in the deposition-table values, so each shell
    integrates the 14 x_e table rows once and the x_e dependence is a lerp of
    row integrals.  Linear interpolation in energy is linear too: the rows
    interpolated at the nodes and summed with quadrature weights g equal the
    table times v = W^T g, W the interpolation matrix (two nonzeros a node).
    So every (shell, species) scatters its weights onto the 258 energy bins
    (`_bin_weights`) and one product of the stacked tables with the weight
    vectors gives all row integrals of the ladder at once.
    """
    xint = get_xint_tables()
    alpha_x = astro_params.X_RAY_SPEC_INDEX
    nu0 = astro_params.NU_X_THRESH * physconst.eV_to_Hz
    nu_max = astro_params.NU_X_MAX * physconst.eV_to_Hz
    fH = h_frac(Y_He)
    fHe = he_frac(Y_He)

    lower_limits_hz = np.asarray(lower_limits_hz, np.float64)
    n_r = len(lower_limits_hz)
    x_e_values = np.asarray(x_e_values, np.float64)
    n_xe = len(x_e_values)
    heat = np.zeros((n_r, n_xe))
    ion = np.zeros((n_r, n_xe))
    lya = np.zeros((n_r, n_xe))

    ix_all, fr_all = xint.xe_index(x_e_values)
    n_nodes = 1024
    energies = xint.energies
    tabs = xint.tables

    live = lower_limits_hz < nu_max
    if not live.any():
        return heat, ion, lya
    ln_nu = np.linspace(np.log(lower_limits_hz[live]), np.log(nu_max), n_nodes, axis=-1)
    nu = np.exp(ln_nu)  # (n_live, n_nodes)
    w = np.gradient(ln_nu, axis=-1) * nu
    spec_w = (nu / nu0) ** (-alpha_x - 1) * w

    species = (
        (physconst.nu_ion_HI, sigma_HI, fH, "neutral"),
        (physconst.nu_ion_HeI, sigma_HeI, fHe, "neutral"),
        (physconst.nu_ion_HeII, sigma_HeII, fHe, "ionized"),
    )
    # per species, shell and node: the deposited energy and the weights
    E, g, g_heat = [], [], []
    for nu_th, sig_fn, abund, _ in species:
        E.append((nu - nu_th) / physconst.eV_to_Hz)
        g.append(spec_w * sig_fn(nu) * abund)
        g_heat.append(g[-1] * physconst.h_p * (nu - nu_th))
    E, g, g_heat = np.stack(E), np.stack(g), np.stack(g_heat)

    # row integrals, (species, shell, table row): the x_e population factor
    # (1-xe) or xe is applied after the lerp; below the tabulated energies
    # the electron deposits everything as heat (f_heat 1, the others 0)
    (v, _), (v_heat, below_heat) = _bin_weights(E, (g, g_heat), energies)
    n_ion_tab = tabs["n_ionHI"] + tabs["n_ionHeI"] + tabs["n_ionHeII"]
    i_heat_rows = v_heat @ tabs["f_heat"].T + below_heat[..., None]
    i_ion_rows = v @ n_ion_tab.T + np.sum(g, axis=-1)[..., None]  # the +1 primary ionization
    i_lya_rows = v @ tabs["n_lya"].T

    def lerp(rows_int):
        return rows_int[:, ix_all] + (rows_int[:, ix_all + 1] - rows_int[:, ix_all]) * fr_all

    for k, (*_, pop) in enumerate(species):
        popf = (1.0 - x_e_values) if pop == "neutral" else x_e_values
        heat[live] += lerp(i_heat_rows[k]) * popf
        ion[live] += lerp(i_ion_rows[k]) * popf
        lya[live] += lerp(i_lya_rows[k]) * popf

    return heat, ion, lya


def _bin_weights(E, weights, energies):
    """Scatter quadrature weights onto the energy bins of linear interpolation.

    `E` (..., n_nodes) are the nodes' energies and each array of `weights`
    has E's shape.  For each array, returns its weight vectors (...,
    len(energies)), so that `v @ tab` is the sum over nodes of the weight
    times `np.interp(E, energies, tab)` but for the nodes below
    `energies[0]`, and the summed weights (...) of those nodes, which take
    the table's fill instead.  As in np.interp, a node at or above
    `energies[-1]` takes the last column."""
    n_bins = len(energies)
    lead = E.shape[:-1]
    size = int(np.prod(lead)) * n_bins
    below = E < energies[0]
    j = np.searchsorted(energies, E, side="right") - 1
    np.clip(j, 0, n_bins - 2, out=j)
    e_lo = energies[j]
    frac = (E - e_lo) / (energies[j + 1] - e_lo)
    frac[E >= energies[-1]] = 1.0
    # bins of the flattened (rows, n_bins) output
    lo_bin = (j + np.arange(0, size, n_bins).reshape(lead + (1,))).ravel()
    frac = frac.ravel()
    out = []
    for wgt in weights:
        inside = np.where(below, 0.0, wgt).ravel()
        hi_w = inside * frac
        v = np.bincount(lo_bin, inside - hi_w, minlength=size)
        v += np.bincount(lo_bin + 1, hi_w, minlength=size)
        out.append((v.reshape(lead + (n_bins,)), np.sum(wgt, axis=-1, where=below)))
    return out


# ---------------------------------------------------------------------------
# X-ray optical depth and the tau=1 horizon (heating_helper:901-1226)


def _per_row(curves, zhat):
    """Evaluate the minihalo curves of `tau_x` on its (rows, nodes) grid:
    none, one for every row, or one a row, each distinct curve called once."""
    if curves is None:
        return 0.0
    if callable(curves):
        return curves(zhat)
    out = np.empty_like(zhat)
    rows = {}
    for i, fn in enumerate(curves):
        rows.setdefault(id(fn), (fn, []))[1].append(i)
    for fn, idx in rows.values():
        out[idx] = fn(zhat[idx])
    return out


def tau_x(nu_at_zp, zp, zpp, x_e_ave, nion_of_z, ion_eff, N_b0, dtdz_fn, Y_He, n_nodes=96,
          nion_mini_of_z=None, ion_eff_mini=0.0):
    """tau_X for a photon arriving at zp with frequency nu, emitted at zpp.

    `nion_of_z` is a callable giving the global relative Nion at z (the mean
    collapsed/ionizing fraction entering the HI filling factor estimate).
    With minihalos, `nion_mini_of_z` adds the MCG ionizing contribution to
    the filling factor (tauX_integrand_MINI, heating_helper_progs.c:901-941).

    `nu_at_zp` and `zpp` may be arrays of one shape (rows): each row is
    integrated on its own grid, and `nion_mini_of_z` may then be a sequence
    of per-row curves."""
    # ascending grid: zhat runs zp -> zpp so the trapezoid weights are
    # positive (a descending grid silently returned tau < 0, which made
    # nu_tau_one bail to its 24.6 eV floor and turned OFF all X-ray
    # attenuation — hugely over-heating every USE_TS_FLUCT config)
    zhat = np.ascontiguousarray(np.linspace(zp, zpp, n_nodes, axis=-1))
    nuhat = np.asarray(nu_at_zp, np.float64)[..., None] / (1 + zp) * (1 + zhat)
    fcoll = nion_of_z(zhat)
    fcoll_mini = _per_row(nion_mini_of_z, zhat)
    nion_tot = ion_eff * fcoll + ion_eff_mini * fcoll_mini
    no_light = (fcoll < 1e-20) & (np.asarray(fcoll_mini) < 1e-20)
    fill = np.where(no_light, 1.0, 1 - nion_tot / (1.0 - x_e_ave))
    fill = np.maximum(fill, 1e-4)
    fH = h_frac(Y_He)
    fHe = he_frac(Y_He)
    sigma = (
        fH * (1 - x_e_ave) * sigma_HI(nuhat)
        + fHe * (1 - x_e_ave) * sigma_HeI(nuhat)
        + fHe * x_e_ave * sigma_HeII(nuhat)
    )
    drpropdz = physconst.c_cms * dtdz_fn(zhat)  # negative
    n = N_b0 * (1 + zhat) ** 3
    integrand = np.abs(drpropdz) * n * fill * sigma
    return np.trapezoid(integrand, zhat, axis=-1)


def nu_tau_one(zp, zpp, x_e_ave, nion_of_z, ion_eff, N_b0, dtdz_fn, Y_He,
               nion_mini_of_z=None, ion_eff_mini=0.0):
    """Frequency where tau_X = 1 (bisection in log nu, heating_helper:1162-1226;
    the mini args give the nu_tau_one_MINI variant, :1094-1160).

    `zpp` may be an array of shell redshifts: one lockstep bisection then
    finds every shell's horizon, each step evaluating tau_X once for the
    shells still in play, and `nion_mini_of_z` may be a sequence of per-shell
    curves.  Each shell keeps its own bracket, midpoints and exits, so its
    horizon is the one a bisection of that shell alone finds."""
    scalar = np.ndim(zpp) == 0
    zpp = np.atleast_1d(np.asarray(zpp, np.float64))
    lo = np.full(zpp.shape, np.log(physconst.nu_ion_HeI))
    hi = np.full(zpp.shape, np.log(1e6 * physconst.eV_to_Hz))
    out = np.full(zpp.shape, physconst.nu_ion_HeI)
    if x_e_ave > 0.9999:
        return out[0] if scalar else out

    def f(rows, ln_nu):
        curves = nion_mini_of_z
        if curves is not None and not callable(curves):
            curves = [curves[i] for i in rows]
        return (
            tau_x(np.exp(ln_nu), zp, zpp[rows], x_e_ave, nion_of_z, ion_eff, N_b0, dtdz_fn,
                  Y_He, nion_mini_of_z=curves, ion_eff_mini=ion_eff_mini)
            - 1.0
        )

    # f(lo) < 0: nu_HeI already; f(hi) > 0: the top of the bracket
    rows = np.arange(len(zpp))
    rows = rows[~(f(rows, lo[rows]) < 0)]
    at_top = f(rows, hi[rows]) > 0
    out[rows[at_top]] = np.exp(hi[rows[at_top]])
    rows = rows[~at_top]
    bisected = rows
    for _ in range(40):
        if not len(rows):
            break
        mid = 0.5 * (lo[rows] + hi[rows])
        up = f(rows, mid) > 0
        lo[rows] = np.where(up, mid, lo[rows])
        hi[rows] = np.where(up, hi[rows], mid)
        rows = rows[~(hi[rows] - lo[rows] < 0.02)]
    out[bisected] = np.exp(0.5 * (lo[bisected] + hi[bisected]))
    return out[0] if scalar else out


# ---------------------------------------------------------------------------
# Lyman-series spectral sums (heating_helper:200-362)


def frecycle(n):
    """Fraction of Ly-n photons recycled to Ly-alpha (Pritchard & Furlanetto 2006)."""
    table = {0: 1, 1: 1, 2: 1, 3: 0, 4: 0.2609, 5: 0.3078, 6: 0.3259, 7: 0.3353,
             8: 0.3410, 9: 0.3448, 10: 0.3476, 11: 0.3496, 12: 0.3512, 13: 0.3524,
             14: 0.3535, 15: 0.3543, 16: 0.3550, 17: 0.3556, 18: 0.3561, 19: 0.3565,
             20: 0.3569, 21: 0.3572, 22: 0.3575, 23: 0.3578, 24: 0.3580, 25: 0.3582,
             26: 0.3584, 27: 0.3586, 28: 0.3587, 29: 0.3589, 30: 0.3590}
    return table.get(n, 0.0)


def nu_n(n):
    """Frequency of Lyman-n in units of Lyman-alpha."""
    return (1.0 - n**-2.0) / 0.75


def zmax_lyn(z, n):
    """Max redshift at which a Ly-n transition contributes to Lya flux at z."""
    return (1 + z) * (1 - (n + 1) ** -2) / (1 - n**-2) - 1


class StellarSpectra:
    """Barkana & Loeb piecewise power-law spectra between Lyman lines.

    File columns: n, N0_pop2, alpha_pop2, N0_pop3, alpha_pop3 per interval
    [nu_n, nu_{n+1}].  Normalized so the total ionizing photon number matches
    POP2_ION / POP3_ION (reference spectral_emissivity flag=1 branch).
    """

    def __init__(self, pop2_ion: float, pop3_ion: float):
        # file has 22 numeric rows (n = 2..23) followed by a stray label line
        raw = np.loadtxt(_DATA / "stellar_spectra.dat", max_rows=22)
        n = raw[:, 0].astype(int)
        self.nu_edges = 4.0 / 3.0 * (1.0 - 1.0 / n**2.0)  # units of nu_Lya
        self.alpha2 = raw[:, 2]
        self.alpha3 = raw[:, 4]
        N0_2 = raw[:, 1].copy()
        N0_3 = raw[:, 3].copy()
        for i in range(len(n) - 1):
            fac2 = self.nu_edges[i + 1] ** (self.alpha2[i] + 1) - self.nu_edges[i] ** (
                self.alpha2[i] + 1
            )
            N0_2[i] *= (self.alpha2[i] + 1) / fac2 * pop2_ion
            fac3 = self.nu_edges[i + 1] ** (self.alpha3[i] + 1) - self.nu_edges[i] ** (
                self.alpha3[i] + 1
            )
            N0_3[i] *= (self.alpha3[i] + 1) / fac3 * pop3_ion
        self.N0_2 = N0_2
        self.N0_3 = N0_3

    def emissivity(self, nu_norm, population=2):
        """Photon number emissivity at nu (in nu_Lya units), per baryon per
        frequency (the 1/nu_Lya makes it per Hz when multiplied upstream)."""
        N0 = self.N0_2 if population == 2 else self.N0_3
        alpha = self.alpha2 if population == 2 else self.alpha3
        i = np.searchsorted(self.nu_edges, nu_norm) - 1
        i = int(np.clip(i, 0, len(self.nu_edges) - 2))
        return N0[i] * nu_norm ** alpha[i] / physconst.nu_Ly_alpha

    def emissivity_band_integral(self, nu_lo, n_interval, population=2):
        """Integral of the emissivity from nu_lo to the next Lyman edge
        (used for the LW band, flag=2 branch)."""
        N0 = self.N0_2 if population == 2 else self.N0_3
        alpha = self.alpha2 if population == 2 else self.alpha3
        i = n_interval - 2  # table rows start at n=2; interval is [nu_n, nu_{n+1}]
        if i < 0 or i >= len(self.nu_edges) - 1:
            return 1e-40
        res = N0[i] / (alpha[i] + 1) * (
            self.nu_edges[i + 1] ** (alpha[i] + 1) - nu_lo ** (alpha[i] + 1)
        )
        return max(res, 1e-40)


# ---------------------------------------------------------------------------
# 21-cm collisional coupling kappa_10 tables
# (log T, log kappa) knots: Zygelman 2005 (H-H), Furlanetto & Furlanetto 2007
# (e-H and p-H); identical knot sets to those used across the 21-cm literature.

_KAPPA_HH_LOGT = np.linspace(0.0, 9.21034037198, 30)
_KAPPA_HH_LOGK = np.array([
    -29.6115227098, -29.6228184691, -29.5917673123, -29.4469989515, -29.1171430989,
    -28.5382192456, -27.7424388865, -26.8137036254, -25.8749225449, -25.0548322235,
    -24.4005076336, -23.8952335377, -23.5075651004, -23.201637629, -22.9593758343,
    -22.7534867461, -22.5745752086, -22.4195690855, -22.2833176123, -22.1549519419,
    -22.0323282988, -21.9149994721, -21.800121439, -21.6839502137, -21.5662434981,
    -21.4473595491, -21.3279560712, -21.2067614838, -21.0835560288, -20.9627928675,
])

_KAPPA_PH_LOGT = np.linspace(0.0, 9.90348755254, 30)
_KAPPA_PH_LOGK = np.array([
    -21.6395565688, -21.5641675629, -21.5225112028, -21.5130514508, -21.5342522691,
    -21.5845293039, -21.6581396414, -21.7420392948, -21.8221380683, -21.8837908896,
    -21.9167553997, -21.9200173678, -21.8938574675, -21.8414464728, -21.7684762963,
    -21.6796222358, -21.5784701374, -21.4679438133, -21.3503236936, -21.2277666787,
    -21.1017425964, -20.9733966978, -20.8437244283, -20.7135746917, -20.583135408,
    -20.4523507819, -20.3215504736, -20.1917429161, -20.0629513946, -19.9343540344,
])

_KAPPA_EH_LOGT = np.linspace(0.0, 11.512925465, 30)
_KAPPA_EH_LOGK = np.array([
    -22.1549007191, -21.9576919899, -21.760758435, -21.5641795674, -21.3680349001,
    -21.1724124486, -20.9774403051, -20.78327367, -20.5901042551, -20.3981934669,
    -20.2078762485, -20.0195787458, -19.8339587914, -19.6518934427, -19.4745894649,
    -19.3043925781, -19.1444129787, -18.9986014565, -18.8720602784, -18.768679825,
    -18.6909581885, -18.6387511068, -18.6093755705, -18.5992098958, -18.6050625357,
    -18.6319366207, -18.7017996535, -18.8477153986, -19.0813436512, -19.408859606,
])


def kappa_tables():
    """Return the (logT_knots, logk_knots) triples for (HH, eH, pH) as jnp-ready
    numpy arrays, plus the high-T extrapolation slope for HH (0.381)."""
    return {
        "HH": (_KAPPA_HH_LOGT, _KAPPA_HH_LOGK, 0.381),
        "eH": (_KAPPA_EH_LOGT, _KAPPA_EH_LOGK, None),
        "pH": (_KAPPA_PH_LOGT, _KAPPA_PH_LOGK, None),
    }


def alpha_A(T):
    """Case-A recombination coefficient fit [cm^3/s] (thermochem.c:66-76)."""
    logT = np.log(np.asarray(T, dtype=np.float64) / 1.1604505e4)
    poly = (
        -28.6130338
        - 0.72411256 * logT
        - 2.02604473e-2 * logT**2
        - 2.38086188e-3 * logT**3
        - 3.21260521e-4 * logT**4
        - 1.42150291e-5 * logT**5
        + 4.98910892e-6 * logT**6
        + 5.75561414e-7 * logT**7
        - 1.85676704e-8 * logT**8
        - 3.07113524e-9 * logT**9
    )
    return np.exp(poly)
