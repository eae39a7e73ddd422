"""Linear power spectrum, sigma(M), and background cosmology (host-side float64).

Behavioral parity with reference 21cmFAST cosmology.c (power_in_k:278, sigma_z0:369,
dsigmasqdm_z0:421, dicke:670, dtdz:711, hubble:770, MtoR/RtoM:593-616), redesigned
as a vectorized, stateless-per-instance `Cosmology` object.  All heavy per-mode
work on device uses *tables* produced here (see `SigmaTable`), so the quadratures
below run once per parameter set, on host, in float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import transfers
from .constants import H0_PER_h, physconst

# Filter type enum (matches reference InputParameters.h choices)
FILTER_TOPHAT = 0
FILTER_SHARPK = 1
FILTER_GAUSSIAN = 2

_GL_NODES = 4096  # fixed Gauss-Legendre order for the sigma integrals (u = kR up to 350)
_U_MAX = 350.0  # upper integration limit in kR, as in reference sigma_z0


def _w_tophat(u):
    """Real-space tophat window in k-space; u = kR."""
    u = np.asarray(u)
    small = u < 1e-4
    with np.errstate(invalid="ignore", divide="ignore"):
        w = 3.0 * (np.sin(u) - u * np.cos(u)) / u**3
    return np.where(small, 1 - u * u / 10.0, w)


def _w_gaussian(u):
    # NOTE: the reference grid-filter gaussian includes the 0.643 width factor
    # (filtering.c:32); the sigma integral uses the same function via filter_function.
    return np.exp(-(0.643**2) * u * u / 2.0)


def _w_sharpk(u):
    return np.where(u * 0.413566994 > 1, 0.0, 1.0)


_WINDOWS = {FILTER_TOPHAT: _w_tophat, FILTER_SHARPK: _w_sharpk, FILTER_GAUSSIAN: _w_gaussian}


@dataclasses.dataclass(frozen=True)
class SigmaTable:
    """ln(M) -> sigma(M, z=0) and d sigma^2/dM lookup (numpy, float64)."""

    ln_m: np.ndarray
    sigma: np.ndarray
    dsigmasq_dm: np.ndarray

    def sigma_of_lnm(self, lnm):
        return np.interp(lnm, self.ln_m, self.sigma)

    def dsigmasq_of_lnm(self, lnm):
        return np.interp(lnm, self.ln_m, self.dsigmasq_dm)


class Cosmology:
    """Background + linear power spectrum for one cosmological parameter set.

    Parameters mirror the reference `CosmoParams` struct. `power_spectrum` selects
    the transfer function (0=EH 1=BBKS 2=Efstathiou 3=Peebles 4=White 5=tabulated).
    For `power_spectrum=5` pass `transfer_table=(k[Mpc^-1], T(k))` in the CLASS
    convention (T ~ delta(k,z=0)/zeta(k)).
    """

    def __init__(
        self,
        *,
        hlittle: float = 0.6766,
        OMm: float = 0.30966,
        OMb: float = 0.04897,
        OMn: float = 0.0,
        OMr: float = 8.6e-5,
        OMk: float = 0.0,
        POWER_INDEX: float = 0.9665,
        SIGMA_8: float | None = 0.8102,
        A_s: float | None = None,
        Y_He: float = 0.24,
        wl: float = -1.0,
        power_spectrum: int = 0,
        filter_type: int = FILTER_TOPHAT,
        transfer_table: tuple[np.ndarray, np.ndarray] | None = None,
        vcb_suppression: bool = False,
    ):
        self.hlittle = float(hlittle)
        self.OMm = float(OMm)
        self.OMb = float(OMb)
        self.OMn = float(OMn)
        self.OMr = float(OMr)
        self.OMk = float(OMk)
        self.OMl = 1.0 - OMm - OMk  # flat by default (radiation ignored as in reference)
        self.POWER_INDEX = float(POWER_INDEX)
        self.Y_He = float(Y_He)
        self.wl = float(wl)
        self.power_spectrum = int(power_spectrum)
        self.filter_type = int(filter_type)
        self.transfer_table = transfer_table
        # mean relative-velocity suppression of small-scale matter power
        # (Munoz+ fit; reference cosmology.c:27-29 + power_in_k:295-300):
        # active when CLASS transfers are used together with a v_cb model
        self.vcb_suppression = bool(vcb_suppression) and self.power_spectrum == 5

        self.Ho = self.hlittle * H0_PER_h  # s^-1
        # critical density in Msun / Mpc^3 at z=0
        self.rho_crit = (
            (3.0 * self.Ho**2 / (8.0 * np.pi * physconst.G))
            * physconst.cm_per_Mpc**3
            / physconst.Msun
        )
        self.rho_crit_cgs = 3.0 * self.Ho**2 / (8.0 * np.pi * physconst.G)
        # mean matter density Msun/Mpc^3 (comoving)
        self.rho_mean = self.OMm * self.rho_crit

        self._eh = transfers.eh_parameters(OMm, OMb, OMn, hlittle, physconst.T_cmb)
        (self._sound_horizon, self._alpha_nu, self._beta_c, self._omhh, self._f_nu,
         self._theta_cmb) = self._eh

        # Gauss-Legendre nodes for sigma integrals, cached (needed before norm)
        x, w = np.polynomial.legendre.leggauss(_GL_NODES)
        self._gl_u = 0.5 * _U_MAX * (x + 1.0)
        self._gl_w = 0.5 * _U_MAX * w

        # --- Power-spectrum normalization (reference init_ps:507-557) ---
        if SIGMA_8 is not None and A_s is not None:
            raise ValueError("give only one of SIGMA_8 / A_s")
        if A_s is not None:
            self.use_sigma8 = False
            self.ps_norm = float(A_s)
            self.sigma_norm = 2.0 * np.pi**2
            self.SIGMA_8 = None
        else:
            self.use_sigma8 = True
            self.ps_norm = float(SIGMA_8 if SIGMA_8 is not None else 0.8102)
            self.SIGMA_8 = self.ps_norm
            self.sigma_norm = 1.0
            radius_8 = 8.0 / self.hlittle
            sig8_unnorm = self._sigma_of_R(np.array([radius_8]))[0]
            self.sigma_norm = (self.ps_norm / sig8_unnorm) ** 2

    # ------------------------------------------------------------------ power
    def transfer_function(self, k):
        k = np.asarray(k, dtype=np.float64)
        ps = self.power_spectrum
        if ps == 0:
            return transfers.transfer_EH(
                k,
                sound_horizon=self._sound_horizon,
                alpha_nu=self._alpha_nu,
                beta_c=self._beta_c,
                omhh=self._omhh,
                f_nu=self._f_nu,
                theta_cmb=self._theta_cmb,
            )
        if ps == 1:
            return transfers.transfer_BBKS(k, self.OMm, self.OMb, self.hlittle)
        if ps == 2:
            return transfers.transfer_Efstathiou(k, self.OMm, self.hlittle)
        if ps == 3:
            return transfers.transfer_Peebles(k, self.OMm, self.OMb, self.hlittle)
        if ps == 4:
            return transfers.transfer_White(k, self.OMm, self.OMb, self.hlittle)
        if ps == 5:
            kt, Tt = self.transfer_table
            # natural cubic spline in linear k — the reference's exact
            # convention (gsl_interp_cspline, transfer_function_CLASS:151);
            # linear interp of the ~29-points/decade table biased the band
            # power by ~3-4% (measured against the mini golds).
            # EH-shaped extrapolation above kmax (:184-196).
            if not hasattr(self, "_class_spline"):
                from scipy.interpolate import CubicSpline

                self._class_spline = CubicSpline(kt, Tt, bc_type="natural")
            T = self._class_spline(np.clip(k, kt[0], kt[-1]))
            kmax = kt[-1]
            if np.any(k > kmax):
                eh = self.__class__.transfer_function
                ratio = Tt[-1] / kmax**2 / transfers.transfer_EH(
                    kmax,
                    sound_horizon=self._sound_horizon,
                    alpha_nu=self._alpha_nu,
                    beta_c=self._beta_c,
                    omhh=self._omhh,
                    f_nu=self._f_nu,
                    theta_cmb=self._theta_cmb,
                )
                T_ext = ratio * transfers.transfer_EH(
                    k,
                    sound_horizon=self._sound_horizon,
                    alpha_nu=self._alpha_nu,
                    beta_c=self._beta_c,
                    omhh=self._omhh,
                    f_nu=self._f_nu,
                    theta_cmb=self._theta_cmb,
                ) * k**2
                T = np.where(k > kmax, T_ext, T)
            return T
        raise ValueError(f"unknown power_spectrum {ps}")

    def primordial_curvature_power(self, k):
        """Dimensionless primordial curvature PS, reference cosmology.c:242-254."""
        k_pivot = 0.05
        return self.ps_norm * (np.asarray(k, dtype=np.float64) / k_pivot) ** (
            self.POWER_INDEX - 1.0
        )

    def power_in_k(self, k):
        """Linear matter P(k) at z=0 in Mpc^3 (reference power_in_k:278-303)."""
        k = np.asarray(k, dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            T = self.transfer_function(k)
            if self.power_spectrum < 5:
                T = T * k * k  # match CLASS convention where T ~ k^2 at low k
            p = self.sigma_norm * self.primordial_curvature_power(k) * T * T / k**3
            if self.vcb_suppression:
                # 24% dip centred at k=300/Mpc, 0.9 dex wide — the mean-v_cb
                # suppression of minihalo-scale power (cosmology.c:295-300)
                p = p * (1.0 - 0.24 * np.exp(
                    -np.log(k / 300.0) ** 2 / (2.0 * 0.9**2)
                ))
        return np.where(k == 0.0, 0.0, p)

    # ------------------------------------------------------- relative velocity
    # mean |v_cb| at kinematic decoupling [km/s]: the reference default
    # (V_CB_AVG_DEFAULT, wrapper/inputs.py:138), overwritten from the actual
    # velocity-transfer table when one is injected (wrapper/inputs.py:1940-1947
    # computes it as sqrt(8/3pi) * V_CB_RMS from the CLASS run)
    V_CB_AVG = 27.0

    def set_vcb_power_table(self, k, p_vcb):
        """Inject an externally computed P_vcb(k) table (e.g. from a CLASS run
        with output velocity transfer, as the reference ingests via
        classy_interface.py).  Overrides the built-in analytic shape; values
        are |v_cb| power at kinematic decoupling in (km/s)^2 Mpc^3.

        Also recomputes V_CB_AVG from the table's rms, mirroring the
        reference's CosmoTables construction (wrapper/inputs.py:1938-1947)."""
        k = np.asarray(k, dtype=np.float64)
        p_vcb = np.asarray(p_vcb, dtype=np.float64)
        self._vcb_table = (k, p_vcb)
        # rms^2 = int k^2 dk / (2 pi^2) P_vcb(k), log-k Simpson like compute_rms
        pos = k > 0
        lnk = np.log(k[pos])
        from scipy.integrate import simpson

        var = simpson(k[pos] ** 3 * p_vcb[pos], x=lnk) / (2.0 * np.pi**2)
        self.V_CB_AVG = float(np.sqrt(8.0 / (3.0 * np.pi)) * np.sqrt(var))

    def power_vcb(self, k):
        """P_vcb(k): 3D power of the DM-baryon relative speed at kinematic
        decoupling, in (km/s)^2 Mpc^3 (reference power_in_vcb, cosmology.c:310,
        which requires a CLASS velocity-transfer table).

        Without an injected table this uses an analytic stand-in built from the
        Eisenstein & Hu (1998) drag-epoch scales: the relative velocity is a
        compensated acoustic mode — zero outside the sound horizon (rising as
        (k s)^2), oscillating with the velocity phase cos(k s), and Silk-damped
        — normalized so the 3D rms speed is V_CB_AVG*sqrt(3pi/8) ~ 29.3 km/s
        (Tseliakhovich & Hirata 2010).  Shape accuracy is ~tens of percent;
        inject a CLASS table via `set_vcb_power_table` for precision work."""
        k = np.asarray(k, dtype=np.float64)
        tab = getattr(self, "_vcb_table", None)
        if tab is not None:
            kt, pt = tab
            with np.errstate(divide="ignore"):
                out = np.exp(
                    np.interp(np.log(np.maximum(k, kt[0])), np.log(kt), np.log(np.maximum(pt, 1e-300)))
                )
            return np.where(k == 0.0, 0.0, out)
        norm = self._vcb_norm()
        with np.errstate(divide="ignore", invalid="ignore"):
            out = norm * self._vcb_shape(k) / k**3
        return np.where(k == 0.0, 0.0, out)

    def _vcb_silk_k(self):
        obhh = self.OMb * self.hlittle**2
        return 1.6 * obhh**0.52 * self._omhh**0.73 * (
            1.0 + (10.4 * self._omhh) ** -0.95
        )

    def _vcb_shape(self, k):
        """Dimensionless Delta^2-like shape of the v_cb spectrum (unnormalized)."""
        k = np.asarray(k, dtype=np.float64)
        s = self._sound_horizon
        ksilk = self._vcb_silk_k()
        rise = (k * s) ** 2 / (1.0 + (k * s) ** 2)
        osc = np.cos(k * s) ** 2
        damp = np.exp(-2.0 * (k / ksilk) ** 1.4)
        return rise * osc * damp

    def _vcb_norm(self):
        cached = getattr(self, "_vcb_norm_cache", None)
        if cached is None:
            lnk = np.linspace(np.log(1e-4), np.log(1e2), 4096)
            integral = np.trapezoid(self._vcb_shape(np.exp(lnk)), lnk)
            sigma_sq = (self.V_CB_AVG * np.sqrt(3.0 * np.pi / 8.0)) ** 2
            cached = self._vcb_norm_cache = 2.0 * np.pi**2 * sigma_sq / integral
        return cached

    # ------------------------------------------------------------------ sigma
    def MtoR(self, M):
        """Mass -> filter radius [Mpc] (reference cosmology.c:593-603)."""
        if self.filter_type == FILTER_TOPHAT:
            return (3.0 * np.asarray(M) / (4.0 * np.pi * self.rho_mean)) ** (1.0 / 3.0)
        if self.filter_type == FILTER_GAUSSIAN:
            return (np.asarray(M) / ((2 * np.pi) ** 1.5 * self.rho_mean)) ** (1.0 / 3.0)
        raise ValueError("M<->R conversion requires tophat or gaussian filter")

    def RtoM(self, R):
        if self.filter_type == FILTER_TOPHAT:
            return (4.0 / 3.0) * np.pi * np.asarray(R) ** 3 * self.rho_mean
        if self.filter_type == FILTER_GAUSSIAN:
            return (2 * np.pi) ** 1.5 * self.rho_mean * np.asarray(R) ** 3
        raise ValueError("M<->R conversion requires tophat or gaussian filter")

    def _sigma_of_R(self, R):
        """sigma(R) at z=0, vectorized over R via shared GL nodes in u=kR."""
        R = np.atleast_1d(np.asarray(R, dtype=np.float64))
        u = self._gl_u  # (N,)
        w = self._gl_w
        W2 = _WINDOWS[self.filter_type](u) ** 2
        k = u[None, :] / R[:, None]  # (nR, N)
        p = self.power_in_k(k)
        integ = (k * k * p) * (W2 * w)[None, :] / (2.0 * np.pi**2)
        var = integ.sum(axis=1) / R
        return np.sqrt(var)

    def sigma_z0(self, M):
        """sigma(M) at z=0 (matches reference sigma_z0 to ~1e-6)."""
        M = np.asarray(M, dtype=np.float64)
        return self._sigma_of_R(self.MtoR(M)).reshape(np.shape(M))

    def _dsigmasq_dm_of_R(self, R):
        """d sigma^2 / dM, vectorized (reference dsigmasqdm_z0:421, dwdm_filter)."""
        R = np.atleast_1d(np.asarray(R, dtype=np.float64))
        u = self._gl_u
        wq = self._gl_w
        k = u[None, :] / R[:, None]
        p = self.power_in_k(k)
        if self.filter_type == FILTER_TOPHAT:
            w = _w_tophat(u)
            with np.errstate(invalid="ignore", divide="ignore"):
                dwdr = (
                    9.0 * np.cos(u) * k / (u**3)[None, :]
                    + 3.0 * np.sin(u)[None, :] * (1 - 3.0 / (u * u))[None, :] / (u[None, :] * R[:, None])
                )
            dwdr = np.where(u[None, :] < 1e-10, 0.0, dwdr)
            drdm = 1.0 / (4.0 * np.pi * self.rho_mean * R * R)
        elif self.filter_type == FILTER_GAUSSIAN:
            # NOTE: reference dwdm_filter uses the *unscaled* gaussian here
            w = np.exp(-u * u / 2.0)
            dwdr = -k * u[None, :] * w[None, :]
            drdm = 1.0 / ((2 * np.pi) ** 1.5 * self.rho_mean * 3.0 * R * R)
        else:
            raise ValueError("dsigma/dm only defined for tophat/gaussian")
        dw2dm = 2.0 * w[None, :] * dwdr * drdm[:, None]
        integ = (k * k * p) * dw2dm * wq[None, :] / (2.0 * np.pi**2)
        return integ.sum(axis=1) / R

    def dsigmasqdm_z0(self, M):
        M = np.asarray(M, dtype=np.float64)
        return self._dsigmasq_dm_of_R(self.MtoR(M)).reshape(np.shape(M))

    def build_sigma_table(self, m_min=1e0, m_max=1e20, n=600) -> SigmaTable:
        """Dense ln(M) table of sigma / dsigma^2/dm, shipped to device as constants."""
        ln_m = np.linspace(np.log(m_min), np.log(m_max), n)
        m = np.exp(ln_m)
        return SigmaTable(ln_m=ln_m, sigma=self.sigma_z0(m), dsigmasq_dm=self.dsigmasqdm_z0(m))

    # ------------------------------------------------------------- background
    def omega_mz(self, z):
        zp1 = 1.0 + np.asarray(z, dtype=np.float64)
        return (
            self.OMm
            * zp1**3
            / (self.OMm * zp1**3 + self.OMl + self.OMr * zp1**4 + self.OMk * zp1**2)
        )

    def deltac_nonlinear(self, z):
        """Bryan & Norman 1998 virial overdensity (relative to critical)."""
        d = self.omega_mz(z) - 1.0
        return 18 * np.pi**2 + 82 * d - 39 * d * d

    def dicke(self, z):
        """Linear growth factor D(z), normalized to D(0)=1 (cosmology.c:670-708)."""
        z = np.asarray(z, dtype=np.float64)
        tiny = 1e-4
        if abs(self.OMm - 1.0) < tiny:  # EdS
            return 1.0 / (1.0 + z)
        if (
            self.OMl > -tiny
            and abs(self.OMl + self.OMm + self.OMr - 1.0) < 0.01
            and abs(self.wl + 1.0) < tiny
        ):
            # flat LCDM: Liddle et al. 1996 fit via Carroll-Press-Turner form
            omegaM_z = self.OMm * (1 + z) ** 3 / (
                self.OMl + self.OMm * (1 + z) ** 3 + self.OMr * (1 + z) ** 4
            )
            dick_z = 2.5 * omegaM_z / (
                1.0 / 70.0 + omegaM_z * (209 - omegaM_z) / 140.0 + omegaM_z ** (4.0 / 7.0)
            )
            dick_0 = 2.5 * self.OMm / (
                1.0 / 70.0 + self.OMm * (209 - self.OMm) / 140.0 + self.OMm ** (4.0 / 7.0)
            )
            return dick_z / (dick_0 * (1.0 + z))
        if (self.OMm + self.OMl + self.OMr) < 1 + tiny and abs(self.OMl) < tiny:
            # open, zero lambda (Peebles p.53)
            x_0 = 1.0 / self.OMm - 1.0
            dick_0 = 1 + 3.0 / x_0 + 3 * np.log(np.sqrt(1 + x_0) - np.sqrt(x_0)) * np.sqrt(
                1 + x_0
            ) / x_0**1.5
            x = abs(1.0 / self.OMm - 1.0) / (1 + z)
            dick_z = 1 + 3.0 / x + 3 * np.log(np.sqrt(1 + x) - np.sqrt(x)) * np.sqrt(1 + x) / x**1.5
            return dick_z / dick_0
        raise ValueError("no growth function for this cosmology")

    def dtdz(self, z):
        """dt/dz [s] (reference cosmology.c:711-721; ignores radiation)."""
        z = np.asarray(z, dtype=np.float64)
        x = np.sqrt(self.OMl / self.OMm) * (1 + z) ** -1.5
        dxdz = np.sqrt(self.OMl / self.OMm) * (1 + z) ** -2.5 * (-1.5)
        const1 = 2 * np.sqrt(1 + self.OMm / self.OMl) / (3.0 * self.Ho)
        numer = dxdz * (1 + x * (x**2 + 1) ** -0.5)
        denom = x + np.sqrt(x**2 + 1)
        return const1 * numer / denom

    def ddicke_dt(self, z):
        """dD/dt [1/s] by the same finite difference as the reference (cosmology.c:724-730)."""
        dz = 1e-10
        return (self.dicke(z + dz) - self.dicke(z)) / dz / self.dtdz(z)

    def ddicke_dz(self, z):
        dz = 1e-10
        return (self.dicke(z + dz) - self.dicke(z)) / dz

    def hubble(self, z):
        """H(z) in 1/s."""
        zp1 = 1.0 + np.asarray(z, dtype=np.float64)
        return self.Ho * np.sqrt(self.OMm * zp1**3 + self.OMr * zp1**4 + self.OMl)

    def t_hubble(self, z):
        return 1.0 / self.hubble(z)

    def drdz_cm(self, z):
        """Comoving distance per unit redshift [cm]."""
        return (1.0 + np.asarray(z)) * physconst.c_cms * self.dtdz(z)

    def comoving_distance(self, z, n=4096):
        """Comoving distance [Mpc] from z=0 (simple composite Simpson, ~1e-8 acc)."""
        z = np.asarray(z, dtype=np.float64)
        scalar = z.ndim == 0
        zmax = float(np.max(z)) if z.size else 0.0
        zs = np.linspace(0.0, max(zmax, 1e-8), n)
        zp1 = 1.0 + zs
        integrand = (
            physconst.c_cms
            / physconst.cm_per_Mpc
            / (self.Ho * np.sqrt(self.OMm * zp1**3 + self.OMr * zp1**4 + self.OMl))
        )
        cum = np.concatenate([[0.0], np.cumsum((integrand[1:] + integrand[:-1]) / 2 * np.diff(zs))])
        out = np.interp(z, zs, cum)
        return float(out) if scalar else out

    # hydrogen/helium number densities (cm^-3, comoving at z=0)
    @property
    def N_b0(self):
        No = self.rho_crit_cgs * self.OMb * (1 - self.Y_He) / physconst.m_p
        He_No = self.rho_crit_cgs * self.OMb * self.Y_He / (4.0 * physconst.m_p)
        return No + He_No

    def TtoM(self, z, T, mu):
        """Virial temperature -> halo mass (Barkana & Loeb 2001; cosmology.c:642-658)."""
        return (
            7030.97
            / self.hlittle
            * np.sqrt(self.omega_mz(z) / (self.OMm * self.deltac_nonlinear(z)))
            * (T / (mu * (1 + z))) ** 1.5
        )
