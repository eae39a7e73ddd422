"""First-order Boltzmann solver for the relative baryon-CDM velocity transfer.

A copy of py21cmfast_tpu/cosmology/boltzmann.py (host numpy/scipy, float64,
the same numerics), kept here so that the port imports nothing of the JAX
package.  Its account follows as it stands there.

The reference obtains T_vcb(k) (and the matter transfer) from CLASS
(classy_interface.py:53-294); classy is not available in the runtime
image, so this module integrates the standard linear perturbation system
itself — CDM + baryons + photon multipoles (with polarization) + massless
neutrinos in the conformal Newtonian gauge, following Ma & Bertschinger 1995
(MB95) — well enough to tabulate

  * T_vcb(k) = |theta_b - theta_c| / k  at kinematic decoupling (units v/c
    per unit primordial curvature zeta), the quantity `power_in_vcb`
    (reference cosmology.c:310-325) needs, and
  * T_m(k, z)  (CLASS convention, delta_m per unit zeta, here with the
    opposite overall sign — only T^2 enters the power spectrum).

Numerical scheme (the parts that make it work):

  * The metric potential phi is ALGEBRAIC, from the Einstein constraints
    (MB95 eq 23a+23b combined):
        k^2 phi = -4 pi G a^2 [sum rho_i delta_i
                               + (3 aH / k^2) sum (rho_i + p_i) theta_i]
    Integrating phi as an ODE through the momentum constraint lets
    quadrature drift accumulate with no restoring force — a sustained
    spurious psi that reverses theta_c after enough acoustic cycles
    (observed: delta_m sign flips at k ~ 0.7/Mpc and a 20x blowup by
    k = 4/Mpc).  The constraint form ties phi to the integrated matter
    variables exactly, as CLASS/CAMB do.
  * The photon-baryon slip Delta = theta_g - theta_b is a STATE VARIABLE.
    Storing theta_g and theta_b separately makes the Thomson term
    kappa'(theta_g - theta_b) a catastrophic cancellation at kappa' up to
    1e9/Mpc; as a state, Delta is a diagonally stiff relaxation variable
    that an implicit integrator keeps on its slow manifold exactly.
  * Three stages per mode: a tight-coupling fluid stage deep in the
    photon-baryon era (common velocity, first-order shear
    sigma_g = 16/45 theta/kappa' carrying the dominant Silk damping), the
    full hierarchy with the slip variable through recombination, and a
    matter-only stage (CDM + baryons, psi = phi) once radiation
    perturbations stop mattering for the potentials (a > A_LATE and
    k tau >> 1) — the analog of CLASS's radiation-streaming approximation,
    without which every sub-horizon radiation multipole must be tracked to
    z = 0.
  * Sub-horizon neutrinos switch to a fluid closure (CLASS's UFA idea):
    the l=3 recursion asymptote closes the shear equation as
    sigma' = (2/3) theta - 3 sigma/tau, phase-mixing the free-streaming
    oscillations instead of reflecting them off l_max.

Everything is host-side float64 numpy/scipy; the output ships as package
data (see scripts/r4_make_class_tables.py) and loads through the same
`register_class_transfer` path a live CLASS run would use.

STATUS (round 5): production-usable.  After fixing the super-horizon phi
carriage, the tau(a) integration constant, the output gauge (CLASS's
`d_m` is the COMOVING gauge-invariant density even under
`gauge: Newtonian` — the 3 aH theta/k^2 shift is (aH/k)^2-scaled and was
the former +7% low-k "shape error"), and adding the reference's 0.06 eV
massive neutrino (exact Fermi-Dirac background + hierarchy-then-fluid
perturbations, `_init_ncdm_background`/`_dFnc` — the reference's CLASS
runs put it ON TOP of Omega_cdm = OMm - OMb, inputs.py:562-565), the z=0
delta_m SHAPE agrees with the gold CLASS table to +-0.7% for
k = 0.03-1/Mpc and +-1.2% over the full k = 1.2e-3-1/Mpc band (BAO
wiggles resolved; the residual is a low-k hump from the truncated
adiabatic ICs feeding the phi-state stage — X_ALG=8 minimizes it — plus
Saha+Peebles vs RECFAST recombination; the constant ~+3% amplitude
offset cancels under the SIGMA_8 normalization every consumer applies).
The T_vcb(z_dec) band reproduces CLASS's V_CB_RMS to ~3% (the ncdm is
still relativistic at z_dec and N_ur + ncdm matches the massless 3.044
there to <0.1%, so the bundled vcb table predates the ncdm terms
unchanged).  `generate_transfer_tables` produces CLASS-convention
(k, T_density, T_vcb) tables for ANY cosmology on the reference's
k_transfer grid — the classy-free replacement for the reference's live
CLASS run — and the bundled Planck18 package data
(_data/class_transfer_density_planck18.dat, class_transfer_vcb_planck18.dat)
ships through this path (scripts/r5_make_vcb_table.py).
"""

from __future__ import annotations

import numpy as np
from scipy.integrate import solve_ivp

from .constants import physconst

__all__ = ["BoltzmannSolver", "compute_vcb_transfer"]

# Mpc in cm, sigma_T in cm^2, G in cgs
_CM_PER_MPC = physconst.cm_per_Mpc
_SIGMA_T = physconst.sigma_T
_C_CMS = physconst.c_cms


class BoltzmannSolver:
    """Linear perturbations for one LCDM cosmology (no massive neutrinos).

    Units: lengths in Mpc, conformal time tau in Mpc (c=1), k in 1/Mpc.
    """

    def __init__(self, *, hlittle=0.6766, OMm=0.30966, OMb=0.04897,
                 T_cmb=2.7255, Y_He=0.245, N_ur=None, m_ncdm=0.06,
                 lmax_g=12, lmax_nu=12, lmax_pol=8):
        self.h = float(hlittle)
        self.OMm = float(OMm)
        self.OMb = float(OMb)
        self.OMc = self.OMm - self.OMb
        self.T_cmb = float(T_cmb)
        self.Y_He = float(Y_He)
        self.m_ncdm = float(m_ncdm)
        self.lmax_g = int(lmax_g)
        self.lmax_nu = int(lmax_nu)
        self.lmax_pol = int(lmax_pol)
        # the reference's CLASS setup (classy_interface.py:32-50): one 0.06 eV
        # massive neutrino on TOP of Omega_cdm = OMm - OMb (inputs.py:562-565)
        # plus N_ur = 2.0308 massless species; with m_ncdm = 0 all 3.044 are
        # massless and Omega_m = OMm exactly.
        if N_ur is None:
            N_ur = 2.0308 if self.m_ncdm > 0 else 3.044
        self.N_ur = float(N_ur)

        H0 = 100.0 * self.h / (_C_CMS * 1e-5)  # 1/Mpc (H0/c)
        self.H0 = H0
        # photon + neutrino densities today (Omega h^2 from T_cmb)
        omega_g = 2.47282e-5 * (self.T_cmb / 2.7255) ** 4  # Omega_gamma h^2
        self.OMg = omega_g / self.h**2
        self.OMnu = self.OMg * (7.0 / 8.0) * (4.0 / 11.0) ** (4.0 / 3.0) * N_ur
        self._init_ncdm_background()
        self.OMr = self.OMg + self.OMnu  # strictly-massless radiation
        # early-time radiation total (for tau(a)'s integration constant):
        # the ncdm is relativistic there, rho a^4 -> its massless limit
        self.OMr_early = self.OMr + self.OMnc_rel
        self.OMl = 1.0 - self.OMc - self.OMb - self.OMr - self.OMnc0

        # comoving baryon number densities for the Thomson term
        rho_crit = 3 * (self.h * 3.2407e-18) ** 2 / (8 * np.pi * physconst.G)
        self.n_H0 = rho_crit * self.OMb * (1 - self.Y_He) / physconst.m_p  # cm^-3

        self._xe_tab = None
        # background tau(a) lookup, shared by every solve_k call.  The lower
        # edge must sit below a(tau0) for the HIGHEST k served: tau0 = 0.05/k
        # and tau(1e-11) ~ 4.6e-6 Mpc covers k up to ~1e4/Mpc (a tau0 clamped
        # to the grid edge re-introduces the tau/a desync fixed in
        # tau_of_a_grid for k > 108).
        self._a_grid = np.logspace(-11.5, 0.001, 9000)
        self._tau_grid = self.tau_of_a_grid(self._a_grid)

    # ---------------------------------------------------------------- background
    def _init_ncdm_background(self):
        """Exact massive-neutrino background from the Fermi-Dirac momentum
        integrals, tabulated over the dimensionless mass r = m a / T_nc0:

          rho(a) a^4 = OMnc_rel * I_rho(r)/I_rho(0),
          P(a)  a^4 = OMnc_rel * I_P(r)/I_rho(0),
          I_rho = int q^2 sqrt(q^2+r^2) f(q) dq,  I_P = int q^4/(3 sqrt) f dq

        with T_ncdm = 0.71611 T_cmb (CLASS's default, which makes
        Omega_ncdm h^2 = m/93.14 eV) and OMnc_rel the massless-limit Omega of
        one such species.  w(a) and the adiabatic c_a^2 = P'/rho' feed the
        late-stage fluid closure."""
        self.has_ncdm = self.m_ncdm > 0
        if not self.has_ncdm:
            self.OMnc_rel = 0.0
            self.OMnc0 = 0.0
            return
        T_nc = 0.71611 * self.T_cmb      # K
        T_nc_eV = T_nc * 8.617333e-5     # eV
        self.OMnc_rel = self.OMg * (7.0 / 8.0) * 0.71611**4

        q = np.linspace(1e-4, 50.0, 4000)
        fq = 1.0 / (np.exp(q) + 1.0)
        r_grid = np.concatenate([[0.0], np.logspace(-4, np.log10(2e4), 400)])
        eps = np.sqrt(q[None, :] ** 2 + r_grid[:, None] ** 2)
        i0 = np.trapezoid(q**3 * fq, q)
        i_rho = np.trapezoid(q[None, :] ** 2 * eps * fq[None, :], q, axis=1) / i0
        i_p = np.trapezoid(
            q[None, :] ** 4 / (3.0 * eps) * fq[None, :], q, axis=1) / i0
        self._nc_r = r_grid
        self._nc_irho = i_rho
        self._nc_ip = i_p
        self._nc_m_over_T = self.m_ncdm / T_nc_eV  # = r at a = 1
        self.OMnc0 = float(self._rho_nc(1.0))
        # adiabatic sound speed c_a^2 = dP/drho: with rho a^4 = C I_rho(r),
        # P a^4 = C I_P(r) and r proportional to a,
        # dP/da = C (r I_P' - 4 I_P)/a^5 (same for rho), so
        # c_a^2 = (r I_P' - 4 I_P) / (r I_rho' - 4 I_rho)
        dp = np.gradient(i_p, r_grid)
        drho = np.gradient(i_rho, r_grid)
        with np.errstate(invalid="ignore", divide="ignore"):
            ca2 = (r_grid * dp - 4.0 * i_p) / (r_grid * drho - 4.0 * i_rho)
        ca2[0] = 1.0 / 3.0
        self._nc_ca2 = np.clip(ca2, 0.0, 1.0 / 3.0)

    def _nc_interp(self, table, a):
        r = self._nc_m_over_T * np.asarray(a, np.float64)
        return np.interp(r, self._nc_r, table)

    def _rho_nc(self, a):
        """ncdm density in Omega units (rho/rho_crit0)."""
        if not self.has_ncdm:
            return np.zeros_like(np.asarray(a, np.float64))
        a = np.asarray(a, np.float64)
        return self.OMnc_rel * self._nc_interp(self._nc_irho, a) / a**4

    def _p_nc(self, a):
        if not self.has_ncdm:
            return np.zeros_like(np.asarray(a, np.float64))
        a = np.asarray(a, np.float64)
        return self.OMnc_rel * self._nc_interp(self._nc_ip, a) / a**4

    def _ca2_nc(self, a):
        return self._nc_interp(self._nc_ca2, a)

    def hubble_conf(self, a):
        """Conformal Hubble a'/a in 1/Mpc."""
        if self.has_ncdm:
            a = np.asarray(a, np.float64)
            return self.H0 * np.sqrt(
                (self.OMc + self.OMb) / a + self.OMr / a**2 + self.OMl * a**2
                + a**2 * self._rho_nc(a)
            )
        return self.H0 * np.sqrt(
            self.OMm / a + self.OMr / a**2 + self.OMl * a**2
        )

    def tau_of_a_grid(self, a_grid):
        """Conformal time tau(a) in Mpc by quadrature.

        The integration constant matters: tau(a_min) is NOT zero but the
        exact radiation-era value a_min / (H0 sqrt(OMr)).  Omitting it
        desynchronizes a(tau) from tau by ~1e-3 Mpc, which breaks the
        -aH psi vs momentum-term cancellation in phi' for modes whose
        integration starts at small tau0 (high k): phi decayed at x < 1
        and every k >~ 2 locked onto a sign-flipped growing mode."""
        from scipy.integrate import cumulative_trapezoid

        integrand = 1.0 / (a_grid**2 * (self.hubble_conf(a_grid) / a_grid))
        tau0 = a_grid[0] / (self.H0 * np.sqrt(self.OMr_early))
        tau = cumulative_trapezoid(integrand, a_grid, initial=0.0) + tau0
        return tau

    # ------------------------------------------------------------- recombination
    def x_e(self, z):
        """Free-electron fraction n_e/n_H: Saha (H + He) above z=1500,
        Peebles three-level solve below (recombination._solve)."""
        if self._xe_tab is None:
            self._xe_tab = self._build_xe_table()
        zt, xt = self._xe_tab
        return np.interp(np.log(1 + np.asarray(z)), zt, xt)

    def _build_xe_table(self):
        f_He = self.Y_He / (3.9715 * (1 - self.Y_He))
        # low-z: Peebles solver for this cosmology
        from .recombination import _solve

        z_lo, x_lo, _T = _solve((self.h, self.OMm, self.OMb,
                                 self.OMr, self.OMl, self.Y_He))
        # high-z: Saha for H; He singly/doubly ionized steps
        z_hi = np.logspace(np.log10(1500.0), 7.5, 600)
        T = self.T_cmb * (1 + z_hi)
        kT_eV = physconst.k_B * T / 1.60218e-12
        n_H = self.n_H0 * (1 + z_hi) ** 3
        saha = 2.4147e15 * T**1.5 * np.exp(-13.5984 / kT_eV) / n_H
        x_H = 0.5 * (-saha + np.sqrt(saha**2 + 4 * saha))
        x_H = np.clip(x_H, 0.0, 1.0)
        # He: doubly ionized above ~ kT > 54.4/35, singly above 24.6/30 (Saha-ish)
        saha2 = 2.4147e15 * T**1.5 * np.exp(-54.4178 / kT_eV) / n_H * 4.0
        x_he2 = 0.5 * (-saha2 + np.sqrt(saha2**2 + 4 * saha2))
        saha1 = 2.4147e15 * T**1.5 * np.exp(-24.5874 / kT_eV) / n_H * 4.0
        x_he1 = 0.5 * (-saha1 + np.sqrt(saha1**2 + 4 * saha1))
        x_hi = x_H + f_He * (np.clip(x_he1, 0, 1) + np.clip(x_he2, 0, 1))

        sel = z_lo <= 1500.0
        z_all = np.concatenate([z_lo[sel], z_hi])
        x_all = np.concatenate([x_lo[sel], x_hi])
        order = np.argsort(z_all)
        return np.log(1 + z_all[order]), x_all[order]

    def dkappa_dtau(self, a):
        """Thomson opacity a n_e sigma_T, in 1/Mpc."""
        z = 1.0 / a - 1.0
        n_e = self.x_e(z) * self.n_H0 / a**3  # cm^-3
        return a * n_e * _SIGMA_T * _CM_PER_MPC

    def _cs2_baryon(self, a):
        """Baryon sound speed squared (units of c^2), T_b = T_gamma (tightly
        coupled; adequate through decoupling, after which the term is
        negligible at the k this solver serves)."""
        T_b = self.T_cmb / a
        mu = 1.0 / (1 - 0.75 * self.Y_He)
        return (physconst.k_B * T_b / (mu * physconst.m_p)) / (_C_CMS**2) * (4.0 / 3.0)

    # --------------------------------------------------------------- potentials
    def _potentials(self, a, ach, k, dens, mom, shear_src):
        """phi, psi, phi' from the Einstein constraints (MB95 eq 23):
        dens = sum rho_i delta_i, mom = sum (rho_i+p_i) theta_i,
        shear_src = sum (rho_i+p_i) sigma_i; rho in Omega_i/a^n units.

        VALID ONLY SUB-HORIZON (k tau >~ X_ALG): super-horizon, dens and
        3 ach mom / k^2 cancel to O((k tau)^2), so phi reconstructed this way
        amplifies any state error by ~1.5 (aH/k)^2 — the O((k tau0)^2)
        IC truncation then feeds back through k^2 psi and corrupts every
        mode by O(1) before horizon entry (the round-4 'flat low-k /
        contaminated high-k' z=0 shape).  While k tau < X_ALG the solver
        instead carries phi as a state variable (`_potentials_from_phi`)."""
        H0sq = self.H0**2
        phi = -1.5 * H0sq * a**2 * (dens + 3.0 * ach * mom / k**2) / k**2
        psi = phi - 4.5 * H0sq * a**2 * shear_src / k**2
        dphi = -ach * psi + 1.5 * H0sq * a**2 * mom / k**2
        return phi, psi, dphi

    def _potentials_from_phi(self, a, ach, k, phi, mom, shear_src):
        """psi, phi' with phi CARRIED AS A STATE VARIABLE: psi from the
        anisotropic-stress constraint (additive, no cancellation), phi' from
        the momentum constraint (MB95 eq 23b).  Used while k tau < X_ALG,
        where the algebraic 00-constraint reconstruction is singular (see
        `_potentials`); phi(tau0) is set to its exact analytic adiabatic
        value, so no cancellation ever determines it."""
        H0sq = self.H0**2
        psi = phi - 4.5 * H0sq * a**2 * shear_src / k**2
        dphi = -ach * psi + 1.5 * H0sq * a**2 * mom / k**2
        return phi, psi, dphi

    # ------------------------------------------------------------------- the ODE
    # Full-hierarchy state layout:
    #   [a, d_c, th_c, d_b, th_b, Delta, F0, F2..F_lg, G0..G_lp, F_nu 0..l]
    # where Delta = theta_g - theta_b is the photon-baryon slip; F1 is NOT
    # stored (theta_g = th_b + Delta; F1 = 4 theta_g / 3k) and phi is
    # algebraic.

    def _n_full(self):
        n = 6 + 1 + (self.lmax_g - 1) + (self.lmax_pol + 1) + (self.lmax_nu + 1)
        if self.has_ncdm:
            n += self.lmax_nu + 1  # ncdm hierarchy block (massless-form)
        return n

    def _rhs(self, tau, y, k, phi_state=False):
        lg, ln, lp = self.lmax_g, self.lmax_nu, self.lmax_pol
        a = y[0]
        ach = self.hubble_conf(a)
        da = a * ach

        d_c, th_c = y[1], y[2]
        d_b, th_b = y[3], y[4]
        Delta = y[5]
        d_g = y[6]
        Fg2 = y[7: 7 + lg - 1]          # F_2 .. F_lg
        i = 7 + lg - 1
        Gp = y[i: i + lp + 1]; i += lp + 1
        Fn = y[i: i + ln + 1]; i += ln + 1
        Fnc = y[i: i + ln + 1] if self.has_ncdm else None

        th_g = th_b + Delta
        sig_g = 0.5 * Fg2[0]
        d_n = Fn[0]
        th_n = 0.75 * k * Fn[1]
        sig_n = 0.5 * Fn[2]

        rho_c = self.OMc / a**3
        rho_b = self.OMb / a**3
        rho_g = self.OMg / a**4
        rho_n = self.OMnu / a**4

        dens = rho_c * d_c + rho_b * d_b + rho_g * d_g + rho_n * d_n
        mom = (rho_c * th_c + rho_b * th_b
               + (4.0 / 3.0) * (rho_g * th_g + rho_n * th_n))
        shear_src = (4.0 / 3.0) * (rho_g * sig_g + rho_n * sig_n)
        if self.has_ncdm:
            # massive neutrino: massless-form hierarchy (exact while
            # relativistic; the semi/non-relativistic evolution is handled by
            # the late-stage fluid), exact rho(a)/P(a) in the Einstein sources
            rho_nc = float(self._rho_nc(a))
            rpp_nc = rho_nc + float(self._p_nc(a))
            th_nc = 0.75 * k * Fnc[1]
            dens += rho_nc * Fnc[0]
            mom += rpp_nc * th_nc
            shear_src += rpp_nc * 0.5 * Fnc[2]
        if phi_state:
            phi, psi, dphi = self._potentials_from_phi(
                a, ach, k, y[-1], mom, shear_src)
        else:
            phi, psi, dphi = self._potentials(a, ach, k, dens, mom, shear_src)

        kap = self.dkappa_dtau(a)
        R = (4.0 / 3.0) * rho_g / rho_b
        cs2 = self._cs2_baryon(a)

        dd_c = -th_c + 3 * dphi
        dth_c = -ach * th_c + k**2 * psi

        dd_b = -th_b + 3 * dphi
        dth_b = (-ach * th_b + cs2 * k**2 * d_b + k**2 * psi
                 + R * kap * Delta)
        # slip: Delta' = theta_g' - theta_b'
        dth_g_nc = k**2 * (0.25 * d_g - sig_g) + k**2 * psi  # non-collisional part
        dDelta = (dth_g_nc - kap * Delta) - dth_b

        dd_g = -(4.0 / 3.0) * th_g + 4 * dphi

        Pi = Fg2[0] + Gp[0] + (Gp[2] if lp >= 2 else 0.0)
        dFg2 = np.empty_like(Fg2)
        # F2' = 8/15 th_g - 3/5 k F3 - 9/5 kap sig_g + 1/10 kap (G0 + G2)
        F3 = Fg2[1] if lg >= 3 else 0.0
        dFg2[0] = ((8.0 / 15.0) * th_g - (3.0 / 5.0) * k * F3
                   - 1.8 * kap * sig_g
                   + 0.1 * kap * (Gp[0] + (Gp[2] if lp >= 2 else 0.0)))
        for ell in range(3, lg):
            dFg2[ell - 2] = ((k / (2 * ell + 1)) * (ell * Fg2[ell - 3]
                                                    - (ell + 1) * Fg2[ell - 1])
                             - kap * Fg2[ell - 2])
        # truncation (MB95 eq 51)
        dFg2[lg - 2] = (k * Fg2[lg - 3] - ((lg + 1) / max(tau, 1e-12)) * Fg2[lg - 2]
                        - kap * Fg2[lg - 2])

        dGp = np.empty_like(Gp)
        for ell in range(0, lp):
            below = Gp[ell - 1] if ell >= 1 else 0.0
            dGp[ell] = ((k / (2 * ell + 1)) * (ell * below - (ell + 1) * Gp[ell + 1])
                        + kap * (-Gp[ell]
                                 + 0.5 * Pi * ((1.0 if ell == 0 else 0.0)
                                               + (0.2 if ell == 2 else 0.0))))
        dGp[lp] = (k * Gp[lp - 1] - ((lp + 1) / max(tau, 1e-12)) * Gp[lp]
                   - kap * Gp[lp])

        dFn = self._dFn(Fn, tau, k, dphi, psi)

        out = np.empty_like(y)
        out[0] = da
        out[1] = dd_c; out[2] = dth_c
        out[3] = dd_b; out[4] = dth_b
        out[5] = dDelta
        out[6] = dd_g
        out[7: 7 + lg - 1] = dFg2
        i = 7 + lg - 1
        out[i: i + lp + 1] = dGp; i += lp + 1
        out[i: i + ln + 1] = dFn; i += ln + 1
        if self.has_ncdm:
            out[i: i + ln + 1] = self._dFnc(Fnc, tau, k, dphi, psi, a)
        if phi_state:
            out[-1] = dphi
        return out

    # Massless-neutrino block.  Deep sub-horizon (k tau > UFA_KTAU) the
    # truncated hierarchy reflects power off l_max and corrupts the
    # potentials exactly where neutrinos carry 40% of the energy (RD); the
    # standard cure (CLASS's ultra-relativistic fluid approximation,
    # Blas/Lesgourgues/Tram 2011) closes the system at the fluid level.  Here
    # the l=3 recursion asymptote F3 = (5/k tau) F2 - F1 closes the shear
    # equation: sigma' = (2/3) theta - 3 sigma / tau, which phase-mixes the
    # free-streaming oscillations instead of reflecting them.
    UFA_KTAU = 30.0

    def _dFn(self, Fn, tau, k, dphi, psi):
        ln = self.lmax_nu
        th_n = 0.75 * k * Fn[1]
        sig_n = 0.5 * Fn[2]
        d_n = Fn[0]

        dFn = np.zeros_like(Fn)
        dFn[0] = -(4.0 / 3.0) * th_n + 4 * dphi
        dth_n = k**2 * (0.25 * d_n - sig_n) + k**2 * psi
        dFn[1] = (4.0 / (3.0 * k)) * dth_n
        if k * tau > self.UFA_KTAU:
            # fluid closure; higher moments frozen (they no longer feed back)
            dFn[2] = k * Fn[1] - 3.0 * Fn[2] / tau
            return dFn
        if ln >= 3:
            dFn[2] = (8.0 / 15.0) * th_n - (3.0 / 5.0) * k * Fn[3]
        for ell in range(3, ln):
            dFn[ell] = (k / (2 * ell + 1)) * (ell * Fn[ell - 1]
                                              - (ell + 1) * Fn[ell + 1])
        dFn[ln] = k * Fn[ln - 1] - ((ln + 1) / max(tau, 1e-12)) * Fn[ln]
        return dFn

    # CLASS's ncdm fluid trigger: sub-horizon (k tau > ~31) the massive
    # neutrino hierarchy hands over to a 3-moment fluid with the adiabatic
    # c_a^2(a) — which also carries the non-relativistic transition
    # (clustering below k_fs) that the massless-form hierarchy cannot.
    # Without this, modes that never reach the LATE stage (low k) kept
    # radiation-form ncdm to z=0 while high-k modes got the late-stage
    # fluid — a ~1% spurious step across k = 0.002-0.04/Mpc.
    NC_FLUID_KTAU = 31.0

    def _dFnc(self, Fnc, tau, k, dphi, psi, a):
        """Massive-neutrino block: massless-form hierarchy while
        super-horizon-ish/relativistic, 3-moment adiabatic fluid once
        k tau > NC_FLUID_KTAU.  Slot convention matches the massless block
        (delta in [0], theta = 0.75 k F1, sigma = 0.5 F2), so the regime
        switch and the late-stage handoff are state-identity maps."""
        if k * tau <= self.NC_FLUID_KTAU:
            return self._dFn(Fnc, tau, k, dphi, psi)
        w = float(self._p_nc(a)) / float(self._rho_nc(a))
        ca2 = float(self._ca2_nc(a))
        ach = self.hubble_conf(a)
        d = Fnc[0]
        th = 0.75 * k * Fnc[1]
        sig = 0.5 * Fnc[2]
        dFnc = np.zeros_like(Fnc)
        dFnc[0] = -(1.0 + w) * (th - 3.0 * dphi) - 3.0 * ach * (ca2 - w) * d
        dth = (-ach * (1.0 - 3.0 * ca2) * th
               + (ca2 / (1.0 + w)) * k**2 * d - k**2 * sig + k**2 * psi)
        dFnc[1] = dth / (0.75 * k)
        dFnc[2] = -6.0 * ach * sig  # source-free decay; feedback is (rho+P)-suppressed
        return dFnc

    # ------------------------------------------------- tight-coupling stage
    # Deep in the photon-baryon era kappa' reaches ~1e9/Mpc; even with the
    # slip variable the full hierarchy wastes steps there.  Evolve one
    # combined fluid (common velocity th, first-order shear
    # sigma_g = 16/45 th/kappa' — the dominant 16/15 part of the Silk
    # damping rate) until kappa' < S max(k, aH), then hand over.
    # TC state: [a, d_c, th_c, d_b, th, d_g, F_nu 0..l]

    def _rhs_tc(self, tau, y, k, phi_state=False):
        ln = self.lmax_nu
        a = y[0]
        ach = self.hubble_conf(a)
        da = a * ach

        d_c, th_c = y[1], y[2]
        d_b, th = y[3], y[4]
        d_g = y[5]
        Fn = y[6: 6 + ln + 1]
        Fnc = y[6 + ln + 1: 6 + 2 * (ln + 1)] if self.has_ncdm else None

        th_n = 0.75 * k * Fn[1]
        sig_n = 0.5 * Fn[2]
        d_n = Fn[0]

        kap = self.dkappa_dtau(a)
        sig_g = (16.0 / 45.0) * th / kap

        rho_c = self.OMc / a**3
        rho_b = self.OMb / a**3
        rho_g = self.OMg / a**4
        rho_n = self.OMnu / a**4

        dens = rho_c * d_c + rho_b * d_b + rho_g * d_g + rho_n * d_n
        mom = (rho_c * th_c + rho_b * th
               + (4.0 / 3.0) * (rho_g * th + rho_n * th_n))
        shear_src = (4.0 / 3.0) * (rho_g * sig_g + rho_n * sig_n)
        if self.has_ncdm:
            rho_nc = float(self._rho_nc(a))
            rpp_nc = rho_nc + float(self._p_nc(a))
            dens += rho_nc * Fnc[0]
            mom += rpp_nc * 0.75 * k * Fnc[1]
            shear_src += rpp_nc * 0.5 * Fnc[2]
        if phi_state:
            phi, psi, dphi = self._potentials_from_phi(
                a, ach, k, y[-1], mom, shear_src)
        else:
            phi, psi, dphi = self._potentials(a, ach, k, dens, mom, shear_src)

        R = (4.0 / 3.0) * rho_g / rho_b
        cs2 = self._cs2_baryon(a)

        dd_c = -th_c + 3 * dphi
        dth_c = -ach * th_c + k**2 * psi
        dd_b = -th + 3 * dphi
        dd_g = -(4.0 / 3.0) * th + 4 * dphi
        dth = ((-ach * th + cs2 * k**2 * d_b
                + R * k**2 * (0.25 * d_g - sig_g)) / (1.0 + R)
               + k**2 * psi)

        dFn = self._dFn(Fn, tau, k, dphi, psi)

        out = np.empty_like(y)
        out[0] = da
        out[1] = dd_c; out[2] = dth_c
        out[3] = dd_b; out[4] = dth
        out[5] = dd_g
        out[6: 6 + ln + 1] = dFn
        if self.has_ncdm:
            out[6 + ln + 1: 6 + 2 * (ln + 1)] = self._dFnc(
                Fnc, tau, k, dphi, psi, a)
        if phi_state:
            out[-1] = dphi
        return out

    # -------------------------------------------------------- late matter stage
    # Once a > A_LATE and k tau >> 1, radiation perturbations are irrelevant
    # for the potentials (rho_r delta_r / rho_m delta_m << 1% sub-horizon) and
    # residual Thomson drag is negligible: CDM + baryons with psi = phi.
    # State: [a, d_c, th_c, d_b, th_b]

    def _rhs_late(self, tau, y, k):
        a = y[0]
        ach = self.hubble_conf(a)
        d_c, th_c = y[1], y[2]
        d_b, th_b = y[3], y[4]

        rho_c = self.OMc / a**3
        rho_b = self.OMb / a**3
        dens = rho_c * d_c + rho_b * d_b
        mom = rho_c * th_c + rho_b * th_b
        if self.has_ncdm:
            # ncdm as an adiabatic fluid (sigma dropped): this stage spans
            # the non-relativistic transition (z_nr ~ 110 for 0.06 eV), so
            # w(a) and c_a^2(a) from the exact background carry both the
            # rho a^-4 -> a^-3 handover and the free-streaming k^2 c_a^2
            # pressure that suppresses sub-k_fs clustering.
            d_nc, th_nc = y[5], y[6]
            rho_nc = float(self._rho_nc(a))
            p_nc = float(self._p_nc(a))
            w = p_nc / rho_nc
            ca2 = float(self._ca2_nc(a))
            dens += rho_nc * d_nc
            mom += (rho_nc + p_nc) * th_nc
        phi, psi, dphi = self._potentials(a, ach, k, dens, mom, 0.0)
        cs2 = self._cs2_baryon(a)

        out = [
            a * ach,
            -th_c + 3 * dphi,
            -ach * th_c + k**2 * psi,
            -th_b + 3 * dphi,
            -ach * th_b + cs2 * k**2 * d_b + k**2 * psi,
        ]
        if self.has_ncdm:
            out.append(-(1.0 + w) * (th_nc - 3 * dphi)
                       - 3 * ach * (ca2 - w) * d_nc)
            out.append(-ach * (1.0 - 3 * ca2) * th_nc
                       + (ca2 / (1.0 + w)) * k**2 * d_nc + k**2 * psi)
        return np.array(out)

    # --------------------------------------------------------- initial conditions
    def _adiabatic_ic_tc(self, k, tau0, a0):
        """Super-horizon adiabatic ICs for the TC stage, normalized to
        comoving curvature R = 1 (MB95 eq 98).

        In the radiation era with the constant growing mode, the comoving
        curvature is R = psi (3/2 + 2 R_nu / 5), so psi = 1/(3/2 + 2 R_nu/5)
        gives unit curvature — the CLASS transfer normalization."""
        ln = self.lmax_nu
        rho_n = self.OMnu / a0**4 + float(self._rho_nc(a0))  # ncdm relativistic
        rho_g = self.OMg / a0**4
        R_nu = rho_n / (rho_n + rho_g)
        psi = 1.0 / (1.5 + 0.4 * R_nu)
        phi = (1.0 + 2.0 * R_nu / 5.0) * psi
        kt = k * tau0
        d_g = -2.0 * psi
        th = 0.5 * k * kt * psi  # = k^2 tau / 2 * psi

        nblk = (ln + 1) * (2 if self.has_ncdm else 1)
        y = np.zeros(6 + nblk + 1)
        y[0] = a0
        y[1] = 0.75 * d_g; y[2] = th   # CDM
        y[3] = 0.75 * d_g; y[4] = th   # photon-baryon common velocity
        y[5] = d_g
        for blk in range(2 if self.has_ncdm else 1):
            j = 6 + blk * (ln + 1)
            y[j] = d_g                     # neutrino F0 (delta_nu = delta_g)
            y[j + 1] = 4.0 / (3.0 * k) * th  # neutrino F1
            if ln >= 2:
                # MB95 eq 98: sigma_nu = (k tau)^2 (phi+psi)/15; F2 = 2 sigma
                y[j + 2] = 2.0 * kt**2 * (phi + psi) / 15.0
        y[-1] = phi                    # phi carried as a state while k tau < X_ALG
        return y

    def _tc_to_full(self, y_tc, k, phi_state=False):
        """Map the TC state onto the full hierarchy at the switch, seeding
        Delta/F2/F3/G0/G1/G2 with their first-order tight-coupling values
        (sigma_g = 16/45 th/kap, Pi = 5 sigma, G0 = 5 sig/2, G2 = sig/2).
        With phi_state both states carry phi as their last entry."""
        lg, ln, lp = self.lmax_g, self.lmax_nu, self.lmax_pol
        a = y_tc[0]
        th = y_tc[4]
        d_g = y_tc[5]
        d_b = y_tc[3]
        kap = self.dkappa_dtau(a)
        ach = self.hubble_conf(a)
        sig = (16.0 / 45.0) * th / kap
        # zeroth-order slip: Delta relaxes to
        # [k^2 (delta_g/4 - sigma) + H th - cs2 k^2 d_b] / ((1+R) kap)
        R = (4.0 / 3.0) * (self.OMg / a**4) / (self.OMb / a**3)
        cs2 = self._cs2_baryon(a)
        Delta0 = (k**2 * (0.25 * d_g - sig) + ach * th
                  - cs2 * k**2 * d_b) / ((1.0 + R) * kap)

        y = np.zeros(self._n_full() + (1 if phi_state else 0))
        y[0:4] = y_tc[0:4]
        y[4] = th - Delta0 * R / (1.0 + R)   # theta_b (th was the mixture velocity)
        y[5] = Delta0
        y[6] = d_g
        y[7] = 2.0 * sig                      # F2
        if lg >= 3:
            y[8] = 3.0 * k * (2.0 * sig) / (7.0 * kap)  # F3
        i = 7 + lg - 1
        y[i] = 2.5 * sig                      # G0
        if lp >= 1:
            y[i + 1] = 0.5 * k * sig / kap    # G1 = (k/3kap)(G0 - 2 G2)
        if lp >= 2:
            y[i + 2] = 0.5 * sig              # G2
        i += lp + 1
        nblk = (ln + 1) * (2 if self.has_ncdm else 1)
        y[i: i + nblk] = y_tc[6: 6 + nblk]
        if phi_state:
            y[-1] = y_tc[-1]
        return y

    # ----------------------------------------------------------------- the solve
    A_START_MAX = 1e-5    # ICs must sit deep in radiation domination
    A_SWITCH_MAX = 4e-4   # hierarchy must be live well before recombination
    A_LATE = 2.5e-3       # z ~ 400: radiation forcing of phi is < 1% sub-horizon
    KTAU_LATE = 25.0      # ...but only for well-sub-horizon modes
    X_ALG = 8.0           # k tau above which the algebraic 00-constraint phi is
                          # safe (amplification of state error ~1.5/x^2 < 3%);
                          # below it phi is carried as a state (see _potentials)

    def solve_k(self, k, z_out=(1059.94,), rtol=1e-7, atol=1e-12,
                tc_switch=500.0):
        """Integrate one k from deep radiation era to min(z_out).

        Returns dict with delta_c/delta_b/theta_c/theta_b/delta_m and v_cb
        (= |theta_b - theta_c| / k, units of c) at each z in z_out."""
        a_grid, tau_grid = self._a_grid, self._tau_grid
        # start with the mode super-horizon (k tau0 <= 0.05, IC error
        # O((k tau)^2) ~ 2.5e-3) and deep in RD
        tau0 = min(0.05 / k, float(np.interp(self.A_START_MAX, a_grid, tau_grid)))
        a0 = float(np.interp(tau0, tau_grid, a_grid))

        # TC -> full switch scale factor
        kap_grid = self.dkappa_dtau(a_grid)
        ach_grid = self.hubble_conf(a_grid)
        loose = kap_grid <= tc_switch * np.maximum(k, ach_grid)
        a_sw = float(a_grid[np.argmax(loose)]) if loose.any() else self.A_SWITCH_MAX
        a_sw = min(a_sw, self.A_SWITCH_MAX)
        tau_sw = float(np.interp(a_sw, a_grid, tau_grid))

        z_out = np.sort(np.asarray(z_out, np.float64))[::-1]
        a_out = 1.0 / (1 + z_out)
        # outputs inside the TC stage are fine: the staged march snapshots the
        # TC state (th = common velocity) directly
        tau_out = np.interp(a_out, a_grid, tau_grid)
        tau_end = float(tau_out[-1])

        # stage boundaries: phi-state -> algebraic at k tau = X_ALG; full
        # hierarchy -> matter-only once a > A_LATE and k tau > KTAU_LATE.
        tau_x = self.X_ALG / k
        tau_late = float(np.interp(self.A_LATE, a_grid, tau_grid))
        tau_late = max(tau_late, self.KTAU_LATE / k)

        # segment edges strictly inside (tau0, tau_end); regime of a segment
        # is decided by its midpoint against (tau_sw, tau_x, tau_late)
        edges = [tau0]
        for t in sorted({tau_sw, tau_x, tau_late}):
            if tau0 * 1.05 < t < tau_end:
                edges.append(t)
        edges.append(tau_end)

        y = self._adiabatic_ic_tc(k, tau0, a0)
        in_tc, has_phi = True, True
        if tau_sw <= tau0 * 1.05:
            y = self._tc_to_full(y, k, phi_state=True)
            in_tc = False

        outputs = {}
        for t_a, t_b in zip(edges[:-1], edges[1:]):
            mid = 0.5 * (t_a + t_b)
            # regime transitions at the segment head
            if in_tc and mid > tau_sw:
                y = self._tc_to_full(y, k, phi_state=has_phi)
                in_tc = False
            if has_phi and mid > tau_x:
                y = y[:-1]
                has_phi = False
            n_late = 7 if self.has_ncdm else 5
            late = (not in_tc) and mid > tau_late
            if late and len(y) > n_late:
                if self.has_ncdm:
                    # map the ncdm hierarchy onto the late fluid (delta, theta)
                    ln = self.lmax_nu
                    # full-state ncdm block starts after [6 scalars+d_g, F2.., G.., Fn..]
                    i_nc = 7 + (self.lmax_g - 1) + (self.lmax_pol + 1) + (ln + 1)
                    d_nc = y[i_nc]
                    th_nc = 0.75 * k * y[i_nc + 1]
                    y = np.concatenate([y[:5], [d_nc, th_nc]])
                else:
                    y = y[:5].copy()

            sel = (tau_out > t_a) & (tau_out <= t_b)
            t_eval = np.unique(np.concatenate([tau_out[sel], [t_b]]))
            if late:
                rhs, args = self._rhs_late, (k,)
            elif in_tc:
                rhs, args = self._rhs_tc, (k, has_phi)
            else:
                rhs, args = self._rhs, (k, has_phi)
            sol = solve_ivp(
                rhs, (t_a, t_b), y, args=args, method="BDF",
                t_eval=t_eval, rtol=rtol, atol=atol,
                **({"first_step": tau0 * 0.01} if t_a == tau0 else {}),
            )
            if not sol.success:
                raise RuntimeError(
                    f"Boltzmann stage ({'late' if late else 'tc' if in_tc else 'full'})"
                    f" failed at k={k}: {sol.message}")
            for tt, col in zip(sol.t, sol.y.T):
                for j in np.nonzero(sel)[0]:
                    if abs(tau_out[j] - tt) < 1e-9 * max(tt, 1.0):
                        # snap = (a, d_c, th_c, d_b, th_b[, d_nc, th_nc]);
                        # in the TC state th is the common velocity
                        snap = (col[0], col[1], col[2], col[3], col[4])
                        if self.has_ncdm:
                            ln2 = self.lmax_nu
                            if late:
                                snap += (col[5], col[6])
                            else:
                                i_nc = (6 if in_tc else
                                        7 + (self.lmax_g - 1)
                                        + (self.lmax_pol + 1)) + ln2 + 1
                                snap += (col[i_nc],
                                         0.75 * k * col[i_nc + 1])
                        outputs[j] = snap
            y = sol.y[:, -1]

        res = []
        rho_c, rho_b = self.OMc, self.OMb
        for j, z in enumerate(z_out):
            a, d_c, th_c, d_b, th_b = outputs[j][:5]
            d_nc = outputs[j][5] if self.has_ncdm else 0.0
            # CLASS tabulates density transfers in the SYNCHRONOUS gauge
            # comoving with CDM (its default); the integration here is
            # Newtonian.  The gauge time-shift that sets theta_c^S = 0 is
            # alpha = theta_c^N / k^2, moving every matter density by
            # 3 aH (1+w) alpha — a (aH/k)^2-scaled term that reaches ~6% of
            # delta_m at k = 1e-3/Mpc, z = 0 (the former low-k "shape error"
            # vs the gold table).  Velocities and v_cb = |th_b - th_c|/k are
            # reported in Newtonian gauge; v_cb is unchanged by the shift
            # (both thetas move by k^2 alpha).
            ach = float(self.hubble_conf(a))
            gauge = 3.0 * ach * th_c / k**2
            # delta_m is rho-weighted over cdm + baryons + ncdm (CLASS's d_m
            # includes the massive neutrino with its exact rho(a))
            rc, rb = rho_c / a**3, rho_b / a**3
            rnc = float(self._rho_nc(a)) if self.has_ncdm else 0.0
            d_m = ((rc * d_c + rb * d_b + rnc * d_nc) / (rc + rb + rnc)
                   + gauge)
            res.append({
                "z": float(z), "a": float(a),
                "delta_c": float(d_c + gauge), "delta_b": float(d_b + gauge),
                "delta_m": float(d_m),
                "theta_c": float(th_c), "theta_b": float(th_b),
                "v_cb": float(abs(th_b - th_c) / k),
            })
        return res


def compute_vcb_transfer(k_arr, *, z_dec=None, solver=None, **cosmo_kwargs):
    """T_vcb(k) at kinematic decoupling, units v/c per unit zeta.

    Also returns delta_m(k, z_dec) for diagnostics."""
    if solver is None:
        solver = BoltzmannSolver(**cosmo_kwargs)
    if z_dec is None:
        from .classy_interface import find_redshift_kinematic_decoupling

        z_dec = find_redshift_kinematic_decoupling()
    t_vcb = np.empty(len(k_arr))
    d_m = np.empty(len(k_arr))
    for i, k in enumerate(k_arr):
        r = solver.solve_k(float(k), z_out=(z_dec,))[0]
        t_vcb[i] = r["v_cb"]
        d_m[i] = r["delta_m"]
    return t_vcb, d_m


# the reference's k_transfer grid (classy_interface.py:21-31): the grid its
# CLASS-derived cosmo tables are sampled on
REFERENCE_K_TRANSFER = np.concatenate([
    np.logspace(-5.15, -1.49, 50),
    np.logspace(-1.45, -0.258, 80),
    np.logspace(-0.2083, 3.049, 100),
])


def generate_transfer_tables(cosmo_params=None, *, vcb=True, n_k=64,
                             k_max_exact=500.0, z_dec=None, verbose=False,
                             **cosmo_kwargs):
    """First-principles CLASS-convention transfer tables for ANY cosmology:
    (k, T_density(z=0)[, T_vcb(z_dec)]) on the reference's k_transfer grid,
    from the in-house Boltzmann solver — the classy-free replacement for the
    reference's live CLASS run (wrapper/inputs.py:1861-1966).

    The density transfer is solved exactly at `n_k` log-spaced points and
    cubic-interpolated (in log) onto the reference grid; BAO wiggles (~5%
    amplitude) are resolved to ~1-2% at the default n_k=64.  T_vcb oscillates
    much faster, so it is solved exactly at every reference grid point up to
    k=3 (above which Silk damping makes it smooth), as the bundled Planck18
    table was.  Runtime is dominated by the vcb band (~20-40 min single
    core); pass vcb=False when V_CB_MODEL is NONE/AVG.

    Typical use:

        k, td, tv = generate_transfer_tables(my_cosmo_params)
        register_class_transfer(k, td, k_vcb=k, transfer_vcb=tv)

    Accuracy (validated against the gold CLASS table for Planck18): density
    shape within ~2% over k = 0.004-1/Mpc with a constant ~+5% amplitude
    offset that cancels under SIGMA_8 normalization; V_CB_RMS within 3% of
    CLASS.  Known omissions: massive neutrinos treated as massless,
    Saha+Peebles recombination instead of RECFAST."""
    from scipy.interpolate import CubicSpline

    if cosmo_params is not None:
        cosmo_kwargs = dict(
            hlittle=float(cosmo_params.hlittle), OMm=float(cosmo_params.OMm),
            OMb=float(cosmo_params.OMb), Y_He=float(cosmo_params.Y_He),
        )
    solver = BoltzmannSolver(**cosmo_kwargs)
    k_grid = REFERENCE_K_TRANSFER

    ks_d = np.logspace(np.log10(k_grid[0]), np.log10(min(k_grid[-1], 20.0)), n_k)
    td = np.empty(n_k)
    for i, k in enumerate(ks_d):
        td[i] = abs(solver.solve_k(float(k), z_out=(0.0,))[0]["delta_m"])
        if verbose:
            print(f"density k={k:10.5g} T={td[i]:.5g}", flush=True)
    spl = CubicSpline(np.log(ks_d), np.log(td))
    t_dens = np.exp(spl(np.log(np.clip(k_grid, ks_d[0], ks_d[-1]))))
    # power-law tail beyond the exact range
    hi = k_grid > ks_d[-1]
    if hi.any():
        slope = (np.log(td[-1]) - np.log(td[-2])) / (
            np.log(ks_d[-1]) - np.log(ks_d[-2]))
        t_dens[hi] = td[-1] * (k_grid[hi] / ks_d[-1]) ** slope

    if not vcb:
        return k_grid, t_dens, None

    if z_dec is None:
        from .classy_interface import find_redshift_kinematic_decoupling

        z_dec = find_redshift_kinematic_decoupling()
    exact = k_grid[k_grid <= 3.0]
    tv_exact = np.array([
        solver.solve_k(float(k), z_out=(z_dec,))[0]["v_cb"] for k in exact
    ])
    anchors = np.logspace(np.log10(3.2), np.log10(k_max_exact), 14)
    tv_anchor = np.array([
        solver.solve_k(float(k), z_out=(z_dec,))[0]["v_cb"] for k in anchors
    ])
    spl_v = CubicSpline(np.log(anchors), np.log(tv_anchor))
    mid = k_grid[(k_grid > 3.0) & (k_grid <= anchors[-1])]
    tv_mid = np.exp(spl_v(np.log(mid)))
    slope = (np.log(tv_anchor[-1]) - np.log(tv_anchor[-2])) / (
        np.log(anchors[-1]) - np.log(anchors[-2]))
    tail = k_grid[k_grid > anchors[-1]]
    tv_tail = tv_anchor[-1] * (tail / anchors[-1]) ** slope
    t_vcb = np.concatenate([tv_exact, tv_mid, tv_tail])
    return k_grid, t_dens, t_vcb
