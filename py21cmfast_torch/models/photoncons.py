"""Photon non-conservation correction.

Equivalent of reference photoncons.c:75-822 + wrapper/photoncons.py:205-641,
copied from py21cmfast_tpu/models/photoncons.py (host numpy); the
calibration run drives the port's ICs, perturb and ionization on `device`.
The excursion-set method destroys photons (overlapping bubbles); the z-variant
correction measures the offset between the *analytic* filling factor Q(z)
(photon-conserving ODE) and the excursion-set *calibration* run, and shifts the
redshift fed to the ionization box by deltaz(xH) to compensate.

Flow (PHOTON_CONS_TYPE='Z-PHOTONCONS'):
  1. `analytic_Q_history`: dQ/dt = zeta dfcoll/dt - Q/t_rec   (InitialisePhotonCons)
  2. `calibrate_photon_cons`: a constant-zeta excursion-set run records the
     calibration xH(z) curve (calibrate_photon_cons, wrapper/photoncons.py:270)
  3. `PhotonConsState.deltaz(xH)`: smoothed z_cal(xH) - z_analytic(xH)
  4. the ionization driver asks `adjusted_redshift(z)` and scales densities by
     D(z_adj)/D(z)  (adjust_redshifts_for_photoncons, photoncons.c:668-822)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .._device import resolve_device
from ..inputs import InputParameters
from . import hmf

__all__ = ["PhotonConsState", "PhotonConsFit", "setup_photon_cons",
           "analytic_Q_history", "euler_q", "photoncons_alpha",
           "photoncons_fesc"]

_state_cache: dict = {}

# reference photoncons.c:66-72 (hard-coded there too)
PHOTONCONS_START = 0.995  # xH where the correction begins
PHOTONCONS_END = 0.3  # xH below which the exact correction is smoothed
PHOTONCONS_ASYMPTOTE = 0.01  # final xH of the extrapolated correction


@dataclasses.dataclass
class PhotonConsState:
    z_analytic: np.ndarray  # descending z grid
    Q_analytic: np.ndarray  # ionized filling factor
    z_cal: np.ndarray
    xh_cal: np.ndarray
    deltaz_xh: np.ndarray  # xH grid for the deltaz spline
    deltaz_vals: np.ndarray

    def adjusted_redshift(self, z: float) -> float:
        """z shifted DOWN by deltaz = |z_cal - z_analytic| at the analytic
        xH(z): the excursion set destroys photons, so the ionization box is
        evaluated at a later effective time to compensate
        (photoncons.c adjust_redshifts_for_photoncons:668-770)."""
        xh_ana = 1.0 - np.interp(z, self.z_analytic[::-1], self.Q_analytic[::-1])
        if xh_ana > PHOTONCONS_START:
            return float(z)  # ionization hasn't started: no shift (:695-699)
        dz = np.interp(xh_ana, self.deltaz_xh, self.deltaz_vals)
        return float(max(z - dz, 0.0))


def euler_q(nion_fn, ion_eff, z_end=3.5):
    """The reference's exact Euler integration of dQ/da = dNion/da
    (InitialisePhotonCons, photoncons.c:95-230), f64: a from 0.03,
    da = 3e-3 shrinking by da**1.003 with floor 7e-5, central difference
    with delta_a = 1e-7, monotonicity-retry conditioning.

    NOTE the deliberate quirk-faithfulness: each step weights the
    derivative by the PRE-shrink da while the grid advances by the
    POST-shrink da (photoncons.c:205-228), so the quadrature overshoots
    the telescoped closed form Q = ION_EFF*(Nion(z)-Nion(z~32)) by
    +15-25% over z=12-14 — this is the reference's documented stepping
    (its own comment bounds the error at <5%/25%, photoncons.c:86-91),
    reproduced here because the gold photoncons runs inherit it (see
    scripts/photoncons_repro.py).  Returns (z desc, Q); Q is cumulative
    photons, not clipped at 1 (photoncons.c:213-215)."""
    a_start, a_end = 0.03, 1.0 / (1.0 + z_end)
    delta_a = 1e-7
    num_fails = 0
    while True:  # monotonicity-retry (photoncons.c:133-238)
        da = (
            3e-3 - num_fails * 1e-3
            if num_fails < 3
            else 1e-3 - (num_fails - 2) * 1e-4
        )
        a = a_start
        q0 = q_prev = 0.0
        z_arr, q_arr = [], []
        mono = True
        while a < a_end:
            zi = 1.0 / a - 1.0
            z0 = 1.0 / (a + delta_a) - 1.0
            z1 = 1.0 / (a - delta_a) - 1.0
            n0 = ion_eff * nion_fn(z0)
            n1 = ion_eff * nion_fn(z1)
            q1 = q0 + ((n0 - n1) / 2.0 / delta_a) * da  # RecombPhotonCons=False
            if q1 < q_prev:
                mono = False
                break
            q_prev = q1
            z_arr.append(zi)
            q_arr.append(q1)
            da = 7e-5 if da < 7e-5 else da**1.003
            q0 = q1
            a = a + da
        if mono:
            break
        num_fails += 1
        if num_fails > 10:
            raise RuntimeError("photoncons monotonicity conditioning failed")
    return np.array(z_arr), np.array(q_arr)


def _dsig2_unstable(cosmo, m: float) -> float:
    """Emulation of the reference's inflated dsigma^2/dM: the cancellation-
    prone top-hat dW/dr of dwdm_filter (filtering.c:49-78) under scipy's
    adaptive QAGS (GK21 + epsilon extrapolation).  In f64 the two O(u^-2)
    terms of dW/dr cancel to O(u) as u = kR -> 0; chasing that noise
    inflates |dsigma^2/dM| by a structured 20-27% for M >~ 1e9, which moves
    the analytic Q(z) measurably toward the reference's gold histories
    (scripts/photoncons_repro.py: Nion ratio 1.07-1.22 over z=5-18).

    Round-5 negative result, kept for the record: a faithful GSL-QAG/GK61
    reimplementation (cosmology/quadrature.qag_gk61, the reference's actual
    rule and subdivision policy, its exact limits 1e-99/R..350/R and
    epsrel=1e-6) converges CLEANLY to the stable value (ratio 1.000) — the
    gold's inflation is therefore NOT plain-qage noise; it presumably needs
    GSL's specific roundoff-bailout path or lives elsewhere in the
    reference's photoncons pipeline.  The scipy-QAGS emulation remains the
    empirically closest available stand-in, covered by the parity ratchet."""
    from scipy import integrate

    rho = float(cosmo.rho_mean)
    R = (3.0 * m / (4.0 * np.pi * rho)) ** (1.0 / 3.0)
    pk = cosmo.power_in_k

    def f(k):
        kR = k * R
        w = 1.0 if kR < 1e-4 else 3.0 * (np.sin(kR) / kR**3 - np.cos(kR) / kR**2)
        if kR < 1e-10:
            dwdr = 0.0
        else:
            dwdr = 9.0 * np.cos(kR) * k / kR**3 + 3.0 * np.sin(kR) * (
                1.0 - 3.0 / (kR * kR)
            ) / (kR * R)
        drdm = 1.0 / (4.0 * np.pi * rho * R * R)
        return k * k * pk(k) * 2.0 * w * dwdr * drdm / (2.0 * np.pi**2)

    import warnings

    with np.errstate(all="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return integrate.quad(f, 1e-12, 350.0 / R, limit=1000, epsrel=1e-6)[0]


_noisy_table_cache: dict = {}


class _RefDsigmaTable:
    """Mimics the reference's dSigmasqdm interp table exactly: 300 nodes
    log-spaced over M in [5e2, 1e20] (_global_initialization.py:132-134,
    interp_tables.c N_MASS_INTERP), values stored as FLOAT32 log10(-ds)
    (initialiseSigmaMInterpTable:1154), linear interpolation in lnM
    (EvaluateRGTable1D_f)."""

    def __init__(self, base, ln_m, log10_neg_ds):
        self._base = base
        self._ln_m = ln_m
        self._l10 = np.asarray(log10_neg_ds, np.float32).astype(np.float64)

    @property
    def ln_m(self):
        return self._base.ln_m

    def sigma_of_lnm(self, lnm):
        return self._base.sigma_of_lnm(lnm)

    def dsigmasq_of_lnm(self, lnm):
        return -(10.0 ** np.interp(lnm, self._ln_m, self._l10))


def _noisy_sigma_table(inputs: InputParameters, n: int = 300):
    """Sigma table whose dsigma^2/dM carries the reference's quadrature-noise
    inflation (_dsig2_unstable) — used ONLY by the photon-conservation
    analytic Q(z), whose gold histories inherit that inflation through the
    reference's forced-QAG Nion_General (photoncons.c:168-172 'We Force
    QAG').  sigma(M) itself has no cancellation and stays the stable table.
    The node grid, float32 log10 storage and linear-in-lnM interpolation all
    match the reference's dSigmasqdm_InterpTable."""
    from .ionization import _get_sigma_table

    key = inputs.matter_cosmo_hash if hasattr(inputs, "matter_cosmo_hash") else (
        inputs.full_hash
    )
    if key in _noisy_table_cache:
        return _noisy_table_cache[key]
    base = _get_sigma_table(inputs)
    cosmo = inputs.cosmology
    ln_m = np.linspace(np.log(5e2), np.log(1e20), n)
    ds = np.array([_dsig2_unstable(cosmo, float(m)) for m in np.exp(ln_m)])
    tbl = _RefDsigmaTable(base, ln_m, np.log10(np.maximum(-ds, 1e-300)))
    _noisy_table_cache[key] = tbl
    return tbl


def analytic_Q_history(inputs: InputParameters, z_min=None, z_max=None, n=None):
    """Photon-conserving analytic filling factor Q(z)
    (InitialisePhotonCons, photoncons.c:75-293).

    dQ/da = dNion/da with RecombPhotonCons=False (photoncons.c:66 — NO
    recombination sink by default), integrated with the reference's exact
    Euler stepping (`euler_q`; includes its documented quadrature bias).
    For mass-dependent source models Nion_General runs from M_TURN/50 with
    the M_TURN exponential turnover (:117-121, 169-172) — NOT the run's
    minimum_source_mass; for CONST-ION-EFF it is HII_EFF_FACTOR * Fcoll
    over M > M(ION_Tvir_MIN).  `z_min`/`n` are accepted for backward
    compatibility; the grid is the Euler a-grid."""
    cosmo = inputs.cosmology
    ap = inputs.astro_params
    # the reference forces direct QAG here (photoncons.c:168-172), so its
    # Nion carries the unstable-dsigma^2/dM inflation — emulate it
    sigma_table = _noisy_sigma_table(inputs)
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    ln_mmax = np.log(hmf.M_MAX_INTEGRAL)
    z_end = z_min if z_min is not None else float(ap.PHOTONCONS_CALIBRATION_END)

    if inputs.matter_options.source_model_is_mass_dependent:
        m_turn = 10.0 ** float(ap.M_TURN)
        ln_mmin = np.log(m_turn / 50.0)
        sc = hmf.set_scaling_constants(float(z_end), inputs)
        ion_eff = sc.pop2_ion * sc.fstar_10 * sc.fesc_10

        def nion_fn(z):
            return float(hmf.nion_general(
                sigma_table, cosmo, hmf_int, float(z), ln_mmin, ln_mmax,
                m_turn, sc,
            ))
    else:
        mu = 1.22 if ap.ION_Tvir_MIN < 9.99999e3 else 0.6
        ion_eff = float(ap.HII_EFF_FACTOR)

        def nion_fn(z):
            m_min = float(cosmo.TtoM(float(z), ap.ION_Tvir_MIN, mu))
            return float(hmf.fcoll_general(
                sigma_table, cosmo, hmf_int, float(z), np.log(m_min), ln_mmax
            ))

    return euler_q(nion_fn, ion_eff, z_end=z_end)


def calibrate_photon_cons(inputs: InputParameters, z_ana=None, q_ana=None, *, device="cuda"):
    """Run the calibration simulation and record global xH(z)
    (wrapper/photoncons.py calibrate_photon_cons:270-395).

    Matches the reference: SAME box size and seed as the run (the deltaz
    correction is a same-realization comparison), Ts/recombinations/minihalos
    off, sampler models swapped for their integral equivalent, and the
    reference's adaptive z scroll — start at 1.1 * z(Q = 1 - PhotonConsStart),
    step dz = 0.5 / 0.15 / 0.05 by neutral fraction, down to
    PHOTONCONS_CALIBRATION_END.  The mean neutral fraction of each step is
    numpy's float32 mean of the box, as the JAX package takes it: the step
    size branches on it."""
    from ..drivers.single_field import compute_ionization_field, perturb_field
    from ..models.ics import compute_initial_conditions

    dev = resolve_device(device)
    source_map = {
        "E-INTEGRAL": "E-INTEGRAL",
        "L-INTEGRAL": "L-INTEGRAL",
        "DEXM-ESF": "L-INTEGRAL",
        "CHMF-SAMPLER": "L-INTEGRAL",
        "CONST-ION-EFF": "CONST-ION-EFF",
    }
    cal_inputs = inputs.evolve_input_structs(
        SOURCE_MODEL=source_map[inputs.matter_options.SOURCE_MODEL],
        PHOTON_CONS_TYPE="NO-PHOTONCONS",
        USE_TS_FLUCT=False,
        RECOMB_MODEL="NONE",
        USE_MINI_HALOS=False,
        R_BUBBLE_MAX=(
            15.0 if inputs.astro_options.uses_recombination
            else inputs.astro_params.R_BUBBLE_MAX
        ),
    )

    # starting redshift: ComputeZstart_PhotonCons (photoncons.c:312-333)
    if z_ana is None or q_ana is None:
        z_ana, q_ana = analytic_Q_history(inputs)
    q_start = 1.0 - PHOTONCONS_START
    if q_ana.max() > q_start:
        # z_ana is descending, so Q(z) is ascending along the array
        z = 1.1 * float(np.interp(q_start, q_ana, z_ana))
    else:
        z = 20.0  # reionization never starts; arbitrary high start (:318-321)

    z_end = float(inputs.astro_params.PHOTONCONS_CALIBRATION_END)
    ics = compute_initial_conditions(cal_inputs, device=dev)

    zs, xh = [], []
    ib = None
    prev_z = None
    while z > z_end:
        pf = perturb_field(z, cal_inputs, ics, device=dev)
        ib = compute_ionization_field(
            z, cal_inputs, pf, previous_ionized_box=ib, prev_redshift=prev_z, device=dev
        )
        mean_nf = float(np.mean(ib.neutral_fraction.cpu().numpy()))
        zs.append(z)
        xh.append(mean_nf)
        prev_z = z
        # adaptive step (wrapper/photoncons.py:361-368)
        if 0.3 < mean_nf <= 0.9:
            z -= 0.15
        elif 0.01 < mean_nf <= 0.3:
            z -= 0.05
        else:
            z -= 0.5
    return np.array(zs), np.array(xh)


@dataclasses.dataclass
class PhotonConsFit:
    """Linear-in-Q parameter fit for the simpler photon-conservation models
    (reference wrapper/photoncons.py photoncons_alpha:416 / photoncons_fesc:587):
    the ionization box runs with ALPHA_ESC (or F_ESC10) replaced by
    yint + slope * Q_analytic(z)."""

    kind: str  # "alpha" | "fesc"
    fit_yint: float
    fit_slope: float
    z_analytic: np.ndarray
    Q_analytic: np.ndarray
    q_targets: np.ndarray  # diagnostic: per-calibration-z parameter targets
    z_cal: np.ndarray

    def value_at(self, z: float) -> float:
        q = np.interp(z, self.z_analytic[::-1], self.Q_analytic[::-1])
        return float(self.fit_yint + self.fit_slope * min(q, 1.0))


_MAX_Q_FIT = 0.99
_MIN_Q_FIT = 0.2


def photoncons_fesc(inputs: InputParameters, *, device="cuda") -> PhotonConsFit:
    """F-PHOTONCONS: F_ESC10(z) = F_ESC10 * Q_analytic/Q_calibration, fitted
    linearly in Q (Nion is ~linear in fesc, so the analytic history with the
    boosted fesc overshoots by exactly the calibration deficit)."""
    z_ana, q_ana = analytic_Q_history(inputs)
    z_cal, xh_cal = calibrate_photon_cons(inputs, device=device)
    q_ref = np.minimum(np.interp(z_cal, z_ana[::-1], q_ana[::-1]), 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = q_ref / np.maximum(1.0 - xh_cal, 1e-10)
    targets = ratio * inputs.astro_params.fesc_10
    sel = np.isfinite(targets) & (q_ref > _MIN_Q_FIT) & (q_ref < _MAX_Q_FIT)
    if sel.sum() < 2:
        slope, yint = 0.0, inputs.astro_params.fesc_10
    else:
        slope, yint = np.polyfit(q_ref[sel], targets[sel], 1)
    return PhotonConsFit(
        kind="fesc", fit_yint=float(yint), fit_slope=float(slope),
        z_analytic=z_ana, Q_analytic=q_ana, q_targets=targets, z_cal=z_cal,
    )


def photoncons_alpha(inputs: InputParameters, *, device="cuda") -> PhotonConsFit:
    """ALPHA-PHOTONCONS: find, per calibration redshift, the ALPHA_ESC whose
    analytic history overshoots the fiducial by the calibration deficit
    (Q(alpha)/Q_ref == Q_ref/Q_cal), then fit ALPHA_ESC = yint + slope*Q
    (reference wrapper/photoncons.py:416-585, ratio criterion)."""
    ap = inputs.astro_params
    z_ana, q_ana = analytic_Q_history(inputs, n=256)
    z_cal, xh_cal = calibrate_photon_cons(inputs, device=device)
    q_ref = np.minimum(np.interp(z_cal, z_ana[::-1], q_ana[::-1]), 1.0)

    alphas = ap.ALPHA_ESC + np.linspace(-2.0, 1.0, 31)
    q_test = np.empty((alphas.size, z_cal.size))
    for i, a in enumerate(alphas):
        za, qa = analytic_Q_history(inputs.evolve_input_structs(ALPHA_ESC=a), n=256)
        q_test[i] = np.interp(z_cal, za[::-1], qa[::-1])

    with np.errstate(divide="ignore", invalid="ignore"):
        # Q(alpha)/Q_ref - Q_ref/Q_cal: root in alpha per redshift
        crit = q_test / q_ref[None, :] - (
            q_ref / np.maximum(1.0 - xh_cal, 1e-10)
        )[None, :]
    targets = np.full(z_cal.size, np.nan)
    last_alpha = ap.ALPHA_ESC
    for j in range(z_cal.size)[::-1]:
        sign_flip = np.where(np.diff(np.sign(crit[:, j])))[0]
        if sign_flip.size == 0:
            continue
        y0, y1 = crit[sign_flip, j], crit[sign_flip + 1, j]
        x0, x1 = alphas[sign_flip], alphas[sign_flip + 1]
        guesses = x0 - y0 * (x1 - x0) / (y1 - y0)
        targets[j] = guesses[np.argmin(np.abs(guesses - last_alpha))]
        last_alpha = targets[j]

    sel = np.isfinite(targets) & (q_ref > _MIN_Q_FIT) & (q_ref < _MAX_Q_FIT)
    if sel.sum() < 2:
        slope, yint = 0.0, ap.ALPHA_ESC
    else:
        slope, yint = np.polyfit(q_ref[sel], targets[sel], 1)
    return PhotonConsFit(
        kind="alpha", fit_yint=float(yint), fit_slope=float(slope),
        z_analytic=z_ana, Q_analytic=q_ana, q_targets=targets, z_cal=z_cal,
    )


def setup_photon_cons(inputs: InputParameters, *, device="cuda"):
    """Build (and cache) the photon-conservation state for these inputs,
    its calibration run on `device`.  Returns a PhotonConsState
    (Z-PHOTONCONS), a PhotonConsFit (ALPHA/F), or None.  The cache is keyed
    by the inputs, the type and the device's type."""
    pc_type = inputs.astro_options.PHOTON_CONS_TYPE
    if pc_type == "NO-PHOTONCONS":
        return None
    dev = resolve_device(device)
    key = (inputs.full_hash, pc_type, dev.type)
    if key in _state_cache:
        return _state_cache[key]
    if pc_type == "ALPHA-PHOTONCONS":
        state = photoncons_alpha(inputs, device=dev)
        _state_cache[key] = state
        return state
    if pc_type == "F-PHOTONCONS":
        state = photoncons_fesc(inputs, device=dev)
        _state_cache[key] = state
        return state

    z_ana, q_ana = analytic_Q_history(inputs)
    z_cal, xh_cal = calibrate_photon_cons(inputs, z_ana, q_ana, device=dev)

    # deltaz(xH) = |z_cal(xH) - z_analytic(xH)| on the reference's NF grid
    # (determine_deltaz_for_photoncons, photoncons.c:335-666), built with the
    # reference's exact conditioning steps.
    xh_ana = 1.0 - q_ana
    order = np.argsort(xh_cal)

    def z_of_xh_ana(xh):
        return np.interp(xh, xh_ana[::-1], z_ana[::-1])

    def z_of_xh_cal(xh):
        return np.interp(xh, xh_cal[order], z_cal[order])

    cal_min = float(np.min(xh_cal))
    extrapolate = cal_min < PHOTONCONS_END
    nf_min = PHOTONCONS_END if extrapolate else cal_min
    bin_width = (PHOTONCONS_START - nf_min) / 99.0
    xh_exact = nf_min + bin_width * np.arange(100)
    dz_exact = np.abs(z_of_xh_cal(xh_exact) - z_of_xh_ana(xh_exact))

    if extrapolate:
        # linear extension of the ANALYTIC curve below the threshold
        # (photoncons.c:480-529): gradient over delta_NF=0.025 near nf_min,
        # times the reference's 1.1 smoothing fudge; end at
        # max(cal_min, PhotonConsAsymptoteTo).
        delta_nf = 0.025
        za1 = z_of_xh_ana(xh_exact[0] + delta_nf)
        za2 = z_of_xh_ana(xh_exact[0])
        grad = 1.1 * delta_nf / (za1 - za2)
        const = (xh_exact[0] + delta_nf) - grad * za1
        nf_end = max(cal_min, PHOTONCONS_ASYMPTOTE)
        n_ext = max(int(np.floor(99.0 * (nf_min - nf_end)
                                 / (PHOTONCONS_START - nf_min))) - 1, 0)
        z_ana_end = (nf_end - const) / grad
        dz_end = abs(z_of_xh_cal(nf_end) - z_ana_end)
        # endpoint + linearly interpolated extrapolation points (:509-529)
        frac = np.arange(1, n_ext + 1) / (n_ext + 1.0)
        xh_grid = np.concatenate(
            [[nf_end], nf_end + (nf_min - nf_end) * frac, xh_exact]
        )
        deltaz = np.concatenate(
            [[dz_end], dz_end + (dz_exact[0] - dz_end) * frac, dz_exact]
        )
    else:
        # never fully reionized: seed the endpoint just below the grid (:420-428)
        xh_grid = np.concatenate([[0.999 * nf_min], xh_exact])
        first = dz_exact[0]
        deltaz = np.concatenate(
            [[1.001 * first if np.all(np.diff(dz_exact) >= 0) else 0.999 * first],
             dz_exact]
        )

    # high-xH monotone fix (photoncons.c:543-583): where xH > 0.95 and the
    # correction DROPS towards higher xH, resample the correction at
    # PhotonConsStart - 0.001*(counter+1) until it meets the previous value —
    # flattens deltaz over the early stage instead of letting it fall.
    if nf_min < 0.8:
        for i in range(len(xh_grid) - 1):
            val1, val2 = deltaz[i], deltaz[i + 1]
            counter = 0
            while xh_grid[i + 1] > 0.95 and val2 < val1 and counter < 100:
                nf_s = PHOTONCONS_START - 0.001 * (counter + 1)
                val2 = abs(z_of_xh_cal(nf_s) - z_of_xh_ana(nf_s))
                deltaz[i + 1] = val2
                counter += 1
                if counter == 100:
                    deltaz[i + 1] = deltaz[i] * 1.01
    # (the !increasing_val pre-smoothing pass, photoncons.c:590-610, is a
    # no-op in every defined execution path — its exit conditions restore
    # deltaz unchanged — so it is intentionally not replicated)

    # symmetric boxcar with edge-shrinking window (photoncons.c:612-650)
    n_tot = len(xh_grid)
    width = 35
    deltaz_s = deltaz.copy()
    for i in range(1, n_tot - 1):
        if i - width // 2 < 0:
            s_int = 2 * i + (width % 2)
        elif i - width // 2 + (width - 1) > n_tot - 1:
            s_int = (width - 1) - 2 * ((i - width // 2 + width - 1) - (n_tot - 1)) + (width % 2)
        else:
            s_int = width
        j0 = i - s_int // 2
        window = deltaz[max(j0, 0): j0 + s_int]
        deltaz_s[i] = window.mean()

    state = PhotonConsState(
        z_analytic=z_ana,
        Q_analytic=q_ana,
        z_cal=z_cal,
        xh_cal=xh_cal,
        deltaz_xh=xh_grid,
        deltaz_vals=deltaz_s,
    )
    _state_cache[key] = state
    return state
