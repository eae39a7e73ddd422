"""k-space filter bank.

Behavioral parity with reference filtering.c:18-307.  Every filter is a pure
function of the |k| grid.  Filter ids match the reference:

  0: real-space spherical tophat        W(kR) = 3 (sin kR - kR cos kR)/(kR)^3
  1: sharp-k                            W = [kR * 0.4136 <= 1]
  2: gaussian (width 0.643/R)           W = exp(-0.643^2 (kR)^2/2)
  3: exponential-MFP tophat (Davies & Furlanetto)
  4: spherical shell (annulus R_inner=R_param, R_outer=R)
  5: Ly-a multiple-scattering window: host-tabulated 2F3 curves in float64
     (`ms_filter_table`), linearly interpolated on the |k| grid on the device
     (`ms_interp_grid` / `w_multiple_scattering`)

The device windows take float32 |k| tensors and return float32 windows.
"""

from __future__ import annotations

import numpy as np
import torch

TOPHAT = 0
SHARPK = 1
GAUSSIAN = 2
EXP_MFP = 3
SHELL = 4
LYA_MS = 5


def w_tophat(kr):
    safe = torch.where(kr < 1e-4, 1.0, kr)
    w = 3.0 * (torch.sin(safe) - safe * torch.cos(safe)) / safe**3
    return torch.where(kr < 1e-4, 1.0 - kr * kr / 10.0, w)


def w_sharpk(kr):
    return torch.where(kr * 0.413566994 > 1.0, 0.0, 1.0)


def w_gaussian_sq(kr_sq):
    return torch.exp(-0.643 * 0.643 * kr_sq / 2.0)


def _f64(v):
    """A scalar rounded to float32, as the JAX package hands it over, then
    widened."""
    return float(np.float32(v))


def w_exp_mfp(k, R, mfp):
    """Davies & Furlanetto exponentially-damped tophat (filtering.c:80-104).

    Window for photons with mean free path `mfp` inside a tophat of radius R.
    The expression cancels terms of order (mfp/R)^3 ~ 1e5 times larger than
    its result (mfp/R ~ 40 at the smallest radius of a 1.5 Mpc cell), so a
    float32 evaluation carries errors up to ~1e-2 there, whose value depends on
    the backend's transcendentals and FMA contraction (the JAX package's own
    CPU result is off the exact window by more than 1e-3 there).  The window
    is evaluated in float64 from the float32 |k|, R and mfp and rounded once:
    the same float32 window on the CPU and on the card."""
    R, mfp = _f64(R), _f64(mfp)
    kr = k.double() * R
    ratio = mfp / R
    exp_term = float(np.exp(-R / mfp))

    # main expression
    kr_safe = torch.where(kr < 1e-4, 1.0, kr)
    f = (kr_safe**2 * ratio**2 + 2.0 * ratio + 1.0) * ratio * torch.cos(kr_safe)
    f = f + (kr_safe**2 * (ratio**2 - ratio**3) + ratio + 1.0) * torch.sin(kr_safe) / kr_safe
    f = f * exp_term
    f = f - 2.0 * ratio**2
    f = f * (-3.0) * ratio / (kr_safe**2 * ratio**2 + 1.0) ** 2

    # second-order Taylor expansion about kR = 0
    ts_0 = 6.0 * ratio**3 - exp_term * (6.0 * ratio**3 + 6.0 * ratio**2 + 3.0 * ratio)
    taylor = ts_0 + (exp_term * (2.0 * ratio**2 + 0.5 * ratio) - 2.0 * ts_0 * ratio**2) * kr * kr
    return torch.where(kr < 1e-4, taylor, f).float()


def w_shell(k, R_inner, R_outer):
    """Spherical-shell (annulus) window (filtering.c:106-117).  Its numerator
    cancels to (kR)^3/3 at small kR, so it is evaluated in float64 from the
    float32 |k| and radii and rounded once, like `w_exp_mfp`."""
    R_inner, R_outer = _f64(R_inner), _f64(R_outer)
    k = k.double()
    kri = k * R_inner
    kro = k * R_outer
    kro_safe = torch.where(kro < 1e-4, 1.0, kro)
    kri_safe = torch.where(kro < 1e-4, 0.5, kri)
    w = (
        3.0
        / (kro_safe**3 - kri_safe**3)
        * (
            torch.sin(kro_safe)
            - torch.cos(kro_safe) * kro_safe
            - torch.sin(kri_safe)
            + torch.cos(kri_safe) * kri_safe
        )
    )
    x = R_inner / R_outer
    taylor = 1.0 - kro * kro / 10.0 * (x**5 - 1.0) / (x**3 - 1.0)
    return torch.where(kro < 1e-4, taylor, w).float()


# --------------------------------------------------------------------------
# Filter 5: Lya multiple-scattering annulus window (reference filtering.c:119-307;
# equations from arXiv:2601.14360 Eqs. 11, 25, 28-32, E7-E8).  The window mixes
# scalar Gamma-function work with a per-|k| 2F3 evaluation: it is evaluated in
# float64 numpy on the host over a 1D k-table per (R_inner, R_outer, R_star)
# triple (one shell of one snapshot), then interpolated on the device.
# --------------------------------------------------------------------------

# Fit coefficients (highest power first, in zeta = log10 x) for the escape
# moments mu(x), eta(x) of arXiv:2601.14360 Eqs. 29-30.
_MS_MU_MID = (-0.104, 0.4867, -0.8217, 0.4889, 0.264, 0.518)  # 3 < x <= 30
_MS_MU_LOW = (-0.0285, 0.087, -0.1205, -0.0456, 0.3787, 0.5285)  # 0.2 < x <= 3
_MS_ETA_MID = (2.17, -8.832, 13.579, -10.04, 4.166, -0.17)  # 3 < x <= 20
_MS_ETA_LOW = (0.352, -0.0516, -0.293, 0.342, 0.582, 0.266)  # 0.2 < x <= 3


def _ms_mu(x_em: float) -> float:
    if x_em > 30.0:
        return 1.0 - 1.0478 * x_em**-0.7266
    if x_em > 3.0:
        return float(np.polyval(_MS_MU_MID, np.log10(x_em)))
    if x_em > 0.2:
        return float(np.polyval(_MS_MU_LOW, np.log10(x_em)))
    return 0.3982 * x_em**0.1592


def _ms_eta(x_em: float) -> float:
    if x_em > 20.0:
        return 1.0 - 2.804 * x_em**-1.242
    if x_em > 3.0:
        return float(np.polyval(_MS_ETA_MID, np.log10(x_em)))
    if x_em > 0.2:
        return float(np.polyval(_MS_ETA_LOW, np.log10(x_em)))
    return 0.4453 * x_em**1.296


def ms_alpha_beta(x_em: float) -> tuple[float, float]:
    """Shape parameters (alpha, beta) of the scattering kernel at x_em = R/R_star
    (arXiv:2601.14360 Eq. 28: mu = alpha/(alpha+beta), eta = alpha/(alpha+beta^2))."""
    mu, eta = _ms_mu(x_em), _ms_eta(x_em)
    inv_eta = 1.0 / eta - 1.0
    inv_mu = 1.0 / mu - 1.0
    return inv_eta / inv_mu**2, inv_eta / inv_mu


def _w_tophat_np(kr):
    safe = np.where(kr < 1e-6, 1.0, kr)
    w = 3.0 * (np.sin(safe) - safe * np.cos(safe)) / safe**3
    return np.where(kr < 1e-6, 1.0, w)


def _hyper_2f3_series(kr, alpha, beta, rtol=1e-4, max_terms=1000):
    """Power series for 2F3((a+2)/2,(a+3)/2; 5/2,(a+b+2)/2,(a+b+3)/2; -(kR)^2/4)
    (Eq. E7 of arXiv:2601.14360), valid/stable for kR < ~30."""
    kr = np.asarray(kr, dtype=np.float64)
    total = np.zeros_like(kr)
    term = np.ones_like(kr)
    for n in range(1, max_terms):
        total += term
        term = term * (
            -1.0
            / (1.0 + beta / (alpha + 2.0 * n))
            / (1.0 + beta / (alpha + 1.0 + 2.0 * n))
            * kr
            * kr
            / (2.0 * n)
            / (2.0 * n + 3.0)
        )
        if np.all(np.abs(term) < np.abs(total) * rtol + 1e-300):
            break
    return total


def _hyper_2f3_asymptotic(kr, alpha, beta):
    """Large-kR asymptotics of the same 2F3 (Eq. E8 of arXiv:2601.14360 /
    functions.wolfram.com 07.26.06.0003.01), sqrt(pi) factors pre-absorbed."""
    from scipy.special import gamma as G, rgamma as Grec

    kr = np.asarray(kr, dtype=np.float64)
    a1 = (2.0 + alpha) / 2.0
    a2 = (3.0 + alpha) / 2.0
    b1 = 2.5
    b2 = (2.0 + alpha + beta) / 2.0
    b3 = (3.0 + alpha + beta) / 2.0

    gamma_b1 = 0.75  # Gamma(5/2) with the sqrt(pi) absorbed into the other terms
    if a1 < 20.0:
        ratio1 = G(b2) / G(a1)
        ratio2 = G(b3) / G(a2)
    else:
        # Stirling-based ratio Gamma(x+y)/Gamma(x) for y = beta/2 << x
        y = beta / 2.0
        ratio1 = a1**y * np.exp(
            (a1 + y - 0.5) * (y / a1 - y * y / (2 * a1 * a1) + y**3 / (3 * a1**3)) - y
        )
        ratio2 = a2**y * np.exp(
            (a2 + y - 0.5) * (y / a2 - y * y / (2 * a2 * a2) + y**3 / (3 * a2**3)) - y
        )

    if alpha < 10.0:
        # possibly-singular Gammas appear only in denominators -> rgamma
        decay1 = (
            np.pi * G(a1) * Grec(b1 - a1) * Grec(b2 - a1) * Grec(b3 - a1)
            / (kr / 2.0) ** (alpha + 2.0)
        )
        decay2 = (
            -2.0 * np.pi * G(a2) * Grec(b1 - a2) * Grec(b2 - a2) * Grec(b3 - a2)
            / (kr / 2.0) ** (alpha + 3.0)
        )
    else:
        decay1 = decay2 = 0.0

    phase = kr - np.pi * (2.0 + beta) / 2.0
    f = (np.cos(phase) - (1.0 + (alpha - 1.0) * beta) / kr * np.sin(phase)) / (
        kr / 2.0
    ) ** (beta + 2.0)
    return (f + decay1 + decay2) * gamma_b1 * ratio1 * ratio2


def hyper_2f3_window(kr, alpha, beta):
    """W(kR) = 2F3(..., -(kR)^2/4): unit-normalised single-sphere multiple-
    scattering window.  beta == 0 degenerates to the straight-line tophat
    (no neutral hydrogen -> no scattering), matching filtering.c:256-262."""
    kr = np.asarray(kr, dtype=np.float64)
    if beta == 0.0:
        return _w_tophat_np(kr)
    out = np.empty_like(kr)
    small = kr < 30.0
    if small.any():
        out[small] = _hyper_2f3_series(kr[small], alpha, beta)
    big = ~small
    if big.any():
        f_ms = _hyper_2f3_asymptotic(kr[big], alpha, beta)
        f_sl = _w_tophat_np(kr[big])
        # rule of thumb from the reference: the MS window must lie below the
        # straight-line window at large kR; the asymptotic form misbehaves for
        # large alpha at intermediate kR
        out[big] = np.where(np.abs(f_ms) < np.abs(f_sl), f_ms, f_sl)
    return out


def ms_window(k, R_inner, R_outer, R_star):
    """Host float64 multiple-scattering annulus window W(k)
    (arXiv:2601.14360 Eq. 11; reference multiple_scattering_filter)."""
    k = np.asarray(k, dtype=np.float64)
    if R_star == 0.0:
        # post-reionization (R_star ~ x_HI -> 0): reference fixes
        # (alpha, beta) = (1, 1) inner / (1, 0) outer, filtering.c:166-172
        ai = ao = 1.0
        bi, bo = 1.0, 0.0
    else:
        ai, bi = ms_alpha_beta(R_inner / R_star)
        ao, bo = ms_alpha_beta(R_outer / R_star)
    w = R_outer**3 * hyper_2f3_window(k * R_outer, ao, bo)
    if R_inner > 0.0:
        w = w - R_inner**3 * hyper_2f3_window(k * R_inner, ai, bi)
    return w / (R_outer**3 - R_inner**3)


def ms_filter_table(k_max, R_inner, R_outer, R_star, n_k: int = 2048):
    """Tabulate the multiple-scattering window over k in [0, k_max] (host).

    Returns (k_table, w_table) float32 arrays; k=0 maps to W=1 exactly."""
    k_table = np.linspace(0.0, float(k_max), n_k)
    w = ms_window(k_table[1:], R_inner, R_outer, R_star)
    w_table = np.concatenate([[1.0], w])
    return k_table.astype(np.float32), w_table.astype(np.float32)


def ms_interp_grid(kmag, k_table):
    """What jnp.interp(kmag, k_table, .) computes before it reads the values,
    in its float32 arithmetic: the upper knot index `i` of each |k|, the
    offset ratio (k - k[i-1]) / (k[i] - k[i-1]) and the mask of |k| beyond the
    last knot.  The k grid and the table's knots are the same for every shell
    of a snapshot, so this is computed once and `w_multiple_scattering`
    gathers each shell's window with it."""
    xp = torch.as_tensor(np.asarray(k_table, np.float32), device=kmag.device)
    i = torch.clamp(torch.searchsorted(xp, kmag, right=True), 1, xp.shape[0] - 1)
    dx = xp[i] - xp[i - 1]
    ratio = (kmag - xp[i - 1]) / dx
    return i, ratio, kmag < xp[0], kmag > xp[-1]


def w_multiple_scattering(grid, w_table):
    """The tabulated MS window on the |k| grid (jnp.interp, ends held)."""
    i, ratio, left, right = grid
    fp = torch.as_tensor(np.asarray(w_table, np.float32), device=ratio.device)
    f_lo = fp[i - 1]
    f = f_lo + ratio * (fp[i] - f_lo)
    f = torch.where(left, fp[0], f)
    return torch.where(right, fp[-1], f)


def filter_weights(kmag, filter_type: int, R, R_param=0.0):
    """Return W(k) for the given filter id on the |k| grid."""
    if filter_type == TOPHAT:
        return w_tophat(kmag * R)
    if filter_type == SHARPK:
        return w_sharpk(kmag * R)
    if filter_type == GAUSSIAN:
        return w_gaussian_sq((kmag * R) ** 2)
    if filter_type == EXP_MFP:
        return w_exp_mfp(kmag, R, R_param)
    if filter_type == SHELL:
        return w_shell(kmag, R, R_param)
    raise ValueError(f"unknown filter type {filter_type}")


def filter_kbox(kbox, kmag, filter_type: int, R, R_param=0.0):
    """Multiply a k-space half-space box by the filter window."""
    return kbox * filter_weights(kmag, filter_type, R, R_param).to(kbox.real.dtype)
