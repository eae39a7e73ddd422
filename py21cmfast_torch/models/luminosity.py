"""UV luminosity functions.

Host-side equivalent of reference LuminosityFunction.c:1-264 (`ComputeLF`):
phi(M_UV) from the HMF + stellar-mass/SFR scaling relations, using the
standard Kennicutt/Madau conversion between SFR and UV luminosity.  A copy
of py21cmfast_tpu/models/luminosity.py (host numpy, float64) on the port's
HMF and sigma table.
"""

from __future__ import annotations

import numpy as np

from ..cosmology.constants import physconst
from ..inputs import InputParameters
from . import hmf

__all__ = ["compute_luminosity_function"]

# L_UV/SFR conversion [erg s^-1 Hz^-1 / (Msun yr^-1)] (Madau & Dickinson 2014)
LUV_OVER_SFR = 1.0 / 1.15e-28


def compute_luminosity_function(
    redshifts,
    inputs: InputParameters,
    nbins: int = 100,
    mturnovers=None,
    component: str = "acg",
):
    """Return (Muv[n_z, nbins], Mhalo[n_z, nbins], lfunc[n_z, nbins]).

    lfunc is log10(phi / mag^-1 Mpc^-3); mirrors reference
    wrapper/cfuncs.py:211 `compute_luminosity_function`."""
    from .ionization import _get_sigma_table

    cosmo = inputs.cosmology
    sigma_table = _get_sigma_table(inputs)
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    ap = inputs.astro_params

    redshifts = np.atleast_1d(np.asarray(redshifts, dtype=np.float64))
    n_z = len(redshifts)
    muv = np.empty((n_z, nbins))
    mhalo = np.empty((n_z, nbins))
    lfunc = np.empty((n_z, nbins))

    for i, z in enumerate(redshifts):
        sc = hmf.set_scaling_constants(float(z), inputs)
        m_min = hmf.minimum_source_mass(float(z), inputs)
        ln_m = np.linspace(np.log(max(m_min, 1e7)), np.log(1e14), nbins)
        m = np.exp(ln_m)
        growth = float(cosmo.dicke(float(z)))

        # mean stellar mass & SFR per halo (median relations, no scatter)
        if component.lower() in ("mcg", "mini", "2"):
            # molecularly-cooled (Pop III) component
            # (LuminosityFunction.c:111-126 + atomic-threshold upper cutoff)
            mturn = (
                sc.mturn_m_nofb
                if mturnovers is None
                else float(np.atleast_1d(mturnovers)[i])
            )
            fstar = sc.fstar_7 * (m / 1e7) ** sc.alpha_star_mini
            fstar = np.minimum(
                fstar * np.exp(-mturn / m - m / sc.acg_thresh), 1.0
            )
        else:
            fstar = sc.fstar_10 * (m / 1e10) ** sc.alpha_star
            if inputs.astro_options.USE_UPPER_STELLAR_TURNOVER and sc.alpha_star > sc.alpha_upper:
                fstar = sc.fstar_10 * sc.upper_pivot_ratio / (
                    (m / sc.pivot_upper) ** (-sc.alpha_star)
                    + (m / sc.pivot_upper) ** (-sc.alpha_upper)
                )
            mturn = sc.mturn_a_nofb if mturnovers is None else float(np.atleast_1d(mturnovers)[i])
            fstar = np.minimum(fstar * np.exp(-mturn / m), 1.0)
        stellar = fstar * m * cosmo.OMb / cosmo.OMm
        sfr_yr = stellar / (sc.t_star * sc.t_h) * physconst.s_per_yr  # Msun/yr

        l_uv = sfr_yr * LUV_OVER_SFR
        muv[i] = 51.63 - 2.5 * np.log10(np.maximum(l_uv, 1e-30))
        mhalo[i] = m

        # dn/dM_UV = dn/dlnM * dlnM/dM_UV
        dndlnm = hmf.unconditional_mf(sigma_table, cosmo, hmf_int, float(z), growth, ln_m)
        dndlnm = dndlnm * cosmo.rho_mean  # -> Mpc^-3 per lnM
        dmuv_dlnm = np.gradient(muv[i], ln_m)
        with np.errstate(divide="ignore", invalid="ignore"):
            phi = np.abs(dndlnm / dmuv_dlnm)
        # the MCG component's upper (atomic-threshold) cutoff makes Muv(M)
        # non-monotonic: dMuv/dlnM crosses zero and phi diverges (the
        # reference smooths this kink, LuminosityFunction.c:150-175); mask it
        phi = np.where(np.abs(dmuv_dlnm) < 1e-8, np.nan, phi)
        phi = np.where(np.isfinite(phi), phi, 1e-30)
        lfunc[i] = np.log10(np.maximum(phi, 1e-30))

    return muv, mhalo, lfunc
