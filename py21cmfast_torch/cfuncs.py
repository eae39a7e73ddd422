"""Low-level evaluation API — the parity-test surface.

Equivalent of reference wrapper/cfuncs.py:157-1259, following
py21cmfast_tpu/cfuncs.py: direct access to the sigma/HMF/conditional-integral/
sampler machinery without running full boxes.  The reference uses these for
its tier-2 tests; the same calls here hit the host-side float64 tables that
the port's device code consumes, and return what the JAX package's return.
The two that run device code, `convert_halo_properties` and
`sample_halos_from_conditions`, take a keyword-only `device="cuda"` and
return numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .cosmology.constants import physconst
from .inputs import InputParameters
from .models import hmf
from .models.ionization import _get_sigma_table

__all__ = [
    "convert_halo_properties",
    "evaluate_sigma",
    "evaluate_condition_integrals",
    "evaluate_SFRD_cond",
    "evaluate_Nion_cond",
    "evaluate_inverse_table",
    "return_uhmf_value",
    "return_chmf_value",
    "compute_tau",
    "compute_mturns",
    "compute_luminosity_function",
    "evaluate_FgtrM_cond",
    "evaluate_SFRD_z",
    "evaluate_Nion_z",
    "get_condition_mass",
    "get_delta_crit",
    "get_delta_crit_nu",
    "get_expected_nhalo",
    "get_growth_factor",
    "get_halo_catalog_buffer_size",
    "get_matter_power_values",
    "get_vcb_power_values",
    "integrate_chmf_interval",
    "sample_halos_from_conditions",
]


def evaluate_sigma(inputs: InputParameters, masses):
    """sigma(M) and dsigma^2/dM at z=0 (reference evaluate_sigma:443)."""
    t = _get_sigma_table(inputs)
    ln_m = np.log(np.asarray(masses, dtype=np.float64))
    return t.sigma_of_lnm(ln_m), t.dsigmasq_of_lnm(ln_m)


def return_uhmf_value(inputs: InputParameters, redshift, masses):
    """Unconditional dn/dlnM [Mpc^-3] (reference return_uhmf_value:1203)."""
    t = _get_sigma_table(inputs)
    cosmo = inputs.cosmology
    growth = float(cosmo.dicke(redshift))
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    ln_m = np.log(np.asarray(masses, dtype=np.float64))
    return hmf.unconditional_mf(t, cosmo, hmf_int, redshift, growth, ln_m) * cosmo.rho_mean


def return_chmf_value(inputs: InputParameters, redshift, masses, cond_mass, delta):
    """Conditional MF per condition mass (reference return_chmf_value:1227)."""
    t = _get_sigma_table(inputs)
    cosmo = inputs.cosmology
    growth = float(cosmo.dicke(redshift))
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    if hmf_int not in (hmf.HMF_PS, hmf.HMF_ST, hmf.HMF_DELOS):
        hmf_int = hmf.HMF_PS
    ln_m = np.log(np.asarray(masses, dtype=np.float64))
    sigma_cond = t.sigma_of_lnm(np.log(cond_mass))
    return hmf.conditional_mf(t, hmf_int, growth, ln_m, delta, sigma_cond)


def evaluate_condition_integrals(inputs: InputParameters, redshift, cond_masses, deltas):
    """(N_halo, M_coll) per condition (reference evaluate_condition_integrals:512)."""
    t = _get_sigma_table(inputs)
    cosmo = inputs.cosmology
    growth = float(cosmo.dicke(redshift))
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    m_min = inputs.simulation_options.SAMPLER_MIN_MASS
    ln_mc = np.log(np.asarray(cond_masses, dtype=np.float64))
    sig = t.sigma_of_lnm(ln_mc)
    n = hmf.nhalo_conditional(t, hmf_int, growth, np.log(m_min), ln_mc, sig, deltas)
    m = hmf.mcoll_conditional(t, hmf_int, growth, np.log(m_min), ln_mc, sig, deltas)
    return n * np.exp(ln_mc), m * np.exp(ln_mc)


def evaluate_SFRD_cond(inputs: InputParameters, redshift, cond_mass, deltas):
    """Conditional SFRD integrand values (reference evaluate_SFRD_cond:782)."""
    t = _get_sigma_table(inputs)
    cosmo = inputs.cosmology
    growth = float(cosmo.dicke(redshift))
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    sc = hmf.set_scaling_constants(redshift, inputs).without_esc()
    m_min = hmf.minimum_source_mass(redshift, inputs, xray=True)
    sig = float(t.sigma_of_lnm(np.log(cond_mass)))
    return hmf.nion_conditional(
        t, hmf_int, growth, np.log(m_min), float(np.log(cond_mass)), sig,
        np.asarray(deltas), sc.mturn_a_nofb, sc,
        method=inputs.astro_options.INTEGRATION_METHOD_ATOMIC,
    )


def evaluate_Nion_cond(inputs: InputParameters, redshift, cond_mass, deltas):
    """Conditional Nion values (reference evaluate_Nion_cond:873)."""
    t = _get_sigma_table(inputs)
    cosmo = inputs.cosmology
    growth = float(cosmo.dicke(redshift))
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    sc = hmf.set_scaling_constants(redshift, inputs)
    m_min = hmf.minimum_source_mass(redshift, inputs)
    sig = float(t.sigma_of_lnm(np.log(cond_mass)))
    return hmf.nion_conditional(
        t, hmf_int, growth, np.log(m_min), float(np.log(cond_mass)), sig,
        np.asarray(deltas), sc.mturn_a_nofb, sc,
        method=inputs.astro_options.INTEGRATION_METHOD_ATOMIC,
    )


def evaluate_inverse_table(inputs: InputParameters, redshift, cond_mass, deltas, probabilities):
    """M(delta, p) from the inverse CMF table (reference evaluate_inverse_table:574)."""
    t = _get_sigma_table(inputs)
    growth = float(inputs.cosmology.dicke(redshift))
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    so = inputs.simulation_options
    sig = float(t.sigma_of_lnm(np.log(cond_mass)))
    lnp_axis, inv = hmf.build_inverse_cmf_table(
        t, hmf_int, growth, np.log(so.SAMPLER_MIN_MASS), float(np.log(cond_mass)),
        sig, np.asarray(deltas), n_prob=so.N_PROB_INTERP, min_logprob=so.MIN_LOGPROB,
    )
    probs = np.clip(np.log(np.asarray(probabilities)), so.MIN_LOGPROB, 0.0)
    out = np.array([np.interp(probs, lnp_axis, row) for row in inv])
    return np.exp(out)


def sample_halos_from_conditions(inputs: InputParameters, redshift, deltas,
                                 seed=1234, redshift_prev=None, *, device="cuda"):
    """Draw halo samples for given conditions; returns dict with masses
    per condition (reference sample_halos_from_conditions:1053 /
    single_test_sample, Stochasticity.c:1168).

    With `redshift_prev`, `deltas` is instead interpreted as DESCENDANT HALO
    MASSES at `redshift_prev` and progenitors are sampled down to `redshift`
    with the configured SAMPLE_METHOD (grid conditions always sample
    number-limited, matching stoc_sample).  The draws come from a
    torch.Generator on `device` seeded with `seed`: a seed gives other halos
    than the JAX package's key does, from the same distribution."""
    from .models.halos import _normals, _sample_progenitors, sample_halo_grid
    from .outputs import HaloCatalog

    dev = resolve_device(device)
    generator = torch.Generator(device=dev)
    generator.manual_seed(int(seed))
    if redshift_prev is not None:
        masses_d = torch.as_tensor(np.asarray(deltas, dtype=np.float32), device=dev)
        n = masses_d.numel()
        star, sfr, xray = _normals(n, generator, dev)
        cat = HaloCatalog(
            redshift=np.float32(redshift_prev),
            halo_masses=masses_d,
            halo_coords=torch.zeros((n, 3), dtype=torch.float32, device=dev),
            star_rng=star, sfr_rng=sfr, xray_rng=xray,
            n_halos=n,
        )
        out = _sample_progenitors(redshift, inputs, cat, generator, dev)
        m = out.halo_masses.cpu().numpy()
        return {"halo_masses": m[m > 0], "n_halos": int(out.n_halos)}

    deltas = np.asarray(deltas, dtype=np.float64)
    growth = float(inputs.cosmology.dicke(redshift))
    # build a fake "grid" holding the conditions (lagrangian delta at z=0 norm)
    n = len(deltas)
    side = int(np.ceil(n ** (1 / 3)))
    grid = np.zeros(side**3)
    grid[:n] = deltas / growth
    box_len = side * inputs.simulation_options.box_len / inputs.simulation_options.HII_DIM
    inputs_grid = inputs.evolve_input_structs(
        HII_DIM=side, DIM=2 * side,
        BOX_LEN=box_len,
        # the synthetic condition grid can be tiny; keep the (unused here)
        # bubble radius inside it so cross-validation passes
        R_BUBBLE_MAX=min(
            inputs.astro_params.r_bubble_max(inputs.astro_options), box_len / 4
        ),
    )
    pad_mask = np.arange(side**3) >= n  # padding cells sample nothing
    masses, _pos = sample_halo_grid(
        redshift, inputs_grid, grid.reshape(side, side, side).astype(np.float32),
        exclude_mask=pad_mask.reshape(side, side, side), generator=generator, device=dev,
    )
    m = masses.cpu().numpy()
    m = m[m > 0]
    return {"halo_masses": m, "n_halos": len(m)}


def convert_halo_properties(inputs: InputParameters, redshift, halo_masses,
                            star_rng=None, sfr_rng=None, xray_rng=None, *, device="cuda"):
    """Per-halo galaxy properties from the stochastic scaling relations
    (reference cfuncs.convert_halo_properties:1106 / test_halo_props), run
    on `device` by the port's `halo_properties`.

    Returns a dict of numpy arrays: stellar_mass [Msun], sfr [Msun/s], n_ion
    weight, fesc-weighted sfr, and xray luminosity [1e38 erg/s]."""
    from .models.halobox import halo_properties
    from .outputs import HaloCatalog

    dev = resolve_device(device)

    def on_dev(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=torch.float32)
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    m = on_dev(halo_masses)
    zeros = torch.zeros_like(m)
    cat = HaloCatalog(
        redshift=np.float32(redshift),
        halo_masses=m,
        halo_coords=torch.zeros((m.numel(), 3), dtype=torch.float32, device=dev),
        star_rng=zeros if star_rng is None else on_dev(star_rng),
        sfr_rng=zeros if sfr_rng is None else on_dev(sfr_rng),
        xray_rng=zeros if xray_rng is None else on_dev(xray_rng),
        n_halos=m.numel(),
    )
    stellar, sfr, n_ion_w, wsfr, xray38 = halo_properties(redshift, inputs, cat, device=dev)
    return {
        "stellar_mass": stellar.cpu().numpy(),
        "sfr": sfr.cpu().numpy(),
        "n_ion": n_ion_w.cpu().numpy(),
        "fesc_weighted_sfr": wsfr.cpu().numpy(),
        "xray_luminosity": xray38.cpu().numpy(),
    }


def compute_tau(inputs: InputParameters, redshifts, global_xHI, z_re_HeII: float = 3.0):
    """Thomson scattering optical depth tau_e given a reionization history
    (reference compute_tau:157): integrates n_e sigma_T along the LoS with
    singly-ionized He tracking H and HeII reionization at z_re_HeII."""
    cosmo = inputs.cosmology
    redshifts = np.asarray(redshifts, dtype=np.float64)
    global_xHI = np.asarray(global_xHI, dtype=np.float64)
    order = np.argsort(redshifts)
    redshifts, global_xHI = redshifts[order], global_xHI[order]

    z_grid = np.linspace(0.0, max(redshifts.max(), z_re_HeII + 1), 3000)
    xhi = np.interp(z_grid, redshifts, global_xHI, left=global_xHI[0], right=1.0)
    xhi = np.where(z_grid > redshifts.max(), 1.0, xhi)
    x_e = 1.0 - xhi

    no = cosmo.rho_crit_cgs * cosmo.OMb * (1 - cosmo.Y_He) / physconst.m_p
    fhe = (cosmo.Y_He / 4) / (1 - cosmo.Y_He)
    # tau = int n_e(proper) sigma_T c |dt/dz| dz
    n_e = no * (1 + z_grid) ** 3 * x_e * (1 + fhe * (1 + (z_grid < z_re_HeII)))
    dldz = np.abs(physconst.c_cms * cosmo.dtdz(z_grid))  # proper path per dz
    return float(np.trapezoid(n_e * physconst.sigma_T * dldz, z_grid))


# ---------------------------------------------------------------------------
# the rest of the reference surface (reference wrapper/cfuncs.py:26-1050)


def get_growth_factor(inputs: InputParameters, redshift):
    """D(z), D(0)=1 (reference get_growth_factor:468)."""
    return float(inputs.cosmology.dicke(redshift))


def get_matter_power_values(inputs: InputParameters, k):
    """Linear matter P(k) at z=0 in Mpc^3 (reference get_matter_power_values:418)."""
    return inputs.cosmology.power_in_k(np.asarray(k, dtype=np.float64))


def get_vcb_power_values(inputs: InputParameters, k):
    """Relative-velocity power (reference get_vcb_power_values:428)."""
    return inputs.cosmology.power_vcb(np.asarray(k, dtype=np.float64))


def get_condition_mass(inputs: InputParameters, R: float):
    """Lagrangian mass of a filter scale R [Mpc] (reference get_condition_mass:477)."""
    return float(inputs.cosmology.RtoM(R))


def get_delta_crit(inputs: InputParameters, mass: float, redshift: float):
    """Collapse barrier for the configured (conditional) HMF at (M, z)
    (reference get_delta_crit:498)."""
    t = _get_sigma_table(inputs)
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    if hmf_int not in (hmf.HMF_PS, hmf.HMF_ST, hmf.HMF_DELOS):
        hmf_int = hmf.HMF_PS
    sigma = float(t.sigma_of_lnm(np.log(mass)))
    growth = float(inputs.cosmology.dicke(redshift))
    return float(hmf.get_delta_crit(hmf_int, sigma, growth))


def get_delta_crit_nu(hmf_int_flag: int, sigma: float, growth: float):
    """Barrier from (sigma, growth) directly (reference get_delta_crit_nu:505)."""
    return float(hmf.get_delta_crit(int(hmf_int_flag), float(sigma), float(growth)))


def get_expected_nhalo(inputs: InputParameters, redshift: float) -> int:
    """Expected halo count above SAMPLER_MIN_MASS in the box
    (reference get_expected_nhalo:26)."""
    t = _get_sigma_table(inputs)
    cosmo = inputs.cosmology
    so = inputs.simulation_options
    growth = float(cosmo.dicke(redshift))
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    ln_m = np.linspace(np.log(so.SAMPLER_MIN_MASS), np.log(hmf.M_MAX_INTEGRAL), 400)
    dn = hmf.unconditional_mf(t, cosmo, hmf_int, redshift, growth, ln_m) * cosmo.rho_mean
    n_per_vol = float(np.trapezoid(dn, ln_m))
    vol = float(np.prod(so.box_lens))
    return int(n_per_vol * vol)


def get_halo_catalog_buffer_size(inputs: InputParameters, redshift: float) -> int:
    """Padded catalog allocation size (reference get_halo_catalog_buffer_size:57)."""
    from ._cfg import config

    n = get_expected_nhalo(inputs, redshift)
    factor = float(inputs.simulation_options.SAMPLER_BUFFER_FACTOR)
    mem_factor = float(config.get("HALO_CATALOG_MEM_FACTOR", 1.0))
    return max(int(n * factor * mem_factor), 10000)


def compute_mturns(inputs: InputParameters, redshift, J_LW_21=0.0, v_cb=0.0,
                   ionisation_rate_G12=0.0, z_reion=-1.0):
    """(M_turn_acg, M_turn_mcg) with LW + streaming + reionization feedback
    (reference compute_mturns:83 / thermochem.c:300-323)."""
    ap = inputs.astro_params
    cosmo = inputs.cosmology
    z = float(redshift)
    acg = float(cosmo.TtoM(z, 1e4, 0.59))
    # Sobacchi & Mesinger 2013 reionization feedback
    if z_reion > 0.0:
        zfrac = max(1.0 - ((1.0 + z) / (1.0 + z_reion)) ** 2.0, 0.0)
        m_re = (
            3e9 * (2.0 * max(ionisation_rate_G12, 1e-20)) ** 0.17
            * ((1.0 + z) / 10.0) ** -2.1 * zfrac**2.5
        )
    else:
        m_re = 0.0
    m_turn_a = max(acg, m_re, ap.m_turn)
    m_turn_m = None
    if inputs.astro_options.USE_MINI_HALOS:
        mlw = float(hmf.lyman_werner_threshold(
            z, J_LW_21, v_cb, ap, v_cb_avg=inputs.cosmology.V_CB_AVG))
        m_turn_m = max(mlw, m_re, ap.m_turn)
    return m_turn_a, m_turn_m


def integrate_chmf_interval(inputs: InputParameters, redshift, m_lo, m_hi,
                            cond_mass, deltas):
    """Conditional-MF number integral over [m_lo, m_hi) per condition
    (reference integrate_chmf_interval:541)."""
    t = _get_sigma_table(inputs)
    growth = float(inputs.cosmology.dicke(redshift))
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    if hmf_int not in (hmf.HMF_PS, hmf.HMF_ST, hmf.HMF_DELOS):
        hmf_int = hmf.HMF_PS
    sig = t.sigma_of_lnm(np.log(cond_mass))
    d = np.asarray(deltas, dtype=np.float64)
    return hmf.integrate_cmf(
        t, hmf_int, growth, float(np.log(m_lo)),
        float(np.log(m_hi)) * np.ones_like(d), d, sig * np.ones_like(d),
    ) * cond_mass


def evaluate_FgtrM_cond(inputs: InputParameters, redshift, cond_mass, deltas):
    """Conditional collapsed fraction (EPS erfc form; reference
    evaluate_FgtrM_cond:608 / FgtrM_bias_fast)."""
    t = _get_sigma_table(inputs)
    growth = float(inputs.cosmology.dicke(redshift))
    m_min = hmf.minimum_source_mass(redshift, inputs)
    sigma_min = float(t.sigma_of_lnm(np.log(m_min)))
    sigma_cond = float(t.sigma_of_lnm(np.log(cond_mass)))
    return hmf.fcoll_conditional_eps(
        growth, np.asarray(deltas, dtype=np.float64), sigma_min, sigma_cond
    )


def evaluate_SFRD_z(inputs: InputParameters, redshifts, log10_mturns=None):
    """Global SFRD(z) table values (reference evaluate_SFRD_z:631): the
    Nion_General integral with f_esc = 1; with `log10_mturns`, also the MCG
    component at those LW turnovers."""
    t = _get_sigma_table(inputs)
    cosmo = inputs.cosmology
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    ln_mmax = np.log(hmf.M_MAX_INTEGRAL)
    zs = np.atleast_1d(np.asarray(redshifts, dtype=np.float64))
    out = np.empty_like(zs)
    out_mini = None if log10_mturns is None else np.empty((len(zs),))
    for i, z in enumerate(zs):
        sc = hmf.set_scaling_constants(float(z), inputs).without_esc()
        m_min = hmf.minimum_source_mass(float(z), inputs, xray=True)
        out[i] = hmf.nion_general(
            t, cosmo, hmf_int, float(z), np.log(m_min), ln_mmax,
            sc.mturn_a_nofb, sc,
        )
        if out_mini is not None:
            out_mini[i] = hmf.nion_general_mini(
                t, cosmo, hmf_int, float(z), np.log(m_min), ln_mmax,
                10.0 ** np.asarray(log10_mturns, dtype=np.float64)[i], sc,
            )
    return (out, out_mini) if out_mini is not None else (out, None)


def evaluate_Nion_z(inputs: InputParameters, redshifts, log10_mturns=None):
    """Global ionizing emissivity table values (reference evaluate_Nion_z:706)."""
    t = _get_sigma_table(inputs)
    cosmo = inputs.cosmology
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    ln_mmax = np.log(hmf.M_MAX_INTEGRAL)
    zs = np.atleast_1d(np.asarray(redshifts, dtype=np.float64))
    out = np.empty_like(zs)
    out_mini = None if log10_mturns is None else np.empty((len(zs),))
    for i, z in enumerate(zs):
        sc = hmf.set_scaling_constants(float(z), inputs)
        m_min = hmf.minimum_source_mass(float(z), inputs)
        out[i] = hmf.nion_general(
            t, cosmo, hmf_int, float(z), np.log(m_min), ln_mmax,
            sc.mturn_a_nofb, sc,
        )
        if out_mini is not None:
            out_mini[i] = hmf.nion_general_mini(
                t, cosmo, hmf_int, float(z), np.log(m_min), ln_mmax,
                10.0 ** np.asarray(log10_mturns, dtype=np.float64)[i], sc,
            )
    return (out, out_mini) if out_mini is not None else (out, None)


def compute_luminosity_function(redshifts, inputs: InputParameters, nbins=100,
                                mturnovers=None, component="acg"):
    """UV luminosity function (reference compute_luminosity_function:211);
    thin re-export of models.luminosity.compute_luminosity_function."""
    from .models.luminosity import compute_luminosity_function as _lf

    return _lf(redshifts, inputs, nbins=nbins, mturnovers=mturnovers,
               component=component)
