"""The catalog gate: the compared cone's halo catalogs held to the
conditional mass function (CMF) of the reference's own tables
(`models/hmf.py` and the sigma table of `models/ionization.py`, with the
reference's own Lagrangian densities), before the reference takes them as
the cone's random input (`halos.py`).

- `halo_count`: the lowest node's grid sample (its catalog after DexM's
  halos, which lead it and carry DexM's discrete level masses) counts
  within 1% of sum(n_exp) plus one halo a collapsed cell, n_exp being each
  sampling cell's CMF integral from SAMPLER_MIN_MASS to the cell mass at
  its density, or within 5 sigma of Poisson where that is wider;
- `halo_octaves`: its count in each of four mass octaves from
  SAMPLER_MIN_MASS within 5 sigma of the CMF's expectation;
- `step_octaves`: the first progenitor step (the lowest node's halos as
  descendants, the next node's as progenitors) in the same octaves against
  the CMF conditioned on each descendant as the sampler conditions it,
  within 5 sigma and the share `STEP_SHARE` of the sample method (MASS-
  LIMITED keeps mass, not number; see `STEP_SHARE`);
- `rng_mean`, `rng_var`: the `star_rng`, `sfr_rng` and `xray_rng` of each
  node of RNG_MIN_HALOS halos or more against N(0, 1), the mean and the
  variance within 5 sigma.

Cells that DexM excludes (more than half inside its halos) are counted as
sampling: that takes a DexM halo of more than half a cell's mass, which the
cut boxes hold none of and a deep cone a handful, each worth some dozens of
halos against the 1%.  Each number is returned beside its limit; the gate
passes where none is above it.
"""

from __future__ import annotations

import math

import numpy as np

from .cosmology.constants import physconst
from .models import hmf
from .models.ionization import _get_sigma_table

SIGMAS = 5.0
COUNT_SHARE = 0.01
OCTAVES = 4
# the share by which a progenitor step's octave may depart from the CMF
# besides its 5 sigma, by SAMPLE_METHOD: NUMBER-LIMITED draws a Poisson
# number from the CMF; MASS-LIMITED draws until the target mass and trims
# to it, which reads 6-8% off the CMF's count at steps of 1.02-1.05 in
# 1 + z (and 37% at 1.2): twice that (PERF.md)
STEP_SHARE = {"NUMBER-LIMITED": 0.0, "MASS-LIMITED": 0.15}
# the nodes whose property draws are held to N(0, 1): those with this many
# halos, where a sample's variance is near normal
RNG_MIN_HALOS = 1000


def _numpy(t):
    return t.detach().double().cpu().numpy().reshape(-1)


def _edges(inputs):
    return inputs.simulation_options.SAMPLER_MIN_MASS * 2.0 ** np.arange(OCTAVES + 1)


def dexm_levels(inputs) -> np.ndarray:
    """DexM's level masses (float32): the tophat radii from a hires cell's up
    to a quarter box, DELTA_R_FACTOR apart."""
    so = inputs.simulation_options
    r_min = physconst.l_factor * so.box_len / so.dim
    r_max = physconst.l_factor * so.box_len / 4
    n_r = int(math.log(r_max / r_min) / math.log(so.DELTA_R_FACTOR)) + 1
    radii = r_min * so.DELTA_R_FACTOR ** np.arange(n_r)
    return np.asarray(inputs.cosmology.RtoM(radii[radii <= r_max])).astype(np.float32)


def _grid_sample(inputs, z, masses, lowres_density):
    """(count share and its limit, worst octave in sigma)."""
    so, cosmo = inputs.simulation_options, inputs.cosmology
    table = _get_sigma_table(inputs)
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    growth = float(cosmo.dicke(z))
    m_cell = cosmo.rho_mean * (so.box_len / so.HII_DIM) ** 3
    sigma_cell = float(table.sigma_of_lnm(math.log(m_cell)))
    d_hi = float(hmf.get_delta_crit(hmf_int if hmf_int in (0, 1, 4) else 0, sigma_cell, growth)
                 ) * hmf.MAX_DELTAC_FRAC
    deltas = np.linspace(-1.0 + 1e-6, d_hi, so.N_COND_INTERP)
    delta = _numpy(lowres_density) * growth
    collapsed = delta >= d_hi
    delta = np.clip(delta, deltas[0], d_hi)

    def above(m):
        per = hmf.nhalo_conditional(table, hmf_int, growth, math.log(m), math.log(m_cell),
                                    sigma_cell, deltas) * m_cell
        return float(np.interp(delta, deltas, per)[~collapsed].sum())

    edges = _edges(inputs)
    expected = above(edges[0]) + int(collapsed.sum())
    levels = np.isin(masses.astype(np.float32), dexm_levels(inputs))
    grid = masses[int(np.argmin(levels)) if not levels.all() else masses.size:]
    share = abs(grid.size / expected - 1.0) if expected > 0 else float(grid.size > 0)
    limit = max(COUNT_SHARE, SIGMAS / math.sqrt(expected)) if expected > 0 else 0.0
    want = -np.diff([above(e) for e in edges])
    got = np.histogram(grid, bins=edges)[0]
    return (share, limit), _worst_sigma(got, want, 0.0)


def _worst_sigma(got, want, share):
    """The worst octave's departure in units of its limit's sigma: |got -
    want| over sqrt(want) + share * want / SIGMAS, so that a departure of
    share * want and SIGMAS Poisson sigma reads SIGMAS."""
    want = np.asarray(want, np.float64)
    scale = np.sqrt(np.maximum(want, 1.0)) + share * want / SIGMAS
    return float(np.max(np.abs(got - want) / scale))


def _first_step(inputs, z_desc, desc, z_prog, prog):
    """The worst octave of the progenitors against the CMF of each
    descendant: a descendant of mass M conditions on M and on its collapse
    barrier at its own redshift grown to the progenitors'."""
    if desc.size == 0:
        return float(prog.size > 0)
    cosmo = inputs.cosmology
    so = inputs.simulation_options
    table = _get_sigma_table(inputs)
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    growth, growth_desc = float(cosmo.dicke(z_prog)), float(cosmo.dicke(z_desc))
    ln_m = np.linspace(math.log(so.SAMPLER_MIN_MASS), math.log(desc.max()) + 1e-3, 512)
    sigma = table.sigma_of_lnm(ln_m)
    delta = hmf.get_delta_crit(hmf_int if hmf_int in (0, 1, 4) else 0, sigma,
                               growth_desc) * growth / growth_desc
    ln_desc = np.log(np.maximum(desc, so.SAMPLER_MIN_MASS))

    def above(m):
        per = hmf.nhalo_conditional(table, hmf_int, growth, math.log(m), ln_m, sigma,
                                    delta) * np.exp(ln_m)
        return float(np.interp(ln_desc, ln_m, np.where(ln_m > math.log(m), per, 0.0)).sum())

    edges = _edges(inputs)
    want = -np.diff([above(e) for e in edges])
    got = np.histogram(prog, bins=edges)[0]
    return _worst_sigma(got, want, STEP_SHARE.get(inputs.matter_options.SAMPLE_METHOD, 0.0))


def _draws(catalogs):
    """The worst mean and variance of each property draw over the nodes of
    RNG_MIN_HALOS halos or more, in sigma of N(0, 1)'s."""
    worst_mean = worst_var = 0.0
    for cat in catalogs.values():
        for name in ("star_rng", "sfr_rng", "xray_rng"):
            x = _numpy(getattr(cat, name))
            if x.size < RNG_MIN_HALOS:
                continue
            worst_mean = max(worst_mean, float(abs(x.mean())) * math.sqrt(x.size))
            worst_var = max(worst_var,
                            float(abs(x.var(ddof=1) - 1.0)) / math.sqrt(2.0 / (x.size - 1)))
    return worst_mean, worst_var


def check(inputs, catalogs, lowres_density) -> dict:
    """{name: {"value", "limit"}} of the cone's catalogs ({float32 node
    redshift: catalog}) at the reference's Lagrangian lowres density."""
    nodes = sorted(catalogs)
    z0 = nodes[0]
    m0 = _numpy(catalogs[z0].halo_masses)
    (share, limit), octaves = _grid_sample(inputs, z0, m0, lowres_density)
    out = {"halo_count": {"value": share, "limit": limit},
           "halo_octaves": {"value": octaves, "limit": SIGMAS}}
    if len(nodes) > 1:
        step = _first_step(inputs, z0, m0, nodes[1], _numpy(catalogs[nodes[1]].halo_masses))
        out["step_octaves"] = {"value": step, "limit": SIGMAS}
    mean, var = _draws(catalogs)
    out["rng_mean"] = {"value": mean, "limit": SIGMAS}
    out["rng_var"] = {"value": var, "limit": SIGMAS}
    return out
