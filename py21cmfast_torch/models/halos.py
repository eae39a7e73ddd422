"""Discrete halo catalogs: the DexM excursion-set finder, the CHMF grid
sampler and the progenitor sampler.

Equivalent of reference HaloCatalog.c:38-625, Stochasticity.c and
PerturbedHaloCatalog.c:25-149, following py21cmfast_tpu/models/halos.py:

 * DexM (`_dexm_scan`): a descending-R excursion set on the hires grid whose
   exclusion is a mask grown by painting tophat spheres in k-space, one
   Python step a radius through `torch.fft`.
 * The grid sampler (`sample_halo_grid`): every lowres cell draws k_max
   masses from the inverse conditional mass function and keeps a Poisson
   number of them (grid conditions always sample number-limited,
   Stochasticity.c:696-699).
 * Progenitors (`_sample_progenitors`): each halo of the previous (lower-z)
   catalog draws 64 masses from the inverse CMF conditioned on its mass and
   keeps them MASS-LIMITED (`_fix_mass_keep`, the reference's two-sided
   overshoot correction) or NUMBER-LIMITED; positions and the property
   draws are inherited, the latter AR(1)-mixed with fresh normals.

Every random step is split in two: a draw, from a `torch.Generator` on its
own device, and a deterministic core that takes the draws as tensors; the
draws are moved to the run's device.  The host parts (numpy float64) are
the condition tables, the DexM radii and barriers, and the numpy draws of
the reference (`default_rng(seed + 3)` for the DexM jitter,
`default_rng(seed + 29)` for the collapsed cells).  Catalogs are stored
compacted, in the order of `torch.nonzero` (row-major, as `np.nonzero`).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import not_in_slice, resolve_device
from ..cosmology.constants import physconst
from ..inputs import InputParameters
from ..ops import cic, fft, filters, grids
from ..outputs import HaloCatalog, InitialConditions, PerturbedHaloCatalog
from . import hmf
from .ionization import _get_sigma_table
from .perturb import _displacement_factors

__all__ = ["default_generator", "determine_halo_catalog", "perturb_halo_catalog",
           "sample_halo_grid"]

# same-level dedup strata of DexM (the JAX package's DEXM_SAME_LEVEL_STRATA)
DEXM_SAME_LEVEL_STRATA = 4
# the grid sampler's (cells, k_max) draws per chunk
SAMPLER_CHUNK_ENTRIES = 2**22
# progenitor draws per descendant (the multiplicity of a ~2% step is small)
PROGENITOR_K_MAX = 64
# descendants per chunk of the progenitor sampler
PROGENITOR_CHUNK_ROWS = 2**20

_f32 = np.float32


def check_inputs(inputs: InputParameters) -> None:
    """Raise NotImplementedError for the progenitor samplers outside the port."""
    method = inputs.matter_options.SAMPLE_METHOD
    if method not in ("MASS-LIMITED", "NUMBER-LIMITED"):
        not_in_slice(f"SAMPLE_METHOD={method!r}", 13)


def default_generator(inputs: InputParameters, redshift: float, device) -> torch.Generator:
    """A generator on `device` seeded from random_seed and int(redshift * 100),
    the two numbers the JAX package folds into its key."""
    seed = np.random.SeedSequence([int(inputs.random_seed), int(redshift * 100)])
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return g


def _rand(shape, generator, dev, low=None):
    u = torch.rand(shape, generator=generator, device=generator.device)
    if low is not None:
        u.clamp_(min=low)
    return u.to(dev)


def _normals(n, generator, dev):
    """Three standard normals a halo: its stellar, SFR and X-ray scatter
    (`_property_rng`)."""
    return tuple(torch.randn(n, generator=generator, device=generator.device).to(dev)
                 for _ in range(3))


def _interp(x, xp, fp):
    """np.interp on the device (float64): `xp` increasing, ends clamped."""
    j = torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0, xp.numel() - 2)
    slope = (fp[j + 1] - fp[j]) / (xp[j + 1] - xp[j])
    y = slope * (x - xp[j]) + fp[j]
    y = torch.where(x <= xp[0], fp[0], y)
    return torch.where(x >= xp[-1], fp[-1], y)


# ---------------------------------------------------------------------------
# DexM: excursion-set halo finder on the hires grid


def _sphere_vol(r32):
    """4/3 pi r^3 in float32, as the JAX package forms it from a float32 r."""
    return float(_f32(4.0 / 3.0 * np.pi) * (r32 * (r32 * r32)))


def _dexm_scan(d_k, barriers, radii, masses, loose_level, stratum_grid, *, hi_shape,
               box_lens, optimize=False, strata=DEXM_SAME_LEVEL_STRATA):
    """Descending-R excursion set with FFT sphere-painted exclusion
    (HaloCatalog.c:227-289).

    At each radius (host float32 `radii`, `barriers`, `masses`, bool
    `loose_level`), the cells above the barrier, outside every halo and
    clear of flagged cells within R (a tophat convolution of the in_halo
    mask below half a cell) become candidates.  With `optimize`
    (DEXM_OPTIMIZE) the levels above DEXM_OPTIMIZE_MINMASS test the centre
    cell only.  Same-level overlaps are resolved by taking the candidates in
    `strata` batches by `stratum_grid` (uint8 in [0, strata)): each batch
    is tested against the centres accepted before it at the conflict radius
    2R (R for the loose test).  New centres then paint their spheres into
    in_halo.  Returns (halo_mass_grid, in_halo): the halo mass at each
    centre cell, 0 elsewhere."""
    dev = d_k.device
    kmag = grids.kmag_grid(hi_shape, box_lens, dev)
    half_cell = float(_f32(0.5 * (box_lens[0] / hi_shape[0]) ** 3))
    halo_grid = torch.zeros(hi_shape, dtype=torch.float32, device=dev)
    in_halo = torch.zeros(hi_shape, dtype=torch.bool, device=dev)

    def smoothed(box_k, r):
        return fft.irfft3(filters.filter_kbox(box_k, kmag, filters.TOPHAT, r), hi_shape)

    for r32, barrier, mass, loose in zip(radii, barriers, masses, loose_level):
        r, vol = float(r32), _sphere_vol(r32)
        cand = smoothed(d_k, r) > float(barrier)
        # overlap of already-flagged cells within R of each centre
        occupied = smoothed(fft.rfft3(in_halo.to(torch.float32)), r)
        clear = occupied * vol < half_cell
        del occupied
        if optimize and loose:
            clear = ~in_halo
        cand &= ~in_halo & clear
        del clear
        if strata <= 1:
            new_centres = cand
        else:
            r_conf = r32 if (optimize and loose) else _f32(2.0) * r32
            vol_conf = _sphere_vol(r_conf)
            new_centres = cand & (stratum_grid == 0)
            for s in range(1, strata):
                n_near = smoothed(fft.rfft3(new_centres.to(torch.float32)), float(r_conf))
                ok = n_near * vol_conf < half_cell
                del n_near
                new_centres = new_centres | (cand & (stratum_grid == s) & ok)
                del ok
        del cand
        halo_grid = torch.where(new_centres, float(mass), halo_grid)
        # paint the exclusion spheres: anything with weight above half a
        # cell in a normalized tophat of radius R lies inside some halo
        painted = smoothed(fft.rfft3(new_centres.to(torch.float32)), r)
        in_halo |= painted * vol > half_cell
        del painted, new_centres
    return halo_grid, in_halo


def dexm_levels(redshift: float, inputs: InputParameters):
    """DexM's host arrays, float32: the radii (descending from box/4 to the
    hires cell, by DELTA_R_FACTOR), the barrier at each (the ST-like
    moving barrier, hmf.c:143-146, in z=0-linear units), the halo mass of
    each and whether each is above DEXM_OPTIMIZE_MINMASS."""
    so = inputs.simulation_options
    cosmo = inputs.cosmology
    growth = float(cosmo.dicke(redshift))
    r_min = physconst.l_factor * so.box_len / so.dim
    r_max = physconst.l_factor * so.box_len / 4  # halos can't exceed ~ box/4
    n_r = int(np.log(r_max / r_min) / np.log(so.DELTA_R_FACTOR)) + 1
    radii = r_min * so.DELTA_R_FACTOR ** np.arange(n_r)
    radii = radii[radii <= r_max][::-1]
    masses = np.asarray(cosmo.RtoM(radii))
    sigmas = _get_sigma_table(inputs).sigma_of_lnm(np.log(masses))
    barriers = hmf.sheth_delc_dexm(physconst.delta_c_sph / growth, sigmas)
    return (radii.astype(_f32), barriers.astype(_f32), masses.astype(_f32),
            masses > so.DEXM_OPTIMIZE_MINMASS)


def draw_strata(inputs: InputParameters, generator: torch.Generator, device):
    """The draw of DexM: a uint8 stratum in [0, 4) for every hires cell."""
    return torch.randint(0, DEXM_SAME_LEVEL_STRATA, inputs.simulation_options.hires_shape,
                         generator=generator, device=generator.device,
                         dtype=torch.uint8).to(device)


def dexm_halo_grid(redshift: float, inputs: InputParameters, ics: InitialConditions,
                   stratum_grid=None, generator=None, *, device="cuda"):
    """Run the DexM finder on the hires IC density; returns
    (halo_mass_grid, in_halo), both hires.  The strata are drawn from
    `generator` (`default_generator` when None) unless given."""
    dev = resolve_device(device)
    so = inputs.simulation_options
    if stratum_grid is None:
        if generator is None:
            generator = default_generator(inputs, redshift, dev)
        stratum_grid = draw_strata(inputs, generator, dev)
    radii, barriers, masses, loose = dexm_levels(redshift, inputs)
    d_k = fft.rfft3(ics.hires_density.to(dev))
    return _dexm_scan(d_k, barriers, radii, masses, loose, stratum_grid.to(dev),
                      hi_shape=so.hires_shape, box_lens=so.box_lens,
                      optimize=bool(inputs.matter_options.DEXM_OPTIMIZE))


def _dexm_catalog(inputs, halo_grid, in_halo):
    """The DexM halos (host float32 masses and float64 Mpc positions, the
    centre cells in C order plus a `default_rng(seed + 3)` jitter) and the
    lowres exclusion mask: cells more than half inside DexM halos sample no
    more mass (a zero mask when DIM is no multiple of HII_DIM)."""
    so = inputs.simulation_options
    idx = torch.nonzero(halo_grid)
    masses = halo_grid[tuple(idx.T)].cpu().numpy()
    rng = np.random.default_rng(inputs.random_seed + 3)
    pos = (idx.cpu().numpy().astype(np.float64) + rng.uniform(size=(len(masses), 3))) * (
        so.box_len / so.dim)
    if so.dim % so.HII_DIM == 0:
        r = so.dim // so.HII_DIM
        count = in_halo.reshape(so.HII_DIM, r, so.HII_DIM, r, so.hii_d_para, r).sum(
            dim=(1, 3, 5), dtype=torch.int64)
        excl = (2 * count > r**3).cpu().numpy()
    else:
        excl = np.zeros(so.lowres_shape, bool)
    return masses, pos, excl


# ---------------------------------------------------------------------------
# The CHMF grid sampler


def grid_sampler_tables(redshift: float, inputs: InputParameters, lagrangian_delta,
                        exclude_mask=None):
    """The host part of `sample_halo_grid` (float64): the inverse-CMF table
    over N_COND_INTERP cell densities, each cell's clipped density, expected
    halo count (`n_exp`; 0 in excluded and collapsed cells) and collapsed
    mass, the collapsed cells (density above 0.99 of the barrier: one halo
    of the expected mass each, Stochasticity.c:686-694), `k_max`, and
    `n_expected` = sum(n_exp) + the collapsed cells."""
    so = inputs.simulation_options
    cosmo = inputs.cosmology
    sigma_table = _get_sigma_table(inputs)
    growth = float(cosmo.dicke(redshift))
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]

    cell_len = so.box_len / so.HII_DIM
    m_cell = cosmo.rho_mean * cell_len**3
    ln_mmin, ln_mcell = np.log(so.SAMPLER_MIN_MASS), np.log(m_cell)
    sigma_cell = float(sigma_table.sigma_of_lnm(ln_mcell))
    dcrit = float(hmf.get_delta_crit(hmf_int if hmf_int in (0, 1, 4) else 0, sigma_cell, growth))
    d_lo, d_hi = -1.0 + 1e-6, dcrit * hmf.MAX_DELTAC_FRAC
    deltas = np.linspace(d_lo, d_hi, so.N_COND_INTERP)
    args = (sigma_table, hmf_int, growth, ln_mmin, ln_mcell, sigma_cell, deltas)
    nhalo_tab = hmf.nhalo_conditional(*args) * m_cell
    mcoll_tab = hmf.mcoll_conditional(*args) * m_cell
    _, inv_tab = hmf.build_inverse_cmf_table(
        *args, n_prob=so.N_PROB_INTERP, min_logprob=so.MIN_LOGPROB)

    delta_raw = np.asarray(lagrangian_delta.cpu().numpy() if isinstance(lagrangian_delta, torch.Tensor)
                           else lagrangian_delta, np.float64).reshape(-1) * growth
    delta_z = np.clip(delta_raw, d_lo, d_hi)
    n_exp = np.interp(delta_z, deltas, nhalo_tab)
    m_tgt = np.interp(delta_z, deltas, mcoll_tab)
    excl = (np.zeros(delta_z.size, bool) if exclude_mask is None
            else np.asarray(exclude_mask, bool).reshape(-1))
    collapsed = (delta_raw >= d_hi) & ~excl
    n_exp = np.where(excl | collapsed, 0.0, n_exp)
    return dict(
        inv_tab=inv_tab, d_lo=d_lo, d_hi=d_hi, delta_z=delta_z, n_exp=n_exp, m_tgt=m_tgt,
        collapsed=collapsed, cell_len=cell_len,
        k_max=int(np.clip(3 * n_exp.max() + 8, 16, 4096)),
        n_expected=float(n_exp.sum()) + int(collapsed.sum()),
    )


def _inverse_cmf_gather(inv_table, ic0, fc, u, lnp_min):
    """ln M from the inverse-CMF table: bilinear in (condition, ln p) at
    float32 condition coordinates (ic0, fc) and uniforms `u`, with the JAX
    package's clip before the truncation to an index.  log(u) is taken in
    float64 and rounded once, so that the card and the CPU agree on it."""
    n_cond, n_prob = inv_table.shape
    lnp = torch.clamp(torch.log(u.double()).float(), lnp_min, 0.0)
    tp = grids.true_div(lnp - lnp_min, float(_f32(0.0) - _f32(lnp_min)))
    tp = torch.clamp(tp * (n_prob - 1), 0.0, n_prob - 1.001)
    del lnp
    ip0 = tp.to(torch.int64)
    fp = tp - ip0
    del tp
    flat = inv_table.reshape(-1)
    base = ic0[:, None] * n_prob + ip0
    del ip0
    t00, t01 = flat[base], flat[base + 1]
    t10, t11 = flat[base + n_prob], flat[base + n_prob + 1]
    del base
    return (t00 * (1 - fp) + t01 * fp) * (1 - fc) + (t10 * (1 - fp) + t11 * fp) * fc


def _sample_cells_core(delta, inv_table, d_lo, d_hi, lnp_min, m_min, u, n_draw):
    """The deterministic core of the grid sampler for a chunk of cells: the
    masses drawn in each cell (chunk, k_max) from the inverse CMF at the
    cell's float32 density `delta` and uniforms `u` in [1e-12, 1), and the
    keep mask: the first `n_draw` (the cell's Poisson count) above m_min."""
    n_cond = inv_table.shape[0]
    d_lo32, d_hi32 = _f32(d_lo), _f32(d_hi)
    tc = grids.true_div(delta - float(d_lo32), float(d_hi32 - d_lo32))
    tc = torch.clamp(tc * (n_cond - 1), 0.0, n_cond - 1.001)
    ic0 = tc.to(torch.int64)
    fc = (tc - ic0)[:, None]
    m = torch.exp(_inverse_cmf_gather(inv_table, ic0, fc, u, float(_f32(lnp_min))))
    k = torch.arange(u.shape[1], device=u.device)
    keep = (k[None, :] < n_draw[:, None]) & (m >= float(_f32(m_min)))
    return m, keep


def _cell_positions(cell_ids, jitter, lo_shape, cell_len):
    """Kept halos' positions (Mpc, float32): cell corner plus the uniform
    jitter of their slot, times the cell length."""
    nx, ny, nz = lo_shape
    base = torch.stack([cell_ids // (ny * nz), (cell_ids // nz) % ny, cell_ids % nz],
                       dim=-1).to(torch.float32)
    return (base + jitter) * float(_f32(cell_len))


def _grid_draws(n_exp, k_max, generator, dev):
    """The draws of a chunk of cells: uniforms in [1e-12, 1) (cells, k_max),
    a Poisson count a cell from its float32 `n_exp`, and the
    (cells, k_max, 3) position jitter."""
    u = _rand((n_exp.numel(), k_max), generator, dev, low=1e-12)
    n_draw = torch.poisson(n_exp.to(generator.device), generator=generator).to(dev)
    return u, n_draw, _rand((n_exp.numel(), k_max, 3), generator, dev)


def _grid_chunk(inputs, h, delta, inv_table, start, u, n_draw, jitter):
    """The halos of the chunk of cells from `start` given its draws: float32
    masses and positions (Mpc), compacted in row-major order."""
    so = inputs.simulation_options
    m, keep = _sample_cells_core(delta[start:start + u.shape[0]], inv_table, h["d_lo"], h["d_hi"],
                                 so.MIN_LOGPROB, so.SAMPLER_MIN_MASS, u, n_draw)
    rows, slots = keep.nonzero(as_tuple=True)
    return m[rows, slots], _cell_positions(rows + start, jitter[rows, slots], so.lowres_shape,
                                           h["cell_len"])


def _collapsed_halos(inputs, h, dev):
    """One halo of the expected mass in each collapsed cell, at a
    `default_rng(seed + 29)` position in it (float32 masses and Mpc)."""
    ids = np.nonzero(h["collapsed"])[0]
    nx, ny, nz = inputs.simulation_options.lowres_shape
    rng = np.random.default_rng(inputs.random_seed + 29)
    pos = (np.stack([ids // (ny * nz), (ids // nz) % ny, ids % nz], axis=-1).astype(np.float64)
           + rng.uniform(size=(len(ids), 3))) * h["cell_len"]
    return (torch.as_tensor(h["m_tgt"][ids].astype(_f32), device=dev),
            torch.as_tensor(pos.astype(_f32), device=dev))


def sample_halo_grid(redshift: float, inputs: InputParameters, lagrangian_delta,
                     exclude_mask=None, generator=None, *, device="cuda"):
    """Sample the conditional MF in every lowres cell between SAMPLER_MIN_MASS
    and the cell mass (reference sample_halo_grids, Stochasticity.c:761-941),
    number-limited; collapsed cells give one halo of their expected mass.

    The cells are taken in chunks whose (cells, k_max) draws stay near 2^22,
    each drawing from `generator` (`_grid_draws`).  The kept halos are
    compacted with `torch.nonzero` in row-major order, the collapsed cells'
    halos last.  The JAX package scatters them instead into a buffer of
    SAMPLER_BUFFER_FACTOR * sum(n_exp) + 1024 slots; the two catalogs are
    equal whenever that buffer does not overflow.  Returns float32 (masses,
    positions in Mpc)."""
    dev = resolve_device(device)
    if generator is None:
        generator = default_generator(inputs, redshift, dev)
    h = grid_sampler_tables(redshift, inputs, lagrangian_delta, exclude_mask)
    k_max = h["k_max"]
    inv_table = torch.as_tensor(h["inv_tab"].astype(_f32), device=dev)
    delta = torch.as_tensor(h["delta_z"].astype(_f32), device=dev)
    n_exp = torch.as_tensor(h["n_exp"].astype(_f32), device=generator.device)
    chunk = max(1, SAMPLER_CHUNK_ENTRIES // k_max)
    masses, pos = [], []
    for start in range(0, delta.numel(), chunk):
        draws = _grid_draws(n_exp[start:start + chunk], k_max, generator, dev)
        m, p = _grid_chunk(inputs, h, delta, inv_table, start, *draws)
        masses.append(m)
        pos.append(p)
        del draws, m, p
    m, p = _collapsed_halos(inputs, h, dev)
    return torch.cat(masses + [m]), torch.cat(pos + [p])


# ---------------------------------------------------------------------------
# Progenitors


def _fix_mass_keep(m, m_tgt, sel, u):
    """Reference fix_mass_sample (Stochasticity.c:341-411), vectorized, as the
    JAX package's: the sampled set is the shortest prefix of the (B, K)
    draws `m` whose cumulative mass crosses the target `m_tgt`; then with
    `sel` (a Bernoulli(1/2) a row) the crossing halo is dropped iff that
    lands closer to the target, and otherwise sampled halos are removed in
    the random order of the uniforms `u` until the total drops below the
    target, the last removal re-added iff that is closer.  Rows that never
    cross their target keep their draws.  Returns the keep mask."""
    K = m.shape[1]
    tgt = m_tgt[:, None]
    csum = torch.cumsum(m, dim=1)
    inside = csum <= tgt
    crossing = ((csum - m) < tgt) & ~inside  # at most one a row
    del csum
    sampled = inside | crossing
    del inside
    total = torch.where(sampled, m, 0.0).sum(dim=1)

    # branch A: drop the crossing halo iff dropping is closer to the target
    m_last = torch.where(crossing, m, 0.0).sum(dim=1)
    drop_last = (total - m_last - m_tgt).abs() < (total - m_tgt).abs()
    keep_a = sampled & ~(crossing & drop_last[:, None])
    del crossing, m_last, drop_last

    # branch B: remove sampled halos in the uniforms' order until <= target
    order = torch.argsort(torch.where(sampled, u, float("inf")), dim=1, stable=True)
    m_ord = torch.where(torch.gather(sampled, 1, order), torch.gather(m, 1, order), 0.0)
    after = total[:, None] - torch.cumsum(m_ord, dim=1)  # total after t removals
    # the first t with after <= target (0 where there is none)
    t_idx = torch.argmax((after <= tgt).to(torch.uint8), dim=1)[:, None]
    last_removed = torch.gather(m_ord, 1, t_idx)[:, 0]
    after_final = torch.gather(after, 1, t_idx)[:, 0]
    del m_ord, after
    readd = (after_final + last_removed - m_tgt).abs() < (after_final - m_tgt).abs()
    # each slot's place in the removal order (the inverse permutation)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(K, device=m.device).expand_as(order))
    del order
    keep_b = sampled & ((rank > t_idx) | ((rank == t_idx) & readd[:, None]))
    keep_b = torch.where((total > m_tgt)[:, None], keep_b, sampled)
    return torch.where(sel[:, None], keep_a, keep_b)


def _progenitor_draws(cond_t, m_tgt, inv_table, lnp_min, m_min, u, n_draw=None, sel=None,
                      u_fix=None):
    """The deterministic core of the progenitor sampler for a chunk of
    descendants: (B, K) masses from the inverse CMF at float32 condition
    coordinates `cond_t` and uniforms `u`, and the keep mask,
    NUMBER-LIMITED (the first `n_draw` Poisson counts) when `n_draw` is
    given, else MASS-LIMITED (`_fix_mass_keep` on `m_tgt` with the draws
    `sel` and `u_fix`); masses below m_min are never kept."""
    n_cond = inv_table.shape[0]
    ic0 = torch.clamp(cond_t.to(torch.int64), 0, n_cond - 2)
    fc = (cond_t - ic0)[:, None]
    m = torch.exp(_inverse_cmf_gather(inv_table, ic0, fc, u, float(_f32(lnp_min))))
    above = m >= float(_f32(m_min))
    if n_draw is not None:
        k = torch.arange(u.shape[1], device=u.device)
        return m, (k[None, :] < n_draw[:, None]) & above
    return m, _fix_mass_keep(m, m_tgt, sel, u_fix) & above


def _progenitor_rng(n_exp, k_max, number_limited, generator, dev):
    """The draws of a chunk of descendants: uniforms in [1e-12, 1) (B, K),
    then a Poisson count a row (NUMBER-LIMITED), or a Bernoulli(1/2) a row
    and (B, K) uniforms (MASS-LIMITED)."""
    rows = n_exp.numel()
    u = _rand((rows, k_max), generator, dev, low=1e-12)
    if number_limited:
        return dict(u=u, n_draw=torch.poisson(n_exp.to(generator.device), generator=generator).to(dev))
    sel = _rand((rows,), generator, dev) < 0.5
    return dict(u=u, sel=sel, u_fix=_rand((rows, k_max), generator, dev))


def _delta_crit(hmf_int, sigma, growth):
    """hmf.get_delta_crit on a tensor of sigmas."""
    if hmf_int == hmf.HMF_DELOS:
        return torch.full_like(sigma, physconst.delta_c_delos)
    if hmf_int == hmf.HMF_ST:
        return hmf.sheth_delc_fixed(physconst.delta_c_sph / growth, sigma) * growth
    return torch.full_like(sigma, physconst.delta_c_sph)


def progenitor_tables(redshift: float, inputs: InputParameters, prev_redshift: float,
                      max_mass):
    """The host part of the progenitor sampler (float64): over N_COND_INTERP
    descendant masses from SAMPLER_MIN_MASS to `max_mass` (the largest
    descendant, a float32) the inverse CMF, the expected collapsed mass
    (times HALOMASS_CORRECTION) and halo count, each descendant conditioned
    on its collapse barrier at the previous redshift rescaled to this one."""
    so = inputs.simulation_options
    cosmo = inputs.cosmology
    sigma_table = _get_sigma_table(inputs)
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    eff_hmf = hmf_int if hmf_int in (0, 1, 4) else 0
    growth = float(cosmo.dicke(redshift))
    growth_prev = float(cosmo.dicke(prev_redshift))
    m_min = so.SAMPLER_MIN_MASS
    # the JAX package's float32 maximum and its float32 log
    m_max = max(_f32(max_mass), _f32(m_min * 2))
    ln_mbins = np.linspace(np.log(m_min), np.log(m_max) + 1e-3, so.N_COND_INTERP)
    sig_bins = sigma_table.sigma_of_lnm(ln_mbins)
    delta_bins = hmf.get_delta_crit(eff_hmf, sig_bins, growth_prev) * growth / growth_prev
    args = (sigma_table, hmf_int, growth, np.log(m_min), ln_mbins, sig_bins, delta_bins)
    _, inv_tab = hmf.build_inverse_cmf_table(
        *args, n_prob=so.N_PROB_INTERP, min_logprob=so.MIN_LOGPROB)
    return dict(
        inv_tab=inv_tab, ln_mbins=ln_mbins, sig_bins=sig_bins, growth=growth, eff_hmf=eff_hmf,
        mcoll_bins=hmf.mcoll_conditional(*args) * np.exp(ln_mbins),
        nhalo_bins=hmf.nhalo_conditional(*args) * np.exp(ln_mbins),
    )


def _descendant_conditions(inputs, h, masses_d):
    """Per-descendant float64 conditions on the device: the condition
    coordinate, the target mass (HALOMASS_CORRECTION applied), the expected
    count, and the rare halos (MASS-LIMITED: a many-sigma condition refuses
    to split and keeps one progenitor of the target mass,
    Stochasticity.c:385-392), whose target and count are zeroed."""
    so = inputs.simulation_options
    dev = masses_d.device
    ln_mbins = torch.as_tensor(h["ln_mbins"], device=dev)

    def interp(table):
        return _interp(ln_md, ln_mbins, torch.as_tensor(table, device=dev))

    # the float32 log of the float32 masses, as the JAX package's host takes it
    ln_md = torch.log(torch.clamp(masses_d.double(), min=so.SAMPLER_MIN_MASS)).float().double()
    m_tgt = interp(h["mcoll_bins"]) * so.HALOMASS_CORRECTION
    n_exp = interp(h["nhalo_bins"])
    cond_t = interp(np.arange(len(h["ln_mbins"]), dtype=np.float64))
    if inputs.matter_options.SAMPLE_METHOD == "MASS-LIMITED":
        sig_d = interp(h["sig_bins"])
        rare = sig_d * 7.0 * h["growth"] < _delta_crit(h["eff_hmf"], sig_d, h["growth"])
        del sig_d
    else:
        rare = torch.zeros_like(ln_md, dtype=torch.bool)
    return cond_t, m_tgt, n_exp, rare


def _sample_progenitors(redshift, inputs, prev_cat: HaloCatalog, generator, dev) -> HaloCatalog:
    """Progenitors of each halo of `prev_cat` from its redshift up to
    `redshift` (reference sample_halo_progenitors, Stochasticity.c:943-1114),
    in chunks of PROGENITOR_CHUNK_ROWS descendants."""
    check_inputs(inputs)
    so = inputs.simulation_options
    masses_d = prev_cat.halo_masses.to(dev)
    n = masses_d.numel()
    h = progenitor_tables(redshift, inputs, float(prev_cat.redshift),
                          masses_d.max().item() if n else 0.0)
    inv_table = torch.as_tensor(h["inv_tab"].astype(_f32), device=dev)
    number_limited = inputs.matter_options.SAMPLE_METHOD == "NUMBER-LIMITED"
    desc, prog_m, rare_idx, rare_m = [], [], [], []
    for start in range(0, n, PROGENITOR_CHUNK_ROWS):
        cond_t, m_tgt, n_exp, rare = _descendant_conditions(
            inputs, h, masses_d[start:start + PROGENITOR_CHUNK_ROWS])
        if bool(rare.any()):
            ids = rare.nonzero()[:, 0]
            rare_idx.append(ids + start)
            rare_m.append(m_tgt[ids].float())
            m_tgt = torch.where(rare, 0.0, m_tgt)
            n_exp = torch.where(rare, 0.0, n_exp)
        draws = _progenitor_rng(n_exp.float(), PROGENITOR_K_MAX, number_limited, generator, dev)
        m, keep = _progenitor_draws(cond_t.float(), m_tgt.float(), inv_table, so.MIN_LOGPROB,
                                    so.SAMPLER_MIN_MASS, **draws)
        del draws, cond_t, m_tgt, n_exp, rare
        rows, slots = keep.nonzero(as_tuple=True)
        desc.append(rows + start)
        prog_m.append(m[rows, slots])
        del m, keep, rows, slots
    empty_i = torch.zeros(0, dtype=torch.int64, device=dev)
    empty_f = torch.zeros(0, dtype=torch.float32, device=dev)
    desc_idx = torch.cat(desc + rare_idx) if desc else empty_i
    new_masses = torch.cat(prog_m + rare_m) if prog_m else empty_f
    n_new = new_masses.numel()
    corr = (so.CORR_STAR, so.CORR_SFR, so.CORR_LX)
    old = (prev_cat.star_rng, prev_cat.sfr_rng, prev_cat.xray_rng)
    fresh = _normals(n_new, generator, dev)
    # c * old in float32, the rest in float64, as numpy evaluates the JAX
    # package's host expression
    mixed = [((c * o.to(dev)[desc_idx]).double() + float(np.sqrt(1 - c * c)) * f.double()).float()
             for c, o, f in zip(corr, old, fresh)]
    return HaloCatalog(
        redshift=np.float32(redshift),
        halo_masses=new_masses,
        halo_coords=prev_cat.halo_coords.to(dev)[desc_idx],
        star_rng=mixed[0],
        sfr_rng=mixed[1],
        xray_rng=mixed[2],
        n_halos=n_new,
    )


# ---------------------------------------------------------------------------
# Catalog assembly


def determine_halo_catalog(
    redshift: float,
    inputs: InputParameters,
    ics: InitialConditions,
    previous_catalog: HaloCatalog | None = None,
    generator: torch.Generator | None = None,
    *,
    device="cuda",
) -> HaloCatalog:
    """The halo catalog at `redshift` (reference determine_halo_catalog,
    single_field.py:161): the first (lowest-z) snapshot is DexM above the
    lowres cell mass plus the grid sampler below it; every later one holds
    the progenitors of `previous_catalog`.  The draws come from `generator`
    (`default_generator` on `device` when None)."""
    dev = resolve_device(device)
    so = inputs.simulation_options
    if generator is None:
        generator = default_generator(inputs, redshift, dev)
    if previous_catalog is not None:
        return _sample_progenitors(redshift, inputs, previous_catalog, generator, dev)

    halo_grid, in_halo = dexm_halo_grid(redshift, inputs, ics, generator=generator, device=dev)
    dexm_masses, dexm_pos, excl = _dexm_catalog(inputs, halo_grid, in_halo)
    del halo_grid, in_halo
    masses, pos = sample_halo_grid(redshift, inputs, ics.lowres_density, exclude_mask=excl,
                                   generator=generator, device=dev)
    all_masses = torch.cat([torch.as_tensor(dexm_masses.astype(_f32), device=dev), masses])
    all_pos = torch.cat([torch.as_tensor(dexm_pos.astype(_f32), device=dev), pos])
    n = all_masses.numel()
    star, sfr, xray = _normals(n, generator, dev)
    return HaloCatalog(
        redshift=np.float32(redshift),
        halo_masses=all_masses,
        halo_coords=all_pos,
        star_rng=star,
        sfr_rng=sfr,
        xray_rng=xray,
        n_halos=n,
    )


def perturb_halo_catalog(
    redshift: float,
    inputs: InputParameters,
    ics: InitialConditions,
    catalog: HaloCatalog,
    *,
    device="cuda",
) -> PerturbedHaloCatalog:
    """Move halos from Lagrangian to Eulerian positions with the IC
    displacement fields read at each halo (reference
    PerturbedHaloCatalog.c:25-149): the ZA fields, minus the 2LPT ones under
    PERTURB_ALGORITHM '2LPT', on the perturb grid (hires with
    PERTURB_ON_HIGH_RES), wrapped into the box."""
    dev = resolve_device(device)
    so = inputs.simulation_options
    mo = inputs.matter_options
    _, _, fac_za, fac_2lpt = _displacement_factors(inputs, redshift)
    pt_shape = so.hires_shape if mo.PERTURB_ON_HIGH_RES else so.lowres_shape
    cell = so.box_len / pt_shape[0]
    pos = catalog.halo_coords.to(dev)
    px = grids.true_div(pos[:, 0], cell)
    py = grids.true_div(pos[:, 1], cell)
    pz = grids.true_div(pos[:, 2], cell) * (pt_shape[2] / pt_shape[0] * pt_shape[0] / pt_shape[2])

    def read(fields):
        return torch.stack([cic.cic_read(v.to(dev), px, py, pz) for v in fields], dim=-1)

    disp = read((ics.vx, ics.vy, ics.vz)) * float(_f32(fac_za))
    if mo.PERTURB_ALGORITHM == "2LPT" and ics.vx_2LPT is not None:
        disp = disp - read((ics.vx_2LPT, ics.vy_2LPT, ics.vz_2LPT)) * float(_f32(fac_2lpt))
    box = torch.as_tensor(np.asarray(so.box_lens, _f32), device=dev)
    moved = pos + disp
    # jnp.remainder: the truncated remainder, moved into [0, box)
    rem = torch.fmod(moved, box)
    new_pos = torch.where((rem != 0) & (rem < 0), rem + box, rem)
    return PerturbedHaloCatalog(
        redshift=np.float32(redshift),
        halo_masses=catalog.halo_masses.to(dev),
        halo_coords=new_pos,
        star_rng=catalog.star_rng.to(dev),
        sfr_rng=catalog.sfr_rng.to(dev),
        xray_rng=catalog.xray_rng.to(dev),
        n_halos=catalog.n_halos,
    )
