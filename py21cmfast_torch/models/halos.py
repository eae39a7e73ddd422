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
   overshoot correction) or NUMBER-LIMITED, or splits it by the partition
   sampler (Sheth & Lemson 1999) or the binary split (Parkinson+08, walked
   as a list of branches); positions and the property draws are inherited,
   the latter AR(1)-mixed with fresh normals.

Every random step is split in two: a draw, from a `torch.Generator` on its
own device, and a deterministic core that takes the draws as tensors; the
draws are moved to the run's device; the partition and binary-split steps
draw as they go, a callable of the step handing the core its draws.  The
host parts (numpy float64) are
the condition tables, the DexM radii and barriers, and the numpy draws of
the reference (`default_rng(seed + 3)` for the DexM jitter,
`default_rng(seed + 29)` for the collapsed cells).  Catalogs are stored
compacted, in the order of `torch.nonzero` (row-major, as `np.nonzero`).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..cosmology.constants import physconst
from ..inputs import InputParameters
from ..ops import cic, fft, filters, grids, special
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
# the progenitor sampler's chunks: at most PROGENITOR_CHUNK_ROWS descendants
# and at most PROGENITOR_CHUNK_BYTES of a method's working set, about
# PROGENITOR_ROW_BYTES a descendant: MASS/NUMBER-LIMITED (B, 64) float32
# draws and masses, some sixteen such arrays alive in `_fix_mass_keep`; the
# partition its (B, 64) masses and emit mask and a step's ~45 float32
# temporaries a row; the binary split ~1.1 branches a descendant, each with
# its trapezoid and ~40 temporaries a step, and its emitted progenitors
PROGENITOR_CHUNK_ROWS = 2**23
PROGENITOR_CHUNK_BYTES = 2**32
PROGENITOR_ROW_BYTES = {"MASS-LIMITED": 4096, "NUMBER-LIMITED": 4096, "PARTITION": 512,
                        "BINARY-SPLIT": 512}
# the binary split's scan steps, lattice slots a descendant and progenitors
# a descendant (the JAX package's t_max, capacity and cap_out)
BINARY_SPLIT_T_MAX, BINARY_SPLIT_CAPACITY, BINARY_SPLIT_CAP_OUT = 48, 64, 256

_f32 = np.float32


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
                        exclude_mask=None, grid_shape=None, origin_cells=(0, 0, 0)):
    """The host part of `sample_halo_grid` (float64): the inverse-CMF table
    over N_COND_INTERP cell densities, each cell's clipped density, expected
    halo count (`n_exp`; 0 in excluded and collapsed cells) and collapsed
    mass, the collapsed cells (density above 0.99 of the barrier: one halo
    of the expected mass each, Stochasticity.c:686-694), `k_max`, and
    `n_expected` = sum(n_exp) + the collapsed cells.  `grid_shape` and
    `origin_cells` name a slab of the lowres grid (parallel/sampler.py):
    `lagrangian_delta` is then that slab, whose first cell is at
    `origin_cells`."""
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
        grid_shape=tuple(so.lowres_shape if grid_shape is None else grid_shape),
        origin=tuple(int(o) for o in origin_cells),
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


def _cell_positions(cell_ids, jitter, lo_shape, cell_len, origin=(0, 0, 0)):
    """Kept halos' positions (Mpc, float32): cell corner plus the uniform
    jitter of their slot, times the cell length, plus the slab's origin
    (`origin` cells, in float32 as the JAX package adds it)."""
    nx, ny, nz = lo_shape
    base = torch.stack([cell_ids // (ny * nz), (cell_ids // nz) % ny, cell_ids % nz],
                       dim=-1).to(torch.float32)
    pos = (base + jitter) * float(_f32(cell_len))
    if any(origin):
        pos = pos + torch.as_tensor(np.asarray(origin, _f32) * _f32(cell_len), device=pos.device)
    return pos


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
    return m[rows, slots], _cell_positions(rows + start, jitter[rows, slots], h["grid_shape"],
                                           h["cell_len"], h["origin"])


def _collapsed_halos(inputs, h, dev):
    """One halo of the expected mass in each collapsed cell, at a
    `default_rng(seed + 29)` position in it (float32 masses and Mpc)."""
    ids = np.nonzero(h["collapsed"])[0]
    nx, ny, nz = h["grid_shape"]
    rng = np.random.default_rng(inputs.random_seed + 29)
    pos = (np.stack([ids // (ny * nz), (ids // nz) % ny, ids % nz], axis=-1).astype(np.float64)
           + np.asarray(h["origin"], np.float64)
           + rng.uniform(size=(len(ids), 3))) * h["cell_len"]
    return (torch.as_tensor(h["m_tgt"][ids].astype(_f32), device=dev),
            torch.as_tensor(pos.astype(_f32), device=dev))


def sample_halo_grid(redshift: float, inputs: InputParameters, lagrangian_delta,
                     exclude_mask=None, generator=None, grid_shape=None, origin_cells=(0, 0, 0),
                     *, device="cuda"):
    """Sample the conditional MF in every lowres cell between SAMPLER_MIN_MASS
    and the cell mass (reference sample_halo_grids, Stochasticity.c:761-941),
    number-limited; collapsed cells give one halo of their expected mass.

    The cells are taken in chunks whose (cells, k_max) draws stay near 2^22,
    each drawing from `generator` (`_grid_draws`).  The kept halos are
    compacted with `torch.nonzero` in row-major order, the collapsed cells'
    halos last.  The JAX package scatters them instead into a buffer of
    SAMPLER_BUFFER_FACTOR * sum(n_exp) + 1024 slots; the two catalogs are
    equal whenever that buffer does not overflow.  `grid_shape` and
    `origin_cells` sample a slab of the grid (parallel/sampler.py):
    `lagrangian_delta` is then that slab, and the positions are global.
    Returns float32 (masses, positions in Mpc)."""
    dev = resolve_device(device)
    if generator is None:
        generator = default_generator(inputs, redshift, dev)
    h = grid_sampler_tables(redshift, inputs, lagrangian_delta, exclude_mask, grid_shape,
                            origin_cells)
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
                      max_mass, inverse=True):
    """The host part of the progenitor sampler (float64): over N_COND_INTERP
    descendant masses from SAMPLER_MIN_MASS to `max_mass` (the largest
    descendant, a float32) the inverse CMF, the expected collapsed mass
    (times HALOMASS_CORRECTION) and halo count, each descendant conditioned
    on its collapse barrier at the previous redshift rescaled to this one.
    The inverse CMF (`inv_tab`, None unless `inverse`) serves the MASS- and
    NUMBER-LIMITED samplers only."""
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
    inv_tab = hmf.build_inverse_cmf_table(
        *args, n_prob=so.N_PROB_INTERP, min_logprob=so.MIN_LOGPROB)[1] if inverse else None
    return dict(
        inv_tab=inv_tab, ln_mbins=ln_mbins, sig_bins=sig_bins, delta_bins=delta_bins,
        growth=growth, growth_prev=growth_prev, eff_hmf=eff_hmf, hmf_int=hmf_int,
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


# ---------------------------------------------------------------------------
# The partition (Sheth & Lemson 1999) and binary-split (Parkinson+08) samplers


def _lerp(x, x0, inv_dx, table):
    """grids.uniform_lerp, NaN where `x` is NaN without indexing with it:
    the JAX package computes such junk on lanes it then masks (a branch at
    exactly twice the resolution mass), where XLA's gather clamps the
    index."""
    nan = torch.isnan(x)
    return torch.where(nan, float("nan"), grids.uniform_lerp(torch.where(nan, x0, x), x0, inv_dx, table))


def _gaussian_tail(nu_min, u, u1, u2):
    """A standard normal conditioned on X > nu_min (gsl_ran_ugaussian_tail),
    from the draws: the inverse CDF at the uniform `u` in [1e-7, 1) where
    nu_min <= 2, else Devroye's tail method X = sqrt(nu_min^2 - 2 ln U1),
    accepted where U2 < nu_min / X, over 4 tries (4, B) of `u1` in
    [1e-12, 1) and `u2`: the first accepted try, nu_min + 0.1 when none is.
    erfc and erfinv are XLA's float32 approximations (ops/special.py)."""
    sqrt2 = grids.device_scalar(np.sqrt(_f32(2.0)), torch.float32, nu_min.device)
    q = 0.5 * special.erfc32(nu_min / sqrt2)
    x_inv = sqrt2 * special.erfinv32(torch.clamp(1.0 - 2.0 * q * u, -0.999999, 0.999999))
    x_try = torch.sqrt(nu_min * nu_min - 2.0 * special.log32(u1))
    acc = u2 < nu_min / torch.clamp_min(x_try, 1e-10)
    # the first accepted try (argmax returns the first maximum)
    first = torch.argmax(acc.to(torch.uint8), dim=0, keepdim=True)
    x_dev = torch.gather(x_try, 0, first)[0]
    x_dev = torch.where(acc.any(dim=0), x_dev, nu_min + 0.1)
    return torch.where(nu_min > 2.0, x_dev, torch.maximum(x_inv, nu_min))


def _st_taylor_dev(sig, sig_cond, growth):
    """The moving ST barrier's 5-term Taylor expansion (hmf.c:234-267), in
    float32 at the float32 `growth`."""
    a, alpha, beta = hmf.JENKINS_a, hmf.JENKINS_c, hmf.JENKINS_b
    del_ = _f32(physconst.delta_c_sph) / growth
    sigsq = sig * sig
    sigsq_inv = torch.reciprocal(sigsq)
    sigdiff = torch.where((sig - sig_cond).abs() < 1e-9, 1e-6, sigsq - sig_cond * sig_cond)
    t = torch.ones_like(sig)
    result = torch.ones_like(sig)
    for i in range(1, 6):
        t = grids.true_div(t * -sigdiff, float(i)) * float(alpha - i + 1) * sigsq_inv
        result = result + t
    pre1 = float(np.sqrt(_f32(a)) * del_)
    pre2 = beta * special.pow32(sigsq_inv * float(_f32(a) * del_ * del_), -alpha)
    return pre1 * (1.0 + pre2 * result)


def _axis(a):
    """The first point and the float32 inverse spacing of a uniform float32
    axis, as the JAX package's kernels form them."""
    a = np.asarray(a, _f32)
    return float(a[0]), float(_f32(a.size - 1) / (a[-1] - a[0]))


def partition_tables(sigma_table, m_lo, m_hi, n=512):
    """Float32 host tables of the partition sampler: sigma on a uniform ln M
    axis from `m_lo` to `m_hi`, and ln M on a uniform sigma axis."""
    ln_axis = np.linspace(np.log(m_lo), np.log(m_hi), n)
    sig_vals = sigma_table.sigma_of_lnm(ln_axis)  # decreasing in ln M
    sig_axis = np.linspace(sig_vals[-1], sig_vals[0], n)
    lnm_of_sig = np.interp(sig_axis, sig_vals[::-1], ln_axis[::-1])
    return tuple(a.astype(_f32) for a in (ln_axis, sig_vals, sig_axis, lnm_of_sig))


def _partition_rng(n, use_st, generator, dev):
    """The draws of the partition sampler for a chunk of `n` descendants: a
    callable of (step, rows) giving the step's draws for those rows."""
    def draw(t, rows):
        k = rows.numel()
        out = dict(u=_rand((k,), generator, dev, low=1e-7),
                   u1=_rand((4, k), generator, dev, low=1e-12), u2=_rand((4, k), generator, dev))
        if use_st:
            out["u_acc"] = _rand((k,), generator, dev)
        return out
    return draw


def _partition_kernel(delta_cond, ln_m_cond, active0, tables, sigma_min, m_min, growth,
                      corr_fudge, draw, *, t_max, use_st):
    """Sheth & Lemson 1999 partition sampling (stoc_partition_sample,
    Stochasticity.c:437-486): each condition's remaining mass is split by a
    nu drawn from the truncated Gaussian (with the ST moving-barrier
    rejection under HMF 'ST') until it falls below `m_min`; one step a
    progenitor draw across the conditions, t_max steps.  `tables` are
    `partition_tables`; the float32 scalars are host floats; `draw(t, rows)`
    gives the draws of step t for the still active rows (only those are
    drawn and updated: a row that stops emits nothing more).  Returns the
    (B, t_max) masses and emit mask."""
    dev = delta_cond.device
    sig_vals, lnm_of_sig = (torch.as_tensor(tables[i], device=dev) for i in (1, 3))
    lnm0, inv_dlnm = _axis(tables[0])
    sig0, inv_dsig = _axis(tables[2])
    sig_lo, sig_hi = float(tables[2][0]), float(tables[2][-1])
    sigma_min_sq = float(_f32(sigma_min) * _f32(sigma_min))
    B = delta_cond.numel()
    m_cond = special.exp32(ln_m_cond)
    m_rem = m_cond.clone()
    active = active0.clone()
    masses = torch.zeros((B, t_max), dtype=torch.float32, device=dev)
    emitted = torch.zeros((B, t_max), dtype=torch.bool, device=dev)
    for t in range(t_max):
        rows = active.nonzero()[:, 0]
        if rows.numel() == 0:
            break
        d = draw(t, rows)
        mr = m_rem[rows]
        sig_r = _lerp(special.log32(torch.clamp_min(mr, 1.0)), lnm0, inv_dlnm, sig_vals)
        if use_st:
            a = hmf.JENKINS_a
            dc = _f32(physconst.delta_c_sph) / _f32(growth)
            coef = float(_f32(a) * dc * dc)
            dcrit_r = (float(np.sqrt(_f32(a)) * dc) * (1.0 + hmf.JENKINS_b * special.pow32(
                grids.true_div(sig_r * sig_r, coef), hmf.JENKINS_c))) * float(_f32(growth))
        else:
            dcrit_r = torch.full_like(sig_r, physconst.delta_c_sph)
        delta_cur = (dcrit_r - delta_cond[rows]) / (mr / m_cond[rows])
        del_c = grids.true_div(delta_cur, float(_f32(growth)))
        del_term = del_c * del_c
        sigdiff_min = torch.clamp_min(sigma_min_sq - sig_r * sig_r, 1e-12)
        nu_min = torch.sqrt(del_term / sigdiff_min)
        nu = _gaussian_tail(nu_min, d["u"], d["u1"], d["u2"]) * float(_f32(corr_fudge))
        nu_c = torch.clamp_min(nu, 1e-10)
        sig_samp = torch.sqrt(del_term / (nu_c * nu_c) + sig_r * sig_r)
        if use_st:
            t1 = _st_taylor_dev(sig_samp, sig_r, _f32(growth)) - del_c
            t2 = _st_taylor_dev(torch.full_like(sig_r, float(_f32(sigma_min))), sig_r,
                                _f32(growth)) - del_c
            accept = d["u_acc"] <= t2 / torch.clamp_min(t1, 1e-30)
        else:
            accept = torch.ones_like(mr, dtype=torch.bool)
        sig_c = torch.clamp(sig_samp, sig_lo, sig_hi)
        m_samp = torch.minimum(
            special.exp32(_lerp(sig_c, sig0, inv_dsig, lnm_of_sig)), mr)
        m_new = torch.where(accept, mr - m_samp, mr)
        masses[rows, t] = torch.where(accept, m_samp, 0.0)
        emitted[rows, t] = accept
        m_rem[rows] = m_new
        active[rows] = m_new > float(_f32(m_min))
    return masses, emitted


def _binary_split_rng(n, generator, dev):
    """The draws of the binary-split sampler for a chunk of `n` descendants:
    a callable of (step, rows, slots) giving the uniforms u1, u2, u3 of the
    step's branches, each at (its descendant, its lattice slot)."""
    def draw(t, rows, slots):
        return tuple(_rand((rows.numel(),), generator, dev) for _ in range(3))
    return draw


# the binary split's float32 temporaries a branch in one step, in bytes: the
# 17-point trapezoid of `frac_below_res` (four arrays of it) and some forty
# per-branch arrays; a step's branches are computed in batches of at most
# BINARY_SPLIT_STEP_BYTES of them
BINARY_SPLIT_BRANCH_BYTES = 17 * 4 * 4 + 40 * 4
BINARY_SPLIT_STEP_BYTES = 2**31


def _segment_cumsum(x, first):
    """Inclusive cumulative sums of the int64 `x` within runs of equal keys,
    `first` the index of each entry's run start."""
    cs = torch.cumsum(x, dim=0)
    return cs - (cs[first] - x[first])


def _binary_split_kernel(m_cond, d_start0, d_target, tables, m_res, g0, gamma1, gamma2, draw,
                         *, t_max, capacity, cap_out):
    """Parkinson+08 binary-split merger trees (stoc_split_sample,
    Stochasticity.c:488-660), breadth-parallel as in the JAX package: every
    branch of every condition advances one barrier step a scan step;
    finished branches emit both progenitors into (B, cap_out) rows (in slot
    order, the larger progenitors first; one past cap_out falls into a
    spill slot and is lost, as in JAX); a continuing split keeps the larger
    progenitor in its slot and the smaller one claims the lowest free slot
    of the row's `capacity`.  The spawned branch starts at its sibling
    slot's advanced barrier plus the step again (the sibling's slot is
    zeroed first when the larger progenitor fell below resolution), as the
    JAX package has it.  `tables` = (ln M axis, sigma, dsigma^2/dM) on a
    uniform axis; the scalars are float32 host floats; `draw(t, rows, slots)`
    gives the uniforms u1, u2, u3 of the step's branches.

    The JAX package walks the whole (B, capacity) lattice every step and
    scatters into (B, cap_out) rows; here the occupied slots are kept as a
    list of branches (descendant, slot, mass, barrier) ordered by descendant
    and slot, about one a descendant, and the emitted progenitors as a list
    of (descendant, place in its row, mass): the empty slots emit nothing
    and stay empty there, so the progenitors are the lattice's, in its
    order.  Branches still active after t_max steps are force-saved.
    Returns the progenitors' descendants, places and masses, ordered by
    descendant and place, every descendant's count (past cap_out where its
    row spilled) and the number of force-saved branches."""
    dev = m_cond.device
    B, C = m_cond.numel(), capacity
    sigma_tab, dsigsq_tab = (torch.as_tensor(tables[i], device=dev) for i in (1, 2))
    lnm0, inv_dlnm = _axis(tables[0])

    def sigma_of(x):
        return _lerp(x, lnm0, inv_dlnm, sigma_tab)

    def dsigsq_of(x):
        return _lerp(x, lnm0, inv_dlnm, dsigsq_tab)

    m_res_t = torch.tensor(m_res, dtype=torch.float32, device=dev)
    sigma_res = sigma_of(special.log32(m_res_t))
    sigsq_res = sigma_res * sigma_res
    eps1_sqrt2 = float(_f32(0.1) * np.sqrt(_f32(2.0)))
    sqrt_2_pi = float(np.sqrt(_f32(2.0 / np.pi)))
    half_g1 = float(_f32(gamma1) / _f32(2.0))
    lin17 = torch.linspace(0.0, 1.0, 17, dtype=torch.float32, device=dev)
    out_ct = torch.zeros(B, dtype=torch.int64, device=dev)
    emitted = []

    def emit_rows(row, first, emit, m_emit):
        """Record the emitted masses at their places after their rows'
        counts, in slot order; a place past cap_out is lost (the JAX
        package's spill slot)."""
        e = emit.to(torch.int64)
        place = out_ct[row] + _segment_cumsum(e, first) - 1
        kept = emit & (place < cap_out)
        emitted.append((row[kept], place[kept], m_emit[kept]))
        out_ct.index_add_(0, row, e)

    def frac_below_res(sigma_s, sigsq_s, G1, dd):
        """ComputeFraction_split: the mass lost below resolution over dd,
        the Parkinson+08 J(u) by a 16-interval trapezoid."""
        u_res = sigma_s / torch.sqrt(torch.clamp_min(sigsq_res - sigsq_s, 1e-12))
        uu = lin17 * u_res[:, None]
        uc = torch.clamp_min(uu, 1e-8)
        integ = special.pow32(1.0 + torch.reciprocal(uc * uc), half_g1)
        integ = torch.where(uu > 0, integ, 0.0)
        j_val = 0.5 * ((uu[:, 1:] - uu[:, :-1]) * (integ[:, 1:] + integ[:, :-1])).sum(
            dim=1, dtype=torch.float64).float()
        return sqrt_2_pi * j_val * G1 / sigma_s * dd

    def advance(m, d, dd_target, u1, u2, u3):
        """One barrier step of a batch of branches: their larger and smaller
        progenitors (0 below resolution), whether they finish, and the step."""
        lnm = special.log32(torch.clamp_min(m, 1.0))
        m_half = 0.5 * m
        lnm_half = lnm - float(_f32(np.log(2.0)))
        sigma_s = sigma_of(lnm)
        sigsq_s = sigma_s * sigma_s
        sigma_h = sigma_of(lnm_half)
        sigsq_h = sigma_h * sigma_h
        G1 = g0 * special.pow32(d / torch.clamp_min(sigma_s, 1e-10), gamma2)
        q_res = m_res_t / torch.clamp_min(m, 1.0)
        # the no-split branch (q_res >= 0.5): the timestep limit only
        dd_nosplit = eps1_sqrt2 * torch.sqrt(torch.clamp_min(sigsq_h - sigsq_s, 1e-12))
        # the split branch
        alpha_h = -m_half / (2.0 * sigsq_h) * dsigsq_of(lnm_half)  # -dln sigma/dln m at m/2
        v_res = sigsq_res * special.pow32(torch.clamp_min(sigsq_res - sigsq_s, 1e-12), -1.5)
        v_half = sigsq_h * special.pow32(torch.clamp_min(sigsq_h - sigsq_s, 1e-12), -1.5)
        log_2q = special.log32(torch.clamp_min(2.0 * q_res, 1e-10))
        beta = special.log32(v_res / v_half) / log_2q
        b_coef = special.pow32(2.0, beta) * v_half
        mu = -special.log32(sigma_res / sigma_h) / log_2q if gamma1 < 0 else alpha_h
        eta = beta - 1.0 - gamma1 * mu
        pow_diff = special.pow32(0.5, eta) - special.pow32(q_res, eta)
        G2 = G1 * special.pow32(sigma_h / sigma_s, gamma1) * special.pow32(0.5, mu * gamma1)
        eta_safe = torch.where(eta.abs() > 1e-10, eta, 1e-10)
        dn_dd = sqrt_2_pi * b_coef * pow_diff / eta_safe * alpha_h * G2
        dd_split = torch.minimum(dd_nosplit, torch.full_like(dn_dd, 0.1) / torch.clamp_min(dn_dd, 1e-10))
        can_split = q_res < 0.5
        dd = torch.where(can_split, dd_split, dd_nosplit)
        save = dd >= dd_target
        dd = torch.minimum(dd, dd_target)
        # the split draw (the reference draws it before it tests `save`)
        n_upper = dn_dd * dd
        q = special.pow32(special.pow32(q_res, eta) + pow_diff * u2, torch.reciprocal(eta_safe))
        m_q = q * m
        lnm_q = special.log32(torch.clamp_min(m_q, 1.0))
        sigma_q = sigma_of(lnm_q)
        alpha_q = -m_q / (2.0 * sigma_q * sigma_q) * dsigsq_of(lnm_q)
        sigsq_q = sigma_q * sigma_q
        r_q = (alpha_q / torch.clamp_min(alpha_h, 1e-10)) * (
            sigsq_q * special.pow32(torch.clamp_min(sigsq_q - sigsq_s, 1e-12), -1.5)
            / (b_coef * special.pow32(torch.clamp_min(q, 1e-10), beta)))
        q = torch.where(can_split & (u1 < n_upper) & (u3 <= r_q), q, 0.0)
        m1 = (1.0 - frac_below_res(sigma_s, sigsq_s, G1, dd) - q) * m
        m2 = q * m
        return (torch.where(m1 > m_res_t, m1, 0.0), torch.where(m2 > m_res_t, m2, 0.0), save, dd)

    # the branches, ordered by (descendant, slot); every one is occupied
    row = (m_cond > 0).nonzero()[:, 0]
    slot = torch.zeros_like(row)
    m, d = m_cond[row], d_start0[row]
    per = max(1, BINARY_SPLIT_STEP_BYTES // BINARY_SPLIT_BRANCH_BYTES)
    for t in range(t_max):
        if row.numel() == 0:
            break
        u1, u2, u3 = draw(t, row, slot)
        dd_target = d_target[row] - d
        parts = [advance(*xs) for xs in zip(*(x.split(per) for x in (m, d, dd_target, u1, u2, u3)))]
        m1, m2, save, dd = (torch.cat(p) for p in zip(*parts))
        del parts, u1, u2, u3, dd_target
        first = torch.searchsorted(row, row)
        # finished branches emit both progenitors: the larger ones, then the smaller
        emit_rows(row, first, save & (m1 > 0), m1)
        emit_rows(row, first, save & (m2 > 0), m2)
        # unfinished ones: the slot keeps the larger progenitor ...
        keep1 = ~save & (m1 > 0)
        d_kept = torch.where(keep1, d + dd, 0.0)
        # ... and the smaller one claims its row's spawn_rank-th free slot
        spawn = ~save & (m2 > 0)
        spawn_rank = _segment_cumsum(spawn.to(torch.int64), first) - 1
        n_kept = torch.zeros(B, dtype=torch.int64, device=dev).index_add_(0, row, keep1.to(torch.int64))
        ok = spawn & (spawn_rank < C - n_kept[row])
        s_row, s_rank = row[ok], spawn_rank[ok]
        if s_row.numel():
            # the free slots of the spawning rows, in slot order (a stable
            # sort of their occupancy by the kept branches)
            rows_u = torch.unique(s_row)
            local = torch.searchsorted(rows_u, row)
            in_u = (local < rows_u.numel()) & (rows_u[local.clamp(max=rows_u.numel() - 1)] == row)
            occ = torch.zeros((rows_u.numel(), C), dtype=torch.uint8, device=dev)
            occ[local[keep1 & in_u], slot[keep1 & in_u]] = 1
            free_order = torch.argsort(occ, dim=1, stable=True)
            s_slot = free_order[torch.searchsorted(rows_u, s_row), s_rank]
        else:
            s_slot = s_row
        new_row = torch.cat([row[keep1], s_row])
        new_slot = torch.cat([slot[keep1], s_slot])
        order = torch.argsort(new_row * C + new_slot)
        m = torch.cat([m1[keep1], m2[ok]])[order]
        d = torch.cat([d_kept[keep1], (d_kept + dd)[ok]])[order]
        row, slot = new_row[order], new_slot[order]
        del m1, m2, save, dd, keep1, spawn, spawn_rank, ok, first, d_kept

    # force-save the branches still active after t_max steps
    emit = m > m_res_t
    if row.numel():
        emit_rows(row, torch.searchsorted(row, row), emit, m)
    rows, places, masses = (torch.cat(x) for x in zip(*emitted)) if emitted else (
        row, slot, m)
    order = torch.argsort(rows * cap_out + places)
    return rows[order], places[order], masses[order], out_ct, int(emit.sum())


def _sample_progenitors(redshift, inputs, prev_cat: HaloCatalog, generator, dev) -> HaloCatalog:
    """Progenitors of each halo of `prev_cat` from its redshift up to
    `redshift` (reference sample_halo_progenitors, Stochasticity.c:943-1114),
    in chunks of at most PROGENITOR_CHUNK_ROWS descendants and
    PROGENITOR_CHUNK_BYTES of the method's working set, by SAMPLE_METHOD: the
    inverse CMF kept MASS- or NUMBER-LIMITED, the partition sampler (HMF
    'PS' or 'ST' only) or the binary split."""
    so = inputs.simulation_options
    method = inputs.matter_options.SAMPLE_METHOD
    hmf_int = hmf.HMF_NAMES[inputs.matter_options.HMF]
    if method == "PARTITION" and hmf_int not in (hmf.HMF_PS, hmf.HMF_ST):
        raise ValueError("PARTITION sampling requires HMF='PS' or 'ST'")
    masses_d = prev_cat.halo_masses.to(dev)
    n = masses_d.numel()
    inverse = method in ("MASS-LIMITED", "NUMBER-LIMITED")
    h = progenitor_tables(redshift, inputs, float(prev_cat.redshift),
                          masses_d.max().item() if n else 0.0, inverse=inverse)
    sample = (_inverse_cmf_chunk if inverse else _partition_chunk if method == "PARTITION"
              else _binary_split_chunk)
    chunk = max(1, min(PROGENITOR_CHUNK_ROWS, PROGENITOR_CHUNK_BYTES // PROGENITOR_ROW_BYTES[method]))
    desc, prog_m, rare_idx, rare_m = [], [], [], []
    for start in range(0, n, chunk):
        rows_d = masses_d[start:start + chunk]
        cond_t, m_tgt, n_exp, rare = _descendant_conditions(inputs, h, rows_d)
        if bool(rare.any()):
            ids = rare.nonzero()[:, 0]
            rare_idx.append(ids + start)
            rare_m.append(m_tgt[ids].float())
            m_tgt = torch.where(rare, 0.0, m_tgt)
            n_exp = torch.where(rare, 0.0, n_exp)
        rows, m = sample(inputs, h, rows_d, cond_t, m_tgt, n_exp, generator, dev)
        del cond_t, m_tgt, n_exp, rare
        desc.append(rows + start)
        prog_m.append(m)
        del rows, m
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


def _compacted(m, keep):
    """The kept entries of (B, K) masses: their rows and masses, row-major."""
    rows, slots = keep.nonzero(as_tuple=True)
    return rows, m[rows, slots]


def _inverse_cmf_chunk(inputs, h, masses_d, cond_t, m_tgt, n_exp, generator, dev):
    """MASS- or NUMBER-LIMITED progenitors of a chunk: their descendants'
    rows and their masses, row-major in the (B, K) draws."""
    so = inputs.simulation_options
    number_limited = inputs.matter_options.SAMPLE_METHOD == "NUMBER-LIMITED"
    inv_table = torch.as_tensor(h["inv_tab"].astype(_f32), device=dev)
    draws = _progenitor_rng(n_exp.float(), PROGENITOR_K_MAX, number_limited, generator, dev)
    return _compacted(*_progenitor_draws(cond_t.float(), m_tgt.float(), inv_table, so.MIN_LOGPROB,
                                         so.SAMPLER_MIN_MASS, **draws))


def _partition_chunk(inputs, h, masses_d, cond_t, m_tgt, n_exp, generator, dev):
    """Partition progenitors of a chunk (emitted and at least
    SAMPLER_MIN_MASS): their descendants' rows and their masses, in the
    order of the (B, PROGENITOR_K_MAX) emissions, the conditions at each
    descendant's barrier (JAX halos.py:931-955)."""
    so = inputs.simulation_options
    m_min = so.SAMPLER_MIN_MASS
    sigma_table = _get_sigma_table(inputs)
    ln_md = torch.log(torch.clamp(masses_d.double(), min=m_min)).float()
    delta_d = _interp(ln_md.double(), torch.as_tensor(h["ln_mbins"], device=dev),
                      torch.as_tensor(h["delta_bins"], device=dev)).float()
    tables = partition_tables(sigma_table, m_min * 0.25, float(np.exp(h["ln_mbins"][-1])) * 1.05)
    use_st = h["hmf_int"] == hmf.HMF_ST
    draw = _partition_rng(masses_d.numel(), use_st, generator, dev)
    m, keep = _partition_kernel(
        delta_d, ln_md, m_tgt > 0, tables, float(sigma_table.sigma_of_lnm(np.log(m_min))),
        m_min, h["growth"], so.HALOMASS_CORRECTION, draw, t_max=PROGENITOR_K_MAX,
        use_st=use_st)
    return _compacted(m, keep & (m >= float(_f32(m_min))))


def _binary_split_chunk(inputs, h, masses_d, cond_t, m_tgt, n_exp, generator, dev):
    """Binary-split progenitors of a chunk (at least SAMPLER_MIN_MASS): their
    descendants' rows and their masses in the order of the JAX package's
    (B, 256) rows, the tree walked from each descendant's barrier at the
    previous redshift to this one's (JAX halos.py:909-930)."""
    so = inputs.simulation_options
    m_min = so.SAMPLER_MIN_MASS
    sigma_table = _get_sigma_table(inputs)
    ln_axis = np.linspace(np.log(m_min * 0.25), float(h["ln_mbins"][-1]) + 0.1, 512)
    tables = tuple(np.asarray(a, _f32) for a in (
        ln_axis, sigma_table.sigma_of_lnm(ln_axis), sigma_table.dsigmasq_of_lnm(ln_axis)))
    B = masses_d.numel()

    def barrier(growth):
        return torch.full((B,), float(_f32(physconst.delta_c_sph / growth)), device=dev)

    rows, _, m, _, _ = _binary_split_kernel(
        torch.clamp(masses_d, min=float(_f32(m_min))), barrier(h["growth_prev"]),
        barrier(h["growth"]), tables, float(_f32(m_min)), float(_f32(so.PARKINSON_G0)),
        float(_f32(so.PARKINSON_y1)), float(_f32(so.PARKINSON_y2)),
        _binary_split_rng(B, generator, dev), t_max=BINARY_SPLIT_T_MAX,
        capacity=BINARY_SPLIT_CAPACITY, cap_out=BINARY_SPLIT_CAP_OUT)
    keep = m >= float(_f32(m_min))
    return rows[keep], m[keep]


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
