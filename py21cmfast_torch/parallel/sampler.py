"""Slab-decomposed stochastic halo sampling on the mesh, following
py21cmfast_tpu/parallel/sampler.py.

The grid sampler's per-cell draws and the progenitor sampler's per-halo
draws are independent, so rank s samples the cells of its own x-slab (and
the progenitors of the halos that lie there) through the single-device
samplers, from a generator of its own; the slab catalogs are then gathered
in slab order, so that every rank holds the whole catalog in the order of
the JAX package's concatenation, for the perturb and the painting of each
node.  The statistics are the single-device sampler's (other random
streams; the conditional MF, the stopping rules and the property draws are
the same code).

Reference equivalent: the OpenMP thread partition of sample_halo_grids /
sample_halo_progenitors (Stochasticity.c:761-1114), lifted to ranks.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..inputs import InputParameters
from ..models import halos
from ..outputs import HaloCatalog
from .mesh import gather_slabs, slab_bounds

__all__ = ["sample_halo_grid_slabs", "sample_progenitors_slabs",
           "determine_halo_catalog_slabs", "slab_partition", "slab_generator"]

_f32 = np.float32


def slab_generator(inputs: InputParameters, redshift: float, slab: int, device) -> torch.Generator:
    """The generator of slab `slab` at `redshift`: seeded from random_seed,
    int(redshift * 100) and the slab, the numbers the JAX package folds
    into its slab keys."""
    seed = np.random.SeedSequence([int(inputs.random_seed), int(redshift * 100), 1 + int(slab)])
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return g


def slab_partition(inputs: InputParameters, x_mpc, n_slabs: int):
    """The rows of each slab's halos, by Lagrangian x: slab s takes
    x0 <= x < x1 of its bounds, slab 0 also x < 0 and the last slab
    everything from its x0 on (JAX sampler.py:141-143)."""
    so = inputs.simulation_options
    x_cells = x_mpc / (so.box_len / so.HII_DIM)
    parts = []
    bounds = slab_bounds(so.HII_DIM, n_slabs)
    for s, (x0, x1) in enumerate(bounds):
        sel = (x_cells >= x0) & (x_cells < x1) if s < n_slabs - 1 else (x_cells >= x0)
        if s == 0:
            sel = sel | (x_cells < 0)
        parts.append(torch.nonzero(sel)[:, 0])
    return parts


def _catalog_rows(masses, coords, rngs):
    return torch.cat([masses[:, None], coords] + [r[:, None] for r in rngs], dim=1)


def _catalog_of_rows(redshift, rows):
    return HaloCatalog(
        redshift=np.float32(redshift),
        halo_masses=rows[:, 0].contiguous(),
        halo_coords=rows[:, 1:4].contiguous(),
        star_rng=rows[:, 4].contiguous(),
        sfr_rng=rows[:, 5].contiguous(),
        xray_rng=rows[:, 6].contiguous(),
        n_halos=int(rows.shape[0]),
    )


def sample_halo_grid_slabs(redshift: float, inputs: InputParameters, lagrangian_delta, mesh,
                           exclude_mask=None, generator=None):
    """The grid sampler with one x-slab a rank: `lagrangian_delta` is this
    rank's slab of the lowres IC density, `exclude_mask` the whole lowres
    DexM mask (numpy) or None.  Returns float32 (masses, positions in Mpc)
    of the whole grid, in slab order, on every rank."""
    so = inputs.simulation_options
    dev = mesh.device
    x0, x1 = mesh.bounds(so.HII_DIM)
    excl = np.asarray(exclude_mask)[x0:x1] if exclude_mask is not None else None
    if generator is None:
        generator = slab_generator(inputs, redshift, mesh.rank, dev)
    m, p = halos.sample_halo_grid(
        redshift, inputs, lagrangian_delta, exclude_mask=excl, generator=generator,
        grid_shape=(x1 - x0,) + tuple(so.lowres_shape[1:]), origin_cells=(x0, 0, 0), device=dev)
    rows = mesh.all_gather_rows(torch.cat([m[:, None], p], dim=1))
    return rows[:, 0].contiguous(), rows[:, 1:].contiguous()


def sample_progenitors_slabs(redshift: float, inputs: InputParameters, prev_cat: HaloCatalog,
                             mesh, generator=None) -> HaloCatalog:
    """The progenitor step with the previous catalog partitioned by halo
    x-position into one slab a rank (halos keep their Lagrangian positions,
    so the partition is stable down the scroll); the slabs' progenitors are
    gathered in slab order."""
    dev = mesh.device
    if int(prev_cat.n_halos) == 0:
        return prev_cat
    coords = prev_cat.halo_coords.to(dev)
    sel = slab_partition(inputs, coords[:, 0], mesh.size)[mesh.rank]
    if sel.numel():
        sub = HaloCatalog(
            redshift=prev_cat.redshift,
            halo_masses=prev_cat.halo_masses.to(dev)[sel],
            halo_coords=coords[sel],
            star_rng=prev_cat.star_rng.to(dev)[sel],
            sfr_rng=prev_cat.sfr_rng.to(dev)[sel],
            xray_rng=prev_cat.xray_rng.to(dev)[sel],
            n_halos=int(sel.numel()),
        )
        if generator is None:
            generator = slab_generator(inputs, redshift, mesh.rank, dev)
        cat = halos._sample_progenitors(redshift, inputs, sub, generator, dev)
        rows = _catalog_rows(cat.halo_masses, cat.halo_coords,
                             (cat.star_rng, cat.sfr_rng, cat.xray_rng))
    else:
        rows = torch.zeros((0, 7), dtype=torch.float32, device=dev)
    return _catalog_of_rows(redshift, mesh.all_gather_rows(rows.to(torch.float32)))


def determine_halo_catalog_slabs(redshift: float, inputs: InputParameters, ics, mesh,
                                 previous_catalog: HaloCatalog | None = None) -> HaloCatalog:
    """The slab counterpart of models.halos.determine_halo_catalog, `ics`
    the ICs' slabs.  The first snapshot's DexM pass runs on the whole hires
    density, gathered for that call only (every rank finds the same halos);
    the grid sampling below the cell mass and every progenitor step run a
    slab a rank."""
    dev = mesh.device
    if previous_catalog is not None:
        return sample_progenitors_slabs(redshift, inputs, previous_catalog, mesh)
    generator = halos.default_generator(inputs, redshift, dev)
    hires = gather_slabs(mesh, ics.hires_density)
    halo_grid, in_halo = halos.dexm_halo_grid(
        redshift, inputs, SimpleNamespace(hires_density=hires), generator=generator, device=dev)
    del hires
    dexm_masses, dexm_pos, excl = halos._dexm_catalog(inputs, halo_grid, in_halo)
    del halo_grid, in_halo
    masses, pos = sample_halo_grid_slabs(redshift, inputs, ics.lowres_density, mesh,
                                         exclude_mask=excl)
    all_masses = torch.cat([torch.as_tensor(dexm_masses.astype(_f32), device=dev), masses])
    all_pos = torch.cat([torch.as_tensor(dexm_pos.astype(_f32), device=dev), pos])
    star, sfr, xray = halos._normals(all_masses.numel(), generator, dev)
    return HaloCatalog(
        redshift=np.float32(redshift),
        halo_masses=all_masses,
        halo_coords=all_pos,
        star_rng=star,
        sfr_rng=sfr,
        xray_rng=xray,
        n_halos=int(all_masses.numel()),
    )
