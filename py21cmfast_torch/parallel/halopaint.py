"""Slab-sharded halo painting: the slab-local CIC of the halos' source
properties with a ghost exchange (the multi-GPU analogue of HaloBox.c:518-561
`sum_halos_onto_grid`), following py21cmfast_tpu/parallel/halopaint.py.

Every rank holds the whole perturbed catalog (the slab sampler gathers it);
each takes the halos whose Eulerian x it owns, turns their masses and
property draws into source quantities with the single-device halo-property
kernel (models/halobox._halo_props_kernel), and CIC-scatters them into its
slab extended by two ghost rows a side, which go to the neighbours as the
perturb deposit's margins do (parallel/perturb.py).  Two rows bound the CIC
stencil: the halos already sit at their Eulerian positions.

With USE_MINI_HALOS the per-cell feedback turnover grids
(models/halobox._mcrit_grids) are computed on the slabs, extended by the
neighbours' edge rows, and CIC-read at each halo before the property kernel
(reference map_mass.c:412-414, HaloBox.c:563-660).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..inputs import InputParameters
from ..models import hmf
from ..models.halobox import _halo_props_kernel, _mcrit_grids, _props_flags, _scaling_consts_dict
from ..ops.gridops import GridOps
from ..ops.grids import true_div
from .perturb import scatter_into_slab

__all__ = ["sharded_halo_grids"]

_MARGIN = 2  # CIC stencil reach in cells; halos sit at Eulerian positions
_f32 = np.float32


def _cic_read_buffer(buf, px_b, py, pz):
    """8-corner CIC read from a ghost-extended (n_buf_x, ny, nz) buffer: x
    clamped into the buffer (the ghosts cover the overflow), y and z
    periodic; the stencil of perturb._cic_scatter_buffer."""
    n_buf_x, ny, nz = buf.shape
    x0, y0, z0 = torch.floor(px_b), torch.floor(py), torch.floor(pz)
    fx, fy, fz = px_b - x0, py - y0, pz - z0
    ix0 = torch.clamp(x0.to(torch.int64), 0, n_buf_x - 2)
    iy0 = torch.remainder(y0.to(torch.int64), ny)
    iz0 = torch.remainder(z0.to(torch.int64), nz)
    out = torch.zeros_like(px_b)
    for dx in (0, 1):
        wx = fx if dx else 1.0 - fx
        for dy in (0, 1):
            wy = fy if dy else 1.0 - fy
            iy = torch.remainder(iy0 + dy, ny)
            for dz in (0, 1):
                wz = fz if dz else 1.0 - fz
                iz = torch.remainder(iz0 + dz, nz)
                out = out + buf[ix0 + dx, iy, iz] * (wx * wy * wz)
    return out


def _with_ghosts(mesh, slab, m):
    """(nxl, ny, nz) slab -> (nxl + 2m, ny, nz) with the neighbours' edge rows."""
    nxl = slab.shape[0]
    from_right, from_left = mesh.exchange(slab[:m].contiguous(), slab[nxl - m:].contiguous())
    return torch.cat([from_left, slab, from_right], dim=0)


def sharded_halo_grids(
    redshift: float,
    inputs: InputParameters,
    pt_halos,
    mesh,
    previous_spin_temp=None,
    previous_ionized_box=None,
    lowres_vcb=None,
) -> SimpleNamespace:
    """Paint n_ion / sfr / wsfr / xray (and sfr_mini / stars_mini with
    USE_MINI_HALOS) onto this rank's x-slab of the lowres grids.

    `pt_halos` is the whole perturbed catalog (every rank holds it); the
    previous boxes and `lowres_vcb` are slabs.  Returns a namespace read as
    a HaloBox by the ionization and the Ts / XraySourceBox stages."""
    so = inputs.simulation_options
    ao = inputs.astro_options
    use_mini = bool(ao.USE_MINI_HALOS)
    shape = so.lowres_shape
    nx = shape[0]
    gops = GridOps(mesh)
    x0, x1 = mesh.bounds(nx)
    nxl = x1 - x0
    dev = mesh.device
    cell = so.box_len / so.HII_DIM

    sc = hmf.set_scaling_constants(redshift, inputs)
    c = _scaling_consts_dict(sc, inputs.cosmology, redshift, ao)
    l10_a = float(np.log10(sc.mturn_a_nofb))
    l10_m = float(np.log10(max(sc.mturn_m_nofb, 1.0)))
    if use_mini:
        mt_a_grid, mt_m_grid = _mcrit_grids(redshift, inputs, sc, previous_spin_temp,
                                            previous_ionized_box, lowres_vcb, dev,
                                            gops.local_shape(shape))
        l10_a, l10_m = gops.means([mt_a_grid, mt_m_grid], shape)

    # the halos whose Eulerian x this rank owns
    pos_cells = true_div(pt_halos.halo_coords.to(dev), cell)
    px = torch.remainder(pos_cells[:, 0], float(nx))
    owner = torch.clamp(torch.div(torch.floor(px).to(torch.int64), nxl, rounding_mode="floor"),
                        0, mesh.size - 1)
    mine = torch.nonzero(owner == mesh.rank)[:, 0]
    px, py, pz = px[mine], pos_cells[mine, 1], pos_cells[mine, 2]
    masses = pt_halos.halo_masses.to(dev)[mine]
    px_b = px - float(x0) + float(_MARGIN)

    if use_mini:
        halo_mt_a = 10.0 ** _cic_read_buffer(_with_ghosts(mesh, mt_a_grid, _MARGIN), px_b, py, pz)
        halo_mt_m = 10.0 ** _cic_read_buffer(_with_ghosts(mesh, mt_m_grid, _MARGIN), px_b, py, pz)
    else:
        halo_mt_a = torch.full_like(masses, float(_f32(sc.mturn_a_nofb)))
        halo_mt_m = torch.full_like(masses, float(_f32(max(sc.mturn_m_nofb, 1.0))))
    props = _halo_props_kernel(
        masses, pt_halos.star_rng.to(dev)[mine], pt_halos.sfr_rng.to(dev)[mine],
        pt_halos.xray_rng.to(dev)[mine], halo_mt_a, halo_mt_m, c, **_props_flags(sc, ao))
    names = ["n_ion", "sfr", "wsfr", "xray38"] + (["sfr_mini", "stellar_mini"] if use_mini else [])
    painted = scatter_into_slab(mesh, px, py, pz, torch.stack([props[n] for n in names]), shape,
                                _MARGIN, x0)
    painted = painted * float(_f32(1.0 / cell**3))
    return SimpleNamespace(
        redshift=np.float32(redshift),
        n_ion=painted[0],
        halo_sfr=painted[1],
        whalo_sfr=painted[2],
        halo_xray=painted[3],
        halo_sfr_mini=painted[4] if use_mini else None,
        halo_stars_mini=painted[5] if use_mini else None,
        log10_Mcrit_ACG_ave=np.float32(l10_a),
        log10_Mcrit_MCG_ave=np.float32(l10_m),
    )
