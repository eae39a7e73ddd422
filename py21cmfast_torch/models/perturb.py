"""Perturbed (Eulerian) density + velocity fields at a given redshift.

Equivalent of reference PerturbedField.c:389-496 + map_mass.c:146-208,
following py21cmfast_tpu/models/perturb.py.  The hires IC "particles" (one per
hires cell, mass 1 + delta*D_init) are moved by the (2)LPT displacement and
CIC-deposited by the swept deposit (ops/deposit.py: the hand-written CUDA
kernel on the card): onto the lowres grid at the integer ratio DIM/HII_DIM,
or with PERTURB_ON_HIGH_RES onto the hires grid itself (ratio 1), which is
then tophat-filtered and subsampled to lowres.  At a non-integer DIM/HII_DIM
each hires particle reads the displacement of its resampled lowres cell and
is scattered by `ops/cic.cic_scatter_flat` (`index_add_`), as the JAX
package's general route does; the choice is made from the shapes alone.

Normalization chain:
  grid = CIC(1 + delta_hi * D_init)            [sum of masses per cell]
  1+delta = grid * HII^3/DIM^3 ; delta = .. - 1
  optional gaussian smoothing; clip at -1+eps
Velocities:  v_i(k) = dD/dt / D * i k_i / k^2 * delta(k)   [comoving Mpc/s]
(reference compute_perturbed_velocities:284-388).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..cosmology.constants import FRACT_FLOAT_ERR, physconst
from ..inputs import InputParameters
from ..ops import cic, deposit, fft, filters, grids
from ..outputs import InitialConditions, PerturbedField

__all__ = ["perturb_field", "uses_swept_deposit"]

_f32 = np.float32


def _displacement_factors(inputs: InputParameters, redshift: float):
    cosmo = inputs.cosmology
    so = inputs.simulation_options
    D = float(cosmo.dicke(redshift))
    D_init = float(cosmo.dicke(so.INITIAL_REDSHIFT))
    fac_za = D - D_init
    # 2LPT displacement is psi2 * (-3/7) D^2 (Scoccimarro 1998 eq. D8);
    # the reference subtracts, with the same form evaluated at both z's.
    fac_2lpt = (-3.0 / 7.0) * (D**2 - D_init**2)
    return D, D_init, fac_za, fac_2lpt


def _displacement_cells(vel, vel_2lpt, fac_za, fac_2lpt, cells_per_mpc):
    """Displacement fields in lowres-cell units for the swept deposit.

    The scale factors are formed in float32 (as the JAX package does with
    its traced float32 growth factors) before they multiply the fields."""
    out = []
    for a in range(3):
        da = vel[a] * float(_f32(fac_za) * _f32(cells_per_mpc[a]))
        if vel_2lpt is not None:
            da = da - vel_2lpt[a] * float(_f32(fac_2lpt) * _f32(cells_per_mpc[a]))
        out.append(da.contiguous())
    return tuple(out)


def uses_swept_deposit(inputs: InputParameters) -> bool:
    """True when a displaced perturb deposits through the swept kernel: at
    an integer ratio of the hires grid to the grid it deposits on (always
    so with PERTURB_ON_HIGH_RES); otherwise it takes the scatter route."""
    so = inputs.simulation_options
    mo = inputs.matter_options
    hi_shape = so.hires_shape
    pt_shape = hi_shape if mo.PERTURB_ON_HIGH_RES else so.lowres_shape
    ratio = hi_shape[0] // pt_shape[0]
    return mo.PERTURB_ALGORITHM != "LINEAR" and all(
        h == ratio * p for h, p in zip(hi_shape, pt_shape))


def _displace_and_scatter(hires_density, vel, vel_2lpt, d_init, fac_za, fac_2lpt, *, hi_shape,
                          out_shape, box_lens):
    """The general deposit of the JAX package's `_displace_and_deposit`
    (map_mass.c:146-208) for a non-integer DIM/HII_DIM: each hires cell
    reads the displacement of its lowres cell by the resample map
    int(i n/N + 0.5) of each axis, moves by it in hires-cell units and is
    CIC-scattered onto the `out_shape` grid, in x slabs of about 2^24
    particles.  Returns the accumulated mass."""
    dev = hires_density.device
    nx, ny, nz = hi_shape
    maps = [torch.as_tensor((np.arange(n) * (o / n) + 0.5).astype(np.int64) % o, device=dev)
            for n, o in zip(hi_shape, out_shape)]
    # the float32 growth factors times the cells per Mpc, in float32
    scale = [float(_f32(fac_za) * _f32(hi_shape[i]) / _f32(box_lens[i])) for i in range(3)]
    scale_2 = [float(_f32(fac_2lpt) * _f32(hi_shape[i]) / _f32(box_lens[i])) for i in range(3)]
    ratio_out = float(_f32(out_shape[0] / hi_shape[0]))
    ratio_out_z = float(_f32(out_shape[2] / hi_shape[2]))
    iy = torch.arange(ny, dtype=torch.float32, device=dev)[None, :, None]
    iz = torch.arange(nz, dtype=torch.float32, device=dev)[None, None, :]
    acc = torch.zeros(int(np.prod(out_shape)), dtype=torch.float32, device=dev)
    slab = max(1, 2**24 // (ny * nz))
    for x0 in range(0, nx, slab):
        xs = torch.arange(x0, min(nx, x0 + slab), device=dev)

        def at(v):
            return v[maps[0][xs]][:, maps[1]][:, :, maps[2]]

        pos = [xs.to(torch.float32)[:, None, None], iy, iz]
        for a in range(3):
            pos[a] = pos[a] + at(vel[a]) * scale[a]
            if vel_2lpt is not None:
                pos[a] = pos[a] - at(vel_2lpt[a]) * scale_2[a]
        mass = 1.0 + hires_density[x0:x0 + xs.numel()] * d_init
        cic.cic_scatter_flat(acc, pos[0] * ratio_out, pos[1] * ratio_out, pos[2] * ratio_out_z,
                             mass, out_shape)
    return acc.reshape(out_shape)


def _finalize_density_and_velocity(
    grid_1pd, mass_factor, dDdt_over_D, *, lo_shape, box_lens, smooth, smooth_R, need_xy
):
    """(1+delta) normalization, optional smoothing, clipping, k-space velocities."""
    dev = grid_1pd.device
    delta = grid_1pd * mass_factor - 1.0
    d_k = fft.rfft3(delta)
    if smooth:
        kmag = grids.kmag_grid(lo_shape, box_lens, dev)
        d_k = filters.filter_kbox(d_k, kmag, filters.GAUSSIAN, float(_f32(smooth_R)))
    delta = torch.clamp_min(fft.irfft3(d_k, lo_shape), -1.0 + FRACT_FLOAT_ERR)

    kx, ky, kz = grids.k_axes(lo_shape, box_lens, dev)
    ksq = grids.ksq_grid(lo_shape, box_lens, dev)
    ksq_safe = torch.where(ksq > 0, ksq, 1.0)

    def vel_axis(kvec):
        v_k = d_k * (1j * (kvec * dDdt_over_D) / ksq_safe)
        return fft.irfft3(v_k.masked_fill_(ksq == 0, 0), lo_shape)

    v_z = vel_axis(kz[None, None, :])
    v_x = vel_axis(kx[:, None, None]) if need_xy else None
    v_y = vel_axis(ky[None, :, None]) if need_xy else None
    return delta, v_x, v_y, v_z


def perturb_field(
    redshift: float, inputs: InputParameters, ics: InitialConditions, *, device="cuda"
) -> PerturbedField:
    """Compute the Eulerian density/velocity at `redshift` from the ICs.

    The IC fields are moved to `device` if they live elsewhere."""
    dev = resolve_device(device)
    so = inputs.simulation_options
    mo = inputs.matter_options
    cosmo = inputs.cosmology
    hi_shape = so.hires_shape
    lo_shape = so.lowres_shape
    # the grid the particles are deposited on, where the ICs' velocities live
    pt_shape = hi_shape if mo.PERTURB_ON_HIGH_RES else lo_shape
    box_lens = so.box_lens

    D, D_init, fac_za, fac_2lpt = _displacement_factors(inputs, redshift)
    dDdt_over_D = float(_f32(cosmo.ddicke_dt(redshift) / D))

    if mo.PERTURB_ALGORITHM == "LINEAR":
        grid_1pd = ics.lowres_density.to(dev) * float(_f32(D)) + 1.0
        mass_factor = 1.0
    elif not uses_swept_deposit(inputs):
        # a non-integer DIM/HII_DIM: the general resample-and-scatter route
        use_2lpt = mo.PERTURB_ALGORITHM == "2LPT" and ics.vx_2LPT is not None
        grid_1pd = _displace_and_scatter(
            ics.hires_density.to(dev), tuple(v.to(dev) for v in (ics.vx, ics.vy, ics.vz)),
            tuple(v.to(dev) for v in (ics.vx_2LPT, ics.vy_2LPT, ics.vz_2LPT)) if use_2lpt else None,
            float(_f32(D_init)), fac_za, fac_2lpt, hi_shape=hi_shape, out_shape=pt_shape,
            box_lens=box_lens)
        mass_factor = float(_f32(np.prod(pt_shape) / np.prod(hi_shape)))
    else:
        # PERTURB_DEPOSIT "SWEPT" and "SCATTER" name two TPU schedules of one
        # function at an integer ratio: hires cell h lands at h/R + d(c(h)),
        # which is the swept c + s/R + d(c).  Both take the one kernel.
        ratio = hi_shape[0] // pt_shape[0]
        cells_per_mpc = tuple(pt_shape[a] / box_lens[a] for a in range(3))
        use_2lpt = mo.PERTURB_ALGORITHM == "2LPT" and ics.vx_2LPT is not None
        vel = tuple(v.to(dev) for v in (ics.vx, ics.vy, ics.vz))
        vel_2lpt = (
            tuple(v.to(dev) for v in (ics.vx_2LPT, ics.vy_2LPT, ics.vz_2LPT))
            if use_2lpt else None
        )
        d_fields = _displacement_cells(vel, vel_2lpt, fac_za, fac_2lpt, cells_per_mpc)
        grid_1pd = deposit.cic_deposit_swept(
            ics.hires_density.to(dev).contiguous(), *d_fields, float(_f32(D_init)), ratio
        )
        mass_factor = float(_f32(np.prod(pt_shape) / np.prod(hi_shape)))
        if pt_shape != lo_shape:
            # deposited on the hires grid: tophat-filter (1+delta) at the
            # lowres cell scale and subsample before the normalization
            d_k = filters.filter_kbox(
                fft.rfft3(grid_1pd), grids.kmag_grid(pt_shape, box_lens, dev), filters.TOPHAT,
                float(_f32(physconst.l_factor * box_lens[0] / lo_shape[0])),
            )
            grid_1pd = grids.subsample(fft.irfft3(d_k, pt_shape), lo_shape)
            mass_factor = 1.0

    delta, v_x, v_y, v_z = _finalize_density_and_velocity(
        grid_1pd,
        mass_factor,
        dDdt_over_D,
        lo_shape=lo_shape,
        box_lens=box_lens,
        smooth=mo.SMOOTH_EVOLVED_DENSITY_FIELD,
        smooth_R=so.DENSITY_SMOOTH_RADIUS * so.box_len / so.HII_DIM,
        need_xy=mo.KEEP_3D_VELOCITIES,
    )
    return PerturbedField(
        redshift=np.float32(redshift),
        density=delta,
        velocity_z=v_z,
        velocity_x=v_x,
        velocity_y=v_y,
    )
