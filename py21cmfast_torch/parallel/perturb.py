"""Slab-sharded initial conditions and perturbed field: the GRF, the lowres
density, the Zel'dovich, 2LPT and v_cb fields through the slab FFT, and the
slab-local CIC deposit with a ghost exchange (the multi-GPU equivalents of
models/ics.py and models/perturb.py), following
py21cmfast_tpu/parallel/perturb.py.

Decomposition: the hires "particles" (one per hires cell) live on x-slabs;
each rank deposits its particles into a lowres buffer extended by `margin`
rows on each side, then sends the margins to its neighbours, which add them
to their edge rows (periodic in x).  The margin bounds the largest
x-displacement over every rank, so no particle lands beyond one neighbour.
The deposit is `index_add_`, as the JAX package's is an XLA scatter
(`_cic_scatter_buffer`), not its Pallas kernel.

Reference equivalents: InitialConditions.c:547-772, PerturbedField.c:389-496
(move + deposit), compute_perturbed_velocities:284-388.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cosmology.constants import FRACT_FLOAT_ERR, physconst
from ..ops import filters, grids
from . import pfft

__all__ = ["build_sharded_lowres_ics", "build_sharded_perturb", "displace_grids_slab",
           "scatter_into_slab"]

_f32 = np.float32

# hires particles a deposit chunk (bounds the index and weight temporaries)
_CHUNK_PARTICLES = 2**24


def _masked(g_k, keep):
    return g_k.masked_fill(~keep, 0)


def build_sharded_lowres_ics(mesh, hi_shape, lo_shape, box_lens, use_2lpt=False,
                             with_vcb=False):
    """fn(white, ln_k, sqrtp[, ln_k_v, ratio_v]) -> (hires_density,
    lowres_density, psi_x, psi_y, psi_z[, psi2_x, psi2_y, psi2_z][, vcb]),
    this rank's x-slabs (hires_density at the hires resolution, the rest at
    lowres).  `white` is this rank's slab of the hires white noise; the
    tables are `models.ics.power_amplitude_table` (and `vcb_ratio_table`
    with `with_vcb`).  The tophat filter at the lowres cell scale (when
    DIM != HII_DIM) and the strided subsample of the single-device ICs;
    with `use_2lpt` the Scoccimarro 1998 App. D second-order displacement
    from six phi_ij transforms, one forward transform and three gradients,
    all through the slab FFT; with `with_vcb` the lowres |v_cb| box [km/s]
    of models.ics.compute_vcb_box."""
    n_shards = mesh.size
    nx, ny, nz = hi_shape
    if nx % n_shards or ny % n_shards or lo_shape[0] % n_shards:
        raise ValueError(f"{hi_shape} / {lo_shape} grids do not split into {n_shards} slabs")
    n_tot = nx * ny * nz
    volume = box_lens[0] * box_lens[1] * box_lens[2]
    amp_fac = float(_f32(np.sqrt(n_tot / volume)))
    do_filter = hi_shape[0] != lo_shape[0]
    smooth_R = physconst.l_factor * box_lens[0] / lo_shape[0]
    ratio = hi_shape[0] // lo_shape[0]
    if do_filter:
        if any(h != ratio * lo for h, lo in zip(hi_shape, lo_shape)):
            raise ValueError("the sharded ICs need an integer DIM/HII_DIM")
        if (nx // n_shards) % ratio:
            raise ValueError("hires slab must contain whole subsampling strides")

    def subsample_local(x):
        if not do_filter:
            return x
        return x[::ratio, ::ratio, ::ratio].contiguous()

    def fn(white, ln_k, sqrtp, ln_k_v=None, ratio_v=None):
        dev = white.device
        d_k = pfft.rfft3(mesh, white)
        kx, ky, kz = pfft.local_k_axes(mesh, hi_shape, box_lens, dev)
        kvecs = (kx[:, None, None], ky[None, :, None], kz[None, None, :])
        kmag = pfft.local_kmag(mesh, hi_shape, box_lens, dev)
        has_k = kmag > 0
        lnk = torch.log(torch.where(has_k, kmag, 1.0))
        inv_dx = (ln_k.shape[0] - 1) / (ln_k[-1] - ln_k[0])
        amp = torch.where(has_k, grids.uniform_lerp(lnk, ln_k[0], inv_dx, sqrtp), 0.0) * amp_fac
        d_k = d_k * amp
        del amp
        hires_density = pfft.irfft3(mesh, d_k, nz)
        ksq = kvecs[0] ** 2 + kvecs[1] ** 2 + kvecs[2] ** 2
        ksq_pos = ksq > 0
        ksq_safe = torch.where(ksq_pos, ksq, 1.0)

        vcb = None
        if with_vcb:
            kmag_safe = torch.sqrt(ksq_safe)
            ramp = torch.where(
                has_k, grids.uniform_lerp(lnk, ln_k_v[0], (ln_k_v.shape[0] - 1)
                                          / (ln_k_v[-1] - ln_k_v[0]), ratio_v), 0.0)
            v2 = None
            for kvec in kvecs:
                g = d_k * (1j * kvec / kmag_safe) * ramp
                if do_filter:
                    g = filters.filter_kbox(g, kmag, filters.TOPHAT, smooth_R)
                comp = subsample_local(pfft.irfft3(mesh, g, nz))
                v2 = comp * comp if v2 is None else v2 + comp * comp
            vcb = torch.sqrt(v2)
            del kmag_safe, ramp, g
        del lnk

        d_k_f = filters.filter_kbox(d_k, kmag, filters.TOPHAT, smooth_R) if do_filter else d_k
        density = subsample_local(pfft.irfft3(mesh, d_k_f, nz))

        def grad(src_k, kvec, filt):
            g = _masked(src_k * (1j * kvec / ksq_safe), ksq_pos)
            if filt:
                g = filters.filter_kbox(g, kmag, filters.TOPHAT, smooth_R)
            return subsample_local(pfft.irfft3(mesh, g, nz))

        psi = [grad(d_k_f, kv, False) for kv in kvecs]
        del d_k_f
        out = [hires_density, density] + psi
        if use_2lpt:
            # lap(phi2) = sum_{i<j} phi_ii phi_jj - phi_ij^2, phi_ij from the
            # UNFILTERED field; the lowres-cell smoothing is applied to the
            # final gradient (as the single-device _compute_2lpt)
            def phi_ij(i, j):
                return pfft.irfft3(mesh, _masked(-d_k * kvecs[i] * kvecs[j] / ksq_safe, ksq_pos),
                                   nz)

            p_xx, p_yy, p_zz = phi_ij(0, 0), phi_ij(1, 1), phi_ij(2, 2)
            s2 = p_xx * p_yy + p_xx * p_zz + p_yy * p_zz
            del p_xx, p_yy, p_zz
            for i, j in ((0, 1), (0, 2), (1, 2)):
                od = phi_ij(i, j)
                s2 = s2 - od * od
                del od
            s2_k = pfft.rfft3(mesh, s2)
            del s2
            out += [grad(s2_k, kv, do_filter) for kv in kvecs]
        if with_vcb:
            out.append(vcb)
        return tuple(out)

    return fn


def _cic_scatter_buffer(buf, px_b, py, pz, w, n_buf_x, ny, nz):
    """8-corner CIC into a flattened margin-extended buffer, in place: x is
    clamped into the buffer (no wrap, the margins take the overflow), y and
    z are periodic.  `buf` is (n_cells,) with `w` of the positions' shape,
    or a (P, n_cells) stack with `w` of shape (P,) + the positions' shape."""
    x0, y0, z0 = torch.floor(px_b), torch.floor(py), torch.floor(pz)
    fx, fy, fz = px_b - x0, py - y0, pz - z0
    ix0 = torch.clamp(x0.to(torch.int64), 0, n_buf_x - 2)
    iy0 = torch.remainder(y0.to(torch.int64), ny)
    iz0 = torch.remainder(z0.to(torch.int64), nz)
    dim = buf.dim() - 1
    w = w.reshape(w.shape[:dim] + (-1,))
    for dx in (0, 1):
        wx = fx if dx else 1.0 - fx
        ix = ix0 + dx
        for dy in (0, 1):
            wy = fy if dy else 1.0 - fy
            iy = torch.remainder(iy0 + dy, ny)
            for dz in (0, 1):
                wz = fz if dz else 1.0 - fz
                iz = torch.remainder(iz0 + dz, nz)
                idx = ((ix * ny + iy) * nz + iz).reshape(-1)
                buf.index_add_(dim, idx, w * (wx * wy * wz).reshape(-1))
    return buf


def _fold_margins(mesh, buf, margin, nxl):
    """The interior of a margin-extended (..., n_buf_x, ny, nz) buffer with
    the neighbours' margins added: my left margin belongs to the left
    neighbour's tail, my right margin to the right neighbour's head."""
    lead = buf.dim() - 3
    sl = (slice(None),) * lead
    left = buf[sl + (slice(0, margin),)].contiguous()
    right = buf[sl + (slice(margin + nxl, None),)].contiguous()
    from_right, from_left = mesh.exchange(left, right)
    interior = buf[sl + (slice(margin, margin + nxl),)].clone()
    interior[sl + (slice(nxl - margin, nxl),)] += from_right
    interior[sl + (slice(0, margin),)] += from_left
    return interior


def scatter_into_slab(mesh, px, py, pz, weights, lo_shape, margin, x0_glob):
    """CIC-scatter `weights` at lowres positions (px global, in cells) onto
    this rank's x-slab of a `lo_shape` grid, whose first row is `x0_glob`:
    through a buffer of `margin` ghost rows a side and the ghost exchange.
    `weights` may be a (P, ...) stack; returns (nxl, ny, nz) or (P, nxl,
    ny, nz)."""
    x0, x1 = mesh.bounds(lo_shape[0])
    nxl, ny, nz = x1 - x0, lo_shape[1], lo_shape[2]
    n_buf_x = nxl + 2 * margin
    lead = tuple(weights.shape[:weights.dim() - px.dim()])
    buf = torch.zeros(lead + (n_buf_x * ny * nz,), dtype=torch.float32, device=px.device)
    px_b = px - float(_f32(x0_glob)) + float(_f32(margin))
    _cic_scatter_buffer(buf, px_b, py, pz, weights, n_buf_x, ny, nz)
    return _fold_margins(mesh, buf.reshape(lead + (n_buf_x, ny, nz)), margin, nxl)


def margin_cells(mesh, local_max_disp, nxl):
    """The ghost rows a side for displacements of at most `local_max_disp`
    lowres cells on this rank: the maximum over every rank (ranks with
    buffers of different sizes would corrupt the exchange), plus the CIC
    stencil and padding, at most the slab width."""
    (glob,) = mesh.all_reduce_floats([local_max_disp], "max")
    return min(int(np.ceil(glob)) + 3, nxl)


def displace_grids_slab(mesh, props, vel, vel_2lpt, fac_za, fac_2lpt, disp_to_cells):
    """`models.halobox._displace_grids` on x-slabs: each cell's values move
    to index + psi * factor (x global) and are CIC-deposited across the slab
    borders."""
    nxl, ny, nz = props[0].shape
    x0, _ = mesh.bounds(nxl * mesh.size)
    lo_shape = (nxl * mesh.size, ny, nz)
    dev = props[0].device
    pos = []
    local_max = 0.0
    for a in range(3):
        d = vel[a] * fac_za
        if vel_2lpt is not None:
            d = d + vel_2lpt[a] * fac_2lpt
        d = d * disp_to_cells
        view = [1, 1, 1]
        view[a] = props[0].shape[a]
        idx = torch.arange(props[0].shape[a], dtype=torch.float32, device=dev).reshape(view)
        if a == 0:
            idx = idx + float(x0)
            local_max = float(d.abs().max()) if d.numel() else 0.0
        pos.append(idx + d)
    margin = margin_cells(mesh, local_max, nxl)
    moved = scatter_into_slab(mesh, pos[0], pos[1], pos[2], torch.stack(props), lo_shape, margin,
                              x0)
    return [g.clone() for g in moved.unbind(0)]


def build_sharded_perturb(mesh, hi_shape, lo_shape, box_lens, margin: int, use_2lpt=False):
    """fn(hires_density, psi_x, psi_y, psi_z, psi2_x, psi2_y, psi2_z, d_init,
    fac_za, fac_2lpt, mass_factor, dDdt_over_D) -> (delta, v_z), this rank's
    lowres x-slabs; the psi2 fields are read only with `use_2lpt`.

    `psi_*` are the lowres displacement slabs of build_sharded_lowres_ics;
    `margin` bounds the largest |x displacement| in lowres cells over every
    rank (the driver takes max|psi_x| * fac_za (+ |psi2_x| * fac_2lpt) *
    HII/BOX + padding, reduced over the ranks)."""
    n_shards = mesh.size
    nx_h, ny_h, nz_h = hi_shape
    nx_l, ny_l, nz_l = lo_shape
    nxh_loc = nx_h // n_shards
    nxl_loc = nx_l // n_shards
    if margin > nxl_loc:
        raise ValueError("displacement margin exceeds the slab width")
    ratio = nx_h / nx_l
    # hires index -> lowres (pt) grid index for the displacement gathers
    map_loc = (np.arange(nxh_loc) * (nx_l / nx_h) + 0.5).astype(np.int64)
    needs_next = map_loc.max() >= nxl_loc  # the gather may touch the neighbour's first row
    map_y = (np.arange(ny_h) * (ny_l / ny_h) + 0.5).astype(np.int64) % ny_l
    map_z = (np.arange(nz_h) * (nz_l / nz_h) + 0.5).astype(np.int64) % nz_l
    inv_ratio = float(_f32(1.0 / ratio))
    y_step, z_step = float(_f32(ny_l / ny_h)), float(_f32(nz_l / nz_h))

    def cells_per_mpc(fac):
        """float32 fac * n_l / L per axis, formed as the JAX package does."""
        f = _f32(fac)
        return [float(_f32(f * _f32(n)) / _f32(lb)) for n, lb in zip(lo_shape, box_lens)]

    def fn(hires_density, psi_x, psi_y, psi_z, psi2_x, psi2_y, psi2_z, d_init, fac_za, fac_2lpt,
           mass_factor, dDdt_over_D):
        dev = hires_density.device
        x0_glob_l = mesh.rank * nxl_loc

        def extend(v):
            """The slab with one row more from the right neighbour."""
            if not needs_next:
                return v
            first = v[:1].contiguous()
            from_right, _ = mesh.exchange(first, torch.zeros_like(first))
            return torch.cat([v, from_right], dim=0)

        fields = [extend(psi_x), extend(psi_y), extend(psi_z)]
        if use_2lpt:
            fields += [extend(psi2_x), extend(psi2_y), extend(psi2_z)]
        s = cells_per_mpc(fac_za)
        s2 = cells_per_mpc(fac_2lpt)
        iy_l = torch.as_tensor(map_y, device=dev)
        iz_l = torch.as_tensor(map_z, device=dev)
        fy = torch.arange(ny_h, dtype=torch.float32, device=dev)[None, :, None] * y_step
        fz = torch.arange(nz_h, dtype=torch.float32, device=dev)[None, None, :] * z_step
        n_buf_x = nxl_loc + 2 * margin
        buf = torch.zeros(n_buf_x * ny_l * nz_l, dtype=torch.float32, device=dev)
        rows = max(1, _CHUNK_PARTICLES // (ny_h * nz_h))
        for r0 in range(0, nxh_loc, rows):
            r1 = min(nxh_loc, r0 + rows)
            ix_l = torch.as_tensor(map_loc[r0:r1], device=dev)

            def g(v):
                return v[ix_l][:, iy_l][:, :, iz_l]

            ix_glob_h = torch.arange(mesh.rank * nxh_loc + r0, mesh.rank * nxh_loc + r1,
                                     dtype=torch.float32, device=dev)
            px = ix_glob_h[:, None, None] * inv_ratio + g(fields[0]) * s[0]
            py = fy + g(fields[1]) * s[1]
            pz = fz + g(fields[2]) * s[2]
            if use_2lpt:
                # SUBTRACTED: fac_2lpt carries the -3/7 D^2 factor
                px = px - g(fields[3]) * s2[0]
                py = py - g(fields[4]) * s2[1]
                pz = pz - g(fields[5]) * s2[2]
            mass = 1.0 + hires_density[r0:r1] * d_init
            px_b = px - float(_f32(x0_glob_l)) + float(_f32(margin))
            _cic_scatter_buffer(buf, px_b, py, pz, mass, n_buf_x, ny_l, nz_l)
            del px, py, pz, px_b, mass
        interior = _fold_margins(mesh, buf.reshape(n_buf_x, ny_l, nz_l), margin, nxl_loc)
        del buf
        delta = interior * float(_f32(mass_factor)) - 1.0
        # velocities through the slab FFT (kz is the unsharded axis)
        d_k = pfft.rfft3(mesh, delta)
        kz = pfft.local_k_axes(mesh, lo_shape, box_lens, dev)[2]
        ksq = pfft.local_ksq(mesh, lo_shape, box_lens, dev)
        ksq_pos = ksq > 0
        ksq_safe = torch.where(ksq_pos, ksq, 1.0)
        v_k = _masked(d_k * (1j * kz[None, None, :] * float(_f32(dDdt_over_D)) / ksq_safe), ksq_pos)
        v_z = pfft.irfft3(mesh, v_k, nz_l)
        delta = torch.clamp_min(delta, -1.0 + FRACT_FLOAT_ERR)
        return delta, v_z

    return fn
