"""Cloud-in-cell mass assignment in plain PyTorch (reference map_mass.c:19-210).

Each of the 8 CIC corners is one `index_add_` into the flattened grid.  These
are the plain versions: the swept deposit on the card runs the hand-written
kernel in ops/deposit.py, which is held against `cic_scatter_flat`.
"""

from __future__ import annotations

import torch


def _corners(px, py, pz, shape, dtype):
    """Lower corner indices (periodic), upper indices and fractions per axis."""
    out = []
    for p, n in zip((px, py, pz), shape):
        i0f = torch.floor(p)
        f = (p - i0f).to(dtype)
        i0 = torch.remainder(i0f.to(torch.int64), n)
        out.append((i0, torch.remainder(i0 + 1, n), f))
    return out


def cic_scatter_flat(acc_flat, px, py, pz, weights, out_shape):
    """Scatter-add `weights` at fractional positions into a flattened grid, in place.

    Positions are in *output-grid cell units* (cell centres at integer coords,
    matching reference map_mass.c:28 'cell at idx==0 centred at (0,0,0)'),
    periodic wrapping applied.  Returns `acc_flat`.
    """
    nx, ny, nz = out_shape
    (ix0, ix1, fx), (iy0, iy1, fy), (iz0, iz1, fz) = _corners(
        px, py, pz, out_shape, acc_flat.dtype
    )
    w = weights.to(acc_flat.dtype)
    for xi, wx in ((ix0, 1.0 - fx), (ix1, fx)):
        for yi, wy in ((iy0, 1.0 - fy), (iy1, fy)):
            base = (xi * ny + yi) * nz
            for zi, wz in ((iz0, 1.0 - fz), (iz1, fz)):
                acc_flat.index_add_(0, (base + zi).reshape(-1), (w * wx * wy * wz).reshape(-1))
    return acc_flat


def cic_read(box, px, py, pz):
    """Trilinear (CIC) read of `box` at fractional positions (map_mass.c:102-140)."""
    (ix0, ix1, fx), (iy0, iy1, fy), (iz0, iz1, fz) = _corners(
        px, py, pz, box.shape, box.dtype
    )
    out = 0.0
    for xi, wx in ((ix0, 1.0 - fx), (ix1, fx)):
        for yi, wy in ((iy0, 1.0 - fy), (iy1, fy)):
            for zi, wz in ((iz0, 1.0 - fz), (iz1, fz)):
                out = out + box[xi, yi, zi] * wx * wy * wz
    return out
