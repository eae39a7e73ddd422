"""Distributed 3D real FFT: slab decomposition with all-to-all transposes.

Each rank owns an x-slab, transforms its (y, z) planes, then one all-to-all
re-slabs the box along ky for the last transform along x.  The k-space
result is therefore ky-sharded: rank r holds the ky rows r*ny/p ...
(r+1)*ny/p of the whole (nx, ny, nz//2+1) half-box, on which filters and
gradients act directly; the inverse reverses the transpose.  Follows
py21cmfast_tpu/parallel/pfft.py.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["rfft3", "irfft3", "local_k_axes", "local_kmag"]


def rfft3(mesh, local_x):
    """(nx/p, ny, nz) real x-slab -> (nx, ny/p, nz//2+1) complex ky-shard."""
    k_yz = torch.fft.rfftn(local_x, dim=(1, 2))
    k_t = mesh.all_to_all(k_yz, split_axis=1, concat_axis=0)
    return torch.fft.fft(k_t, dim=0)


def irfft3(mesh, local_k, nz: int):
    """(nx, ny/p, nz//2+1) ky-shard -> (nx/p, ny, nz) real x-slab."""
    k_t = torch.fft.ifft(local_k, dim=0)
    k_yz = mesh.all_to_all(k_t, split_axis=0, concat_axis=1)
    return torch.fft.irfftn(k_yz, s=(k_yz.shape[1], nz), dim=(1, 2))


def local_k_axes(mesh, shape, box_lens, device):
    """(kx, ky, kz) float32 of the ky-sharded layout: the whole kx and kz
    axes and this rank's ky rows."""
    nx, ny, nz = shape
    lx, ly, lz = box_lens
    chunk = ny // mesh.size
    kx = np.fft.fftfreq(nx) * nx * 2 * np.pi / lx
    ky = (np.fft.fftfreq(ny) * ny * 2 * np.pi / ly)[mesh.rank * chunk:(mesh.rank + 1) * chunk]
    kz = np.fft.rfftfreq(nz) * nz * 2 * np.pi / lz
    return tuple(torch.as_tensor(k, dtype=torch.float32, device=device) for k in (kx, ky, kz))


def local_ksq(mesh, shape, box_lens, device):
    kx, ky, kz = local_k_axes(mesh, shape, box_lens, device)
    return kx[:, None, None] ** 2 + ky[None, :, None] ** 2 + kz[None, None, :] ** 2


def local_kmag(mesh, shape, box_lens, device):
    """|k| of this rank's ky rows, correctly rounded to float32 as
    `ops.grids.kmag_grid` takes it (the root in float64 on the CPU)."""
    ksq = local_ksq(mesh, shape, box_lens, device)
    if ksq.device.type == "cpu":
        return torch.sqrt(ksq.double()).float()
    return torch.sqrt(ksq)
