"""k-space grid helpers for rfftn-layout boxes.

Conventions: numpy FFT layout — a real box of shape (Nx, Ny, Nz) transforms
to a complex half-space (Nx, Ny, Nz//2 + 1).  k_i = 2*pi*n_i/L_i with n wrapped
to [-N/2, N/2] (reference indexing.h:116-120 `index_to_k`).
"""

from __future__ import annotations

import numpy as np
import torch


_scalars: dict = {}


def device_scalar(value, dtype, device):
    """A 0-d tensor of `value` on `device`, made once: creating one copies
    to the card and waits for it."""
    key = (float(value), dtype, torch.device(device))
    if key not in _scalars:
        _scalars[key] = torch.tensor(float(value), dtype=dtype, device=device)
    return _scalars[key]


def true_div(x, divisor):
    """x / divisor, a true float32 division on every device: divided by a
    host scalar, CUDA multiplies by its reciprocal instead."""
    return x / device_scalar(divisor, x.dtype, x.device)


def k_axes(shape, box_lens, device):
    """Return (kx, ky, kz) 1D float32 tensors for an rfftn half-space of a real box."""
    nx, ny, nz = shape
    lx, ly, lz = box_lens
    kx = np.fft.fftfreq(nx) * nx * 2 * np.pi / lx
    ky = np.fft.fftfreq(ny) * ny * 2 * np.pi / ly
    kz = np.fft.rfftfreq(nz) * nz * 2 * np.pi / lz
    return tuple(torch.as_tensor(k, dtype=torch.float32, device=device) for k in (kx, ky, kz))


def ksq_grid(shape, box_lens, device):
    """|k|^2 on the rfftn half-space, shape (Nx, Ny, Nz//2+1)."""
    kx, ky, kz = k_axes(shape, box_lens, device)
    return kx[:, None, None] ** 2 + ky[None, :, None] ** 2 + kz[None, None, :] ** 2


def kmag_grid(shape, box_lens, device):
    """|k| on the rfftn half-space, shape (Nx, Ny, Nz//2+1), correctly rounded
    to float32 as the JAX package's |k| is.  torch's CPU float32 sqrt is not
    (it is an ulp off on some cells), so on the CPU the root is taken in
    float64 and rounded; the card's float32 sqrt is exact."""
    ksq = ksq_grid(shape, box_lens, device)
    if ksq.device.type == "cpu":
        return torch.sqrt(ksq.double()).float()
    return torch.sqrt(ksq)


def resample_indices(n_out: int, n_in: int):
    """Strided subsampling indices: lowres index i -> hires index int(i*ratio+0.5).

    Mirrors reference indexing.h:110-114 `resample_index` (note the +0.5 is on the
    *output* resolution since the ratio may be non-integer).
    """
    ratio = n_in / n_out
    idx = (np.arange(n_out) * ratio + 0.5).astype(np.int64)
    return np.clip(idx, 0, n_in - 1)


def subsample(field, out_shape):
    """Subsample a 3D real-space field at strided points (no averaging), as the
    reference does when assigning hires -> lowres grids."""
    for axis in range(3):
        idx = resample_indices(out_shape[axis], field.shape[axis])
        field = field.index_select(axis, torch.as_tensor(idx, device=field.device))
    return field


def uniform_lerp(x, x0, inv_dx, table):
    """Linear interpolation on a UNIFORM 1D grid: table[i] at x0 + i/inv_dx.

    The clip to >= 0 comes before the integer cast, so the truncation toward
    zero of the cast is a floor."""
    t = (x - x0) * inv_dx
    t = torch.clamp(t, 0.0, table.shape[0] - 1.001)
    i0 = t.to(torch.int64)
    f = t - i0
    return table[i0] * (1.0 - f) + table[i0 + 1] * f
