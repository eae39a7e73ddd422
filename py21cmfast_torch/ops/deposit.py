"""Swept CIC deposit of the 2LPT perturb: the CUDA kernel, its plain version
and the wrapper that chooses between them by the tensors' device.

The DIM^3 "particles" (one per hires cell, mass 1 + delta*D_init) move by the
lowres displacement field and deposit onto the lowres grid with CIC weights
(reference map_mass.c:146-210).  Hires cell h = R*c + s on each axis, with the
centred residual s in [-R//2, R - R//2) and the last partial channel wrapped
to c = 0, lands at c + d(c) + s/R in lowres cells (the channel decomposition
of py21cmfast_tpu/ops/deposit.py).

`cic_deposit_swept` launches csrc/cic_deposit.cu for CUDA tensors and runs
`cic_deposit_swept_plain` only for CPU tensors.  The result is the
unnormalized accumulated mass (divide by R^3 for mean one).
"""

from __future__ import annotations

import ctypes

import torch

from . import cic

__all__ = ["cic_deposit_swept", "cic_deposit_swept_plain"]


def _check(hires, dx, dy, dz, ratio):
    if ratio < 1 or int(ratio) != ratio:
        raise ValueError(f"ratio must be a positive integer, got {ratio}")
    lo_shape = tuple(dx.shape)
    if len(lo_shape) != 3:
        raise ValueError(f"displacements must be 3D, got shape {lo_shape}")
    for name, t in (("dx", dx), ("dy", dy), ("dz", dz)):
        if tuple(t.shape) != lo_shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, dx has {lo_shape}")
    want = tuple(ratio * n for n in lo_shape)
    if tuple(hires.shape) != want:
        raise ValueError(f"hires has shape {tuple(hires.shape)}, expected R*lo_shape = {want}")
    for name, t in (("hires", hires), ("dx", dx), ("dy", dy), ("dz", dz)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != hires.device:
            raise ValueError(f"{name} is on {t.device}, hires on {hires.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return lo_shape


def _channel_axis(n_hi: int, n_lo: int, ratio: int, device):
    """Per-axis channel cell c (wrapped) and residual s/R of every hires index."""
    h = torch.arange(n_hi, device=device) + ratio // 2
    c = torch.remainder(torch.div(h, ratio, rounding_mode="floor"), n_lo)
    rho = (torch.remainder(h, ratio) - ratio // 2).to(torch.float32) / ratio
    return c, rho


def cic_deposit_swept_plain(hires, dx, dy, dz, d_init, ratio):
    """Plain PyTorch version: every sub-particle's position and mass on the
    whole hires grid, then the per-particle CIC scatter."""
    lo_shape = _check(hires, dx, dy, dz, ratio)
    dev = hires.device
    (cx, rx), (cy, ry), (cz, rz) = (
        _channel_axis(hires.shape[a], lo_shape[a], ratio, dev) for a in range(3)
    )

    def at_channel(d):
        return d.index_select(0, cx).index_select(1, cy).index_select(2, cz)

    fx, fy, fz = (c.to(torch.float32) for c in (cx, cy, cz))
    px = fx[:, None, None] + at_channel(dx) + rx[:, None, None]
    py = fy[None, :, None] + at_channel(dy) + ry[None, :, None]
    pz = fz[None, None, :] + at_channel(dz) + rz[None, None, :]
    mass = 1.0 + hires * d_init
    acc = torch.zeros(lo_shape[0] * lo_shape[1] * lo_shape[2], dtype=torch.float32, device=dev)
    return cic.cic_scatter_flat(acc, px, py, pz, mass, lo_shape).reshape(lo_shape)


def cic_deposit_swept(hires, dx, dy, dz, d_init, ratio):
    """Deposit 1 + hires*d_init, displaced by (dx, dy, dz) [lowres cells],
    onto the lowres grid.  CUDA tensors launch the kernel (counted in
    `cic_deposit_swept.launches`); CPU tensors take the plain version."""
    lo_shape = _check(hires, dx, dy, dz, ratio)
    if hires.device.type == "cpu":
        return cic_deposit_swept_plain(hires, dx, dy, dz, d_init, ratio)
    if hires.device.type != "cuda":
        raise ValueError(f"unsupported device {hires.device}")
    from .._kernels import load

    fn = load(
        "cic_deposit", "cic_deposit_swept",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
    )
    # the C function zeroes `out` on the stream before it launches the kernel
    out = torch.empty(lo_shape, dtype=torch.float32, device=hires.device)
    with torch.cuda.device(hires.device):
        err = fn(
            hires.data_ptr(), dx.data_ptr(), dy.data_ptr(), dz.data_ptr(), out.data_ptr(),
            *lo_shape, int(ratio), float(d_init), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"cic_deposit_swept kernel launch failed: cudaError {err}")
    cic_deposit_swept.launches += 1
    return out


cic_deposit_swept.launches = 0
